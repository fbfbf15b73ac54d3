"""EncoderDecoder segmentor: backbone + decode head (+ auxiliary head).

Port of ``cp2_tpu/models/encoder_decoder.py``: one forward returning the
head output at feature resolution — segmentation logits when the head
classifies, dense embeddings when ``contrast=True`` — and, with
``with_aux``, the auxiliary head's logits beside it (mmseg's
``_auxiliary_head_forward_train``).  Train-mode dropout draws its masks
from the ``generator`` passed in (the backbone's too, where it takes one,
as the ViT does).  A ``neck`` (from ``NECKS``) runs on the backbone's
features in ``extract_feat``; its module keeps the flax key ``neck_mod``.
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from cp2_tpu_torch.models.registry import BACKBONES, HEADS, NECKS, SEGMENTORS


@SEGMENTORS.register
class EncoderDecoder(nn.Module):
    def __init__(self, backbone: dict, decode_head: dict,
                 neck: Optional[dict] = None,
                 auxiliary_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del train_cfg, test_cfg
        bb = dict(backbone)
        bb.setdefault("dtype", dtype)
        bb.pop("init_cfg", None)  # checkpoints load through the bridge
        self.backbone = BACKBONES.build(bb)
        self._backbone_takes_generator = (
            "generator" in inspect.signature(self.backbone.forward).parameters)
        self.neck_mod = None
        if neck is not None:
            nk = dict(neck)
            nk.setdefault("dtype", dtype)
            self.neck_mod = NECKS.build(nk)
        head = dict(decode_head)
        head.setdefault("dtype", dtype)
        self.decode_head = HEADS.build(head)
        self.auxiliary_head = None
        if auxiliary_head is not None:
            aux = dict(auxiliary_head)
            aux.setdefault("dtype", dtype)
            self.auxiliary_head = HEADS.build(aux)

    def extract_feat(self, img: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Backbone stage features (tuple), NCHW, through the neck if any."""
        if self._backbone_takes_generator:
            feats = self.backbone(img, generator=generator)
        else:
            feats = self.backbone(img)
        if self.neck_mod is not None:
            feats = self.neck_mod(feats)
        return feats

    def forward(self, img: torch.Tensor, with_aux: bool = False,
                generator: Optional[torch.Generator] = None):
        """Head output at feature resolution (OS=8/16/32 depending on config);
        ``(out, aux_out)`` with ``with_aux`` when there is an auxiliary head."""
        feats = self.extract_feat(img, generator)
        out = self.decode_head(feats, generator=generator)
        if with_aux and self.auxiliary_head is not None:
            return out, self.auxiliary_head(feats, generator=generator)
        return out

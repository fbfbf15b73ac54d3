"""EncoderDecoder segmentor: backbone + decode head (+ auxiliary head).

Port of ``cp2_tpu/models/encoder_decoder.py``: one forward returning the
head output at feature resolution — segmentation logits when the head
classifies, dense embeddings when ``contrast=True`` — and, with
``with_aux``, the auxiliary head's logits beside it (mmseg's
``_auxiliary_head_forward_train``).  Train-mode dropout draws its masks
from the ``generator`` passed in.  Necks are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cp2_tpu_torch.models.registry import BACKBONES, HEADS, SEGMENTORS


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
        if neck is not None:
            raise NotImplementedError("necks on a segmentor are not ported yet")
        bb = dict(backbone)
        bb.setdefault("dtype", dtype)
        bb.pop("init_cfg", None)  # checkpoints load through the bridge
        self.backbone = BACKBONES.build(bb)
        head = dict(decode_head)
        head.setdefault("dtype", dtype)
        self.decode_head = HEADS.build(head)
        self.auxiliary_head = None
        if auxiliary_head is not None:
            aux = dict(auxiliary_head)
            aux.setdefault("dtype", dtype)
            self.auxiliary_head = HEADS.build(aux)

    def extract_feat(self, img: torch.Tensor):
        """Backbone stage features (tuple), NCHW."""
        return self.backbone(img)

    def forward(self, img: torch.Tensor, with_aux: bool = False,
                generator: Optional[torch.Generator] = None):
        """Head output at feature resolution (OS=8/16/32 depending on config);
        ``(out, aux_out)`` with ``with_aux`` when there is an auxiliary head."""
        feats = self.extract_feat(img)
        out = self.decode_head(feats, generator=generator)
        if with_aux and self.auxiliary_head is not None:
            return out, self.auxiliary_head(feats, generator=generator)
        return out

"""EncoderDecoder segmentor: backbone + decode head combinator.

Port of ``cp2_tpu/models/encoder_decoder.py``: one forward returning the
head output at feature resolution — segmentation logits when the head
classifies, dense embeddings when ``contrast=True``.  Necks and auxiliary
heads are not ported yet.
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
        if neck is not None or auxiliary_head is not None:
            raise NotImplementedError("necks and auxiliary heads are not ported yet")
        bb = dict(backbone)
        bb.setdefault("dtype", dtype)
        bb.pop("init_cfg", None)  # checkpoints load through the bridge
        self.backbone = BACKBONES.build(bb)
        head = dict(decode_head)
        head.setdefault("dtype", dtype)
        self.decode_head = HEADS.build(head)

    def extract_feat(self, img: torch.Tensor):
        """Backbone stage features (tuple), NCHW."""
        return self.backbone(img)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """Head output at feature resolution (OS=8/16/32 depending on config)."""
        return self.decode_head(self.extract_feat(img))

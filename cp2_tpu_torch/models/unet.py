"""U-Net backbone variants of the CP2 ablations.

Port of ``cp2_tpu/models/unet.py`` (reference builder.py:76-137, built
there from segmentation_models_pytorch): a ResNet-50 encoder with

* no decoder (``UNetEncoderOnly``): the dense projector on stage-4
  features, output stride 32; or
* the first N U-Net decoder blocks (``UNetTruncated``): upsample, concat
  the encoder's skip, two convs, then the projector; N=2 gives 128
  channels at output stride 8.

NCHW in and out; module names match the flax tree (``backbone``,
``decoder_{i}``, ``projector``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cp2_tpu_torch.models.layers import ConvMLP
from cp2_tpu_torch.models.registry import BACKBONES
from cp2_tpu_torch.models.resnet import ResNet
from cp2_tpu_torch.models.utils import UpConvBlock

DECODER_CHANNELS = (256, 128, 64, 32, 16)


def _encoder(norm_cfg, dtype):
    return ResNet(depth=50, norm_cfg=norm_cfg or {"type": "BN"}, dtype=dtype)


@BACKBONES.register
class UNetEncoderOnly(nn.Module):
    """ResNet-50 encoder + dense projector on stage-4 features (OS=32)."""

    def __init__(self, projector_dim: int = 128, norm_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = _encoder(norm_cfg, dtype)
        width = self.backbone.stage_channels[-1]
        self.projector = ConvMLP(width, width, projector_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projector(self.backbone(x)[-1])


@BACKBONES.register
class UNetTruncated(nn.Module):
    """ResNet-50 encoder + first N U-Net decoder blocks + dense projector."""

    def __init__(self, projector_dim: int = 128, num_decoder_blocks: int = 2,
                 norm_cfg: Optional[dict] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_decoder_blocks < 1:
            raise ValueError("num_decoder_blocks must be >= 1")
        self.backbone = _encoder(norm_cfg, dtype)
        stages = self.backbone.stage_channels
        # skips, deepest first: stage3 (OS=16), stage2 (OS=8), stage1 (OS=4)
        self.skip_stages = [2, 1, 0, None, None][:num_decoder_blocks]
        width = stages[-1]
        for i, skip in enumerate(self.skip_stages):
            in_channels = width + (0 if skip is None else stages[skip])
            setattr(self, f"decoder_{i}", UpConvBlock(
                in_channels, DECODER_CHANNELS[i], norm_cfg=norm_cfg, dtype=dtype))
            width = DECODER_CHANNELS[i]
        self.projector = ConvMLP(width, width, projector_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        y = feats[-1]
        for i, skip in enumerate(self.skip_stages):
            y = getattr(self, f"decoder_{i}")(y, None if skip is None else feats[skip])
        return self.projector(y)

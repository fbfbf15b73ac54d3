"""Model building-block utilities (mmseg ``models/utils`` parity).

Port of ``UpConvBlock`` of ``cp2_tpu/models/utils.py:181-198``, the U-Net
decoder block; the other utilities there wait for a model that uses them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cp2_tpu_torch.models.layers import ConvModule


class UpConvBlock(nn.Module):
    """Nearest ×2 upsample + skip concat + two 3x3 ``ConvModule``s, NCHW
    (reference utils/up_conv_block.py).

    ``jax.image.resize(..., "nearest")`` at an exact factor of 2 reads
    input pixel ⌊i/2⌋ for output pixel i, as ``F.interpolate`` does: the
    two are equal bit for bit.
    """

    def __init__(self, in_channels: int, features: int, norm_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg or {"type": "BN"}, dtype=dtype)
        self.conv1 = ConvModule(in_channels, features, 3, **kw)
        self.conv2 = ConvModule(features, features, 3, **kw)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.conv2(self.conv1(x))

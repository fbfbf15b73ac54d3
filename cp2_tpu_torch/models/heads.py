"""Decode heads: ASPP (DeepLabV3) and FCN, with the dense-contrast branch.

Port of ``cp2_tpu/models/heads.py``:

* ``ASPPHead`` (reference ``mmseg_/models/decode_heads/aspp_head.py:53-117``):
  global image-pool branch broadcast back to the grid, parallel atrous
  convs ``aspp_{i}``, ``bottleneck``, then either the ``conv_seg``
  classifier or — with ``contrast=True`` — the ``contrast_conv`` 1x1-conv
  MLP to a ``contrast_dim`` dense embedding.
* ``FCNHead`` (reference ``fcn_head.py:10-91``): a stack of ``convs_{i}``
  with the optional ``conv_cat`` of input and output; ``num_convs=0`` is
  the identity the MoCo config uses (``configs/config_moco.py``), then
  ``conv_seg``.

Dropout draws its mask from an explicit ``torch.Generator``, as flax draws
from the ``dropout`` rng stream: in train mode each kept activation is
scaled by 1/keep, each dropped one set to 0 (``heads.py:82-83,134-135``);
in eval mode, or at ratio 0, it is the identity.  The contrast heads
return before the dropout, so the pretrain step draws no random numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cp2_tpu_torch.models.layers import ConvMLP, ConvModule, conv2d
from cp2_tpu_torch.models.registry import HEADS


def _select_input(inputs, in_index):
    if isinstance(inputs, (tuple, list)):
        return inputs[in_index]
    return inputs


def dropout(y: torch.Tensor, ratio: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, y / keep_prob, 0)`` with the keep
    mask drawn on ``generator`` (on ``y``'s device) in train mode."""
    if not training or ratio <= 0:
        return y
    if generator is None:
        raise ValueError("train-mode dropout needs a generator")
    keep_prob = 1.0 - ratio
    keep = torch.rand(y.shape, generator=generator, device=y.device) < keep_prob
    return torch.where(keep, y / keep_prob, torch.zeros((), dtype=y.dtype, device=y.device))


@HEADS.register
class ASPPHead(nn.Module):
    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: Optional[int] = None,
                 dilations: Sequence[int] = (1, 6, 12, 18), in_index: int = -1,
                 dropout_ratio: float = 0.1, contrast: bool = False,
                 contrast_dim: int = 128, norm_cfg: Optional[dict] = None,
                 align_corners: bool = False, loss_decode: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del align_corners, loss_decode  # used by the finetune path, not here
        self.in_index = in_index
        self.contrast = contrast
        self.dtype = dtype
        kw = dict(norm_cfg=norm_cfg, dtype=dtype)
        self.image_pool = ConvModule(in_channels, channels, 1, **kw)
        for i, dilation in enumerate(dilations):
            setattr(self, f"aspp_{i}", ConvModule(
                in_channels, channels, 1 if dilation == 1 else 3,
                dilation=dilation, **kw,
            ))
        self.num_branches = len(dilations)
        self.bottleneck = ConvModule((len(dilations) + 1) * channels, channels, 3, **kw)
        if contrast:
            self.contrast_conv = ConvMLP(channels, channels, contrast_dim, dtype=dtype)
        else:
            self.dropout_ratio = dropout_ratio
            self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _select_input(inputs, self.in_index).to(self.dtype)
        n, _, h, w = x.shape
        # image-level pooled branch; bilinear resize of a 1x1 map == broadcast
        pooled = self.image_pool(x.mean(dim=(2, 3), keepdim=True))
        branches = [pooled.expand(n, pooled.shape[1], h, w)]
        for i in range(self.num_branches):
            branches.append(getattr(self, f"aspp_{i}")(x))
        y = self.bottleneck(torch.cat(branches, dim=1))
        if self.contrast:
            return self.contrast_conv(y)
        y = dropout(y, self.dropout_ratio, self.training, generator)
        return conv2d(self.conv_seg, y, self.dtype)


@HEADS.register
class FCNHead(nn.Module):
    def __init__(self, in_channels: int = 2048, channels: int = 2048,
                 num_classes: Optional[int] = None, num_convs: int = 2,
                 kernel_size: int = 3, concat_input: bool = True, dilation: int = 1,
                 in_index: int = -1, dropout_ratio: float = 0.1,
                 contrast: bool = False, contrast_dim: int = 128,
                 norm_cfg: Optional[dict] = None, align_corners: bool = False,
                 loss_decode: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del align_corners, loss_decode  # used by the finetune path, not here
        if num_convs == 0 and in_channels != channels:
            raise ValueError("num_convs=0 requires in_channels == channels")
        self.in_index = in_index
        self.num_convs = num_convs
        self.concat_input = concat_input and num_convs > 0
        self.contrast = contrast
        self.dtype = dtype
        kw = dict(norm_cfg=norm_cfg, dtype=dtype)
        for i in range(num_convs):
            setattr(self, f"convs_{i}", ConvModule(
                in_channels if i == 0 else channels, channels, kernel_size,
                dilation=dilation, **kw))
        if self.concat_input:
            self.conv_cat = ConvModule(in_channels + channels, channels, kernel_size, **kw)
        if contrast:
            self.contrast_conv = ConvMLP(channels, channels, contrast_dim, dtype=dtype)
        else:
            self.dropout_ratio = dropout_ratio if num_convs > 0 else 0.0
            self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _select_input(inputs, self.in_index).to(self.dtype)
        y = x
        for i in range(self.num_convs):
            y = getattr(self, f"convs_{i}")(y)
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=1))
        if self.contrast:
            return self.contrast_conv(y)
        y = dropout(y, self.dropout_ratio, self.training, generator)
        return conv2d(self.conv_seg, y, self.dtype)

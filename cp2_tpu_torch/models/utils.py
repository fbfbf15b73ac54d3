"""Model building-block utilities (mmseg ``models/utils`` parity), NCHW.

Port of ``cp2_tpu/models/utils.py``: ``make_divisible``,
``trunc_normal_init``, ``DropPath`` (stochastic depth), ``SELayer``,
``InvertedResidual``, ``SelfAttentionBlock``, ``Encoding`` and the U-Net
decoder block ``UpConvBlock``.  Module and parameter names follow the flax
modules, so ``checkpoint/bridge.py`` carries their weights.

flax infers a layer's input width at its first call; ``nn.Conv2d`` and
``nn.Linear`` need it up front, so the modules here take their input
channels as their first argument.  Randomness comes from an explicit
``torch.Generator``: JAX's dropout keys cannot be replayed in torch, so
``DropPath`` splits its draw (``keep_mask``) from its apply
(``apply_mask``), and a mask drawn by JAX can be applied as it is.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cp2_tpu_torch.models.layers import BatchNorm, ConvModule, conv2d, linear


def make_divisible(value: float, divisor: int = 8, min_value: Optional[int] = None,
                   min_ratio: float = 0.9) -> int:
    """Round channel counts to hardware-friendly multiples."""
    if min_value is None:
        min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < min_ratio * value:
        new_value += divisor
    return new_value


def trunc_normal_init(stddev: float = 0.02) -> Callable:
    """flax ``nn.initializers.truncated_normal(stddev)``: a normal of scale
    ``stddev`` cut at ±2 of it (not rescaled), as an in-place initializer
    ``init(tensor, generator=None)``."""

    def init(tensor: torch.Tensor, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            return nn.init.trunc_normal_(tensor, 0.0, stddev, -2 * stddev, 2 * stddev,
                                         generator=generator)

    return init


class DropPath(nn.Module):
    """Per-sample stochastic depth (reference utils/drop.py)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def keep_mask(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Bernoulli(1 - rate) per sample, shape (N, 1, ..., 1), on ``x``'s
        device."""
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.rand(shape, generator=generator, device=x.device) < 1.0 - self.rate

    def apply_mask(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        keep_prob = 1.0 - self.rate
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("train-mode DropPath needs a generator")
        return self.apply_mask(x, self.keep_mask(x, generator))


class SELayer(nn.Module):
    """Squeeze-and-Excitation channel gate (reference utils/se_layer.py)."""

    def __init__(self, channels: int, ratio: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = make_divisible(channels / ratio)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = F.relu(linear(self.fc1, s, self.dtype))
        s = torch.sigmoid(linear(self.fc2, s, self.dtype))
        return x * s[:, :, None, None]


class InvertedResidual(nn.Module):
    """MobileNetV2-style inverted residual (reference
    utils/inverted_residual.py): 1x1 expand → 3x3 depthwise → BN → relu6 →
    1x1 project, with the identity added when shapes allow."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: int = 6, norm_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_res = stride == 1 and in_channels == out_channels
        kw = dict(norm_cfg=norm_cfg or {"type": "BN"}, dtype=dtype)
        self.expand = ConvModule(in_channels, hidden, 1, **kw) if expand_ratio != 1 else None
        self.dw_conv = nn.Conv2d(hidden, hidden, 3, stride=stride, padding=1,
                                 groups=hidden, bias=False)
        self.dw_bn = BatchNorm(hidden)
        self.project = ConvModule(hidden, out_channels, 1, act=False, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = F.conv2d(y.to(self.dtype), self.dw_conv.weight.to(self.dtype), None,
                     self.dw_conv.stride, self.dw_conv.padding, groups=self.dw_conv.groups)
        y = F.relu6(self.dw_bn(y.float())).to(self.dtype)
        y = self.project(y)
        return x + y if self.use_res else y


class SelfAttentionBlock(nn.Module):
    """Key/query/value attention over feature maps (reference
    utils/self_attention_block.py): queries from one map, keys and values
    from another, the value aggregation back on the query's grid.  One
    batched matmul pair; the softmax in float32, as the JAX block takes it.
    """

    def __init__(self, query_in_channels: int, key_in_channels: int, channels: int,
                 out_channels: int, matmul_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query_project = nn.Conv2d(query_in_channels, channels, 1)
        self.key_project = nn.Conv2d(key_in_channels, channels, 1)
        self.value_project = nn.Conv2d(key_in_channels, channels, 1)
        self.out_project = nn.Conv2d(channels, out_channels, 1)
        self.channels = channels
        self.matmul_norm = matmul_norm
        self.dtype = dtype

    def forward(self, query_feats: torch.Tensor, key_feats: torch.Tensor) -> torch.Tensor:
        n, _, qh, qw = query_feats.shape
        # (N, C, h, w) → (N, h·w, C), the flax module's NHWC flattening
        q = conv2d(self.query_project, query_feats, self.dtype).flatten(2).transpose(1, 2)
        k = conv2d(self.key_project, key_feats, self.dtype).flatten(2).transpose(1, 2)
        v = conv2d(self.value_project, key_feats, self.dtype).flatten(2).transpose(1, 2)
        sim = q @ k.transpose(1, 2)
        if self.matmul_norm:
            sim = sim * (self.channels ** -0.5)
        attn = torch.softmax(sim.float(), dim=-1).to(self.dtype)
        ctx = (attn @ v).transpose(1, 2).reshape(n, self.channels, qh, qw)
        return conv2d(self.out_project, ctx, self.dtype)


class Encoding(nn.Module):
    """Learned residual encoding layer (mmseg_/ops/encoding.py:6-72):
    pixel features against K learned codewords with learned smoothing,
    softmax-weighted residual sums as batched matmuls.  Returns (N, K, C).

    The smoothing factors keep the flax name ``scale``; the bridge tells
    them from a norm's scale by their ``codewords`` sibling.
    """

    def __init__(self, channels: int, num_codes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        std = 1.0 / ((num_codes * channels) ** 0.5)
        self.codewords = nn.Parameter(torch.rand(num_codes, channels) * (2 * std) - std)
        # smoothing factors U(-1, 0) (mmseg encoding.py)
        self.scale = nn.Parameter(-torch.rand(num_codes))
        self.channels = channels
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        feats = x.reshape(n, self.channels, -1).transpose(1, 2).to(self.dtype)  # (N, P, C)
        codewords = self.codewords
        dots = feats @ codewords.t()                                  # (N, P, K)
        f_sq = (feats ** 2).sum(-1, keepdim=True)                     # (N, P, 1)
        c_sq = (codewords ** 2).sum(-1)[None, None, :]                # (1, 1, K)
        dist = f_sq - 2.0 * dots + c_sq
        assign = torch.softmax(self.scale[None, None, :] * dist, dim=2)
        # encoded[k] = sum_p a[p,k] * (x[p] - c[k])
        return (assign.transpose(1, 2) @ feats
                - assign.sum(1)[..., None] * codewords[None])


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

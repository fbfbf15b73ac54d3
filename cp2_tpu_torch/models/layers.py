"""Shared building blocks for the model zoo (NCHW inside, ``nn.Module``).

Port of ``cp2_tpu/models/layers.py``.  What carries over, and what does not:

* BatchNorm reproduces flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
  dtype=float32)``, not torch's: running stats move by 0.1 of the batch
  statistic, and the running variance takes the BIASED batch variance
  (torch's ``F.batch_norm`` takes the unbiased one; ``BatchNorm`` corrects
  its buffer after the call, ``PARITY.md:283-292`` gives the law).
* The dtype policy of ``layers.py:39-47,279``: a conv runs in ``dtype``
  (weights kept in float32 and cast per call), BatchNorm computes in
  float32, and each ``ConvModule`` returns ``dtype``.
* ``DilatedConv3x3`` and ``SpaceToDepthConv`` are exact TPU rewrites of a
  plain conv (tap-split dilated conv, space-to-depth stem); here both are
  the one ``nn.Conv2d`` named ``conv``, so bridged weights load unchanged.
* "BN" and "SyncBN" are the same module, as in the JAX package, where
  global-view ``jit`` makes every BatchNorm's statistics cover the global
  batch.  On one process they do anyway; with a process group of W > 1
  ranks, train-mode ``BatchNorm`` reduces its statistics over the ranks
  (``_global_moments``), so W processes normalise as one process would on
  the concatenated batch.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cp2_tpu_torch.parallel import collectives

FLAX_BN_MOMENTUM = 0.9  # weight of the old running stat (flax convention)
BN_EPS = 1e-5

_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """While a checkpointed block recomputes its forward in the backward
    (``torch.utils.checkpoint``'s recompute context), train-mode
    ``BatchNorm`` normalises by the batch statistics as it did the first
    time but leaves its running statistics alone: they move once per
    step, as under flax's ``nn.remat``.  Thread-local, since autograd may
    recompute on a thread of its own."""
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


class BatchNorm(nn.Module):
    """flax-semantics BatchNorm over the channel axis of an NCHW tensor.

    ``frozen`` uses the running statistics even in train mode — the
    ``norm_eval`` / ``frozen_stages`` behaviour the flax modules thread
    through as ``norm_frozen``.  Input of any float dtype is normalised in
    float32 (cuDNN's mixed-precision batch norm); the output keeps the
    input's dtype, which is what the flax module's float32 output becomes
    after the cast each caller applies.
    """

    def __init__(self, num_features: int, *, zero_init: bool = False,
                 frozen: bool = False):
        super().__init__()
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.zero_init = zero_init
        self.frozen = frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        m = FLAX_BN_MOMENTUM
        if collectives.world_size() > 1:
            return self._global_forward(x, update=not getattr(_recompute, "depth", 0))
        if getattr(_recompute, "depth", 0):
            # the first forward's call on copies of the statistics: the
            # same result and the same tensors saved for the backward
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, 1.0 - m, BN_EPS)
        n = x.numel() // x.shape[1]
        # torch updates its running variance with the unbiased batch
        # variance: let it update a copy (which autograd keeps), then set
        # the buffer to flax's m·old + (1-m)·var = ((n-1)·copy + m·old) / n
        torch_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, torch_var, self.weight,
                         self.bias, True, 1.0 - m, BN_EPS)
        with torch.no_grad():
            self.running_var.mul_(m / n).add_(torch_var, alpha=(n - 1) / n)
        return y

    def _global_forward(self, x: torch.Tensor, update: bool) -> torch.Tensor:
        """Train-mode BatchNorm over the global batch of every rank: the
        batch mean and biased variance of ``_global_moments``, float32, and
        the running statistics moved by them as flax moves its own (not
        while a checkpointed block recomputes)."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        mean, var = _global_moments(xf)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        if update:
            m = FLAX_BN_MOMENTUM
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return y.to(x.dtype)


def _global_moments(xf: torch.Tensor):
    """Per-channel mean and biased variance of a float32 (N, C, ...) batch
    over every rank's rows.

    Each rank takes its own count, mean and centred sum of squares, and one
    differentiable ``all_reduce`` of a zero (W, 3, C) buffer in which it
    filled its own slot gives every rank all of them; they combine as
    Chan's parallel variance does (the centred sums plus each rank's count
    times its mean's squared distance from the global mean), which keeps
    the digits a one-pass E[x²] − E[x]² would lose.  The all-reduce's
    backward sums the statistics' gradients over the ranks, so after
    ``pmean_gradients`` each rank holds the gradient of the global batch's
    mean loss.
    """
    from torch.distributed.nn import functional as dist_fn

    dims = [0] + list(range(2, xf.dim()))
    count = xf.numel() // xf.shape[1]
    var_l, mean_l = torch.var_mean(xf, dim=dims, correction=0)
    mine = torch.stack([torch.full_like(mean_l, float(count)), mean_l, var_l * count])
    world, rank = collectives.world_size(), collectives.rank()
    slots = torch.cat([mine.new_zeros((rank, 3, mine.shape[1])), mine[None],
                       mine.new_zeros((world - rank - 1, 3, mine.shape[1]))])
    counts, means, m2s = dist_fn.all_reduce(slots).unbind(1)
    n = counts.sum(0)
    mean = (counts * means).sum(0) / n
    var = (m2s.sum(0) + (counts * (means - mean) ** 2).sum(0)) / n
    return mean, var


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(epsilon=1e-5, dtype=float32)``: float32 compute."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


def make_norm(norm_cfg: Optional[dict], num_features: int, *,
              zero_init: bool = False, frozen: bool = False
              ) -> Optional[nn.Module]:
    """Build a norm layer from an mmseg-style norm_cfg dict."""
    if norm_cfg is None:
        return None
    kind = norm_cfg.get("type", "BN")
    if kind in ("BN", "SyncBN", "BN2d"):
        return BatchNorm(num_features, zero_init=zero_init, frozen=frozen)
    if kind == "GN":
        norm = GroupNorm(norm_cfg.get("num_groups", 32), num_features, eps=BN_EPS)
        if zero_init:
            nn.init.zeros_(norm.weight)
        return norm
    raise ValueError(f"unsupported norm type {kind!r}")


def _rounds_before_bias(dtype: torch.dtype) -> bool:
    """flax's ``nn.Conv`` and ``nn.Dense`` round the product to ``dtype``
    and then add the bias in ``dtype``: two roundings below float32.  A
    fused bias (torch's CPU convolution, cuBLASLt's epilogue) rounds once,
    so below float32 the bias is added as a step of its own; at float32
    and above the one rounding is the fused path's, kept as it was."""
    return torch.finfo(dtype).bits < 32


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run ``conv`` in ``dtype`` with its float32 weights cast per call; the
    bias is added where flax adds it (``_rounds_before_bias``)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    split = bias is not None and _rounds_before_bias(dtype)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None if split else bias, conv.stride,
                 conv.padding, conv.dilation)
    return y + bias.view(1, -1, *([1] * (y.dim() - 2))) if split else y


class ConvModule(nn.Module):
    """conv → norm → activation (mmcv ConvModule), NCHW.

    Bias is omitted when a norm follows, matching the reference.
    ``padding=None`` gives 'same' padding for odd kernels with dilation.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 norm_cfg: Optional[dict] = None, act: bool = True,
                 padding: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 norm_frozen: bool = False):
        super().__init__()
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride=stride,
                              padding=padding, dilation=dilation,
                              bias=norm_cfg is None)
        self.norm = make_norm(norm_cfg, features, frozen=norm_frozen)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv, x, self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        if self.act:
            x = F.relu(x)
        return x.to(self.dtype)


def linear(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run ``fc`` in ``dtype`` with its float32 weights cast per call; the
    bias is added where flax adds it (``_rounds_before_bias``)."""
    bias = None if fc.bias is None else fc.bias.to(dtype)
    split = bias is not None and _rounds_before_bias(dtype)
    y = F.linear(x.to(dtype), fc.weight.to(dtype), None if split else bias)
    return y + bias if split else y


class MLP(nn.Module):
    """fc → (optional BN) → relu → fc projector/predictor head on (N, C).

    Port of ``layers.py:282-307`` (the MoCo/BYOL heads, reference
    builder.py:404-429; BYOL inserts the BatchNorm).  The BatchNorm is the
    flax-semantics one above on (N, C) input: its batch holds N values per
    channel, and the running variance's biased correction uses that N.
    """

    def __init__(self, in_features: int, hidden: int, out: int, use_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.bn = BatchNorm(hidden) if use_bn else None
        self.fc2 = nn.Linear(hidden, out)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(self.fc1, x, self.dtype)
        if self.bn is not None:
            x = self.bn(x)
        return linear(self.fc2, F.relu(x), self.dtype)


class ConvMLP(nn.Module):
    """1x1-conv → relu → 1x1-conv dense projection head (``contrast_conv``)."""

    def __init__(self, in_channels: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, hidden, 1)
        self.conv2 = nn.Conv2d(hidden, out, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv2d(self.conv1, x, self.dtype))
        return conv2d(self.conv2, x, self.dtype)


@torch.no_grad()
def init_flax_like_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise in place as flax's defaults would, from ``generator``.

    Conv and dense kernels: ``lecun_normal`` (truncated normal, fan-in
    scaling); their biases zero; norm scales one (zero where
    ``zero_init``), biases zero; running stats zero mean, unit variance.
    The values differ from a flax init with the same seed — only the
    distributions match.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # flax's truncated normal is cut at ±2σ and rescaled to unit
            # variance by this constant
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(0.0 if m.zero_init else 1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module

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
* ``SpaceToDepthConv`` is an exact TPU rewrite of the stem's plain conv;
  here the stem is the one ``nn.Conv2d`` named ``conv``.  ``DilatedConv3x3``
  has a counterpart: ``conv2d`` runs a stride-1 3x3 'same' convolution
  whose dilation is large against its grid as the sum of its in-bounds
  taps (``tap_split_engages``), on the same ``nn.Conv2d`` parameter, so
  bridged weights and checkpoints load unchanged either way.
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
from cp2_tpu_torch.utils.profiling import span

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


TAP_SPLITS = {"split": 0, "plain": 0}  # convolutions through ``conv2d``, by path


def reset_tap_split_counts() -> None:
    for key in TAP_SPLITS:
        TAP_SPLITS[key] = 0


def tap_split_engages(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether ``conv2d`` runs ``conv`` on ``x`` as the sum of its in-bounds
    taps: a dilated (d ≥ 2, as ``DilatedConv3x3``'s rule also asks)
    stride-1 3x3 convolution with 'same' zero padding whose dilation
    reaches half its grid or more (``2·d ≥ H`` or ``2·d ≥ W``).  At d = 1
    that would take only grids of 2 or less, where it saves nothing.

    There an off-centre tap reads the image only in a band of at most
    ``H − d`` rows or ``W − d`` columns, and reads padding elsewhere:
    at the ASPP's 14x14 grid d = 18 leaves only the centre tap and d = 12
    bands of 2 rows or columns; at 22x22, bands of 4 (d = 18) and 10
    (d = 12).  cuDNN's dilated kernels work through the padding (its
    generic ``dgrad_engine`` and ``wgrad_alg1_engine`` at 5-6 useful
    TFLOP/s); 1x1 convolutions over the bands skip it.  d = 6 at 14x14
    (bands of 8) stays on cuDNN's dilated path, which runs it fast, and so
    do the backbone's d = 2 convolutions at the model's grids."""
    if (conv.kernel_size != (3, 3) or conv.stride != (1, 1) or conv.groups != 1
            or conv.padding_mode != "zeros" or x.dim() != 4):
        return False
    dy, dx = conv.dilation
    if conv.padding != (dy, dx) or min(dy, dx) < 2:
        return False
    return 2 * dy >= x.shape[-2] or 2 * dx >= x.shape[-1]


def _band(size: int, offset: int):
    """(output, input) slices of one axis where a tap at ``offset`` reads
    inside the input (output ``i`` reads input ``i + offset``), or None."""
    lo, hi = max(0, -offset), size - max(0, offset)
    return (slice(lo, hi), slice(lo + offset, hi + offset)) if hi > lo else None


def _off_centre_taps(h: int, w: int, dilation):
    """``(tap, out_rows, out_cols, in_rows, in_cols)`` of each off-centre tap
    of a 3x3 'same' convolution that reads inside an ``h`` x ``w`` input,
    ``tap`` its index ``3·row + column``; a tap that reads only padding is
    left out."""
    dy, dx = dilation
    taps = []
    for ti in range(3):
        for tj in range(3):
            rows, cols = _band(h, (ti - 1) * dy), _band(w, (tj - 1) * dx)
            if (ti, tj) != (1, 1) and rows and cols:
                taps.append((3 * ti + tj, rows[0], cols[0], rows[1], cols[1]))
    return taps


def _band_layout(band: torch.Tensor) -> torch.Tensor:
    """A band of rows or columns as its 1x1 convolution should get it: on
    the card, a channels-last copy, which cuDNN runs as one product per
    pass, in GEMM kernels (cuBLASLt's ``nvjet_*``, CUTLASS) whose names are
    not a convolution's.  An NCHW band costs it transposes and, for the
    weight gradient, a float32 reduction over the batch: at the
    pretrain's d = 12 on an H100, one forward and backward took 3.28
    against 1.37 ms of device time and held 369 against 152 MiB above its
    operands.  Elsewhere the band stays as it is (oneDNN's channels-last
    backward corrupts this CPU build's heap at 1x1 and 2x2 maps)."""
    return band.contiguous(memory_format=torch.channels_last) if band.is_cuda else band


def _conv_backward(grad, x, weight, mask):
    """Both gradients of a bias-free 1x1 convolution, as ``mask`` asks."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        grad, x, weight, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask + [False])
    return gx, gw


class _TapSplitConv3x3(torch.autograd.Function):
    """A stride-1 3x3 'same' convolution as the sum of its in-bounds taps.

    The centre tap is a 1x1 convolution over the whole grid.  Each other
    tap of ``_off_centre_taps`` is a 1x1 convolution of the input rows and
    columns it reads, added into the band of the output it reaches; a tap
    that reads only padding runs nothing.  The bands go to cuDNN
    channels-last (``_band_layout``).  Each piece comes back rounded to the
    input's dtype; the forward adds them in a float32 copy of the output
    and rounds the sum again, so below float32 an output element that the
    centre and ``k`` ≥ 1 other taps reach is rounded ``k + 2`` times where
    cuDNN's dilated kernel rounds once (in bfloat16 on an H100 the output
    lies 1.18-1.23 times as far from float32 as cuDNN's).

    The backward runs each piece's ``convolution_backward`` (the input's
    and the weight's gradient in one call) and adds the input gradient of
    each band into the centre's in place, one band at a time.  Below
    float32 that add rounds too: an element that ``k`` other taps read is
    rounded ``2k + 1`` times (1.10-1.15 times cuDNN's distance from
    float32 on an H100).  A float32 accumulator would be the size of the
    input (C_in = 2048 channels: 103 MB at the pretrain's (64, 14, 14),
    2 % of its step's peak), alive near the top of the backward, where the
    step's activations are; the forward's is the output's size (C_out =
    512).  Summing each output region's taps in one 1x1 convolution over
    their windows concatenated by channel rounds once, forward and
    backward, but it launches more (a copy a window): at the pretrain's
    d = 12 on an H100, 133 kernels and 2.02 ms of card time a forward and
    backward against these pieces' 90 and 1.35 ms.  Each weight gradient
    is one product, rounded once; a tap that reads only padding gets
    exactly zero.

    It saves what the plain convolution saves: the input, and the weight
    in the input's dtype (laid out tap by tap, ``(9, C_out, C_in, 1, 1)``).
    The pieces are ``aten.convolution`` and ``aten.convolution_backward``
    calls on the (output, tap) pairs that read inside the input, so a FLOP
    count under XLA's rule (``utils/flops.py``) is the plain convolution's,
    integer for integer.  Every slice is fixed by the shapes: no host sync.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, dilation):
        cout, cin = weight.shape[:2]
        taps = weight.permute(2, 3, 0, 1).to(x.dtype, memory_format=torch.contiguous_format)
        taps = taps.reshape(9, cout, cin, 1, 1)
        ctx.save_for_backward(x, taps)
        ctx.dilation, ctx.weight_dtype = dilation, weight.dtype
        y = F.conv2d(x, taps[4])
        bands = _off_centre_taps(x.shape[-2], x.shape[-1], dilation)
        if not bands:
            return y
        acc = y.to(torch.promote_types(y.dtype, torch.float32))
        del y
        for tap, out_r, out_c, in_r, in_c in bands:
            acc[:, :, out_r, out_c].add_(F.conv2d(_band_layout(x[:, :, in_r, in_c]), taps[tap]))
        return acc.to(x.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, taps = ctx.saved_tensors
        mask = list(ctx.needs_input_grad[:2])
        with span("model.tap_split"):
            gx, gw_centre = _conv_backward(grad, x, taps[4], mask)
            gws = {4: gw_centre}
            for tap, out_r, out_c, in_r, in_c in _off_centre_taps(x.shape[-2], x.shape[-1],
                                                                  ctx.dilation):
                gxt, gws[tap] = _conv_backward(_band_layout(grad[:, :, out_r, out_c]),
                                               _band_layout(x[:, :, in_r, in_c]), taps[tap], mask)
                if mask[0]:
                    gx[:, :, in_r, in_c].add_(gxt)
            gweight = None
            if mask[1]:
                zero = gw_centre.new_zeros(()).expand_as(gw_centre)
                gweight = torch.stack([gws.get(i, zero) for i in range(9)], -1)
                gweight = gweight.view(taps.shape[1:3] + (3, 3)).to(ctx.weight_dtype)
        return gx, gweight, None


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run ``conv`` in ``dtype`` with its float32 weights cast per call; the
    bias is added where flax adds it (``_rounds_before_bias``).  Where
    ``tap_split_engages``, the convolution runs as the sum of its in-bounds
    taps (``_TapSplitConv3x3``, inside the span ``model.tap_split``), and
    its bias, if any, is added after; ``TAP_SPLITS`` counts the calls on
    each path."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    x = x.to(dtype)
    if tap_split_engages(conv, x):
        TAP_SPLITS["split"] += 1
        with span("model.tap_split"):
            y = _TapSplitConv3x3.apply(x, conv.weight, conv.dilation)
        return y if bias is None else y + bias.view(1, -1, 1, 1)
    TAP_SPLITS["plain"] += 1
    split = bias is not None and _rounds_before_bias(dtype)
    y = F.conv2d(x, conv.weight.to(dtype), None if split else bias, conv.stride,
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

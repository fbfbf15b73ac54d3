"""ResNet backbone family (NCHW ``nn.Module``), mmseg-compatible config.

Port of ``cp2_tpu/models/resnet.py`` with the same stage configuration:
per-stage ``strides`` / ``dilations`` (the OS=16 variant is
``strides=(1,2,2,1), dilations=(1,1,1,2)`` with ``contract_dilation``),
'pytorch' style (stride on the 3x3 conv), ``zero_init_residual``,
``deep_stem``, ``avg_down``, ``multi_grid``, and ``norm_eval`` /
``frozen_stages`` as BatchNorms that keep their running statistics.

Module names match the flax tree (``conv1``, ``layer{i}_{b}`` with
``conv1/conv2/conv3/norm3/downsample``), so the flax→torch bridge is a
rename plus a transpose.

``with_cp`` recomputes each residual block in the backward
(``torch.utils.checkpoint``, non-reentrant), the counterpart of flax's
``nn.remat``: activation memory for compute.  The recompute runs under
``layers.recomputing``, so each BatchNorm's running statistics move once
per step, as under ``nn.remat``; the step's loss, gradients and
statistics equal the plain step's.

Forward returns the tuple of stage features selected by ``out_indices``.
``frozen_param_labels`` labels the parameters that ``frozen_stages``
freezes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cp2_tpu_torch.models.layers import ConvModule, conv2d, make_norm, recomputing
from cp2_tpu_torch.models.registry import BACKBONES

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class _Shortcut(nn.Module):
    """Residual path with the optional 1x1 projection ``downsample``.

    ``avg_down`` pools before a stride-1 projection (no parameters), so the
    projection keeps the flax name ``downsample/{conv,norm}`` either way.
    """

    def __init__(self, in_channels, features, stride, has_downsample,
                 avg_down, norm_cfg, dtype, norm_frozen):
        super().__init__()
        self.pool = stride if (has_downsample and avg_down and stride != 1) else 1
        self.downsample = (
            ConvModule(in_channels, features, 1,
                       stride=1 if self.pool > 1 else stride, act=False,
                       norm_cfg=norm_cfg, dtype=dtype, norm_frozen=norm_frozen)
            if has_downsample else None
        )

    def shortcut(self, x):
        if self.downsample is None:
            return x
        if self.pool > 1:
            x = F.avg_pool2d(x, self.pool, self.pool)
        return self.downsample(x)


class BasicBlock(_Shortcut):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 avg_down: bool = False, norm_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32, norm_frozen: bool = False,
                 zero_init_residual: bool = True):
        super().__init__(in_channels, planes, stride, has_downsample,
                         avg_down, norm_cfg, dtype, norm_frozen)
        del zero_init_residual  # the flax BasicBlock has no zero-init norm
        kw = dict(norm_cfg=norm_cfg, dtype=dtype, norm_frozen=norm_frozen)
        self.conv1 = ConvModule(in_channels, planes, 3, stride=stride,
                                dilation=dilation, **kw)
        self.conv2 = ConvModule(planes, planes, 3, dilation=dilation, act=False, **kw)

    def forward(self, x):
        return F.relu(self.conv2(self.conv1(x)) + self.shortcut(x))


class Bottleneck(_Shortcut):
    """1x1 reduce → 3x3 (stride/dilation) → 1x1 expand, expansion 4.

    ``zero_init_residual``: the last norm's scale starts at zero so each
    block begins as identity (reference resnet.py:600-630 semantics).
    """

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 avg_down: bool = False, norm_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32, norm_frozen: bool = False,
                 zero_init_residual: bool = True):
        super().__init__(in_channels, planes * 4, stride, has_downsample,
                         avg_down, norm_cfg, dtype, norm_frozen)
        kw = dict(norm_cfg=norm_cfg, dtype=dtype, norm_frozen=norm_frozen)
        self.conv1 = ConvModule(in_channels, planes, 1, **kw)
        self.conv2 = ConvModule(planes, planes, 3, stride=stride,
                                dilation=dilation, **kw)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.norm3 = make_norm(norm_cfg, planes * 4, zero_init=zero_init_residual,
                               frozen=norm_frozen)
        self.dtype = dtype

    def forward(self, x):
        out = conv2d(self.conv3, self.conv2(self.conv1(x)), self.dtype)
        if self.norm3 is not None:
            out = self.norm3(out)
        return F.relu(out.to(self.dtype) + self.shortcut(x))


@BACKBONES.register
class ResNet(nn.Module):
    """ResNet-{18,34,50,101,152} with mmseg-style stage configuration."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = "pytorch", deep_stem: bool = False,
                 avg_down: bool = False, frozen_stages: int = -1,
                 norm_cfg: Optional[dict] = None, norm_eval: bool = False,
                 multi_grid: Optional[Sequence[int]] = None,
                 contract_dilation: bool = False, with_cp: bool = False,
                 zero_init_residual: bool = True, init_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del style, init_cfg  # 'pytorch' style only; checkpoints load via the bridge
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth}")
        block_kind, stage_blocks = ARCH_SETTINGS[depth]
        stage_blocks = stage_blocks[:num_stages]
        block_cls = Bottleneck if block_kind == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.deep_stem = deep_stem
        self.with_cp = with_cp
        self.dtype = dtype

        frozen_stem = norm_eval or frozen_stages >= 0
        kw = dict(norm_cfg=norm_cfg, dtype=dtype, norm_frozen=frozen_stem)
        if deep_stem:
            self.stem1 = ConvModule(in_channels, stem_channels // 2, 3, stride=2, **kw)
            self.stem2 = ConvModule(stem_channels // 2, stem_channels // 2, 3, **kw)
            self.stem3 = ConvModule(stem_channels // 2, stem_channels, 3, **kw)
        else:
            self.conv1 = ConvModule(in_channels, stem_channels, 7, stride=2,
                                    padding=3, **kw)

        channels = stem_channels
        self.stages: list[list[str]] = []
        self.strides = tuple(strides[:len(stage_blocks)])
        self.stage_channels: list[int] = []  # output channels of each stage
        for i, num_blocks in enumerate(stage_blocks):
            stride, dilation = strides[i], dilations[i]
            planes = base_channels * 2**i
            norm_frozen = norm_eval or frozen_stages >= i + 1
            names = []
            for b in range(num_blocks):
                if multi_grid is not None and i == len(stage_blocks) - 1:
                    block_dilation = dilation * multi_grid[b]
                elif b == 0 and dilation > 1 and contract_dilation:
                    block_dilation = dilation // 2
                else:
                    block_dilation = dilation
                name = f"layer{i + 1}_{b}"
                setattr(self, name, block_cls(
                    channels, planes,
                    stride=stride if b == 0 else 1,
                    dilation=block_dilation,
                    has_downsample=(
                        b == 0 and (stride != 1
                                    or channels != planes * block_cls.expansion)
                    ),
                    avg_down=avg_down,
                    norm_cfg=norm_cfg,
                    dtype=dtype,
                    norm_frozen=norm_frozen,
                    zero_init_residual=zero_init_residual,
                ))
                names.append(name)
                channels = planes * block_cls.expansion
            self.stages.append(names)
            self.stage_channels.append(channels)

    def feature_hw(self, img_hw: Tuple[int, int]) -> Tuple[int, int]:
        """Spatial size of the last stage's output for an ``img_hw`` input.

        The stem conv and the max pool each halve a side rounding up, and so
        does every stride-s 3x3 conv ('same' padding) and 1x1 projection.
        """
        out = []
        for side in img_hw:
            side = -(-side // 4)
            for s in self.strides:
                side = -(-side // s)
            out.append(side)
        return tuple(out)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.to(self.dtype)
        if self.deep_stem:
            x = self.stem3(self.stem2(self.stem1(x)))
        else:
            x = self.conv1(x)
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        remat = self.with_cp and self.training and torch.is_grad_enabled()
        for i, names in enumerate(self.stages):
            for name in names:
                block = getattr(self, name)
                if remat:
                    x = checkpoint(block, x, use_reentrant=False,
                                   context_fn=_recompute_contexts)
                else:
                    x = block(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


def _recompute_contexts():
    """``checkpoint``'s (forward, recompute) contexts."""
    return contextlib.nullcontext(), recomputing()


def frozen_param_labels(model: nn.Module, frozen_stages: int) -> Dict[str, str]:
    """``{name: "frozen" | "trainable"}`` over a backbone's
    ``named_parameters``: the stem once ``frozen_stages >= 0`` and
    ``layer1`` .. ``layer{frozen_stages}``.

    Port of ``cp2_tpu/models/resnet.py::frozen_param_labels`` (the
    reference's ``_freeze_stages``, resnet.py:532-599): the same rule on
    the port's names, which the bridge maps onto the flax paths, so the
    labels agree leaf for leaf.
    """

    def label(name: str) -> str:
        if frozen_stages >= 0 and ("conv1" in name.split(".")[0] or name.startswith("stem")):
            return "frozen"
        for stage in range(1, frozen_stages + 1):
            if name.startswith(f"layer{stage}_"):
                return "frozen"
        return "trainable"

    return {name: label(name) for name, _ in model.named_parameters()}

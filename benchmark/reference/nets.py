"""The plain networks: dilated ResNet + ASPP head (with the contrast MLP, or
a classifier), written as functions of a flat dict of float32 tensors.

Nothing here comes from the program under test.  The layer equations are
the published ones (ResNet-50 v1.5 bottlenecks, DeepLabV3's ASPP with an
image-pool branch, CP2's 1x1-conv contrast MLP); the parameter names are
those of the program's ``state_dict``, so one dict of weights made from the
seed loads into both.  Every convolution runs in float32 with TF32 off,
every BatchNorm normalises by the batch's mean and biased variance.

``Precision`` selects the control, the reference computed one step below
the configuration's bfloat16: with ``fp8`` it keeps in float8 what the
program keeps in its compute type (every convolution's operands and
output, each normalised activation, each residual sum), e4m3 forward and
e5m2 for their gradients, each with a per-tensor scale from its largest
magnitude; BatchNorm and the losses compute in float32, as the program's
do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale from its largest
    magnitude, back in ``x``'s dtype."""
    scale = largest / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Operand(torch.autograd.Function):
    """A product's operand in float8 e4m3; its gradient passed through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Stored(torch.autograd.Function):
    """An activation kept in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """Where and how the reference rounds: ``fp32`` (nowhere), ``fp8``
    (the control: the operands of every convolution, and every tensor the
    program keeps in its compute type, in float8), or ``fp64`` (the
    convolutions in float64, a look at the float32 reference's own
    rounding)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8", "fp64"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Operand.apply(x)
        return x.double() if self.name == "fp64" else x

    def stored(self, y: torch.Tensor) -> torch.Tensor:
        return _Stored.apply(y) if self.name == "fp8" else y


FP32 = Precision("fp32")


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------

def _conv(spec, name, cout, cin, k, bias=False):
    spec.append((f"{name}.weight", (cout, cin, k, k), "conv"))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zeros"))


def _bn(spec, name, c, scale="ones"):
    spec += [(f"{name}.weight", (c,), scale), (f"{name}.bias", (c,), "zeros"),
             (f"{name}.running_mean", (c,), "zeros"), (f"{name}.running_var", (c,), "ones")]


def _conv_bn(spec, name, cout, cin, k):
    _conv(spec, f"{name}.conv", cout, cin, k)
    _bn(spec, f"{name}.norm", cout)


def resnet_blocks(bb: dict) -> List[dict]:
    """One dict per bottleneck: name, channels, stride, dilation,
    downsample; the mmseg ResNet's layout (``contract_dilation`` halves the
    first block's dilation in a dilated stage)."""
    depth = bb.get("depth", 50)
    if depth != 50:
        raise ValueError("the reference builds ResNet-50 bottlenecks only")
    counts = (3, 4, 6, 3)[: bb.get("num_stages", 4)]
    base = bb.get("base_channels", 64)
    cin = bb.get("stem_channels", 64)
    blocks = []
    for i, n in enumerate(counts):
        planes = base * 2 ** i
        stride, dil = bb["strides"][i], bb["dilations"][i]
        for b in range(n):
            d = dil // 2 if (b == 0 and dil > 1 and bb.get("contract_dilation")) else dil
            s = stride if b == 0 else 1
            blocks.append(dict(name=f"layer{i + 1}_{b}", cin=cin, planes=planes, stride=s,
                               dilation=d, down=b == 0 and (s != 1 or cin != planes * 4)))
            cin = planes * 4
    return blocks


def param_spec(model: dict, prefix: str = "") -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every tensor of the network, in the order
    the weights are drawn; ``kind`` is ``conv`` (fan-in scaled normal),
    ``ones``, ``zeros`` or ``branch``: each residual branch's last
    BatchNorm scale, which the configuration's ``init`` sets small but not
    0, so that every block starts near the identity and still passes its
    branch's output and gradient on."""
    bb, head = model["backbone"], model["decode_head"]
    spec: list = []
    p = prefix + "backbone."
    stem = bb.get("stem_channels", 64)
    _conv_bn(spec, p + "conv1", stem, 3, 7)
    for blk in resnet_blocks(bb):
        n, planes = p + blk["name"], blk["planes"]
        if blk["down"]:
            _conv_bn(spec, n + ".downsample", planes * 4, blk["cin"], 1)
        _conv_bn(spec, n + ".conv1", planes, blk["cin"], 1)
        _conv_bn(spec, n + ".conv2", planes, planes, 3)
        _conv(spec, n + ".conv3", planes * 4, planes, 1)
        _bn(spec, n + ".norm3", planes * 4, scale="branch")
    h = prefix + "decode_head."
    cin, ch = head["in_channels"], head["channels"]
    _conv_bn(spec, h + "image_pool", ch, cin, 1)
    for i, d in enumerate(head["dilations"]):
        _conv_bn(spec, h + f"aspp_{i}", ch, cin, 1 if d == 1 else 3)
    _conv_bn(spec, h + "bottleneck", ch, ch * (len(head["dilations"]) + 1), 3)
    if head.get("contrast"):
        _conv(spec, h + "contrast_conv.conv1", ch, ch, 1, bias=True)
        _conv(spec, h + "contrast_conv.conv2", head.get("contrast_dim", 128), ch, 1, bias=True)
    else:
        _conv(spec, h + "conv_seg", head["num_classes"], ch, 1, bias=True)
    return spec


def trainable(spec) -> List[str]:
    """Names of the parameters (the running statistics are buffers)."""
    return [n for n, _, _ in spec if not n.endswith(("running_mean", "running_var"))]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, prec: Precision = FP32):
    if b is not None and prec.name == "fp64":
        b = b.double()
    return prec.stored(F.conv2d(prec.operand(x), prec.operand(w), b, stride, padding,
                                dilation))


def batch_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm: the batch's mean and biased variance."""
    dims = [0] + list(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w.view(shape) + b.view(shape)


def _cbr(P, name, x, stride=1, padding=0, dilation=1, relu=True, prec=FP32):
    y = conv2d(x, P[name + ".conv.weight"], None, stride, padding, dilation, prec)
    y = batch_norm(y, P[name + ".norm.weight"], P[name + ".norm.bias"])
    return prec.stored(F.relu(y) if relu else y)


def resnet(P: Dict[str, torch.Tensor], bb: dict, x: torch.Tensor, prefix: str = "",
           prec: Precision = FP32) -> torch.Tensor:
    """NCHW image → the last stage's features."""
    p = prefix + "backbone."
    x = _cbr(P, p + "conv1", x, stride=2, padding=3, prec=prec)
    x = F.max_pool2d(x, 3, 2, padding=1)
    for blk in resnet_blocks(bb):
        n, d = p + blk["name"], blk["dilation"]
        out = _cbr(P, n + ".conv1", x, prec=prec)
        out = _cbr(P, n + ".conv2", out, stride=blk["stride"], padding=d, dilation=d,
                   prec=prec)
        out = conv2d(out, P[n + ".conv3.weight"], prec=prec)
        out = prec.stored(batch_norm(out, P[n + ".norm3.weight"], P[n + ".norm3.bias"]))
        short = (_cbr(P, n + ".downsample", x, stride=blk["stride"], relu=False, prec=prec)
                 if blk["down"] else x)
        x = prec.stored(F.relu(out + short))
    return x


def aspp(P, head: dict, x: torch.Tensor, prefix: str = "", prec: Precision = FP32):
    """DeepLabV3's ASPP: image pool + one branch per dilation + the 3x3
    bottleneck, BatchNorm and ReLU after each convolution."""
    h = prefix + "decode_head."
    n, _, hh, ww = x.shape
    pooled = _cbr(P, h + "image_pool", x.mean(dim=(2, 3), keepdim=True), prec=prec)
    branches = [pooled.expand(n, pooled.shape[1], hh, ww)]
    for i, d in enumerate(head["dilations"]):
        branches.append(_cbr(P, h + f"aspp_{i}", x, padding=0 if d == 1 else d,
                             dilation=d, prec=prec))
    return _cbr(P, h + "bottleneck", torch.cat(branches, dim=1), padding=1, prec=prec)


def contrast_embed(P, model: dict, img_nhwc: torch.Tensor, prefix: str = "encoder.",
                   prec: Precision = FP32) -> torch.Tensor:
    """CP2's dense embedding: NHWC image → (N, h, w, dim)."""
    h = prefix + "decode_head."
    x = img_nhwc.permute(0, 3, 1, 2)
    y = aspp(P, model["decode_head"], resnet(P, model["backbone"], x, prefix, prec), prefix,
             prec)
    y = prec.stored(F.relu(conv2d(y, P[h + "contrast_conv.conv1.weight"],
                                  P[h + "contrast_conv.conv1.bias"], prec=prec)))
    y = conv2d(y, P[h + "contrast_conv.conv2.weight"], P[h + "contrast_conv.conv2.bias"],
               prec=prec)
    return y.permute(0, 2, 3, 1)


def segment_logits(P, model: dict, img_nhwc: torch.Tensor, keep: Optional[torch.Tensor],
                   keep_prob: float, prec: Precision = FP32) -> torch.Tensor:
    """DeepLabV3: NHWC image → NCHW class logits at the feature grid;
    ``keep`` is the dropout mask before the classifier (None: no dropout)."""
    x = img_nhwc.permute(0, 3, 1, 2)
    y = aspp(P, model["decode_head"], resnet(P, model["backbone"], x, "", prec), "", prec)
    if keep is not None:
        y = torch.where(keep, y / keep_prob, torch.zeros((), dtype=y.dtype, device=y.device))
    return conv2d(y, P["decode_head.conv_seg.weight"], P["decode_head.conv_seg.bias"],
                  prec=prec)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)

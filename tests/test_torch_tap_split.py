"""The tap split of ``models/layers.py::conv2d`` on the CPU.

A stride-1 3x3 'same' convolution whose dilation reaches half its grid
(``tap_split_engages``: ``2·d ≥ H`` or ``2·d ≥ W``) runs as the sum of its
in-bounds taps.  Held here, for the forward, the input's gradient and the
weight's gradient:

* against ``F.conv2d(..., dilation=d, padding=d)``: float32 to 1e-5 of the
  largest magnitude; bfloat16 within the tolerance of the bfloat16 conv
  policy test (``tests/test_torch_model.py``: 5 % of the largest
  magnitude), and no farther from the exact (float64) result than twice
  the plain convolution's bfloat16 result, normwise (2.5 times for the
  input's gradient, whose bands are added in bfloat16).  Measured on
  three seeds: 1.33-1.48 (forward), 1.43-1.87 (input gradient), 1.00
  (weight gradient); the d = 18 at 14x14 and 5x5 cases are the centre
  tap alone, 1.00 throughout;
* at the ASPP's grids (14x14 and 22x22 at d = 12 and 18), a non-square
  grid, and a grid smaller than the dilation; d = 6, d = 2, stride 2, a
  1x1 and a d = 1 3x3 convolution at the same grids, and a d = 1 3x3 at a
  2x2 grid, stay on the plain path, by ``TAP_SPLITS``, and give its
  result bit for bit;
* a tap that reads only padding gets a weight gradient of exactly zero,
  as the plain convolution gives it; the state dict keeps its keys and
  shapes; against the JAX package's ``DilatedConv3x3`` on the same
  weights through ``checkpoint/bridge.py``, float32;
* at 224² the flagship encoder splits exactly the ASPP's d = 12 and d = 18
  convolutions (meta device), and a profiler sees the ``model.tap_split``
  span around the forward and the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cp2_tpu.models.layers import DilatedConv3x3
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import layers
from cp2_tpu_torch.models.layers import ConvModule
from cp2_tpu_torch.utils import profiling

ENGAGED = [(14, 14, 12), (14, 14, 18), (22, 22, 12), (22, 22, 18), (9, 30, 12), (5, 5, 12)]
PLAIN = [  # (h, w, kernel, stride, dilation)
    (14, 14, 3, 1, 6), (14, 14, 3, 1, 2), (22, 22, 3, 1, 6), (22, 22, 3, 1, 2),
    (14, 14, 3, 2, 1), (14, 14, 3, 1, 1), (14, 14, 1, 1, 1), (2, 2, 3, 1, 1)]
CIN, COUT = 64, 32
BF16_MAX_ABS = 5e-2  # tests/test_torch_model.py::test_bf16_policy_casts_like_jax
BF16_NORM_RATIO = {"output": 2.0, "input gradient": 2.5, "weight gradient": 2.0}


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _case(h, w, d, seed=0, kernel=3, stride=1):
    g = torch.Generator().manual_seed(seed)
    conv = torch.nn.Conv2d(CIN, COUT, kernel, stride=stride, padding=d * (kernel - 1) // 2,
                           dilation=d, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / (CIN * kernel ** 2) ** 0.5)
    x = torch.randn(2, CIN, h, w, generator=g)
    return conv, x, g


def _run(fn, conv, x, gy):
    """(output, input gradient, weight gradient) of ``fn(x)`` against ``gy``."""
    x = x.clone().requires_grad_()
    conv.weight.grad = None
    y = fn(x)
    return (y,) + torch.autograd.grad(y, (x, conv.weight), gy.to(y.dtype))


def _plain(conv, dtype):
    return lambda x: F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                              conv.padding, conv.dilation)


def _split(conv, dtype):
    return lambda x: layers.conv2d(conv, x, dtype)


def _gy(conv, x, g):
    with torch.no_grad():
        shape = F.conv2d(x[:1, :1], conv.weight[:1, :1], None, conv.stride, conv.padding,
                         conv.dilation).shape
    return torch.randn((x.shape[0], COUT) + tuple(shape[2:]), generator=g)


@pytest.mark.parametrize("h,w,d", ENGAGED, ids=[f"{h}x{w}d{d}" for h, w, d in ENGAGED])
def test_split_equals_the_plain_conv_in_float32(h, w, d):
    conv, x, g = _case(h, w, d)
    gy = _gy(conv, x, g)
    layers.reset_tap_split_counts()
    ours = _run(_split(conv, torch.float32), conv, x, gy)
    assert layers.TAP_SPLITS == {"split": 1, "plain": 0}
    ref = _run(_plain(conv, torch.float32), conv, x, gy)
    for name, a, b in zip(("output", "input gradient", "weight gradient"), ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.detach().abs().max()),
                                   msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,w,d", ENGAGED, ids=[f"{h}x{w}d{d}" for h, w, d in ENGAGED])
def test_split_equals_the_plain_conv_in_bfloat16(h, w, d, seed):
    conv, x, g = _case(h, w, d, seed)
    x = x.bfloat16().float()  # the values both bfloat16 runs and the exact one see
    gy = _gy(conv, x, g).bfloat16().float()
    ours = _run(_split(conv, torch.bfloat16), conv, x, gy)
    plain = _run(_plain(conv, torch.bfloat16), conv, x, gy)
    conv64 = torch.nn.Conv2d(CIN, COUT, 3, padding=d, dilation=d, bias=False).double()
    with torch.no_grad():
        conv64.weight.copy_(conv.weight.bfloat16().double())
    exact = _run(_plain(conv64, torch.float64), conv64, x.double(), gy.double())
    for name, a, b, e in zip(BF16_NORM_RATIO, ours, plain, exact):
        a, b = a.double(), b.double()
        assert (a - b).abs().max() <= BF16_MAX_ABS * e.abs().max(), name
        assert (a - e).norm() <= BF16_NORM_RATIO[name] * max((b - e).norm(), 1e-30), name


@pytest.mark.parametrize("h,w,kernel,stride,d", PLAIN,
                         ids=[f"{h}x{w}k{k}s{s}d{d}" for h, w, k, s, d in PLAIN])
def test_other_convolutions_stay_plain(h, w, kernel, stride, d):
    conv, x, g = _case(h, w, d, kernel=kernel, stride=stride)
    assert not layers.tap_split_engages(conv, x)
    gy = _gy(conv, x, g)
    layers.reset_tap_split_counts()
    ours = _run(_split(conv, torch.float32), conv, x, gy)
    assert layers.TAP_SPLITS == {"split": 0, "plain": 1}
    for a, b in zip(ours, _run(_plain(conv, torch.float32), conv, x, gy)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,w,d,live", [
    (14, 14, 18, {4}), (5, 5, 12, {4}), (9, 30, 12, {3, 4, 5}), (14, 14, 12, set(range(9)))])
def test_padding_only_taps_get_exactly_zero_gradient(h, w, d, live):
    conv, x, g = _case(h, w, d)
    gy = _gy(conv, x, g)
    for fn in (_split(conv, torch.float32), _plain(conv, torch.float32)):
        gw = _run(fn, conv, x, gy)[2].flatten(2)
        for tap in range(9):
            assert bool((gw[:, :, tap] == 0).all()) == (tap not in live), tap


def test_state_dict_keeps_its_keys_and_shapes():
    module = ConvModule(CIN, COUT, 3, dilation=12, norm_cfg=dict(type="BN"))
    before = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert before == {"conv.weight": (COUT, CIN, 3, 3), "norm.weight": (COUT,),
                      "norm.bias": (COUT,), "norm.running_mean": (COUT,),
                      "norm.running_var": (COUT,)}
    module.train()
    layers.reset_tap_split_counts()
    module(torch.randn(2, CIN, 14, 14)).sum().backward()
    assert layers.TAP_SPLITS["split"] == 1
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == before
    params, _ = state_dict_to_flax(module.state_dict())
    assert params["conv"]["kernel"].shape == (3, 3, CIN, COUT)


@pytest.mark.parametrize("h,w,d", [(14, 14, 12), (22, 22, 18), (9, 30, 12)],
                         ids=["14x14d12", "22x22d18", "9x30d12"])
def test_split_equals_jax_dilated_conv3x3(h, w, d):
    """The JAX package's TPU tap split and the port's, on the same weights
    (bridged) and input, float32."""
    x = np.random.RandomState(0).randn(2, h, w, CIN).astype(np.float32)
    jm = DilatedConv3x3(COUT, d, use_bias=True)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    params = dict(params, bias=np.random.RandomState(1).randn(COUT).astype(np.float32))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    module = ConvModule(CIN, COUT, 3, dilation=d, norm_cfg=None, act=False)
    load_flax_into(module, {"conv": jax.tree_util.tree_map(np.asarray, params)})
    layers.reset_tap_split_counts()
    with torch.no_grad():
        ours = module(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert layers.TAP_SPLITS["split"] == 1
    np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_flagship_encoder_splits_the_aspp_d12_and_d18_convs(monkeypatch):
    """At 224² (a 14x14 grid) exactly the ASPP's d = 12 and d = 18
    convolutions split; its d = 6 and the backbone's d = 2 stay plain."""
    from cp2_tpu_torch.graft_entry import entry

    engaged = layers.tap_split_engages
    seen = []

    def recording(conv, x):
        took = engaged(conv, x)
        if conv.kernel_size == (3, 3):
            seen.append((conv.in_channels, conv.dilation, tuple(x.shape[-2:]), took))
        return took

    monkeypatch.setattr(layers, "tap_split_engages", recording)
    fn, args = entry(device="meta")
    fn(*args)
    split = sorted((c, dil, grid) for c, dil, grid, took in seen if took)
    assert split == [(2048, (12, 12), (14, 14)), (2048, (18, 18), (14, 14))]
    plain = {(c, dil) for c, dil, _, took in seen if not took}
    assert (2048, (6, 6)) in plain and (512, (2, 2)) in plain


def test_span_names_the_split_forward_and_backward(tmp_path):
    import json

    conv, x, g = _case(14, 14, 12)
    with profiling.trace(str(tmp_path)):
        _run(_split(conv, torch.float32), conv, x, _gy(conv, x, g))
    with open(tmp_path / profiling.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert names.count("model.tap_split") == 2

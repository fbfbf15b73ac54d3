"""The port's FLOP count (``cp2_tpu_torch/utils/flops.py``) against XLA's.

The JAX tools take ``model_flops_per_step`` from XLA's
``cost_analysis()["flops"]``; the port counts with ``FlopCounterMode``
under XLA's rules.  Held here:

* a single convolution (kernel 1/3/7, stride 1/2, dilation 1/6/12/18,
  grids 4/14/16; padding d·(k−1)/2, the model's), forward and forward with
  both gradients, **equals** XLA's count of ``lax.conv_general_dilated``,
  integer for integer; so do products (``mm``, ``einsum``);
* the flagship forward (``config_pretrain.py``, batch 2, 224², counted on
  the meta device) lies within 5 % below XLA's count of
  ``__graft_entry__.entry()``: XLA also counts elementwise work, which the
  port's count leaves out; torch's default formulas count taps that read
  padding and land more than 30 % above, which shows the rule in force;
* the dense pair loss counts by its formula on the CPU route and on the
  meta device, and a step's count does not depend on the route;
* a convolution that ``models/layers.py`` splits into its in-bounds taps,
  and the flagship pretrain and finetune steps that split their ASPP's
  d = 12 and d = 18 convolutions, count what they count on the plain
  path, integer for integer.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cp2_tpu_torch.ops import dense_loss  # noqa: E402
from cp2_tpu_torch.utils import flops  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite runs several workers on few cores; these small counts only
    # lose to the threads' contention
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _xla_flops(fn, *args) -> int:
    import jax

    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return int(cost["flops"])


CONVS = list(itertools.product((1, 3, 7), (1, 2), (1, 6, 12, 18), (4, 14, 16)))


@pytest.mark.parametrize("kernel,stride,dilation,grid", CONVS,
                         ids=[f"k{k}s{s}d{d}g{g}" for k, s, d, g in CONVS])
def test_conv_count_equals_xla(kernel, stride, dilation, grid):
    import jax
    import jax.numpy as jnp

    n, cin, cout = 2, 8, 4
    pad = dilation * (kernel - 1) // 2

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride, stride), [(pad, pad), (pad, pad)],
            rhs_dilation=(dilation, dilation), dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def conv_and_grads(x, w, ct):
        y, vjp = jax.vjp(conv, x, w)
        return (y,) + vjp(ct)

    x = jnp.zeros((n, grid, grid, cin))
    w = jnp.zeros((kernel, kernel, cin, cout))
    ct = jnp.zeros(jax.eval_shape(conv, x, w).shape)
    xla_fwd, xla_all = _xla_flops(conv, x, w), _xla_flops(conv_and_grads, x, w, ct)

    tx = torch.zeros((n, cin, grid, grid), requires_grad=True)
    tw = torch.zeros((cout, cin, kernel, kernel), requires_grad=True)
    conv_t = torch.nn.functional.conv2d
    _, ours_fwd = flops.count_flops(lambda: conv_t(tx.detach(), tw.detach(), None, stride,
                                                   pad, dilation))

    def fwd_and_grads():
        y = conv_t(tx, tw, None, stride, pad, dilation)
        return torch.autograd.grad(y, (tx, tw), torch.zeros_like(y))

    _, ours_all = flops.count_flops(fwd_and_grads)
    assert ours_fwd == xla_fwd
    assert ours_all == xla_all


def test_conv_count_drops_the_gradient_nobody_asks_for():
    """The image needs no gradient: only the weight's is counted, as XLA
    drops the stem's input gradient in the step."""
    x = torch.zeros((2, 3, 16, 16))
    w = torch.zeros((4, 3, 7, 7), requires_grad=True)

    def fwd_and_grad():
        y = torch.nn.functional.conv2d(x, w, None, 2, 3)
        return torch.autograd.grad(y.sum(), w)

    _, one = flops.count_flops(lambda: torch.nn.functional.conv2d(x, w.detach(), None, 2, 3))
    _, both = flops.count_flops(fwd_and_grad)
    assert both == 2 * one


@pytest.mark.parametrize("kind", ["mm", "einsum_bmm", "einsum_queue"])
def test_product_count_equals_xla(kind):
    import jax
    import jax.numpy as jnp

    shapes = {"mm": ((6, 5), (5, 7)), "einsum_bmm": ((3, 10, 8), (3, 12, 8)),
              "einsum_queue": ((4, 16), (32, 16))}[kind]
    spec = {"mm": "ij,jk->ik", "einsum_bmm": "nxc,nyc->nxy", "einsum_queue": "nc,kc->nk"}[kind]

    def fwd_and_grads(a, b, ct):
        y, vjp = jax.vjp(lambda a, b: jnp.einsum(spec, a, b), a, b)
        return (y,) + vjp(ct)

    a, b = (jnp.zeros(s) for s in shapes)
    ct = jnp.zeros(jnp.einsum(spec, a, b).shape)
    xla_fwd = _xla_flops(lambda a, b: jnp.einsum(spec, a, b), a, b)
    xla_all = _xla_flops(fwd_and_grads, a, b, ct)
    ta, tb = (torch.zeros(s, requires_grad=True) for s in shapes)
    _, ours_fwd = flops.count_flops(lambda: torch.einsum(spec, ta.detach(), tb.detach()))

    def torch_all():
        y = torch.einsum(spec, ta, tb)
        return torch.autograd.grad(y, (ta, tb), torch.zeros_like(y))

    _, ours_all = flops.count_flops(torch_all)
    assert (ours_fwd, ours_all) == (xla_fwd, xla_all)


@pytest.mark.parametrize("size,out,kernel,stride,padding,dilation", [
    (14, 14, 3, 1, 18, 18), (14, 14, 3, 1, 6, 6), (224, 112, 7, 2, 3, 1), (5, 3, 3, 2, 1, 1)])
def test_valid_pairs_against_a_count_by_hand(size, out, kernel, stride, padding, dilation):
    want = sum(1 for o in range(out) for t in range(kernel)
               if 0 <= o * stride - padding + t * dilation < size)
    assert flops.valid_pairs(size, out, kernel, stride, padding, dilation) == want


@pytest.fixture(scope="module")
def flagship_xla():
    """XLA's count of the JAX flagship forward and its output's shape."""
    import jax

    from __graft_entry__ import entry as jax_entry

    fn, args = jax_entry()
    out = jax.eval_shape(fn, *args)
    return _xla_flops(fn, *args), out


def test_flagship_forward_count_within_5_percent_below_xla(flagship_xla, monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    from cp2_tpu_torch.graft_entry import entry
    from cp2_tpu_torch.models import layers

    xla, _ = flagship_xla
    fn, args = entry(device="meta")
    _, ours = flops.count_flops(fn, *args)
    # XLA counts elementwise work too (BatchNorm, ReLU, the residual adds):
    # the port's count lies below it, by 4.1 % on this forward
    assert 0.95 * xla <= ours < xla, (ours, xla)
    with FlopCounterMode(display=False) as default:
        fn(*args)
    # torch's default conv formula counts the taps that read padding; the
    # tap split runs none at d = 12 and 18, but d = 6 still reads some
    assert default.get_total_flops() > ours
    # every convolution on cuDNN's plain path: the same count under XLA's
    # rule, and the default formula over every tap lands 30 % above XLA's
    monkeypatch.setattr(layers, "tap_split_engages", lambda conv, x: False)
    _, plain = flops.count_flops(fn, *args)
    assert plain == ours
    with FlopCounterMode(display=False) as default:
        fn(*args)
    assert default.get_total_flops() > 1.3 * xla


TAP_SPLIT_CONVS = [(14, 14, 12), (14, 14, 18), (22, 22, 12), (22, 22, 18), (9, 30, 12),
                   (5, 5, 12)]


@pytest.mark.parametrize("h,w,dilation", TAP_SPLIT_CONVS,
                         ids=[f"{h}x{w}d{d}" for h, w, d in TAP_SPLIT_CONVS])
def test_tap_split_conv_counts_as_the_plain_conv(h, w, dilation):
    """A convolution that ``models/layers.py::conv2d`` splits into its
    in-bounds taps counts, forward and with both gradients, what the plain
    convolution counts under XLA's rule, integer for integer: its pieces
    are the (output, tap) pairs that read inside the input."""
    from cp2_tpu_torch.models import layers

    conv = torch.nn.Conv2d(8, 4, 3, padding=dilation, dilation=dilation, bias=False)
    x = torch.zeros((2, 8, h, w), requires_grad=True)
    assert layers.tap_split_engages(conv, x)

    def fwd_and_grads(run):
        y = run()
        return torch.autograd.grad(y, (x, conv.weight), torch.zeros_like(y))

    def split():
        return layers.conv2d(conv, x, torch.float32)

    def plain():
        return torch.nn.functional.conv2d(x, conv.weight, None, 1, dilation, dilation)

    with torch.no_grad():
        assert flops.count_flops(split)[1] == flops.count_flops(plain)[1]
    assert flops.count_flops(fwd_and_grads, split)[1] == \
        flops.count_flops(fwd_and_grads, plain)[1]


@pytest.mark.parametrize("task", ["pretrain", "finetune"])
def test_tap_split_keeps_the_step_count(task, monkeypatch):
    """The flagship pretrain step (``config_pretrain.py``, 224², whose ASPP
    splits d = 12 and 18 at 14x14 in the query and the key forward) and the
    finetune step (``config_finetune.py``, 352², 22x22), counted on the
    meta device, count what they counted with every convolution on the
    plain path, integer for integer."""
    from cp2_tpu_torch.models import layers
    from cp2_tpu_torch.tools import bench_finetune, bench_pretrain_variant
    from cp2_tpu_torch.utils.benchmarking import model_config

    def count():
        if task == "pretrain":
            return bench_pretrain_variant.step_flops(model_config("config_pretrain.py"), "CP2",
                                                     "DEEPLABV3", 2, 224, augment=False)
        return bench_finetune.step_flops(model_config("config_finetune.py"), 2, 2, 352)

    layers.reset_tap_split_counts()
    split = count()
    assert layers.TAP_SPLITS["split"] == (4 if task == "pretrain" else 2)
    monkeypatch.setattr(layers, "tap_split_engages", lambda conv, x: False)
    assert count() == split


def _dense_inputs(n=2, s2=36, c=8, seed=0):
    r = np.random.RandomState(seed)
    q = torch.from_numpy(r.randn(n, s2, c).astype(np.float32))
    k = torch.from_numpy(r.randn(n, s2, c).astype(np.float32))
    a = torch.from_numpy((r.rand(n, s2) > 0.5).astype(np.float32))
    return q, k, a, a.flip(1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("grads", ["none", "q", "q_and_k"])
def test_dense_loss_counts_by_formula(device, grads):
    q, k, a, b = (t.to(device) for t in _dense_inputs())
    q.requires_grad_(grads != "none")
    k.requires_grad_(grads == "q_and_k")
    n, s2, c = q.shape

    def run():
        loss = dense_loss.dense_pair_loss(q, k, a, b, 0.2)
        if grads != "none":
            loss.backward()

    before = dict(dense_loss.LAUNCHES)
    _, counted = flops.count_flops(run)
    assert counted == 2 * n * s2 * s2 * c * {"none": 1, "q": 2, "q_and_k": 3}[grads]
    assert dense_loss.LAUNCHES == before  # no kernel off the card


def test_step_count_does_not_depend_on_the_route():
    """The CP2 step counted on the meta device
    (``tools/bench_pretrain_variant.py::step_flops``) and counted while it
    runs on the CPU (the dense loss on its plain version) agree integer for
    integer.  On the card the twins count the step with the kernels, and
    ``chip_smoke.py`` holds that count to this one."""
    from __graft_entry__ import _tiny_model_cfg

    from cp2_tpu_torch.tools import bench_pretrain_variant

    tiny = _tiny_model_cfg(128)  # the CP2 embedding width
    meta = bench_pretrain_variant.step_flops(tiny, "CP2", "DEEPLABV3", 2, 32, augment=False)
    state, step = bench_pretrain_variant.state_and_step(tiny, "cpu", "CP2", "DEEPLABV3", 32,
                                                        augment=False)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in bench_pretrain_variant.pretrain_batch_shapes(2, 32).items()}
    with torch.backends.mkldnn.flags(enabled=False):
        _, counted = flops.count_flops(step, state, batch)
    assert counted == meta and step.calls == 1


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A10G", None), ("cpu", None)])
def test_peak_bf16_flops_by_card_name(name, peak):
    assert flops.peak_bf16_flops(name) == peak


def test_mfu_is_per_step_times_steps_over_time_and_peak():
    assert flops.mfu(2e12, 10, 2.0, 1e15) == pytest.approx(0.01)
    assert flops.mfu(2e12, 10, 2.0, None) is None
    assert flops.mfu(None, 10, 2.0, 1e15) is None


def test_graft_entry_output_matches_jax_eval_shape(flagship_xla):
    """``cp2_tpu_torch.graft_entry.entry()``'s forward gives the shape and
    dtype ``jax.eval_shape`` gives for ``__graft_entry__.entry()``'s."""
    from cp2_tpu_torch.graft_entry import entry

    _, want = flagship_xla
    fn, args = entry(device="meta")
    got = fn(*args)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)

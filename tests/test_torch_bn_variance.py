"""What flax's one-pass BatchNorm variance does to a short finetune, against
the float noise between the two packages, on the CPU.

flax's ``nn.BatchNorm`` takes the batch variance as E[x²] − E[x]² by
default (``use_fast_variance=True``), in float32, and the JAX package
keeps that default; the port takes it in two passes (E[(x − E[x])²],
cuDNN's and torch's BatchNorm), and the other port tests set flax to two
passes to compare.

Twenty steps of ``make_seg_steps`` (``SEG_MODEL`` with its auxiliary head,
Adam at lr 1e-4, four batches in turn) run from the same weights on four
trajectories: JAX with two passes, JAX with one pass, the port, and the
port in float64 (the exact trajectory; its casts to float32 made casts to
float64).  After the 20 steps, the distances of the parameters (all
leaves as one vector; their norm is 71.5) and the largest distance of the
20 losses:

* **one pass**, JAX one pass against JAX two passes: what the formula moves;
* **the noise**, the port against JAX two passes: what the two packages'
  float arithmetic moves at the same formula.

Measured (printed by the tests):

| | parameters: one pass, noise | losses: one pass, noise | parameters from exact: JAX 2 passes, 1 pass, port |
|---|---|---|---|
| bfloat16 | 0.172, 0.213 | 4.55e-3, 8.04e-3 | 0.208, 0.197, 0.237 |
| float32 | 3.35e-2, 1.32e-2 | 1.51e-3, 1.59e-4 | 1.80e-2, 3.38e-2, 1.84e-2 |

So in bfloat16, the precision of every gate row and experiment script, one
pass stays inside the noise (asserted: within 1.5 × the noise); in
float32 it moves the trajectory 2.5 × (parameters) to 9.5 × (losses) the
noise, and it is the less exact formula (asserted: its trajectory at least
1.5 × as far from the exact one as the two-pass ones, measured 1.9 ×).
The port keeps two passes (ROADMAP §3, "Numerical findings", says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_port_common import HW, SEG_MODEL, fill_variables, to_plain_dict
from test_torch_segmentation_task import _batch, _jax_state, _torch_batch
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.ops.metrics import ConfusionState as JaxConfusion
from cp2_tpu.train import segmentation_task as jtask
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import build_segmentor
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.train import segmentation_task as task

HWS = (HW, HW)
STEPS = 20
LR, WD = 1e-4, 1e-4


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def numerics():
    """oneDNN off and two threads for the port (as the other port tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def start():
    model = jax_build_segmentor(SEG_MODEL)
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False,
                                               with_aux=True))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    return params, stats, [_batch(seed=s) for s in range(4)]


def _jax_run(params, stats, batches, dtype, two_pass):
    with pytest.MonkeyPatch.context() as patch:
        if two_pass:
            patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        model = jax_build_segmentor(dict(SEG_MODEL, dtype=dtype))
        tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
        step, _, _ = jtask.make_seg_steps(model, tx, 2, HWS)
        step = jax.jit(step)
        state, losses = _jax_state(params, stats, tx), []
        for i in range(STEPS):
            state, _, m = step(state, batches[i % len(batches)], jax.random.PRNGKey(i),
                               JaxConfusion.create(2))
            losses.append(float(m["loss"]))
    return to_plain_dict(state.params), losses


def _port_run(params, stats, batches, dtype):
    """The port's 20 steps; in float64 with its casts to float32
    (``Tensor.float``) made casts to float64, the exact trajectory."""
    model = build_segmentor(dict(SEG_MODEL, dtype=dtype))
    load_flax_into(model, params, stats)
    if dtype == torch.float64:
        model.double()
    state = task.create_seg_state(model, task.make_adam(LR, WD), "cpu")
    train_step, _, _ = task.make_seg_steps(2, HWS)
    losses = []
    with pytest.MonkeyPatch.context() as patch:
        if dtype == torch.float64:
            patch.setattr(torch.Tensor, "float", lambda self: self.double())
        for i in range(STEPS):
            batch = _torch_batch(batches[i % len(batches)])
            batch["image"] = batch["image"].to(dtype if dtype == torch.float64 else torch.float32)
            state, _, m = train_step(state, batch, torch.Generator().manual_seed(i),
                                     ConfusionState.create(2))
            losses.append(float(m["loss"]))
    ours, _ = state_dict_to_flax(state.model.state_dict())
    return ours, losses


def _flat(tree):
    out = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(_flat(value) if isinstance(value, dict) else [np.ravel(np.asarray(value,
                                                                              np.float64))])
    return out


def _distance(a, b):
    return float(np.linalg.norm(np.concatenate(_flat(a)) - np.concatenate(_flat(b))))


def _trajectories(start, dtype):
    params, stats, batches = start
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    two, two_losses = _jax_run(params, stats, batches, jdt, two_pass=True)
    one, one_losses = _jax_run(params, stats, batches, jdt, two_pass=False)
    port, port_losses = _port_run(params, stats, batches, tdt)
    assert np.isfinite(two_losses).all() and two_losses[-1] < two_losses[0]
    return {"two": (two, two_losses), "one": (one, one_losses), "port": (port, port_losses)}


@pytest.fixture(scope="module")
def exact(start):
    params, stats, batches = start
    return _port_run(params, stats, batches, torch.float64)[0]


def _report(dtype, runs, exact):
    (two, two_losses), (one, one_losses), (port, port_losses) = (
        runs["two"], runs["one"], runs["port"])
    one_pass, noise = _distance(one, two), _distance(port, two)
    loss_one = max(abs(a - b) for a, b in zip(one_losses, two_losses))
    loss_noise = max(abs(a - b) for a, b in zip(port_losses, two_losses))
    from_exact = {k: _distance(v[0], exact) for k, v in runs.items()}
    print(f"\n{dtype}: parameters one pass {one_pass:.3e}, noise {noise:.3e} "
          f"(norm {np.linalg.norm(np.concatenate(_flat(two))):.1f}); losses one pass "
          f"{loss_one:.3e}, noise {loss_noise:.3e}; from exact: JAX two passes "
          f"{from_exact['two']:.3e}, one pass {from_exact['one']:.3e}, port "
          f"{from_exact['port']:.3e}")
    return one_pass, noise, loss_one, loss_noise, from_exact


def test_one_pass_variance_stays_inside_the_noise_in_bf16(start, exact):
    one_pass, noise, loss_one, loss_noise, _ = _report(
        "bfloat16", _trajectories(start, "bfloat16"), exact)
    assert one_pass <= 1.5 * noise, (one_pass, noise)
    assert loss_one <= 1.5 * loss_noise, (loss_one, loss_noise)


def test_one_pass_variance_is_the_less_exact_in_float32(start, exact):
    _, _, _, _, from_exact = _report("float32", _trajectories(start, "float32"), exact)
    assert from_exact["one"] >= 1.5 * max(from_exact["two"], from_exact["port"]), from_exact

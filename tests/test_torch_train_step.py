"""The port's CP2 pretrain step against the JAX package's, on the CPU.

Both start from one bridged state (tiny flagship-structure model, queue
64, batch 2, 64x64, SGD momentum 0.9 / wd 1e-4) and take the pre-augmented
batch form of ``bench.py``, the same batch every step as there.  The JAX
step runs as the package's ``make_pretrain_step`` under ``jax.jit`` with
``metrics_level`` 0, which computes the dense loss by einsum; on CPU
tensors the port's step takes the plain dense loss.  Pinned after 1 and
after 3 steps: the loss, params, the params' change, ema_params, both
batch_stats trees, the queue, queue_ptr and step.

Two more one-step runs take raw uint8 frames through the on-device
augmentation, at ``metrics_level`` 1 and 2: the JAX step augments inside
itself on ``fold_in(key, step)``, and the port's ``augment_fn`` applies
those draws, replayed (``_torch_port_common.replay_jax_pretrain_params``).
They pin every metric key and value, ``_visual/*`` arrays included, and
the state.  The state after an augmented step is held at 2e-3 (update and
all): this model's gradient on augmented frames is sensitive to rounding
in its input, and the JAX step disagrees with itself by that much.  Fed
its own augmentation once eagerly and once under ``jax.jit`` (which part
by up to 1.5e-5 in the images), the JAX step's conv1 update parts by
1.9e-3 of its largest element (2.15); the port, fed the eager images,
parts from the eager-fed JAX step by 6.5e-4.

Tolerance: rtol 1e-4 after 1 step and 1e-3 after 3, each with an absolute
floor of the same fraction of the array's largest magnitude
(``assert_close``).  Two deviations, measured on this model:

* The JAX side runs flax's BatchNorm with its two-pass variance
  E[(x-E[x])^2] (``use_fast_variance=False``), the port's formula, rather
  than its default one-pass E[x^2]-E[x]^2.  The one-pass form loses digits
  where a channel's mean dwarfs its spread (the image-pool BatchNorm over
  2 samples reaches mean^2/var ~ 3e3): after one step the JAX step's two
  variance forms part by 3.1e-2 of the largest update of a parameter,
  where the port and the two-pass JAX step part by 8e-5.  One case holds
  the port to the default JAX step after 1 step at 5e-2 for that reason.
* The 3-step cases use lr 1e-3 instead of 0.1.  At 0.1 (and at 0.01) an
  update changes the weights of this narrow random model by up to their
  own size, and a float32 and a float64 run of the port itself part by
  0.6 of a weight after 3 steps, so no float32 comparison can hold them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_port_common import (
    BATCH,
    DIM,
    HW,
    TINY_MODEL,
    assert_close,
    assert_trees_close,
    jax_encoder,
    pre_augmented_batch,
    random_flax_variables,
    replay_jax_pretrain_params,
    to_plain_dict,
    torch_encoder,
    unit_queue,
)
from cp2_tpu.augment import AugmentConfig as JaxAugmentConfig
from cp2_tpu.augment import pretrain_batch_augment as jax_pretrain_batch_augment
from cp2_tpu.ssl import SSLHyperParams as JaxHyperParams
from cp2_tpu.ssl.model import output_stride_of as jax_output_stride_of
from cp2_tpu.ssl.state import PretrainState as JaxPretrainState
from cp2_tpu.ssl.train_step import (
    backbone_output_stride_of as jax_backbone_output_stride_of,
    epoch_scalar_names,
    make_optimizer as jax_make_optimizer,
    make_pretrain_step as jax_make_pretrain_step,
)
from cp2_tpu.types import BackboneType as JaxBackboneType
from cp2_tpu.types import PretrainType as JaxPretrainType
from cp2_tpu_torch.augment import AugmentConfig, apply_pretrain_augment
from cp2_tpu_torch.checkpoint.bridge import (
    load_pretrain_state_from_flax,
    pretrain_state_to_flax,
)
from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state, output_stride_of
from cp2_tpu_torch.ssl.train_step import (
    epoch_scalar_names as torch_epoch_scalar_names,
    make_optimizer,
    make_pretrain_step,
)
from cp2_tpu_torch.types import PretrainType

QUEUE_LEN = 64
LR = {1: 0.1, 3: 1e-3}
TOL = {1: 1e-4, 3: 1e-3}
FAST_VARIANCE_TOL = 5e-2
AUGMENTED_STATE_TOL = 2e-3


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


def _initial_tree():
    params, stats = random_flax_variables(jax_encoder(), seed=0)
    return {
        "params": params,
        "batch_stats": stats,
        "ema_params": copy.deepcopy(params),
        "ema_batch_stats": copy.deepcopy(stats),
        "queue": unit_queue(1, QUEUE_LEN),
        "queue_ptr": np.int32(0),
        "queue2": unit_queue(2, QUEUE_LEN),
        "queue2_ptr": np.int32(0),
        "step": np.int32(0),
    }


def _jax_run(tree, batches, lr, epoch_scalars, two_pass=True, metrics_level=0,
             augment=False):
    model = jax_encoder()
    hp = JaxHyperParams.for_variant(JaxPretrainType.CP2, dim=DIM, queue_len=QUEUE_LEN)
    tx = jax_make_optimizer("sgd", lr)
    state = JaxPretrainState(
        step=jnp.asarray(tree["step"]),
        params=tree["params"],
        batch_stats=tree["batch_stats"],
        ema_params=tree["ema_params"],
        ema_batch_stats=tree["ema_batch_stats"],
        opt_state=tx.init(tree["params"]),
        queue=jnp.asarray(tree["queue"]),
        queue_ptr=jnp.asarray(tree["queue_ptr"]),
        queue2=jnp.asarray(tree["queue2"]),
        queue2_ptr=jnp.asarray(tree["queue2_ptr"]),
    )
    step = jax.jit(jax_make_pretrain_step(
        model, tx, hp, jax_output_stride_of(TINY_MODEL),
        jax_backbone_output_stride_of(TINY_MODEL, JaxBackboneType.DEEPLABV3),
        metrics_level=metrics_level, epoch_scalars=epoch_scalars,
        augment_fn=(lambda rng, raw: jax_pretrain_batch_augment(
            rng, raw, JaxAugmentConfig(out_hw=(HW, HW)))) if augment else None,
    ))
    out = []
    with pytest.MonkeyPatch.context() as patch:
        if two_pass:  # traced at the first call
            patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        for batch in batches:
            state, metrics = step(state, batch, jax.random.PRNGKey(0))
            snap = {k: to_plain_dict(getattr(state, k)) for k in (
                "params", "batch_stats", "ema_params", "ema_batch_stats", "queue",
                "queue_ptr", "step")}
            out.append((snap, to_plain_dict(metrics)))
    return out


def _torch_run(tree, batches, lr, epoch_scalars, metrics_level=0, augment_fn=None):
    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=DIM, queue_len=QUEUE_LEN)
    state = create_pretrain_state(torch_encoder(), make_optimizer("sgd", lr), hp,
                                  device="cpu")
    load_pretrain_state_from_flax(state, tree)
    step = make_pretrain_step(hp, output_stride_of(TINY_MODEL), metrics_level=metrics_level,
                              epoch_scalars=epoch_scalars, augment_fn=augment_fn)
    out = []
    for batch in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((pretrain_state_to_flax(state),
                    {k: v.numpy() for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def runs():
    """``get(n_steps, epoch_scalars, two_pass)`` → (JAX run, port run), each a
    list of (state tree, metrics) per step; computed once per key."""
    tree = _initial_tree()
    cache = {}

    def get(n_steps, epoch_scalars=False, two_pass=True):
        key = (n_steps, epoch_scalars, two_pass)
        if key not in cache:
            batches = [pre_augmented_batch(0)] * n_steps
            lr = LR[n_steps]
            cache[key] = (_jax_run(tree, batches, lr, epoch_scalars, two_pass),
                          _torch_run(tree, batches, lr, epoch_scalars))
        return tree, cache[key]

    return get


def _delta(tree, start):
    return {k: _delta(v, start[k]) if isinstance(v, dict) else v - start[k]
            for k, v in tree.items()}


def _states_close(state, ref_state, start, tol, n_steps):
    for name in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        assert_trees_close(state[name], ref_state[name], tol, name)
    if n_steps == 1:
        # the change of the params holds the gradients to the same
        # tolerance (at lr 1e-3 a float32 weight's rounding is 1e-3 of it)
        assert_trees_close(_delta(state["params"], start["params"]),
                     _delta(ref_state["params"], start["params"]), tol, "update")
    assert_close(state["queue"], ref_state["queue"], tol, "queue")
    assert int(state["queue_ptr"]) == int(ref_state["queue_ptr"]) == n_steps * BATCH
    assert int(state["step"]) == int(ref_state["step"]) == n_steps


@pytest.mark.parametrize("n_steps", [1, 3])
def test_cp2_steps_match_jax(runs, n_steps):
    # the 3-step runs carry epoch_scalars, which adds metrics and leaves
    # the state as it is: one JAX compile fewer
    start, (jax_out, torch_out) = runs(n_steps, epoch_scalars=n_steps == 3)
    ref_state, ref_metrics = jax_out[-1]
    state, metrics = torch_out[-1]
    tol = TOL[n_steps]
    assert np.isfinite(metrics["loss"])
    for (_, m), (_, ref_m) in zip(torch_out, jax_out):
        assert_close(m["loss"], ref_m["loss"], tol, "loss")
    _states_close(state, ref_state, start, tol, n_steps)


def test_cp2_step_matches_default_jax_step(runs):
    """One step against the JAX step exactly as the package runs it, with
    flax's one-pass BatchNorm variance (see the module docstring)."""
    start, (jax_out, torch_out) = runs(1, two_pass=False)
    (ref_state, ref_metrics), (state, metrics) = jax_out[-1], torch_out[-1]
    assert_close(metrics["loss"], ref_metrics["loss"], TOL[1], "loss")
    _states_close(state, ref_state, start, FAST_VARIANCE_TOL, 1)


def test_epoch_scalars_match_jax(runs):
    """``epoch_scalars=True``: the packed ``_epoch_vec`` of every step, in
    the JAX package's ``epoch_scalar_names`` order, and the same state."""
    assert torch_epoch_scalar_names(PretrainType.CP2) == epoch_scalar_names(
        JaxPretrainType.CP2)
    start, (jax_out, torch_out) = runs(3, epoch_scalars=True)
    for (_, ref_metrics), (_, metrics) in zip(jax_out, torch_out):
        assert_close(metrics["_epoch_vec"], ref_metrics["_epoch_vec"], TOL[3], "_epoch_vec")
        assert metrics["loss"] == metrics["_epoch_vec"][0]
    _states_close(torch_out[-1][0], jax_out[-1][0], start, TOL[3], 3)


RAW_HW = (72, 80)


@pytest.fixture(scope="module")
def augmented_runs():
    """``get(metrics_level)`` → (JAX run, port run) of one step on raw uint8
    frames, augmented on the device: the JAX step's own draws, replayed
    into the port's ``augment_fn``."""
    tree = _initial_tree()
    r = np.random.RandomState(5)
    raw = {name: r.randint(0, 256, (BATCH, *RAW_HW, 3)).astype(np.uint8)
           for name in ("fg", "bg0", "bg1")}
    # the JAX step's augmentation key: split(fold_in(key, step 0))[0]
    aug_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))[0]
    cfg = AugmentConfig(out_hw=(HW, HW))
    params = replay_jax_pretrain_params(aug_rng, BATCH, RAW_HW, cfg)
    drawn_on = []

    def augment_fn(generator, frames):
        drawn_on.append(generator.device)
        return apply_pretrain_augment(frames, params, cfg)

    cache = {}

    def get(metrics_level):
        if metrics_level not in cache:
            cache[metrics_level] = (
                _jax_run(tree, [raw], LR[1], False, metrics_level=metrics_level, augment=True),
                _torch_run(tree, [raw], LR[1], False, metrics_level=metrics_level,
                           augment_fn=augment_fn))
            assert drawn_on[-1] == torch.device("cpu")  # the state's device
        return tree, cache[metrics_level]

    return get


@pytest.mark.parametrize("metrics_level", [1, 2])
def test_cp2_step_metrics_match_jax(augmented_runs, metrics_level):
    """The same metric keys as the JAX step at ``metrics_level`` 1 and 2,
    each value (the ``_visual/*`` arrays at level 2 too) at rtol 1e-4.  The
    absolute floor is 1e-4 of the metric's scale: 1 for the score
    statistics (cosines in [-1, 1], whose quartiles may sit near 0), else
    the value's own magnitude."""
    _, (jax_out, torch_out) = augmented_runs(metrics_level)
    ref_metrics, metrics = jax_out[-1][1], torch_out[-1][1]
    assert set(metrics) == set(ref_metrics)
    assert any(k.startswith("_visual/") for k in metrics) == (metrics_level == 2)
    for key in ("step/average_iou", "step/dense_per_sample_median_negative_scores",
                "step/instance_upper_negative_scores", "train/+ive_scores_step"):
        assert key in metrics, key
    for key, value in ref_metrics.items():
        scale = 1.0 if "scores" in key else float(np.abs(value).max())
        np.testing.assert_allclose(np.asarray(metrics[key], np.float64), value, rtol=TOL[1],
                                   atol=TOL[1] * scale, err_msg=key)


def test_augmented_step_matches_jax(augmented_runs):
    """One step through ``augment_fn`` on raw frames: the loss equals the
    JAX step's at 1e-4, which augmented inside itself, and the state after
    it at 2e-3 (see the module docstring)."""
    start, (jax_out, torch_out) = augmented_runs(1)
    assert_close(torch_out[-1][1]["loss"], jax_out[-1][1]["loss"], TOL[1], "loss")
    _states_close(torch_out[-1][0], jax_out[-1][0], start, AUGMENTED_STATE_TOL, 1)

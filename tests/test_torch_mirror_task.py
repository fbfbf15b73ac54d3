"""The port's mirror (CutPaste) task steps against the JAX package's, on the
CPU.

The segmentor is ``config_finetune.py``'s structure at narrow widths
(``SEG_MODEL`` without its auxiliary head, as the mirror CLI builds it:
dilated ResNet-50 at width 8 under an ASPP-16 classifier) on 64x64 inputs,
dropout 0 for the comparisons with JAX (torch cannot replay JAX's dropout
draws); both sides start from numpy weights through the bridge.  flax's
BatchNorm computes its variance in two passes, as in the other port tests.

* ``mirror_consistency_loss`` with and without a sample mask: 1e-6
  relative (a few float32 softmaxes and one mean).
* One train step of each ``MirrorVariant`` against ``make_mirror_steps``:
  the loss and its two parts at 1e-5, each parameter's gradient to 5e-5 of
  that parameter's largest gradient, and the BatchNorm running statistics
  at 1e-5.  5e-5 is the finetune step's bound, for the same network and
  the same reason (``tests/test_torch_segmentation_task.py``: float32
  cannot resolve its gradient through sixteen train-mode BatchNorms to
  1e-5).  OUTPUT runs two forwards, the second on the statistics the first
  updated, and weights the consistency term at 1.0 here (0.01 in the CLI)
  so that its gradient shows.  The batch is seed 1's: on seed 0's, a
  float64 run of the port puts the port's float32 gradient 2.7e-2 from
  exact in NONE's step (the 7x7 stem convolution's float32 sums, on
  torch's CPU kernels with or without oneDNN, through the stem
  BatchNorm's cancellation; the same step with that one convolution in
  float64 is 5.5e-5 from exact), and JAX's 5.7e-4; on seed 1's both
  float32 gradients are within 3.1e-5 of the float64 one (``ROADMAP.md`` §3, numerical findings).
* The eval step with a padded row: confusion counts exactly, the loss at
  1e-5 and the weight.
* Dropout: with ``image == mirror`` and dropout 0.1, the two train forwards
  of one OUTPUT step give equal logits (one dropout draw, as JAX's shared
  key), while two forwards on a generator left to run on differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_port_common import (
    HW,
    SEG_MODEL,
    assert_close,
    assert_trees_close,
    fill_variables,
    to_plain_dict,
)
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.ops.metrics import ConfusionState as JaxConfusion
from cp2_tpu.train import mirror_task as jmirror
from cp2_tpu.train import segmentation_task as jtask
from cp2_tpu.types import MirrorVariant as JaxMirrorVariant
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import build_segmentor
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.train import mirror_task
from cp2_tpu_torch.train import segmentation_task as task
from cp2_tpu_torch.types import MirrorVariant

RTOL = 1e-5
GRAD_TOL = 5e-5  # see the module docstring
HWS = (HW, HW)
MIRROR_MODEL = dict(SEG_MODEL, auxiliary_head=None)


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def numerics():
    """oneDNN off and two threads for the port, two-pass BatchNorm variance
    for flax (see ``tests/test_torch_heads_necks.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        yield
    torch.set_num_threads(threads)


def _images(r, n):
    """Images whose brightness and contrast differ per image (the ASPP
    image-pool branch normalises per-image means over the batch)."""
    image = r.rand(n, HW, HW, 3) * r.uniform(0.2, 1.0, (n, 1, 1, 3)) + r.uniform(0, 0.5, (n, 1, 1, 3))
    return np.clip(image, 0.0, 1.0).astype(np.float32)


def _batch(seed=0, n=4):
    r = np.random.RandomState(seed)
    mask = r.randint(0, 2, (n, HW // 8, HW // 8)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    return {"image": _images(r, n), "mirror": _images(r, n), "mask": mask}


@pytest.fixture(scope="module")
def seg():
    model = jax_build_segmentor(MIRROR_MODEL)
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    return model, params, stats


def _port_state(params, stats, model_cfg=MIRROR_MODEL):
    model = build_segmentor(model_cfg)
    load_flax_into(model, params, stats)
    return task.create_seg_state(model, task.make_adam(1e-4, 1e-4), "cpu")


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _capture_grads():
    """An optax transform whose update is zero and whose state is the
    gradient it was given: the step's own gradients, read from its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_state(params, stats, tx):
    return jtask.SegTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params))


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "sample_mask"])
def test_consistency_loss_matches_jax(masked):
    r = np.random.RandomState(1)
    s, t = (r.randn(3, 8, 8, 4).astype(np.float32) * 3 for _ in range(2))
    mask = np.array([True, False, True]) if masked else None
    ref = jmirror.mirror_consistency_loss(jnp.asarray(s), jnp.asarray(t), 2.0,
                                          None if mask is None else jnp.asarray(mask))
    ours = mirror_task.mirror_consistency_loss(torch.from_numpy(s), torch.from_numpy(t), 2.0,
                                               None if mask is None else torch.from_numpy(mask))
    assert_close(ours.numpy(), np.asarray(ref), 1e-6, "consistency loss")


@pytest.mark.parametrize("variant", ["OUTPUT", "NONE"])
def test_train_step_matches_jax(seg, variant):
    model, params, stats = seg
    batch = _batch(seed=1)  # see the module docstring
    lmbd = 1.0
    tx = _capture_grads()
    step, _ = jmirror.make_mirror_steps(model, tx, 2, HWS,
                                        mirror_variant=JaxMirrorVariant[variant],
                                        lmbd_compare_loss=lmbd)
    new, confusion, ref = jax.jit(step)(_jax_state(params, stats, tx), batch,
                                        jax.random.PRNGKey(0), JaxConfusion.create(2))
    train_step, _ = mirror_task.make_mirror_steps(2, HWS, mirror_variant=MirrorVariant[variant],
                                                  lmbd_compare_loss=lmbd)
    state, ours_conf, ours = train_step(_port_state(params, stats), _torch(batch),
                                        torch.Generator().manual_seed(0), ConfusionState.create(2))
    assert state.step == 1
    assert set(ours) == set(ref) == {"train_loss", "train_class_loss", "train_compare_loss"}
    for k in ours:
        assert_close(ours[k].numpy(), np.asarray(ref[k]), RTOL, k)
    if variant == "OUTPUT":
        assert float(ours["train_compare_loss"]) > 0
    grads, _ = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})
    assert_trees_close(grads, to_plain_dict(new.opt_state), GRAD_TOL, "grads")
    _, new_stats = state_dict_to_flax(state.model.state_dict())
    assert_trees_close(new_stats, to_plain_dict(new.batch_stats), RTOL, "stats")
    np.testing.assert_array_equal(ours_conf.matrix.numpy(),
                                  np.asarray(confusion.matrix).astype(np.int64))


@pytest.mark.parametrize("variant", ["OUTPUT", "NONE"])
def test_eval_step_with_padded_row_matches_jax(seg, variant):
    model, params, stats = seg
    batch = _batch(seed=3, n=3)
    batch["valid"] = np.array([True, True, False])
    tx = _capture_grads()
    _, eval_step = jmirror.make_mirror_steps(model, tx, 2, HWS,
                                             mirror_variant=JaxMirrorVariant[variant])
    ref_conf, ref = jax.jit(eval_step)(_jax_state(params, stats, tx), batch,
                                       JaxConfusion.create(2))
    _, ours_eval = mirror_task.make_mirror_steps(2, HWS, mirror_variant=MirrorVariant[variant])
    state = _port_state(params, stats)
    conf, m = ours_eval(state, _torch(batch), ConfusionState.create(2))
    assert state.model.training  # the step leaves the mode as it found it
    np.testing.assert_array_equal(conf.matrix.numpy(),
                                  np.asarray(ref_conf.matrix).astype(np.int64))
    views = 2 if variant == "OUTPUT" else 1
    assert int(conf.matrix.sum()) == views * 2 * HW * HW  # the pad row is not counted
    assert float(m["weight"]) == float(ref["weight"]) == 2.0
    assert_close(m["val_loss"].numpy(), np.asarray(ref["val_loss"]), RTOL, "val_loss")


def test_both_forwards_share_one_dropout_draw(seg):
    _, params, stats = seg
    cfg = dict(MIRROR_MODEL, decode_head=dict(MIRROR_MODEL["decode_head"], dropout_ratio=0.1))
    state = _port_state(params, stats, cfg)
    batch = _torch(_batch(seed=5))
    batch["mirror"] = batch["image"].clone()
    outs = []
    hook = state.model.decode_head.register_forward_hook(
        lambda _m, _a, out: outs.append(out.detach().clone()))
    train_step, _ = mirror_task.make_mirror_steps(2, HWS)
    _, _, m = train_step(state, batch, torch.Generator().manual_seed(3), ConfusionState.create(2))
    assert len(outs) == 2
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    # the draws are live: two forwards on a generator left to run on differ
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        task.seg_forward(state.model, batch["image"], HWS, generator=gen)
    hook.remove()
    assert not torch.equal(outs[2], outs[3])
    assert np.isfinite(float(m["train_loss"]))

"""The port's segmentation ops against the JAX package's, on the CPU:
``ops/resize.py``, ``ops/metrics.py`` and ``ops/seg_losses.py``.

* resizes at rtol 1e-5 (with ``assert_close``'s absolute floor), in both
  directions: JAX's linear resize antialiases when it downsamples, and the
  port builds the same weights;
* confusion counts, ``compute_metrics`` and ``intersect_and_union`` exactly
  (the counts are integers; the ratios are the same float32 operations);
* each loss and its gradient with respect to the logits at 1e-5, OHEM
  weights exactly, accuracy at 1e-5.

Shapes are tiny: batch 2, 9x11 label maps, 2-5 classes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import assert_close
from cp2_tpu.ops import metrics as jm
from cp2_tpu.ops import resize as jr
from cp2_tpu.ops import seg_losses as jl
from cp2_tpu_torch.ops import metrics as tm
from cp2_tpu_torch.ops import resize as tr
from cp2_tpu_torch.ops import seg_losses as tl

RTOL = 1e-5

RESIZES = {
    "up": ((2, 5, 7, 3), (22, 23)),  # the finetune path's direction
    "down": ((2, 22, 23, 3), (5, 7)),  # antialiased in JAX
    "down_h_up_w": ((1, 17, 4, 2), (6, 13)),
    "same_h": ((1, 6, 9, 2), (6, 4)),
}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_bilinear_matches_jax(case):
    shape, out_hw = RESIZES[case]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = jr.resize_bilinear(jnp.asarray(x), out_hw)
    ours = tr.resize_bilinear(torch.from_numpy(x), out_hw)
    assert_close(ours.numpy(), np.asarray(ref), RTOL, case)
    for mode in ("bilinear", "nearest"):
        assert_close(tr.resize(torch.from_numpy(x), out_hw, mode=mode).numpy(),
                     np.asarray(jr.resize(jnp.asarray(x), out_hw, mode=mode)), RTOL, mode)


def test_upsampling_equals_interpolate():
    """Upsampling (the finetune logits' direction) is ``F.interpolate``'s
    bilinear resize with ``align_corners=False``."""
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 5, 7).astype(np.float32))
    ref = torch.nn.functional.interpolate(x, (22, 35), mode="bilinear", align_corners=False)
    ours = tr.resize_bilinear(x.permute(0, 2, 3, 1), (22, 35)).permute(0, 3, 1, 2)
    assert_close(ours.numpy(), ref.numpy(), RTOL)


@pytest.mark.parametrize("out_hw", [(13, 5), (3, 17), (8, 8)])
def test_nearest_resizes_match_jax(out_hw):
    ids = np.random.RandomState(2).randint(0, 100, (2, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        tr.nearest_exact_resize(torch.from_numpy(ids), out_hw).numpy(),
        np.asarray(jr.nearest_exact_resize(jnp.asarray(ids), out_hw)))
    x = np.random.RandomState(3).randn(2, 4, 5, 3).astype(np.float32)
    for mode in ("nearest", "bilinear"):
        np.testing.assert_allclose(
            tr.upsample(torch.from_numpy(x), 3, mode).numpy(),
            np.asarray(jr.upsample(jnp.asarray(x), 3, mode)), rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(tr.rescale_ids(torch.from_numpy(ids), 2).numpy(),
                                  np.asarray(jr.rescale_ids(jnp.asarray(ids), 2)))


# ---------------------------------------------------------------------------
# confusion counts and metrics
# ---------------------------------------------------------------------------

def _maps(seed, classes, shape=(3, 9, 11)):
    r = np.random.RandomState(seed)
    preds = r.randint(0, classes, shape).astype(np.int32)
    targets = r.randint(0, classes, shape).astype(np.int32)
    targets[0, :2] = 255  # outside [0, C): counted nowhere
    return preds, targets


@pytest.mark.parametrize("classes,masked", [(2, False), (2, True), (5, False), (5, True)])
def test_confusion_and_metrics_match_jax_exactly(classes, masked):
    sample_mask = np.array([True, True, False]) if masked else None
    ours = tm.ConfusionState.create(classes)
    ref = jm.ConfusionState.create(classes)
    for seed in (0, 1):
        preds, targets = _maps(seed + 10 * classes, classes)
        ours = ours.update(torch.from_numpy(preds), torch.from_numpy(targets),
                           None if sample_mask is None else torch.from_numpy(sample_mask))
        ref = ref.update(jnp.asarray(preds), jnp.asarray(targets),
                         None if sample_mask is None else jnp.asarray(sample_mask))
    assert ours.matrix.dtype == torch.int64
    np.testing.assert_array_equal(ours.matrix.numpy(), np.asarray(ref.matrix).astype(np.int64))
    binary = classes == 2
    ignore = None if binary else 0
    got = tm.compute_metrics(ours, binary=binary, ignore_index=ignore, prefix="val_")
    want = jm.compute_metrics(ref, binary=binary, ignore_index=ignore, prefix="val_")
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_intersect_and_union_and_eval_metrics_match_jax(ignore_index):
    preds, targets = _maps(3, 4)
    ours = tm.intersect_and_union(torch.from_numpy(preds), torch.from_numpy(targets), 4,
                                  ignore_index)
    ref = jm.intersect_and_union(jnp.asarray(preds), jnp.asarray(targets), 4, ignore_index)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    metrics = ("mIoU", "mDice", "mFscore")
    got = tm.eval_metrics(*ours, metrics=metrics)
    want = jm.eval_metrics(*ref, metrics=metrics)
    assert set(got) == set(want)
    for key, value in want.items():
        assert_close(got[key].numpy(), np.asarray(value), RTOL, key)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(classes, seed=4):
    r = np.random.RandomState(seed)
    logits = (2.0 * r.randn(2, 9, 11, classes)).astype(np.float32)
    labels = r.randint(0, classes, (2, 9, 11)).astype(np.int32)
    labels[1, 3:5] = 255  # ignored
    return logits, labels


LOSSES = {
    "ce": (3, "CrossEntropyLoss", {}),
    "ce_class_weight": (3, "CrossEntropyLoss", dict(class_weight=[0.5, 1.0, 2.0],
                                                    loss_weight=0.7)),
    "ce_sigmoid": (3, "CrossEntropyLoss", dict(use_sigmoid=True)),
    "ce_pixel_weight": (2, "CrossEntropyLoss", dict(weight="pixels")),
    "ce_no_ignore": (4, "CrossEntropyLoss", dict(ignore_index=None)),
    "dice": (3, "DiceLoss", dict(class_weight=[1.0, 0.5, 2.0])),
    "dice_exponent1": (2, "DiceLoss", dict(exponent=1.0, smooth=0.5)),
    "lovasz": (4, "LovaszLoss", {}),
    "lovasz_all": (3, "LovaszLoss", dict(classes="all", loss_weight=2.0)),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_and_gradients_match_jax(case):
    classes, name, kw = LOSSES[case]
    logits, labels = _loss_inputs(classes)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight") == "pixels":
        w = np.random.RandomState(5).rand(2, 9, 11).astype(np.float32)
        jkw["weight"], tkw["weight"] = jnp.asarray(w), torch.from_numpy(w)
    if "class_weight" in kw:
        jkw["class_weight"] = jnp.asarray(kw["class_weight"], jnp.float32)
    ref_fn = jl.LOSSES.get(name)
    ref, ref_grad = jax.value_and_grad(lambda x: ref_fn(x, jnp.asarray(labels), **jkw))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    ours = tl.LOSSES.get(name)(x, torch.from_numpy(labels), **tkw)
    ours.backward()
    assert_close(ours.detach().numpy(), np.asarray(ref), RTOL, case)
    assert_close(x.grad.numpy(), np.asarray(ref_grad), RTOL, case + " grad")


@pytest.mark.parametrize("thresh,min_kept", [(None, 50), (0.7, 20), (0.2, 400), (None, 1)])
def test_ohem_weights_match_jax_exactly(thresh, min_kept):
    logits, labels = _loss_inputs(3, seed=6)
    ref = jl.ohem_weights(jnp.asarray(logits), jnp.asarray(labels), thresh=thresh,
                          min_kept=min_kept)
    ours = tl.ohem_weights(torch.from_numpy(logits), torch.from_numpy(labels),
                           thresh=thresh, min_kept=min_kept)
    assert 0 < float(ours.sum()) < ours.numel()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_seg_accuracy_matches_jax():
    logits, labels = _loss_inputs(5, seed=7)
    logits[0, 0, :, 1] = logits[0, 0, :, 3]  # ties between a lower and a higher channel
    ref = jl.seg_accuracy(jnp.asarray(logits), jnp.asarray(labels), topk=(1, 2, 3))
    ours = tl.seg_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), topk=(1, 2, 3))
    for o, r in zip(ours, ref):
        assert_close(o.numpy(), np.asarray(r), RTOL)
    assert_close(tl.seg_accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
                 np.asarray(jl.seg_accuracy(jnp.asarray(logits), jnp.asarray(labels))), RTOL)

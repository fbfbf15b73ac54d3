"""PROPOSED's objective in the port against the JAX package's, on the CPU.

``cp2_objective`` on both sides, for every mapping type with correspondence
weights (PIXEL_ID, REGION_ID, PIXEL_REGION_ID at ``scripts/proposed.sh``'s
10/1/0) and every negative type (NONE, FIXED, AVERAGE, MEDIAN, HARD at
scale 2): the loss, its gradient with respect to the query features, and
the metrics of ``metrics_level`` 1.  The query "model" is a holder of its
dense features (one parameter, shaped like the dense output), so the
gradient with respect to that parameter is the gradient with respect to
the query features.  The batch has two views whose pixel ids overlap in
part, SAM-like region ids in 0..4 (0 unknown) and erased backgrounds.

These weights and negative types take the plain route (einsum →
``negative_reshape`` → weights → ``cp2_dense_loss``), never the kernel;
one more case holds the kernel route against the plain route where both
apply (unit weights, NONE).  Tolerance: rtol 1e-5 with an absolute floor
of 1e-5 of the array's largest magnitude; the score statistics (cosines,
whose quartiles may sit near 0) take their floor from 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

from _torch_port_common import assert_close, unit_queue
from cp2_tpu.ssl import SSLHyperParams as JaxHyperParams
from cp2_tpu.ssl import objectives as jax_obj
from cp2_tpu.types import MappingType as JaxMappingType
from cp2_tpu.types import NegativeType as JaxNegativeType
from cp2_tpu.types import PretrainType as JaxPretrainType
from cp2_tpu_torch.ssl import SSLHyperParams
from cp2_tpu_torch.ssl import objectives as obj
from cp2_tpu_torch.types import MappingType, NegativeType, PretrainType

N, HW, OS, C, QUEUE = 2, 32, 4, 16, 64
GRID = HW // OS
TOL = 1e-5

# weights valid for each mapping type (hparams.py's web): PIXEL_ID up-weights
# pixel matches, REGION_ID region matches, PIXEL_REGION_ID is proposed.sh's
MAPPINGS = {
    "PIXEL_ID": dict(lmbd_pixel_corr_weight=3.0, lmbd_region_corr_weight=1.0,
                     lmbd_not_corr_weight=1.0),
    "REGION_ID": dict(lmbd_pixel_corr_weight=1.0, lmbd_region_corr_weight=2.0,
                      lmbd_not_corr_weight=1.0),
    "PIXEL_REGION_ID": dict(lmbd_pixel_corr_weight=10.0, lmbd_region_corr_weight=1.0,
                            lmbd_not_corr_weight=0.0),
}
NEGATIVES = ["NONE", "FIXED", "AVERAGE", "MEDIAN", "HARD"]


class JaxFeatureHolder(fnn.Module):
    """``dense`` returns the parameter ``feats``, whatever the image."""

    def setup(self):
        self.feats = self.param("feats", fnn.initializers.zeros, (N, GRID, GRID, C))

    def dense(self, img, train=True):
        return self.feats


class FeatureHolder(nn.Module):
    def __init__(self, feats: np.ndarray):
        super().__init__()
        self.feats = nn.Parameter(torch.from_numpy(feats.copy()))

    def dense(self, img):
        return self.feats


def _batch(seed=0):
    r = np.random.RandomState(seed)
    ids = np.arange(1, HW * HW + 1, dtype=np.int32).reshape(1, HW, HW).repeat(N, 0)
    # view b sees the frame shifted by 2 grid cells: the pixel ids overlap in part
    ids_b = np.roll(ids, 2 * OS, axis=1)
    regions = r.randint(0, 5, (N, HW // 8, HW // 8)).repeat(8, 1).repeat(8, 2)
    bgs = []
    for _ in range(2):
        bg = r.rand(N, HW, HW, 3).astype(np.float32) + 0.01
        for i in range(N):
            y0, x0 = r.randint(0, HW // 3, 2)
            bg[i, y0:y0 + HW // 2, x0:x0 + HW // 2] = 0.0
        bgs.append(bg)
    return {
        "img_a": r.rand(N, HW, HW, 3).astype(np.float32),
        "img_b": r.rand(N, HW, HW, 3).astype(np.float32),
        "bg0": bgs[0], "bg1": bgs[1],
        "pixel_ids_a": ids, "pixel_ids_b": ids_b,
        "region_ids_a": regions.astype(np.int32),
        "region_ids_b": np.roll(regions, OS, axis=2).astype(np.int32),
    }


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """The test workers share the cores; these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.RandomState(1)
    return {
        "batch": _batch(0),
        "q": r.randn(N, GRID, GRID, C).astype(np.float32),
        "k": r.randn(N, GRID, GRID, C).astype(np.float32),
        "queue": unit_queue(2, QUEUE, C),
    }


def _hps(mapping, negative, **extra):
    kw = dict(dim=C, queue_len=QUEUE, negative_scale=2.0, **extra)
    jax_hp = JaxHyperParams.for_variant(
        JaxPretrainType.PROPOSED, mapping_type=JaxMappingType[mapping],
        negative_type=JaxNegativeType[negative], **kw)
    hp = SSLHyperParams.for_variant(
        PretrainType.PROPOSED, mapping_type=MappingType[mapping],
        negative_type=NegativeType[negative], **kw)
    return jax_hp, hp


def _jax_objective(inputs, jax_hp):
    model = JaxFeatureHolder()

    def loss_fn(params):
        return jax_obj.cp2_objective(
            model, params, {}, jnp.asarray(inputs["k"]), inputs["batch"],
            jnp.asarray(inputs["queue"]), jax_hp, OS, metrics_level=1)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {"feats": inputs["q"]})
    return float(loss), np.asarray(grads["feats"]), {
        k: np.asarray(v) for k, v in aux["metrics"].items()}


def _torch_objective(inputs, hp):
    model = FeatureHolder(inputs["q"])
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    loss, aux = obj.cp2_objective(model, torch.from_numpy(inputs["k"]), batch,
                                  torch.from_numpy(inputs["queue"]), hp, OS,
                                  metrics_level=1)
    loss.backward()
    return float(loss.detach()), model.feats.grad.numpy(), {
        k: v.detach().numpy() for k, v in aux["metrics"].items()}


def _assert_match(ours, ref):
    (loss, grad, metrics), (ref_loss, ref_grad, ref_metrics) = ours, ref
    assert np.isfinite(loss)
    assert_close(loss, ref_loss, TOL, "loss")
    assert_close(grad, ref_grad, TOL, "dL/dq")
    assert set(metrics) == set(ref_metrics)
    for key, value in ref_metrics.items():
        scale = 1.0 if "scores" in key else float(np.abs(value).max())
        np.testing.assert_allclose(np.asarray(metrics[key], np.float64), value, rtol=TOL,
                                   atol=TOL * scale, err_msg=key)


@pytest.mark.parametrize("negative", NEGATIVES)
@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
def test_proposed_objective_matches_jax(inputs, monkeypatch, mapping, negative):
    jax_hp, hp = _hps(mapping, negative, **MAPPINGS[mapping])
    assert not obj.uses_dense_kernel(hp)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the plain route reached the dense-loss kernel")

    monkeypatch.setattr(obj, "dense_pair_loss", no_kernel)
    _assert_match(_torch_objective(inputs, hp), _jax_objective(inputs, jax_hp))


def test_kernel_and_plain_routes_agree(inputs, monkeypatch):
    """Unit weights and NONE: the kernel route (on CPU tensors, the kernel's
    plain version) and the plain route (forced) give the same loss,
    gradient and metrics, and both the JAX objective's."""
    jax_hp, hp = _hps("PIXEL_REGION_ID", "NONE")
    assert obj.uses_dense_kernel(hp)
    calls = []
    kernel = obj.dense_pair_loss
    monkeypatch.setattr(obj, "dense_pair_loss",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    kernel_route = _torch_objective(inputs, hp)
    assert calls == [1]
    monkeypatch.setattr(obj, "uses_dense_kernel", lambda hp: False)
    plain_route = _torch_objective(inputs, hp)
    assert calls == [1]
    _assert_match(kernel_route, plain_route)
    _assert_match(kernel_route, _jax_objective(inputs, jax_hp))

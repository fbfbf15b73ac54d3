"""The port's correspondence math, dense-score statistics and the rest of
``ops/losses.py`` against the JAX package, on the CPU.

The analytic fixtures of ``tests/test_correlation_mapping.py`` and
``tests/test_contrastive_metrics.py`` run again on the port's functions;
random inputs made with numpy go through both packages.  Tolerances: IoUs
and counts exactly (they are ratios of small integers), scores and losses
at 1e-6 absolute (float32 values of order 1; sums in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp2_tpu.ops import correlation as JC
from cp2_tpu.ops import losses as JL
from cp2_tpu_torch.ops import correlation as C
from cp2_tpu_torch.ops import losses as L

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _unique_ids_case():
    batch_size, height, width = 4, 10, 10
    crop_h, crop_w = height // 2, width // 2
    rng = np.random.RandomState(0)
    base_map = np.arange(1, batch_size * height * width + 1)
    rng.shuffle(base_map)
    base_map = base_map.reshape(batch_size, height, width)
    map_a = base_map[:, :crop_h, :crop_w]
    map_b = base_map[:, 1: 1 + crop_h, 2: 2 + crop_w]
    mask_a = np.zeros((batch_size, crop_h, crop_w))
    mask_a[:, 2:4, 1:3] = 1
    mask_b = np.zeros((batch_size, crop_h, crop_w))
    mask_b[:, 1:3, 0:2] = 1
    return {"map_a": map_a, "map_b": map_b, "mask_a": mask_a, "mask_b": mask_b,
            "iou": np.full(batch_size, 12 / (12 + 25 - 12 + 25 - 12)),
            "iou_masked": np.full(batch_size, 1 / 3)}


def _shared_ids_case():
    base_map = np.array([[[1, 2, 2, 3, 4, 5], [6, 2, 2, 3, 3, 3],
                          [7, 8, 9, 10, 11, 12], [13, 8, 8, 8, 14, 15]]], np.float32)
    return {"map_a": base_map[:, 0:3, 1:4], "map_b": base_map[:, 0:3, 2:5],
            "mask_a": np.array([[[1, 1, 1], [1, 1, 1], [0, 0, 0]]], np.float32),
            "mask_b": np.array([[[1, 0, 0], [1, 0, 0], [1, 0, 0]]], np.float32),
            "iou": np.array([4 / 7]), "iou_masked": np.array([2 / 3])}


CASES = {"uniqueIds": _unique_ids_case, "sharedIds": _shared_ids_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_correlation_iou_analytic(case):
    d = CASES[case]()
    res = C.get_masked_correlation_map(*(_t(d[k]) for k in ("map_a", "map_b", "mask_a",
                                                            "mask_b")))
    np.testing.assert_allclose(res["iou"].numpy(), d["iou"], rtol=1e-6)
    np.testing.assert_allclose(res["iou_masked"].numpy(), d["iou_masked"], rtol=1e-6)


def test_correlation_map_matches_bruteforce():
    d = _shared_ids_case()
    res = C.get_correlation_map(_t(d["map_a"]), _t(d["map_b"]))
    a, b = d["map_a"].reshape(1, -1), d["map_b"].reshape(1, -1)
    expected = a[:, :, None] == b[:, None, :]
    np.testing.assert_array_equal(res["corr_map"].numpy(), expected)
    np.testing.assert_array_equal(res["corr_map_a"].numpy(), expected.sum(2))
    np.testing.assert_array_equal(res["corr_map_b"].numpy(), expected.sum(1))


def test_masked_correspondences_share_ids():
    d = _unique_ids_case()
    res = C.get_masked_correlation_map(*(_t(d[k]) for k in ("map_a", "map_b", "mask_a",
                                                            "mask_b")))
    corr_mask = res["corr_mask"].numpy()
    a = d["map_a"].reshape(corr_mask.shape[0], -1)
    b = d["map_b"].reshape(corr_mask.shape[0], -1)
    n, x, y = np.nonzero(corr_mask)
    assert len(n) > 0
    np.testing.assert_array_equal(a[n, x], b[n, y])


@pytest.mark.parametrize("n_ids", [6, 40])
def test_correlation_maps_match_jax(n_ids):
    """Random id maps with repeats (6 ids) and mostly distinct ones (40),
    random masks: every output of ``get_masked_correlation_map`` and the
    bare ``masked_iou`` equal the JAX package's."""
    r = np.random.RandomState(n_ids)
    maps = [r.randint(0, n_ids, (3, 5, 6)).astype(np.float32) for _ in range(2)]
    masks = [(r.rand(3, 5, 6) > 0.4).astype(np.float32) for _ in range(2)]
    ours = C.get_masked_correlation_map(*(_t(x) for x in maps + masks))
    ref = JC.get_masked_correlation_map(*(jnp.asarray(x) for x in maps + masks))
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    flat = [x.reshape(3, -1) for x in maps + masks]
    np.testing.assert_array_equal(C.masked_iou(*(_t(x) for x in flat)).numpy(),
                                  np.asarray(JC.masked_iou(*(jnp.asarray(x) for x in flat))))


def test_mean_and_quantile_axis_semantics():
    scores = np.array([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]],
                       [[1.0, 2.0, 3.0], [7.0, 8.0, 9.0]]], np.float32)
    np.testing.assert_allclose(_t(scores).mean(dim=(1, 2)).numpy(), [3.5, 5.0])
    quartiles = L.row_quantiles_linear(_t(scores).reshape(2, -1))
    np.testing.assert_allclose(quartiles.numpy(), [[2.25, 2.25], [3.5, 5.0], [4.75, 7.75]])


def test_dense_loss_stats_nan_masking():
    logits = _t([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]])
    labels = _t([[[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]])
    stats = C.dense_loss_stats(logits, labels)
    # positives: {1, 6}; negatives: {2, 3, 4, 5}
    np.testing.assert_allclose(stats["positive"]["average"].numpy(), [3.5])
    np.testing.assert_allclose(stats["negative"]["average"].numpy(), [3.5])
    np.testing.assert_allclose(stats["positive"]["quartiles"][1].numpy(), [3.5])
    np.testing.assert_allclose(stats["negative"]["quartiles"][0].numpy(), [2.75])
    np.testing.assert_allclose(stats["negative"]["quartiles"][2].numpy(), [4.25])


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_dense_loss_stats_matches_oracle_and_jax(density):
    """The one-sort statistics equal the NaN-masked oracle ``_nan_stats``
    (through the all-negative and all-positive rows) and the JAX
    package's; ties (logits rounded to 0.1) exercise the sort order."""
    r = np.random.RandomState(7)
    logits = np.round(r.randn(5, 13, 17), 1).astype(np.float32)
    labels = (r.rand(5, 13, 17) < density).astype(np.float32)
    got = C.dense_loss_stats(_t(logits), _t(labels))
    lb = torch.from_numpy(labels.astype(bool))
    nan = torch.tensor(float("nan"))
    oracle = {"positive": C._nan_stats(torch.where(lb, _t(logits), nan)),
              "negative": C._nan_stats(torch.where(lb, nan, _t(logits)))}
    ref = JC.dense_loss_stats(jnp.asarray(logits), jnp.asarray(labels))
    for side in ("positive", "negative"):
        for want in (oracle[side], ref[side]):
            for i in range(3):
                np.testing.assert_allclose(got[side]["quartiles"][i].numpy(),
                                           np.asarray(want["quartiles"][i]), atol=ATOL,
                                           err_msg=f"{side} q{i}")
            np.testing.assert_allclose(got[side]["average"].numpy(),
                                       np.asarray(want["average"]), atol=ATOL,
                                       err_msg=f"{side} average")


def test_dense_loss_stats_at_the_step_shape():
    r = np.random.RandomState(0)
    logits = r.randn(4, 196, 196).astype(np.float32)
    labels = (r.rand(4, 196, 196) > 0.7).astype(np.float32)
    stats = C.dense_loss_stats(_t(logits), _t(labels))
    for side in ("positive", "negative"):
        assert stats[side]["average"].shape == (4,)
        assert all(q.shape == (4,) for q in stats[side]["quartiles"])
    ref = np.where(labels.astype(bool), logits, np.nan)
    np.testing.assert_allclose(stats["positive"]["quartiles"][1].numpy(),
                               np.nanquantile(ref.reshape(4, -1), 0.5, axis=1), rtol=1e-5)


@pytest.mark.parametrize("negative_type", ["NONE", "FIXED", "AVERAGE", "MEDIAN", "HARD"])
def test_negative_reshape_matches_jax(negative_type):
    r = np.random.RandomState(3)
    logits = np.round(r.randn(3, 7, 9), 2).astype(np.float32)
    labels = (r.rand(3, 7, 9) > 0.6).astype(np.float32)
    average = r.randn(3).astype(np.float32)
    median = r.randn(3).astype(np.float32)
    ours = L.negative_reshape(_t(logits), _t(labels), negative_type, 2.0,
                              negative_average=_t(average), negative_median=_t(median))
    ref = JL.negative_reshape(jnp.asarray(logits), jnp.asarray(labels), negative_type, 2.0,
                              negative_average=jnp.asarray(average),
                              negative_median=jnp.asarray(median))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    if negative_type == "HARD":  # some negatives were scaled, not all
        changed = ours.numpy() != logits
        assert changed.any() and not changed.all()


def test_negative_reshape_unknown_type_raises():
    with pytest.raises(NotImplementedError):
        L.negative_reshape(_t(np.zeros((1, 2, 2))), _t(np.zeros((1, 2, 2))), "SOFT", 2.0)


@pytest.mark.parametrize("k,qs", [(9, (0.25, 0.5, 0.75)), (64, (0.0, 0.1, 0.9, 1.0)),
                                  (2, (0.5,))])
def test_row_quantiles_linear_matches_jax(k, qs):
    x = np.round(np.random.RandomState(k).randn(5, k), 1).astype(np.float32)
    ours = L.row_quantiles_linear(_t(x), qs)
    ref = JL.row_quantiles_linear(jnp.asarray(x), qs)
    assert tuple(ours.shape) == (len(qs), 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["plain", "ignore_index", "sample_mask", "both"])
def test_softmax_cross_entropy_matches_jax(mode):
    r = np.random.RandomState(2)
    logits = r.randn(3, 4, 5, 6).astype(np.float32)
    labels = r.randint(0, 6, (3, 4, 5)).astype(np.int32)
    labels[0, 0, :2] = 255  # ignored, or out of range: picks nothing
    kw = {}
    if mode in ("ignore_index", "both"):
        kw["ignore_index"] = 255
    if mode in ("sample_mask", "both"):
        kw["sample_mask"] = np.array([True, False, True])
    ours = L.softmax_cross_entropy(_t(logits), torch.from_numpy(labels),
                                   **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                                      else v for k, v in kw.items()})
    ref = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                      for k, v in kw.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)

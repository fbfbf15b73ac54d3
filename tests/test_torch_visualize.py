"""The port's figures (``cp2_tpu_torch/utils/visualize.py``) render with
numpy and PIL alone: each of the five figure functions writes its PNG with
matplotlib made unimportable, and what each panel shows is held to its
data (tiles against the colour table of the normalised values, bars
against ``np.histogram``'s counts on the ``"auto"`` edges).  Where
matplotlib is importable, the port's colour tables and its lookup are held
to matplotlib's; the correlation maps behind the debug panels to the JAX
package's."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from cp2_tpu_torch.utils import visualize as viz


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401


def _read(path):
    with Image.open(path) as im:
        assert im.format == "PNG"
        return np.asarray(im.convert("RGB"))


def _tile(fig, row, col, shape):
    """The pixel drawn at the centre of each source element of panel
    (row, col)."""
    left, top, right, bottom = viz.cell_box(row, col, shape)
    h, w = shape[:2]
    ys = top + ((np.arange(h) + 0.5) * (bottom - top) / h).astype(int)
    xs = left + ((np.arange(w) + 0.5) * (right - left) / w).astype(int)
    return fig[np.ix_(ys, xs)]


def _expected(panel, cmap, vmin=None, vmax=None):
    """The colour table's entry for each normalised value, computed here
    from the data: (x - vmin) / (vmax - vmin), index floor(x * N) clipped
    to the table."""
    x = np.asarray(panel, dtype=np.float64)
    lo = x.min() if vmin is None else vmin
    hi = x.max() if vmax is None else vmax
    table = viz.COLORMAPS[cmap]
    norm = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    return table[np.clip(np.floor(norm * len(table)), 0, len(table) - 1).astype(int)]


def _corr_inputs(seed=0, n=2, hw=(6, 8)):
    rng = np.random.default_rng(seed)
    map_a = rng.integers(0, 5, (n, *hw)).astype(np.float32)
    map_b = rng.integers(0, 5, (n, *hw)).astype(np.float32)
    mask_a = (rng.random((n, *hw)) > 0.4).astype(np.float32)
    mask_b = (rng.random((n, *hw)) > 0.4).astype(np.float32)
    return map_a, map_b, mask_a, mask_b


def _heatmap_inputs(seed=0, n=3, g=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, g * g, g * g)).astype(np.float32)
    return logits, rng.random((n, g * g)) > 0.5, rng.random((n, g * g)) > 0.5, (g, g)


def _draw(kind, out):
    rng = np.random.default_rng(1)
    if kind == "iou_histogram":
        return [viz.iou_histogram(rng.random(200), os.path.join(out, "h.png"))]
    if kind == "dense_similarity_heatmaps":
        return [viz.dense_similarity_heatmaps(*_heatmap_inputs(), os.path.join(out, "s.png"))]
    if kind == "correlation_map_panels":
        viz.correlation_map_panels(*_corr_inputs(), out, "demo")
        return [os.path.join(out, f"demo_{s}.png")
                for s in ("iou_histogram", "masked_iou_histogram", "maps_visualization")]
    if kind == "example_grid":
        return [viz.example_grid({"img_a": rng.random((3, 20, 24, 3)),
                                  "img_b": rng.random((3, 20, 24, 3))},
                                 os.path.join(out, "sub", "e.png"))]
    return [viz.segmentation_overlay_grid(
        rng.random((2, 24, 30, 3)), rng.integers(0, 2, (2, 24, 30)),
        rng.integers(0, 12, (2, 24, 30)), os.path.join(out, "o.png"))]


@pytest.mark.parametrize("kind", ["iou_histogram", "dense_similarity_heatmaps",
                                  "correlation_map_panels", "example_grid",
                                  "segmentation_overlay_grid"])
def test_each_figure_is_written_without_matplotlib(kind, tmp_path, no_matplotlib):
    paths = _draw(kind, str(tmp_path))
    for path in paths:
        fig = _read(path)
        assert fig.ndim == 3 and fig.shape[0] > 100 and fig.shape[1] > 100
        assert (fig != 255).any(), f"{path} is blank"


def test_heatmap_tiles_are_the_viridis_entries_of_their_values(tmp_path, no_matplotlib):
    logits, mask_a, mask_b, grid = _heatmap_inputs()
    fig = _read(viz.dense_similarity_heatmaps(logits, mask_a, mask_b, grid,
                                              str(tmp_path / "s.png")))
    for i in range(logits.shape[0]):
        fa, fb = mask_a[i], mask_b[i]
        hm_b = logits[i][fa].sum(0) / max(fa.sum(), 1)
        hm_a = logits[i][:, fb].sum(1) / max(fb.sum(), 1)
        for j, panel in enumerate((mask_a[i], hm_a, mask_b[i], hm_b)):
            panel = panel.reshape(grid).astype(np.float64)
            np.testing.assert_array_equal(_tile(fig, i, j, grid), _expected(panel, "viridis"),
                                          err_msg=f"row {i} panel {j}")


def test_correlation_panels_show_the_maps_masks_and_correlations(tmp_path, no_matplotlib):
    """The viridis panels of the maps share the sample's range over both
    maps; the gray panels and the correlation maps take their own."""
    map_a, map_b, mask_a, mask_b = _corr_inputs()
    res = viz.correlation_map_panels(map_a, map_b, mask_a, mask_b, str(tmp_path), "d")
    fig = _read(tmp_path / "d_maps_visualization.png")
    shape = map_a.shape[1:]
    for i in range(map_a.shape[0]):
        lo = min(map_a[i].min(), map_b[i].min())
        hi = max(map_a[i].max(), map_b[i].max())
        want = [
            _expected(map_a[i], "viridis", lo, hi),
            _expected(res["corr_map_a"][i].reshape(shape), "gray"),
            _expected(mask_a[i], "gray"),
            _expected(mask_a[i] * map_a[i], "viridis", lo, hi),
            _expected(res["corr_map_a_masked"][i].reshape(shape), "gray"),
            _expected(map_b[i], "viridis", lo, hi),
            _expected(res["corr_map_b"][i].reshape(shape), "gray"),
            _expected(mask_b[i], "gray"),
            _expected(mask_b[i] * map_b[i], "viridis", lo, hi),
            _expected(res["corr_map_b_masked"][i].reshape(shape), "gray"),
        ]
        for j, tile in enumerate(want):
            np.testing.assert_array_equal(_tile(fig, i, j, shape), tile,
                                          err_msg=f"row {i} panel {j}")


def test_overlay_and_example_tiles_are_their_pixels_and_classes(tmp_path, no_matplotlib):
    """Images are drawn as matplotlib draws float RGB (clipped, times 255,
    truncated); masks and predictions through tab10 at vmin 0, vmax 9, so
    class c is tab10's c-th colour and classes above 9 take the last."""
    rng = np.random.default_rng(3)
    images = rng.random((2, 12, 16, 3)) * 1.2 - 0.1
    masks = rng.integers(0, 2, (2, 12, 16))
    preds = rng.integers(0, 12, (2, 12, 16))
    fig = _read(viz.segmentation_overlay_grid(images, masks, preds, str(tmp_path / "o.png")))
    tab10 = viz.COLORMAPS["tab10"]
    for i in range(2):
        np.testing.assert_array_equal(_tile(fig, i, 0, images[i].shape),
                                      (np.clip(images[i], 0, 1) * 255).astype(np.uint8))
        np.testing.assert_array_equal(_tile(fig, i, 1, masks[i].shape), tab10[masks[i]])
        np.testing.assert_array_equal(_tile(fig, i, 2, preds[i].shape),
                                      tab10[np.minimum(preds[i], 9)])
    batches = {"img_a": rng.random((3, 10, 14, 3)), "img_b": rng.random((3, 10, 14, 3))}
    fig = _read(viz.example_grid(batches, str(tmp_path / "e.png")))
    for j, name in enumerate(batches):
        for i in range(3):
            np.testing.assert_array_equal(_tile(fig, i, j, (10, 14)),
                                          (batches[name][i] * 255).astype(np.uint8))


@pytest.mark.parametrize("n", [7, 200, 5000])
def test_histogram_bars_are_the_auto_bin_counts(n, tmp_path, no_matplotlib):
    rng = np.random.default_rng(n)
    ious = np.concatenate([rng.beta(2, 5, n // 2), rng.beta(8, 2, n - n // 2)])
    fig = _read(viz.iou_histogram(ious, str(tmp_path / "h.png")))
    counts, _ = np.histogram(ious, np.histogram_bin_edges(ious, "auto"))
    assert len(counts) > 1
    left, top, right, bottom = viz.HIST_BOX
    right = max(right, left + len(counts))
    bar = np.all(fig == np.array(viz.BAR_COLOR, dtype=np.uint8), axis=-1)
    heights = []
    for x0, x1 in viz.bar_columns(len(counts), left, right):
        column = bar[top:bottom, (x0 + x1) // 2]
        heights.append(int(column.sum()))
        if column.any():  # a bar stands on the axis, unbroken
            assert column[-1] and column[-int(column.sum()):].all()
    want = np.round(counts * (bottom - top) / counts.max()).astype(int)
    np.testing.assert_array_equal(heights, want)
    assert heights[int(np.argmax(counts))] == bottom - top
    assert not bar[:, :left].any() and not bar[:, right:].any()


def test_colour_tables_and_lookup_equal_matplotlibs():
    """Where matplotlib is importable: viridis, gray and tab10 within 1/255
    of ``matplotlib.colormaps``, and whole panels coloured as
    ``Normalize`` + the colormap colour them."""
    matplotlib = pytest.importorskip("matplotlib")
    from matplotlib.colors import Normalize

    for name, table in viz.COLORMAPS.items():
        cm = matplotlib.colormaps[name]
        assert cm.N == len(table), name
        ref = np.asarray(cm(np.arange(cm.N)))[:, :3]
        np.testing.assert_allclose(table / 255.0, ref, atol=1 / 255, err_msg=name)
    rng = np.random.default_rng(0)
    for panel, cmap, vmin, vmax in [(rng.normal(size=(9, 11)), "viridis", None, None),
                                    (rng.random((6, 6)) * 3, "viridis", 0.5, 2.0),
                                    (rng.random((5, 7)), "gray", None, None),
                                    (rng.integers(0, 14, (8, 8)), "tab10", 0, 9)]:
        ref = matplotlib.colormaps[cmap](Normalize(vmin, vmax)(panel), bytes=True)[..., :3]
        got = viz.colorize(panel, cmap, vmin, vmax)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, cmap


def test_correlation_results_equal_the_jax_packages(tmp_path):
    """The data behind the debug panels: the port's results dict against
    ``cp2_tpu.utils.visualize.correlation_map_panels`` on the same maps."""
    pytest.importorskip("matplotlib")
    from cp2_tpu.utils import visualize as jax_viz

    inputs = _corr_inputs(seed=5, n=3, hw=(5, 7))
    ours = viz.correlation_map_panels(*inputs, str(tmp_path / "port"), "d")
    ref = jax_viz.correlation_map_panels(*inputs, str(tmp_path / "jax"), "d")
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))

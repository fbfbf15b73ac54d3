"""Training visualizations: IoU histograms, dense-similarity heatmaps,
example grids, correlation-map panels, segmentation overlays.

Port of ``cp2_tpu/utils/visualize.py``: the reference's image artifacts,
epoch-end IoU histograms and viridis similarity heatmaps
(builder.py:1450-1549), the correlation-map debug panels
(tools/correlation_mapping.py:250-339, computed with the port's
``ops/correlation.py``) and the finetune segmentation overlays
(finetune.py:86-139).  The figure functions write PNGs (and return paths)
so they slot into any metric sink.

Everything here is numpy and PIL: no matplotlib, which the card machine
lacks.  Each figure keeps the JAX package's file name, panels, panel order
and titles; an ``imshow`` panel is rendered as matplotlib renders it with
its default normalisation (the panel's finite min and max, or the
``vmin``/``vmax`` given) looked up in the same colour table (viridis and
gray of 256 entries, tab10 of 10), each panel scaled by nearest neighbour
to ``CELL`` pixels on its longer side under a title strip.  Fonts, frames
and layout are PIL's, not matplotlib's.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# matplotlib's colour tables as 8-bit RGB (``matplotlib.colormaps[name]``,
# rounded; tests/test_torch_visualize.py holds them to it within 1/255)
_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164471365481467481668481769"
    "48186a481a6c481b6d481c6e481d6f481f70482071482173482374482475482576482677482878482979472a7a472c7a"
    "472d7b472e7c472f7d46307e46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a3d4e8a3c4f8a3c508b3b518b"
    "3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d365c8d365d8d355e8d355f8d34608d34618d33628d"
    "33638d32648e32658e31668e31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e"
    "26828e26828e25838e25848e25858e24868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d"
    "21918c20928c20928c20938c1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad81"
    "28ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b77937b87838b9773aba763bbb753dbc74"
    "3fbc7340bd7242be7144bf7046c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d1537ad1517cd2507fd34e81d34d"
    "84d44b86d54989d5488bd6468ed64590d74393d74195d84098d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32"
    "addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61ef6e620f8e621fbe723fde725"
)
_TAB10_HEX = "1f77b4ff7f0e2ca02cd627289467bd8c564be377c27f7f7fbcbd2217becf"


def _table(hexes: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(hexes), dtype=np.uint8).reshape(-1, 3)


COLORMAPS = {
    "viridis": _table(_VIRIDIS_HEX),
    "gray": np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1),
    "tab10": _table(_TAB10_HEX),
}
BAR_COLOR = tuple(int(c) for c in COLORMAPS["tab10"][0])  # matplotlib's "C0"

CELL = 192  # pixels on a panel's longer side
TITLE = 14  # pixels of the title strip above each panel
PAD = 6  # pixels between panels and at the edges
_WHITE = (255, 255, 255)
_BLACK = (0, 0, 0)


def normalize(panel, vmin=None, vmax=None) -> np.ndarray:
    """matplotlib's ``Normalize``: ``(x - vmin) / (vmax - vmin)`` in float64,
    ``vmin``/``vmax`` defaulting to the finite min and max; 0 where they are
    equal."""
    x = np.asarray(panel, dtype=np.float64)
    finite = x[np.isfinite(x)]
    if vmin is None:
        vmin = finite.min() if finite.size else 0.0
    if vmax is None:
        vmax = finite.max() if finite.size else 0.0
    if vmax == vmin:
        return np.where(np.isnan(x), np.nan, 0.0)
    return (x - float(vmin)) / (float(vmax) - float(vmin))


def colorize(panel, cmap: str, vmin=None, vmax=None) -> np.ndarray:
    """A 2-d panel as (H, W, 3) uint8 through a colour table, as matplotlib's
    ``Colormap.__call__`` indexes it: ``floor(x * N)``, 1.0 to the last
    entry, below 0 to the first and above 1 to the last; NaN is drawn
    white, the figure's background."""
    table = COLORMAPS[cmap]
    x = normalize(panel, vmin, vmax)
    idx = np.floor(np.nan_to_num(x, nan=0.0) * len(table))
    idx = np.clip(idx, 0, len(table) - 1).astype(np.int64)
    rgb = table[idx]
    rgb[np.isnan(x)] = _WHITE
    return rgb


def _rgb(image) -> np.ndarray:
    """A float RGB image as matplotlib draws it: clipped to [0, 1], times
    255, truncated."""
    return (np.clip(np.asarray(image, dtype=np.float32), 0, 1) * 255).astype(np.uint8)


def cell_box(row: int, col: int, shape) -> tuple:
    """(left, top, right, bottom) of the pixels panel (row, col) of shape
    ``shape`` (H, W, ...) covers in a grid figure; right and bottom
    exclusive."""
    h, w = shape[:2]
    scale = CELL / max(h, w)
    left = PAD + col * (CELL + PAD)
    top = PAD + row * (TITLE + CELL + PAD) + TITLE
    return left, top, left + max(1, round(w * scale)), top + max(1, round(h * scale))


def _save(image, save_path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    image.save(save_path)
    return save_path


def _grid(rows, save_path: str) -> str:
    """Write a figure of panels: ``rows`` is a list of rows, each a list of
    ``(rgb, title)`` with ``rgb`` an (H, W, 3) uint8 array and ``title`` a
    string or None."""
    from PIL import Image, ImageDraw, ImageFont

    cols = max(len(row) for row in rows)
    size = (PAD + cols * (CELL + PAD), PAD + len(rows) * (TITLE + CELL + PAD))
    fig = Image.new("RGB", size, _WHITE)
    draw = ImageDraw.Draw(fig)
    font = ImageFont.load_default()
    for i, row in enumerate(rows):
        for j, (rgb, title) in enumerate(row):
            left, top, right, bottom = cell_box(i, j, rgb.shape)
            panel = Image.fromarray(np.ascontiguousarray(rgb, dtype=np.uint8))
            fig.paste(panel.resize((right - left, bottom - top), Image.NEAREST), (left, top))
            if title:
                draw.text((left, top - TITLE), title, fill=_BLACK, font=font)
    return _save(fig, save_path)


HIST_SIZE = (1000, 400)  # matplotlib's figsize (10, 4) at 100 dpi
HIST_BOX = (80, 40, 960, 340)  # (left, top, right, bottom) of the plot area


def bar_columns(n_bins: int, left: int, right: int) -> list:
    """The first and last pixel column of each of ``n_bins`` touching bars
    across ``[left, right)``."""
    width = right - left
    return [(left + i * width // n_bins, left + (i + 1) * width // n_bins - 1)
            for i in range(n_bins)]


def iou_histogram(ious: Sequence[float], save_path: str, title: str = "Histogram of IoU values"):
    """One bar per bin of ``np.histogram_bin_edges(x, "auto")`` (matplotlib's
    ``bins="auto"``), each as tall as its count against the tallest."""
    from PIL import Image, ImageDraw, ImageFont

    x = np.asarray(ious, dtype=np.float64).ravel()
    edges = np.histogram_bin_edges(x, "auto")
    counts, _ = np.histogram(x, edges)
    left, top, right, bottom = HIST_BOX
    right = max(right, left + len(counts))  # at least a pixel a bar
    fig = Image.new("RGB", (max(HIST_SIZE[0], right + 40), HIST_SIZE[1]), _WHITE)
    draw = ImageDraw.Draw(fig)
    font = ImageFont.load_default()
    tallest = max(int(counts.max()), 1)
    for (x0, x1), count in zip(bar_columns(len(counts), left, right), counts):
        h = round(int(count) * (bottom - top) / tallest)
        if h:
            draw.rectangle((x0, bottom - h, x1, bottom - 1), fill=BAR_COLOR)
    draw.line((left - 1, top, left - 1, bottom), fill=_BLACK)
    draw.line((left - 1, bottom, right, bottom), fill=_BLACK)
    for text, (tx, ty) in ((f"{edges[0]:.3g}", (left, bottom + 4)),
                           (f"{edges[-1]:.3g}", (right - 30, bottom + 4)),
                           (str(tallest), (left - 40, top)), ("0", (left - 12, bottom - 12))):
        draw.text((tx, ty), text, fill=_BLACK, font=font)
    w = draw.textlength(title, font=font)
    draw.text(((left + right - w) / 2, top - 28), title, fill=_BLACK, font=font)
    w = draw.textlength("IoU", font=font)
    draw.text(((left + right - w) / 2, bottom + 24), "IoU", fill=_BLACK, font=font)
    label = Image.new("RGB", (80, 14), _WHITE)
    ImageDraw.Draw(label).text((0, 0), "Frequency", fill=_BLACK, font=font)
    fig.paste(label.rotate(90, expand=True), (8, (top + bottom) // 2 - 40))
    return _save(fig, save_path)


def dense_similarity_heatmaps(
    logits_dense: np.ndarray,   # (N, X, Y) weighted similarities
    mask_a: np.ndarray,         # (N, X) foreground masks (flattened grid)
    mask_b: np.ndarray,         # (N, Y)
    grid_hw,
    save_path: str,
):
    """Average foreground-to-foreground similarity maps per sample.

    For each sample: average similarity of image-b pixels against image-a's
    foreground (and vice versa), reshaped to the feature grid and rendered
    alongside the masks with viridis (builder.py:1488-1549 semantics).
    """
    n = logits_dense.shape[0]
    titles = ("mask_a", "heatmap_a", "mask_b", "heatmap_b")
    rows = []
    for i in range(n):
        fa = mask_a[i].astype(bool)
        fb = mask_b[i].astype(bool)
        hm_b = logits_dense[i][fa, :].sum(0) / max(fa.sum(), 1)
        hm_a = logits_dense[i][:, fb].sum(1) / max(fb.sum(), 1)
        panels = (mask_a[i], hm_a, mask_b[i], hm_b)
        rows.append([(colorize(np.reshape(p, grid_hw), "viridis"), f"{t}[{i}]")
                     for p, t in zip(panels, titles)])
    return _grid(rows, save_path)


def correlation_map_panels(
    map_a, map_b, mask_a, mask_b, save_dir: str, name: str = ""
):
    """Debug panels for correspondence maps + IoU histograms.

    Computes the masked correlation maps with the port's
    ``get_masked_correlation_map`` and renders the 10-column panel layout
    of the reference demo (tools/correlation_mapping.py:250-339), one row
    a sample (the demo's trailing row of empty axes is not drawn).  The
    viridis panels of the maps share the sample's range over both maps;
    the others take their own.  Returns the results dict, as numpy.
    """
    import torch

    from cp2_tpu_torch.ops.correlation import get_masked_correlation_map

    results = get_masked_correlation_map(
        *(torch.as_tensor(np.asarray(x), dtype=torch.float32)
          for x in (map_a, map_b, mask_a, mask_b)))
    res = {k: v.numpy() for k, v in results.items()}
    os.makedirs(save_dir, exist_ok=True)
    iou_histogram(res["iou"], os.path.join(save_dir, f"{name}_iou_histogram.png"))
    iou_histogram(
        res["iou_masked"],
        os.path.join(save_dir, f"{name}_masked_iou_histogram.png"),
        title="Histogram of Masked IoU values",
    )

    map_a = np.asarray(map_a)
    map_b = np.asarray(map_b)
    mask_a = np.asarray(mask_a)
    mask_b = np.asarray(mask_b)
    h, w = map_a.shape[1], map_a.shape[2]
    rows = []
    for i in range(map_a.shape[0]):
        vmin = min(map_a[i].min(), map_b[i].min())
        vmax = max(map_a[i].max(), map_b[i].max())
        panels = [
            (map_a[i], "viridis", f"map_a[{i}]"),
            (res["corr_map_a"][i].reshape(h, w), "gray", f"corr_map_a[{i}]"),
            (mask_a[i], "gray", f"mask_a[{i}]"),
            (mask_a[i] * map_a[i], "viridis", f"mask_a*map_a[{i}]"),
            (res["corr_map_a_masked"][i].reshape(h, w), "gray", f"corr_a_masked[{i}]"),
            (map_b[i], "viridis", f"map_b[{i}]"),
            (res["corr_map_b"][i].reshape(h, w), "gray", f"corr_map_b[{i}]"),
            (mask_b[i], "gray", f"mask_b[{i}]"),
            (mask_b[i] * map_b[i], "viridis", f"mask_b*map_b[{i}]"),
            (res["corr_map_b_masked"][i].reshape(h, w), "gray", f"corr_b_masked[{i}]"),
        ]
        rows.append([
            (colorize(panel, cmap, *((vmin, vmax) if cmap == "viridis" and "corr" not in title
                                     else (None, None))), title)
            for panel, cmap, title in panels])
    _grid(rows, os.path.join(save_dir, f"{name}_maps_visualization.png"))
    return res


def example_grid(named_batches, save_path: str):
    """Training-example grid: one column per named image batch, titled on
    its first row.

    Parity with the reference's first-batch example grids
    (builder.py:687-698,1188-1199: torchvision.make_grid of img_a/img_b/bg
    to wandb).
    """
    names = list(named_batches)
    n = min(b.shape[0] for b in named_batches.values())
    rows = [[(_rgb(named_batches[name][i]), name if i == 0 else None) for name in names]
            for i in range(n)]
    return _grid(rows, save_path)


def segmentation_overlay_grid(
    images: np.ndarray,   # (N, H, W, 3) in [0,1]
    masks: np.ndarray,    # (N, H, W) int
    preds: np.ndarray,    # (N, H, W) int
    save_path: str,
):
    """Image / ground-truth / prediction triptychs (finetune callback
    parity); masks and predictions through tab10 at ``vmin=0, vmax=9``."""
    rows = [[(_rgb(images[i]), "image"),
             (colorize(masks[i], "tab10", 0, 9), "mask"),
             (colorize(preds[i], "tab10", 0, 9), "pred")]
            for i in range(images.shape[0])]
    return _grid(rows, save_path)


def show_result(
    img,
    seg,
    *,
    palette=None,
    num_classes: Optional[int] = None,
    opacity: float = 0.5,
    out_file: Optional[str] = None,
):
    """Palette overlay of a segmentation map on an image.

    mmseg ``BaseSegmentor.show_result`` parity
    (``mmseg_/models/segmentors/base.py:208-268``): each class painted
    with its palette color, alpha-blended at ``opacity``; RGB in/out.
    ``img`` may be a path or an (H, W, 3) uint8/float array; ``seg`` an
    (H, W) integer map.  Falls back to mmseg's seed-42 random palette when
    none is given.  Returns the blended uint8 array (also written to
    ``out_file`` when given).
    """
    from PIL import Image

    from cp2_tpu_torch.data.class_names import random_palette

    if isinstance(img, (str, os.PathLike)):
        with open(img, "rb") as f:
            img = np.asarray(Image.open(f).convert("RGB"))
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    seg = np.asarray(seg).astype(np.int64)
    if palette is None:
        n = num_classes if num_classes is not None else int(seg.max()) + 1
        palette = random_palette(max(n, 1))
    palette = np.asarray(palette, dtype=np.uint8)
    if palette.ndim != 2 or palette.shape[1] != 3:
        raise ValueError(f"palette must be (K, 3), got {palette.shape}")
    if not 0 < opacity <= 1.0:
        raise ValueError(f"opacity must be in (0, 1], got {opacity}")
    color_seg = palette[np.clip(seg, 0, palette.shape[0] - 1)]
    out = (img * (1 - opacity) + color_seg * opacity).astype(np.uint8)
    if out_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        Image.fromarray(out).save(out_file)
    return out

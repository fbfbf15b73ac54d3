"""Training visualizations: IoU histograms, dense-similarity heatmaps,
example grids, correlation-map panels, segmentation overlays.

Port of ``cp2_tpu/utils/visualize.py``: the reference's image artifacts,
epoch-end IoU histograms and viridis similarity heatmaps
(builder.py:1450-1549), the correlation-map debug panels
(tools/correlation_mapping.py:250-339, computed with the port's
``ops/correlation.py``) and the finetune segmentation overlays
(finetune.py:86-139).  The figure functions write PNGs (and return paths)
so they slot into any metric sink; matplotlib is imported lazily and
headless.  ``show_result`` is numpy and PIL only, and runs where there is
no matplotlib (the card machine).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def iou_histogram(ious: Sequence[float], save_path: str, title: str = "Histogram of IoU values"):
    plt = _plt()
    fig = plt.figure(figsize=(10, 4))
    plt.hist(np.asarray(ious), bins="auto")
    plt.title(title)
    plt.xlabel("IoU")
    plt.ylabel("Frequency")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


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
    plt = _plt()
    n = logits_dense.shape[0]
    rows = []
    for i in range(n):
        fa = mask_a[i].astype(bool)
        fb = mask_b[i].astype(bool)
        hm_b = logits_dense[i][fa, :].sum(0) / max(fa.sum(), 1)
        hm_a = logits_dense[i][:, fb].sum(1) / max(fb.sum(), 1)
        rows.append(
            (
                mask_a[i].reshape(grid_hw),
                hm_a.reshape(grid_hw),
                mask_b[i].reshape(grid_hw),
                hm_b.reshape(grid_hw),
            )
        )
    fig, axes = plt.subplots(n, 4, figsize=(8, 2 * n), squeeze=False)
    titles = ("mask_a", "heatmap_a", "mask_b", "heatmap_b")
    for i, row in enumerate(rows):
        for j, (panel, title) in enumerate(zip(row, titles)):
            axes[i, j].imshow(panel, cmap="viridis")
            axes[i, j].set_title(f"{title}[{i}]", fontsize=6)
            axes[i, j].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def correlation_map_panels(
    map_a, map_b, mask_a, mask_b, save_dir: str, name: str = ""
):
    """Debug panels for correspondence maps + IoU histograms.

    Computes the masked correlation maps with the port's
    ``get_masked_correlation_map`` and renders the 10-column panel layout
    of the reference demo (tools/correlation_mapping.py:250-339).  Returns
    the results dict, as numpy.
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

    plt = _plt()
    map_a = np.asarray(map_a)
    map_b = np.asarray(map_b)
    mask_a = np.asarray(mask_a)
    mask_b = np.asarray(mask_b)
    batch = map_a.shape[0]
    h, w = map_a.shape[1], map_a.shape[2]
    fig, axes = plt.subplots(batch + 1, 10, figsize=(20, 2 * (batch + 1)), squeeze=False)
    for i in range(batch):
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
        for j, (panel, cmap, title) in enumerate(panels):
            kw = {"vmin": vmin, "vmax": vmax} if cmap == "viridis" and "corr" not in title else {}
            axes[i, j].imshow(panel, cmap=cmap, **kw)
            axes[i, j].set_title(title, fontsize=5)
            axes[i, j].axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(save_dir, f"{name}_maps_visualization.png"), dpi=100)
    plt.close(fig)
    return res


def example_grid(named_batches, save_path: str):
    """Training-example grid: one column per named image batch.

    Parity with the reference's first-batch example grids
    (builder.py:687-698,1188-1199: torchvision.make_grid of img_a/img_b/bg
    to wandb).
    """
    plt = _plt()
    names = list(named_batches)
    n = min(b.shape[0] for b in named_batches.values())
    fig, axes = plt.subplots(n, len(names), figsize=(2 * len(names), 2 * n),
                             squeeze=False)
    for j, name in enumerate(names):
        imgs = np.asarray(named_batches[name], dtype=np.float32)
        for i in range(n):
            axes[i, j].imshow(np.clip(imgs[i], 0, 1))
            if i == 0:
                axes[i, j].set_title(name, fontsize=7)
            axes[i, j].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
    return save_path


def segmentation_overlay_grid(
    images: np.ndarray,   # (N, H, W, 3) in [0,1]
    masks: np.ndarray,    # (N, H, W) int
    preds: np.ndarray,    # (N, H, W) int
    save_path: str,
):
    """Image / ground-truth / prediction triptychs (finetune callback parity)."""
    plt = _plt()
    n = images.shape[0]
    fig, axes = plt.subplots(n, 3, figsize=(6, 2 * n), squeeze=False)
    for i in range(n):
        axes[i, 0].imshow(np.clip(images[i], 0, 1))
        axes[i, 0].set_title("image", fontsize=6)
        axes[i, 1].imshow(masks[i], cmap="tab10", vmin=0, vmax=9)
        axes[i, 1].set_title("mask", fontsize=6)
        axes[i, 2].imshow(preds[i], cmap="tab10", vmin=0, vmax=9)
        axes[i, 2].set_title("pred", fontsize=6)
        for j in range(3):
            axes[i, j].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


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

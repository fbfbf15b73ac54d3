"""Training visualizations of the CLIs: IoU histograms, dense-similarity
heatmaps, example grids, segmentation overlays.

A copy of ``iou_histogram``, ``dense_similarity_heatmaps``,
``example_grid`` (the pretrain CLI's) and ``segmentation_overlay_grid``
(the finetune CLI's ``--visualize_freq``) of
``cp2_tpu/utils/visualize.py``; the correlation-map panels wait for the
tools.

Parity with the reference's image artifacts: epoch-end IoU histograms and
viridis similarity heatmaps (builder.py:1450-1549).  All functions write
PNGs (and return paths) so they slot into any metric sink; matplotlib is
imported lazily and headless.
"""

from __future__ import annotations

import os
from typing import Sequence

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

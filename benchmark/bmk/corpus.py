"""The synthetic polyp corpus: shapes on texture, numpy and PIL only.

A frozen copy of the version-1 generator of
``cp2_tpu_torch/tools/synthetic_corpus.py`` (``make_sample`` and its two
helpers), extended from square frames to (height, width) so that it writes
CVC-ClinicDB's shape: 612 RGB frames of 384 x 288 with binary masks.  Each
sample is a function of its own seed alone.

The corpus is written once per checkout, as PNG files, under
``.bench_cache/`` at the checkout's root (listed in ``.gitignore``); later
runs find it there.  It stands for a fixed dataset: the run's seed draws
the weights, the order, the crops and the augmentation, not the frames.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
from PIL import Image


def _smooth_noise(rng, hw, grid, channels=3):
    coarse = rng.rand(grid, grid, channels).astype(np.float32)
    img = Image.fromarray((coarse * 255).astype(np.uint8))
    return np.asarray(img.resize((hw[1], hw[0]), Image.BILINEAR), dtype=np.float32) / 255.0


def _blob_mask(rng, hw):
    h, w = hw
    cy, cx = rng.uniform(0.25, 0.75, 2) * np.array([h, w], dtype=np.float64)
    r0 = rng.uniform(0.10, 0.22) * min(h, w)
    aspect = rng.uniform(0.6, 1.4)
    theta0 = rng.uniform(0, 2 * np.pi)
    amps = rng.uniform(0.0, 0.18, 3)
    phases = rng.uniform(0, 2 * np.pi, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    ry = dy * np.cos(theta0) - dx * np.sin(theta0)
    rx = dy * np.sin(theta0) + dx * np.cos(theta0)
    ang = np.arctan2(ry, rx * aspect)
    rad = np.sqrt((rx * aspect) ** 2 + ry ** 2)
    r_theta = r0 * (1.0 + sum(a * np.sin((k + 2) * ang + p)
                              for k, (a, p) in enumerate(zip(amps, phases))))
    return rad <= r_theta


def make_sample(seed: int, hw: Tuple[int, int]):
    """(RGB uint8 (h, w, 3), mask uint8 (h, w) in {0, 255})."""
    h, w = hw
    rng = np.random.RandomState(seed)
    bg = _smooth_noise(rng, hw, grid=rng.randint(4, 8))
    bg = np.clip(bg + rng.randn(h, w, 3).astype(np.float32) * 0.04, 0, 1)
    mask = np.zeros((h, w), bool)
    fg = np.zeros_like(bg)
    for _ in range(rng.randint(1, 4)):
        m = _blob_mask(rng, hw)
        tex = _smooth_noise(rng, hw, grid=rng.randint(12, 24))
        tex = np.clip(0.65 * tex + 0.35 * bg + rng.uniform(-0.12, 0.12, 3), 0, 1)
        fg = np.where(m[..., None], tex, fg)
        mask |= m
    img = np.where(mask[..., None], fg, bg)
    img = np.clip(img + rng.randn(h, w, 3).astype(np.float32) * 0.02, 0, 1)
    return (img * 255).astype(np.uint8), mask.astype(np.uint8) * 255


def corpus_dir(scratch: str, spec: dict) -> str:
    h, w = spec["hw"]
    return os.path.join(scratch, f"corpus_v1_{spec['frames']}x{h}x{w}_s{spec['seed']}")


def ensure(scratch: str, spec: dict, threads: int = 8) -> List[Tuple[str, str]]:
    """(image, mask) paths of the corpus under ``scratch``, written first if
    missing."""
    out = corpus_dir(scratch, spec)
    n, hw = spec["frames"], tuple(spec["hw"])
    pairs = [(os.path.join(out, "images", f"{i:04d}.png"),
              os.path.join(out, "masks", f"{i:04d}.png")) for i in range(n)]
    if os.path.isdir(out):
        return pairs
    part = out + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(os.path.join(part, "images"))
    os.makedirs(os.path.join(part, "masks"))

    def write(i):
        img, mask = make_sample(spec["seed"] + i, hw)
        Image.fromarray(img).save(os.path.join(part, "images", f"{i:04d}.png"))
        Image.fromarray(mask).save(os.path.join(part, "masks", f"{i:04d}.png"))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(n)))
    os.replace(part, out)
    return pairs

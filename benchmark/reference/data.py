"""What the reference reads: the corpus files decoded with PIL, in the order
and with the crops the training loaders' laws give.

The loaders shuffle each epoch with ``RandomState(seed + epoch)`` and take
whole batches (drop_last); the finetune loader crops each frame after an
aspect-preserving resize of its shorter side to the crop size, at an
offset drawn from ``RandomState((seed·1000003 + epoch·8191 + index) mod
(2³¹ − 1))``, rows first.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    idx = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(idx)
    return idx


def batch_rows(seed: int, epoch: int, n: int, batch: int, b: int) -> np.ndarray:
    return epoch_order(seed, epoch, n)[b * batch:(b + 1) * batch]


def decode_frame(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """RGB uint8 at ``hw`` (PIL's bilinear resize where the size differs)."""
    with Image.open(path) as img:
        img = img.convert("RGB")
        if (img.height, img.width) != tuple(hw):
            img = img.resize((hw[1], hw[0]), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def crop_pair(img_path: str, mask_path: str, size: int, seed: int, epoch: int,
              index: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shorter side resized to ``size`` (bilinear image, nearest mask), a
    random ``size``² crop, the mask binarised to int32."""
    with Image.open(img_path) as f:
        img = f.convert("RGB")
    with Image.open(mask_path) as f:
        mask = f.convert("L")
    scale = size / min(img.width, img.height)
    new = (max(size, round(img.width * scale)), max(size, round(img.height * scale)))
    img, mask = img.resize(new, Image.BILINEAR), mask.resize(new, Image.NEAREST)
    rng = np.random.RandomState((seed * 1000003 + epoch * 8191 + int(index)) % (2**31 - 1))
    y0 = rng.randint(0, img.height - size + 1)
    x0 = rng.randint(0, img.width - size + 1)
    img = np.asarray(img, np.uint8)[y0:y0 + size, x0:x0 + size]
    mask = np.asarray(mask, np.int32)[y0:y0 + size, x0:x0 + size]
    return img, (mask > 0).astype(np.int32)


def decode_frames(paths: Sequence[str], hw) -> np.ndarray:
    return np.stack([decode_frame(p, hw) for p in paths])


def crop_pairs(pairs: List[Tuple[str, str]], rows, size, seed, epoch):
    out = [crop_pair(pairs[i][0], pairs[i][1], size, seed, epoch, i) for i in rows]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])

"""Host-side prefetching loader feeding raw frames to the device pipeline.

A copy of ``PretrainDataSource``, ``SegmentationDataSource`` and
``HostDataLoader`` of ``cp2_tpu/data/host_loader.py``: the host only
decodes frames and brings them to a fixed size (uint8); crops, photometric
ops and id maps of the pretrain path, and the finetune path's flips,
jitter, distortion and noise, run on the device
(``cp2_tpu_torch.augment``).  Decoding uses PIL, imported when the first
frame is read.

Sharding: ``shard=(host_id, num_hosts)`` partitions the per-step index
stream, the counterpart of DistributedSampler.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from cp2_tpu_torch.data.datasets import region_mask_path


def _decode_rgb(path: str, base_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
        if (img.height, img.width) != base_hw:
            img = img.resize((base_hw[1], base_hw[0]), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def _decode_mask(path: str, base_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f).convert("L")
        if (img.height, img.width) != base_hw:
            img = img.resize((base_hw[1], base_hw[0]), Image.NEAREST)
        return np.asarray(img, dtype=np.int32)


class PretrainDataSource:
    """Unlabeled images (+ optional SAM region maps) at a fixed base size."""

    def __init__(
        self,
        files: Sequence[str],
        base_hw: Tuple[int, int] = (256, 256),
        with_region_maps: bool = False,
    ):
        self.files = list(files)
        self.base_hw = base_hw
        self.with_region_maps = with_region_maps

    def __len__(self) -> int:
        return len(self.files)

    def load(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        path = self.files[index]
        out = {"image": _decode_rgb(path, self.base_hw)}
        if self.with_region_maps:
            out["region_map"] = _decode_mask(region_mask_path(path), self.base_hw)
        return out


class SegmentationDataSource:
    """(image, mask) pairs; the host does the geometric normalisation.

    ``mode="crop"`` (polyp): aspect-preserving SmallestMaxSize then a shared
    crop — ``random_crop=True`` reproduces SmallestMaxSize + RandomCrop
    (train/val transforms, reference finetune_dataset.py:301-337); ``False``
    the deterministic centre crop of test (:338-349).  ``mode="resize"``
    (lemon): a direct, aspect-breaking resize to ``image_size``, the
    reference's ``A.Resize(544, 1024)`` (:349-384).  Masks are binarised
    when ``num_classes == 2`` (reference :113-116).
    """

    def __init__(
        self,
        pairs: Sequence[Tuple[str, str]],
        image_size,
        num_classes: int = 2,
        random_crop: bool = True,
        seed: int = 0,
        mode: str = "crop",
    ):
        self.pairs = list(pairs)
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self.image_hw = tuple(image_size)
        self.num_classes = num_classes
        self.random_crop = random_crop
        if mode not in ("crop", "resize"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "crop" and self.image_hw[0] != self.image_hw[1]:
            raise ValueError("crop mode requires a square target")
        self.mode = mode
        self._rng = np.random.RandomState(seed)
        self._rng_lock = threading.Lock()

    @property
    def image_size(self) -> int:
        return self.image_hw[0]

    def __len__(self) -> int:
        return len(self.pairs)

    def _smallest_max_size(self, img, resample):
        s = self.image_size
        scale = s / min(img.width, img.height)
        return img.resize(
            (max(s, round(img.width * scale)), max(s, round(img.height * scale))),
            resample,
        )

    def load(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        from PIL import Image

        img_path, mask_path = self.pairs[index]
        with open(img_path, "rb") as f:
            img = Image.open(f).convert("RGB")
        with open(mask_path, "rb") as f:
            mask = Image.open(f).convert("L")
        if self.mode == "resize":
            h, w = self.image_hw
            # the reference resizes both nearest; bilinear on the image, as
            # in crop mode below
            img = np.asarray(img.resize((w, h), Image.BILINEAR), np.uint8)
            mask = np.asarray(mask.resize((w, h), Image.NEAREST), np.int32)
            if self.num_classes == 2:
                mask = (mask > 0).astype(np.int32)
            return {"image": img, "mask": mask}
        img = self._smallest_max_size(img, Image.BILINEAR)
        mask = self._smallest_max_size(mask, Image.NEAREST)
        s = self.image_size
        if self.random_crop:
            if rng is None:
                # shared-state fallback: serialise draws across decode threads
                with self._rng_lock:
                    y0 = self._rng.randint(0, img.height - s + 1)
                    x0 = self._rng.randint(0, img.width - s + 1)
            else:
                y0 = rng.randint(0, img.height - s + 1)
                x0 = rng.randint(0, img.width - s + 1)
        else:
            y0 = (img.height - s) // 2
            x0 = (img.width - s) // 2
        img = np.asarray(img, np.uint8)[y0:y0 + s, x0:x0 + s]
        mask = np.asarray(mask, np.int32)[y0:y0 + s, x0:x0 + s]
        if self.num_classes == 2:
            mask = (mask > 0).astype(np.int32)
        return {"image": img, "mask": mask}


class HostDataLoader:
    """Shuffling, sharding, batch-stacking iterator with background prefetch.

    ``num_workers`` threads decode rows concurrently (PIL releases the GIL
    during decode/resize) into a bounded in-order queue.  Per-item
    randomness derives from ``(seed, epoch, index)``, so batches are
    reproducible regardless of worker count or scheduling.
    ``epoch_iterator(epoch)`` reshuffles with ``seed + epoch``, the
    DistributedSampler ``set_epoch`` contract.
    """

    def __init__(
        self,
        source,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),
        prefetch: int = 2,
        num_workers: int = 1,
    ):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        host_id, num_hosts = self.shard
        n = len(self.source) // num_hosts
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.source)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        host_id, num_hosts = self.shard
        if num_hosts <= 1:
            return idx
        # truncate to a multiple of num_hosts before striding so every
        # shard yields the same number of batches
        even = n // num_hosts * num_hosts
        return idx[:even][host_id::num_hosts]

    def _item_rng(self, epoch: int, index: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 1000003 + epoch * 8191 + int(index)) % (2**31 - 1)
        )

    def epoch_iterator(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices(epoch)
        nbatches = len(idx) // self.batch_size if self.drop_last else (
            (len(idx) + self.batch_size - 1) // self.batch_size
        )
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_row(i):
            return self.source.load(int(i), rng=self._item_rng(epoch, int(i)))

        def producer(pool):
            try:
                for b in range(nbatches):
                    if stop.is_set():
                        return
                    rows_idx = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    if pool is None:
                        rows = [load_row(i) for i in rows_idx]
                    else:
                        rows = list(pool.map(load_row, rows_idx))
                    valid = len(rows)
                    # pad a short final batch (drop_last=False) to the full
                    # size; the per-row "valid" mask marks the pad rows
                    while len(rows) < self.batch_size:
                        rows.append(rows[-1])
                    batch = {
                        k: np.stack([r[k] for r in rows]) for k in rows[0]
                    }
                    batch["valid"] = np.arange(self.batch_size) < valid
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # surface decode errors, don't hang
                q.put(e)

        pool = (
            ThreadPoolExecutor(max_workers=self.num_workers)
            if self.num_workers > 1
            else None
        )
        t = threading.Thread(target=producer, args=(pool,), daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            if pool is not None:
                pool.shutdown(wait=False)

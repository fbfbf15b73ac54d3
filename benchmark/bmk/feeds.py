"""The general feed: one traffic file's parameters turned into the batches a
training loop consumes, epoch after epoch.

``feed: "resident"``: the frames are decoded once in set-up and held on the
device as uint8; each batch is a gather of its rows.  ``feed: "files"``:
the corpus's PNG files go through the program's host loader
(``HostDataLoader`` with ``num_workers`` decode threads) and
``DevicePrefetcher`` at ``prefetch_depth``, restarted each epoch, as the
CLIs run them.  Both take each stream's rows in the loaders' order
(``reference/data.py``), whole batches only.

Pretraining reads three streams of frames at the loader's base size;
finetuning reads one stream of (image, mask) pairs at the crop size: held
on the device as the crops the loader's geometry makes at epoch 0, or
cropped anew each epoch by the loader.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from reference import data


class Feed:
    def __init__(self, traffic: dict, streams: Dict[str, int], pairs: List[Tuple[str, str]],
                 batch: int, device, spans, *, base_hw=None, crop: int = 0):
        """``streams``: name → loader seed (pretrain: fg, bg0, bg1; finetune:
        one stream, ``image``); ``base_hw`` (pretrain) or ``crop``
        (finetune) sets the frames' size."""
        self.kind = traffic["feed"]
        if self.kind not in ("resident", "files"):
            raise ValueError(f"unknown feed {self.kind!r}")
        self.traffic, self.streams, self.pairs = traffic, streams, pairs
        self.batch, self.device, self.span = batch, torch.device(device), spans
        self.base_hw, self.crop = base_hw, crop
        self.n = len(pairs)
        self.steps_per_epoch = self.n // batch
        self.host = None  # the resident frames, on the host, for the reference
        if self.kind == "resident":
            self._make_resident()
        else:
            self._make_loaders()

    # -- resident ------------------------------------------------------------
    def _make_resident(self):
        workers = 8
        with ThreadPoolExecutor(workers) as pool:
            if self.crop:
                seed = next(iter(self.streams.values()))
                out = list(pool.map(lambda i: data.crop_pair(*self.pairs[i], self.crop, seed, 0, i),
                                    range(self.n)))
                self.host = {"image": np.stack([o[0] for o in out]),
                             "mask": np.stack([o[1] for o in out])}
            else:
                frames = list(pool.map(lambda p: data.decode_frame(p[0], self.base_hw),
                                       self.pairs))
                self.host = {"frames": np.stack(frames)}
        self.dev = {k: torch.from_numpy(v).to(self.device) for k, v in self.host.items()}

    def _resident_epoch(self, epoch: int) -> Iterator[dict]:
        order = {name: torch.from_numpy(
            data.epoch_order(s, epoch, self.n)[: self.steps_per_epoch * self.batch]
        ).to(self.device) for name, s in self.streams.items()}
        for b in range(self.steps_per_epoch):
            with self.span("feed"):
                sl = slice(b * self.batch, (b + 1) * self.batch)
                if self.crop:
                    idx = order["image"][sl]
                    yield {"image": self.dev["image"].index_select(0, idx),
                           "mask": self.dev["mask"].index_select(0, idx)}
                else:
                    yield {name: self.dev["frames"].index_select(0, idx[sl])
                           for name, idx in order.items()}

    # -- files ---------------------------------------------------------------
    def _make_loaders(self):
        from cp2_tpu_torch.data import HostDataLoader, PretrainDataSource, SegmentationDataSource
        from cp2_tpu_torch.data.prefetch import HostToDevice

        workers = int(self.traffic["num_workers"])
        if self.crop:
            ((name, seed),) = self.streams.items()
            src = SegmentationDataSource(self.pairs, self.crop, 2, random_crop=True, seed=seed,
                                         mode="crop")
            self.loaders = {name: HostDataLoader(src, self.batch, shuffle=True, drop_last=True,
                                                 seed=seed, num_workers=workers)}
        else:
            files = [p[0] for p in self.pairs]
            self.loaders = {name: HostDataLoader(PretrainDataSource(files, tuple(self.base_hw)),
                                                 self.batch, shuffle=True, drop_last=True,
                                                 seed=seed, num_workers=workers)
                            for name, seed in self.streams.items()}
        self.to_device = HostToDevice(self.device)

    def _stage(self, items):
        if self.crop:
            return self.to_device(items[0])
        return self.to_device({name: item["image"] for name, item in zip(self.loaders, items)})

    def _files_epoch(self, epoch: int) -> Iterator[dict]:
        from cp2_tpu_torch.data.prefetch import DevicePrefetcher

        iters = zip(*(loader.epoch_iterator(epoch) for loader in self.loaders.values()))
        staged = DevicePrefetcher(iters, self._stage, depth=int(self.traffic["prefetch_depth"]))
        try:
            while True:
                with self.span("loader_wait"):
                    try:
                        item = next(staged)
                    except StopIteration:
                        return
                    batch = item.wait()
                yield batch
        finally:
            staged.close()

    def epoch(self, epoch: int) -> Iterator[dict]:
        if self.kind == "resident":
            return self._resident_epoch(epoch)
        return self._files_epoch(epoch)

    def reference_rows(self, epoch: int, b: int) -> Dict[str, np.ndarray]:
        """Each stream's rows of batch ``b`` of ``epoch``."""
        return {name: data.batch_rows(s, epoch, self.n, self.batch, b)
                for name, s in self.streams.items()}


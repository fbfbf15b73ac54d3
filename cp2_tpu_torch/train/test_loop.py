"""Evaluation loops: dataset-level testing with optional test-time flips.

Port of ``cp2_tpu/train/test_loop.py`` (mmseg's ``single_gpu_test`` /
``multi_gpu_test``, ``apis/test.py:34-230``): run a segmentor over a
dataset, averaging softmax probabilities over the views of a
MultiScaleFlipAug sample and un-flipping flipped views, and return each
image's predicted class map for ``dataset.evaluate``.

The dataset is anything indexable with a length whose items are
``{"img": HWC array, "img_metas": {"flip": bool, ...}}`` dicts, or lists of
them (one per view): the item format of the mmseg ``CustomDataset`` and its
test pipelines.  The model runs where its parameters are, in the mode it
is in (eval mode, as ``init_segmentor`` returns it).

Under a process group (``cp2_tpu_torch.parallel``, e.g. ``torchrun``),
``multi_device_test`` shards the dataset by rank, as mmseg's
``multi_gpu_test`` does, and gathers the class maps, so every rank returns
what one process returns; JAX's single controller runs the loop once
(``cp2_tpu/train/test_loop.py:76-79``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from cp2_tpu_torch import parallel
from cp2_tpu_torch.parallel.collectives import group_device
from cp2_tpu_torch.train.inference import whole_inference


def dataset_test(model: torch.nn.Module, dataset, *, batch_size: int = 1,
                 progress: bool = False) -> List[np.ndarray]:
    """Whole-image inference over a dataset of fixed-size float images
    (``test_loop.py:34-68``); int64 class maps, one per sample."""
    del batch_size  # one sample at a time, as the JAX loop
    device = next(model.parameters()).device
    results: List[np.ndarray] = []
    with torch.no_grad():
        for idx in range(len(dataset)):
            sample = dataset[idx]
            views = sample if isinstance(sample, list) else [sample]
            prob_sum = None
            for view in views:
                img = torch.from_numpy(np.asarray(view["img"], np.float32)[None]).to(device)
                probs = torch.softmax(whole_inference(model, img), dim=-1)
                if view.get("img_metas", {}).get("flip"):
                    probs = probs.flip(2)
                prob_sum = probs if prob_sum is None else prob_sum + probs
            results.append(torch.argmax(prob_sum, dim=-1)[0].cpu().numpy().astype(np.int64))
            if progress and idx % 50 == 0:
                print(f"[test] {idx + 1}/{len(dataset)}")
    return results


def single_device_test(model: torch.nn.Module, dataset, **kw) -> List[np.ndarray]:
    """Alias matching the reference's single_gpu_test naming."""
    return dataset_test(model, dataset, **kw)


class _RankShard:
    """The images ``i`` of ``dataset`` with ``i % world == rank``, in order."""

    def __init__(self, dataset, rank: int, world: int):
        self.dataset, self.rank, self.world = dataset, rank, world

    def __len__(self):
        return len(range(self.rank, len(self.dataset), self.world))

    def __getitem__(self, j):
        return self.dataset[self.rank + j * self.world]


def multi_device_test(model: torch.nn.Module, dataset, **kw) -> List[np.ndarray]:
    """``dataset_test`` across the ranks of the process group: each rank
    runs the images ``i % W == rank``, then every rank gets every class map
    in dataset order, equal to what one process's ``dataset_test`` returns.
    Without a process group it is the one-process loop.

    Two ``all_reduce``s (the port's only collective, ``parallel/
    collectives.py``): the maps' shapes, then one flat zero-filled buffer
    in which each rank has written its own maps; adding zeros is exact.
    """
    if not parallel.is_active():
        return dataset_test(model, dataset, **kw)
    world, rank, n = parallel.world_size(), parallel.rank(), len(dataset)
    mine = dataset_test(model, _RankShard(dataset, rank, world), **kw)
    where = group_device()
    shapes = torch.zeros((n, 2), dtype=torch.int64)
    for j, pred in enumerate(mine):
        shapes[rank + j * world] = torch.tensor(pred.shape)
    shapes = shapes.to(where)
    torch.distributed.all_reduce(shapes)
    sizes = shapes.prod(1).tolist()
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    flat = torch.zeros(offsets[-1], dtype=torch.int32)
    for j, pred in enumerate(mine):
        i = rank + j * world
        flat[offsets[i]:offsets[i + 1]] = torch.from_numpy(pred.reshape(-1).astype(np.int32))
    flat = flat.to(where)
    torch.distributed.all_reduce(flat)
    flat = flat.cpu().numpy()
    shapes = shapes.cpu().tolist()
    return [flat[offsets[i]:offsets[i + 1]].astype(np.int64).reshape(shapes[i])
            for i in range(n)]

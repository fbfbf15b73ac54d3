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
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

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


def multi_device_test(model: torch.nn.Module, dataset, **kw) -> List[np.ndarray]:
    """Alias kept for API parity with multi_gpu_test: one process runs the
    same loop (more than one process is not ported yet)."""
    return dataset_test(model, dataset, **kw)

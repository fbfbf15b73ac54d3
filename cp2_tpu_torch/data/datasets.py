"""File discovery and deterministic data splits.

A copy of ``cp2_tpu/data/datasets.py``: the port imports nothing of the
JAX package.

Re-implements the reference's dataset plumbing:
* pretrain file listing for the three directory layouts — CSV split files,
  flat classification dirs, filename-tagged splits (reference
  ``datasets/pretrain_dataset.py:99-178``).
* finetune image/mask pairing with hashed-seed deterministic RANDOM splits,
  FILENAME splits, train-ratio subsampling, and the DDP-divisible
  pseudo-test subset (reference ``datasets/finetune_dataset.py:38-207``).

Split determinism: the reference seeds numpy with ``abs(hash(tag)) %
2**31`` (finetune_dataset.py:52-54), which silently depends on
PYTHONHASHSEED — two processes of one experiment can disagree on split
membership.  The rebuild seeds from a STABLE digest (md5 of the tag) by
default, so membership is reproducible across processes, machines, and
sessions.  Set ``CP2_COMPAT_HASH_SPLITS=1`` to reproduce the reference's
``hash()`` behavior bit-for-bit (requires a fixed PYTHONHASHSEED, as the
reference does implicitly).
"""

from __future__ import annotations

import csv
import os
from glob import glob
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cp2_tpu_torch.types import DatasetType, DataSplitType

DATA_RANDOM_SEED = 0
BASE_TRAIN_SPLIT = 0.7
BASE_TEST_SPLIT = 0.2
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
MASK_DIR = "SAM_Masks"
MASK_EXT = ".png"


def read_paths_csv(csv_path: str) -> List[str]:
    """Read comma-separated path rows (reference pretrain_dataset.py:45-58)."""
    paths: List[str] = []
    with open(csv_path, "r") as f:
        for row in csv.reader(f):
            paths.extend(row)
    return paths


def _stem_of(path: str) -> str:
    p = Path(path)
    return p.stem if p.suffix.lower() in IMAGE_EXTS else p.name


def _csv_split_files(image_dirs: Sequence[str], split_name: str) -> List[str]:
    out: List[str] = []
    for img_dir in image_dirs:
        if not os.path.exists(img_dir):
            raise FileNotFoundError(img_dir)
        wanted = {_stem_of(p) for p in read_paths_csv(
            os.path.join(img_dir, f"{split_name}.csv")
        )}
        files = [p for p in glob(os.path.join(img_dir, "*")) if _stem_of(p) in wanted]
        if len(files) != len(wanted):
            raise ValueError(
                f"{img_dir}: csv lists {len(wanted)} files, found {len(files)}"
            )
        out.extend(files)
    return out


def get_pretrain_files(
    image_dirs: Sequence[str],
    directory_type: DatasetType,
    split_name: str = "train",
) -> List[str]:
    """Unlabeled-image file list for pretraining."""
    image_dirs = [os.path.abspath(os.path.expanduser(d)) for d in image_dirs]
    if directory_type == DatasetType.CSV:
        return _csv_split_files(image_dirs, split_name)
    files: List[str] = []
    for img_dir in image_dirs:
        if not os.path.exists(img_dir):
            raise FileNotFoundError(img_dir)
        files.extend(glob(os.path.join(img_dir, "*")))
    files = sorted(files, key=lambda p: Path(p).stem)
    if directory_type == DatasetType.CLASSIFICATION:
        return files
    if directory_type == DatasetType.FILENAME:
        if split_name not in ("train", "val", "test"):
            raise ValueError(split_name)
        return [p for p in files if split_name in p and ".csv" not in p]
    raise NotImplementedError(f"{directory_type = }")


def region_mask_path(image_path: str) -> str:
    """SAM region-mask location: ``<root>/SAM_Masks/<stem>.png``
    (reference loader.py:46-47,75-83)."""
    p = Path(image_path)
    return os.path.join(p.parents[1], MASK_DIR, p.stem + MASK_EXT)


def list_image_mask_pairs(
    image_directory: str, mask_directory: str
) -> List[Tuple[str, str]]:
    """Stem-matched (image, mask) pairs (reference finetune_dataset.py:150-172)."""
    image_directory = os.path.abspath(os.path.expanduser(image_directory))
    mask_directory = os.path.abspath(os.path.expanduser(mask_directory))
    images = [
        p for p in sorted(glob(os.path.join(image_directory, "*")))
        if ".csv" not in p
    ]
    masks = sorted(glob(os.path.join(mask_directory, "*")))
    if not images:
        raise ValueError(f"no images in {image_directory}")
    pairs = []
    for img, mask in zip(images, masks):
        if Path(img).stem != Path(mask).stem:
            raise ValueError(f"{img} and {mask} do not match")
        pairs.append((img, mask))
    return pairs


def _hashed_state(tag: str) -> np.random.RandomState:
    if os.environ.get("CP2_COMPAT_HASH_SPLITS") == "1":
        # reference semantics (finetune_dataset.py:52-54): PYTHONHASHSEED-
        # dependent; only meaningful with a pinned hash seed
        return np.random.RandomState(abs(hash(tag)) % (2**31))
    import hashlib

    digest = hashlib.md5(tag.encode()).digest()
    return np.random.RandomState(int.from_bytes(digest[:4], "little") % (2**31))


def get_data_splits(
    image_mask_paths: List[Tuple[str, str]],
    data_split_type: DataSplitType,
    train_data_ratio: float,
) -> Dict[str, List[Tuple[str, str]]]:
    """train/val/test membership + optional train subsampling."""
    data: Dict[str, List[Tuple[str, str]]] = {"train": [], "val": [], "test": []}
    if data_split_type == DataSplitType.RANDOM:
        num_train = int(len(image_mask_paths) * BASE_TRAIN_SPLIT)
        num_test = int(len(image_mask_paths) * BASE_TEST_SPLIT)
        idxs = np.arange(len(image_mask_paths))
        _hashed_state(f"idxs-shuffle-{DATA_RANDOM_SEED}").shuffle(idxs)
        data["train"] = [image_mask_paths[i] for i in idxs[:num_train]]
        data["test"] = [
            image_mask_paths[i] for i in idxs[num_train : num_train + num_test]
        ]
        data["val"] = [image_mask_paths[i] for i in idxs[num_train + num_test :]]
    elif data_split_type == DataSplitType.FILENAME:
        for split in data:
            data[split] = [
                (x, y) for x, y in image_mask_paths if split in Path(x).stem
            ]
    else:
        raise NotImplementedError(f"{data_split_type = }")

    if sum(len(v) for v in data.values()) != len(image_mask_paths):
        raise ValueError("splits do not partition the dataset")

    if train_data_ratio < 1.0:
        num = int(len(data["train"]) * train_data_ratio)
        if not (0 < num <= len(data["train"])):
            raise ValueError(f"bad train_data_ratio {train_data_ratio}")
        picks = _hashed_state(f"train-split-{DATA_RANDOM_SEED}").choice(
            len(data["train"]), size=num, replace=False
        )
        data["train"] = [data["train"][i] for i in picks]
    return data


def pseudo_test_subset(
    test_paths: List[Tuple[str, str]], batch_size: int, num_devices: int
) -> List[Tuple[str, str]]:
    """Device-divisible random subset of test for in-training evaluation
    (reference finetune_dataset.py:191-207)."""
    per_step = batch_size * num_devices
    num_batches = len(test_paths) // per_step
    allowed = num_batches * per_step
    picks = _hashed_state(f"test-val-split-{DATA_RANDOM_SEED}").choice(
        len(test_paths), size=allowed, replace=False
    )
    return [test_paths[i] for i in picks]

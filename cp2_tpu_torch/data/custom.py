"""CustomDataset: annotation-file segmentation datasets + evaluation.

Port of ``cp2_tpu/data/custom.py`` (the reference's
``mmseg_/datasets/custom.py:19-400``): img_dir/ann_dir pairing by suffix,
an optional split file, the pipeline run per item, and ``evaluate``
producing the mIoU/mDice/mFscore tables with the port's
``ops/metrics.py``.  Also the per-dataset classes mmseg ships (ADE20K,
Cityscapes, VOC, ..., ``mmseg_/datasets/*.py``) and the Concat/Repeat
wrappers (dataset_wrappers.py:7,24).  Masks are read as cv2's
``IMREAD_GRAYSCALE`` reads them (``data/imgproc.py``), without cv2.
"""

from __future__ import annotations

import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from cp2_tpu_torch.data import imgproc
from cp2_tpu_torch.data.class_names import (
    ADE_CLASSES,
    ADE_PALETTE,
    CITYSCAPES_CLASSES,
    CITYSCAPES_PALETTE,
    PASCAL_CONTEXT_CLASSES,
    VOC_CLASSES,
    VOC_PALETTE,
    random_palette,
)
from cp2_tpu_torch.data.pipelines import build_pipeline
from cp2_tpu_torch.models.registry import Registry

DATASETS = Registry("dataset")


def build_dataset(cfg: dict):
    cfg = dict(cfg)
    if cfg.get("type") == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"]), cfg["times"])
    if cfg.get("type") == "ConcatDataset":
        return ConcatDataset([build_dataset(c) for c in cfg["datasets"]])
    return DATASETS.build(cfg)


@DATASETS.register
class CustomDataset:
    CLASSES: Optional[Sequence[str]] = None
    PALETTE = None

    def __init__(
        self,
        pipeline,
        img_dir,
        img_suffix=".jpg",
        ann_dir=None,
        seg_map_suffix=".png",
        split=None,
        data_root=None,
        test_mode=False,
        ignore_index=255,
        reduce_zero_label=False,
        classes=None,
    ):
        self.pipeline = build_pipeline(pipeline)
        if data_root is not None:
            img_dir = osp.join(data_root, img_dir)
            if ann_dir is not None:
                ann_dir = osp.join(data_root, ann_dir)
            if split is not None:
                split = osp.join(data_root, split)
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.img_suffix = img_suffix
        self.seg_map_suffix = seg_map_suffix
        self.test_mode = test_mode
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        if classes is not None:
            self.CLASSES = classes
        self.img_infos = self._load_annotations(split)

    def _load_annotations(self, split) -> List[Dict]:
        infos = []
        if split is not None:
            with open(split) as f:
                stems = [line.strip() for line in f if line.strip()]
            for stem in stems:
                info = {"filename": stem + self.img_suffix}
                if self.ann_dir is not None:
                    info["ann"] = {"seg_map": stem + self.seg_map_suffix}
                infos.append(info)
        else:
            for path in sorted(glob(osp.join(self.img_dir, f"*{self.img_suffix}"))):
                stem = osp.basename(path)[: -len(self.img_suffix)]
                info = {"filename": osp.basename(path)}
                if self.ann_dir is not None:
                    info["ann"] = {"seg_map": stem + self.seg_map_suffix}
                infos.append(info)
        return infos

    def __len__(self):
        return len(self.img_infos)

    def __getitem__(self, idx):
        info = self.img_infos[idx]
        results = {
            "img_info": info,
            "ann_info": info.get("ann"),
            "img_prefix": self.img_dir,
            "seg_prefix": self.ann_dir,
        }
        return self.pipeline(results)

    def get_gt_seg_maps(self):
        for info in self.img_infos:
            seg = imgproc.imread(
                osp.join(self.ann_dir, info["ann"]["seg_map"]), imgproc.IMREAD_GRAYSCALE
            ).astype(np.int64)
            if self.reduce_zero_label:
                seg[seg == 0] = 255
                seg = seg - 1
                seg[seg == 254] = 255
            yield seg

    def evaluate(self, results: List[np.ndarray], metric="mIoU", **kwargs) -> Dict:
        """Aggregate metrics over predicted class maps (custom.py evaluate):
        per-class areas summed in float64, the ratios in float32 as the JAX
        function takes them."""
        import torch

        from cp2_tpu_torch.ops.metrics import eval_metrics, intersect_and_union

        metrics = [metric] if isinstance(metric, str) else list(metric)
        num_classes = len(self.CLASSES) if self.CLASSES else int(
            max(int(r.max()) for r in results) + 1
        )
        totals = [np.zeros((num_classes,), np.float64) for _ in range(4)]
        for pred, gt in zip(results, self.get_gt_seg_maps()):
            parts = intersect_and_union(
                torch.from_numpy(np.asarray(pred)), torch.from_numpy(np.asarray(gt)),
                num_classes, ignore_index=self.ignore_index,
            )
            totals = [t + p.numpy() for t, p in zip(totals, parts)]
        out = eval_metrics(*[torch.from_numpy(t) for t in totals], metrics=tuple(metrics))
        return {k: v.numpy().tolist() for k, v in out.items()}


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.CLASSES = datasets[0].CLASSES
        self._offsets = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self._offsets, idx, side="right"))
        prev = 0 if ds == 0 else int(self._offsets[ds - 1])
        return self.datasets[ds][idx - prev]


class RepeatDataset:
    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


def _register_simple(name, classes, img_suffix=".jpg", seg_map_suffix=".png",
                     reduce_zero_label=False, palette=None):
    @DATASETS.register(name=name)
    class _DS(CustomDataset):
        CLASSES = classes
        # datasets without a published colormap get mmseg's seed-42
        # fallback palette (class_names.random_palette)
        PALETTE = (
            [list(c) for c in palette] if palette is not None
            else random_palette(len(classes))
        )

        def __init__(self, **kwargs):
            kwargs.setdefault("img_suffix", img_suffix)
            kwargs.setdefault("seg_map_suffix", seg_map_suffix)
            kwargs.setdefault("reduce_zero_label", reduce_zero_label)
            super().__init__(**kwargs)

    _DS.__name__ = name
    return _DS


VESSEL_CLASSES = ("background", "vessel")

PascalVOCDataset = _register_simple(
    "PascalVOCDataset", VOC_CLASSES, palette=VOC_PALETTE
)
CityscapesDataset = _register_simple(
    "CityscapesDataset", CITYSCAPES_CLASSES,
    img_suffix="_leftImg8bit.png", seg_map_suffix="_gtFine_labelTrainIds.png",
    palette=CITYSCAPES_PALETTE,
)
ADE20KDataset = _register_simple(
    "ADE20KDataset", ADE_CLASSES, seg_map_suffix=".png",
    reduce_zero_label=True, palette=ADE_PALETTE,
)
PascalContextDataset = _register_simple(
    "PascalContextDataset", PASCAL_CONTEXT_CLASSES
)
ChaseDB1Dataset = _register_simple(
    "ChaseDB1Dataset", VESSEL_CLASSES, img_suffix=".png",
    seg_map_suffix="_1stHO.png",
)
DRIVEDataset = _register_simple(
    "DRIVEDataset", VESSEL_CLASSES, img_suffix=".png",
    seg_map_suffix="_manual1.png",
)
HRFDataset = _register_simple(
    "HRFDataset", VESSEL_CLASSES, img_suffix=".png", seg_map_suffix=".png"
)
STAREDataset = _register_simple(
    "STAREDataset", VESSEL_CLASSES, img_suffix=".png", seg_map_suffix=".ah.png"
)

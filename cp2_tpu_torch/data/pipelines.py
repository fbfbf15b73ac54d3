"""mmseg-style host-side transform pipeline, without OpenCV.

Port of ``cp2_tpu/data/pipelines.py`` (the reference's
``mmseg_/datasets/pipelines/``: compose.py, loading.py,
transforms.py:10-833, test_time_aug.py): dict-in / dict-out transforms over
numpy arrays, composable from config dicts (``dict(type='Resize',
img_scale=(2048, 512), ratio_range=(0.5, 2.0))``), with the same result
keys (``img``, ``gt_semantic_seg``, ``img_shape``, ``ori_shape``,
``pad_shape``, ``scale_factor``, ``flip``, ``flip_direction``) and the
same per-transform ``np.random.RandomState(seed)``, so the draws equal the
JAX package's.

The JAX transforms call cv2; these call ``data/imgproc.py``, which
computes what those cv2 calls compute in numpy and PIL (its docstring
states where the results are bit-exact and where within one level).  cv2
is never imported, even where it is installed: the card machine has none.
"""

from __future__ import annotations

import os.path as osp
from typing import Sequence

import numpy as np

from cp2_tpu_torch.data import imgproc
from cp2_tpu_torch.models.registry import Registry

PIPELINES = Registry("pipeline")


def build_pipeline(cfgs: Sequence[dict]) -> "Compose":
    return Compose([PIPELINES.build(dict(c)) for c in cfgs])


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register
class LoadImageFromFile:
    def __init__(self, to_float32=False, color_type="color"):
        self.to_float32 = to_float32
        self.color_type = color_type

    def __call__(self, results):
        path = (
            osp.join(results["img_prefix"], results["img_info"]["filename"])
            if results.get("img_prefix")
            else results["img_info"]["filename"]
        )
        flag = (imgproc.IMREAD_COLOR if self.color_type == "color"
                else imgproc.IMREAD_GRAYSCALE)
        img = imgproc.imread(path, flag)
        if self.to_float32:
            img = img.astype(np.float32)
        results["filename"] = path
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = 1.0
        return results


@PIPELINES.register
class LoadAnnotations:
    def __init__(self, reduce_zero_label=False):
        self.reduce_zero_label = reduce_zero_label

    def __call__(self, results):
        path = (
            osp.join(results["seg_prefix"], results["ann_info"]["seg_map"])
            if results.get("seg_prefix")
            else results["ann_info"]["seg_map"]
        )
        seg = imgproc.imread(path, imgproc.IMREAD_GRAYSCALE).astype(np.int64)
        if self.reduce_zero_label:
            seg[seg == 0] = 255
            seg = seg - 1
            seg[seg == 254] = 255
        results["gt_semantic_seg"] = seg
        return results


def _rescale_size(old_hw, scale, ratio_range=None, rng=None):
    h, w = old_hw
    if ratio_range is not None:
        ratio = rng.uniform(*ratio_range)
        scale = (int(scale[0] * ratio), int(scale[1] * ratio))
    max_long, max_short = max(scale), min(scale)
    factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5), factor


@PIPELINES.register
class Resize:
    """Keep-ratio rescale with optional ratio jitter (transforms.py:10-160)."""

    def __init__(self, img_scale=None, ratio_range=None, keep_ratio=True, seed=0):
        self.img_scale = img_scale
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        img = results["img"]
        scale = results.get("scale", self.img_scale)
        if self.keep_ratio:
            new_w, new_h, factor = _rescale_size(
                img.shape[:2], scale, self.ratio_range, self.rng
            )
        else:
            new_h, new_w = scale
            factor = None
        results["img"] = imgproc.resize_linear(img, (new_w, new_h))
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = imgproc.resize_nearest(
                results["gt_semantic_seg"].astype(np.int32), (new_w, new_h)
            ).astype(np.int64)
        results["img_shape"] = results["img"].shape
        results["pad_shape"] = results["img"].shape
        results["scale_factor"] = factor or 1.0
        return results


@PIPELINES.register
class RandomFlip:
    def __init__(self, prob=0.5, direction="horizontal", seed=0):
        self.prob = prob
        self.direction = direction
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        flip = results.get("flip")
        if flip is None:
            flip = self.rng.rand() < self.prob
        results["flip"] = bool(flip)
        results["flip_direction"] = self.direction
        if flip:
            axis = 1 if self.direction == "horizontal" else 0
            results["img"] = np.flip(results["img"], axis=axis).copy()
            if "gt_semantic_seg" in results:
                results["gt_semantic_seg"] = np.flip(
                    results["gt_semantic_seg"], axis=axis
                ).copy()
        return results


@PIPELINES.register
class Pad:
    def __init__(self, size=None, size_divisor=None, pad_val=0, seg_pad_val=255):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def _target(self, shape):
        if self.size is not None:
            return self.size
        d = self.size_divisor
        return (-(-shape[0] // d) * d, -(-shape[1] // d) * d)

    def __call__(self, results):
        th, tw = self._target(results["img"].shape[:2])
        img = results["img"]
        ph, pw = max(0, th - img.shape[0]), max(0, tw - img.shape[1])
        results["img"] = np.pad(
            img, ((0, ph), (0, pw), (0, 0))[: img.ndim],
            constant_values=self.pad_val,
        )
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = np.pad(
                results["gt_semantic_seg"], ((0, ph), (0, pw)),
                constant_values=self.seg_pad_val,
            )
        results["pad_shape"] = results["img"].shape
        return results


@PIPELINES.register
class Normalize:
    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb  # loading already converts to RGB

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        results["img"] = (img - self.mean) / self.std
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std, to_rgb=self.to_rgb)
        return results


@PIPELINES.register
class Rerange:
    def __init__(self, min_value=0, max_value=255):
        self.min_value = min_value
        self.max_value = max_value

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-12)
        results["img"] = img * (self.max_value - self.min_value) + self.min_value
        return results


@PIPELINES.register
class CLAHE:
    def __init__(self, clip_limit=40.0, tile_grid_size=(8, 8)):
        self.clip_limit = clip_limit
        self.tile_grid_size = tuple(tile_grid_size)

    def __call__(self, results):
        img = results["img"]
        out = np.stack(
            [imgproc.clahe(np.asarray(img[..., c], np.uint8), self.clip_limit,
                           self.tile_grid_size) for c in range(img.shape[-1])],
            axis=-1,
        )
        results["img"] = out
        return results


@PIPELINES.register
class RandomCrop:
    def __init__(self, crop_size, cat_max_ratio=1.0, ignore_index=255, seed=0):
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index
        self.rng = np.random.RandomState(seed)

    def _box(self, shape):
        mh = max(shape[0] - self.crop_size[0], 0)
        mw = max(shape[1] - self.crop_size[1], 0)
        y = self.rng.randint(0, mh + 1)
        x = self.rng.randint(0, mw + 1)
        return y, x

    def __call__(self, results):
        img = results["img"]
        y, x = self._box(img.shape)
        if self.cat_max_ratio < 1.0 and "gt_semantic_seg" in results:
            # re-draw up to 10 times to avoid single-class crops
            for _ in range(10):
                seg = results["gt_semantic_seg"][
                    y : y + self.crop_size[0], x : x + self.crop_size[1]
                ]
                labels, counts = np.unique(seg, return_counts=True)
                counts = counts[labels != self.ignore_index]
                if len(counts) > 1 and counts.max() / counts.sum() < self.cat_max_ratio:
                    break
                y, x = self._box(img.shape)
        results["img"] = img[y : y + self.crop_size[0], x : x + self.crop_size[1]]
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = results["gt_semantic_seg"][
                y : y + self.crop_size[0], x : x + self.crop_size[1]
            ]
        results["img_shape"] = results["img"].shape
        return results


@PIPELINES.register
class RandomRotate:
    def __init__(self, prob, degree, pad_val=0, seg_pad_val=255, seed=0):
        self.prob = prob
        self.degree = (-degree, degree) if np.isscalar(degree) else degree
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        if self.rng.rand() >= self.prob:
            return results
        angle = self.rng.uniform(*self.degree)
        h, w = results["img"].shape[:2]
        mat = imgproc.rotation_matrix((w / 2, h / 2), angle, 1.0)
        results["img"] = imgproc.warp_affine(
            results["img"], mat, (w, h), nearest=False, border_value=self.pad_val,
        )
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = imgproc.warp_affine(
                results["gt_semantic_seg"].astype(np.int32), mat, (w, h),
                nearest=True, border_value=self.seg_pad_val,
            ).astype(np.int64)
        return results


@PIPELINES.register
class RGB2Gray:
    def __init__(self, out_channels=None, weights=(0.299, 0.587, 0.114)):
        self.out_channels = out_channels
        self.weights = np.asarray(weights, np.float32)

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        gray = (img * self.weights).sum(-1, keepdims=True)
        reps = self.out_channels or img.shape[-1]
        results["img"] = np.repeat(gray, reps, axis=-1)
        return results


@PIPELINES.register
class AdjustGamma:
    def __init__(self, gamma=1.0):
        self.gamma = gamma
        inv = 1.0 / gamma
        self.table = ((np.arange(256) / 255.0) ** inv * 255).astype(np.uint8)

    def __call__(self, results):
        results["img"] = self.table[np.asarray(results["img"], np.uint8)]
        return results


@PIPELINES.register
class SegRescale:
    def __init__(self, scale_factor=1):
        self.scale_factor = scale_factor

    def __call__(self, results):
        if self.scale_factor != 1 and "gt_semantic_seg" in results:
            seg = results["gt_semantic_seg"]
            nh = int(seg.shape[0] * self.scale_factor)
            nw = int(seg.shape[1] * self.scale_factor)
            results["gt_semantic_seg"] = imgproc.resize_nearest(
                seg.astype(np.int32), (nw, nh)
            ).astype(np.int64)
        return results


@PIPELINES.register
class PhotoMetricDistortion:
    """Brightness/contrast/saturation/hue distortion (transforms.py:774-833)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18, seed=0):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        r = self.rng
        if r.randint(2):
            img = img + r.uniform(-self.brightness_delta, self.brightness_delta)
        contrast_last = r.randint(2)
        if not contrast_last and r.randint(2):
            img = img * r.uniform(*self.contrast_range)
        hsv = imgproc.rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
        if r.randint(2):
            hsv[..., 1] = hsv[..., 1] * r.uniform(*self.saturation_range)
        if r.randint(2):
            hsv[..., 0] = (hsv[..., 0] + r.uniform(-self.hue_delta, self.hue_delta)) % 180
        img = imgproc.hsv_to_rgb(np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
        if contrast_last and r.randint(2):
            img = img * r.uniform(*self.contrast_range)
        results["img"] = np.clip(img, 0, 255)
        return results


@PIPELINES.register
class MultiScaleFlipAug:
    """Test-time augmentation wrapper (test_time_aug.py:10-133).

    Returns a list of transformed results (one per scale x flip combo);
    the eval loop averages the resulting logits.
    """

    def __init__(self, transforms, img_scale, img_ratios=None, flip=False,
                 flip_direction="horizontal"):
        self.transforms = build_pipeline(transforms)
        scales = img_scale if isinstance(img_scale, list) else [img_scale]
        if img_ratios:
            base = scales[0]
            scales = [(int(base[0] * r), int(base[1] * r)) for r in img_ratios]
        self.scales = scales
        self.flip = flip
        self.flip_direction = flip_direction

    def __call__(self, results):
        out = []
        for scale in self.scales:
            for flip in [False] + ([True] if self.flip else []):
                r = dict(results)
                r["scale"] = scale
                r["flip"] = flip
                r["flip_direction"] = self.flip_direction
                out.append(self.transforms(r))
        return out


@PIPELINES.register
class DefaultFormatBundle:
    """HWC float image + int64 seg, batched-dim-free (formating.py parity)."""

    def __call__(self, results):
        results["img"] = np.ascontiguousarray(results["img"], np.float32)
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = np.ascontiguousarray(
                results["gt_semantic_seg"], np.int64
            )
        return results


@PIPELINES.register
class ImageToTensor:
    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for k in self.keys:
            results[k] = np.ascontiguousarray(results[k], np.float32)
        return results


@PIPELINES.register
class Collect:
    def __init__(self, keys, meta_keys=("filename", "ori_shape", "img_shape",
                                        "pad_shape", "scale_factor", "flip")):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {k: results[k] for k in self.keys}
        out["img_metas"] = {k: results.get(k) for k in self.meta_keys}
        return out

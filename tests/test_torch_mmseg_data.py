"""The port's mmseg dataset layer (``cp2_tpu_torch/data/{imgproc,pipelines,
custom,class_names}.py``) against the JAX package's, which calls cv2, on
the CPU.

Tolerances, each from what the port reproduces (``data/imgproc.py``):

* exact: PNG reads (modes L, RGB, RGBA, P, colour and grey), nearest and
  linear resizes of uint8 images, nearest rotations of masks, RGB→HSV and
  HSV→RGB, CLAHE, crops, flips, pads, and every transform and dataset item
  built from those;
* a linear rotation of a uint8 image: at most one level, on at most 0.1 %
  of the pixels (cv2's vector code orders some float32 operations
  otherwise; 0.05 % measured on these images);
* float32 resizes: 1e-3 absolute on 0-255 values (cv2's vector code fuses
  some multiply-adds).

The class maps of ``dataset_test`` over a ``MultiScaleFlipAug`` dataset
(``tests/test_inference.py``, at 32²) agree exactly; the tiny segmentor
carries JAX's weights through the bridge.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from PIL import Image  # noqa: E402

from cp2_tpu.data import class_names as jnames  # noqa: E402
from cp2_tpu.data import custom as jcustom  # noqa: E402
from cp2_tpu.data import pipelines as jpipes  # noqa: E402
from cp2_tpu_torch.data import class_names as names  # noqa: E402
from cp2_tpu_torch.data import custom, imgproc, pipelines  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


def _rgb(h, w, seed=0):
    r = np.random.RandomState(seed)
    # a smooth ramp under the noise, so resamplers see gradients, not only
    # noise
    ramp = np.linspace(0, 1, w)[None, :, None] * np.linspace(0.4, 1, h)[:, None, None]
    return np.clip(r.rand(h, w, 3) * 160 + ramp * 95, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    rgb = _rgb(37, 41)
    paths = {
        "RGB": root / "rgb.png",
        "RGBA": root / "rgba.png",
        "L": root / "l.png",
        "P": root / "p.png",
    }
    Image.fromarray(rgb).save(paths["RGB"])
    alpha = np.random.RandomState(1).randint(0, 256, (37, 41, 1)).astype(np.uint8)
    Image.fromarray(np.concatenate([rgb, alpha], -1)).save(paths["RGBA"])
    Image.fromarray(rgb[..., 1]).save(paths["L"])
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=12).save(paths["P"])
    return paths


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("flag", ["color", "grayscale"])
def test_imread_matches_cv2(pngs, mode, flag):
    """A grey read of a colour or palette PNG is libpng's truncated luma,
    not PIL's ``convert("L")`` and not the palette index."""
    path = str(pngs[mode])
    if flag == "color":
        ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        ours = imgproc.imread(path, imgproc.IMREAD_COLOR)
    else:
        ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        ours = imgproc.imread(path, imgproc.IMREAD_GRAYSCALE)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    if mode == "P" and flag == "grayscale":
        assert not np.array_equal(ours, np.asarray(Image.open(path)))


def test_imread_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        imgproc.imread(str(tmp_path / "none.png"))


RESIZES = [(37, 41, 50, 29), (40, 40, 20, 20), (64, 48, 32, 24), (33, 47, 66, 94),
           (40, 40, 36, 36), (48, 64, 67, 81)]


@pytest.mark.parametrize("sh,sw,dh,dw", RESIZES)
def test_resizes_match_cv2(sh, sw, dh, dw):
    img = _rgb(sh, sw, seed=sh)
    np.testing.assert_array_equal(
        imgproc.resize_linear(img, (dw, dh)),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(
        imgproc.resize_linear(img[..., 0], (dw, dh)),
        cv2.resize(img[..., 0], (dw, dh), interpolation=cv2.INTER_LINEAR))
    f = img.astype(np.float32)
    np.testing.assert_allclose(
        imgproc.resize_linear(f, (dw, dh)),
        cv2.resize(f, (dw, dh), interpolation=cv2.INTER_LINEAR), rtol=0, atol=1e-3)
    mask = np.random.RandomState(sw).randint(0, 21, (sh, sw)).astype(np.int32)
    np.testing.assert_array_equal(
        imgproc.resize_nearest(mask, (dw, dh)),
        cv2.resize(mask, (dw, dh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("angle", [-171.3, -98.2, -30.0, 7.25, 13.7, 90.0, 163.6])
def test_rotation_matches_cv2(angle):
    for h, w in ((37, 41), (64, 48)):
        img = _rgb(h, w, seed=w)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        np.testing.assert_array_equal(imgproc.rotation_matrix((w / 2, h / 2), angle, 1.0), m)
        ref = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR, borderValue=0)
        ours = imgproc.warp_affine(img, m, (w, h), nearest=False, border_value=0)
        diff = np.abs(ours.astype(int) - ref)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (h, w, diff.max(), (diff > 0).mean())
        mask = np.random.RandomState(h).randint(0, 5, (h, w)).astype(np.int32)
        np.testing.assert_array_equal(
            imgproc.warp_affine(mask, m, (w, h), nearest=True, border_value=255),
            cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST, borderValue=255))


@pytest.mark.parametrize("width", [7, 24, 40, 100, 512])
def test_hsv_round_trip_matches_cv2(width):
    """RGB→HSV on uint8, and HSV→RGB, whose rows cv2 splits into vector
    blocks of 32 pixels and a scalar tail."""
    r = np.random.RandomState(width)
    rgb = r.randint(0, 256, (16, width, 3)).astype(np.uint8)
    hsv = imgproc.rgb_to_hsv(rgb)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    np.testing.assert_array_equal(imgproc.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    shifted = hsv.copy()
    shifted[..., 0] = r.randint(0, 256, shifted.shape[:2])  # hue past 180 too
    np.testing.assert_array_equal(imgproc.hsv_to_rgb(shifted),
                                  cv2.cvtColor(shifted, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("h,w,clip,grid", [(64, 64, 40.0, (8, 8)), (37, 45, 2.0, (8, 8)),
                                           (50, 61, 4.0, (4, 3))])
def test_clahe_matches_cv2(h, w, clip, grid):
    img = _rgb(h, w, seed=h)[..., 2]
    np.testing.assert_array_equal(imgproc.clahe(img, clip, grid),
                                  cv2.createCLAHE(clip, grid).apply(img))


# --------------------------------------------------------------------------
# each transform against the JAX package's, on the same results dict
# --------------------------------------------------------------------------

def _results(pngs, float_img=False):
    img = imgproc.imread(str(pngs["RGB"]))
    seg = np.random.RandomState(5).randint(0, 4, img.shape[:2]).astype(np.int64)
    seg[:5, :7] = 255
    img = img.astype(np.float32) if float_img else img
    return {"img": img, "gt_semantic_seg": seg, "img_shape": img.shape,
            "ori_shape": img.shape, "pad_shape": img.shape, "scale_factor": 1.0,
            "filename": "x.png"}


TRANSFORMS = {
    "Resize-ratio": (dict(type="Resize", img_scale=(64, 48), ratio_range=(0.5, 2.0), seed=3), 4),
    "Resize-fixed": (dict(type="Resize", img_scale=(30, 52), keep_ratio=False), 1),
    "RandomFlip": (dict(type="RandomFlip", prob=0.5, seed=1), 4),
    "RandomFlip-vertical": (dict(type="RandomFlip", prob=1.0, direction="vertical"), 1),
    "Pad-size": (dict(type="Pad", size=(48, 64)), 1),
    "Pad-divisor": (dict(type="Pad", size_divisor=16, pad_val=7), 1),
    "Normalize": (dict(type="Normalize", mean=MEAN, std=STD), 1),
    "Rerange": (dict(type="Rerange", min_value=-1, max_value=2), 1),
    "CLAHE": (dict(type="CLAHE", clip_limit=3.0, tile_grid_size=(4, 4)), 1),
    "RandomCrop": (dict(type="RandomCrop", crop_size=(24, 20), seed=2), 4),
    "RandomCrop-cat-max": (dict(type="RandomCrop", crop_size=(16, 16), cat_max_ratio=0.4,
                                seed=4), 4),
    "RandomRotate-mask": (dict(type="RandomRotate", prob=1.0, degree=40, seed=5), 4),
    "RGB2Gray": (dict(type="RGB2Gray"), 1),
    "RGB2Gray-1ch": (dict(type="RGB2Gray", out_channels=1), 1),
    "AdjustGamma": (dict(type="AdjustGamma", gamma=1.7), 1),
    "SegRescale": (dict(type="SegRescale", scale_factor=0.5), 1),
    "PhotoMetricDistortion": (dict(type="PhotoMetricDistortion", seed=6), 6),
    "DefaultFormatBundle": (dict(type="DefaultFormatBundle"), 1),
    "ImageToTensor": (dict(type="ImageToTensor", keys=["img"]), 1),
    "Collect": (dict(type="Collect", keys=["img", "gt_semantic_seg"]), 1),
}


def _assert_results_equal(ours, ref, image_tol=None):
    if isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _assert_results_equal(o, r, image_tol)
        return
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_results_equal(ours[k], v, image_tol)
        elif isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            if k == "img" and image_tol is not None:
                diff = np.abs(ours[k].astype(np.float64) - v)
                assert diff.max() <= 1 and (diff > 0).mean() <= image_tol, k
            else:
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(pngs, name):
    """Each transform, called ``calls`` times from one instance (so the
    draws of its ``RandomState`` go on), equals JAX's on the same input."""
    cfg, calls = TRANSFORMS[name]
    ours_t, ref_t = pipelines.PIPELINES.build(dict(cfg)), jpipes.PIPELINES.build(dict(cfg))
    for i in range(calls):
        results = _results(pngs, float_img=name in ("Rerange",))
        ours = ours_t(copy.deepcopy(results))
        ref = ref_t(copy.deepcopy(results))
        _assert_results_equal(ours, ref)


def test_rotate_image_within_one_level_of_jax(pngs):
    t_ours = pipelines.PIPELINES.build(dict(type="RandomRotate", prob=0.8, degree=(-60, 25),
                                            pad_val=9, seed=7))
    t_ref = jpipes.PIPELINES.build(dict(type="RandomRotate", prob=0.8, degree=(-60, 25),
                                        pad_val=9, seed=7))
    for _ in range(5):
        results = _results(pngs)
        _assert_results_equal(t_ours(copy.deepcopy(results)), t_ref(copy.deepcopy(results)),
                              image_tol=1e-3)


def test_load_transforms_match_jax(pngs):
    results = {"img_info": {"filename": os.path.basename(pngs["RGBA"])},
               "img_prefix": str(pngs["RGBA"].parent),
               "ann_info": {"seg_map": os.path.basename(pngs["P"])},
               "seg_prefix": str(pngs["P"].parent)}
    for cfg in (dict(type="LoadImageFromFile"), dict(type="LoadImageFromFile", to_float32=True),
                dict(type="LoadImageFromFile", color_type="grayscale"),
                dict(type="LoadAnnotations"), dict(type="LoadAnnotations", reduce_zero_label=True)):
        ours = pipelines.PIPELINES.build(dict(cfg))(copy.deepcopy(results))
        ref = jpipes.PIPELINES.build(dict(cfg))(copy.deepcopy(results))
        _assert_results_equal(ours, ref)


def test_multi_scale_flip_aug_matches_jax(pngs):
    cfg = dict(type="MultiScaleFlipAug", img_scale=(32, 24), img_ratios=[0.5, 1.0, 1.5],
               flip=True, transforms=[dict(type="Resize", keep_ratio=True),
                                      dict(type="RandomFlip"),
                                      dict(type="Normalize", mean=MEAN, std=STD),
                                      dict(type="ImageToTensor", keys=["img"]),
                                      dict(type="Collect", keys=["img"])])
    results = _results(pngs)
    ours = pipelines.PIPELINES.build(copy.deepcopy(cfg))(copy.deepcopy(results))
    ref = jpipes.PIPELINES.build(copy.deepcopy(cfg))(copy.deepcopy(results))
    assert len(ours) == 6
    _assert_results_equal(ours, ref)


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    """16 image PNGs of 40x48 with class-index masks {0, 1}."""
    root = tmp_path_factory.mktemp("seg")
    img_dir, ann_dir = root / "img", root / "ann"
    img_dir.mkdir()
    ann_dir.mkdir()
    r = np.random.RandomState(0)
    for i in range(16):
        Image.fromarray(_rgb(40, 48, seed=i)).save(img_dir / f"s{i:02d}.png")
        mask = (r.rand(5, 6) > 0.5).repeat(8, 0).repeat(8, 1).astype(np.uint8)
        Image.fromarray(mask).save(ann_dir / f"s{i:02d}.png")
    return img_dir, ann_dir


PIPELINE = [  # tests/test_data_layer.py::test_mmseg_pipeline_end_to_end
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations"),
    dict(type="Resize", img_scale=(64, 48), ratio_range=(0.9, 1.1)),
    dict(type="RandomFlip", prob=0.5),
    dict(type="PhotoMetricDistortion"),
    dict(type="Normalize", mean=MEAN, std=STD),
    dict(type="Pad", size=(64, 64)),
    dict(type="DefaultFormatBundle"),
    dict(type="Collect", keys=["img", "gt_semantic_seg"]),
]


def _datasets(seg_tree, pipeline=PIPELINE):
    img_dir, ann_dir = seg_tree
    kw = dict(img_dir=str(img_dir), img_suffix=".png", ann_dir=str(ann_dir),
              seg_map_suffix=".png", classes=("bg", "fg"))
    return (custom.CustomDataset(copy.deepcopy(pipeline), **kw),
            jcustom.CustomDataset(copy.deepcopy(pipeline), **kw))


def test_custom_dataset_pipeline_matches_jax(seg_tree):
    ours, ref = _datasets(seg_tree)
    assert len(ours) == len(ref) == 16
    for i in range(16):
        a, b = ours[i], ref[i]
        assert a["img"].shape == (64, 64, 3) and a["gt_semantic_seg"].shape == (64, 64)
        _assert_results_equal(a, b)


def test_gt_maps_and_evaluate_match_jax(seg_tree):
    ours, ref = _datasets(seg_tree)
    gts = list(ours.get_gt_seg_maps())
    for a, b in zip(gts, ref.get_gt_seg_maps()):
        np.testing.assert_array_equal(a, b)
    r = np.random.RandomState(3)
    preds = [np.where(r.rand(*g.shape) < 0.8, g, 1 - g) for g in gts]
    metrics = ["mIoU", "mDice", "mFscore"]
    got, want = ours.evaluate(preds, metric=metrics), ref.evaluate(preds, metric=metrics)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert ours.evaluate(gts, metric="mIoU")["mIoU"] == pytest.approx(1.0)


def test_class_tables_and_palettes_match_jax():
    for alias in ("cityscapes", "ade", "ade20k", "voc", "pascal_voc", "voc12", "voc12aug",
                  "pascal_context"):
        assert names.get_classes(alias) == jnames.get_classes(alias)
        assert names.get_palette(alias) == jnames.get_palette(alias)
    for n in (2, 19, 60):
        assert names.random_palette(n) == jnames.random_palette(n)
    with pytest.raises(ValueError):
        names.get_classes("nope")


@pytest.mark.parametrize("name", sorted(jcustom.DATASETS._entries))
def test_registered_dataset_matches_jax(seg_tree, name):
    img_dir, ann_dir = seg_tree
    cfg = dict(type=name, pipeline=[dict(type="LoadImageFromFile")], img_dir=str(img_dir),
               ann_dir=str(ann_dir))
    ours, ref = custom.build_dataset(dict(cfg)), jcustom.build_dataset(dict(cfg))
    assert type(ours).__name__ == type(ref).__name__ == name
    for attr in ("CLASSES", "PALETTE", "img_suffix", "seg_map_suffix", "reduce_zero_label",
                 "img_infos"):
        assert getattr(ours, attr) == getattr(ref, attr), attr


def test_concat_and_repeat_match_jax(seg_tree):
    img_dir, ann_dir = seg_tree
    one = dict(type="CustomDataset", pipeline=[dict(type="LoadImageFromFile")],
               img_dir=str(img_dir), img_suffix=".png", ann_dir=str(ann_dir))
    cfg = dict(type="ConcatDataset", datasets=[
        one, dict(type="RepeatDataset", times=3, dataset=one)])
    ours, ref = custom.build_dataset(copy.deepcopy(cfg)), jcustom.build_dataset(copy.deepcopy(cfg))
    assert len(ours) == len(ref) == 64
    for idx in (0, 15, 16, 40, 63):
        np.testing.assert_array_equal(ours[idx]["img"], ref[idx]["img"])
        assert ours[idx]["filename"] == ref[idx]["filename"]


def test_dataset_test_over_multi_scale_flip_aug_matches_jax(seg_tree):
    """``dataset_test`` over the TTA dataset of ``tests/test_inference.py``
    (32², flip), the tiny segmentor of ``tests/test_finetune_task.py``
    with JAX's weights: the same class maps."""
    import jax
    import jax.numpy as jnp
    import torch

    from _torch_port_common import fill_variables
    from cp2_tpu.models import build_segmentor as jax_build_segmentor
    from cp2_tpu.train.test_loop import dataset_test as jax_dataset_test
    from cp2_tpu_torch.checkpoint.bridge import load_flax_into
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.train.test_loop import dataset_test

    model_cfg = dict(
        type="EncoderDecoder",
        backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                      dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1), norm_cfg=dict(type="BN"),
                      contract_dilation=True),
        decode_head=dict(type="ASPPHead", in_channels=64, channels=16, dilations=(1, 6),
                         num_classes=2, norm_cfg=dict(type="BN")))
    pipeline = [
        dict(type="LoadImageFromFile"),
        dict(type="MultiScaleFlipAug", img_scale=(32, 32), flip=True, transforms=[
            dict(type="Resize", keep_ratio=False),
            dict(type="RandomFlip", prob=0.0),
            dict(type="Normalize", mean=[0, 0, 0], std=[255, 255, 255]),
            dict(type="ImageToTensor", keys=["img"]),
            dict(type="Collect", keys=["img"])]),
    ]
    ours_ds, ref_ds = _datasets(seg_tree, pipeline)
    jmodel = jax_build_segmentor(model_cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3)), train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    port = build_segmentor(model_cfg)
    load_flax_into(port, params, stats)
    port.eval()
    n = 4
    sub = lambda ds: [ds[i] for i in range(n)]  # noqa: E731
    ref = jax_dataset_test(jmodel, {"params": params, "batch_stats": stats}, sub(ref_ds))
    with torch.backends.mkldnn.flags(enabled=False):
        ours = dataset_test(port, sub(ours_ds))
    for a, b in zip(ours, ref):
        assert a.shape == (32, 32)
        np.testing.assert_array_equal(a, b)


def test_pipeline_runs_with_cv2_hidden(seg_tree):
    """As on the card machine, which has no cv2: the package imports and
    the whole pipeline runs with ``import cv2`` failing."""
    img_dir, ann_dir = seg_tree
    code = f"""
import sys
sys.modules["cv2"] = None
sys.path.insert(0, {ROOT!r})
from cp2_tpu_torch.data.custom import CustomDataset
ds = CustomDataset({PIPELINE[:4] + [dict(type="RandomRotate", prob=1.0, degree=20),
                                    dict(type="CLAHE")] + PIPELINE[4:]!r},
                   img_dir={str(img_dir)!r}, img_suffix=".png", ann_dir={str(ann_dir)!r},
                   classes=("bg", "fg"))
item = ds[3]
assert item["img"].shape == (64, 64, 3), item["img"].shape
assert "cv2" not in [m for m, v in sys.modules.items() if v is not None]
print("ok", ds.evaluate([g for g in ds.get_gt_seg_maps()])["mIoU"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok 1.0"

"""The port's pretrain augmentation against the JAX package's, on the CPU.

torch's generators cannot replay JAX's threefry draws, so the two halves
of each op are held apart:

* every deterministic apply (crop resampling, id maps, jitter, grayscale,
  blur, erase) and the whole ``pretrain_batch_augment`` take the draws the
  JAX op makes on a key, replayed into the port's parameters
  (``_torch_port_common.replay_*``), and must give the JAX output: images
  to 1e-5 absolute (float32 values in [0, 1]), ids exactly;
* every sampler is held against the JAX sampler by distribution: over 4096
  draws each, the mean of each drawn quantity agrees within 4 standard
  errors of the difference.

Shapes are tiny: batch 2, 40x48 uint8 sources, 32x32 outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    jax_split,
    replay_blur,
    replay_crop,
    replay_erase,
    replay_gray,
    replay_jax_pretrain_params,
    replay_jitter,
)
from cp2_tpu.augment import functional as JF
from cp2_tpu.augment import pipeline as JP
from cp2_tpu_torch.augment import functional as F
from cp2_tpu_torch.augment import pipeline as P

SRC_HW = (40, 48)
OUT_HW = (32, 32)
IMG_ATOL = 1e-5
N_DRAWS = 4096


def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _images(seed, n=2, hw=OUT_HW):
    return np.random.RandomState(seed).rand(n, *hw, 3).astype(np.float32)


def _jax_crop(c: F.CropParams):
    return JF.CropParams(*(jnp.asarray(v.numpy()) for v in c))


def _close(ours, ref, what=""):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=IMG_ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# deterministic applies on the JAX draws
# ---------------------------------------------------------------------------

CROPS = {
    # the whole frame, down in both axes, and a flipped crop at the
    # bottom-right edge, up in both axes
    "edges_down_up": dict(y0=[0.0, 30.5], x0=[0.0, 39.0], h=[40.0, 9.5], w=[48.0, 9.0],
                          flip=[False, True]),
    # flipped at the left edge, down in y and up in x; fractional corner at
    # the top edge, up in y and down in x
    "edges_mixed_flip": dict(y0=[3.3, 0.0], x0=[0.0, 5.25], h=[36.7, 20.0],
                             w=[20.0, 42.75], flip=[True, False]),
}


@pytest.mark.parametrize("case", sorted(CROPS) + ["sampled"])
def test_crop_resize_bilinear_matches_jax(case):
    if case == "sampled":
        crop = replay_crop(_keys(1, 2), SRC_HW, (0.2, 1.0), (3 / 4, 4 / 3), 0.5)
    else:
        c = CROPS[case]
        crop = F.CropParams(*(torch.tensor(c[k], dtype=torch.float32) for k in
                              ("y0", "x0", "h", "w")), torch.tensor(c["flip"]))
    img = _images(2, hw=SRC_HW)
    ref = jax.vmap(lambda im, cp: JF.crop_resize_bilinear(im, cp, OUT_HW))(
        jnp.asarray(img), _jax_crop(crop))
    _close(F.crop_resize_bilinear(torch.from_numpy(img), crop, OUT_HW), ref, case)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_pixel_ids_from_crop_matches_jax(stride):
    crop = replay_crop(_keys(3, 2), SRC_HW, (0.2, 1.0), (3 / 4, 4 / 3), 0.5)
    ref = jax.vmap(lambda cp: JF.pixel_ids_from_crop(cp, OUT_HW, SRC_HW, stride))(
        _jax_crop(crop))
    ours = F.pixel_ids_from_crop(crop, OUT_HW, SRC_HW, stride)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_warp_id_map_matches_jax():
    crop = replay_crop(_keys(4, 2), SRC_HW, (0.2, 1.0), (3 / 4, 4 / 3), 0.5)
    regions = np.random.RandomState(4).randint(0, 9, (2, *SRC_HW)).astype(np.int32)
    ref = jax.vmap(lambda m, cp: JF.warp_id_map(m, cp, OUT_HW))(
        jnp.asarray(regions), _jax_crop(crop))
    ours = F.warp_id_map(torch.from_numpy(regions), crop, OUT_HW)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# hue shifts well below zero: most pixels' hue + shift < 0, so the floor
# modulo (not fmod) decides the result
JITTER = dict(brightness=(0.6, 1.4), contrast=(0.6, 1.4), saturation=(0.6, 1.4),
              hue=(-0.45, -0.25), p=0.8)


@pytest.fixture(scope="module")
def jax_jitter():
    """The JAX ``color_jitter`` under vmap with the order as an argument:
    its 24-branch switch compiles once for every order."""
    return jax.jit(lambda keys, img, order: jax.vmap(lambda k, im: JF.color_jitter(
        k, im, JITTER["brightness"], JITTER["contrast"], JITTER["saturation"],
        JITTER["hue"], JITTER["p"], order_idx=order))(keys, img))


@pytest.mark.parametrize("order", [0, 7, 16, 23])
def test_color_jitter_matches_jax(jax_jitter, order):
    keys = _keys(10 + order, 4)
    img = _images(5, n=4)
    ref = jax_jitter(keys, jnp.asarray(img), jnp.int32(order))
    params = replay_jitter(keys, JITTER["brightness"], JITTER["contrast"],
                           JITTER["saturation"], JITTER["hue"], JITTER["p"], order)
    assert params.apply.any()
    h, _, _ = F._rgb_to_hsv(torch.from_numpy(img))
    assert ((h + params.hue.reshape(-1, 1, 1)) < 0).any()  # a negative wrap runs
    _close(F.color_jitter(torch.from_numpy(img), params), ref, f"order {order}")


@pytest.mark.parametrize("op", ["grayscale", "blur", "erase"])
def test_photometric_and_erase_match_jax(op):
    keys = _keys(20, 4)
    img = _images(6, n=4)
    x = torch.from_numpy(img)
    if op == "grayscale":
        ref = jax.vmap(lambda k, im: JF.to_grayscale(k, im, 0.5))(keys, jnp.asarray(img))
        gate = replay_gray(keys, 0.5)
        assert gate.any() and not gate.all()
        ours = F.to_grayscale(x, gate)
    elif op == "blur":
        ref = jax.vmap(lambda k, im: JF.gaussian_blur(k, im, (0.1, 2.0), 0.5))(
            keys, jnp.asarray(img))
        params = replay_blur(keys, (0.1, 2.0), 0.5)
        assert params.apply.any()
        ours = F.gaussian_blur(x, params)
    else:
        ref = jax.vmap(lambda k, im: JF.random_erase(k, im, (0.5, 0.8), (0.8, 1.25)))(
            keys, jnp.asarray(img))
        ours = F.random_erase(x, replay_erase(keys, OUT_HW, (0.5, 0.8), (0.8, 1.25)))
    _close(ours, ref, op)


@pytest.mark.parametrize("with_regions", [False, True])
def test_pretrain_batch_augment_matches_jax(with_regions):
    """The whole pipeline on the JAX draws: every image to 1e-5, every id
    exactly.  The batch's jitter order stays fixed, as by default: a random
    order compiles the JAX op's 24-branch switch once per view (~35 s);
    ``test_color_jitter_matches_jax`` covers the orders."""
    r = np.random.RandomState(7)
    raw = {name: r.randint(0, 256, (2, *SRC_HW, 3)).astype(np.uint8)
           for name in ("fg", "bg0", "bg1")}
    if with_regions:
        raw["region_maps"] = r.randint(0, 9, (2, *SRC_HW)).astype(np.int32)
    kw = dict(out_hw=OUT_HW, pixel_ids_stride=2)
    rng = jax.random.PRNGKey(11)
    ref = JP.pretrain_batch_augment(rng, {k: jnp.asarray(v) for k, v in raw.items()},
                                    JP.AugmentConfig(**kw))
    cfg = P.AugmentConfig(**kw)
    params = replay_jax_pretrain_params(rng, 2, SRC_HW, cfg)
    ours = P.apply_pretrain_augment({k: torch.from_numpy(v) for k, v in raw.items()},
                                    params, cfg)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if key.startswith(("pixel_ids", "region_ids")):
            assert ours[key].dtype == torch.int32
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
        else:
            assert ours[key].dtype == torch.float32
            _close(ours[key], value, key)
    for bg in ("bg0", "bg1"):  # every background has its erased hole
        assert ((ours[bg] == 0).all(dim=-1).flatten(1).sum(1) > 0).all()


# ---------------------------------------------------------------------------
# samplers, by distribution
# ---------------------------------------------------------------------------

def _crop_stats(y0, x0, h, w, flip):
    return {"area": h * w / (SRC_HW[0] * SRC_HW[1]), "log_aspect": np.log(w / h),
            "y0": y0 / SRC_HW[0], "x0": x0 / SRC_HW[1], "flip": flip}


def _port_draws(name, gen, n):
    if name == "crop":
        c = F.sample_resized_crop(gen, n, SRC_HW)
        return _crop_stats(*(v.double().numpy() for v in c))
    if name == "jitter":
        j = F.sample_color_jitter(gen, n)
        return {k: getattr(j, k).double().numpy()
                for k in ("brightness", "contrast", "saturation", "hue", "apply")}
    if name == "gates":
        return {"gray": F.sample_gate(gen, n, 0.2).double().numpy(),
                **{f"blur_{k}": v.double().numpy()
                   for k, v in F.sample_gaussian_blur(gen, n)._asdict().items()}}
    e = F.sample_random_erase(gen, n, OUT_HW)
    return {"area": (e.eh * e.ew).double().numpy() / (OUT_HW[0] * OUT_HW[1]),
            "y0": e.y0.double().numpy(), "x0": e.x0.double().numpy()}


def _jax_draws(name, keys):
    if name == "crop":
        c = replay_crop(keys, SRC_HW, (0.2, 1.0), (3 / 4, 4 / 3), 0.5)
        return _crop_stats(*(v.double().numpy() for v in c))
    if name == "jitter":
        j = replay_jitter(keys, (0.6, 1.4), (0.6, 1.4), (0.6, 1.4), (-0.1, 0.1), 0.8)
        return {k: getattr(j, k).double().numpy()
                for k in ("brightness", "contrast", "saturation", "hue", "apply")}
    if name == "gates":
        k = jax_split(keys, 2)
        return {"gray": replay_gray(k[:, 0], 0.2).double().numpy(),
                **{f"blur_{n}": v.double().numpy()
                   for n, v in replay_blur(k[:, 1], (0.1, 2.0), 0.5)._asdict().items()}}
    e = replay_erase(keys, OUT_HW, (0.5, 0.8), (0.8, 1.25))
    return {"area": (e.eh * e.ew).double().numpy() / (OUT_HW[0] * OUT_HW[1]),
            "y0": e.y0.double().numpy(), "x0": e.x0.double().numpy()}


@pytest.mark.parametrize("name", ["crop", "jitter", "gates", "erase"])
def test_samplers_match_jax_by_distribution(name):
    ours = _port_draws(name, torch.Generator().manual_seed(5), N_DRAWS)
    ref = _jax_draws(name, _keys(5, N_DRAWS))
    assert set(ours) == set(ref)
    for key, want in ref.items():
        got = ours[key]
        assert got.shape == want.shape == (N_DRAWS,)
        se = np.sqrt((got.var() + want.var()) / N_DRAWS)
        assert abs(got.mean() - want.mean()) <= 4 * se + 1e-12, (
            name, key, got.mean(), want.mean(), se)


def test_sample_pretrain_params_on_generator_device():
    """Every drawn tensor lies on the generator's device, one per image;
    the op orders stay host integers."""
    cfg = P.AugmentConfig(out_hw=OUT_HW, jitter_random_order=True)
    params = P.sample_pretrain_params(torch.Generator().manual_seed(0), 2, SRC_HW, cfg)
    for view in (params.view_a, params.view_b, params.bg0, params.bg1):
        assert isinstance(view.jitter.order, int) and 0 <= view.jitter.order < 24
        for t in (*view.crop, view.jitter.brightness, view.gray, view.blur.sigma):
            assert t.shape == (2,) and t.device.type == "cpu"
    again = P.sample_pretrain_params(torch.Generator().manual_seed(0), 2, SRC_HW, cfg)
    assert torch.equal(params.erase0.y0, again.erase0.y0)  # same seed, same draws

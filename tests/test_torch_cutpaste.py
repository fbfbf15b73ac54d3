"""The port's CutPaste against the JAX package's, on the CPU.

torch's generators cannot replay JAX's threefry draws, so the two halves
are held apart, as in ``tests/test_torch_augment.py``:

* the deterministic apply takes the draws that the JAX ``cutpaste_batch``
  makes on a key (its ``split`` per image, ``choice`` of the class,
  ``randint`` of the extra patches, ``fold_in`` per patch and
  ``_sample_patch``), replayed into the port's ``CutPasteParams`` with the
  rotation's cosine and sine as JAX computes them, and must give the JAX
  output: images to 1e-6 absolute (the paste is a gather and a select, so
  any difference is a pixel taken from elsewhere), masks and targets
  exactly.  The cases cover REGULAR (2 classes), SCAR rotated by up to 45°,
  the OUTPUT variant's mirror and NONE's none, and up to 3 patches.
* the sampler is held to its law over 4096 images: class and patch-count
  frequencies within 4 standard errors of their probabilities, every
  drawn area, aspect and rotation inside its range and their means within
  4 standard errors of the uniform laws' means, and every pasted box
  (rotated) inside the frame.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import replay_jax_cutpaste
from cp2_tpu.augment import cutpaste as JC
from cp2_tpu_torch.augment import cutpaste as C

HW = (40, 48)
IMG_ATOL = 1e-6
N_DRAWS = 4096

CASES = {
    "regular_output": dict(cfg=dict(num_classes=2, max_num_patches=1), mirror=True, seed=0),
    "scar_rotated_output": dict(cfg=dict(num_classes=3, max_num_patches=3, min_rotation=0,
                                         max_rotation=45), mirror=True, seed=1),
    "scar_rotated_none": dict(cfg=dict(num_classes=3, max_num_patches=3, min_rotation=10,
                                       max_rotation=30, max_area_scale=0.3), mirror=False,
                              seed=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_on_jax_draws_matches_jax(case):
    spec = CASES[case]
    jcfg = JC.CutPasteConfig(**spec["cfg"])
    n = 12
    r = np.random.RandomState(spec["seed"])
    images = r.rand(n, *HW, 3).astype(np.float32)
    mirrors = r.rand(n, *HW, 3).astype(np.float32) if spec["mirror"] else None
    rng = jax.random.PRNGKey(100 + spec["seed"])
    ref = JC.cutpaste_batch(rng, jnp.asarray(images),
                            None if mirrors is None else jnp.asarray(mirrors), jcfg)
    params = replay_jax_cutpaste(rng, n, HW, jcfg)
    out, mir, mask, target = C.apply_cutpaste(
        torch.from_numpy(images), None if mirrors is None else torch.from_numpy(mirrors),
        params)
    np.testing.assert_array_equal(target.numpy(), np.asarray(ref["target"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref["mask"]))
    assert mask.dtype == torch.int32 and target.dtype == torch.int32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref["image"]), rtol=0, atol=IMG_ATOL)
    if mirrors is None:
        assert mir is None and "mirror" not in ref
    else:
        np.testing.assert_allclose(mir.numpy(), np.asarray(ref["mirror"]), rtol=0,
                                   atol=IMG_ATOL)
        # the mirror carries the image's pasted pixels and keeps its own elsewhere
        pasted = mask.numpy() > 0
        np.testing.assert_array_equal(mir.numpy()[pasted], out.numpy()[pasted])
        np.testing.assert_array_equal(mir.numpy()[~pasted], mirrors[~pasted])
    # the draws exercise what the case names
    classes = set(target.tolist())
    assert 1 in classes or 2 in classes
    if jcfg.num_classes == 3:
        scar = params.target == 2
        assert scar.any() and (params.sin[scar][params.active[scar]] != 0).any()
        assert (params.active.sum(dim=1) > 1).any()
    assert (mask > 0).any()


def test_cutpaste_batch_keys_and_shapes():
    cfg = C.CutPasteConfig(num_classes=3, max_num_patches=2)
    images = torch.rand(3, *HW, 3)
    gen = torch.Generator().manual_seed(0)
    out = C.cutpaste_batch(gen, images, images.flip(0), cfg)
    assert set(out) == {"image", "mirror", "mask", "target"}
    assert out["image"].shape == out["mirror"].shape == images.shape
    assert out["mask"].shape == (3, *HW) and out["target"].shape == (3,)
    assert set(C.cutpaste_batch(gen, images, None, cfg)) == {"image", "mask", "target"}


def _within(mean, expected, sd, n, what):
    assert abs(mean - expected) <= 4 * sd / math.sqrt(n), (what, mean, expected)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_sampler_follows_its_law(num_classes):
    hw = (64, 80)
    cfg = C.CutPasteConfig(num_classes=num_classes, max_num_patches=3, min_rotation=0,
                           max_rotation=45)
    p = C.sample_cutpaste(torch.Generator().manual_seed(7), N_DRAWS, hw, cfg)
    probs = C.class_probabilities(num_classes)
    for k, pk in enumerate(probs):
        freq = float((p.target == k).float().mean())
        _within(freq, pk, math.sqrt(pk * (1 - pk)), N_DRAWS, f"class {k}")
    counts = p.active.sum(dim=1)
    assert bool(p.active[:, 0].all())
    for k in (1, 2, 3):
        _within(float((counts == k).float().mean()), 1 / 3, math.sqrt(2 / 9), N_DRAWS,
                f"{k} patches")
    h, w = hw
    area = (4 * p.half_h * p.half_w / (h * w)).double()
    aspect = (p.half_w / p.half_h).double()
    degrees = torch.rad2deg(torch.atan2(p.sin, p.cos)).double()
    eps = 1e-4
    for cls, (a_lo, a_hi), (r_lo, r_hi), (d_lo, d_hi) in (
            (1, (0.02, 0.15), (1 / 3, 4 / 3), (0.0, 0.0)),
            (2, (0.02, 0.075), (3.0, 6.0), (0.0, 45.0))):
        sel = (p.target == cls)[:, None].expand_as(p.active)
        if not sel.any():
            continue
        m = int(sel.sum())
        for name, v, lo, hi in (("area", area, a_lo, a_hi), ("aspect", aspect, r_lo, r_hi),
                                ("rotation", degrees, d_lo, d_hi)):
            x = v[sel]
            assert float(x.min()) >= lo - eps * max(1, abs(lo)), (cls, name, float(x.min()))
            assert float(x.max()) <= hi + eps * max(1, abs(hi)), (cls, name, float(x.max()))
            if hi > lo:
                _within(float(x.mean()), (lo + hi) / 2, (hi - lo) / math.sqrt(12), m,
                        f"class {cls} {name}")
    # the rotated box of every slot, and the source patch, lie inside the frame
    bh = p.half_h * p.cos.abs() + p.half_w * p.sin.abs()
    bw = p.half_w * p.cos.abs() + p.half_h * p.sin.abs()
    assert bool((p.dst_cy - bh >= -eps).all() and (p.dst_cy + bh <= h + eps).all())
    assert bool((p.dst_cx - bw >= -eps).all() and (p.dst_cx + bw <= w + eps).all())
    assert bool((p.src_cy - p.half_h >= -eps).all() and (p.src_cy + p.half_h <= h + eps).all())
    assert bool((p.src_cx - p.half_w >= -eps).all() and (p.src_cx + p.half_w <= w + eps).all())

"""The port's finetune and eval augmentation against the JAX package's, on
the CPU: ``grid_distortion``, ``finetune_augment_batch`` (polyp and lemon
stacks) and ``eval_augment_batch``.

As in ``tests/test_torch_augment.py``, each deterministic apply takes the
draws the JAX op makes, replayed into the port's parameters
(``_torch_port_common.replay_*``): images to 1e-5 absolute (float32 values
in [0, 1]), masks exactly.  Each sampler is held to the JAX sampler by
distribution: over 4096 draws the means of each drawn quantity agree within
4 standard errors of their difference.

Shapes are tiny: batch 4, 24x28 and 32x32 images, 2 and 12 classes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    replay_grid,
    replay_jax_eval_params,
    replay_jax_finetune_params,
)
from cp2_tpu.augment import functional as JF
from cp2_tpu.augment import pipeline as JP
from cp2_tpu_torch.augment import functional as F
from cp2_tpu_torch.augment import pipeline as P

IMG_ATOL = 1e-5
N_DRAWS = 4096


def _batch(seed, n=4, hw=(24, 28), classes=2, dtype=np.uint8):
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    if dtype != np.uint8:
        img = (img / 255.0).astype(dtype)
    # blocky masks: a flip or a warp moves whole regions, not noise
    mask = r.randint(0, classes, (n, hw[0] // 4 + 1, hw[1] // 4 + 1)).repeat(4, 1).repeat(4, 2)
    return img, mask[:, :hw[0], :hw[1]].astype(np.int32)


def _check(ours, ref):
    (img, mask), (ref_img, ref_mask) = ours, ref
    assert img.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=0, atol=IMG_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("hw,limit", [((24, 28), 0.3), ((32, 32), 0.5), ((23, 17), 0.3)])
def test_grid_distortion_matches_jax(hw, limit):
    """Gate forced on (p = 1) and off on alternate images via the replayed
    draws; 23x17 leaves a remainder cell on both axes."""
    img, mask = _batch(1, hw=hw, classes=5, dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    ref = jax.vmap(lambda k, im, m: JF.grid_distortion(k, im, m, distort_limit=limit, p=1.0))(
        keys, jnp.asarray(img), jnp.asarray(mask))
    params = replay_grid(keys, 5, limit, 1.0)
    assert params.apply.all()
    _check(F.grid_distortion(torch.from_numpy(img), torch.from_numpy(mask), params), ref)
    # the gate: images whose gate is off come back unchanged
    off = params._replace(apply=torch.tensor([True, False, True, False]))
    out_img, out_mask = F.grid_distortion(torch.from_numpy(img), torch.from_numpy(mask), off)
    assert torch.equal(out_img[1], torch.from_numpy(img[1]))
    assert torch.equal(out_mask[3], torch.from_numpy(mask[3]))
    np.testing.assert_allclose(out_img[0].numpy(), np.asarray(ref[0][0]), atol=IMG_ATOL)


STACKS = {
    "polyp": (P.FinetuneAugmentConfig(distort_p=1.0), JP.FinetuneAugmentConfig(distort_p=1.0), 2),
    "polyp_default": (P.FinetuneAugmentConfig(), JP.FinetuneAugmentConfig(), 2),
    "lemon": (dataclasses.replace(P.lemon_augment_config(), distort_p=1.0),
              dataclasses.replace(JP.lemon_augment_config(), distort_p=1.0), 12),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_finetune_augment_batch_matches_jax(stack):
    cfg, jcfg, classes = STACKS[stack]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    img, mask = _batch(2, classes=classes)
    rng = jax.random.PRNGKey(5)
    ref = JP.finetune_augment_batch(rng, jnp.asarray(img), jnp.asarray(mask), jcfg)
    params = replay_jax_finetune_params(rng, 4, (24, 28), cfg)
    assert params.noise.apply.any() and params.hflip.any()
    if stack == "lemon":
        assert params.jitter is None and params.bc.apply.any()
    else:
        assert params.bc is None and params.jitter.apply.any()
    _check(P.apply_finetune_augment(torch.from_numpy(img), torch.from_numpy(mask), params), ref)


@pytest.mark.parametrize("lemon", [False, True], ids=["polyp", "lemon"])
def test_eval_augment_batch_matches_jax(lemon):
    """The CLI's val flips: polyp H and V, lemon H and grid distortion (here
    at p 1 so the warp runs)."""
    kw = dict(hflip_p=0.5, vflip_p=0.0 if lemon else 0.5, distort_p=1.0 if lemon else 0.0)
    img, mask = _batch(3, classes=12 if lemon else 2, dtype=np.float32)
    rng = jax.random.PRNGKey(9)
    ref = JP.eval_augment_batch(rng, jnp.asarray(img), jnp.asarray(mask), **kw)
    params = replay_jax_eval_params(rng, 4, **kw)
    assert params.hflip.any() and not params.hflip.all()
    _check(P.apply_eval_augment(torch.from_numpy(img), torch.from_numpy(mask), params), ref)


# ---------------------------------------------------------------------------
# samplers, by distribution
# ---------------------------------------------------------------------------

def _stats(params):
    out = {"hflip": params.hflip, "vflip": params.vflip, "noise_var": params.noise.var,
           "noise_gate": params.noise.apply,
           "noise_mean": params.noise.normal.mean(dim=(1, 2, 3)),
           "noise_sq": (params.noise.normal ** 2).mean(dim=(1, 2, 3)),
           "sx": params.distort.sx.mean(1), "sy0": params.distort.sy[:, 0],
           "distort_gate": params.distort.apply}
    if params.jitter is not None:
        out.update(jitter_gate=params.jitter.apply, brightness=params.jitter.brightness,
                   saturation=params.jitter.saturation)
    if params.bc is not None:
        out.update(alpha=params.bc.alpha, beta=params.bc.beta, bc_gate=params.bc.apply)
    return {k: v.double().numpy() for k, v in out.items()}


@pytest.mark.parametrize("lemon", [False, True], ids=["polyp", "lemon"])
def test_finetune_sampler_matches_jax_by_distribution(lemon):
    cfg = P.lemon_augment_config() if lemon else P.FinetuneAugmentConfig()
    ours = _stats(P.sample_finetune_params(torch.Generator().manual_seed(2), N_DRAWS, (4, 4),
                                           cfg))
    ref = _stats(replay_jax_finetune_params(jax.random.PRNGKey(2), N_DRAWS, (4, 4), cfg))
    assert set(ours) == set(ref)
    for key, want in ref.items():
        got = ours[key]
        se = np.sqrt((got.var() + want.var()) / N_DRAWS)
        assert abs(got.mean() - want.mean()) <= 4 * se + 1e-12, (key, got.mean(), want.mean())


def test_eval_and_grid_samplers_on_generator_device():
    """Each drawn tensor lies on the generator's device, one row per image;
    an op whose probability is 0 draws nothing."""
    g = torch.Generator().manual_seed(0)
    grid = F.sample_grid_distortion(g, 3, p=0.2)
    assert grid.sx.shape == grid.sy.shape == (3, 6) and grid.apply.shape == (3,)
    assert float(grid.sx.min()) >= 0.7 and float(grid.sx.max()) <= 1.3
    ev = P.sample_eval_params(g, 3, vflip_p=0.0)
    assert ev.vflip is None and ev.distort is None and ev.hflip.shape == (3,)

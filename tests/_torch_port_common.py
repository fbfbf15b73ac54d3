"""Shared fixtures of the ``test_torch_*`` files: the JAX package against its
PyTorch port on the CPU.

The model is the flagship CP2 *structure* — dilated ResNet-50 (strides
1,2,2,1; dilations 1,1,1,2; ``contract_dilation``) under an ASPP head with
dilations 1,6,12,18 and the ``contrast_conv`` projector — at narrow widths
(stem/base channels 8, head channels 16, contrast dim 16) and 64x64 inputs,
whose 4x4 feature grid sends the JAX side through its ``DilatedConv3x3``
rewrite.  Weights and data come from numpy with a seed and go to both sides
as numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np

DIM = 16
HW = 64
BATCH = 2

TINY_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(
        type="ResNet",
        depth=50,
        stem_channels=8,
        base_channels=8,
        num_stages=4,
        out_indices=(0, 1, 2, 3),
        dilations=(1, 1, 1, 2),
        strides=(1, 2, 2, 1),
        norm_cfg=dict(type="BN"),
        contract_dilation=True,
    ),
    decode_head=dict(
        type="ASPPHead",
        in_channels=256,
        in_index=3,
        channels=16,
        contrast=True,
        contrast_dim=DIM,
        dilations=(1, 6, 12, 18),
        num_classes=2,
        norm_cfg=dict(type="BN"),
    ),
)


# config_moco.py's shape at narrow widths: a plain-stride ResNet-18 (OS 32)
# under the identity FCN head (num_convs=0) whose conv_seg the image-level
# variants never reach
MOCO_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(
        type="ResNet",
        depth=18,
        stem_channels=8,
        base_channels=8,
        num_stages=4,
        out_indices=(0, 1, 2, 3),
        dilations=(1, 1, 1, 1),
        strides=(1, 2, 2, 2),
        norm_cfg=dict(type="BN"),
    ),
    decode_head=dict(
        type="FCNHead",
        num_convs=0,
        concat_input=False,
        in_channels=64,
        in_index=3,
        channels=64,
        num_classes=2,
        norm_cfg=dict(type="BN"),
    ),
)

NARROW = dict(stem_channels=8, base_channels=8)  # the U-Nets' ResNet-50, narrowed


def narrow_unet_backbones(patch) -> None:
    """Make both packages' U-Net backbones a ResNet-50 of width 8.

    The U-Nets build ``ResNet(depth=50)`` at its full width (64) in both
    packages; ``patch`` (a ``pytest.MonkeyPatch``) swaps the name each
    ``unet`` module looks up for the same ResNet with ``NARROW`` widths.
    Keep it in force while the JAX side traces.
    """
    import functools

    import cp2_tpu.models.unet as jax_unet
    import cp2_tpu_torch.models.unet as torch_unet
    from cp2_tpu.models.resnet import ResNet as JaxResNet
    from cp2_tpu_torch.models.resnet import ResNet

    class NarrowJaxResNet(JaxResNet):
        stem_channels: int = NARROW["stem_channels"]
        base_channels: int = NARROW["base_channels"]

    patch.setattr(jax_unet, "ResNet", NarrowJaxResNet)
    patch.setattr(torch_unet, "ResNet", functools.partial(ResNet, **NARROW))


def jax_variant_encoder(pretrain_type, model_cfg, backbone_type=None, dim: int = DIM):
    from cp2_tpu.ssl import SSLEncoder
    from cp2_tpu.types import BackboneType

    return SSLEncoder(model_cfg=model_cfg, pretrain_type=pretrain_type,
                      backbone_type=backbone_type or BackboneType.DEEPLABV3, dim=dim)


def torch_variant_encoder(pretrain_type, model_cfg, backbone_type=None, dim: int = DIM,
                          hw: int = HW):
    """The port's twin of ``jax_variant_encoder``; enums by name."""
    from cp2_tpu_torch.ssl import SSLEncoder
    from cp2_tpu_torch.types import BackboneType, PretrainType

    bt = BackboneType[backbone_type.name] if backbone_type else BackboneType.DEEPLABV3
    return SSLEncoder(model_cfg, pretrain_type=PretrainType[pretrain_type.name],
                      backbone_type=bt, dim=dim, img_hw=(hw, hw))


def jax_encoder():
    from cp2_tpu.ssl import SSLEncoder
    from cp2_tpu.types import BackboneType, PretrainType

    return SSLEncoder(model_cfg=TINY_MODEL, pretrain_type=PretrainType.CP2,
                      backbone_type=BackboneType.DEEPLABV3, dim=DIM)


def torch_encoder():
    from cp2_tpu_torch.ssl import SSLEncoder

    return SSLEncoder(TINY_MODEL, dim=DIM)


def _fill(tree, r: np.random.RandomState, residual_scale: float, module: str = ""):
    """numpy values for a tree of shape structs, well conditioned for a
    forward: fan-in scaled kernels, non-trivial norm scales and stats.

    The last norm of each residual branch (``norm3``) gets a scale near
    0.25: ``zero_init_residual`` starts it at 0, and at 1 the 16 blocks of
    train-mode BatchNorm over a 2x4x4 batch amplify float32 rounding ~100x
    (a float64 run of the port measured 3e-4 absolute error at the output
    against 1.5e-5 with 0.25), which no float32 comparison could resolve.
    """
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _fill(value, r, residual_scale, key)
            continue
        shape = tuple(value.shape)
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = r.randn(*shape) / np.sqrt(fan_in)
        elif key == "scale":
            v = (residual_scale if module == "norm3" else 1.0) * (1.0 + 0.1 * r.randn(*shape))
        elif key == "var":
            v = r.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * r.randn(*shape)
        out[key] = v.astype(np.float32)
    return out


def random_flax_variables(model, seed: int = 0, residual_scale: float = 0.25,
                          hw: int = HW, init_all: bool = False):
    """``(params, batch_stats)`` of ``model`` as nested dicts of numpy,
    shapes from ``jax.eval_shape`` (no init compile), values from numpy.
    ``init_all`` builds the whole tree of an ``SSLEncoder`` variant (its
    ``init_all`` method) instead of the dense path's."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, method="init_all") if init_all
        else model.init(jax.random.PRNGKey(0), x, train=False))
    r = np.random.RandomState(seed)
    return fill_variables(shapes, r, residual_scale)


def fill_variables(shapes, r: np.random.RandomState, residual_scale: float = 0.25):
    """numpy ``(params, batch_stats)`` for a tree of shape structs from
    ``jax.eval_shape`` of a flax ``init`` (see ``_fill``)."""
    params = _fill(shapes["params"], r, residual_scale)
    stats = _fill(shapes.get("batch_stats", {}), r, residual_scale)
    return params, stats


def to_plain_dict(tree):
    """flax FrozenDict / dict of arrays → nested dict of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_plain_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def pre_augmented_batch(seed: int = 0, batch: int = BATCH, hw: int = HW):
    """The pre-augmented batch form of ``bench.py`` (``BENCH_NO_AUG=1``):
    two random views, backgrounds with an erased central square, and the
    identity pixel/region id maps, as numpy."""
    r = np.random.RandomState(seed)
    ids = np.tile(np.arange(1, hw * hw + 1, dtype=np.int32).reshape(1, hw, hw),
                  (batch, 1, 1))
    bg = r.rand(batch, hw, hw, 3).astype(np.float32)
    bg[:, hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4, :] = 0.0
    return {
        "img_a": r.rand(batch, hw, hw, 3).astype(np.float32),
        "img_b": r.rand(batch, hw, hw, 3).astype(np.float32),
        "bg0": bg,
        "bg1": bg.copy(),
        "pixel_ids_a": ids,
        "pixel_ids_b": ids,
        "region_ids_a": ids,
        "region_ids_b": ids,
    }


def unit_queue(seed: int, length: int, dim: int = DIM) -> np.ndarray:
    q = np.random.RandomState(seed).randn(length, dim).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def assert_close(ours, ref, tol: float, what: str = "") -> None:
    """rtol ``tol`` with an absolute floor of ``tol`` times the largest
    magnitude of ``ref``: a relative test alone cannot hold elements that
    sit near zero (BatchNorm biases and running means start near 0)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


def assert_trees_close(ours, ref, tol: float, path: str = "") -> None:
    """Same keys on both sides, every leaf ``assert_close``."""
    assert set(ours) == set(ref), (path, sorted(set(ours) ^ set(ref)))
    for key, value in ref.items():
        where = f"{path}/{key}"
        if isinstance(value, dict):
            assert_trees_close(ours[key], value, tol, where)
        else:
            assert_close(ours[key], value, tol, where)


# ---------------------------------------------------------------------------
# the JAX package's augmentation draws, replayed into the port's parameters
# ---------------------------------------------------------------------------
#
# torch's generators cannot reproduce JAX's threefry draws, so the tests
# hold the port's deterministic applies against the JAX ops on the draws the
# JAX ops make: each helper takes the per-image keys a JAX op receives and
# calls the same ``jax.random`` laws on the same key splits
# (``cp2_tpu/augment/functional.py:50,65,264,338,472``,
# ``cp2_tpu/augment/pipeline.py:53,65,97-98,132-133,141,292``).  A wrong
# replay makes the comparison it feeds fail.


def torchvision_name(key: str) -> str:
    """The port's ResNet key → torchvision's (``conv1.conv.weight`` →
    ``conv1.weight``, ``layer1_0.conv2.norm.bias`` → ``layer1.0.bn2.bias``,
    ``layer2_0.downsample.conv.weight`` → ``layer2.0.downsample.0.weight``)."""
    parts = key.split(".")
    if parts[0] == "conv1":
        return "conv1.weight" if parts[1] == "conv" else f"bn1.{parts[-1]}"
    stage, block = parts[0][len("layer"):].split("_")
    head = f"layer{stage}.{block}"
    if parts[1] == "downsample":
        return f"{head}.downsample.{0 if parts[2] == 'conv' else 1}.{parts[-1]}"
    if parts[1] == "norm3":
        return f"{head}.bn3.{parts[-1]}"
    if parts[1] == "conv3":
        return f"{head}.conv3.{parts[-1]}"
    return f"{head}.{parts[1] if parts[2] == 'conv' else 'bn' + parts[1][-1]}.{parts[-1]}"


# ---------------------------------------------------------------------------
# the finetune segmentor at narrow widths
# ---------------------------------------------------------------------------

# config_finetune.py's structure (dilated ResNet-50, OS 16, the ASPP
# classifier) at widths 8/16, with an FCN auxiliary head on stage 3
SEG_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=50, stem_channels=8, base_channels=8, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1),
                  norm_cfg=dict(type="BN"), contract_dilation=True),
    decode_head=dict(type="ASPPHead", in_channels=256, in_index=3, channels=16,
                     dilations=(1, 6, 12, 18), dropout_ratio=0.0, num_classes=2,
                     norm_cfg=dict(type="BN")),
    auxiliary_head=dict(type="FCNHead", in_channels=128, in_index=2, channels=8, num_convs=1,
                        concat_input=False, dropout_ratio=0.0, num_classes=2,
                        norm_cfg=dict(type="BN")),
)

# config_finetune_moco.py's structure (plain-stride, OS 32) on the MOCO
# encoder's ResNet-18 at width 8
SEG_MOCO_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(MOCO_MODEL["backbone"]),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                     dilations=(1, 6, 12, 18), dropout_ratio=0.1, num_classes=2,
                     norm_cfg=dict(type="BN")),
)


def _tensor(x, dtype=None):
    import torch

    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def jax_split(keys, num: int):
    """(N, 2) keys → (N, num, 2): ``jax.random.split`` per image."""
    import jax

    return jax.vmap(lambda k: jax.random.split(k, num))(keys)


def _uniform(keys, lo, hi):
    import jax

    return jax.vmap(lambda k: jax.random.uniform(k, minval=lo, maxval=hi))(keys)


def _bernoulli(keys, p):
    import jax

    return jax.vmap(lambda k: jax.random.bernoulli(k, p))(keys)


def replay_crop(keys, src_hw, scale, ratio, flip_p):
    """``sample_resized_crop`` on each key, as the port's ``CropParams``."""
    import jax

    from cp2_tpu.augment import functional as JF
    from cp2_tpu_torch.augment import functional as F

    c = jax.vmap(lambda k: JF.sample_resized_crop(k, src_hw, scale, ratio, flip_p))(keys)
    return F.CropParams(*(_tensor(v) for v in (c.y0, c.x0, c.h, c.w, c.flip)))


def replay_jitter(keys, brightness, contrast, saturation, hue, p, order=0):
    """The factors and gate ``color_jitter(key, ...)`` draws."""
    from cp2_tpu_torch.augment import functional as F

    k = jax_split(keys, 5)
    return F.JitterParams(
        brightness=_tensor(_uniform(k[:, 0], *brightness)),
        contrast=_tensor(_uniform(k[:, 1], *contrast)),
        saturation=_tensor(_uniform(k[:, 2], *saturation)),
        hue=_tensor(_uniform(k[:, 3], *hue)),
        apply=_tensor(_bernoulli(k[:, 4], p)),
        order=int(order),
    )


def replay_gray(keys, p):
    """The gate ``to_grayscale(key, img, p)`` draws."""
    return _tensor(_bernoulli(keys, p))


def replay_blur(keys, sigma_range, p):
    """The sigma and gate ``gaussian_blur(key, ...)`` draws."""
    from cp2_tpu_torch.augment import functional as F

    k = jax_split(keys, 2)
    return F.BlurParams(sigma=_tensor(_uniform(k[:, 0], *sigma_range)),
                        apply=_tensor(_bernoulli(k[:, 1], p)))


def replay_erase(keys, hw, scale, ratio):
    """The rectangle ``random_erase(key, img, scale, ratio)`` draws."""
    import jax
    import jax.numpy as jnp
    import torch

    from cp2_tpu_torch.augment import functional as F

    h, w = hw
    k = jax_split(keys, 4)
    area = h * w * _uniform(k[:, 0], *scale)
    aspect = jnp.exp(_uniform(k[:, 1], jnp.log(ratio[0]), jnp.log(ratio[1])))
    eh = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, h).astype(jnp.int32)
    ew = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, w).astype(jnp.int32)
    y0 = jax.vmap(lambda kk, e: jax.random.randint(kk, (), 0, jnp.maximum(h - e + 1, 1)))(
        k[:, 2], eh)
    x0 = jax.vmap(lambda kk, e: jax.random.randint(kk, (), 0, jnp.maximum(w - e + 1, 1)))(
        k[:, 3], ew)
    return F.EraseParams(*(_tensor(v, torch.int64) for v in (y0, x0, eh, ew)))


def _replay_view(k_crop, k_photo, src_hw, cfg, order):
    """A view's crop (``_one_view``) and ``_photometric``: k_j, k_g, k_b."""
    from cp2_tpu_torch.augment.pipeline import ViewParams

    photo = jax_split(k_photo, 3)
    return ViewParams(
        crop=replay_crop(k_crop, src_hw, cfg.crop_scale, cfg.crop_ratio, cfg.flip_p),
        jitter=replay_jitter(photo[:, 0], cfg.brightness, cfg.contrast, cfg.saturation,
                             cfg.hue, cfg.jitter_p, order),
        gray=replay_gray(photo[:, 1], cfg.grayscale_p),
        blur=replay_blur(photo[:, 2], cfg.blur_sigma, cfg.blur_p),
    )


def replay_jax_pretrain_params(rng, n: int, src_hw, cfg):
    """The port's ``PretrainAugParams`` holding exactly the draws that the
    JAX package's ``pretrain_batch_augment(rng, raw, cfg)`` makes on ``n``
    frames of ``src_hw``; ``cfg`` is the port's ``AugmentConfig``, whose
    fields are the JAX one's."""
    import jax

    from cp2_tpu_torch.augment.pipeline import PretrainAugParams

    def orders(key, shape):
        if not cfg.jitter_random_order:
            return [0] * max(1, int(np.prod(shape)))
        return [int(o) for o in np.ravel(jax.random.randint(key, shape, 0, 24))]

    k_fg, k_b0, k_b1 = jax.random.split(rng, 3)
    # two_crop_augment_batch: k_order, rng = split; split(rng, 2n) → (n, 2, 2)
    k_order, k = jax.random.split(k_fg)
    order_ab = orders(k_order, (2,))
    per_view = jax.random.split(k, n * 2).reshape(n, 2, 2)
    views = []
    for v in range(2):  # _one_view: k_crop, k_photo
        k = jax_split(per_view[:, v], 2)
        views.append(_replay_view(k[:, 0], k[:, 1], src_hw, cfg, order_ab[v]))
    # background_augment_batch: k_order, rng = split; split(rng, n); per
    # image k_crop, k_photo, k_erase
    bgs, erases = [], []
    for key in (k_b0, k_b1):
        k_order, k = jax.random.split(key)
        k = jax_split(jax.random.split(k, n), 3)
        bgs.append(_replay_view(k[:, 0], k[:, 1], src_hw, cfg, orders(k_order, ())[0]))
        erases.append(replay_erase(k[:, 2], cfg.out_hw, cfg.erase_scale, cfg.erase_ratio))
    return PretrainAugParams(views[0], views[1], bgs[0], bgs[1], erases[0], erases[1])


def replay_grid(keys, num_steps: int, distort_limit: float, p: float):
    """The stretches and gate ``grid_distortion(key, ...)`` draws
    (``cp2_tpu/augment/functional.py:422-437``)."""
    import jax

    from cp2_tpu_torch.augment import functional as F

    k = jax_split(keys, 3)

    def stretches(kk):
        return jax.vmap(lambda key: 1.0 + jax.random.uniform(
            key, (num_steps + 1,), minval=-distort_limit, maxval=distort_limit))(kk)

    return F.GridParams(sx=_tensor(stretches(k[:, 0])), sy=_tensor(stretches(k[:, 1])),
                        apply=_tensor(_bernoulli(k[:, 2], p)))


def replay_jax_finetune_params(rng, n: int, hw, cfg, channels: int = 3):
    """The port's ``FinetuneAugParams`` holding the draws of the JAX
    package's ``finetune_augment_batch(rng, images, masks, cfg)`` on ``n``
    images of ``hw`` (``cp2_tpu/augment/pipeline.py:195-239``); ``cfg`` is
    the port's ``FinetuneAugmentConfig``, whose fields are the JAX one's."""
    import jax

    from cp2_tpu_torch.augment import pipeline as P

    k_order, k = jax.random.split(rng)
    order = int(jax.random.randint(k_order, (), 0, 24)) if cfg.jitter_random_order else 0
    k = jax_split(jax.random.split(k, n), 6)  # k_h, k_v, k_j, k_n, k_d, k_bc
    jitter = (replay_jitter(k[:, 2], cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue,
                            cfg.jitter_p, order) if cfg.jitter_p > 0 else None)
    bc = None
    if cfg.bc_p > 0:
        kb = jax_split(k[:, 5], 3)
        bc = P.BrightContrastParams(
            alpha=_tensor(1.0 + _uniform(kb[:, 0], *cfg.bc_contrast)),
            beta=_tensor(_uniform(kb[:, 1], *cfg.bc_brightness)),
            apply=_tensor(_bernoulli(kb[:, 2], cfg.bc_p)))
    distort = (replay_grid(k[:, 4], 5, cfg.distort_limit, cfg.distort_p)
               if cfg.distort_p > 0 else None)
    kn = jax_split(k[:, 3], 3)
    normal = jax.vmap(lambda key: jax.random.normal(key, (*hw, channels)))(kn[:, 1])
    noise = P.NoiseParams(var=_tensor(_uniform(kn[:, 0], *cfg.noise_var)),
                          normal=_tensor(normal), apply=_tensor(_bernoulli(kn[:, 2], cfg.noise_p)))
    return P.FinetuneAugParams(hflip=_tensor(_bernoulli(k[:, 0], cfg.hflip_p)),
                               vflip=_tensor(_bernoulli(k[:, 1], cfg.vflip_p)),
                               jitter=jitter, bc=bc, distort=distort, noise=noise)


def replay_jax_eval_params(rng, n: int, *, hflip_p=0.5, vflip_p=0.5, distort_p=0.0,
                           distort_limit=0.3):
    """The draws of the JAX ``eval_augment_batch`` (``pipeline.py:261-279``)."""
    import jax

    from cp2_tpu_torch.augment import pipeline as P

    k = jax_split(jax.random.split(rng, n), 3)  # k_h, k_v, k_d
    return P.EvalAugParams(
        hflip=_tensor(_bernoulli(k[:, 0], hflip_p)) if hflip_p > 0 else None,
        vflip=_tensor(_bernoulli(k[:, 1], vflip_p)) if vflip_p > 0 else None,
        distort=(replay_grid(k[:, 2], 5, distort_limit, distort_p) if distort_p > 0
                 else None))


def replay_jax_cutpaste(rng, n, hw, jcfg):
    """The port's ``CutPasteParams`` holding the draws of the JAX
    ``cutpaste_batch(rng, images, mirrors, jcfg)`` on ``n`` images of
    ``hw`` (``cp2_tpu/augment/cutpaste.py:42-84,129-150,163``)."""
    import jax
    import jax.numpy as jnp
    import torch

    from cp2_tpu.augment import cutpaste as JC
    from cp2_tpu_torch.augment import cutpaste as C

    slots = jcfg.max_num_patches
    p = jnp.array(C.class_probabilities(jcfg.num_classes))

    def one(key):
        k_cls, k_n, k_patches = jax.random.split(key, 3)
        cls = jax.random.choice(k_cls, jcfg.num_classes, p=p)
        extra = jax.random.randint(k_n, (), 0, jnp.maximum(slots, 1))
        rows = []
        for i in range(slots):
            apply_i = (i == 0) | (i <= extra)
            geo = JC._sample_patch(jax.random.fold_in(k_patches, i), hw, jcfg,
                                   cls * apply_i == 2)
            rows.append((apply_i, *geo))
        cols = [jnp.stack(c) for c in zip(*rows)]
        return cls, cols

    cls, cols = jax.vmap(one)(jax.random.split(rng, n))
    active, src_cy, src_cx, hh, hw_, dst_cy, dst_cx, theta = (np.asarray(c) for c in cols)

    def t(x):
        return torch.from_numpy(np.array(x))

    return C.CutPasteParams(
        target=t(cls).long(), active=t(active), src_cy=t(src_cy), src_cx=t(src_cx),
        half_h=t(hh), half_w=t(hw_), dst_cy=t(dst_cy), dst_cx=t(dst_cx),
        cos=t(jnp.cos(theta)), sin=t(jnp.sin(theta)))


# ---------------------------------------------------------------------------
# two processes on the CPU, as torchrun starts them
# ---------------------------------------------------------------------------


def free_ports(count: int):
    """``count`` distinct ports on localhost that nothing listens on now."""
    import socket

    socks = []
    try:
        for _ in range(count):
            s = socket.socket()
            s.bind(("localhost", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn_ranks(module_file: str, entry: str, workdir, world: int = 2, timeout: float = 600,
                threads: int = 1):
    """Run ``entry(workdir)`` of the test module ``module_file`` in ``world``
    processes on the CPU with ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), each with
    ``threads`` torch threads and oneDNN off (see the module docstring of
    ``tests/test_torch_finetune_cli.py``), and wait for all of them; a rank
    that fails or outlives ``timeout`` fails the call with every rank's
    output.  The entry writes what it found under ``workdir``.  A launch
    port that another process took between its pick and rank 0's bind
    (``EADDRINUSE``) is picked again, once."""
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(tests)!r}, {str(tests.parent)!r}]\n"
            "import torch\n"
            f"torch.set_num_threads({threads}); torch.backends.mkldnn.enabled = False\n"
            f"import {Path(module_file).stem} as m\n"
            f"m.{entry}({str(workdir)!r})\n")
    for attempt in range(2):
        outs, codes = _spawn_once(code, workdir, world, timeout, threads)
        if not (attempt == 0 and any("EADDRINUSE" in out or "address already in use" in out
                                     for out in outs)):
            break
    failed = [r for r, c in enumerate(codes) if c != 0]
    if failed:
        report = "\n".join(f"--- rank {r} (exit {codes[r]}) ---\n{outs[r][-6000:]}"
                           for r in range(len(outs)))
        raise AssertionError(f"ranks {failed} failed:\n{report}")
    return outs


def _spawn_once(code, workdir, world, timeout, threads):
    """One launch of ``spawn_ranks``: every rank's output and exit code."""
    import subprocess
    import sys
    import time
    from pathlib import Path

    port = free_ports(1)[0]
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads),
                   JAX_PLATFORMS="cpu")
        logs.append(open(Path(workdir) / f"rank{rank}.log", "w+b"))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        # a failed rank leaves the others waiting in a collective: stop
        # them a few seconds after it, rather than at the deadline
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + 5)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read().decode(errors="replace"))
        f.close()
    return outs, [p.returncode for p in procs]

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


def random_flax_variables(model, seed: int = 0, residual_scale: float = 0.25):
    """``(params, batch_stats)`` of ``model`` as nested dicts of numpy,
    shapes from ``jax.eval_shape`` (no init compile), values from numpy."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, HW, HW, 3), jnp.float32), train=False))
    r = np.random.RandomState(seed)
    params = _fill(shapes["params"], r, residual_scale)
    stats = _fill(shapes["batch_stats"], r, residual_scale)
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

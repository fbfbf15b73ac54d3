"""The port's ``SSLEncoder.dense`` against the JAX package's, on the CPU.

Bridged weights, the flagship structure at narrow widths (see
``_torch_port_common``), float32, train and eval mode.  In train mode the
BatchNorm running statistics both sides write back are pinned too.  At
the 4x4 feature grid the JAX side runs its ``DilatedConv3x3`` tap
decomposition (ASPP and the dilated layer4), and the port its own tap
split of the same convolutions (``models/layers.py::tap_split_engages``),
and in eval mode the JAX side runs its ``SpaceToDepthConv`` stem against
the port's plain ``nn.Conv2d``, so these tests also pin the rewrites.

Tolerance: rtol 1e-4, with an absolute floor of 1e-4 of the largest
magnitude of the same array (``assert_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    BATCH,
    DIM,
    HW,
    TINY_MODEL,
    assert_close,
    assert_trees_close,
    jax_encoder,
    random_flax_variables,
    to_plain_dict,
    torch_encoder,
)
from cp2_tpu.ssl import SSLEncoder as JaxSSLEncoder
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.ssl import SSLEncoder

RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jax_encoder()
    params, stats = random_flax_variables(jm, seed=0)
    return jm, params, stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dense_matches_jax(models, train):
    jm, params, stats = models
    x = np.random.RandomState(1).rand(BATCH, HW, HW, 3).astype(np.float32)

    out, mutated = jax.jit(
        lambda v, x: jm.apply(v, x, train=train, mutable=["batch_stats"],
                              method="dense")
    )({"params": params, "batch_stats": stats}, x)

    tm = torch_encoder()
    load_flax_into(tm, params, stats)
    tm.train(train)
    with torch.no_grad():
        ours = tm.dense(torch.from_numpy(x))

    assert ours.shape == out.shape == (BATCH, HW // 16, HW // 16, DIM)
    assert ours.dtype == torch.float32
    assert_close(ours.numpy(), out, RTOL, "dense output")

    _, new_stats = state_dict_to_flax(tm.state_dict())
    ref_stats = to_plain_dict(mutated["batch_stats"])
    assert_trees_close(new_stats, ref_stats, RTOL)
    if not train:  # eval mode reads the running statistics and keeps them
        assert_trees_close(new_stats, to_plain_dict(stats), RTOL)


def test_bf16_policy_casts_like_jax(models):
    """conv in bfloat16, BatchNorm in float32, every block returns bfloat16:
    the output dtype and a loose value check against the JAX bf16 model."""
    _, params, stats = models
    x = np.random.RandomState(2).rand(BATCH, HW, HW, 3).astype(np.float32)
    jm = JaxSSLEncoder(model_cfg=TINY_MODEL, dim=DIM, dtype=jnp.bfloat16)
    out = jm.apply({"params": params, "batch_stats": stats}, x, train=False,
                   method="dense")
    tm = SSLEncoder(TINY_MODEL, dim=DIM, dtype=torch.bfloat16)
    load_flax_into(tm, params, stats)
    tm.eval()
    with torch.no_grad():
        ours = tm.dense(torch.from_numpy(x))
    assert ours.dtype == torch.bfloat16 and out.dtype == jnp.bfloat16
    ref = np.asarray(out.astype(jnp.float32))
    # bf16 keeps ~3 significant digits and the two frameworks round at
    # different points of a 50-layer network: a normwise 5% bound
    err = np.abs(ours.float().numpy() - ref).max()
    assert err <= 5e-2 * np.abs(ref).max(), err


@pytest.mark.parametrize("path", ["dense", "backbone_feats"])
def test_network_sees_contiguous_nchw_whatever_the_input_strides(path):
    """``dense`` and ``_last_stage`` (``backbone_feats``, MoCo's, BYOL's and
    DenseCL's path) hand the network a contiguous NCHW tensor both for a
    contiguous NHWC batch and for an NHWC view of (N, W, H, C) memory (the
    augmentation's output layout): a hook on the stem conv sees the same
    strides, and the outputs are equal.  cuDNN picks its kernels by the
    input's strides, so the step's speed must not follow the batch's."""
    torch.manual_seed(0)
    tm = torch_encoder().eval()
    x = torch.from_numpy(np.random.RandomState(3).rand(BATCH, 32, 32, 3).astype(np.float32))
    layouts = {"nhwc": x.contiguous(), "nwhc": x.transpose(1, 2).contiguous().transpose(1, 2)}
    assert not layouts["nwhc"].is_contiguous()
    seen, outs = {}, {}
    for name, img in layouts.items():
        hook = tm.encoder.backbone.conv1.register_forward_pre_hook(
            lambda _m, args, name=name: seen.__setitem__(
                name, (tuple(args[0].shape), args[0].is_contiguous(), args[0].stride())))
        with torch.no_grad():
            outs[name] = getattr(tm, path)(img)
        hook.remove()
    for name in layouts:
        shape, contiguous, strides = seen[name]
        assert shape == (BATCH, 3, 32, 32) and contiguous, (name, seen[name])
    assert seen["nhwc"][2] == seen["nwhc"][2]
    torch.testing.assert_close(outs["nhwc"], outs["nwhc"], rtol=0, atol=0)

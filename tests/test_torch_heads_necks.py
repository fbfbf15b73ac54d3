"""The port's heads, necks, U-Nets and ``SSLEncoder`` methods against the JAX
package's flax modules, on the CPU.

Each flax module gets numpy weights from a seed (``fill_variables``), the
port's twin takes them through the bridge, and both run on the same
inputs (NHWC for flax, NCHW for the port's modules) in train mode (the
BatchNorm running statistics written back are pinned too) and eval mode.
The U-Nets' ResNet-50 is narrowed to width 8 on both sides
(``narrow_unet_backbones``).  Last, the bridge carries the whole MOCO,
BYOL, DENSECL and U-Net trees flax → torch → flax unchanged.

oneDNN is off for the port: with it, this CPU build's channels-last
convolution backward corrupts the heap at the 2x2 feature maps of these
tiny networks (the forward-only cases here do not reach it; the step
tests do).

Tolerance: rtol 1e-5, with an absolute floor of 1e-5 of the array's
largest magnitude (``assert_close``).  The flax side computes BatchNorm's
batch variance in two passes, E[(x-E[x])²], as the port does, rather than
flax's default E[x²]-E[x]² (``TwoPassBatchNorm``): the one-pass form loses
digits wherever a channel's mean dwarfs its spread, which train-mode
BatchNorms over a few values at the end of a ResNet do, and parts from
the two-pass one by up to 7e-4 there (``tests/test_torch_train_step.py``
measures the same on the step).
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
    MOCO_MODEL,
    TINY_MODEL,
    assert_close,
    assert_trees_close,
    fill_variables,
    jax_variant_encoder,
    narrow_unet_backbones,
    random_flax_variables,
    to_plain_dict,
    torch_variant_encoder,
)
from cp2_tpu.models import heads as jax_heads
from cp2_tpu.models import layers as jax_layers
from cp2_tpu.models import necks as jax_necks
from cp2_tpu.models import unet as jax_unet
from cp2_tpu.models import utils as jax_utils
from cp2_tpu.types import BackboneType as JaxBackboneType
from cp2_tpu.types import PretrainType as JaxPretrainType
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import heads, layers, necks, unet, utils
from flax import linen as nn

RTOL = 1e-5


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def numerics():
    """oneDNN off and two threads for the port (these tiny models gain
    nothing from more, and the test workers share the cores), two-pass
    BatchNorm variance for flax."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _run_pair(jax_module, torch_module, jax_args, torch_args, train, seed=0):
    """Random variables for ``jax_module``, bridged into ``torch_module``;
    both applied in train or eval mode.  Returns (jax out, jax stats after,
    torch out, torch stats after)."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *jax_args,
                                                    train=train))
    params, stats = fill_variables(shapes, np.random.RandomState(seed))
    out, mutated = jax_module.apply({"params": params, "batch_stats": stats}, *jax_args,
                                    train=train, mutable=["batch_stats"])
    load_flax_into(torch_module, params, stats)
    torch_module.train(train)
    with torch.no_grad():
        ours = torch_module(*torch_args)
    _, new_stats = state_dict_to_flax(torch_module.state_dict())
    return out, to_plain_dict(mutated.get("batch_stats", {})), ours, new_stats


def _check_stats(new_stats, ref_stats):
    assert_trees_close(new_stats, ref_stats, RTOL, "batch_stats")


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_mlp_matches_flax(use_bn, train):
    x = np.random.RandomState(1).randn(4, 24).astype(np.float32)
    out, ref_stats, ours, stats = _run_pair(
        jax_layers.MLP(32, 8, use_bn=use_bn), layers.MLP(24, 32, 8, use_bn=use_bn),
        (x,), (torch.from_numpy(x),), train)
    assert_close(ours.numpy(), out, RTOL, "MLP")
    _check_stats(stats, ref_stats)


FCN_CASES = {
    # config_moco.py's identity head, then conv_seg
    "identity": (dict(in_channels=16, channels=16, num_convs=0, concat_input=False,
                      num_classes=2), False),
    "convs_concat": (dict(in_channels=16, channels=8, num_convs=2, concat_input=True,
                          num_classes=3), False),
    "contrast": (dict(in_channels=16, channels=8, num_convs=1, contrast=True,
                      contrast_dim=4), True),
}


@pytest.mark.parametrize("case", sorted(FCN_CASES))
def test_fcn_head_matches_flax(case):
    """Train mode where the head has no dropout in the way (the identity and
    contrast heads), else eval mode."""
    kw, train = FCN_CASES[case]
    kw = dict(kw, norm_cfg=dict(type="BN"))
    if case == "identity":
        train = True  # no dropout at num_convs=0
    x = np.random.RandomState(2).randn(BATCH, 5, 5, 16).astype(np.float32)
    out, ref_stats, ours, stats = _run_pair(
        jax_heads.FCNHead(**kw), heads.FCNHead(**kw), (x,), (_nchw(x),), train)
    assert_close(_nhwc(ours), out, RTOL, case)
    _check_stats(stats, ref_stats)


@pytest.mark.parametrize("num_grid", [None, 2])
def test_densecl_neck_matches_flax(num_grid):
    x = np.random.RandomState(3).randn(BATCH, 4, 4, 16).astype(np.float32)
    out, _, ours, _ = _run_pair(
        jax_necks.DenseCLNeck(16, 32, 8, num_grid=num_grid),
        necks.DenseCLNeck(16, 32, 8, num_grid=num_grid), (x,), (_nchw(x),), True)
    assert set(ours) == set(out)
    for key, ref in out.items():
        assert_close(ours[key].numpy(), ref, RTOL, key)


@pytest.mark.parametrize("use_bn", [False, True], ids=["moco", "byol"])
def test_global_projector_matches_flax(use_bn):
    """The flatten is NHWC-ordered on both sides, so the bridged kernel
    needs no permutation."""
    x = np.random.RandomState(4).randn(BATCH + 2, 3, 2, 8).astype(np.float32)
    out, ref_stats, ours, stats = _run_pair(
        jax_necks.GlobalProjector(32, 8, use_bn=use_bn),
        necks.GlobalProjector(3 * 2 * 8, 32, 8, use_bn=use_bn), (x,), (_nchw(x),), True)
    assert_close(ours.numpy(), out, RTOL, "GlobalProjector")
    _check_stats(stats, ref_stats)


@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "noskip"])
def test_up_conv_block_matches_flax(with_skip):
    r = np.random.RandomState(5)
    x = r.randn(BATCH, 3, 3, 12).astype(np.float32)
    skip = r.randn(BATCH, 6, 6, 4).astype(np.float32) if with_skip else None
    out, ref_stats, ours, stats = _run_pair(
        jax_utils.UpConvBlock(8), utils.UpConvBlock(12 + (4 if with_skip else 0), 8),
        (x, skip), (_nchw(x), None if skip is None else _nchw(skip)), True)
    assert_close(_nhwc(ours), out, RTOL, "UpConvBlock")
    _check_stats(stats, ref_stats)


@pytest.mark.parametrize("name", ["UNetEncoderOnly", "UNetTruncated"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet_matches_flax(name, train):
    x = np.random.RandomState(6).rand(BATCH, HW, HW, 3).astype(np.float32)
    with pytest.MonkeyPatch.context() as patch:
        narrow_unet_backbones(patch)
        out, ref_stats, ours, stats = _run_pair(
            getattr(jax_unet, name)(projector_dim=DIM), getattr(unet, name)(projector_dim=DIM),
            (x,), (_nchw(x),), train)
    grid = HW // (8 if name == "UNetTruncated" else 32)
    assert ours.shape == (BATCH, DIM, grid, grid)
    assert_close(_nhwc(ours), out, RTOL, name)
    _check_stats(stats, ref_stats)


# ---------------------------------------------------------------------------
# SSLEncoder methods and the bridge, per variant
# ---------------------------------------------------------------------------

VARIANTS = {
    "MOCO": (JaxPretrainType.MOCO, MOCO_MODEL, None),
    "BYOL": (JaxPretrainType.BYOL, MOCO_MODEL, None),
    "DENSECL": (JaxPretrainType.DENSECL, MOCO_MODEL, None),
    "PROPOSED_V2": (JaxPretrainType.PROPOSED_V2, TINY_MODEL, None),
    "UNET_ENCODER_ONLY": (JaxPretrainType.CP2, None, JaxBackboneType.UNET_ENCODER_ONLY),
    "UNET_TRUNCATED": (JaxPretrainType.CP2, None, JaxBackboneType.UNET_TRUNCATED),
}


def _encoders(name, seed=0):
    """(flax encoder, port encoder with the same weights, flax variables)."""
    pt, cfg, bt = VARIANTS[name]
    jm = jax_variant_encoder(pt, cfg, bt)
    params, stats = random_flax_variables(jm, seed=seed, init_all=True)
    tm = torch_variant_encoder(pt, cfg, bt)
    load_flax_into(tm, params, stats)
    return jm, tm, params, stats


def _apply_both(jm, tm, params, stats, method, x, jax_x=None):
    out, mutated = jm.apply({"params": params, "batch_stats": stats},
                            x if jax_x is None else jax_x, train=True,
                            mutable=["batch_stats"], method=method)
    tm.train()
    with torch.no_grad():
        ours = getattr(tm, method)(torch.from_numpy(x))
    _, new_stats = state_dict_to_flax(tm.state_dict())
    return out, ours, to_plain_dict(mutated["batch_stats"]), new_stats


@pytest.mark.parametrize("name,method", [
    ("MOCO", "backbone_feats"), ("MOCO", "global_embed"), ("MOCO", "predict"),
    ("BYOL", "global_embed"), ("BYOL", "predict"),
    ("DENSECL", "densecl_embed"), ("PROPOSED_V2", "densecl_embed"),
    ("UNET_ENCODER_ONLY", "dense"), ("UNET_TRUNCATED", "dense"),
])
def test_ssl_encoder_methods_match_flax(name, method):
    """Each method takes what its flax twin takes (NHWC images, or (N, dim)
    embeddings for ``predict``) and returns the same, NHWC where flax's
    is."""
    with pytest.MonkeyPatch.context() as patch:
        narrow_unet_backbones(patch)
        jm, tm, params, stats = _encoders(name)
        r = np.random.RandomState(7)
        # batch 4: BYOL's MLP BatchNorm over 2 samples maps each channel to
        # ±d/sqrt(d²+eps) with d half the two values' difference, which
        # float32 resolves only to a few digits where they nearly agree
        x = (r.randn(4, DIM).astype(np.float32) if method == "predict"
             else r.rand(4, HW, HW, 3).astype(np.float32))
        out, ours, ref_stats, new_stats = _apply_both(jm, tm, params, stats, method, x)
    if method == "densecl_embed":
        (proj, embd), (our_proj, our_embd) = out, ours
        assert set(our_proj) == set(proj)
        for key, ref in proj.items():
            assert_close(our_proj[key].numpy(), ref, RTOL, key)
        assert_close(our_embd.numpy(), embd, RTOL, "embd")
    else:
        assert tuple(ours.shape) == tuple(out.shape)
        assert_close(ours.numpy(), out, RTOL, method)
    assert_trees_close(new_stats, ref_stats, RTOL, "batch_stats")


def test_projector_width_follows_the_image_size():
    """flax sizes ``fc1`` at its first call; the port from ``img_hw``: at
    224² a ResNet-50's last stage flattens to 7·7·2048 = 100352."""
    from cp2_tpu_torch.config import Config
    import cp2_tpu_torch
    import os

    cfg = Config.fromfile(os.path.join(os.path.dirname(cp2_tpu_torch.__file__),
                                       "configs", "config_moco.py")).model
    backbone = __import__("cp2_tpu_torch.models.resnet", fromlist=["ResNet"]).ResNet(
        **{k: v for k, v in cfg["backbone"].items() if k != "type"})
    assert backbone.feature_hw((224, 224)) == (7, 7)
    assert backbone.feature_hw((225, 200)) == (8, 7)
    assert backbone.stage_channels[-1] == 2048
    for pt, hw in ((JaxPretrainType.MOCO, HW), (JaxPretrainType.BYOL, 48)):
        tm = torch_variant_encoder(pt, MOCO_MODEL, hw=hw)
        jm = jax_variant_encoder(pt, MOCO_MODEL)
        params, _ = random_flax_variables(jm, hw=hw, init_all=True)
        assert tuple(tm.projector.mlp.fc1.weight.shape[::-1]) == \
            params["projector"]["mlp"]["fc1"]["kernel"].shape


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_bridge_round_trip(name):
    """flax → torch → flax is the identity on every variant's tree, the
    unused leaves (MoCo's predictor, conv_seg) and BYOL's MLP BatchNorm
    ``batch_stats`` included; ``load_state_dict(strict=True)`` proves that
    every leaf lands on exactly one tensor."""
    with pytest.MonkeyPatch.context() as patch:
        narrow_unet_backbones(patch)
        _, tm, params, stats = _encoders(name, seed=3)
    back_params, back_stats = state_dict_to_flax(tm.state_dict())
    assert_trees_close(back_params, params, 0.0, "params")
    assert_trees_close(back_stats, stats, 0.0, "batch_stats")
    if name == "BYOL":
        assert "bn" in stats["projector"]["mlp"] and "bn" in stats["predictor"]
    if name == "MOCO":
        assert "predictor" in params and "conv_seg" in params["encoder"]["decode_head"]

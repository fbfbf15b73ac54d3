"""The rest of the port's model zoo and utilities against the JAX package's,
on the CPU: ``models/utils.py``, ``with_cp``, ``frozen_param_labels``, a
segmentor with a neck, ``utils/profiling.py`` and ``show_result``.

Weights come from numpy (``fill_variables``) and cross through the bridge.
Tolerances: forwards at rtol 1e-5 with an absolute floor of 1e-5 of the
largest output (float32, the two sides sum in other orders); the ``with_cp``
step against the plain step of the port exactly (the recompute runs the
same kernels on the same values), and against JAX's ``with_cp`` step at
the finetune step's tolerances (loss and statistics 1e-5, gradients 5e-5:
``tests/test_torch_segmentation_task.py`` gives the reason).  ``DropPath``
is held on JAX's own mask, read back from its output (torch cannot replay
JAX's keys), and its draw by its law.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_port_common import (
    assert_close,
    assert_trees_close,
    fill_variables,
    to_plain_dict,
)
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.models import utils as jutils
from cp2_tpu.models.resnet import ResNet as JaxResNet
from cp2_tpu.models.resnet import frozen_param_labels as jax_frozen_param_labels
from cp2_tpu.ops.metrics import ConfusionState as JaxConfusion
from cp2_tpu.train import segmentation_task as jtask
from cp2_tpu.utils import profiling as jprofiling
from cp2_tpu.utils.visualize import show_result as jax_show_result
from cp2_tpu_torch.checkpoint.bridge import (
    flax_to_state_dict,
    load_flax_into,
    state_dict_to_flax,
)
from cp2_tpu_torch.models import ResNet, build_segmentor, frozen_param_labels, utils
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.train import segmentation_task as task
from cp2_tpu_torch.utils import profiling
from cp2_tpu_torch.utils.visualize import show_result

RTOL = 1e-5
GRAD_TOL = 5e-5
HW = 32


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def numerics():
    """oneDNN off and two threads for the port, two-pass BatchNorm variance
    for flax (see ``tests/test_torch_heads_necks.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        yield
    torch.set_num_threads(threads)


def _init(module, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))
    return fill_variables(shapes, np.random.RandomState(seed))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_make_divisible_matches_jax():
    for value in (3, 8, 12.5, 17, 30, 64, 100.4, 1000):
        for divisor in (4, 8, 16):
            assert utils.make_divisible(value, divisor) == jutils.make_divisible(value, divisor)


def test_trunc_normal_init_law_matches_jax():
    """Cut at ±2σ, not rescaled: the same law as flax's initializer (its
    std 0.88σ); 200k draws on each side agree to 1 %."""
    ref = np.asarray(jutils.trunc_normal_init(0.02)(jax.random.PRNGKey(0), (200_000,)))
    ours = utils.trunc_normal_init(0.02)(torch.empty(200_000), torch.Generator().manual_seed(0))
    ours = ours.numpy()
    assert np.abs(ours).max() <= 0.04 and np.abs(ref).max() <= 0.04
    np.testing.assert_allclose(ours.std(), ref.std(), rtol=1e-2)
    assert abs(ours.mean()) < 1e-3


def test_drop_path_on_jax_mask_and_law():
    x = np.abs(_x((64, 4, 4, 3))) + 0.1  # nonzero, so a dropped sample reads as 0
    rate = 0.3
    ref = np.asarray(jutils.DropPath(rate).apply({}, jnp.asarray(x), train=True,
                                                  rngs={"dropout": jax.random.PRNGKey(3)}))
    keep = (ref != 0).reshape(64, -1)
    assert (keep.all(1) | ~keep.any(1)).all()  # one draw per sample
    module = utils.DropPath(rate).train()
    mask = torch.from_numpy(keep.all(1)).reshape(64, 1, 1, 1)
    np.testing.assert_array_equal(module.apply_mask(_nchw(x), mask).permute(0, 2, 3, 1).numpy(),
                                  ref)
    draws = module.keep_mask(torch.zeros(20_000, 1, 1, 1), torch.Generator().manual_seed(0))
    assert abs(draws.float().mean().item() - 0.7) < 4 * (0.21 / 20_000) ** 0.5
    assert torch.equal(module.eval()(_nchw(x)), _nchw(x))


def test_se_layer_matches_jax():
    x = _x((2, 6, 5, 32))
    jm = jutils.SELayer(ratio=4)
    params, _ = _init(jm, jnp.asarray(x))
    port = utils.SELayer(32, ratio=4)
    load_flax_into(port, params)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(port(_nchw(x)).permute(0, 2, 3, 1).numpy(), np.asarray(ref), RTOL)


@pytest.mark.parametrize("stride,expand,out", [(1, 2, 16), (2, 3, 24), (1, 1, 16)])
def test_inverted_residual_matches_jax(stride, expand, out):
    """Train mode: the output and the BatchNorm statistics."""
    x = _x((4, 8, 8, 16))
    jm = jutils.InvertedResidual(out, stride=stride, expand_ratio=expand)
    params, stats = _init(jm, jnp.asarray(x), train=False)
    ref, mutated = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
    port = utils.InvertedResidual(16, out, stride, expand).train()
    load_flax_into(port, params, stats)
    with torch.no_grad():
        ours = port(_nchw(x))
    assert_close(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), RTOL)
    _, new_stats = state_dict_to_flax(port.state_dict())
    assert_trees_close(new_stats, to_plain_dict(mutated["batch_stats"]), RTOL)


def test_self_attention_block_matches_jax():
    q, k = _x((2, 4, 4, 16)), _x((2, 6, 6, 10), seed=2)
    jm = jutils.SelfAttentionBlock(channels=8, out_channels=12)
    params, _ = _init(jm, jnp.asarray(q), jnp.asarray(k))
    port = utils.SelfAttentionBlock(16, 10, 8, 12)
    load_flax_into(port, params)
    ref = jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(k))
    with torch.no_grad():
        ours = port(_nchw(q), _nchw(k))
    assert_close(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), RTOL)


def test_encoding_matches_jax_and_bridges():
    x = _x((2, 5, 5, 8))
    jm = jutils.Encoding(channels=8, num_codes=4)
    params, _ = _init(jm, jnp.asarray(x))
    params["scale"] = -np.abs(params["scale"])  # smoothing factors are negative
    port = utils.Encoding(8, 4)
    load_flax_into(port, params)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(port(_nchw(x)).numpy(), np.asarray(ref), RTOL)
    back, _ = state_dict_to_flax(port.state_dict())
    assert set(back) == {"codewords", "scale"}
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)


# --------------------------------------------------------------------------
# with_cp and frozen_param_labels
# --------------------------------------------------------------------------

CP_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1),
                  norm_cfg=dict(type="BN"), contract_dilation=True, with_cp=True),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                     dilations=(1, 6), dropout_ratio=0.0, num_classes=2,
                     norm_cfg=dict(type="BN")),
)


def _plain(cfg):
    return dict(cfg, backbone=dict(cfg["backbone"], with_cp=False))


def _seg_batch(n=4, seed=0):
    r = np.random.RandomState(seed)
    img = r.rand(n, HW, HW, 3) * r.uniform(0.2, 1.0, (n, 1, 1, 3)) + r.uniform(0, 0.5, (n, 1, 1, 3))
    mask = r.randint(0, 2, (n, HW // 8, HW // 8)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    return {"image": np.clip(img, 0, 1).astype(np.float32), "mask": mask}


def _port_step(cfg, params, stats, batch):
    port = build_segmentor(cfg)
    load_flax_into(port, params, stats)
    state = task.create_seg_state(port, task.make_sgd(0.01, 0.9, 0.0), "cpu")
    train_step, _, _ = task.make_seg_steps(2, (HW, HW))
    state, _, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                             torch.Generator().manual_seed(0), ConfusionState.create(2))
    grads, _ = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})
    params_after, stats_after = state_dict_to_flax(state.model.state_dict())
    return m["loss"], grads, params_after, stats_after


def test_with_cp_step_equals_plain_step_and_jax():
    """One SGD step with every residual block recomputed in the backward:
    the loss, gradients, parameters and BatchNorm running statistics equal
    the plain step's (the statistics moved once, not twice), and JAX's
    ``nn.remat`` step's."""
    jmodel = jax_build_segmentor(CP_MODEL)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, HW, HW, 3)), train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    batch = _seg_batch()
    loss_cp, grads_cp, params_cp, stats_cp = _port_step(CP_MODEL, params, stats, batch)
    loss, grads, params_plain, stats_plain = _port_step(_plain(CP_MODEL), params, stats, batch)
    assert torch.equal(loss_cp, loss)
    for a, b in ((grads_cp, grads), (params_cp, params_plain), (stats_cp, stats_plain)):
        assert_trees_close(a, b, 0.0)
    moved = np.abs(stats_cp["backbone"]["conv1"]["norm"]["mean"]
                   - stats["backbone"]["conv1"]["norm"]["mean"])
    assert moved.max() > 0

    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step, _, _ = jtask.make_seg_steps(jmodel, capture, 2, (HW, HW))
    jstate = jtask.SegTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=stats, opt_state=capture.init(params))
    new, _, m = jax.jit(step)(jstate, batch, jax.random.PRNGKey(0), JaxConfusion.create(2))
    assert_close(loss_cp.numpy(), np.asarray(m["loss"]), RTOL, "loss")
    assert_trees_close(grads_cp, to_plain_dict(new.opt_state), GRAD_TOL, "grads")
    assert_trees_close(stats_cp, to_plain_dict(new.batch_stats), RTOL, "stats")


@pytest.mark.parametrize("frozen_stages", [-1, 0, 1, 3])
@pytest.mark.parametrize("deep_stem", [False, True])
def test_frozen_param_labels_match_jax(frozen_stages, deep_stem):
    kw = dict(depth=18, stem_channels=8, base_channels=8, deep_stem=deep_stem,
              norm_cfg=dict(type="BN"))
    params, _ = _init(JaxResNet(**kw), jnp.zeros((1, HW, HW, 3)), train=False)
    ref = jax_frozen_param_labels(params, frozen_stages)
    port = ResNet(**kw)
    ours = frozen_param_labels(port, frozen_stages)
    tensors = dict(port.named_parameters())
    ref_by_name = {}
    for path, label in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = tuple(p.key for p in path)
        ref_by_name[keys] = label
    expected = {}
    for name in ours:
        # the bridge's name for the same leaf
        sd = {name: tensors[name]}
        flax_path, _ = state_dict_to_flax(sd)
        leaf = flax_path
        keys = []
        while isinstance(leaf, dict):
            (k, leaf), = leaf.items()
            keys.append(k)
        expected[name] = ref_by_name[tuple(keys)]
    assert ours == expected
    assert len(ours) == len(ref_by_name)
    if frozen_stages >= 1:
        assert ours["layer1_0.conv1.conv.weight"] == "frozen"
        assert ours["layer4_0.conv1.conv.weight"] == "trainable"


def test_segmentor_with_neck_matches_jax_extract_feat():
    cfg = dict(
        type="EncoderDecoder",
        backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                      norm_cfg=dict(type="BN")),
        neck=dict(type="DenseCLNeck", in_channels=64, hid_channels=16, out_channels=8,
                  num_grid=None),
        decode_head=dict(type="FCNHead", in_channels=64, channels=8, num_convs=1,
                         num_classes=2, norm_cfg=dict(type="BN")),
    )
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    jmodel = jax_build_segmentor(cfg)

    def feats(m, img):
        return m.extract_feat(img, train=False)

    params, stats = _init(jmodel, jnp.asarray(x), method=feats)
    assert "neck_mod" in params
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), method=feats)
    port = build_segmentor(cfg).eval()
    sd = port.state_dict()
    carried = flax_to_state_dict(params, stats)
    assert any(k.startswith("neck_mod.") for k in carried)
    sd.update(carried)
    port.load_state_dict(sd)
    with torch.no_grad():
        ours = port.extract_feat(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(ours) == set(ref)
    for k in ref:
        assert_close(ours[k].numpy(), np.asarray(ref[k]), RTOL, k)


# --------------------------------------------------------------------------
# profiling and show_result
# --------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / profiling.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert profiling.device_memory_summary() == ({} if not torch.cuda.is_available()
                                                 else profiling.device_memory_summary())


def test_find_nonfinite_matches_jax():
    tree = {"a": {"w": np.array([1.0, np.nan], np.float32), "ok": np.ones(3, np.float32)},
            "b": np.array([np.inf], np.float32), "step": np.array([7], np.int32),
            "c": {"d": np.zeros((2, 2), np.float32)}}
    ref = jprofiling.find_nonfinite(tree)
    ours = profiling.find_nonfinite(tree)
    assert sorted(ours) == sorted(ref) == ["a/w", "b"]
    as_torch = {"a": {"w": torch.tensor([1.0, float("nan")])}, "n": [torch.tensor([1, 2]),
                                                                    torch.tensor([float("-inf")])]}
    assert profiling.find_nonfinite(as_torch, prefix="s/") == ["s/a/w", "s/n/1"]
    with pytest.raises(FloatingPointError):
        profiling.assert_finite(tree)
    profiling.assert_finite({"x": torch.zeros(3), "i": torch.tensor([2**31 - 1])})


@pytest.mark.parametrize("case", ["uint8", "float-palette", "path"])
def test_show_result_matches_jax(tmp_path, case):
    from PIL import Image

    r = np.random.RandomState(0)
    img = (r.rand(20, 24, 3) * 255).astype(np.uint8)
    seg = r.randint(0, 5, (20, 24))
    kw = {}
    if case == "float-palette":
        img = img.astype(np.float32) / 255.0
        kw = dict(palette=[[10, 20, 30], [200, 0, 0], [0, 200, 0], [0, 0, 200], [9, 9, 9]],
                  opacity=0.3)
    if case == "path":
        Image.fromarray(img).save(tmp_path / "in.png")
        img = str(tmp_path / "in.png")
    ours = show_result(img, seg, out_file=str(tmp_path / "ours.png"), **kw)
    ref = jax_show_result(img, seg, **kw)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours.png")), ours)

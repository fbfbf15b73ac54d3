"""The finetune segmentor in bfloat16, the port against the JAX package, on
the CPU: the precision every finetune CLI run uses (``--bf16`` is on by
default in both packages).

``SEG_MODEL`` (``config_finetune.py``'s structure at narrow widths, with
the FCN auxiliary head) is built in bfloat16 on both sides from the same
numpy weights through the bridge, and takes the same batch
(``test_torch_segmentation_task._batch``).  flax's BatchNorm takes its
variance in two passes, as in the other port tests
(``tests/test_torch_bn_variance.py`` measures what one pass changes).

* **Where each side rounds.**  Every block, ConvModule and head returns
  bfloat16 on both sides, and the logits are float32 from the cast before
  ``ops/resize.py`` on.  One dtype differs by design: flax's BatchNorm
  returns float32 and each of its callers casts that to bfloat16 at once
  (after a ReLU, which commutes with rounding), where the port's returns
  the bfloat16 directly.
* **Each block on the JAX block's input** (train and eval mode): at least
  97 % of every block's output elements, and 99.5 % of all, are equal bit
  for bit.  A block that adds its residual in float32 and rounds after
  the add keeps only 90-96 % of layer1's outputs equal, so the bound sees
  one rounding moved.  Two things are set aside here: the JAX side's
  ``DilatedConv3x3`` (a TPU rewrite that sums the taps of a dilated conv
  and so rounds each tap's partial sum in bfloat16, which the port's
  single convolution does not) runs as the plain convolution it rewrites;
  and ties of float32 sums taken in another order, which flip an element
  by one bfloat16 step.
* **The whole forward and one train step** (train and eval mode, the
  auxiliary head; the loss, every gradient as one vector, the new
  BatchNorm statistics as one vector).  The tolerance comes from a
  float64 run of the port, the exact values ``e``: the port's bfloat16
  ``p`` and JAX's ``j`` satisfy ‖p − j‖ ≤ ‖j − e‖ (the two bfloat16 runs
  agree better with each other than JAX's agrees with the exact one,
  which independent rounding at other points could not give), and
  ⅔ ≤ ‖p − e‖ / ‖j − e‖ ≤ 3/2 (each is as far from exact as the other).
  JAX runs jitted with ``xla_allow_excess_precision`` off, so that it
  rounds where its program says: by default XLA's fusions skip some of
  the program's roundings, and the jitted bfloat16 JAX step then lies
  closer to exact than the program itself (on this batch its gradient
  3.38 from exact, against 4.68 with the option off and the port's 4.50).
  Measured here: ‖p − j‖ / ‖j − e‖ is 0.06 for the loss, 0.61 for the
  gradients, 0.52 for the statistics, 0.69 and 0.58 for the train- and
  eval-mode logits (0.71 and 0.37 for the auxiliary head's); ‖p − e‖ /
  ‖j − e‖ lies in 0.94–1.08.  The suggested ½ · ‖j_bf16 − j_f32‖ cannot hold at this
  size: sixteen train-mode BatchNorms over few values each turn single
  one-step ties into differences of that order (in eval mode 65-87 % of
  layer4's outputs stay equal).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from _torch_port_common import HW, SEG_MODEL, fill_variables, to_plain_dict
from test_torch_segmentation_task import (
    _batch,
    _capture_grads,
    _jax_state,
    _torch_batch,
)
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.models import layers as jax_layers
from cp2_tpu.ops.metrics import ConfusionState as JaxConfusion
from cp2_tpu.train import segmentation_task as jtask
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import build_segmentor
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.train import segmentation_task as task

HWS = (HW, HW)
EXACT = {"xla_allow_excess_precision": False}


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


class PlainDilatedConv3x3(nn.Module):
    """``DilatedConv3x3`` as the one convolution it rewrites (same param)."""

    features: int
    dilation: int
    use_bias: bool = False
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        kernel = self.param("kernel", nn.initializers.lecun_normal(),
                            (3, 3, x.shape[-1], self.features), jnp.float32)
        d = self.dilation
        return jax.lax.conv_general_dilated(
            x.astype(self.dtype), kernel.astype(self.dtype), (1, 1), ((d, d), (d, d)),
            rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.fixture(autouse=True, scope="module")
def numerics():
    """oneDNN off and two threads for the port, two-pass BatchNorm variance
    for flax (as ``tests/test_torch_segmentation_task.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    model = jax_build_segmentor(SEG_MODEL)
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False,
                                               with_aux=True))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    return params, stats, _batch()


def _jax_model():
    return jax_build_segmentor(dict(SEG_MODEL, dtype=jnp.bfloat16))


def _port(params, stats, dtype):
    model = build_segmentor(dict(SEG_MODEL, dtype=dtype))
    load_flax_into(model, params, stats)
    return model.double() if dtype == torch.float64 else model


@contextlib.contextmanager
def _float64_casts(dtype):
    """For the float64 run: the port's casts to float32 (``Tensor.float``,
    before the resize) made casts to float64."""
    if dtype != torch.float64:
        yield
        return
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self: self.double())
        yield


def _jit_exact(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _distances(port, ref, exact):
    """(‖p − j‖, ‖j − e‖, ‖p − e‖) of float64 vectors."""
    p, j, e = (np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in v])
               for v in (port, ref, exact))
    return np.linalg.norm(p - j), np.linalg.norm(j - e), np.linalg.norm(p - e)


def _assert_rounds_as_jax(port, ref, exact, what):
    apart, jax_err, port_err = _distances(port, ref, exact)
    assert apart <= jax_err, (what, apart, jax_err)
    assert 2 / 3 <= port_err / jax_err <= 3 / 2, (what, port_err, jax_err)


def _port_forward(params, stats, image, train, dtype):
    model = _port(params, stats, dtype).train(train)
    x = torch.from_numpy(image)
    with torch.no_grad(), _float64_casts(dtype):
        logits, aux, _ = task.seg_forward(model, x.double() if dtype == torch.float64 else x,
                                          HWS, with_aux=True)
    return logits.numpy(), aux.numpy()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_jax_in_bf16(weights, train):
    params, stats, batch = weights
    model = _jax_model()
    logits, aux, _, _ = _jit_exact(
        lambda v, x: jtask.seg_forward(model, v, x, HWS, train=train, mutable=True,
                                       with_aux=True),
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]))
    ours = _port_forward(params, stats, batch["image"], train, torch.bfloat16)
    exact = _port_forward(params, stats, batch["image"], train, torch.float64)
    for k, what in enumerate(("logits", "aux logits")):
        _assert_rounds_as_jax([ours[k]], [np.asarray((logits, aux)[k])], [exact[k]], what)


def _flax_outputs(params, stats, image, train):
    """Every flax module's output (eager, bfloat16), by '/'-joined path."""
    _, state = _jax_model().apply({"params": params, "batch_stats": stats}, jnp.asarray(image),
                                  train=train, with_aux=True, capture_intermediates=True,
                                  mutable=["intermediates", "batch_stats"])
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if key == "__call__":
                out["/".join(path)] = value[0]
            elif hasattr(value, "items"):
                walk(value, path + (key,))

    walk(state["intermediates"], ())
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cast_placement_matches_flax(weights, train, monkeypatch):
    """The dtype of every block's, ConvModule's and head's output, and of
    the logits before and after the resize, is flax's; the BatchNorms, and
    only they, return bfloat16 where flax's return float32."""
    params, stats, batch = weights
    resized = {"jax": [], "port": []}
    for side, module in (("jax", jtask), ("port", task)):
        def spy(x, size, side=side, resize=module.resize_bilinear):
            y = resize(x, size)
            resized[side].append((str(x.dtype), str(y.dtype)))
            return y
        monkeypatch.setattr(module, "resize_bilinear", spy)
    ref = _flax_outputs(params, stats, batch["image"], train)
    jtask.seg_forward(_jax_model(), {"params": params, "batch_stats": stats},
                      jnp.asarray(batch["image"]), HWS, train=train, mutable=True, with_aux=True)
    model = _port(params, stats, torch.bfloat16).train(train)
    seen = {}
    for name, module in model.named_modules():
        module.register_forward_hook(
            lambda _m, _a, out, key=name.replace(".", "/"): seen.__setitem__(key, out.dtype)
            if isinstance(out, torch.Tensor) else None)
    with torch.no_grad():
        task.seg_forward(model, torch.from_numpy(batch["image"]), HWS, with_aux=True)
    common = sorted(set(seen) & set(ref))
    blocks = [f"backbone/layer{i + 1}_{b}" for i, n in enumerate((3, 4, 6, 3)) for b in range(n)]
    assert set(blocks + ["backbone/conv1", "decode_head", "decode_head/bottleneck",
                         "decode_head/image_pool", "auxiliary_head",
                         "auxiliary_head/convs_0"]) <= set(common)
    norms = [k for k in common if k.rsplit("/", 1)[-1].startswith("norm")]
    assert len(norms) == 60  # 53 in the ResNet-50, 6 in the ASPP head, 1 in the FCN
    for key in common:
        want = str(ref[key].dtype)
        got = str(seen[key]).replace("torch.", "")
        if key in norms:
            assert (got, want) == ("bfloat16", "float32"), key
        else:
            assert got == want == "bfloat16", key
    # the aux logits, then the logits: cast to float32 before the resize
    for side in ("jax", "port"):
        assert [(x.replace("torch.", ""), y.replace("torch.", ""))
                for x, y in resized[side]] == [("float32", "float32")] * 2, side


def _nchw(a):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2).copy()
                            ).bfloat16()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_each_block_rounds_where_flax_rounds(weights, train, monkeypatch):
    """Each backbone block and each head of the port, given the JAX block's
    (or stages') bfloat16 input, returns JAX's output bit for bit but for
    float32 ties (see the module docstring)."""
    params, stats, batch = weights
    monkeypatch.setattr(jax_layers, "DilatedConv3x3", PlainDilatedConv3x3)
    ref = _flax_outputs(params, stats, batch["image"], train)
    backbone = _port(params, stats, torch.bfloat16).train(train)
    equal = {}
    with torch.no_grad():
        x = F.max_pool2d(_nchw(ref["backbone/conv1"]), 3, 2, padding=1)
        feats = []
        for names in backbone.backbone.stages:
            for name in names:
                want = _nchw(ref[f"backbone/{name}"])
                equal[name] = getattr(backbone.backbone, name)(x) == want
                x = want
            feats.append(x)
        for head in ("decode_head", "auxiliary_head"):
            equal[head] = getattr(backbone, head)(tuple(feats)) == _nchw(ref[head])
    share = {k: float(v.float().mean()) for k, v in equal.items()}
    assert min(share.values()) >= 0.97, share
    total = sum(int(v.sum()) for v in equal.values()) / sum(v.numel() for v in equal.values())
    assert total >= 0.995, (total, share)
    assert share["decode_head"] == share["auxiliary_head"] == 1.0  # conv_seg's bias too


def _port_step(params, stats, batch, dtype):
    model = _port(params, stats, dtype)
    tb = _torch_batch(batch)
    if dtype == torch.float64:
        tb["image"] = tb["image"].double()
    state = task.create_seg_state(model, task.make_adam(1e-4, 1e-4), "cpu")
    train_step, _, _ = task.make_seg_steps(2, HWS)
    with _float64_casts(dtype):
        state, _, m = train_step(state, tb, torch.Generator().manual_seed(0),
                                 ConfusionState.create(2))
    grads, _ = state_dict_to_flax({n: p.grad.double() for n, p in model.named_parameters()})
    _, new_stats = state_dict_to_flax({k: v.double() for k, v in model.state_dict().items()})
    return float(m["loss"]), grads, new_stats


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _vector(tree, paths):
    out = []
    for path in paths:
        leaf = tree
        for k in path:
            leaf = leaf[k]
        out.append(np.asarray(leaf, np.float64))
    return out


def test_train_step_matches_jax_in_bf16(weights):
    params, stats, batch = weights
    model, tx = _jax_model(), _capture_grads()
    step, _, _ = jtask.make_seg_steps(model, tx, 2, HWS)
    new, _, m = _jit_exact(step, _jax_state(params, stats, tx), batch, jax.random.PRNGKey(0),
                           JaxConfusion.create(2))
    ref = (float(m["loss"]), to_plain_dict(new.opt_state), to_plain_dict(new.batch_stats))
    ours = _port_step(params, stats, batch, torch.bfloat16)
    exact = _port_step(params, stats, batch, torch.float64)
    _assert_rounds_as_jax([ours[0]], [ref[0]], [exact[0]], "loss")
    for k, what in ((1, "gradients"), (2, "BatchNorm statistics")):
        paths = [p for p, _ in _leaves(ref[k])]
        assert paths == [p for p, _ in _leaves(ours[k])], what
        _assert_rounds_as_jax(_vector(ours[k], paths), _vector(ref[k], paths),
                              _vector(exact[k], paths), what)

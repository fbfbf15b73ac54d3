"""The port's finetune segmentor, train and eval steps and checkpoint
conversion matrix against the JAX package's, on the CPU.

The segmentor is ``config_finetune.py``'s structure at narrow widths
(``SEG_MODEL``: dilated ResNet-50 at width 8, ASPP-16 classifier, an FCN
auxiliary head on stage 3) on 64x64 inputs; both sides start from numpy
weights through the bridge and take the same batch.  flax's BatchNorm
computes its variance in two passes, as in the other port tests.

* The forward, train and eval mode, with the auxiliary head: logits at
  rtol 1e-5 (absolute floor of 1e-5 of the largest logit), predictions
  and BatchNorm statistics.
* One train step against ``make_seg_steps``: the loss at 1e-5, and each
  parameter's gradient to 5e-5 of that parameter's largest gradient.  The
  JAX step's gradients are read from an optax transform that keeps them as
  its state, so they are the step's own.  Why 5e-5 and not 1e-5: through
  sixteen train-mode BatchNorms over a few values each, float32 cannot
  resolve this network's gradient to 1e-5.  A float64 run of the port on
  this batch puts the port's float32 gradient 7.3e-5 from the exact one,
  and JAX's 6.7e-5 (each at its worst layer).  The two float32 gradients
  part by 2.3e-5 (layer1's BatchNorm scales); on other seeds and batch
  sizes one side or the other parts from float64 by up to 1e-1 in one
  layer.  The batch's images differ in brightness, which keeps the
  image-pool branch's BatchNorm over 4 pooled values conditioned.
* The optimizer: optax ``chain(add_decayed_weights, adam)`` against
  ``torch.optim.Adam(weight_decay)`` on identical gradients, 3 steps, 1e-6.
* Three Adam steps (lr 1e-4): Adam's update is close to ±lr for every
  element whose gradient exceeds its eps, whatever its size, so an element
  whose float32 gradient is within rounding of zero may step the other way
  on the other side.  The test therefore holds every parameter within
  2·lr·steps of JAX's (the most two sign flips can part them), and all but
  1 in 10⁴ elements within 1e-5 of their array's largest magnitude.
* ``--linear_evaluation``: the frozen backbone takes a zero gradient, and
  Adam still moves it by its decay term, as JAX's does.
* The eval step with a padded row: confusion counts exactly.
* The dropout law of the heads.
* The conversion matrix on bridged trees: the same report as JAX's for
  CP2, MOCO (on ``config_finetune_moco``'s structure), backbone only,
  MIRROR and torchvision layouts, the same loaded values, and a tag
  mismatch raises.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_port_common import (
    HW,
    MOCO_MODEL,
    SEG_MODEL,
    SEG_MOCO_MODEL,
    assert_close,
    assert_trees_close,
    fill_variables,
    jax_encoder,
    jax_variant_encoder,
    random_flax_variables,
    to_plain_dict,
    torchvision_name,
)
from cp2_tpu.checkpoint import convert as jconvert
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.ops.metrics import ConfusionState as JaxConfusion
from cp2_tpu.train import segmentation_task as jtask
from cp2_tpu.types import PretrainType as JaxPretrainType
from cp2_tpu_torch.checkpoint import convert
from cp2_tpu_torch.checkpoint.bridge import (
    flax_to_state_dict,
    load_flax_into,
    state_dict_to_flax,
)
from cp2_tpu_torch.models import build_segmentor
from cp2_tpu_torch.models.heads import dropout
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.train import segmentation_task as task
from cp2_tpu_torch.types import PretrainType

RTOL = 1e-5
GRAD_TOL = 5e-5  # see the module docstring
LR, WD = 1e-4, 1e-4
HWS = (HW, HW)


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


def _variables(model_cfg, seed=0):
    model = jax_build_segmentor(model_cfg)
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False,
                                               with_aux=True))
    return model, *fill_variables(shapes, np.random.RandomState(seed))


def _port(model_cfg, params, stats):
    model = build_segmentor(model_cfg)
    load_flax_into(model, params, stats)
    return model


def _batch(seed=0, n=4, classes=2):
    """Images whose brightness and contrast differ per image: the ASPP
    image-pool branch normalises its (N, C, 1, 1) means over the batch
    alone, and images of one global mean (plain noise) make that
    BatchNorm divide rounding noise by a spread near zero."""
    r = np.random.RandomState(seed)
    image = (r.rand(n, HW, HW, 3) * r.uniform(0.2, 1.0, (n, 1, 1, 3))
             + r.uniform(0.0, 0.5, (n, 1, 1, 3)))
    image = np.clip(image, 0.0, 1.0).astype(np.float32)
    # blocky masks, so every class has area at the logits' resolution
    mask = r.randint(0, classes, (n, HW // 8, HW // 8)).repeat(8, 1).repeat(8, 2)
    return {"image": image, "mask": mask.astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def seg():
    """The JAX segmentor, its numpy weights, and the batch."""
    model, params, stats = _variables(SEG_MODEL)
    return model, params, stats, _batch()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_segmentor_forward_matches_flax(seg, train):
    model, params, stats, batch = seg
    ref_logits, ref_aux, ref_preds, mutated = jax.jit(lambda v, x: jtask.seg_forward(
        model, v, x, HWS, train=train, mutable=True, with_aux=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]))
    port = _port(SEG_MODEL, params, stats).train(train)
    with torch.no_grad():
        logits, aux, preds = task.seg_forward(port, torch.from_numpy(batch["image"]), HWS,
                                              with_aux=True)
    assert logits.shape == (4, HW, HW, 2) and logits.dtype == torch.float32
    assert_close(logits.numpy(), np.asarray(ref_logits), RTOL, "logits")
    assert_close(aux.numpy(), np.asarray(ref_aux), RTOL, "aux logits")
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
    if train:
        _, new_stats = state_dict_to_flax(port.state_dict())
        assert_trees_close(new_stats, to_plain_dict(mutated["batch_stats"]), RTOL, "stats")


def _capture_grads():
    """An optax transform whose update is zero and whose state is the
    gradient it was given: the step's own gradients, read from its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_state(params, stats, tx):
    return jtask.SegTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params))


def _port_state(params, stats, model_cfg=SEG_MODEL):
    return task.create_seg_state(_port(model_cfg, params, stats), task.make_adam(LR, WD), "cpu")


def _grads_as_flax(model):
    grads, _ = state_dict_to_flax({name: p.grad for name, p in model.named_parameters()})
    return grads


def test_train_step_loss_and_gradients_match_jax(seg):
    model, params, stats, batch = seg
    tx = _capture_grads()
    step, _, _ = jtask.make_seg_steps(model, tx, 2, HWS)
    new, confusion, m = jax.jit(step)(_jax_state(params, stats, tx), batch,
                                      jax.random.PRNGKey(0), JaxConfusion.create(2))
    train_step, _, _ = task.make_seg_steps(2, HWS)
    state = _port_state(params, stats)
    state, ours_confusion, ours = train_step(state, _torch_batch(batch),
                                             torch.Generator().manual_seed(0),
                                             ConfusionState.create(2))
    assert state.step == 1
    assert_close(ours["loss"].numpy(), np.asarray(m["loss"]), RTOL, "loss")
    assert_trees_close(_grads_as_flax(state.model), to_plain_dict(new.opt_state), GRAD_TOL,
                       "grads")
    _, new_stats = state_dict_to_flax(state.model.state_dict())
    assert_trees_close(new_stats, to_plain_dict(new.batch_stats), RTOL, "stats")
    np.testing.assert_array_equal(ours_confusion.matrix.numpy(),
                                  np.asarray(confusion.matrix).astype(np.int64))


def test_adam_matches_optax_chain():
    """``make_adam`` is optax's ``chain(add_decayed_weights, adam)`` on
    identical gradients, over 3 steps."""
    r = np.random.RandomState(0)
    params = {"w": r.randn(6, 5).astype(np.float32), "b": r.randn(5).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * 10.0 ** r.randint(-6, 1, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    ref, opt_state = dict(params), tx.init(params)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = task.make_adam(LR, WD)(tensors.values())
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, ref)
        ref = optax.apply_updates(ref, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        for k, t in tensors.items():
            assert_close(t.detach().numpy(), np.asarray(ref[k]), 1e-6, k)


def _jax_adam_steps(model, params, stats, batch, n, frozen_mask=None):
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    step, _, _ = jtask.make_seg_steps(model, tx, 2, HWS, frozen_mask=frozen_mask)
    step = jax.jit(step)
    state, confusion = _jax_state(params, stats, tx), JaxConfusion.create(2)
    for _ in range(n):
        state, confusion, m = step(state, batch, jax.random.PRNGKey(0), confusion)
    return state, m


def _port_adam_steps(params, stats, batch, n, frozen=None):
    train_step, _, _ = task.make_seg_steps(2, HWS, frozen=frozen)
    state, confusion = _port_state(params, stats), ConfusionState.create(2)
    for i in range(n):
        state, confusion, m = train_step(state, _torch_batch(batch),
                                         torch.Generator().manual_seed(i), confusion)
    return state, m


def test_three_adam_steps_match_jax(seg):
    model, params, stats, batch = seg
    ref, ref_m = _jax_adam_steps(model, params, stats, batch, 3)
    state, m = _port_adam_steps(params, stats, batch, 3)
    assert_close(m["loss"].numpy(), np.asarray(ref_m["loss"]), 1e-4, "loss")
    ours, ours_stats = state_dict_to_flax(state.model.state_dict())
    ref_params = to_plain_dict(ref.params)
    bound = 2 * LR * 3
    total = far = 0
    for path, want in _leaves(ref_params):
        got = _leaf(ours, path)
        diff = np.abs(got - want)
        assert diff.max() <= bound + RTOL * np.abs(want).max(), (path, diff.max())
        far += int((diff > RTOL * np.abs(want).max()).sum())
        total += diff.size
    assert far <= total // 10_000, (far, total)
    assert_trees_close(ours_stats, to_plain_dict(ref.batch_stats), 1e-4, "stats")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_linear_evaluation_moves_frozen_backbone_as_jax(seg):
    """The backbone's gradient is zeroed, and Adam's decay term alone moves
    each backbone parameter by about lr (``ROADMAP.md`` §3), on both sides;
    the head trains."""
    model, params, stats, batch = seg
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: any(getattr(p, "key", None) == "backbone" for p in path), params)
    ref, _ = _jax_adam_steps(model, params, stats, batch, 2, frozen_mask=mask)
    state, _ = _port_adam_steps(params, stats, batch, 2,
                                frozen=lambda name: name.startswith("backbone."))
    ours, _ = state_dict_to_flax(state.model.state_dict())
    ref_params = to_plain_dict(ref.params)
    assert_trees_close(ours["backbone"], ref_params["backbone"], 1e-6, "frozen backbone")
    moved = np.abs(ours["backbone"]["conv1"]["conv"]["kernel"]
                   - params["backbone"]["conv1"]["conv"]["kernel"])
    assert np.median(moved) > LR  # ~2 lr after 2 steps, from the decay alone
    for name, p in state.model.named_parameters():
        if name.startswith("backbone."):
            assert not p.grad.any(), name


def test_eval_step_with_padded_rows_matches_jax(seg):
    model, params, stats, _ = seg
    batch = _batch(seed=3, n=3)
    batch["valid"] = np.array([True, True, False])
    tx = _capture_grads()
    _, eval_step, metrics_of = jtask.make_seg_steps(model, tx, 2, HWS)
    ref_conf, ref = jax.jit(eval_step)(_jax_state(params, stats, tx), batch,
                                       JaxConfusion.create(2))
    _, ours_eval, ours_metrics_of = task.make_seg_steps(2, HWS)
    state = _port_state(params, stats)
    conf, m = ours_eval(state, _torch_batch(batch), ConfusionState.create(2))
    assert state.model.training  # the step leaves the mode as it found it
    np.testing.assert_array_equal(conf.matrix.numpy(), np.asarray(ref_conf.matrix).astype(np.int64))
    assert int(conf.matrix.sum()) == 2 * HW * HW  # the pad row is not counted
    assert float(m["weight"]) == float(ref["weight"]) == 2.0
    assert_close(m["loss"].numpy(), np.asarray(ref["loss"]), RTOL, "loss")
    got = ours_metrics_of(conf, "val_")
    want = metrics_of(ref_conf, "val_")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_dropout_law():
    """Keep rate and scale of the heads' dropout; the same mask for the
    same (seed, step), another for the next step; the identity in eval."""
    from cp2_tpu_torch.ssl.train_step import step_generator

    y = torch.ones(64, 16, 32, 32)
    out = dropout(y, 0.1, True, step_generator(0, 5, "cpu", stream=1))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.allclose(out[kept], torch.tensor(1 / 0.9))
    again = dropout(y, 0.1, True, step_generator(0, 5, "cpu", stream=1))
    later = dropout(y, 0.1, True, step_generator(0, 6, "cpu", stream=1))
    assert torch.equal(out, again) and not torch.equal(out, later)
    assert dropout(y, 0.1, False, None) is y
    with pytest.raises(ValueError):
        dropout(y, 0.1, True, None)
    half = dropout(torch.ones(8, 4, dtype=torch.bfloat16), 0.5, True,
                   torch.Generator().manual_seed(0))
    assert half.dtype == torch.bfloat16 and set(half.unique().tolist()) <= {0.0, 2.0}


# ---------------------------------------------------------------------------
# the conversion matrix
# ---------------------------------------------------------------------------

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _torch_names(report):
    """JAX report names (``a/b/kernel``) as state-dict keys (``a.b.weight``)."""
    out = {}
    for key, names in report.items():
        out[key] = sorted(".".join(n.split("/")[:-1] + [_LEAF[n.split("/")[-1]]])
                          for n in names)
    return out


def _check_graft(target_cfg, source_tree, meta, pt, source_sd, use_backbone_only=False):
    """Both packages' matrix on the same weights: equal reports, and the
    port's merged state dict is the JAX merged tree through the bridge."""
    _, params, stats = _variables(target_cfg, seed=1)
    merged_ref, report_ref = jconvert.load_pretrained_into_segmentor(
        {"params": params, "batch_stats": stats}, source_tree, meta, pt,
        use_backbone_only=use_backbone_only)
    target = flax_to_state_dict(params, stats)
    merged, report = convert.load_pretrained_into_segmentor(
        target, source_sd, meta, PretrainType[pt.name], use_backbone_only=use_backbone_only)
    assert set(report) == set(convert.REPORT_KEYS)
    ref_names = _torch_names(report_ref)
    assert {k: sorted(v) for k, v in report.items()} == {
        k: ref_names.get(k, []) for k in convert.REPORT_KEYS}
    want = flax_to_state_dict(to_plain_dict(merged_ref["params"]),
                              to_plain_dict(merged_ref["batch_stats"]))
    assert set(merged) == set(want)
    for k, v in want.items():
        assert torch.equal(merged[k], v), k
    return report


def _pretrain_tree(model, seed=2):
    params, stats = random_flax_variables(model, seed=seed, init_all=True)
    return {"params": params, "batch_stats": stats}


CP2_TARGET = dict(SEG_MODEL, auxiliary_head=None)


@pytest.mark.parametrize("backbone_only", [False, True], ids=["all", "backbone_only"])
def test_conversion_cp2_matches_jax(backbone_only):
    tree = _pretrain_tree(jax_encoder())
    meta = {"pretrain_type": "CP2"}
    report = _check_graft(CP2_TARGET, tree, meta, JaxPretrainType.CP2,
                          flax_to_state_dict(tree["params"], tree["batch_stats"]),
                          use_backbone_only=backbone_only)
    assert report["loaded"] and all(k.startswith("backbone.") or not backbone_only
                                    for k in report["loaded"])
    with pytest.raises(ValueError):
        convert.load_pretrained_into_segmentor({}, {}, {"pretrain_type": "MOCO"},
                                               PretrainType.CP2)
    with pytest.raises(ValueError):
        jconvert.load_pretrained_into_segmentor({}, {}, {"pretrain_type": "MOCO"},
                                                JaxPretrainType.CP2)


def test_conversion_moco_on_finetune_moco_matches_jax():
    """A MOCO encoder (ResNet-18 under the identity FCN head, projector and
    predictor) into ``config_finetune_moco``'s structure: the backbone
    loads, the FCN's ``conv_seg`` is dropped."""
    tree = _pretrain_tree(jax_variant_encoder(JaxPretrainType.MOCO, MOCO_MODEL))
    report = _check_graft(SEG_MOCO_MODEL, tree, {"pretrain_type": "MOCO"},
                          JaxPretrainType.MOCO,
                          flax_to_state_dict(tree["params"], tree["batch_stats"]))
    assert "decode_head.conv_seg.weight" in report["dropped"]


def test_conversion_mirror_matches_jax():
    _, params, stats = _variables(dict(CP2_TARGET, decode_head=dict(
        CP2_TARGET["decode_head"], num_classes=3)), seed=3)
    report = _check_graft(CP2_TARGET, {"params": params, "batch_stats": stats}, {},
                          JaxPretrainType.MIRROR, flax_to_state_dict(params, stats))
    assert report["dropped"] and report["loaded"]


@pytest.mark.parametrize("pt,prefix", [("CP2_IMGNET", ""), ("MOCO_IMGNET", "module.encoder_q."),
                                       ("PIXPRO", "module.encoder.")])
def test_conversion_torchvision_layout_matches_jax(pt, prefix):
    """A torchvision-layout ResNet-50 (fc and ``num_batches_tracked``
    beside it) from seeded numpy, under each loader's prefix."""
    _, params, stats = _variables(CP2_TARGET, seed=4)
    sd = flax_to_state_dict(params, stats)
    r = np.random.RandomState(5)
    tv = {prefix + torchvision_name(k[len("backbone."):]):
          r.randn(*v.shape).astype(np.float32)
          for k, v in sd.items() if k.startswith("backbone.")}
    tv[prefix + "fc.weight"] = np.zeros((10, 256), np.float32)
    tv[prefix + "bn1.num_batches_tracked"] = np.array(3)
    report = _check_graft(CP2_TARGET, tv, {}, JaxPretrainType[pt],
                          {k: torch.from_numpy(v) for k, v in tv.items()})
    assert len(report["loaded"]) == sum(1 for k in sd if k.startswith("backbone.")
                                        and not k.endswith(("running_mean", "running_var")))
    assert not report["missing_in_source"]


@pytest.mark.parametrize("case", ["default_ce", "dice_ohem", "lovasz", "ce_sigmoid_ohem_thresh"])
def test_build_decode_loss_matches_jax(case):
    """``build_decode_loss`` from a decode-head config: ``None`` for the
    default mean CE, else the configured loss behind OHEM's remapping, at
    1e-5 with its gradient."""
    head = {
        "default_ce": dict(loss_decode=dict(type="CrossEntropyLoss", loss_weight=1.0)),
        "dice_ohem": dict(loss_decode=dict(type="DiceLoss"),
                          sampler=dict(type="OHEMPixelSampler", min_kept=30)),
        "lovasz": dict(loss_decode=dict(type="LovaszLoss", loss_weight=0.5)),
        "ce_sigmoid_ohem_thresh": dict(
            loss_decode=dict(type="CrossEntropyLoss", use_sigmoid=True),
            sampler=dict(type="OHEMPixelSampler", thresh=0.6, min_kept=10)),
    }[case]
    ours_fn = task.build_decode_loss(copy.deepcopy(head))
    ref_fn = jtask.build_decode_loss(copy.deepcopy(head))
    if case == "default_ce":
        assert ours_fn is None and ref_fn is None
        return
    r = np.random.RandomState(8)
    logits = (2.0 * r.randn(2, 9, 11, 3)).astype(np.float32)
    labels = r.randint(0, 3, (2, 9, 11)).astype(np.int32)
    labels[0, :2] = 255
    ref, ref_grad = jax.value_and_grad(lambda x: ref_fn(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    ours = ours_fn(x, torch.from_numpy(labels))
    ours.backward()
    assert_close(ours.detach().numpy(), np.asarray(ref), RTOL, case)
    assert_close(x.grad.numpy(), np.asarray(ref_grad), RTOL, case + " grad")

"""Every pretrain variant's step in the port against the JAX package's, on
the CPU: MOCO, BYOL, DENSECL, PROPOSED_V2 (symmetric, predictor,
coordinate 0.5), PROPOSED (``scripts/proposed.sh``'s PIXEL_REGION_ID
10/1/0) and CP2 on both U-Net backbones.

Both sides start from one bridged state (tiny models: ``MOCO_MODEL``, a
plain ResNet-18 at width 8 under config_moco's identity head, for the
image-level variants, DenseCL and PROPOSED_V2; the flagship structure
``TINY_MODEL`` for PROPOSED; the U-Nets' ResNet-50 at width 8; queues of
64; batch 2, BYOL 8; 64x64) and take the same batch every step: two views
whose pixel ids overlap in part, SAM-like region ids with unknown (0)
blocks, erased backgrounds.  Pinned after 1 step (lr 0.1) and after 3
(lr 1e-3): the loss and every metric of ``metrics_level`` 1 with the
epoch family, params (the ones the loss never reaches included: they
decay and take momentum in the JAX step), the params' change after 1
step, EMA params, both BatchNorm trees, both queues and both pointers.
DenseCL's argmax positive matching picks the same keys on both sides on
these inputs, with a margin far above float32 noise.

PROPOSED_V2 runs on ``MOCO_MODEL``: on ``TINY_MODEL`` the symmetric
loss's JAX float32 gradient parts by 5e-2 of layer2_3's largest gradient
from the same gradient of the port in float64, where the port in float32
parts from it by 1e-5 — the JAX float32 step cannot be the reference
there.

The JAX step is the package's ``make_pretrain_step`` under ``jax.jit``,
once per variant: its optimizer is ``make_optimizer("sgd", lr)`` with the
learning rate carried in the optimizer state (``inject_hyperparams``), so
that one compile serves both learning rates (``test_injected_lr_sgd_is_
make_optimizer`` holds the two to the same updates).  As in
``tests/test_torch_train_step.py``, flax's BatchNorm computes its
variance in two passes, and the tolerance is rtol 1e-4 after 1 step and
1e-3 after 3, each with an absolute floor of the same fraction of the
array's largest magnitude.

oneDNN stays on.  It was turned off while ``SSLEncoder`` handed its
network a channels-last view of the NHWC batch: oneDNN's channels-last
convolution backward corrupts the heap at these 2x2 maps in this CPU
build.  The encoder now hands it a contiguous NCHW tensor, so that
backward is not reached (every case here passes at 1, 2 and 4 threads).
PROPOSED's three steps on ``TINY_MODEL`` sit at the edge of what float32
resolves, so its 3-step case holds each float32 trajectory, JAX's and the
port's, to a float64 run of the port (``_torch_f64_run``: the encoder in
float64, its float32 casts made float64) instead of to each other, at the
same tolerance.  Measured in fractions of that bound (rtol 1e-3 with the
absolute floor), at the third step: JAX's float32 trajectory is 0.93 from
float64 (``dense_per_sample_lower_negative_scores``; 0.92 in the stem
kernel, 0.85 in the head's BatchNorm mean), the port's 0.37 to 0.43 with
1, 2 and 4 threads (0.21 to 0.23 in the stem kernel); the two float32
trajectories part by 0.54 of the bound from each other, so compared to
each other they pass or fail by how each rounds.  JAX's distance does not
depend on the port's threads, and the port's stays under half the bound.
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
    TINY_MODEL,
    assert_close,
    assert_trees_close,
    jax_variant_encoder,
    narrow_unet_backbones,
    pre_augmented_batch,
    random_flax_variables,
    to_plain_dict,
    torch_variant_encoder,
    unit_queue,
)
from cp2_tpu.ssl import SSLHyperParams as JaxHyperParams
from cp2_tpu.ssl.state import PretrainState as JaxPretrainState
from cp2_tpu.ssl.train_step import (
    backbone_output_stride_of as jax_backbone_output_stride_of,
    dense_output_stride_of as jax_dense_output_stride_of,
    epoch_scalar_names as jax_epoch_scalar_names,
    make_optimizer as jax_make_optimizer,
    make_pretrain_step as jax_make_pretrain_step,
)
from cp2_tpu.types import BackboneType as JaxBackboneType
from cp2_tpu.types import MappingType as JaxMappingType
from cp2_tpu.types import PretrainType as JaxPretrainType
from cp2_tpu_torch.checkpoint.bridge import load_pretrain_state_from_flax, pretrain_state_to_flax
from cp2_tpu_torch.ops.losses import l2_normalize
from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state
from cp2_tpu_torch.ssl.train_step import (
    epoch_scalar_names,
    make_optimizer,
    make_pretrain_step,
)
from cp2_tpu_torch.types import BackboneType, MappingType, PretrainType

QUEUE_LEN = 64
LR = {1: 0.1, 3: 1e-3}
TOL = {1: 1e-4, 3: 1e-3}

# name -> (pretrain type, model config, backbone type, hyperparameters)
VARIANTS = {
    "MOCO": (JaxPretrainType.MOCO, MOCO_MODEL, None, {}),
    "BYOL": (JaxPretrainType.BYOL, MOCO_MODEL, None, {}),
    "DENSECL": (JaxPretrainType.DENSECL, MOCO_MODEL, None, {}),
    "PROPOSED_V2": (JaxPretrainType.PROPOSED_V2, MOCO_MODEL, None,
                    dict(use_symmetrical_loss=True, use_predictor=True, lmbd_coordinate=0.5)),
    "PROPOSED": (JaxPretrainType.PROPOSED, TINY_MODEL, None,
                 dict(mapping_type="PIXEL_REGION_ID", lmbd_pixel_corr_weight=10.0,
                      lmbd_region_corr_weight=1.0, lmbd_not_corr_weight=0.0)),
    "CP2_UNET_TRUNCATED": (JaxPretrainType.CP2, TINY_MODEL, JaxBackboneType.UNET_TRUNCATED, {}),
    "CP2_UNET_ENCODER_ONLY": (JaxPretrainType.CP2, TINY_MODEL,
                              JaxBackboneType.UNET_ENCODER_ONLY, {}),
}
# BYOL's MLP BatchNorms normalise over the batch alone: over 2 samples each
# channel becomes ±d/sqrt(d²+eps), which float32 resolves to a few digits
# where the two values nearly agree; at 4 its stem update after 3 steps
# still parts from JAX's by 3x the tolerance, at 8 it holds
BATCHES = {"BYOL": 8}
# parameters each variant's loss never reaches (their update is decay and
# momentum alone), as (path prefix, ...) in the flax tree
UNUSED = {
    "MOCO": [("predictor",), ("encoder", "decode_head", "conv_seg")],
    "BYOL": [("encoder", "decode_head", "conv_seg")],
    "DENSECL": [("encoder", "decode_head", "conv_seg"), ("neck", "global_predictor"),
                ("neck", "local_predictor")],
    "PROPOSED_V2": [("encoder", "decode_head", "conv_seg")],
}

# biases whose every path to the loss passes a train-mode BatchNorm, which
# takes away any constant they add (BYOL's fc1 biases, and the projector's
# fc2 bias, read only through the predictor's fc1 and BatchNorm): their
# gradient is zero in exact arithmetic, so both sides' float32 gradients
# are rounding noise (~4e-7 here); their update is held to the tolerance
# of their layer's kernel update instead of their own (decay-only) size
BN_FED_BIASES = {
    "BYOL": [("projector", "mlp", "fc1", "bias"), ("projector", "mlp", "fc2", "bias"),
             ("predictor", "fc1", "bias")],
}


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two threads, the test workers sharing the cores; oneDNN on (see the
    module docstring)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=True):
        yield
    torch.set_num_threads(threads)


def variant_batch(name: str, seed: int = 0):
    """``pre_augmented_batch`` with view b's pixel ids shifted by 32 rows and
    new in its right half (a partial overlap at every output stride used
    here), and region ids in 8x8 blocks of 0..4."""
    n = BATCHES.get(name, 2)
    batch = pre_augmented_batch(seed, batch=n, hw=HW)
    ids_b = np.roll(batch["pixel_ids_a"], 32, axis=1)
    ids_b[:, :, HW // 2:] += HW * HW
    r = np.random.RandomState(seed + 1)
    regions = r.randint(0, 5, (n, HW // 8, HW // 8)).repeat(8, 1).repeat(8, 2)
    batch.update(pixel_ids_b=ids_b, region_ids_a=regions.astype(np.int32),
                 region_ids_b=np.roll(regions, 32, axis=1).astype(np.int32))
    return batch


def _hps(name):
    pt, _, bt, kw = VARIANTS[name]
    kw = dict(kw, dim=16, queue_len=QUEUE_LEN)
    jkw, tkw = dict(kw), dict(kw)
    if "mapping_type" in kw:
        jkw["mapping_type"] = JaxMappingType[kw["mapping_type"]]
        tkw["mapping_type"] = MappingType[kw["mapping_type"]]
    if bt is not None:
        jkw["backbone_type"], tkw["backbone_type"] = bt, BackboneType[bt.name]
    return (JaxHyperParams.for_variant(pt, **jkw),
            SSLHyperParams.for_variant(PretrainType[pt.name], **tkw))


def _jax_sgd():
    """``make_optimizer("sgd", lr)`` with the learning rate in its state."""
    return optax.chain(optax.add_decayed_weights(1e-4),
                       optax.inject_hyperparams(optax.sgd)(learning_rate=0.1, momentum=0.9))


def _with_lr(opt_state, lr):
    decay, sgd = opt_state
    return decay, sgd._replace(hyperparams=dict(sgd.hyperparams,
                                                learning_rate=jnp.float32(lr)))


def test_injected_lr_sgd_is_make_optimizer():
    r = np.random.RandomState(0)
    params = {"w": r.randn(5, 3).astype(np.float32), "b": r.randn(3).astype(np.float32)}
    grads = [{k: r.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    for lr in LR.values():
        ref, ours = jax_make_optimizer("sgd", lr), _jax_sgd()
        s_ref, s_ours = ref.init(params), _with_lr(_jax_sgd().init(params), lr)
        for g in grads:
            u_ref, s_ref = ref.update(g, s_ref, params)
            u_ours, s_ours = ours.update(g, s_ours, params)
            for k in params:
                np.testing.assert_array_equal(np.asarray(u_ours[k]), np.asarray(u_ref[k]))


def _initial_tree(name):
    pt, cfg, bt, _ = VARIANTS[name]
    params, stats = random_flax_variables(jax_variant_encoder(pt, cfg, bt), seed=0,
                                          init_all=True)
    return {
        "params": params, "batch_stats": stats,
        "ema_params": copy.deepcopy(params), "ema_batch_stats": copy.deepcopy(stats),
        "queue": unit_queue(1, QUEUE_LEN), "queue_ptr": np.int32(0),
        "queue2": unit_queue(2, QUEUE_LEN), "queue2_ptr": np.int32(0),
        "step": np.int32(0),
    }


SNAP = ("params", "batch_stats", "ema_params", "ema_batch_stats", "queue", "queue_ptr",
        "queue2", "queue2_ptr", "step")


def _jax_runs(name, tree, batch):
    pt, cfg, bt, _ = VARIANTS[name]
    bt = bt or JaxBackboneType.DEEPLABV3
    jax_hp, _ = _hps(name)
    model = jax_variant_encoder(pt, cfg, bt)
    tx = _jax_sgd()
    step = jax.jit(jax_make_pretrain_step(
        model, tx, jax_hp, jax_dense_output_stride_of(cfg, bt),
        jax_backbone_output_stride_of(cfg, bt), metrics_level=1, epoch_scalars=True))
    runs = {}
    for n_steps, lr in LR.items():
        state = JaxPretrainState(
            step=jnp.asarray(tree["step"]), params=tree["params"],
            batch_stats=tree["batch_stats"], ema_params=tree["ema_params"],
            ema_batch_stats=tree["ema_batch_stats"],
            opt_state=_with_lr(tx.init(tree["params"]), lr),
            queue=jnp.asarray(tree["queue"]), queue_ptr=jnp.asarray(tree["queue_ptr"]),
            queue2=jnp.asarray(tree["queue2"]), queue2_ptr=jnp.asarray(tree["queue2_ptr"]))
        out = []
        for _ in range(n_steps):
            state, metrics = step(state, batch, jax.random.PRNGKey(0))
            out.append(({k: to_plain_dict(getattr(state, k)) for k in SNAP},
                        to_plain_dict(metrics)))
        runs[n_steps] = out
    return runs


def _torch_runs(name, tree, batch):
    pt, cfg, bt, _ = VARIANTS[name]
    bt = bt or JaxBackboneType.DEEPLABV3
    _, hp = _hps(name)
    step = make_pretrain_step(hp, jax_dense_output_stride_of(cfg, bt),
                              jax_backbone_output_stride_of(cfg, bt), metrics_level=1,
                              epoch_scalars=True)
    runs = {}
    for n_steps, lr in LR.items():
        state = create_pretrain_state(torch_variant_encoder(pt, cfg, bt), make_optimizer(
            "sgd", lr), hp, device="cpu")
        load_pretrain_state_from_flax(state, tree)
        out = []
        for _ in range(n_steps):
            state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            out.append((pretrain_state_to_flax(state),
                        {k: v.numpy() for k, v in metrics.items()}))
        runs[n_steps] = out
    return runs


# variants whose 3-step float32 trajectories are held to a float64 run of
# the port rather than to each other (see the module docstring)
F64_REFERENCE = ("PROPOSED",)


def _torch_f64_run(name, tree, batch, n_steps=3):
    """The port's ``n_steps`` at ``LR[n_steps]`` in float64: the encoder
    built in float64, the state's parameters, statistics and queues in
    float64, the float images too, and ``Tensor.float`` (the objectives'
    casts to float32) made a cast to float64 for the run."""
    from cp2_tpu_torch.ssl import SSLEncoder

    pt, cfg, bt, _ = VARIANTS[name]
    bt = bt or JaxBackboneType.DEEPLABV3
    _, hp = _hps(name)
    step = make_pretrain_step(hp, jax_dense_output_stride_of(cfg, bt),
                              jax_backbone_output_stride_of(cfg, bt), metrics_level=1,
                              epoch_scalars=True)
    encoder = SSLEncoder(cfg, pretrain_type=PretrainType[pt.name],
                         backbone_type=BackboneType[bt.name], dim=16, img_hw=(HW, HW),
                         dtype=torch.float64)
    state = create_pretrain_state(encoder, make_optimizer("sgd", LR[n_steps]), hp,
                                  device="cpu")
    state.model.double()
    state.ema_model.double()
    state.queue, state.queue2 = state.queue.double(), state.queue2.double()
    load_pretrain_state_from_flax(state, tree)
    inputs = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
              for k, v in batch.items()}
    out = []
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a, **kw: self.double())
        for _ in range(n_steps):
            state, metrics = step(state, inputs)
            out.append((pretrain_state_to_flax(state),
                        {k: v.numpy() for k, v in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def runs():
    """``get(name)`` → (start tree, JAX runs, port runs, float64 port run),
    each run a dict n_steps → [(state tree, metrics) per step], the float64
    one the 3-step run's list for the ``F64_REFERENCE`` variants (else
    None); computed once per variant."""
    cache = {}

    def get(name):
        if name not in cache:
            with pytest.MonkeyPatch.context() as patch:
                narrow_unet_backbones(patch)
                patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
                tree, batch = _initial_tree(name), variant_batch(name)
                f64 = _torch_f64_run(name, tree, batch) if name in F64_REFERENCE else None
                cache[name] = (tree, _jax_runs(name, tree, batch),
                               _torch_runs(name, tree, batch), f64)
        return cache[name]

    return get


def _delta(tree, start):
    return {k: _delta(v, start[k]) if isinstance(v, dict) else v - start[k]
            for k, v in tree.items()}


def _subtree(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _updates_close(delta, ref_delta, params, tol, path=""):
    """``assert_close`` on each leaf of the update, with one more absolute
    floor: the float32 spacing of the parameter, below which a stored
    parameter cannot resolve its own change (a BatchNorm scale near 1
    moves in steps of 1.2e-7)."""
    assert set(delta) == set(ref_delta), path
    for key, ref in ref_delta.items():
        where = f"{path}/{key}"
        if isinstance(ref, dict):
            _updates_close(delta[key], ref, params[key], tol, where)
            continue
        ulp = float(np.spacing(np.abs(params[key]).max().astype(np.float32)))
        np.testing.assert_allclose(delta[key], ref, rtol=tol,
                                   atol=max(tol * float(np.abs(ref).max()), ulp),
                                   err_msg=f"update{where}")


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_steps_match_jax(runs, name, n_steps):
    start, jax_runs, torch_runs, f64_run = runs(name)
    if n_steps == 3 and f64_run is not None:
        # both float32 trajectories against the float64 one
        _assert_run_matches(name, n_steps, start, torch_runs[n_steps], f64_run)
        _assert_run_matches(name, n_steps, start, jax_runs[n_steps], f64_run)
    else:
        _assert_run_matches(name, n_steps, start, torch_runs[n_steps], jax_runs[n_steps])


def _assert_run_matches(name, n_steps, start, run, ref_run):
    """``run``'s metrics and final state against ``ref_run``'s at
    ``TOL[n_steps]``."""
    tol = TOL[n_steps]
    for i, ((state, metrics), (ref_state, ref_metrics)) in enumerate(zip(run, ref_run)):
        assert np.isfinite(metrics["loss"])
        assert set(metrics) == set(ref_metrics), (i, set(metrics) ^ set(ref_metrics))
        for key, value in ref_metrics.items():
            scale = 1.0 if "scores" in key else float(np.abs(value).max())
            np.testing.assert_allclose(np.asarray(metrics[key], np.float64), value,
                                       rtol=tol, atol=tol * scale, err_msg=f"{key} step {i}")
    state, ref_state = run[-1][0], ref_run[-1][0]
    for field in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        assert_trees_close(state[field], ref_state[field], tol, field)
    if n_steps == 1:
        # the change holds the gradients (and, for the parameters the loss
        # never reaches, the weight decay alone) to the same tolerance
        delta = _delta(state["params"], start["params"])
        ref_delta = _delta(ref_state["params"], start["params"])
        for path in BN_FED_BIASES.get(name, []):
            ours_b = _subtree(delta, path[:-1]).pop(path[-1])
            ref_b = _subtree(ref_delta, path[:-1]).pop(path[-1])
            kernel = np.abs(_subtree(ref_delta, path[:-1])["kernel"]).max()
            np.testing.assert_allclose(ours_b, ref_b, rtol=tol, atol=tol * kernel,
                                       err_msg="/".join(path))
        _updates_close(delta, ref_delta, ref_state["params"], tol)
        for path in UNUSED.get(name, []):
            leaves = list(_leaves(_subtree(delta, path)))
            assert leaves and all(np.abs(d).max() > 0 for d in leaves), path
    for q in ("queue", "queue2"):
        assert_close(state[q], ref_state[q], tol, q)
        assert int(state[f"{q}_ptr"]) == int(ref_state[f"{q}_ptr"]), q
    assert int(state["step"]) == int(ref_state["step"]) == n_steps
    pt = VARIANTS[name][0]
    enqueues = {"BYOL": (0, 0), "DENSECL": (1, 1), "PROPOSED_V2": (1, 1)}.get(pt.name, (1, 0))
    batch = BATCHES.get(name, 2)
    assert (int(state["queue_ptr"]), int(state["queue2_ptr"])) == tuple(
        e * n_steps * batch % QUEUE_LEN for e in enqueues)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_epoch_scalar_names_match_jax(name):
    pt = VARIANTS[name][0]
    assert epoch_scalar_names(PretrainType[pt.name]) == jax_epoch_scalar_names(pt)


def _pos_idx_torch(name, tree, batch, img_q, img_k):
    """DenseCL's positive indices (argmax of the backbone similarity) of
    the first step on the port, and each row's margin to its runner-up."""
    pt, cfg, bt, _ = VARIANTS[name]
    _, hp = _hps(name)
    state = create_pretrain_state(torch_variant_encoder(pt, cfg, bt), make_optimizer(
        "sgd", 0.1), hp, device="cpu")
    load_pretrain_state_from_flax(state, tree)
    state.ema_update(hp.momentum)
    with torch.no_grad():
        _, qe = state.model.densecl_embed(torch.from_numpy(batch[img_q]))
        _, ke = state.ema_model.densecl_embed(torch.from_numpy(batch[img_k]))
        n = qe.shape[0]
        sim = torch.einsum("nxc,nyc->nxy", l2_normalize(qe.reshape(n, -1, qe.shape[-1])),
                           l2_normalize(ke.reshape(n, -1, ke.shape[-1])))
    top2 = sim.topk(2, dim=2).values
    return sim.argmax(dim=2).numpy(), float((top2[..., 0] - top2[..., 1]).min())


def _pos_idx_jax(name, tree, batch, img_q, img_k):
    pt, cfg, bt, _ = VARIANTS[name]
    jax_hp, _ = _hps(name)
    model = jax_variant_encoder(pt, cfg, bt)
    ema = jax.tree_util.tree_map(lambda k, q: k * jax_hp.momentum + q * (1 - jax_hp.momentum),
                                 tree["ema_params"], tree["params"])

    def embd(params, stats, img):
        (_, e), _ = model.apply({"params": params, "batch_stats": stats}, img, train=True,
                                mutable=["batch_stats"], method="densecl_embed")
        e = e.reshape(e.shape[0], -1, e.shape[-1])
        return e / jnp.maximum(jnp.linalg.norm(e, axis=-1, keepdims=True), 1e-12)

    qe = embd(tree["params"], tree["batch_stats"], batch[img_q])
    ke = embd(ema, tree["ema_batch_stats"], batch[img_k])
    return np.asarray(jnp.argmax(jnp.einsum("nxc,nyc->nxy", qe, ke), axis=2))


@pytest.mark.parametrize("name", ["DENSECL", "PROPOSED_V2"])
def test_densecl_positive_matching_is_unambiguous(name):
    """Both sides pick the same positive keys in each direction the step
    runs, and every row's best key leads its runner-up by more than 1e-4,
    a thousand times float32's rounding of a cosine: a float-noise flip of
    the argmax cannot happen on these inputs (seed 0)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        tree, batch = _initial_tree(name), variant_batch(name)
        pairs = [("img_a", "img_b")]
        if VARIANTS[name][3].get("use_symmetrical_loss"):
            pairs.append(("img_b", "img_a"))
        for img_q, img_k in pairs:
            ours, margin = _pos_idx_torch(name, tree, batch, img_q, img_k)
            np.testing.assert_array_equal(ours, _pos_idx_jax(name, tree, batch, img_q, img_k))
            assert margin > 1e-4, (img_q, margin)

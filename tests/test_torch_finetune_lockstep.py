"""The two finetune CLIs in lockstep, end to end on the CPU:
``cp2_tpu.train.finetune.main`` against ``cp2_tpu_torch.train.finetune.main``
(``device="cpu"``) on one corpus, from the same weights.

* **The setup, the same on both sides.**  A v1 corpus of the quality
  gate's generator (``tools/make_synthetic_dataset.py``, seed 0, 48², 16
  train, 8 val and 8 test images); ``--train_data_ratio 0.5``, batch 2, 3
  epochs, ``--no-native_loader``, ``--no-bf16``; ``SEG_MODEL``'s structure
  without its auxiliary head (``config_finetune.py`` has none; the JAX CLI
  builds no auxiliary parameters) given by ``--config``.  The port starts
  from the variables of the JAX CLI's own ``model.init`` (its seed and
  sample shape), through the bridge, in place of its own initialiser.
  The device augmentation and the val flips are the identity on both
  sides (their draws differ by design and are held to JAX's by
  ``tests/test_torch_finetune_augment.py``); dropout is off in
  ``SEG_MODEL``.  The JAX CLI runs on a one-device mesh; flax's
  BatchNorm takes its variance in two passes (see
  ``tests/test_torch_bn_variance.py``).
* **Two legs**: ``--pretrain_type NONE``, and ``CP2`` from one JAX
  ``PretrainState`` of the narrow CP2 encoder (numpy weights with flax's
  initial laws, ``_init_like``) saved as the JAX pretrain CLI saves it,
  which the port reads after ``tools/jax_to_torch_checkpoint.py`` converts
  it.
* **What is compared**: the train, val and test file lists and the
  pseudo-test subset; the steps of each epoch; each epoch's train loss
  (rtol 1e-4) and train and val metrics (absolute 1e-4); the epoch kept as
  the best, and the only checkpoint left; the final ``test_*`` metrics
  (absolute 1e-4).  Measured: the two CLIs' losses part by at most 1.0e-6
  relative over the 12 steps of either leg, and no metric by more than
  6e-7.  A loop that differs parts them far more: the port's train loader
  shuffled with another seed parts the train losses by 3-9 % and a test
  metric by 4.5e-2 (measured on a copy of the port so changed).
* **Runtime**: about 130 s on one worker, nearly all of it the JAX CLI
  tracing and compiling its jitted steps (a persistent compile cache in
  the test's directory serves the second leg).
"""

import json
import os

import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_port_common import SEG_MODEL, TINY_MODEL, jax_encoder, to_plain_dict

HW = 48
SPLITS = {"train": 16, "val": 8, "test": 8}
MODEL = dict(SEG_MODEL, auxiliary_head=None)
LOSS_RTOL = 1e-4
METRIC_ATOL = 1e-4


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tools import make_synthetic_dataset

    root = tmp_path_factory.mktemp("lockstep")
    make_synthetic_dataset.generate(str(root / "corpus"), HW, SPLITS, seed=0, version=1)
    (root / "config.py").write_text(f"model = {MODEL!r}\n")
    return root


@pytest.fixture(scope="module", autouse=True)
def compile_cache(tmp_path_factory):
    """The JAX CLI's persistent compile cache in a directory of the test's
    own, every program kept, so that the second leg reuses the first's
    (about 55 s a leg without, 25 s with); the previous setting comes back
    after the module."""
    import jax
    from jax._src import compilation_cache

    import cp2_tpu.utils

    before = jax.config.jax_compilation_cache_dir
    enable = cp2_tpu.utils.enable_persistent_compilation_cache
    where = str(tmp_path_factory.mktemp("jax_cache"))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(cp2_tpu.utils, "enable_persistent_compilation_cache",
                      lambda: enable(where, min_compile_seconds=1.0))
        yield
    jax.config.update("jax_compilation_cache_dir", before)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def cp2_runs(corpus):
    """One random JAX ``PretrainState`` of the narrow CP2 encoder, saved as
    the JAX pretrain CLI saves it, and its conversion for the port."""
    import copy

    import jax
    import jax.numpy as jnp

    from cp2_tpu.checkpoint import save_checkpoint
    from cp2_tpu.ssl.state import PretrainState
    from cp2_tpu.ssl.train_step import make_optimizer
    from tools import jax_to_torch_checkpoint

    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jax_encoder().init(jax.random.PRNGKey(0), x, train=False))
    r = np.random.RandomState(5)
    params, stats = _init_like(shapes["params"], r), _init_like(shapes["batch_stats"], r)
    state = PretrainState(
        step=jnp.asarray(np.int32(9)), params=params, batch_stats=stats,
        ema_params=copy.deepcopy(params), ema_batch_stats=copy.deepcopy(stats),
        opt_state=make_optimizer("sgd", 0.1).init(params),
        queue=jnp.zeros((8, 16), jnp.float32), queue_ptr=jnp.asarray(np.int32(0)),
        queue2=jnp.zeros((8, 16), jnp.float32), queue2_ptr=jnp.asarray(np.int32(0)))
    jax_run = corpus / "jax_pretrain"
    save_checkpoint(str(jax_run), 9, jax.device_get(state),
                    meta={"epoch": 1, "pretrain_type": "CP2", "backbone_type": "DEEPLABV3"})
    encoder_cfg = corpus / "encoder.py"
    encoder_cfg.write_text(f"model = {TINY_MODEL!r}\n")
    port_run = corpus / "port_pretrain"
    jax_to_torch_checkpoint.convert(str(jax_run), str(port_run), str(encoder_cfg),
                                    img_hw=(HW, HW))
    return str(jax_run), str(port_run)


def _init_like(tree, r, module=""):
    """numpy values with flax's initial laws for a tree of shape structs:
    fan-in scaled kernels, zero biases, unit norm scales (zero for each
    residual branch's last norm, ``zero_init_residual``), zero means and
    unit variances.  Each block starts as the identity, so the float32
    trajectories stay as close as the JAX CLI's own initial weights keep
    them (random norm scales part the two sides by 1e-2 within 12 steps)."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _init_like(value, r, key)
            continue
        shape = tuple(value.shape)
        if key == "kernel":
            v = r.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif key in ("scale", "var"):
            v = np.full(shape, 0.0 if module == "norm3" and key == "scale" else 1.0)
        else:  # bias, mean
            v = np.zeros(shape)
        out[key] = v.astype(np.float32)
    return out


def _argv(corpus, log_dir, pretrain_type, pretrain_path):
    argv = ["--run_id", "lockstep", "--log_dir", str(log_dir),
            "--img_dirs", str(corpus / "corpus" / "images"),
            "--mask_dirs", str(corpus / "corpus" / "masks"),
            "--config", str(corpus / "config.py"), "--train_data_ratio", "0.5",
            "--img_height", str(HW), "--img_width", str(HW), "--batch_size", "2",
            "--epochs", "3", "--num_workers", "1", "--no-native_loader", "--no-bf16",
            "--visualize_freq", "0", "--pretrain_type", pretrain_type, "--seed", "0"]
    return argv + (["--pretrain_path", pretrain_path] if pretrain_path else [])


def _spy_splits(monkeypatch, module, seen):
    real = module.get_data_splits

    def spy(pairs, *args):
        splits = real(pairs, *args)
        seen.append({k: [tuple(os.path.basename(p) for p in pair) for pair in v]
                     for k, v in splits.items()})
        return splits
    monkeypatch.setattr(module, "get_data_splits", spy)


def _spy_pseudo(monkeypatch, module, seen):
    real = module.pseudo_test_subset

    def spy(items, *args):
        out = real(items, *args)
        seen.append([tuple(os.path.basename(p) for p in pair) for pair in out])
        return out
    monkeypatch.setattr(module, "pseudo_test_subset", spy)


def _run_jax(corpus, log_dir, pretrain_type, pretrain_path, monkeypatch):
    """The JAX CLI on a one-device mesh, identity augmentation, two-pass
    BatchNorm; returns (test metrics, splits, pseudo, the variables of its
    ``model.init`` before any pretrained weights load)."""
    import jax
    import jax.numpy as jnp

    import cp2_tpu.augment as jaug
    import cp2_tpu.checkpoint.convert as jconvert
    import cp2_tpu.data.datasets as jdata
    import cp2_tpu.parallel as jpar
    import cp2_tpu.train.segmentation_task as jtask
    from cp2_tpu.train import finetune as jft

    splits, pseudo, init = [], [], []
    _spy_splits(monkeypatch, jdata, splits)
    _spy_pseudo(monkeypatch, jdata, pseudo)

    def keep(variables):
        if not init:
            init.append((to_plain_dict(variables["params"]),
                         to_plain_dict(variables["batch_stats"])))

    load, create = jconvert.load_pretrained_into_segmentor, jtask.create_seg_state
    monkeypatch.setattr(jconvert, "load_pretrained_into_segmentor",
                        lambda variables, *a, **k: keep(variables) or load(variables, *a, **k))
    monkeypatch.setattr(jtask, "create_seg_state", lambda *a, **k: keep(
        {"params": k["init_params"], "batch_stats": k["init_batch_stats"]}) or create(*a, **k))
    mesh = jpar.create_mesh
    monkeypatch.setattr(jpar, "create_mesh", lambda: mesh(1))
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
    monkeypatch.setattr(jaug, "finetune_augment_batch", lambda rng, images, masks, cfg: (
        images.astype(jnp.float32) / 255.0, masks))
    monkeypatch.setattr(jaug, "eval_augment_batch", lambda rng, images, masks, **kw: (
        images, masks))
    test = jft.main(jft.get_args(_argv(corpus, log_dir, pretrain_type, pretrain_path)))
    return test, splits[0], pseudo[0], init[0]


def _run_port(corpus, log_dir, pretrain_type, pretrain_path, init, monkeypatch):
    import cp2_tpu_torch.augment as aug
    import cp2_tpu_torch.data as data
    import cp2_tpu_torch.models.layers as layers
    from cp2_tpu_torch.checkpoint.bridge import load_flax_into
    from cp2_tpu_torch.train import finetune

    splits, pseudo = [], []
    _spy_splits(monkeypatch, data, splits)
    _spy_pseudo(monkeypatch, data, pseudo)
    monkeypatch.setattr(layers, "init_flax_like_",
                        lambda model, generator: load_flax_into(model, *init))
    monkeypatch.setattr(aug, "finetune_augment_batch", lambda gen, images, masks, cfg: (
        images.to(torch.float32) / 255.0, masks))
    monkeypatch.setattr(aug, "eval_augment_batch", lambda gen, images, masks, **kw: (
        images, masks))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):  # see test_torch_finetune_cli.py
            test = finetune.main(finetune.get_args(
                _argv(corpus, log_dir, pretrain_type, pretrain_path)), device="cpu")
    finally:
        torch.set_num_threads(threads)
    return test, splits[0], pseudo[0]


def _epochs(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "train_loss" in r]


def _checkpoints(run_dir):
    return sorted(d for d in os.listdir(run_dir) if d.isdigit())


@pytest.mark.parametrize("leg", ["NONE", "CP2"])
def test_finetune_clis_run_in_lockstep(corpus, cp2_runs, leg, tmp_path, monkeypatch):
    jax_path, port_path = cp2_runs if leg == "CP2" else ("", "")
    with monkeypatch.context() as patch:
        ref_test, ref_splits, ref_pseudo, init = _run_jax(corpus, tmp_path / "jax", leg,
                                                          jax_path, patch)
    with monkeypatch.context() as patch:
        test, splits, pseudo = _run_port(corpus, tmp_path / "port", leg, port_path, init,
                                         patch)
    assert splits == ref_splits and pseudo == ref_pseudo
    assert [len(splits[k]) for k in ("train", "val", "test")] == [8, 8, 8]

    ref_rows, rows = _epochs(tmp_path / "jax" / "lockstep"), _epochs(tmp_path / "port" / "lockstep")
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in ref_rows] == [0, 1, 2]
    # 8 train images in batches of 2 (drop_last): 4 steps an epoch
    assert [r["_step"] for r in rows] == [r["_step"] for r in ref_rows] == [4, 8, 12]
    for ours, ref in zip(rows, ref_rows):
        val = {k for k in ref if k.startswith(("val_", "pseudotest_"))}
        assert val and {k for k in ours if k.startswith(("val_", "pseudotest_"))} == val
        np.testing.assert_allclose(ours["train_loss"], ref["train_loss"], rtol=LOSS_RTOL)
        for k in sorted(val | {k for k in ref if k.startswith("train_") and k != "train_loss"}):
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=METRIC_ATOL, err_msg=k)

    # the best epoch: the one checkpoint left, at the same step on both sides
    monitor = "val_BinaryJaccardIndex"
    best = max(range(3), key=lambda e: (ref_rows[e][monitor], -e))
    assert _checkpoints(tmp_path / "port" / "lockstep") == \
        _checkpoints(tmp_path / "jax" / "lockstep") == [str(4 * (best + 1))]
    assert set(test) == set(ref_test)
    for k, v in ref_test.items():
        np.testing.assert_allclose(test[k], v, rtol=0, atol=METRIC_ATOL, err_msg=k)

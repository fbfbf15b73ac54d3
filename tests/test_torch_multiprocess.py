"""Two processes against one, on the CPU: the CP2 step and the four CLIs.

Two gloo processes, started as ``torchrun`` starts them, each with its
rows of the global batch, are held to one process on the global batch:

* **The CP2 step against the JAX step.**  The state of
  ``tests/test_torch_train_step.py`` (tiny flagship-structure model, queue
  64, batch 2, 64x64), bridged from flax: each rank steps on one row of
  the pre-augmented batch, and the JAX step (two-pass BatchNorm variance,
  as there) on both.  Parameters, statistics, EMA encoder, ``queue`` and
  ``queue_ptr`` (the global batch enqueued on every rank) after 1 step at
  lr 0.1 and after 3 at lr 1e-3, at that file's tolerances (1e-4 and
  1e-3; its docstring says why); the two ranks' states are equal bit for
  bit.  The one-step update (new minus old weights) is held to a float64
  run of the port on the global batch, as JAX's is, at 2e-4 of each
  parameter's largest update: float32 does not resolve it better, since
  the ASPP image-pool BatchNorm normalises two values whose mean dwarfs
  their spread.  There JAX's update is 1.19e-4 from float64, the two
  ranks' 1.05e-4, and the two part by 1.08e-4 from each other (the
  one-process port's, which that file holds to JAX at 1e-4, 8.1e-5).
* **The CLIs against one process on the batches assembled from the two
  shards**, built as ``tests/test_multiprocess.py`` builds its reference:
  the one-process run's loader is two shard loaders whose batches are
  concatenated in rank order (``AssembledLoader``), so both runs see the
  same global batches and the same draws.  The pretrain CLI (``--debug``'s
  batch 8 and per-step scalars, 2 steps, then a ``--resume`` of 1 more
  step), the finetune CLI (``--fast_dev_run``: the best checkpoint written
  by rank 0 and restored by both after the barrier, then the test pass),
  the mirror CLI (``--fast_dev_run``) and the iteration CLI (4
  iterations).  The checkpoints rank 0 wrote, and the metrics it logged,
  against the one-process run's at 1e-4 (the pretrain run at lr 1e-3,
  where three steps of this tiny model stay within float32's reach of
  each other; every run in float32): the two reduce their BatchNorm
  statistics, losses and gradients in another order, whose rounding the
  train-mode BatchNorms amplify.  Both ranks end with the same weights and
  return the same metrics, bit for bit.

One pair of processes runs every case (``_ranks``), one after another in
one process group.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_port_common import (
    DIM,
    TINY_MODEL,
    assert_close,
    assert_trees_close,
    pre_augmented_batch,
    spawn_ranks,
    torch_encoder,
)

WORLD = 2
QUEUE_LEN = 64
STEP_CASES = {1: 0.1, 3: 1e-3}  # steps: lr, as tests/test_torch_train_step.py
STEP_BATCH = 2
UPDATE_TOL = 2e-4  # the one-step update against float64 (module docstring)
CLI_TOL = 1e-4

TINY_SEG = """
norm_cfg = dict(type="BN", requires_grad=True)
model = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                  dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1), norm_cfg=norm_cfg,
                  contract_dilation=True),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                     dilations=(1, 6), dropout_ratio=0.1, num_classes=None,
                     norm_cfg=norm_cfg),
    auxiliary_head=None,
)
"""
TINY_PRETRAIN = TINY_SEG.replace("dropout_ratio=0.1, num_classes=None,",
                                 "contrast=True, contrast_dim=128, num_classes=2,")
TINY_ITER = TINY_SEG.replace("num_classes=None", "num_classes=2")


# ---------------------------------------------------------------------------
# the CP2 step
# ---------------------------------------------------------------------------


def _cp2_steps(tree, n_steps, rows=slice(None)):
    """The port's CP2 step from ``tree`` (bridged), ``n_steps`` times on
    ``rows`` of the pre-augmented batch; the flax tree of the state."""
    from cp2_tpu_torch.checkpoint.bridge import (
        load_pretrain_state_from_flax,
        pretrain_state_to_flax,
    )
    from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state, output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import PretrainType

    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=DIM, queue_len=QUEUE_LEN)
    state = create_pretrain_state(torch_encoder(), make_optimizer("sgd", STEP_CASES[n_steps]),
                                  hp, device="cpu")
    load_pretrain_state_from_flax(state, tree)
    step = make_pretrain_step(hp, output_stride_of(TINY_MODEL))
    batch = {k: torch.from_numpy(v[rows])
             for k, v in pre_augmented_batch(0, batch=STEP_BATCH).items()}
    for _ in range(n_steps):
        state, metrics = step(state, batch)
    return pretrain_state_to_flax(state), float(metrics["loss"])


def _cp2_step_float64(tree):
    """One step of the port in float64 on the global batch (the encoder,
    state and images in float64, ``Tensor.float`` made a cast to float64
    for the run, as ``tests/test_torch_variant_steps.py`` makes it)."""
    from cp2_tpu_torch.checkpoint.bridge import (
        load_pretrain_state_from_flax,
        pretrain_state_to_flax,
    )
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl import output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import PretrainType

    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=DIM, queue_len=QUEUE_LEN)
    state = create_pretrain_state(SSLEncoder(TINY_MODEL, dim=DIM, dtype=torch.float64),
                                  make_optimizer("sgd", STEP_CASES[1]), hp, device="cpu")
    state.model.double()
    state.ema_model.double()
    state.queue, state.queue2 = state.queue.double(), state.queue2.double()
    load_pretrain_state_from_flax(state, tree)
    step = make_pretrain_step(hp, output_stride_of(TINY_MODEL))
    batch = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
             for k, v in pre_augmented_batch(0, batch=STEP_BATCH).items()}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a, **kw: self.double())
        state, _ = step(state, batch)
    return pretrain_state_to_flax(state)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _pretrain_argv(root, log_dir, *extra):
    return ["--run_id", "r", "--log_dir", str(log_dir), "--data_dirs", str(root / "frames"),
            "--config", str(root / "tiny_pretrain.py"), "--img_height", "32",
            "--img_width", "32", "--num-workers", "1", "--no-native_loader",
            "--pretrain_from_scratch", "--cap_queue", "--no-bf16", "-b", "8", "--epochs", "2",
            "--lr", "0.001", "--scalar-freq", "1", "--visual-freq", "0", *extra]


def _cli_jobs(root, out):
    """(name, CLI module, argv) of every CLI case; ``out`` roots its logs."""
    resume_dir = out / "pretrain" / "r"
    return [
        ("pretrain", "pretrain", _pretrain_argv(root, out / "pretrain", "--max_steps", "1")),
        ("pretrain_resume", "pretrain", _pretrain_argv(
            root, out / "pretrain", "--max_steps", "2", "--resume", str(resume_dir))),
        ("finetune", "finetune", [
            "--run_id", "r", "--log_dir", str(out / "finetune"),
            "--img_dirs", str(root / "pairs" / "images"),
            "--mask_dirs", str(root / "pairs" / "masks"), "--config", str(root / "tiny_seg.py"),
            "--img_height", "32", "--img_width", "32", "--batch_size", "4",
            "--num_workers", "1", "--no-native_loader", "--no-bf16", "--visualize_freq", "0",
            "--pretrain_type", "NONE", "--fast_dev_run"]),
        ("mirror", "mirror_pretrain", [
            "--run_id", "r", "--log_dir", str(out / "mirror"),
            "--data_dirs", str(root / "mirror_frames"), "--config", str(root / "tiny_seg.py"),
            "-x", "32", "-y", "32", "--batch-size", "4", "--num-workers", "1",
            "--no-native_loader", "--no-bf16", "--max_num_patches", "2", "--fast_dev_run"]),
        ("iter", "iter_train", [str(root / "tiny_iter.py"), "--work-dir", str(out / "iter")]),
    ]


def _run_cli(module, argv):
    import importlib

    cli = importlib.import_module(f"cp2_tpu_torch.train.{module}")
    result = cli.main(cli.get_args(argv), device="cpu")
    if module in ("pretrain", "mirror_pretrain"):
        from cp2_tpu_torch.checkpoint.io import state_payload

        return state_payload(result)
    return result


def _ranks(workdir):
    """One rank: every case in turn, in one gloo group; results pickled."""
    from pathlib import Path

    from cp2_tpu_torch import parallel

    workdir = Path(workdir)
    rank = int(os.environ["RANK"])
    assert parallel.initialize(backend="gloo")
    with open(workdir / "tree.pkl", "rb") as f:
        tree = pickle.load(f)
    rows = slice(rank * STEP_BATCH // WORLD, (rank + 1) * STEP_BATCH // WORLD)
    out = {"steps": {n: _cp2_steps(tree, n, rows) for n in STEP_CASES}}
    for name, module, argv in _cli_jobs(workdir / "data", workdir / "two"):
        out[name] = _run_cli(module, argv)
    parallel.shutdown()
    with open(workdir / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _write_data(root):
    from PIL import Image

    r = np.random.RandomState(0)

    def png(path, shape):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray((r.rand(*shape) * 255).astype(np.uint8)).save(path)

    for i in range(24):
        png(root / "frames" / f"train_img{i:02d}.png", (40, 48, 3))
    for split, count in (("train", 8), ("val", 3), ("test", 5)):
        for i in range(count):
            png(root / "pairs" / "images" / f"{split}_{i:02d}.png", (40, 48, 3))
            mask = r.randint(0, 2, (5, 6)).repeat(8, 0).repeat(8, 1) * 255
            (root / "pairs" / "masks").mkdir(parents=True, exist_ok=True)
            Image.fromarray(mask.astype(np.uint8), mode="L").save(
                root / "pairs" / "masks" / f"{split}_{i:02d}.png")
    for split, count in (("train", 8), ("val", 5)):
        names = [f"{split}_{i:02d}.png" for i in range(count)]
        for name in names:
            png(root / "mirror_frames" / name, (64, 64, 3))
        (root / "mirror_frames" / f"{split}.csv").write_text("\n".join(names) + "\n")
    for i in range(16):
        png(root / "iter" / "images" / f"im{i:02d}.png", (40, 40, 3))
        (root / "iter" / "masks").mkdir(parents=True, exist_ok=True)
        Image.fromarray((r.rand(40, 40) > 0.5).astype(np.uint8)).save(
            root / "iter" / "masks" / f"im{i:02d}.png")
    (root / "tiny_pretrain.py").write_text(TINY_PRETRAIN)
    (root / "tiny_seg.py").write_text(TINY_SEG)
    (root / "tiny_iter.py").write_text(f"""{TINY_ITER}
data = dict(
    train=dict(img_dir={str(root / 'iter' / 'images')!r},
               ann_dir={str(root / 'iter' / 'masks')!r}, img_size=32, batch_size=8),
    val=dict(img_dir={str(root / 'iter' / 'images')!r}, ann_dir={str(root / 'iter' / 'masks')!r}),
)
optimizer = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0)
lr_config = dict(policy="poly", power=0.9, min_lr=1e-4)
runner = dict(type="IterBasedRunner", max_iters=4)
checkpoint_config = dict(by_epoch=False, interval=2)
evaluation = dict(interval=2, metric="mIoU")
""")


def assembled_loader(world):
    """A ``HostDataLoader`` stand-in for one process: ``world`` shard
    loaders of ``batch_size / world`` rows each (``shard=(r, world)``),
    whose batches are concatenated in rank order, the global batches that
    ``world`` processes load."""
    from cp2_tpu_torch.data.host_loader import HostDataLoader

    class AssembledLoader:
        def __init__(self, source, batch_size, *, shard=(0, 1), **kw):
            assert shard == (0, 1)
            self.shards = [HostDataLoader(source, batch_size // world, shard=(r, world), **kw)
                           for r in range(world)]

        def __len__(self):
            return len(self.shards[0])

        def epoch_iterator(self, epoch=0):
            for parts in zip(*(s.epoch_iterator(epoch) for s in self.shards)):
                yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    return AssembledLoader


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, the JAX steps, and the one-process CLI runs
    on the assembled batches."""
    import test_torch_train_step as tts

    workdir = tmp_path_factory.mktemp("multiprocess")
    _write_data(workdir / "data")
    tree = tts._initial_tree()
    with open(workdir / "tree.pkl", "wb") as f:
        pickle.dump(tree, f)
    spawn_ranks(__file__, "_ranks", workdir, timeout=600)
    ranks = []
    for rank in range(WORLD):
        with open(workdir / f"out{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    jax_steps = {n: tts._jax_run(tree, [pre_augmented_batch(0, batch=STEP_BATCH)] * n, lr,
                                 False)[-1][0]
                 for n, lr in STEP_CASES.items()}
    one = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as patch:
            import cp2_tpu_torch.data as data

            patch.setattr(data, "HostDataLoader", assembled_loader(WORLD))
            for name, module, argv in _cli_jobs(workdir / "data", workdir / "one"):
                one[name] = _run_cli(module, argv)
    finally:
        torch.set_num_threads(threads)
    return {"dir": workdir, "tree": tree, "ranks": ranks, "jax": jax_steps, "one": one,
            "f64": _cp2_step_float64(tree)}


@pytest.mark.parametrize("n_steps", sorted(STEP_CASES))
def test_two_rank_cp2_step_matches_jax_on_the_global_batch(runs, n_steps):
    import test_torch_train_step as tts

    (state0, loss0), (state1, loss1) = (r["steps"][n_steps] for r in runs["ranks"])
    assert np.isfinite(loss0) and np.isfinite(loss1)
    ref, start, tol = runs["jax"][n_steps], runs["tree"], tts.TOL[n_steps]
    for name in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        assert_trees_close(state0[name], ref[name], tol, name)
    if n_steps == 1:
        exact = tts._delta(runs["f64"]["params"], start["params"])
        for name, params in (("two ranks", state0["params"]), ("JAX", ref["params"])):
            assert_trees_close(tts._delta(params, start["params"]), exact, UPDATE_TOL,
                               f"{name}: update")
    assert_close(state0["queue"], ref["queue"], tol, "queue")
    assert int(state0["queue_ptr"]) == int(ref["queue_ptr"]) == n_steps * STEP_BATCH
    assert int(state0["step"]) == int(ref["step"]) == n_steps
    _trees_equal(state0, state1)



def _trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k, v in a.items():
        if isinstance(v, dict):
            _trees_equal(v, b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]), err_msg=f"{path}/{k}")


def _flat(payload, prefix=""):
    out = {}
    if isinstance(payload, dict):
        for k, v in payload.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = payload
    return out


def _checkpoints_close(two_dir, one_dir):
    """The checkpoints of both runs: the same steps, every tensor within
    ``CLI_TOL`` and every number equal."""
    steps = sorted(d for d in os.listdir(two_dir) if d.isdigit())
    assert steps and steps == sorted(d for d in os.listdir(one_dir) if d.isdigit())
    for step in steps:
        ours = _flat(torch.load(os.path.join(two_dir, step, "state.pt"), weights_only=True))
        ref = _flat(torch.load(os.path.join(one_dir, step, "state.pt"), weights_only=True))
        assert set(ours) == set(ref)
        for key, value in ref.items():
            if isinstance(value, torch.Tensor) and value.is_floating_point():
                assert_close(ours[key].numpy(), value.numpy(), CLI_TOL, f"{step}{key}")
            elif isinstance(value, torch.Tensor):
                assert torch.equal(ours[key], value), key
            else:
                assert ours[key] == value, key
    return steps


def _metric_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "_time"} for line in f]


def _rows_close(two_dir, one_dir):
    ours, ref = _metric_rows(two_dir), _metric_rows(one_dir)
    assert [set(r) for r in ours] == [set(r) for r in ref]
    for row, ref_row in zip(ours, ref):
        for key, value in ref_row.items():
            if key == "epoch_time":  # the wall clock
                continue
            if isinstance(value, float):
                np.testing.assert_allclose(row[key], value, rtol=CLI_TOL, atol=CLI_TOL,
                                           err_msg=key)
            else:
                assert row[key] == value, key
    return ours


def _results_equal(a, b):
    """Equal bit for bit, but for wall-clock seconds."""
    fa, fb = ({k: v for k, v in _flat(x).items() if "seconds" not in k} for x in (a, b))
    assert set(fa) == set(fb)
    for key, value in fa.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, fb[key]), key
        else:
            assert value == fb[key] or (value != value and fb[key] != fb[key]), key


def test_pretrain_cli_two_processes_match_one(runs):
    """2 steps, then a ``--resume`` of 1: the checkpoints at steps 2 and 3
    (weights, BatchNorm statistics, EMA encoder, momentum, queue and its
    pointer advanced by the global batch), and every logged row: the step
    scalars (means over the ranks) and the epoch means (sums over the
    ranks)."""
    two = runs["dir"] / "two" / "pretrain" / "r"
    one = runs["dir"] / "one" / "pretrain" / "r"
    assert _checkpoints_close(two, one) == ["2", "3"]
    rows = _rows_close(two, one)
    assert sum("train/loss_step" in r for r in rows) == 3
    assert sum("train/loss" in r for r in rows) == 2
    final = [r["pretrain_resume"] for r in runs["ranks"]]
    assert final[0]["step"] == 3 and final[0]["queue_ptr"] == 3 * 8 % 24  # --cap_queue: 24
    _results_equal(*final)


def test_finetune_cli_two_processes_match_one(runs):
    """``--fast_dev_run``: rank 0 writes the one best checkpoint; both ranks
    restore it behind the barrier and report the same test metrics, which
    equal one process's."""
    two = runs["dir"] / "two" / "finetune" / "r"
    one = runs["dir"] / "one" / "finetune" / "r"
    assert len(_checkpoints_close(two, one)) == 1
    _rows_close(two, one)
    ours, theirs = (r["finetune"] for r in runs["ranks"])
    assert ours == theirs and "test_Dice" in ours
    for key, value in runs["one"]["finetune"].items():
        np.testing.assert_allclose(ours[key], value, rtol=CLI_TOL, atol=CLI_TOL, err_msg=key)


@pytest.mark.parametrize("cli", ["mirror", "iter"])
def test_mirror_and_iteration_clis_two_processes_match_one(runs, cli):
    two = runs["dir"] / "two" / cli
    one = runs["dir"] / "one" / cli
    if cli == "mirror":
        two, one = two / "r", one / "r"
        _rows_close(two, one)
    assert _checkpoints_close(two, one)
    _results_equal(*(r[cli] for r in runs["ranks"]))
    if cli == "iter":
        ours, ref = runs["ranks"][0]["iter"], runs["one"]["iter"]
        assert ours["iter"] == ref["iter"] == 4
        np.testing.assert_allclose(ours["final_eval"]["mIoU"], ref["final_eval"]["mIoU"],
                                   rtol=CLI_TOL, atol=CLI_TOL)
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=CLI_TOL)

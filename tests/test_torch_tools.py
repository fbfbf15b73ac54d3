"""The port's tools against the JAX package's, on the CPU.

* ``cp2_tpu_torch/tools/synthetic_corpus.py`` is a copy of
  ``tools/make_synthetic_dataset.py``: every sample version at seeds 0-3
  is bit-equal, and ``generate`` writes the same files.
* ``cp2_tpu_torch/tools/quality_gate.py`` takes the JAX gate's flags and
  writes its keys: a CPU run on a tiny config (the finetune structure on
  a ResNet-18 at width 8, injected through the CLIs' ``--config``) and a
  12/4/4 corpus at 32x32, one epoch each.
* ``tools/jax_to_torch_checkpoint.py`` turns a tiny JAX CP2 state, saved
  with ``cp2_tpu.checkpoint.save_checkpoint``, into a port run directory
  whose finetune graft equals the graft of ``checkpoint/bridge.py``'s
  output on the same tree, bit for bit.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

from _torch_port_common import TINY_MODEL, assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import make_synthetic_dataset as jax_corpus  # noqa: E402  (numpy and PIL only)

from cp2_tpu_torch.tools import synthetic_corpus  # noqa: E402

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


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_synthetic_corpus_is_bit_equal_to_the_jax_tool(version):
    for seed in range(4):
        ours = synthetic_corpus._SAMPLE_FNS[version](seed, 48)
        ref = jax_corpus._SAMPLE_FNS[version](seed, 48)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), (version, seed)


def test_synthetic_corpus_writes_the_same_files(tmp_path):
    for module, root in ((synthetic_corpus, tmp_path / "ours"), (jax_corpus, tmp_path / "ref")):
        module.generate(str(root), 24, {"train": 2, "val": 1, "test": 1}, seed=3, version=2)
        module.generate_unlabeled(str(root), 24, 2, seed=3, version=2)
    for sub in ("images", "masks", "unlabeled"):
        names = sorted(os.listdir(tmp_path / "ref" / sub))
        assert sorted(os.listdir(tmp_path / "ours" / sub)) == names
        for name in names:
            assert (tmp_path / "ours" / sub / name).read_bytes() == \
                (tmp_path / "ref" / sub / name).read_bytes(), (sub, name)


def _flags(path):
    """The ``--flags`` a tool's argparse parser declares, from its source."""
    tree = ast.parse(open(path).read())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
            and node.args and isinstance(node.args[0], ast.Constant)}


def test_quality_gate_takes_the_jax_flags():
    from cp2_tpu_torch.tools import quality_gate

    ours = _flags(quality_gate.__file__)
    assert ours == _flags(os.path.join(REPO, "tools", "quality_gate.py"))
    dry = quality_gate.main(["--dryrun", "--device", "cpu"])
    assert dry["dryrun"] and dry["pre_args"].pretrain_type.name == "CP2"


def test_quality_gate_runs_on_the_cpu_and_writes_the_jax_keys(tmp_path, monkeypatch):
    from cp2_tpu.ops import metrics as jax_metrics
    from cp2_tpu_torch.tools import quality_gate
    from cp2_tpu_torch.train import finetune, pretrain

    cfg = tmp_path / "cfgs"
    cfg.mkdir()
    (cfg / "tiny_pretrain.py").write_text(TINY_PRETRAIN)
    (cfg / "tiny_seg.py").write_text(TINY_SEG)
    for cli, name, workers in ((pretrain, "tiny_pretrain.py", "--num-workers"),
                               (finetune, "tiny_seg.py", "--num_workers")):
        monkeypatch.setattr(cli, "get_args", lambda argv, parse=cli.get_args, extra=(
            "--config", str(cfg / name), workers, "1", "--no-native_loader"): parse(
                [*argv, *extra]))
    # the corpus root's path carries no split name: FILENAME discovery
    # matches "train" anywhere in a pretrain file's path
    root = tmp_path / "corpus"
    out = tmp_path / "report"
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):  # see test_torch_finetune_cli.py
            results = quality_gate.main([
                "--root", str(root), "--size", "32", "--n_train", "12", "--n_val", "4",
                "--n_test", "4", "--img_size", "32", "--pretrain_epochs", "1",
                "--pretrain_batch", "4", "--finetune_epochs", "1", "--finetune_batch", "4",
                "--device", "cpu", "--log_dir", str(tmp_path / "logs"), "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    with open(out / "quality_gate.json") as f:
        written = json.load(f)
    assert set(written) == set(results) == {
        "config", "pretrain_seconds", "pretrain_ckpt", "pretrain_loss_first",
        "pretrain_loss_last", "finetune_cp2", "finetune_scratch", "dice_gain_over_scratch"}
    assert set(written["config"]) == {f.lstrip("-") for f in _flags(quality_gate.__file__)}
    test_keys = set(jax_metrics.compute_metrics(jax_metrics.ConfusionState.create(2),
                                                binary=True, prefix="test_"))
    for leg in ("finetune_cp2", "finetune_scratch"):
        assert set(written[leg]) == test_keys | {"test_loss", "seconds"}
        assert all(np.isfinite(v) for v in written[leg].values())
    assert np.isfinite(written["pretrain_loss_last"])
    assert written["pretrain_ckpt"].startswith(str(tmp_path / "logs"))


def test_converter_graft_equals_the_bridge(tmp_path):
    import jax
    import jax.numpy as jnp

    import test_torch_train_step as tts
    from cp2_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
    from cp2_tpu.ssl.state import PretrainState
    from cp2_tpu.ssl.train_step import make_optimizer
    from cp2_tpu_torch.checkpoint.bridge import flax_to_state_dict
    from cp2_tpu_torch.checkpoint.convert import load_pretrained_into_segmentor
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.train.finetune import load_any_checkpoint
    from cp2_tpu_torch.types import PretrainType
    from tools import jax_to_torch_checkpoint

    tree = tts._initial_tree()
    tree["queue_ptr"], tree["step"] = np.int32(6), np.int32(7)
    state = PretrainState(
        step=jnp.asarray(tree["step"]), params=tree["params"], batch_stats=tree["batch_stats"],
        ema_params=tree["ema_params"], ema_batch_stats=tree["ema_batch_stats"],
        opt_state=make_optimizer("sgd", 0.1).init(tree["params"]),
        queue=jnp.asarray(tree["queue"]), queue_ptr=jnp.asarray(tree["queue_ptr"]),
        queue2=jnp.asarray(tree["queue2"]), queue2_ptr=jnp.asarray(tree["queue2_ptr"]))
    jax_run = tmp_path / "jax_run"
    jax_save_checkpoint(str(jax_run), 7, jax.device_get(state), meta={
        "epoch": 3, "pretrain_type": "CP2", "backbone_type": "DEEPLABV3"})
    cfg = tmp_path / "tiny_model.py"
    cfg.write_text(f"model = {TINY_MODEL!r}\n")
    out = tmp_path / "port_run"
    path = jax_to_torch_checkpoint.convert(str(jax_run), str(out), str(cfg), img_hw=(64, 64))
    assert path == str(out / "7")

    # what the finetune CLI reads from the run directory, against the bridge
    ckpt_state, meta = load_any_checkpoint(path)
    assert (meta["epoch"], meta["pretrain_type"], meta["step"]) == (3, "CP2", 7)
    bridged = flax_to_state_dict(tree["params"], tree["batch_stats"])
    assert set(ckpt_state) == set(bridged)
    for key, value in bridged.items():
        assert torch.equal(ckpt_state[key], torch.as_tensor(value)), key
    seg_cfg = dict(TINY_MODEL, decode_head=dict(TINY_MODEL["decode_head"], contrast=False))
    segmentor = build_segmentor(seg_cfg).state_dict()
    ours, ours_report = load_pretrained_into_segmentor(segmentor, ckpt_state, meta,
                                                       PretrainType.CP2)
    ref, ref_report = load_pretrained_into_segmentor(segmentor, bridged, meta, PretrainType.CP2)
    assert {k: sorted(v) for k, v in ours_report.items()} == \
        {k: sorted(v) for k, v in ref_report.items()}
    assert ours_report["loaded"]
    for key, value in ref.items():
        assert torch.equal(ours[key], torch.as_tensor(value)), key

    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert (payload["queue_ptr"], payload["step"]) == (6, 7)
    assert_close(payload["queue"].numpy(), tree["queue"], 0.0, "queue")
    with open(out / "latest") as f:
        assert f.read() == "7"


def test_analyze_metrics_reads_the_ports_run_directories(tmp_path, capsys):
    """``tools/analyze_metrics.py`` (free of JAX) finds its default keys in
    the ``metrics.jsonl`` of a port pretrain run (``--debug``, CP2) and of a
    port finetune run (``--fast_dev_run``), both on the CPU."""
    from PIL import Image

    from cp2_tpu_torch.train import finetune, pretrain
    from tools import analyze_metrics

    r = np.random.RandomState(0)
    for d in ("pngs", "pairs/images", "pairs/masks"):
        (tmp_path / d).mkdir(parents=True)
    for i in range(24):
        Image.fromarray((r.rand(40, 48, 3) * 255).astype(np.uint8)).save(
            tmp_path / "pngs" / f"train_img{i:02d}.png")
    for split, count in {"train": 8, "val": 3, "test": 5}.items():
        for i in range(count):
            Image.fromarray((r.rand(40, 48, 3) * 255).astype(np.uint8)).save(
                tmp_path / "pairs" / "images" / f"{split}_{i:02d}.png")
            ids = r.randint(0, 2, (5, 6)).repeat(8, 0).repeat(8, 1) * 255
            Image.fromarray(ids.astype(np.uint8), mode="L").save(
                tmp_path / "pairs" / "masks" / f"{split}_{i:02d}.png")
    (tmp_path / "tiny_pretrain.py").write_text(TINY_PRETRAIN)
    (tmp_path / "tiny_seg.py").write_text(TINY_SEG)
    logs = tmp_path / "logs"
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):  # see test_torch_finetune_cli.py
            pretrain.main(pretrain.get_args([
                "--run_id", "pre", "--log_dir", str(logs), "--data_dirs", str(tmp_path / "pngs"),
                "--config", str(tmp_path / "tiny_pretrain.py"), "--img_height", "32",
                "--img_width", "32", "--num-workers", "1", "--pretrain_from_scratch",
                "--cap_queue", "--no-bf16", "--visual-freq", "0", "--debug"]), device="cpu")
            finetune.main(finetune.get_args([
                "--run_id", "ft", "--log_dir", str(logs),
                "--img_dirs", str(tmp_path / "pairs" / "images"),
                "--mask_dirs", str(tmp_path / "pairs" / "masks"),
                "--config", str(tmp_path / "tiny_seg.py"), "--img_height", "32",
                "--img_width", "32", "--batch_size", "4", "--num_workers", "1", "--no-bf16",
                "--visualize_freq", "0", "--pretrain_type", "NONE", "--fast_dev_run"]),
                device="cpu")
    finally:
        torch.set_num_threads(threads)
    capsys.readouterr()
    analyze_metrics.main([str(logs / "pre"), str(logs / "ft")])
    out = capsys.readouterr()
    assert "[warn]" not in out.err
    sections = dict(part.split(" ==\n", 1) for part in out.out.split("\n== ")[1:])
    found = {run: {line.split()[0] for line in body.splitlines() if line.strip()}
             for run, body in sections.items()}
    keys = analyze_metrics.DEFAULT_KEYS
    assert found["pre"] == {k for k in keys if k.startswith("train/")}
    assert found["ft"] == {k for k in keys if not k.startswith("train/")}

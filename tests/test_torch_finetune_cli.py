"""The port's finetune CLI, end to end on the CPU.

``main(args, device="cpu")`` runs the whole loop on a tiny config (the
finetune structure on a dilated ResNet-18 at width 8 under an ASPP-16
classifier) and a few PNG image/mask pairs of 40x48 whose stems carry
``train`` / ``val`` / ``test``: files → host loader → prefetch → on-device
co-augmentation → step → val with flips, pseudo-test → best checkpoint →
test on the best weights.

* polyp and lemon (12 classes, the resize geometry, the lemon augmentation
  and its val distortion; at 34x64 instead of 544x1024) with
  ``--fast_dev_run``, and polyp with ``--linear_evaluation``;
* from a CP2 checkpoint written by the port's pretrain CLI (``--debug``):
  the load report equals the JAX matrix's on the same weights (bridged);
* the metric keys are the ones JAX's ``compute_metrics`` names;
* save_top_k=1: of the best checkpoints saved, only the last remains;
* a load of zero tensors, and an orbax directory, are refused; with no card
  ``main()`` raises.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cp2_tpu.checkpoint import convert as jconvert
from cp2_tpu.ops import metrics as jm
from cp2_tpu.types import PretrainType as JaxPretrainType
from cp2_tpu_torch.checkpoint.bridge import flax_to_state_dict, state_dict_to_flax
from cp2_tpu_torch.train import finetune, pretrain

TINY_FINETUNE_CFG = """
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

# the same network with the CP2 contrast head, for the pretrain CLI
TINY_PRETRAIN_CFG = TINY_FINETUNE_CFG.replace(
    "dropout_ratio=0.1, num_classes=None,",
    "contrast=True, contrast_dim=128, num_classes=2,")

SPLITS = {"train": 8, "val": 3, "test": 5}


def _write_pairs(root, classes, r):
    from PIL import Image

    for d in ("images", "masks"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for split, count in SPLITS.items():
        for i in range(count):
            Image.fromarray((r.rand(40, 48, 3) * 255).astype(np.uint8)).save(
                root / "images" / f"{split}_{i:02d}.png")
            ids = r.randint(0, classes, (5, 6)).repeat(8, 0).repeat(8, 1)
            if classes == 2:
                ids = ids * 255  # binarised by the loader
            Image.fromarray(ids.astype(np.uint8), mode="L").save(
                root / "masks" / f"{split}_{i:02d}.png")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune")
    r = np.random.RandomState(0)
    _write_pairs(root / "polyp", 2, r)
    _write_pairs(root / "lemon", 12, r)
    cfg = tmp_path_factory.mktemp("cfg")
    (cfg / "tiny_finetune.py").write_text(TINY_FINETUNE_CFG)
    (cfg / "tiny_pretrain.py").write_text(TINY_PRETRAIN_CFG)
    return root, cfg


@pytest.fixture(autouse=True)
def no_onednn():
    """oneDNN off (its channels-last convolution backward corrupts the heap
    in this CPU build at the tiny networks' maps) and two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


def _args(data, log_dir, run_id, *extra, dataset="polyp"):
    root, cfg = data
    if dataset == "lemon":
        extra = ("--lemon_data", *extra)
    args = finetune.get_args([
        "--run_id", run_id, "--log_dir", str(log_dir),
        "--img_dirs", str(root / dataset / "images"),
        "--mask_dirs", str(root / dataset / "masks"),
        "--config", str(cfg / "tiny_finetune.py"), "--img_height", "32", "--img_width", "32",
        "--batch_size", "4", "--num_workers", "2", "--no-bf16", "--visualize_freq", "0",
        *extra])
    if dataset == "lemon":
        assert (args.img_height, args.img_width, args.num_classes) == (544, 1024, 12)
        args.img_height, args.img_width = 34, 64  # the lemon aspect, cut to size
    return args


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_keys(classes, prefix):
    binary = classes == 2
    return set(jm.compute_metrics(jm.ConfusionState.create(classes), binary=binary,
                                  ignore_index=None if binary else 0, prefix=prefix))


@pytest.mark.parametrize("case", ["polyp", "lemon", "polyp_linear_evaluation"])
def test_fast_dev_run(data, tmp_path, case):
    """Polyp also draws the overlay grid (``--visualize_freq 1``, where
    matplotlib is here); the linear evaluation times its steps
    (``--use_profiler``)."""
    dataset = case.split("_")[0]
    extra = ["--linear_evaluation", "--use_profiler"] if "linear" in case else []
    visual = case == "polyp" and importlib.util.find_spec("matplotlib") is not None
    if visual:
        extra.append("--visualize_freq=1")
    args = _args(data, tmp_path, "r", "--pretrain_type", "NONE", "--fast_dev_run", *extra,
                 dataset=dataset)
    assert args.epochs == 1
    classes = 12 if dataset == "lemon" else 2
    test_metrics = finetune.main(args, device="cpu")
    assert set(test_metrics) == _jax_keys(classes, "test_") | {"test_loss"}
    assert all(np.isfinite(v) for v in test_metrics.values())

    run_dir = os.path.join(str(tmp_path), "r")
    rows = _rows(run_dir)
    epoch = [r for r in rows if "epoch" in r]
    assert len(epoch) == 1
    want = (_jax_keys(classes, "train_") | _jax_keys(classes, "val_")
            | _jax_keys(classes, "pseudotest_")
            | {"train_loss", "epoch_time", "val_loss", "pseudotest_loss", "epoch"})
    assert set(epoch[0]) - {"_step", "_time"} == want
    assert epoch[0]["_step"] == 2  # --fast_dev_run: two train steps
    monitor = "val_BinaryJaccardIndex" if classes == 2 else "val_MulticlassJaccardIndex"
    steps = [d for d in os.listdir(run_dir) if d.isdigit()]
    assert steps == ["2"]
    with open(os.path.join(run_dir, "2", "meta.json")) as f:
        meta = json.load(f)
    assert meta[monitor] == epoch[0][monitor] and meta["pretrain_type"] == "NONE"
    assert rows[-1].keys() - {"_step", "_time"} == set(test_metrics)
    if visual:
        assert os.listdir(os.path.join(run_dir, "visuals")) == ["segmentations_epoch_0000.png"]
        assert any("Segmentations" in r for r in rows)
    if "linear" in case:
        with open(os.path.join(run_dir, "log-finetune.txt")) as f:
            assert "profiler summary: {'steps': 2" in f.read()


def test_best_checkpoint_kept_and_previous_deleted(data, tmp_path, monkeypatch):
    import cp2_tpu_torch.checkpoint as ckpt

    saved = []
    real = ckpt.save_checkpoint

    def recording(directory, step, state, meta=None, **kw):
        saved.append(real(directory, step, state, meta=meta, **kw))
        return saved[-1]

    monkeypatch.setattr(ckpt, "save_checkpoint", recording)
    args = _args(data, tmp_path, "best", "--pretrain_type", "RANDOM", "--epochs", "4",
                 "--learning_rate", "1e-2")
    finetune.main(args, device="cpu")
    assert len(saved) >= 2  # the val IoU rose at least once after epoch 0
    run_dir = os.path.join(str(tmp_path), "best")
    assert [d for d in os.listdir(run_dir) if d.isdigit()] == [os.path.basename(saved[-1])]
    rows = [r for r in _rows(run_dir) if "epoch" in r]
    with open(os.path.join(saved[-1], "meta.json")) as f:
        meta = json.load(f)
    assert meta["val_BinaryJaccardIndex"] == max(r["val_BinaryJaccardIndex"] for r in rows)


@pytest.fixture(scope="module")
def cp2_checkpoint(data, tmp_path_factory):
    """A CP2 checkpoint of the port's pretrain CLI (``--debug``, 3 steps) on
    the finetune images."""
    root, cfg = data
    log_dir = tmp_path_factory.mktemp("pretrain")
    args = pretrain.get_args([
        "--run_id", "cp2", "--log_dir", str(log_dir),
        "--data_dirs", str(root / "polyp" / "images"), "--config", str(cfg / "tiny_pretrain.py"),
        "--img_height", "32", "--img_width", "32", "--num-workers", "2", "--cap_queue",
        "--no-bf16", "--debug", "--visual-freq", "0", "-b", "4"])
    args.batch_size = 4  # --debug sets 8; the images hold 8 "train" stems
    pretrain.main(args, device="cpu")
    return os.path.join(str(log_dir), "cp2")


def test_loads_port_pretrain_checkpoint_as_jax_matrix(data, tmp_path, cp2_checkpoint,
                                                      monkeypatch):
    """The CLI's graft of the port's own CP2 checkpoint: a report equal to
    the JAX matrix's on the same weights, carried over by the bridge."""
    from cp2_tpu.models import build_segmentor as jax_build_segmentor
    import jax
    import jax.numpy as jnp

    from _torch_port_common import fill_variables, to_plain_dict
    from cp2_tpu_torch.checkpoint import convert
    from cp2_tpu_torch.config import Config

    reports = []
    real = convert.load_pretrained_into_segmentor

    def recording(target, state, meta, pt, **kw):
        merged, report = real(target, state, meta, pt, **kw)
        reports.append((target, state, meta, report))
        return merged, report

    monkeypatch.setattr(convert, "load_pretrained_into_segmentor", recording)
    args = _args(data, tmp_path, "ft", "--pretrain_type", "CP2", "--pretrain_path",
                 cp2_checkpoint, "--fast_dev_run")
    finetune.main(args, device="cpu")
    (target, state, meta, report), = reports
    assert meta["pretrain_type"] == "CP2" and len(report["loaded"]) > 0
    assert "decode_head.conv_seg.weight" in report["missing_in_source"]
    assert any(k.startswith("decode_head.contrast_conv") for k in
               report["skipped_missing_in_target"])

    # the same weights through the bridge into the JAX matrix
    cfg = dict(Config.fromfile(args.config).model)
    cfg["decode_head"] = dict(cfg["decode_head"], num_classes=2)
    model = jax_build_segmentor(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3)), train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    ck_params, ck_stats = state_dict_to_flax(state)
    _, ref = jconvert.load_pretrained_into_segmentor(
        {"params": params, "batch_stats": stats},
        {"params": ck_params, "batch_stats": ck_stats}, meta, JaxPretrainType.CP2)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    for key, names in ref.items():
        want = sorted(".".join(n.split("/")[:-1] + [leaf[n.split("/")[-1]]]) for n in names)
        assert sorted(report[key]) == want, key
    assert set(target) == set(flax_to_state_dict(to_plain_dict(params), to_plain_dict(stats)))


def test_refuses_zero_tensors_and_orbax_dirs(data, tmp_path):
    ckpt = tmp_path / "ckpt" / "3"
    ckpt.mkdir(parents=True)
    torch.save({"model": {"encoder.unrelated.weight": torch.zeros(3)}}, ckpt / "state.pt")
    (ckpt / "meta.json").write_text(json.dumps({"pretrain_type": "CP2"}))
    args = _args(data, tmp_path, "z", "--pretrain_type", "CP2", "--pretrain_path",
                 str(ckpt.parent), "--fast_dev_run")
    with pytest.raises(ValueError, match="ZERO tensors"):
        finetune.main(args, device="cpu")
    orbax = tmp_path / "orbax" / "5"
    (orbax / "state").mkdir(parents=True)
    (orbax / "meta.json").write_text("{}")
    args = _args(data, tmp_path, "o", "--pretrain_type", "CP2", "--pretrain_path", str(orbax),
                 "--fast_dev_run")
    with pytest.raises(ValueError, match="no orbax checkpoint"):
        finetune.main(args, device="cpu")


def test_main_without_a_card_raises(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(data, tmp_path, "cuda", "--pretrain_type", "NONE", "--fast_dev_run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(args)
    # a world of 2 with no rank or address cannot rendezvous: it raises,
    # it never finetunes alone in a run meant for two processes
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rendezvous"):
        finetune.main(args, device="cpu")

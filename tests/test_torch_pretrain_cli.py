"""The port's pretrain CLI, end to end on the CPU, and its host-side parts.

``main(args, device="cpu")`` runs the whole loop on a tiny config (ResNet-18
at widths 8, ASPP-16, contrast dim 128 because the CLI's queue is 128 wide)
and 24 PNGs of 40x48: files → host loader → prefetch → augmentation →
CP2 step (plain dense loss on CPU tensors) → metric sink → checkpoint, and
``--resume``.  The epoch mean is held to the mean of the step rows at
rtol 1e-5; a resumed run to the uninterrupted one bit for bit.  Every
other ``--pretrain_type`` runs the same way with ``--debug`` (MOCO, BYOL
and DENSECL on a tiny copy of ``config_moco.py``, the U-Nets at width 8),
PROPOSED with SAM region maps at ``<root>/SAM_Masks/<stem>.png``, and the
DenseCL family resumes bit for bit, ``queue2`` and the symmetric loss's
enqueue parity included.  The ``DevicePrefetcher`` and checkpoint cases
follow ``tests/test_prefetch.py`` and ``tests/test_checkpoint_io.py``.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_common import narrow_unet_backbones, torch_encoder, torchvision_name
from cp2_tpu_torch.checkpoint import (
    gc_checkpoints,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from cp2_tpu_torch.checkpoint.io import state_payload
from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice
from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state
from cp2_tpu_torch.ssl.train_step import epoch_scalar_names, make_optimizer
from cp2_tpu_torch.train import pretrain
from cp2_tpu_torch.types import PretrainType

TINY_PRETRAIN_CFG = """
norm_cfg = dict(type="BN", requires_grad=True)
model = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                  dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1), norm_cfg=norm_cfg,
                  contract_dilation=True),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                     contrast=True, contrast_dim=128, dilations=(1, 6), num_classes=2,
                     norm_cfg=norm_cfg),
    auxiliary_head=None,
)
"""

# config_moco.py at widths 8: plain-stride ResNet-18 under the identity FCN
# head; the projector's hidden width stays 2048, as in the JAX package
TINY_MOCO_CFG = """
norm_cfg = dict(type="BN", requires_grad=True)
model = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                  strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1), norm_cfg=norm_cfg),
    decode_head=dict(type="FCNHead", num_convs=0, concat_input=False, in_channels=64,
                     in_index=3, channels=64, num_classes=2, norm_cfg=norm_cfg),
    auxiliary_head=None,
)
"""

# the step keys of metrics_level 1 for CP2 (cp2_tpu/ssl/objectives.py:220-243)
CP2_STEP_KEYS = (
    ["train/loss_step", "train/loss_ins_step", "train/loss_dense_step", "train/acc_ins_step",
     "train/acc_seg_step", "train/cross_image_variance_source_step",
     "train/cross_image_variance_target_step", "step/average_iou",
     "step/average_masked_iou", "train/+ive_scores_step", "train/-ive_scores_step"]
    + [f"step/dense_per_sample_{s}_{side}_scores" for side in ("positive", "negative")
       for s in ("average", "lower", "median", "upper")]
    + [f"step/instance_{s}_scores" for s in ("average_positive", "average_negative",
                                             "lower_negative", "median_negative",
                                             "upper_negative")]
)


# ... and of the other variants (cp2_tpu/ssl/objectives.py:320-327,381-385,
# 515-576): MoCo's, BYOL's, and the DenseCL family's
INSTANCE_KEYS = [f"step/instance_{s}_scores" for s in (
    "average_positive", "average_negative", "lower_negative", "median_negative",
    "upper_negative")]
STEP_KEYS = {
    "MOCO": ["train/loss_step", "train/acc_ins_step"] + INSTANCE_KEYS,
    "BYOL": ["train/loss_step"],
    "DENSECL": ["train/loss_step", "train/loss_ins_step", "train/loss_dense_step",
                "step/cross_image_variance_source_step",
                "step/cross_image_variance_target_step", "step/average_iou",
                "step/non_zero_iou_ratio", "step/matching_positives_rate",
                "step/dense_average_positive_scores",
                "step/dense_average_negative_scores"] + INSTANCE_KEYS,
    "CP2": CP2_STEP_KEYS,
}
STEP_KEYS["PROPOSED_V2"] = STEP_KEYS["DENSECL"]
STEP_KEYS["PROPOSED"] = STEP_KEYS["CP2"]


def _write_pngs(directory, count, r, shape=(40, 48, 3)):
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    for i in range(count):
        Image.fromarray((r.rand(*shape) * 255).astype(np.uint8)).save(
            directory / f"train_img{i:02d}.png")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    _write_pngs(root, 24, np.random.RandomState(0))
    cfg = tmp_path_factory.mktemp("cfg") / "tiny_pretrain.py"  # not among the images
    cfg.write_text(TINY_PRETRAIN_CFG)
    (cfg.parent / "tiny_moco.py").write_text(TINY_MOCO_CFG)
    return str(root), str(cfg)


@pytest.fixture(scope="module")
def region_data(tmp_path_factory):
    """24 PNGs under ``<root>/images`` and their SAM region maps at
    ``<root>/SAM_Masks/<stem>.png``: 8-bit ids 0..8 in 8x8 blocks, 0 marking
    unknown regions (``cp2_tpu_torch/data/datasets.py:99-103``)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("regions")
    r = np.random.RandomState(1)
    _write_pngs(root / "images", 24, r)
    (root / "SAM_Masks").mkdir()
    for i in range(24):
        ids = r.randint(0, 9, (5, 6)).repeat(8, 0).repeat(8, 1).astype(np.uint8)
        Image.fromarray(ids, mode="L").save(root / "SAM_Masks" / f"train_img{i:02d}.png")
    return str(root / "images")


@pytest.fixture
def no_onednn():
    """oneDNN's channels-last convolution backward corrupts the heap in this
    CPU build at the 1x1 and 2x2 maps of the tiny plain-stride networks.
    Two threads besides: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


def _args(data, log_dir, run_id, *extra):
    images, cfg = data
    return pretrain.get_args([
        "--run_id", run_id, "--log_dir", str(log_dir), "--data_dirs", images,
        "--config", cfg, "--img_height", "32", "--img_width", "32",
        "--num-workers", "2", "--pretrain_from_scratch", "--cap_queue", "--no-bf16",
        *extra])


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_debug_run_logs_exact_epoch_means(data, tmp_path, monkeypatch):
    """At the default ``--visual-freq 1`` the epoch figures are written,
    with matplotlib unimportable (the port renders them with PIL)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = _args(data, tmp_path, "dbg", "--debug")
    assert args.batch_size == 8 and args.epochs == 1 and args.max_steps == 3
    state = pretrain.main(args, device="cpu")
    assert state.step == 3 and state.queue_ptr == 24 % state.queue.shape[0]

    run_dir = os.path.join(str(tmp_path), "dbg")
    rows = _rows(run_dir)
    step_rows = [row for row in rows if "train/loss_step" in row]
    assert len(step_rows) == 3  # --debug logs every step
    for row in step_rows:
        for key in CP2_STEP_KEYS:
            assert key in row and np.isfinite(row[key]), key
    epoch_rows = [row for row in rows if "train/loss" in row]
    assert len(epoch_rows) == 1
    np.testing.assert_allclose(epoch_rows[0]["train/loss"],
                               np.mean([r["train/loss_step"] for r in step_rows]), rtol=1e-5)
    for name in epoch_scalar_names(PretrainType.CP2):
        assert name in epoch_rows[0], name

    ckpt = latest_checkpoint(run_dir)
    assert ckpt is not None and ckpt.endswith(os.sep + "3")
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and meta["pretrain_type"] == "CP2" and meta["step"] == 3
    shown = os.listdir(os.path.join(run_dir, "visuals", "epoch_0000"))
    assert {"iou_histogram.png", "masked_iou_histogram.png", "similarity_heatmaps.png",
            "train_examples.png"} == set(shown)
    for name in shown:
        with Image.open(os.path.join(run_dir, "visuals", "epoch_0000", name)) as im:
            im.load()


def _flat_state(state):
    """Every saved tensor and number of a state, by name."""
    out = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = obj

    walk("", state_payload(state))
    return out


def test_resume_is_bit_exact(data, tmp_path):
    """2 steps, a checkpoint, a resumed run of 1 more step: the same bits as
    3 uninterrupted steps (params, BN buffers, EMA model, optimizer
    momentum, queue, queue_ptr, step).  Batch 12 on 24 frames makes 2 steps
    an epoch, and a resume starts at the next epoch, as in the JAX CLI."""
    common = ("-b", "12", "--epochs", "2", "--visual-freq", "0", "--seed", "3")
    whole = pretrain.main(_args(data, tmp_path / "whole", "r", *common, "--max_steps", "2"),
                          device="cpu")
    assert whole.step == 3
    first = pretrain.main(_args(data, tmp_path / "cut", "r", *common, "--max_steps", "1"),
                          device="cpu")
    assert first.step == 2 and first.queue_ptr == 0  # 24 keys into a queue of 24
    run_dir = str(tmp_path / "cut" / "r")
    assert latest_checkpoint(run_dir).endswith(os.sep + "2")
    resumed = pretrain.main(_args(data, tmp_path / "cut", "r", *common, "--max_steps", "2",
                                  "--resume", run_dir), device="cpu")
    assert resumed.step == 3 and resumed.queue_ptr == whole.queue_ptr == 12

    ours, ref = _flat_state(resumed), _flat_state(whole)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(ours[key], value), key
        else:
            assert ours[key] == value, key
    assert not torch.equal(resumed.queue, first.queue)  # the last step did run


@pytest.mark.parametrize("flag", [
    ("--pretrain_type", "MOCO", "--backbone_type", "UNET_TRUNCATED"),
    ("--negative_type", "HARD"), ("--lmbd_pixel_corr_weight", "2"),
    ("--imagenet_checkpoint", "resnet50.pth"), ("WORLD_SIZE", "2")])
def test_unported_options_raise(data, tmp_path, monkeypatch, flag):
    """Flag combinations the validation web refuses (MoCo on a U-Net, CP2
    with a negative type or correspondence weights) raise ``ValueError``,
    as in the JAX CLI; ``--imagenet_checkpoint`` is ported and reads its
    file, so a missing one raises ``FileNotFoundError``; a launch
    environment that names a world of 2 but no rank or address cannot
    rendezvous and raises ``ValueError``: the CLI never trains alone in a
    run meant for two processes."""
    if flag[0] == "WORLD_SIZE":
        monkeypatch.setenv(*flag)
        args = _args(data, tmp_path, "x")
    else:
        args = _args(data, tmp_path, "x", *flag)
        args.pretrain_from_scratch = False
        args.batch_size = 8  # the 24 files make 3 batches: the run gets to the load
    expected = {"--imagenet_checkpoint": FileNotFoundError}.get(flag[0], ValueError)
    with pytest.raises(expected):
        pretrain.main(args, device="cpu")


def test_imagenet_checkpoint_loads_into_both_encoders(data, tmp_path):
    """``--imagenet_checkpoint``: a torchvision-layout ResNet-18 (with ``fc``
    and ``num_batches_tracked``, which are ignored), made from seeded numpy,
    lands in the query encoder's backbone, parameters and BatchNorm
    statistics, and the EMA key encoder is a copy of it; the head keeps its
    initial weights (``cp2_tpu/train/pretrain.py:683-718``)."""
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.ssl import SSLEncoder

    model_cfg = dict(Config.fromfile(data[1]).model)
    hp = SSLHyperParams.for_variant(PretrainType.CP2, queue_len=24)
    state = create_pretrain_state(SSLEncoder(model_cfg), make_optimizer("sgd", 0.1), hp,
                                  seed=0, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    prefix = "encoder.backbone."
    r = np.random.RandomState(7)
    backbone = {k[len(prefix):]: v for k, v in before.items() if k.startswith(prefix)}
    wanted = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32))
              for k, v in backbone.items()}
    tv = {torchvision_name(k): v for k, v in wanted.items()}
    assert len(tv) == len(wanted)
    tv.update({"fc.weight": torch.zeros(10, 64), "fc.bias": torch.zeros(10),
               "bn1.num_batches_tracked": torch.tensor(5)})
    path = tmp_path / "resnet18.pth"
    torch.save({"state_dict": tv, "epoch": 90}, path)

    pretrain.load_imagenet_backbone(state, str(path))
    for model in (state.model, state.ema_model):
        sd = model.state_dict()
        for k, v in wanted.items():
            assert torch.equal(sd[prefix + k], v), k
        for k, v in before.items():
            if not k.startswith(prefix):
                assert torch.equal(sd[k], v), k


# --pretrain_type → extra flags (the repo's run scripts' own, cut to size).
# PROPOSED takes HARD, not neg_sampling_exp.sh's AVERAGE/MEDIAN: at 32x32
# its grid is 2x2, a sample may have no negative pair, and a mean or median
# of none is NaN, in the JAX package too (tests/test_torch_proposed.py holds
# every negative type at parity).  The encoder-only U-Net (OS 32) trains at
# 96x96, so that its grid has negatives to average.
VARIANT_FLAGS = {
    "PROPOSED": ("--negative_type", "HARD", "--negative_scale", "2"),
    "MOCO": ("--config", "tiny_moco.py"),
    "BYOL": ("--config", "tiny_moco.py"),
    "DENSECL": ("--config", "tiny_moco.py", "--lr", "1e-3"),
    "PROPOSED_V2": ("--use_symmetrical_loss", "--use_predictor", "--lmbd_coordinate", "0.5",
                    "--lmbd_cp2_dense_loss", "0.5", "--dense_logits_temp", "0.2",
                    "--instance_logits_temp", "0.2"),
    "UNET_TRUNCATED": ("--pretrain_type", "CP2", "--backbone_type", "UNET_TRUNCATED"),
    "UNET_ENCODER_ONLY": ("--pretrain_type", "CP2", "--backbone_type", "UNET_ENCODER_ONLY",
                          "--img_height", "96", "--img_width", "96"),
}
# (queue, queue2) keys enqueued per step
ENQUEUES = {"BYOL": (0, 0), "DENSECL": (1, 1), "PROPOSED_V2": (1, 1)}


def _variant_args(data, log_dir, run_id, name, *extra):
    flags = list(VARIANT_FLAGS[name])
    if "--config" in flags:  # next to the tiny pretrain config
        i = flags.index("--config") + 1
        flags[i] = os.path.join(os.path.dirname(data[1]), flags[i])
    if "--pretrain_type" not in flags:
        flags = ["--pretrain_type", name] + flags
    return _args(data, log_dir, run_id, *flags, *extra)


def _check_variant_run(state, run_dir, pt_name, steps, batch):
    pt = PretrainType[pt_name]
    e1, e2 = ENQUEUES.get(pt_name, (1, 0))
    k = state.queue.shape[0]
    assert state.step == steps
    assert (state.queue_ptr, state.queue2_ptr) == (e1 * steps * batch % k,
                                                   e2 * steps * batch % k)
    rows = _rows(run_dir)
    step_rows = [row for row in rows if "train/loss_step" in row]
    assert len(step_rows) == steps
    for row in step_rows:
        for key in STEP_KEYS[pt_name]:
            assert key in row and np.isfinite(row[key]), key
    epoch_rows = [row for row in rows if "train/loss" in row]
    assert len(epoch_rows) == 1
    for name in epoch_scalar_names(pt):
        assert np.isfinite(epoch_rows[0][name]), name
    np.testing.assert_allclose(epoch_rows[0]["train/loss"],
                               np.mean([r["train/loss_step"] for r in step_rows]), rtol=1e-5)


@pytest.mark.usefixtures("no_onednn")
@pytest.mark.parametrize("name", sorted(VARIANT_FLAGS))
def test_debug_run_of_every_variant(data, tmp_path, monkeypatch, name):
    """``--debug`` (batch 8, 3 steps, every step logged) of each pretrain
    type through ``main``: finite step metrics with the variant's keys, its
    epoch family, the queues as it enqueues, a checkpoint with its tags."""
    narrow_unet_backbones(monkeypatch)
    args = _variant_args(data, tmp_path, name, name, "--debug", "--visual-freq", "0")
    state = pretrain.main(args, device="cpu")
    run_dir = os.path.join(str(tmp_path), name)
    _check_variant_run(state, run_dir, args.pretrain_type.name, 3, 8)
    with open(os.path.join(latest_checkpoint(run_dir), "meta.json")) as f:
        meta = json.load(f)
    assert (meta["pretrain_type"], meta["backbone_type"]) == (
        args.pretrain_type.name, args.backbone_type.name)


@pytest.mark.usefixtures("no_onednn")
@pytest.mark.parametrize("native", [True, False], ids=["default_loader", "python_loader"])
def test_proposed_reads_region_maps(data, region_data, tmp_path, monkeypatch, native):
    """PROPOSED with ``scripts/proposed.sh``'s mapping and weights: the SAM
    maps reach the augmentation as ``region_maps`` (ids 0..8 at the frame
    size), whichever loader decodes them, and the run logs the PROPOSED
    step keys."""
    seen = []
    augment = pretrain.pretrain_batch_augment

    def spy(generator, raw, cfg):
        seen.append(raw["region_maps"])
        return augment(generator, raw, cfg)

    monkeypatch.setattr(pretrain, "pretrain_batch_augment", spy)
    args = _args((region_data, data[1]), tmp_path, "p", "--debug", "--visual-freq", "0",
                 "--pretrain_type", "PROPOSED", "--mapping_type", "PIXEL_REGION_ID",
                 "--lmbd_pixel_corr_weight", "10", "--lmbd_region_corr_weight", "1",
                 "--lmbd_not_corr_weight", "0",
                 *([] if native else ["--no-native_loader"]))
    state = pretrain.main(args, device="cpu")
    _check_variant_run(state, os.path.join(str(tmp_path), "p"), "PROPOSED", 3, 8)
    assert len(seen) == 3
    for maps in seen:
        assert tuple(maps.shape) == (8, 64, 64)
        values = set(torch.unique(maps).tolist())
        assert 0 in values and len(values) > 2 and values <= set(range(9)), values


@pytest.mark.usefixtures("no_onednn")
@pytest.mark.parametrize("name", ["DENSECL", "PROPOSED_V2"])
def test_dense_family_resume_is_bit_exact(data, tmp_path, name):
    """As ``test_resume_is_bit_exact``, for the DenseCL family: ``queue2``
    and its pointer carry over, and the symmetric loss (PROPOSED_V2)
    resumes at step 2, an even step, whose enqueue source is direction 2's
    keys; the resumed run equals 3 uninterrupted steps bit for bit."""
    common = ("-b", "12", "--epochs", "2", "--visual-freq", "0", "--seed", "3")
    whole = pretrain.main(_variant_args(data, tmp_path / "whole", "r", name, *common,
                                        "--max_steps", "2"), device="cpu")
    assert whole.step == 3 and whole.queue2_ptr == 12
    pretrain.main(_variant_args(data, tmp_path / "cut", "r", name, *common,
                                "--max_steps", "1"), device="cpu")
    run_dir = str(tmp_path / "cut" / "r")
    resumed = pretrain.main(_variant_args(data, tmp_path / "cut", "r", name, *common,
                                          "--max_steps", "2", "--resume", run_dir),
                            device="cpu")
    assert (resumed.step, resumed.queue_ptr, resumed.queue2_ptr) == (3, 12, 12)
    ours, ref = _flat_state(resumed), _flat_state(whole)
    assert set(ours) == set(ref) and "/queue2" in ref and "/queue2_ptr" in ref
    for key, value in ref.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(ours[key], value), key
        else:
            assert ours[key] == value, key


def test_default_device_is_the_card(data, tmp_path):
    """With no card, ``main`` on its default device raises; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would train on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main(_args(data, tmp_path, "x", "--debug"))


def test_steps_per_call_runs_every_step_once(data, tmp_path):
    """``--steps-per-call`` is accepted and changes nothing: quiet steps
    run one at a time, and ``--max_steps`` is met exactly."""
    state = pretrain.main(_args(data, tmp_path, "k", "--debug", "--visual-freq", "0",
                                "--steps-per-call", "4", "--max_steps", "1",
                                "--prefetch_depth", "0"), device="cpu")
    assert state.step == 2


# ---------------------------------------------------------------------------
# DevicePrefetcher (the cases of tests/test_prefetch.py) and HostToDevice
# ---------------------------------------------------------------------------

def test_prefetch_order_preserved_and_put_applied():
    assert list(DevicePrefetcher(range(20), lambda x: x * 2, depth=3)) == [
        x * 2 for x in range(20)]


def test_prefetch_exhaustion_stops_iteration_and_joins_thread():
    pf = DevicePrefetcher(range(3))
    assert list(pf) == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(pf)
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("where", ["iterator", "put"])
def test_prefetch_exceptions_propagate(where):
    def gen():
        yield 0
        yield 1
        if where == "iterator":
            raise RuntimeError("loader died")
        yield 2

    def put(x):
        if where == "put" and x == 2:
            raise RuntimeError("copy failed")
        return x

    got = []
    with pytest.raises(RuntimeError, match="died|failed"):
        for item in DevicePrefetcher(gen(), put, depth=1):
            got.append(item)
    assert got == [0, 1]


def test_prefetch_close_mid_stream_stops_worker_promptly():
    started = threading.Event()

    def slow_gen():
        for i in range(1000):
            started.set()
            yield i

    pf = DevicePrefetcher(slow_gen(), depth=2)
    started.wait(timeout=5)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_worker_overlaps_with_consumer():
    staged = []

    def put(x):
        staged.append(x)
        return x

    pf = DevicePrefetcher(range(10), put, depth=2)
    assert next(pf) == 0
    deadline = time.time() + 5
    while len(staged) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(staged) >= 3
    pf.close()


def test_prefetch_depth_validation():
    with pytest.raises(ValueError):
        DevicePrefetcher(range(3), depth=0)


def test_host_to_device_on_the_cpu():
    """On the CPU the stage wraps the arrays; ``wait()`` gives them back."""
    arrays = {"fg": np.arange(24, dtype=np.uint8).reshape(1, 2, 4, 3),
              "bg0": np.zeros((1, 2, 4, 3), np.uint8)}
    staged = HostToDevice("cpu")(arrays)
    out = staged.wait()
    assert set(out) == set(arrays)
    for k, v in arrays.items():
        assert out[k].dtype == torch.uint8 and np.array_equal(out[k].numpy(), v)


# ---------------------------------------------------------------------------
# checkpoints (the cases of tests/test_checkpoint_io.py)
# ---------------------------------------------------------------------------

def _state(seed):
    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=16, queue_len=8)
    state = create_pretrain_state(torch_encoder(), make_optimizer("sgd", 0.1), hp,
                                  seed=seed, device="cpu")
    state.step, state.queue_ptr = 7, 4
    # one optimizer step so the momentum buffers exist
    sum(p.sum() for p in state.model.parameters()).backward()
    state.optimizer.step()
    return state


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_save_restore_roundtrip(tmp_path, async_save):
    d = str(tmp_path / "ckpts")
    saved = _state(0)
    path = save_checkpoint(d, 7, saved, meta={"epoch": 3, "pretrain_type": "CP2"},
                           async_save=async_save)
    wait_for_checkpoints()
    restored, meta = restore_checkpoint(path, _state(1))  # other values, same structure
    ours, ref = _flat_state(restored), _flat_state(saved)
    for key, value in ref.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(ours[key], value), key
        else:
            assert ours[key] == value, key
    assert restored.step == 7 and restored.queue_ptr == 4
    assert meta["epoch"] == 3 and meta["pretrain_type"] == "CP2"


def test_latest_link_tracks_newest(tmp_path):
    d = str(tmp_path / "ckpts")
    state = _state(0)
    save_checkpoint(d, 10, state)
    p2 = save_checkpoint(d, 20, state)
    assert latest_checkpoint(d) == p2
    os.remove(os.path.join(d, "latest"))  # the scan finds it without the link
    assert latest_checkpoint(d) == p2


def test_latest_checkpoint_missing_dir(tmp_path):
    assert latest_checkpoint(str(tmp_path / "does-not-exist")) is None


def test_latest_skips_uncommitted_link(tmp_path):
    d = str(tmp_path / "ckpts")
    p1 = save_checkpoint(d, 10, _state(0))
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("20")  # a step whose state never landed
    assert latest_checkpoint(d) == p1


def test_gc_checkpoints(tmp_path):
    d = str(tmp_path / "ckpts")
    state = _state(0)
    for s in (10, 20, 30, 40, 50):
        save_checkpoint(d, s, state)
    assert gc_checkpoints(d, 0) == []  # keep_last 0 keeps everything
    assert gc_checkpoints(d, 2, keep_every=30, protect=[20]) == [10]
    assert latest_checkpoint(d).endswith(os.sep + "50")
    restored, _ = restore_checkpoint(latest_checkpoint(d), _state(1))
    assert restored.step == 7  # the payload is intact after the collection

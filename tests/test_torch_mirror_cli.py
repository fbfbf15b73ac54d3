"""The port's mirror (CutPaste) pretrain CLI, end to end on the CPU.

* ``get_args`` gives the JAX CLI's namespace (enums by name) for the
  defaults, ``--lemon_data``, and every ``MIRROR`` line that the scripts
  echo under ``CP2_SCRIPT_DRYRUN=1``.
* ``apply_prepare`` on the draws the JAX CLI's ``prepare``
  (``cp2_tpu/train/mirror_pretrain.py:229-247``, restated here from the
  JAX package's functions: it is a closure inside ``main``) makes on a key,
  replayed into the port's parameters, gives the JAX batch: images to 1e-5
  absolute (the crop's resampling sums its products in another order, as
  in ``tests/test_torch_augment.py``), masks and targets exactly.
* ``main(args, device="cpu")`` with ``--fast_dev_run`` for both variants
  on a tiny config (the finetune structure on a dilated ResNet-18 at width
  8 under an ASPP-16 classifier) and 64x64 PNGs listed by ``train.csv`` and
  ``val.csv``: the three train keys and ``val_loss_epoch`` in
  ``metrics.jsonl``, the checkpoint's meta ``pretrain_type`` MIRROR, and
  the port's finetune ``--pretrain_type MIRROR`` grafts it (the same load
  report as the JAX matrix's on the same weights).
* With no card ``main()`` raises.
"""

import json
import os
import shlex
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_split, replay_crop, replay_jax_cutpaste, replay_jitter
from cp2_tpu.augment import functional as JF
from cp2_tpu.augment.cutpaste import CutPasteConfig as JaxCutPasteConfig
from cp2_tpu.augment.cutpaste import cutpaste_batch as jax_cutpaste_batch
from cp2_tpu.train import mirror_pretrain as jmirror_pretrain
from cp2_tpu_torch.train import finetune, mirror_pretrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CFG = """
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


def _namespace(args):
    return {k: (v.name if hasattr(v, "name") else v) for k, v in vars(args).items()}


def _script_mirror_lines(tmp_path):
    env = dict(os.environ, CP2_SCRIPT_DRYRUN="1", LOG_DIR=str(tmp_path / "logs"))
    for d in ("data", "data2", "img", "mask", "ckpts"):
        (tmp_path / d).mkdir(exist_ok=True)
        env[{"data": "DATA_DIR", "data2": "DATA_DIR2", "img": "IMG_DIR", "mask": "MASK_DIR",
             "ckpts": "CKPT_DIR"}[d]] = str(tmp_path / d)
    lines = []
    for script in sorted(os.listdir(os.path.join(REPO, "scripts"))):
        if not script.endswith(".sh") or script in ("common.sh", "dist_train.sh"):
            continue
        out = subprocess.run(["bash", os.path.join(REPO, "scripts", script)], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (script, out.stderr)
        lines += [shlex.split(line.split("\t", 1)[1]) for line in out.stdout.splitlines()
                  if line.startswith("MIRROR\t")]
    return lines


def test_get_args_matches_jax(tmp_path):
    base = ["--run_id", "r", "--log_dir", str(tmp_path), "--data_dirs", "d"]
    argvs = [base, base + ["--lemon_data"], base + ["--fast_dev_run", "--variant", "NONE"]]
    scripted = _script_mirror_lines(tmp_path)
    assert len(scripted) >= 2  # polyp-cutpaste.sh and lemon-cutpaste.sh
    for argv in argvs + scripted:
        assert _namespace(mirror_pretrain.get_args(argv)) == _namespace(
            jmirror_pretrain.get_args(argv)), argv


def _jax_prepare(rng, frames, mirror_frames, hw, cfg, with_mirror):
    """``prepare`` of ``cp2_tpu/train/mirror_pretrain.py:229-247``."""
    k1, k2, k3 = jax.random.split(rng, 3)
    n = frames.shape[0]

    def base_view(key, img):
        img = img.astype(jnp.float32) / 255.0
        kc, kp = jax.random.split(key)
        crop = JF.sample_resized_crop(kc, img.shape[:2], (0.2, 1.0))
        view = JF.crop_resize_bilinear(img, crop, hw)
        return JF.color_jitter(kp, view, p=0.75)

    base = jax.vmap(base_view)(jax.random.split(k1, n), frames)
    mirrors = jax.vmap(base_view)(jax.random.split(k2, n), mirror_frames) if with_mirror else None
    return jax_cutpaste_batch(k3, base, mirrors, cfg)


def _replay_prepare(rng, n, src_hw, hw, cfg, with_mirror):
    k1, k2, k3 = jax.random.split(rng, 3)

    def view(key):
        k = jax_split(jax.random.split(key, n), 2)
        return mirror_pretrain.BaseViewParams(
            replay_crop(k[:, 0], src_hw, (0.2, 1.0), (3 / 4, 4 / 3), 0.5),
            replay_jitter(k[:, 1], (0.6, 1.4), (0.6, 1.4), (0.6, 1.4), (-0.1, 0.1), 0.75))

    return mirror_pretrain.PrepareParams(view(k1), view(k2) if with_mirror else None,
                                         replay_jax_cutpaste(k3, n, hw, cfg))


@pytest.mark.parametrize("variant", ["OUTPUT", "NONE"])
def test_prepare_on_jax_draws_matches_jax(variant):
    n, src_hw, hw = 6, (40, 48), (24, 32)
    cfg = JaxCutPasteConfig(num_classes=3, max_num_patches=2, max_rotation=40)
    r = np.random.RandomState(4)
    frames = r.randint(0, 256, (n, *src_hw, 3)).astype(np.uint8)
    mirrors = r.randint(0, 256, (n, *src_hw, 3)).astype(np.uint8)
    with_mirror = variant == "OUTPUT"
    rng = jax.random.PRNGKey(9)
    ref = _jax_prepare(rng, jnp.asarray(frames), jnp.asarray(mirrors), hw, cfg, with_mirror)
    params = _replay_prepare(rng, n, src_hw, hw, cfg, with_mirror)
    ours = mirror_pretrain.apply_prepare(torch.from_numpy(frames), torch.from_numpy(mirrors),
                                         params, hw)
    assert set(ours) == set(ref)
    for key in ("mask", "target"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in set(ref) - {"mask", "target"}:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    assert (ours["mask"] > 0).any() and params.base.jitter.apply.any()


@pytest.fixture(autouse=True)
def no_onednn():
    """oneDNN off (its channels-last convolution backward corrupts the heap
    in this CPU build at the tiny networks' maps) and two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """64x64 PNGs under ``frames/`` listed by ``train.csv`` (8) and
    ``val.csv`` (5: a padded val batch of 4), the tiny config, and finetune
    image/mask pairs of 40x48."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mirror")
    r = np.random.RandomState(0)
    frames = root / "frames"
    frames.mkdir()
    for split, count in (("train", 8), ("val", 5)):
        names = [f"{split}_{i:02d}.png" for i in range(count)]
        for name in names:
            Image.fromarray((r.rand(64, 64, 3) * 255).astype(np.uint8)).save(frames / name)
        (frames / f"{split}.csv").write_text("\n".join(names) + "\n")
    for d in ("images", "masks"):
        (root / "pairs" / d).mkdir(parents=True)
    for split, count in (("train", 8), ("val", 3), ("test", 5)):
        for i in range(count):
            Image.fromarray((r.rand(40, 48, 3) * 255).astype(np.uint8)).save(
                root / "pairs" / "images" / f"{split}_{i:02d}.png")
            mask = r.randint(0, 2, (5, 6)).repeat(8, 0).repeat(8, 1) * 255
            Image.fromarray(mask.astype(np.uint8), mode="L").save(
                root / "pairs" / "masks" / f"{split}_{i:02d}.png")
    (root / "tiny.py").write_text(TINY_CFG)
    return root


def _mirror_args(data, log_dir, run_id, *extra):
    return mirror_pretrain.get_args([
        "--run_id", run_id, "--log_dir", str(log_dir), "--data_dirs", str(data / "frames"),
        "--config", str(data / "tiny.py"), "-x", "32", "-y", "32", "--batch-size", "4",
        "--num-workers", "2", "--no-bf16", "--max_num_patches", "2", "--fast_dev_run", *extra])


@pytest.fixture(scope="module")
def mirror_runs(data, tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("mirror_logs")
    with torch.backends.mkldnn.flags(enabled=False):
        for variant in ("OUTPUT", "NONE"):
            mirror_pretrain.main(_mirror_args(data, log_dir, variant, "--variant", variant,
                                              "--use_profiler"), device="cpu")
    return log_dir


@pytest.mark.parametrize("variant", ["OUTPUT", "NONE"])
def test_fast_dev_run(mirror_runs, variant):
    run_dir = os.path.join(str(mirror_runs), variant)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    epoch = [r for r in rows if "epoch" in r]
    assert len(epoch) == 1
    assert set(epoch[0]) - {"_step", "_time"} == {
        "train_loss", "train_class_loss", "train_compare_loss", "val_loss_epoch", "epoch"}
    assert all(np.isfinite(v) for v in epoch[0].values())
    assert epoch[0]["_step"] == 2  # --fast_dev_run: two train steps
    assert (epoch[0]["train_compare_loss"] > 0) == (variant == "OUTPUT")
    steps = [d for d in os.listdir(run_dir) if d.isdigit()]
    assert steps == ["2"]
    with open(os.path.join(run_dir, "2", "meta.json")) as f:
        meta = json.load(f)
    assert meta["pretrain_type"] == "MIRROR" and meta["val_loss"] == epoch[0]["val_loss_epoch"]
    with open(os.path.join(run_dir, "log-mirror.txt")) as f:
        assert "profiler summary: {'steps': 2" in f.read()


def test_finetune_loads_the_mirror_checkpoint_as_jax_matrix(data, mirror_runs, tmp_path,
                                                            monkeypatch):
    """``--pretrain_type MIRROR`` grafts the mirror run's segmentor: every
    tensor but the classifier, the report the JAX matrix gives on the same
    weights carried over by the bridge."""
    from cp2_tpu.checkpoint import convert as jconvert
    from cp2_tpu.types import PretrainType as JaxPretrainType
    from cp2_tpu_torch.checkpoint import convert
    from cp2_tpu_torch.checkpoint.bridge import state_dict_to_flax

    reports = []
    real = convert.load_pretrained_into_segmentor

    def recording(target, state, meta, pt, **kw):
        merged, report = real(target, state, meta, pt, **kw)
        reports.append((target, state, meta, report))
        return merged, report

    monkeypatch.setattr(convert, "load_pretrained_into_segmentor", recording)
    args = finetune.get_args([
        "--run_id", "ft", "--log_dir", str(tmp_path),
        "--img_dirs", str(data / "pairs" / "images"), "--mask_dirs", str(data / "pairs" / "masks"),
        "--config", str(data / "tiny.py"), "--img_height", "32", "--img_width", "32",
        "--batch_size", "4", "--num_workers", "2", "--no-bf16", "--visualize_freq", "0",
        "--pretrain_type", "MIRROR", "--pretrain_path", os.path.join(str(mirror_runs), "OUTPUT"),
        "--fast_dev_run"])
    test_metrics = finetune.main(args, device="cpu")
    assert all(np.isfinite(v) for v in test_metrics.values())
    (target, state, meta, report), = reports
    assert meta["pretrain_type"] == "MIRROR"
    assert len(report["loaded"]) == len(target) - 2  # all but conv_seg's weight and bias
    ck_params, ck_stats = state_dict_to_flax(state)
    tg_params, tg_stats = state_dict_to_flax(target)
    _, ref = jconvert.load_pretrained_into_segmentor(
        {"params": tg_params, "batch_stats": tg_stats},
        {"params": ck_params, "batch_stats": ck_stats}, meta, JaxPretrainType.MIRROR)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    for key, names in ref.items():
        want = sorted(".".join(n.split("/")[:-1] + [leaf[n.split("/")[-1]]]) for n in names)
        assert sorted(report[key]) == want, key


def test_main_without_a_card_raises(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mirror_pretrain.main(_mirror_args(data, tmp_path, "card"))

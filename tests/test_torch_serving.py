"""The port's serving export, on the CPU: ``torch.export`` artifacts round
trip to the live inference module, and hold JAX's inference function.

The five cases of ``tests/test_serving.py`` on the port, with its
``TINY_SEG`` at 32x32 and float32: a whole-mode class map at batch 2
equal to the live module's; a symbolic batch (traced at 2 under
``Dim("b", min=1)``) checked at batches 1 and 3; slide-mode logits within
1e-5 of the live module's (``tests/test_serving.py``'s tolerance); slide
with a symbolic batch refused; a checkpoint's weights embedded (the
artifact follows a perturbed checkpoint and differs from the unperturbed
weights).  Then the artifact's logits against JAX's ``make_inference_fn``
on the same weights (bridged into one of the port's checkpoints): rtol
1e-5 with an absolute floor of 1e-5 of the largest logit, the eval
forward's tolerance, and the class maps equal; and ``main`` with
``--selftest``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import assert_close, fill_variables
from cp2_tpu import serving as jserving
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu_torch import serving
from cp2_tpu_torch.checkpoint import save_checkpoint
from cp2_tpu_torch.checkpoint.bridge import load_flax_into
from cp2_tpu_torch.train import segmentation_task as task
from cp2_tpu_torch.train.inference import init_segmentor
from tests.test_finetune_task import HW, TINY_SEG


def _rand_batch(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (n, HW, HW, 3),
                                                                 np.uint8))


def _live(checkpoint=None, **kw):
    model = init_segmentor(TINY_SEG, checkpoint, num_classes=2, device="cpu")
    return serving.make_inference_fn(model, **kw)


def _run(module, x):
    with torch.no_grad():
        return module(x)


def test_export_roundtrip_whole(tmp_path):
    out = str(tmp_path / "tiny.pt2")
    _, meta = serving.export_segmentor(TINY_SEG, None, out, img_hw=(HW, HW), batch_size=2,
                                       num_classes=2, bf16=False, device="cpu")
    assert meta["bytes"] > 0 and meta["mode"] == "whole" and meta["platforms"] == ["cpu"]
    with open(out + ".json") as f:
        assert json.load(f)["returns"] == "class_map"
    x = _rand_batch(2)
    got = _run(serving.load_exported(out), x)
    assert got.shape == (2, HW, HW) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _run(_live(), x).numpy())


def test_export_symbolic_batch(tmp_path):
    out = str(tmp_path / "tiny_b.pt2")
    _, meta = serving.export_segmentor(TINY_SEG, None, out, img_hw=(HW, HW), batch_size=None,
                                       num_classes=2, bf16=False, device="cpu")
    assert meta["batch_size"] is None
    art, live = serving.load_exported(out), _live()
    for n in (1, 3):
        x = _rand_batch(n, seed=n)
        np.testing.assert_array_equal(_run(art, x).numpy(), _run(live, x).numpy())


def test_export_slide_logits(tmp_path):
    out = str(tmp_path / "tiny_slide.pt2")
    crop, stride = (HW // 2, HW // 2), (HW // 4, HW // 4)
    _, meta = serving.export_segmentor(TINY_SEG, None, out, img_hw=(HW, HW), batch_size=1,
                                       mode="slide", num_classes=2, crop_size=crop,
                                       stride=stride, bf16=False, return_logits=True,
                                       device="cpu")
    assert meta["crop_size"] == list(crop)
    x = _rand_batch(1)
    got = _run(serving.load_exported(out), x)
    want = _run(_live(mode="slide", num_classes=2, crop_size=crop, stride=stride,
                      return_logits=True), x)
    assert got.shape == (1, HW, HW, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_symbolic_batch_rejects_slide():
    with pytest.raises(ValueError, match="symbolic batch"):
        serving.export_segmentor(TINY_SEG, None, None, img_hw=(HW, HW), batch_size=None,
                                 mode="slide", device="cpu")


def _checkpoint(model, directory, step):
    state = task.create_seg_state(model, task.make_adam(1e-4, 1e-4), "cpu")
    return save_checkpoint(str(directory), step, state, meta={"pretrain_type": "NONE"})


def test_export_embeds_checkpoint_weights(tmp_path):
    model = init_segmentor(TINY_SEG, num_classes=2, device="cpu")
    with torch.no_grad():  # perturb one kernel so the checkpointed model is distinguishable
        model.backbone.conv1.conv.weight.add_(0.5)
    path = _checkpoint(model, tmp_path / "ckpt", 7)
    out = str(tmp_path / "tiny_ckpt.pt2")
    serving.export_segmentor(TINY_SEG, path, out, img_hw=(HW, HW), batch_size=1,
                             num_classes=2, bf16=False, return_logits=True, device="cpu")
    x = _rand_batch(1)
    got = _run(serving.load_exported(out), x).numpy()
    np.testing.assert_allclose(got, _run(_live(path, return_logits=True), x).numpy(),
                               rtol=1e-5, atol=1e-5)
    base = _run(_live(return_logits=True), x).numpy()
    assert np.abs(got - base).max() > 1e-3


def test_exported_logits_match_jax_on_bridged_weights(tmp_path):
    jmodel = jax_build_segmentor(TINY_SEG)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, HW, HW, 3)), train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(1))
    model = init_segmentor(TINY_SEG, num_classes=2, device="cpu")
    load_flax_into(model, params, stats)
    path = _checkpoint(model, tmp_path / "bridged", 3)
    out = str(tmp_path / "bridged.pt2")
    serving.export_segmentor(TINY_SEG, path, out, img_hw=(HW, HW), batch_size=2,
                             num_classes=2, bf16=False, return_logits=True, device="cpu")
    x = _rand_batch(2, seed=5)
    got = _run(serving.load_exported(out), x).numpy()
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(jserving.make_inference_fn(jmodel, variables, return_logits=True))(x.numpy())
    assert_close(got, np.asarray(want), 1e-5, "exported logits against JAX")
    classes = jax.jit(jserving.make_inference_fn(jmodel, variables))(x.numpy())
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(classes))


def test_main_selftest(tmp_path, capsys):
    """The CLI with ``--selftest``: a symbolic-batch export of a config file,
    loaded and held to the live module at a batch of 2."""
    config = tmp_path / "tiny_seg.py"
    config.write_text(f"model = {TINY_SEG!r}\n")
    meta = serving.main(["--config", str(config), "--out", str(tmp_path / "cli.pt2"),
                         "--hw", str(HW), "--batch", "0", "--f32", "--selftest"], device="cpu")
    assert meta["batch_size"] is None and meta["bf16"] is False
    assert "selftest OK" in capsys.readouterr().out


def test_cli_flags_match_jax(capsys):
    """``python -m cp2_tpu_torch.serving`` takes exactly the JAX CLI's flags."""
    import re

    flags = []
    for main in (serving.main, jserving.main):
        with pytest.raises(SystemExit):
            main(["--help"])
        flags.append(set(re.findall(r"(?<![\w-])--?[a-z][\w-]*", capsys.readouterr().out)))
    assert flags[0] == flags[1] and {"--selftest", "--slide-crop", "--batch"} <= flags[0]

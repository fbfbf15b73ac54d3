"""The port's iteration CLI (``cp2_tpu_torch/train/iter_train.py``) against
``tools/train.py``, on the CPU.

* ``get_args`` parses as the JAX CLI's, and ``poly_lr`` equals its schedule
  (float32 on both sides, rtol 1e-6: XLA's and numpy's float32 ``pow`` may
  part by an ulp).
* One SGD step and one Adam step of ``tests/test_iter_train_cli.py``'s tiny
  config (ResNet-18 at width 8 under ASPP-16, 32², batch 4, dropout off so
  both sides draw no mask) against JAX's ``make_seg_steps`` with the CLI's
  optax chain, from the same numpy weights: the loss at 1e-5, the momentum
  trace (the step's gradient plus decay) at 5e-5 of its largest element,
  and the parameters at 1e-5 — the tolerances of
  ``tests/test_torch_segmentation_task.py``, whose docstring gives the
  reason for 5e-5 on gradients through train-mode BatchNorm.  Adam's first
  step is ``lr·g/(|g| + eps)``, which for a gradient near eps follows the
  gradient's last digits (23 of 195050 elements part by more than 1e-5 at
  this seed).  So the test holds the first moment (0.1·g) at 5e-5, every
  parameter within 2·lr of JAX's, and the difference of the two sides'
  parameters to the difference of their Adam steps on their own moments,
  at 1e-5 of the parameter's largest element.
* The CLI end to end (16 PNG pairs of 40², ``main(args, device="cpu")``):
  checkpoints at the interval and at ``max_iters``, the eval log and keys;
  ``--resume-from`` continuing bit for bit as the uninterrupted run;
  ``--load-from`` carrying the weights and nothing else; and the default
  device refusing to run without a card.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from _torch_port_common import assert_close, assert_trees_close, fill_variables, to_plain_dict
from cp2_tpu.models import build_segmentor as jax_build_segmentor
from cp2_tpu.ops.metrics import ConfusionState as JaxConfusion
from cp2_tpu.train import segmentation_task as jtask
from cp2_tpu_torch.checkpoint.bridge import load_flax_into, state_dict_to_flax
from cp2_tpu_torch.models import build_segmentor
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.train import iter_train
from cp2_tpu_torch.train import segmentation_task as task

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import train as jax_cli  # noqa: E402  (get_args / poly_lr import no JAX)

RTOL = 1e-5
GRAD_TOL = 5e-5
HW = 32
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4

NORM = dict(type="BN", requires_grad=True)
TINY_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1),
                  norm_cfg=NORM, contract_dilation=True),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                     dilations=(1, 6), num_classes=2, norm_cfg=NORM),
    auxiliary_head=None,
    train_cfg=dict(),
    test_cfg=dict(mode="whole"),
)


class TwoPassBatchNorm(nn.BatchNorm):
    use_fast_variance: bool = False


@pytest.fixture(autouse=True, scope="module")
def numerics():
    """oneDNN off and two threads for the port, two-pass BatchNorm variance
    for flax (see ``tests/test_torch_segmentation_task.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as patch:
        patch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", [
    ["cfg.py"],
    ["cfg.py", "--work-dir", "/w", "--seed", "3", "--no-validate"],
    ["cfg.py", "--resume-from", "/w/2", "--load-from", "/w/1"],
])
def test_get_args_matches_jax(argv):
    assert vars(iter_train.get_args(argv)) == vars(jax_cli.get_args(argv))


def test_poly_lr_matches_jax():
    ours = iter_train.poly_lr(0.003, 40, 0.9, 1e-4)
    ref = jax_cli.poly_lr(0.003, 40, 0.9, 1e-4)
    for step in (0, 1, 7, 20, 39, 40, 55):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(ours(step), want, rtol=1e-6, err_msg=str(step))
    assert ours(40) == pytest.approx(1e-4)  # the floor at and past max_iters


def _step_model():
    cfg = dict(TINY_MODEL, decode_head=dict(TINY_MODEL["decode_head"], dropout_ratio=0.0))
    model = jax_build_segmentor(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, HW, HW, 3)), train=False))
    params, stats = fill_variables(shapes, np.random.RandomState(0))
    return cfg, model, params, stats


def _batch(n=4, seed=0):
    """uint8 images of differing brightness (the image-pool BatchNorm
    normalises per-image means over the batch), blocky two-class masks;
    the images are float /255 as both CLIs make them."""
    r = np.random.RandomState(seed)
    img = r.rand(n, HW, HW, 3) * r.uniform(0.2, 1.0, (n, 1, 1, 3)) + r.uniform(0, 0.5, (n, 1, 1, 3))
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    mask = r.randint(0, 2, (n, HW // 8, HW // 8)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    return {"image": img.astype(np.float32) / 255.0, "mask": mask}


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_one_step_matches_jax(opt):
    cfg, model, params, stats = _step_model()
    batch = _batch()
    sched = iter_train.poly_lr(LR, 3, 0.9, 1e-4)
    jsched = jax_cli.poly_lr(LR, 3, 0.9, 1e-4)
    if opt == "SGD":
        tx = optax.chain(optax.add_decayed_weights(WD), optax.sgd(jsched, momentum=MOMENTUM))
        port_tx = task.make_sgd(sched(0), MOMENTUM, WD)
    else:
        tx = optax.adam(jsched)
        port_tx = task.make_adam(sched(0), 0.0)
    step, _, _ = jtask.make_seg_steps(model, tx, 2, (HW, HW))
    jstate = jtask.SegTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=stats, opt_state=tx.init(params))
    new, _, m = jax.jit(step)(jstate, batch, jax.random.PRNGKey(0), JaxConfusion.create(2))

    port = build_segmentor(cfg)
    load_flax_into(port, params, stats)
    state = task.create_seg_state(port, port_tx, "cpu")
    task.set_learning_rate(state.optimizer, sched(state.step))
    train_step, _, _ = task.make_seg_steps(2, (HW, HW))
    state, _, ours = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(0), ConfusionState.create(2))
    assert_close(ours["loss"].numpy(), np.asarray(m["loss"]), RTOL, "loss")
    got, got_stats = state_dict_to_flax(state.model.state_dict())
    assert_trees_close(got_stats, to_plain_dict(new.batch_stats), RTOL, "stats")
    ref = to_plain_dict(new.params)
    if opt == "SGD":
        assert_trees_close(got, ref, RTOL, "params")
        trace, _ = state_dict_to_flax({
            n: state.optimizer.state[p]["momentum_buffer"]
            for n, p in state.model.named_parameters()})
        assert_trees_close(trace, to_plain_dict(new.opt_state[1][0].trace), GRAD_TOL, "trace")
        return
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        moments[key], _ = state_dict_to_flax({n: state.optimizer.state[p][key]
                                              for n, p in state.model.named_parameters()})
    adam = new.opt_state[0]
    ref_mu, ref_nu = to_plain_dict(adam.mu), to_plain_dict(adam.nu)
    assert_trees_close(moments["exp_avg"], ref_mu, GRAD_TOL, "first moment")
    lr0 = sched(0)
    for path, want in _leaves(ref):
        have = _leaf(got, path)
        assert np.abs(have - want).max() <= 2 * lr0 + RTOL * np.abs(want).max(), path
        # the parameters part by the difference of the two sides' first
        # Adam steps, each on its own gradient: lr·(u_jax − u_port)
        u_port = _adam_direction(_leaf(moments["exp_avg"], path),
                                 _leaf(moments["exp_avg_sq"], path))
        u_jax = _adam_direction(_leaf(ref_mu, path), _leaf(ref_nu, path))
        np.testing.assert_allclose(have - want, lr0 * (u_jax - u_port), rtol=0,
                                   atol=RTOL * np.abs(want).max(), err_msg="/".join(path))


def _adam_direction(mu, nu, eps=1e-8):
    """The first step's ``m̂ / (sqrt(v̂) + eps)``, float64."""
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    return (mu / 0.1) / (np.sqrt(nu / 0.001) + eps)


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


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """16 (image, mask) PNG pairs of 40², as ``tests/test_iter_train_cli.py``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("iter")
    img_dir, ann_dir = root / "images", root / "masks"
    img_dir.mkdir()
    ann_dir.mkdir()
    r = np.random.RandomState(0)
    for i in range(16):
        Image.fromarray((r.rand(40, 40, 3) * 255).astype(np.uint8)).save(img_dir / f"im{i:02d}.png")
        Image.fromarray((r.rand(40, 40) > 0.5).astype(np.uint8)).save(ann_dir / f"im{i:02d}.png")
    return root


def _config(root, max_iters, interval=2):
    text = f"""
norm_cfg = dict(type="BN", requires_grad=True)
model = {TINY_MODEL!r}
data = dict(
    train=dict(img_dir={str(root / 'images')!r}, ann_dir={str(root / 'masks')!r},
               img_size=32, batch_size=8),
    val=dict(img_dir={str(root / 'images')!r}, ann_dir={str(root / 'masks')!r}),
)
optimizer = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0)
lr_config = dict(policy="poly", power=0.9, min_lr=1e-4)
runner = dict(type="IterBasedRunner", max_iters={max_iters})
checkpoint_config = dict(by_epoch=False, interval={interval})
evaluation = dict(interval={interval}, metric="mIoU")
"""
    path = root / f"cfg_{max_iters}_{interval}.py"
    path.write_text(text)
    return str(path)


def _run(argv):
    return iter_train.main(iter_train.get_args(argv), device="cpu")


def _weights(ckpt):
    return torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)


def test_cli_end_to_end(tree, tmp_path):
    work = tmp_path / "work"
    out = _run([_config(tree, 3), "--work-dir", str(work), "--seed", "0"])
    assert sorted(int(d) for d in os.listdir(work) if d.isdigit()) == [2, 3]
    with open(work / "3" / "meta.json") as f:
        assert json.load(f)["iter"] == 3
    assert out["iter"] == 3 and np.isfinite(out["loss"])
    assert set(out["final_eval"]) == {"aAcc", "IoU", "Acc", "mIoU"}
    assert len(out["final_eval"]["IoU"]) == 2
    text = (work / "log-train.txt").read_text()
    assert "eval@2" in text and "final eval" in text and "mIoU" in text


def test_resume_continues_as_the_uninterrupted_run(tree, tmp_path):
    """Five iterations straight, against two then a resume from the
    iteration-2 checkpoint: the iteration, the rate, the momentum and the
    data order carry, and the iteration-5 weights agree bit for bit."""
    cfg = _config(tree, 5)
    straight = tmp_path / "straight"
    _run([cfg, "--work-dir", str(straight), "--no-validate"])
    resumed = tmp_path / "resumed"
    _run([cfg, "--work-dir", str(resumed), "--no-validate",
          "--resume-from", str(straight / "2")])
    assert sorted(int(d) for d in os.listdir(resumed) if d.isdigit()) == [4, 5]
    a, b = _weights(straight / "5"), _weights(resumed / "5")
    assert a["step"] == b["step"] == 5
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0, msg=k)
    sched = iter_train.poly_lr(0.01, 5)
    assert b["optimizer"]["param_groups"][0]["lr"] == pytest.approx(sched(4))
    for k, v in a["optimizer"]["state"].items():
        torch.testing.assert_close(b["optimizer"]["state"][k]["momentum_buffer"],
                                   v["momentum_buffer"], rtol=0, atol=0)


def test_load_from_carries_the_weights_only(tree, tmp_path):
    """From iteration 2's weights a one-iteration run starts a fresh
    optimizer at iteration 0: its step count is 1, its momentum is that
    one step's gradient, and its weights are the loaded ones moved by it."""
    first = tmp_path / "first"
    _run([_config(tree, 2), "--work-dir", str(first), "--no-validate"])
    loaded = tmp_path / "loaded"
    _run([_config(tree, 1, interval=1), "--work-dir", str(loaded), "--no-validate",
          "--load-from", str(first / "2")])
    src, out = _weights(first / "2"), _weights(loaded / "1")
    assert out["step"] == 1
    lr0 = iter_train.poly_lr(0.01, 1)(0)
    names = [n for n, _ in build_segmentor(TINY_MODEL).named_parameters()]
    for i, name in enumerate(names):
        buf = out["optimizer"]["state"][i]["momentum_buffer"]
        torch.testing.assert_close(out["model"][name], src["model"][name] - lr0 * buf,
                                   rtol=1e-6, atol=1e-7, msg=name)


def test_default_device_raises_without_a_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iter_train.main(iter_train.get_args([_config(tree, 1)]))

"""Train-mode BatchNorm over the global batch of two processes, on the CPU.

With a process group of more than one rank, ``models/layers.BatchNorm``
reduces its statistics over the ranks, as flax's BatchNorm under the JAX
package's global-view ``jit`` takes them over the global batch.  Two gloo
processes, each holding half of a batch drawn with numpy, are held against
one process on the whole batch:

* the output, the running statistics, and the input and parameter
  gradients of ``mean(y · G)`` (G a fixed random tensor) after
  ``pmean_gradients``, for a conv-shaped input, the (N, C) input of BYOL's
  MLP and the (N, C, 1, 1) input of the ASPP image-pool branch, with means
  far from zero (mean²/var ~ 25, where a one-pass variance would lose
  digits): 1e-6 of the largest element, float32 rounding of two
  reductions in another order.  A rank's input gradient is the gradient of
  the sum of both ranks' losses (the all-reduce's backward sums the
  statistics' gradients), so it is held at W times the one-process
  gradient of the mean;
* a width-8 ResNet-18 with ``with_cp`` (every block recomputed in the
  backward, its BatchNorms reducing again in the same order on both ranks):
  bit-equal to the plain network in the same two ranks, and against the
  plain network in one process at 1e-5 of the largest element: its eleven
  train-mode BatchNorms amplify the rounding difference of the two
  reductions (measured 2.7e-6 at the output and 3.3e-6 in the gradients at
  64x64, batch 4; at 32x32, where the last stage normalises 4 values a
  channel, 5.3e-6 and 6.0e-5);
* the two ranks' outputs against flax ``nn.BatchNorm`` on the global batch
  (its two-pass variance, as ``tests/test_torch_train_step.py`` takes it):
  1e-6;
* the one-process path, the frozen path and the eval path bit-equal to the
  module as it was before the global path existed (an inline copy).

One pair of processes computes every case (``_ranks``).
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_common import spawn_ranks
from cp2_tpu_torch import parallel
from cp2_tpu_torch.models.layers import BatchNorm, init_flax_like_

WORLD = 2
CASES = {"conv": (4, 3, 5, 6), "mlp": (8, 6), "image_pool": (4, 5, 1, 1)}
TOL = 1e-6
CP_TOL = 1e-5
RESNET = dict(depth=18, stem_channels=8, base_channels=8, norm_cfg=dict(type="BN"))


def _case_inputs(name):
    """Global input (mean 5, spread ~1 per channel), loss weights G, and the
    module's affine parameters and running statistics, from numpy."""
    r = np.random.RandomState(len(name))
    shape = CASES[name]
    c = shape[1]
    x = (5.0 + r.randn(*shape) * r.uniform(0.5, 1.5, (1, c) + (1,) * (len(shape) - 2)))
    return {"x": x.astype(np.float32), "g": r.randn(*shape).astype(np.float32),
            "weight": (1 + 0.1 * r.randn(c)).astype(np.float32),
            "bias": (0.1 * r.randn(c)).astype(np.float32),
            "mean": (0.1 * r.randn(c)).astype(np.float32),
            "var": r.uniform(0.5, 1.5, c).astype(np.float32)}


def _bn(inputs):
    bn = BatchNorm(inputs["weight"].shape[0])
    with torch.no_grad():
        for name, key in (("weight", "weight"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(inputs[key]))
    return bn


def _bn_run(inputs, rows=slice(None), world=1):
    """Forward and backward of ``mean(y·G)`` on ``rows`` of the global batch."""
    bn = _bn(inputs)
    x = torch.from_numpy(inputs["x"][rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inputs["g"][rows])).mean().backward()
    parallel.pmean_gradients(bn.parameters())
    return {"y": y.detach(), "x_grad": x.grad / world, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def _resnet(with_cp):
    from cp2_tpu_torch.models.resnet import ResNet

    net = ResNet(**RESNET, with_cp=with_cp)
    init_flax_like_(net, torch.Generator().manual_seed(0))
    return net.train()


def _resnet_inputs():
    r = np.random.RandomState(1)
    return (r.rand(4, 3, 64, 64).astype(np.float32),
            r.randn(4, 64, 2, 2).astype(np.float32))


def _resnet_run(with_cp, rows=slice(None)):
    x, g = _resnet_inputs()
    net = _resnet(with_cp)
    out = net(torch.from_numpy(x[rows]))[-1]
    (out * torch.from_numpy(g[rows])).mean().backward()
    parallel.pmean_gradients(net.parameters())
    return {"out": out.detach(),
            "grads": {k: p.grad.clone() for k, p in net.named_parameters()},
            "buffers": {k: b.clone() for k, b in net.named_buffers()}}


def _ranks(workdir):
    rank = int(os.environ["RANK"])
    assert parallel.initialize(backend="gloo")
    out = {}
    for name, shape in CASES.items():
        n = shape[0] // WORLD
        out[name] = _bn_run(_case_inputs(name), slice(rank * n, (rank + 1) * n), WORLD)
    out["resnet_with_cp"] = _resnet_run(True, slice(rank * 2, rank * 2 + 2))
    out["resnet_plain"] = _resnet_run(False, slice(rank * 2, rank * 2 + 2))
    parallel.shutdown()
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sync_bn")
    spawn_ranks(__file__, "_ranks", workdir, timeout=180)
    outs = []
    for rank in range(WORLD):
        with open(workdir / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _close(ours, ref, tol, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process_on_the_global_batch(ranks, case):
    ref = _bn_run(_case_inputs(case))
    n = CASES[case][0] // WORLD
    for rank, out in enumerate(ranks):
        got = out[case]
        rows = slice(rank * n, (rank + 1) * n)
        _close(got["y"], ref["y"][rows], TOL, "y")
        _close(got["x_grad"], ref["x_grad"][rows], TOL, "input gradient")
        for key in ("weight_grad", "bias_grad", "running_mean", "running_var"):
            _close(got[key], ref[key], TOL, key)
    for key in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        assert torch.equal(ranks[0][case][key], ranks[1][case][key]), key


def test_with_cp_recompute_matches_plain_network(ranks):
    """Both ranks recompute each block in the backward; the collectives of
    the recompute pair up, the result is bit-equal to the plain network's in
    the same ranks and, at the stated tolerance, the plain network's on the
    global batch in one process.  The running statistics move once per
    step."""
    ref = _resnet_run(False)
    for rank, out in enumerate(ranks):
        got, plain = out["resnet_with_cp"], out["resnet_plain"]
        assert torch.equal(got["out"], plain["out"])
        for part in ("grads", "buffers"):
            for key, value in plain[part].items():
                assert torch.equal(got[part][key], value), key
        _close(got["out"], ref["out"][rank * 2:rank * 2 + 2], CP_TOL, "output")
        for part in ("grads", "buffers"):
            for key, value in ref[part].items():
                _close(got[part][key], value, CP_TOL, key)


def test_two_ranks_match_flax_batchnorm_on_the_global_batch(ranks):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    inputs = _case_inputs("conv")
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      use_fast_variance=False)
    x = jnp.asarray(inputs["x"].transpose(0, 2, 3, 1))  # NHWC
    variables = {"params": {"scale": inputs["weight"], "bias": inputs["bias"]},
                 "batch_stats": {"mean": inputs["mean"], "var": inputs["var"]}}
    y, updated = bn.apply(variables, x, mutable=["batch_stats"])
    y = np.asarray(jax.device_get(y)).transpose(0, 3, 1, 2)
    stats = jax.device_get(updated["batch_stats"])
    n = CASES["conv"][0] // WORLD
    for rank, out in enumerate(ranks):
        _close(out["conv"]["y"], y[rank * n:(rank + 1) * n], TOL, "y")
        _close(out["conv"]["running_mean"], stats["mean"], TOL, "running_mean")
        _close(out["conv"]["running_var"], stats["var"], TOL, "running_var")


def _forward_before_the_global_path(bn, x):
    """``BatchNorm.forward`` as it was with one process only."""
    if not bn.training or bn.frozen:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, 1e-5)
    m = 0.9
    n = x.numel() // x.shape[1]
    torch_var = bn.running_var.clone()
    y = F.batch_norm(x, bn.running_mean, torch_var, bn.weight, bn.bias, True, 1.0 - m, 1e-5)
    with torch.no_grad():
        bn.running_var.mul_(m / n).add_(torch_var, alpha=(n - 1) / n)
    return y


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_one_process_path_is_bit_equal_to_before(mode):
    inputs = _case_inputs("conv")
    ours, before = _bn(inputs), _bn(inputs)
    for bn in (ours, before):
        bn.frozen = mode == "frozen"
        bn.train(mode != "eval")
    xs = [torch.from_numpy(inputs["x"]).requires_grad_() for _ in range(2)]
    y = ours(xs[0])
    y_before = _forward_before_the_global_path(before, xs[1])
    assert torch.equal(y, y_before)
    g = torch.from_numpy(inputs["g"])
    (y * g).sum().backward()
    (y_before * g).sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(ours, name), getattr(before, name)), name

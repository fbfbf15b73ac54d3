"""The port's measuring tools against the JAX package's, on the CPU.

Each twin (``cp2_tpu_torch.bench``, ``cp2_tpu_torch.tools.bench_*``,
``cp2_tpu_torch.tools.profile_step``, ``cp2_tpu_torch.graft_entry``) keeps
its work in a function that takes the model config and the device; here it
runs on the CPU with ``__graft_entry__._tiny_model_cfg``-sized models for
1-2 steps.  Held: the JAX tool's flags (read from its source) and output
keys, the inputs bit for bit (``bench.py``'s frames and ``BENCH_SCAN``
batches, ``tools/bench_dense_loss.py``'s q, k and masks, executed from the
JAX tools' own lines), the counted step's FLOPs equal to the count from
the configuration alone, the plain dense loss on the JAX tool's inputs
against JAX's ``dense_pair_loss_reference`` (loss 2e-5, gradients 1e-4:
the float32 tolerance of the dense-loss tests), and the 2-process dry run.
"""

import ast
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from __graft_entry__ import _tiny_model_cfg  # noqa: E402  (the JAX file's tiny config)
from _torch_port_common import MOCO_MODEL, SEG_MODEL  # noqa: E402

from cp2_tpu_torch import bench  # noqa: E402
from cp2_tpu_torch.tools import (  # noqa: E402
    bench_dense_loss, bench_dilated_conv, bench_finetune, bench_infer, bench_metrics,
    bench_pretrain_variant, profile_step)
from cp2_tpu_torch.utils.benchmarking import LAUNCH_TAG  # noqa: E402

TINY_CP2 = _tiny_model_cfg(128)  # the dense family's dim, 128
NO_KERNEL = {"dense_pair_loss_fwd": 0, "dense_pair_loss_bwd": 0}


@pytest.fixture(autouse=True)
def _one_thread_no_onednn():
    # one torch thread: the suite runs several workers on few cores, and
    # these tiny steps only lose to the threads' contention; oneDNN's
    # channels-last conv backward corrupts the heap on the tiny networks
    # here (tests/test_torch_finetune_cli.py's docstring)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _source(path):
    return ast.parse(open(os.path.join(REPO, path)).read())


def _flags(tree):
    """The option strings of every ``add_argument`` call in a source tree."""
    return {arg.value for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for arg in node.args if isinstance(arg, ast.Constant)}


def _env_vars(tree):
    """The names read with ``os.environ.get`` (or its alias ``env``)."""
    return {node.args[0].value for node in ast.walk(tree) if isinstance(node, ast.Call)
            and ast.unparse(node.func) in ("os.environ.get", "env") and node.args
            and isinstance(node.args[0], ast.Constant)}


def _launches(out):
    """The twin's ``LAUNCHES`` line."""
    lines = [line for line in out.splitlines() if line.startswith(LAUNCH_TAG + " ")]
    assert len(lines) == 1, out
    return json.loads(lines[0].split(" ", 1)[1])


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


@pytest.mark.parametrize("jax_tool,twin", [
    ("bench.py", "cp2_tpu_torch/bench.py"),
    ("tools/bench_pretrain_variant.py", "cp2_tpu_torch/tools/bench_pretrain_variant.py"),
    ("tools/bench_finetune.py", "cp2_tpu_torch/tools/bench_finetune.py"),
    ("tools/bench_infer.py", "cp2_tpu_torch/tools/bench_infer.py"),
    ("tools/bench_metrics.py", "cp2_tpu_torch/tools/bench_metrics.py"),
    ("tools/bench_dense_loss.py", "cp2_tpu_torch/tools/bench_dense_loss.py"),
    ("tools/bench_dilated_conv.py", "cp2_tpu_torch/tools/bench_dilated_conv.py"),
    ("tools/profile_step.py", "cp2_tpu_torch/tools/profile_step.py"),
    ("__graft_entry__.py", "cp2_tpu_torch/graft_entry.py"),
])
def test_twin_takes_the_jax_tools_flags_and_variables(jax_tool, twin):
    """The same command-line flags, and every ``BENCH_*`` / ``GRAFT_*``
    variable the JAX tool reads (``JAX_*`` are XLA's own)."""
    jax_tree, twin_tree = _source(jax_tool), _source(twin)
    assert _flags(twin_tree) == _flags(jax_tree)
    jax_env = {v for v in _env_vars(jax_tree) if not v.startswith("JAX_")}
    twin_env = _env_vars(twin_tree)
    if jax_tool == "__graft_entry__.py":
        # GRAFT_MP_WORKER and GRAFT_DRYRUN_PROCS pick JAX's multi-host
        # worker; a gloo rank is told by torchrun's environment instead
        jax_env -= {"GRAFT_MP_WORKER", "GRAFT_DRYRUN_PROCS", "GRAFT_DRYRUN_SKIP_MP"}
    assert jax_env <= twin_env, jax_env - twin_env


def _bench_jax_keys():
    """The keys of ``bench.py``'s JSON line, from its source."""
    main = _function(_source("bench.py"), "main")
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and ast.unparse(n.func) == "json.dumps")
    return {k.value for k in call.args[0].keys}


def _run_bench_jax_lines(batch, hw, no_aug, scan_k):
    """``bench.py``'s own lines that make the host arrays (the ``if no_aug``
    block and ``stack_k``), executed with numpy in place of ``jnp``."""
    import jax

    main = _function(_source("bench.py"), "main")
    block = next(n for n in main.body if isinstance(n, ast.If)
                 and ast.unparse(n.test) == "no_aug")
    stack = _function(main, "stack_k")
    ns = {"np": np, "jnp": types.SimpleNamespace(asarray=np.asarray), "batch": batch,
          "hw": hw, "base": hw + 32, "no_aug": no_aug, "scan_k": scan_k,
          "r": np.random.RandomState(0)}
    exec(compile(ast.Module(body=[block, stack], type_ignores=[]), "bench.py", "exec"), ns)
    raw = ns["raw"]
    stacked = jax.tree_util.tree_map(ns["stack_k"], raw) if scan_k > 1 else None
    return raw, stacked


@pytest.mark.parametrize("no_aug", [False, True])
@pytest.mark.parametrize("scan_k", [1, 3])
def test_bench_inputs_are_bench_pys_bit_for_bit(no_aug, scan_k):
    raw_jax, stacked_jax = _run_bench_jax_lines(3, 16, no_aug, scan_k)
    r = np.random.RandomState(0)
    raw = bench.raw_frames(3, 16, no_aug, r)
    assert raw.keys() == raw_jax.keys()
    for k in raw:
        assert raw[k].dtype == np.asarray(raw_jax[k]).dtype
        assert np.array_equal(raw[k], np.asarray(raw_jax[k])), k
    if scan_k > 1:
        batches = bench.scan_batches(raw, scan_k, r)
        for i, b in enumerate(batches):
            for k in raw:
                assert np.array_equal(b[k], np.asarray(stacked_jax[k])[i]), (i, k)
        assert not np.array_equal(batches[0][next(iter(raw))], batches[1][next(iter(raw))])


def test_bench_runs_on_the_cpu_with_its_end_to_end_phases(tmp_path, capsys):
    out = bench.run(TINY_CP2, "cpu", batch=2, hw=32, steps=2, warmup=1, e2e_steps=1,
                    e2e_repeats=2, data_root=str(tmp_path))
    assert out.keys() == _bench_jax_keys() | {"device", "loader", "peak_device_mib"}
    assert out["value"] > 0 and out["e2e_ips"] > 0
    assert out["loader"] in ("native", "python")
    # the raw-cache phase runs with the native pool only
    assert (out["e2e_cached_ips"] is None) == (out["loader"] == "python")
    assert out["e2e_detail"]["segments"] == 2
    assert out["mfu"] is None and out["device"] == "cpu"  # no peak for the CPU
    assert out["model_flops_per_step"] == bench_pretrain_variant.step_flops(
        TINY_CP2, "CP2", "DEEPLABV3", 2, 32)
    launches = _launches(capsys.readouterr().out)
    assert {k: launches[k] for k in NO_KERNEL} == NO_KERNEL  # the plain version on the CPU
    assert launches["steps"] == 1 + 1 + 2 + (1 + 2) + (
        0 if out["e2e_cached_ips"] is None else -(-max(2 * 4, 64) // 2) + 2)


def test_bench_scan_and_pre_augmented_batch(capsys):
    out = bench.run(TINY_CP2, "cpu", batch=2, hw=32, steps=1, warmup=1, no_aug=True, scan=2)
    assert out["value"] > 0 and out["e2e_ips"] is None
    assert out["model_flops_per_step"] == bench_pretrain_variant.step_flops(
        TINY_CP2, "CP2", "DEEPLABV3", 2, 32, augment=False)
    assert _launches(capsys.readouterr().out)["steps"] == 1 + 2 + 2


def test_bench_refuses_compiler_options(monkeypatch):
    monkeypatch.setenv("BENCH_COMPILER_OPTIONS", "xla_tpu_scoped_vmem_limit_kib=65536")
    with pytest.raises(SystemExit, match="no compiler"):
        bench.main()


def test_twins_need_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from cp2_tpu_torch.graft_entry import dryrun_multichip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_infer.run(SEG_MODEL, "cuda", bench_infer.get_args([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)  # the card by default; no process is started


VARIANT_CASES = {
    "DENSECL": (MOCO_MODEL, "DEEPLABV3"), "MOCO": (MOCO_MODEL, "DEEPLABV3"),
    "BYOL": (MOCO_MODEL, "DEEPLABV3"), "PROPOSED": (TINY_CP2, "DEEPLABV3"),
    "PROPOSED_V2": (TINY_CP2, "DEEPLABV3"),
}


@pytest.mark.parametrize("variant", sorted(VARIANT_CASES))
def test_bench_pretrain_variant_on_the_cpu(variant, capsys):
    model_cfg, backbone = VARIANT_CASES[variant]
    args = bench_pretrain_variant.get_args(["--variant", variant, "--batch", "8", "--hw", "32",
                                            "--steps", "1", "--warmup", "0"])
    out = bench_pretrain_variant.run(model_cfg, "cpu", args)
    assert out["metric"] == f"{variant.lower()}_pretrain_images_per_sec_per_chip"
    assert {"metric", "value", "unit", "ms_per_step", "batch", "hw", "mfu",
            "model_flops_per_step"} <= out.keys()
    assert out["value"] > 0 and out["batch"] == 8
    assert out["model_flops_per_step"] == bench_pretrain_variant.step_flops(
        model_cfg, variant, backbone, 8, 32)
    assert _launches(capsys.readouterr().out)["steps"] == 2


def test_bench_pretrain_variant_keeps_the_jax_refusal_and_configs():
    with pytest.raises(SystemExit):
        bench_pretrain_variant.get_args(["--variant", "MOCO", "--backbone", "UNET_TRUNCATED"])
    args = bench_pretrain_variant.get_args(["--variant", "CP2", "--backbone", "UNET_TRUNCATED"])
    assert args.backbone == "UNET_TRUNCATED"
    assert {v: bench_pretrain_variant.config_name(v) for v in bench_pretrain_variant.VARIANTS} == {
        "CP2": "config_pretrain.py", "PROPOSED": "config_pretrain.py",
        "PROPOSED_V2": "config_pretrain.py", "DENSECL": "config_moco.py",
        "MOCO": "config_moco.py", "BYOL": "config_moco.py"}


def test_bench_finetune_on_the_cpu(capsys):
    args = bench_finetune.get_args(["--hw", "32", "--batch", "4", "--steps", "1",
                                    "--warmup", "1"])
    out = bench_finetune.run(SEG_MODEL, "cpu", args)
    jax_keys = {"metric", "value", "unit", "ms_per_step", "batch", "hw", "mfu",
                "model_flops_per_step"}
    assert jax_keys <= out.keys() and out["metric"] == "finetune_train_images_per_sec_per_chip"
    assert out["model_flops_per_step"] == bench_finetune.step_flops(SEG_MODEL, 2, 4, 32)
    launches = _launches(capsys.readouterr().out)
    assert {k: launches[k] for k in NO_KERNEL} == NO_KERNEL
    assert launches["steps"] == 1 + 1 + 1  # counted, warm-up, timed


def test_bench_infer_on_the_cpu(capsys):
    args = bench_infer.get_args(["--hw", "48", "--batch", "2", "--steps", "1",
                                 "--slide-crop", "32", "--slide-stride", "20"])
    out = bench_infer.run(dict(SEG_MODEL, auxiliary_head=None), "cpu", args)
    printed = capsys.readouterr().out
    assert "  whole:" in printed and "  slide 32/20:" in printed and "logits (2, 48, 48, 2)" in printed
    assert out["whole_images_per_sec"] > 0 and out["slide_images_per_sec"] > 0
    assert _launches(printed) == {"steps": 2 * (1 + 1), **NO_KERNEL}  # 2 modes, 1 + 1 calls


def test_bench_metrics_on_the_cpu(capsys):
    args = bench_metrics.get_args(["--batch", "2", "--s", "4", "--k", "64", "--steps", "1",
                                   "--full-step"])
    out = bench_metrics.run(TINY_CP2, "cpu", args, hw=32)
    printed = capsys.readouterr().out
    assert set(out["ms"]) == {"dense_loss_stats", "instance_stats", "masked_corr_map",
                              "full_step_level0", "full_step_level1"}
    assert "metric overhead" in printed and "metric_overhead_ms" in out
    assert _launches(printed)["steps"] == 2 * (5 + 1)


def _jax_dense_inputs(n, s2, c):
    """``tools/bench_dense_loss.py``'s own lines that draw q, k, a and b."""
    run = _function(_source("tools/bench_dense_loss.py"), "run")
    body = run.body[:run.body.index(next(s for s in run.body if "grad_fn" in ast.unparse(s)))]
    ns = {"np": np, "jnp": types.SimpleNamespace(asarray=np.asarray), "n": n,
          "args": types.SimpleNamespace(s2=s2, c=c)}
    exec(compile(ast.Module(body=body, type_ignores=[]), "bench_dense_loss.py", "exec"), ns)
    return ns["q"], ns["k"], ns["a"], ns["b"]


def test_bench_dense_loss_inputs_and_plain_loss_match_jax():
    import jax

    from cp2_tpu.ops.pallas.dense_loss import dense_pair_loss_reference as jax_reference

    from cp2_tpu_torch.ops.dense_loss import dense_pair_loss_reference

    ours = bench_dense_loss.inputs(2, 64, 16)
    theirs = _jax_dense_inputs(2, 64, 16)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    q, k, a, b = (torch.from_numpy(x) for x in ours)
    q.requires_grad_()
    k.requires_grad_()
    loss = dense_pair_loss_reference(q, k, a, b, 0.2)
    dq, dk = torch.autograd.grad(loss, (q, k))
    ref, (rq, rk) = jax.value_and_grad(
        lambda q, k: jax_reference(q, k, theirs[2], theirs[3], 0.2), argnums=(0, 1))(
        theirs[0], theirs[1])
    assert abs(loss.item() - float(ref)) <= 2e-5 * abs(float(ref))
    assert bench_dense_loss.max_rel(dq, torch.from_numpy(np.asarray(rq))) <= 1e-4
    assert bench_dense_loss.max_rel(dk, torch.from_numpy(np.asarray(rk))) <= 1e-4


def test_bench_dense_loss_on_the_cpu(capsys):
    args = bench_dense_loss.get_args(["--s2", "64", "--c", "16", "--batches", "2", "4",
                                      "--steps", "1"])
    out = bench_dense_loss.run("cpu", args)
    assert set(out["by_batch"]) == {"2", "4"}
    for row in out["by_batch"].values():
        assert row["loss_rel"] <= 2e-5 and max(row["dq_rel"], row["dk_rel"]) <= 1e-4
    launches = _launches(capsys.readouterr().out)
    assert launches["steps"] == 2 * 2 and {k: launches[k] for k in NO_KERNEL} == NO_KERNEL


def test_bench_dilated_conv_on_the_cpu(capsys):
    out = bench_dilated_conv.run("cpu", shapes=((2, 14), (1, 22)), cin=8, cout=4,
                                 dilations=(6, 12, 18), steps=1)
    # 2 shapes x 3 dilations x 2 paths, one untimed call and one timed each
    assert _launches(capsys.readouterr().out) == {"steps": 2 * 3 * 2 * 2, **NO_KERNEL}
    # the JAX docstring's useful shares at 14x14: d=6 ~51 %, d=12 ~18 %
    rows = out["by_shape"]["2x14x14"]
    assert rows["6"]["useful_share"] == pytest.approx(0.5102, abs=1e-4)
    assert rows["12"]["useful_share"] == pytest.approx(0.1837, abs=1e-4)
    # conv2d splits d = 12 and 18 at both grids, and leaves d = 6 plain
    assert {(shape, d): row["engages"] for shape, by_d in out["by_shape"].items()
            for d, row in by_d.items()} == {
        (shape, d): d != "6" for shape in ("2x14x14", "1x22x22") for d in ("6", "12", "18")}
    for by_d in out["by_shape"].values():
        for row in by_d.values():
            assert row["plain"]["us"] > 0 and row["split"]["us"] > 0 and row["split_speedup"] > 0


@pytest.mark.parametrize("task", ["pretrain", "finetune"])
def test_profile_step_on_the_cpu(task, tmp_path, capsys):
    model_cfg = TINY_CP2 if task == "pretrain" else SEG_MODEL
    out = profile_step.run(model_cfg, "cpu", task=task, steps=1, out=str(tmp_path),
                           batch=2, hw=32)
    assert os.path.exists(tmp_path / profile_step.TRACE)
    assert out["task"] == task and out["window_ms"] > 0
    # a CPU run has no device kernels: no busy share
    assert out["busy_share"] is None and out["device_ms"] == 0
    assert _launches(capsys.readouterr().out)["steps"] == 2 + 1  # warm-up, profiled
    again = profile_step.main(["--summarize-only", "--out", str(tmp_path)])
    assert again == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["window_ms"] == \
        out["window_ms"]


def test_profile_step_sorts_kernels_into_categories():
    assert profile_step.category("void (anonymous namespace)::fwd_kernel<128, true>") == \
        "dense loss (csrc/dense_loss.cu)"
    assert profile_step.category("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert profile_step.category("sm90_xmma_gemm_bf16bf16_bf16f32") == "matrix product"
    assert profile_step.category("void at::native::vectorized_elementwise_kernel") == \
        "elementwise"


def test_graft_entry_dryrun_in_two_gloo_processes(capsys):
    from cp2_tpu_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    printed = capsys.readouterr().out
    assert "dryrun_multichip(2) OK" in printed and printed.count("OK: loss=") == 2
    assert _launches(printed) == {"steps": 2, **NO_KERNEL}  # one step a rank, plain loss
    assert out["n_processes"] == 2 and out["device"] == "cpu"
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))

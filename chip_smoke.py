#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port ``cp2_tpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device   require CUDA, print the card's name and power limit, turn TF32
            off for matrix products and convolutions (the comparisons
            below are in full float32);
2. build    compile every kernel of the path from ``cp2_tpu_torch/csrc``
            with nvcc for sm_90a, one nvcc per source, all at once;
3. kernels  the dense-pair-loss kernels against their plain PyTorch
            versions, forward value, dq and dk, float32 and bfloat16
            operands, temperatures 1.0 and 0.2, at the CP2 step's shape
            and eight more (every channel width the kernels are built
            for, and the U-Net steps' S² = 784 and 49); two runs of each kernel on the same inputs must be
            bit-equal, and so must forwards run on two streams at once;
            kernel and plain times at each shape
            (device time of a CUDA graph of back-to-back calls, and the
            eager calls' time by CUDA events) beside two bounds: the
            tensor cores' (3xTF32 for float32 operands) and float32 FMA's;
4. small    one CP2 step of a narrow model on the card against the same
            step on the CPU, where the dense loss takes its plain version;
5. step     the full-width CP2 pretrain step (dilated ResNet-50 + ASPP-512,
            contrast dim 128, queue 65536, 224x224, batch 32, bfloat16
            model) through ``create_pretrain_state`` and
            ``make_pretrain_step``: 2 warm-up and 5 timed steps, the launch
            counts of the kernels over those 7 steps, and the kernel held
            against the plain version on the step's own dense features;
6. augment  the on-device pretrain augmentation at full width: raw
            (32, 256, 256, 3) uint8 ``fg``, ``bg0``, ``bg1`` to 224x224:
            parameters drawn on the CPU and applied on the card and on the
            CPU (images to 1e-5, ids exactly); the samplers on the card's
            generator against the laws' expectations over 4096 draws; every
            background's erased rectangle; the device time per batch;
7. cli      the pretrain CLI (``cp2_tpu_torch.train.pretrain.main``) on the
            card at full width on a synthetic directory of 256x256 PNGs:
            the default config, batch 32, 224x224, bfloat16,
            ``--metrics_level 1``, logged and quiet steps, a checkpoint and a
            ``--resume`` from it; first, batches staged through the pinned
            copy stream against their host arrays; finite losses, the metric keys in
            ``metrics.jsonl``, one launch of each dense-loss kernel per step,
            the step and ``queue_ptr`` carried on by the resume; quiet and
            logged step times, end-to-end images/s (loader, copy and
            augmentation included) and the peak memory;
8. variants one step of every other variant at a narrow width on the card
            against the same step on the CPU, at phase 4's tolerance: MOCO,
            BYOL, DENSECL, PROPOSED_V2 (symmetric, predictor, coordinate
            0.5), PROPOSED with PIXEL_REGION_ID 10/1/0 and with each of
            FIXED/AVERAGE/MEDIAN/HARD, CP2 on both U-Nets; the dense-loss
            kernel launches once forward and once backward on the kernel
            route (CP2 on the U-Nets) and never elsewhere;
9. cli x 8  the CLI per variant at full width (batch 32, 224x224, bfloat16,
            queue 65536, ``--metrics_level 1 --scalar-freq 3``) on 192
            synthetic PNGs with SAM region maps (6 steps, 1 epoch): MOCO,
            BYOL and DENSECL on ``config_moco.py``, PROPOSED_V2
            (``sym-coord.sh``), PROPOSED (``proposed.sh``; MEDIAN at scale
            2), CP2 on UNET_TRUNCATED and UNET_ENCODER_ONLY; finite losses,
            the variant's step and epoch keys, both queue pointers, the
            dense-loss launches per route, the kernel against its plain
            version on UNET_TRUNCATED's own features (S² = 784), a 1-step
            DenseCL ``--resume``; step times, images/s and peak memory;
10. finetune the finetune path at a narrow width on the card against the
            CPU, float32: the polyp and lemon augmentation with grid
            distortion forced on, and the val flips (images to 1e-6, masks
            equal), one train step of ``config_finetune.py``'s structure at
            width 8 with an auxiliary head (loss, gradients and BatchNorm
            statistics to 1e-4), an eval step with a padded row (confusion
            counts equal); no dense-loss launch;
11. ft cli  the finetune CLI (``cp2_tpu_torch.train.finetune.main``) at full
            width from phase 7's CP2 checkpoints: polyp on
            ``config_finetune.py`` (dilated ResNet-50, ASPP classifier),
            352x352, batch 16, bfloat16, 2 epochs of 4 steps on synthetic
            384x448 PNG pairs; lemon (544x1024, 12 classes,
            ``--fast_dev_run``); ``--linear_evaluation --fast_dev_run``; the
            graft loads tensors, losses finite, the monitored key in
            ``metrics.jsonl``, one best checkpoint left, the test keys, no
            dense-loss launch; quiet step, images/s, eval time per epoch,
            peak memory, and the step with a channels-last input beside it.

The last lines are one JSON object on the kernels (with their launches on
every path), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM tensor cores, TF32, dense
TF32_PASSES = 3  # float32 operands run as 3xTF32 products
# C = 8 and 16 run at the kernels' padded width 32; 64 and 256 are built too;
# the last two are CP2's in-step shapes on UNET_TRUNCATED and UNET_ENCODER_ONLY
SHAPES = [(32, 196, 128), (8, 1024, 128), (2, 4096, 128), (1, 100, 8), (1, 640, 16),
          (2, 196, 64), (2, 196, 256), (32, 784, 128), (32, 49, 128)]
STEP_SHAPE = SHAPES[0]  # (N, S², C) of the CP2 step at 224², batch 32
TEMPS = (1.0, 0.2)
F32_TOL = {"loss_rtol": 2e-5, "grad_rtol": 1e-4}  # tests/test_pallas_dense_loss.py
BF16_RTOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` over ``iters`` eager calls, CUDA events.

    Where the host takes longer to enqueue a call than the device to run
    it, this is the host's time; ``graph_ms`` is the device's."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_capture_stream = None


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed back to back, timed by CUDA events.

    Every capture uses one stream: PyTorch keeps a cuBLAS workspace for
    each stream that ran a product, for the life of the process, and a new
    stream per call would hold memory the step's peak then counts."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    side = _capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """max |ours - ref| over max |ref| (normwise relative error)."""
    return float((ours.double() - ref.double()).abs().max() / ref.double().abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def dense_inputs(n, s2, c, seed, device="cuda"):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(n, s2, c, generator=g), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(n, s2, c, generator=g), dim=-1)
    a = (torch.rand(n, s2, generator=g) > 0.5).float()
    b = (torch.rand(n, s2, generator=g) > 0.5).float()
    a[:, 0] = 1.0
    b[:, 0] = 1.0
    return [t.to(device) for t in (q, k, a, b)]


def dense_work(n, s2, c):
    """(bytes, operations) each kernel must move and do, float32 operands.

    Forward: read q, k and both masks, write lse and the loss; the
    similarities, 2·N·S⁴·C.  Backward as the step runs it (dq only): read
    q, k, the masks, lse and the upstream gradient, write dq; the
    similarities again and their product with k, 2 · 2·N·S⁴·C.
    """
    qk, masks, lse = 2 * n * s2 * c * 4, 2 * n * s2 * 4, n * s2 * 4
    sim = 2 * n * s2 * s2 * c
    return (qk + masks + lse + 4, sim), (qk + masks + lse + 4 + n * s2 * c * 4, 2 * sim)


def bound_ms(nbytes, ops, peak_ops_per_s):
    """The least time for the work at the given operation rate, and what
    sets it: bytes over the memory rate, or operations over the rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bounds(nbytes, flops):
    """For float32 operands: (tensor-core bound, what sets it), the kernel's
    arithmetic, 3xTF32; and the float32-FMA bound of a CUDA-core kernel."""
    tc = bound_ms(nbytes, TF32_PASSES * flops, PEAK_TF32_FLOPS)
    return tc[0], tc[1], bound_ms(nbytes, flops, PEAK_FP32_FLOPS)[0]


def check_deterministic(dl, q, k, a, b, dtype):
    """Two runs of each kernel on the same inputs give the same bits."""
    ops = dl.prepare_operands(q, k, a, b, dtype)
    g = torch.ones((), device="cuda")
    runs = []
    for _ in range(2):
        loss, lse = dl.fwd_kernel(*ops, 0.2)
        dq, dk = dl.bwd_kernel(*ops, lse, g, 0.2)
        runs.append((loss, lse, dq, dk))
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(*runs))


def check_streams(dl, q, k, a, b):
    """Forwards on two streams at once give the serial loss, bit for bit:
    each stream has its own counter for finding the forward's last block."""
    ops = dl.prepare_operands(q, k, a, b, torch.float32)
    want, _ = dl.fwd_kernel(*ops, 0.2)
    streams = [torch.cuda.Stream() for _ in range(2)]
    losses = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                losses.append(dl.fwd_kernel(*ops, 0.2)[0])
    torch.cuda.synchronize()
    return all(torch.equal(x, want) for x in losses)


def check_kernels(dl):
    """Every shape, temperature and operand type, then the times at each
    shape; returns the step shape's float32 numbers for the JSON line."""
    flagship = {}
    for (n, s2, c) in SHAPES:
        q, k, a, b = dense_inputs(n, s2, c, seed=s2 + c)
        for dtype in (torch.float32, torch.bfloat16):
            for temp in TEMPS:
                qg, kg = (x.detach().clone().requires_grad_() for x in (q, k))
                loss = dl.dense_pair_loss(qg, kg, a, b, temp, compute_dtype=dtype)
                loss.backward()
                torch.cuda.synchronize()
                # the plain version on the same (rounded) operands, float32
                qr, kr = (x.to(dtype).float().detach().clone().requires_grad_()
                          for x in (q, k))
                ref = dl.dense_pair_loss_reference(qr, kr, a, b, temp)
                ref.backward()
                err_loss = abs(loss.item() - ref.item()) / abs(ref.item())
                err_dq, err_dk = max_rel(qg.grad, qr.grad), max_rel(kg.grad, kr.grad)
                if dtype == torch.float32:
                    ok = (err_loss <= F32_TOL["loss_rtol"]
                          and max(err_dq, err_dk) <= F32_TOL["grad_rtol"])
                else:
                    ok = max(err_loss, err_dq, err_dk) <= BF16_RTOL
                abs_fwd = abs(loss.item() - ref.item())
                abs_bwd = max(float((qg.grad - qr.grad).abs().max()),
                              float((kg.grad - kr.grad).abs().max()))
                log(f"  check N={n} S2={s2} C={c} {str(dtype)[6:]:8s} T={temp}: "
                    f"loss rel {err_loss:.2e}  dq {err_dq:.2e}  dk {err_dk:.2e}  "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"kernel disagrees with the plain version at "
                                     f"{(n, s2, c)} {dtype} T={temp}")
                if (n, s2, c) == STEP_SHAPE and dtype == torch.float32:
                    flagship["fwd_abs"] = max(flagship.get("fwd_abs", 0.0), abs_fwd)
                    flagship["bwd_abs"] = max(flagship.get("bwd_abs", 0.0), abs_bwd)
            if not check_deterministic(dl, q, k, a, b, dtype):
                raise SystemExit(f"two runs of the kernels differ at {(n, s2, c)} {dtype}")
        log(f"  two runs bit-equal at N={n} S2={s2} C={c}, float32 and bfloat16")
        if (n, s2, c) == STEP_SHAPE:
            if not check_streams(dl, q, k, a, b):
                raise SystemExit("forwards on two streams at once disagree with the serial one")
            log("  forwards on two streams at once: bit-equal to the serial one")
        # times, float32 operands, T = 1
        ops = dl.prepare_operands(q, k, a, b, torch.float32)
        _, lse = dl.fwd_kernel(*ops, 1.0)
        g = torch.ones((), device="cuda")
        calls = {
            "fwd": lambda: dl.fwd_kernel(*ops, 1.0),
            "fwd_plain": lambda: dl.dense_pair_loss_reference(q, k, a, b, 1.0),
            # the step's backward: dq only (the keys carry no gradient)
            "bwd": lambda: dl.bwd_kernel(*ops, lse, g, 1.0, need_dk=False),
            "bwd_plain": lambda: dl.dense_pair_loss_backward(q, k, a, b, lse, 1.0),
        }
        t = {}
        for name, fn in calls.items():
            t[f"{name}_ms"] = graph_ms(fn)
            t[f"{name}_eager_ms"] = cuda_ms(fn)
        fwd_work, bwd_work = dense_work(n, s2, c)
        t["fwd_bound_ms"], t["fwd_bound_by"], t["fwd_fp32_fma_bound_ms"] = bounds(*fwd_work)
        t["bwd_bound_ms"], t["bwd_bound_by"], t["bwd_fp32_fma_bound_ms"] = bounds(*bwd_work)
        for d in ("fwd", "bwd"):
            log(f"  time  N={n} S2={s2} C={c} float32 {d + ('(dq)' if d == 'bwd' else ''):7s}: "
                f"kernel {t[d + '_ms']:.4f} ms (eager {t[d + '_eager_ms']:.4f}) | plain "
                f"{t[d + '_plain_ms']:.4f} ms (eager {t[d + '_plain_eager_ms']:.4f}) | "
                f"tensor-core bound {t[d + '_bound_ms']:.4f} ms ({t[d + '_bound_by']}), "
                f"{100 * t[d + '_bound_ms'] / t[d + '_ms']:.1f} % of it | float32-FMA "
                f"bound {t[d + '_fp32_fma_bound_ms']:.4f} ms")
        if (n, s2, c) == STEP_SHAPE:
            flagship.update(t)
    return flagship


# ---------------------------------------------------------------------------
# phases 4 and 5: the CP2 pretrain step
# ---------------------------------------------------------------------------

def pre_augmented_batch(batch, hw, seed, device):
    """The pre-augmented batch of ``bench.py`` (``BENCH_NO_AUG=1``)."""
    r = np.random.RandomState(seed)
    ids = np.tile(np.arange(1, hw * hw + 1, dtype=np.int32).reshape(1, hw, hw),
                  (batch, 1, 1))
    bg = r.rand(batch, hw, hw, 3).astype(np.float32)
    bg[:, hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4, :] = 0.0
    raw = {
        "img_a": r.rand(batch, hw, hw, 3).astype(np.float32),
        "img_b": r.rand(batch, hw, hw, 3).astype(np.float32),
        "bg0": bg,
        "bg1": bg.copy(),
        "pixel_ids_a": ids,
        "pixel_ids_b": ids,
        "region_ids_a": ids,
        "region_ids_b": ids,
    }
    return {key: torch.from_numpy(v).to(device) for key, v in raw.items()}


SMALL_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=50, stem_channels=8, base_channels=8,
                  num_stages=4, out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 2),
                  strides=(1, 2, 2, 1), norm_cfg=dict(type="BN"),
                  contract_dilation=True),
    decode_head=dict(type="ASPPHead", in_channels=256, in_index=3, channels=16,
                     contrast=True, contrast_dim=16, dilations=(1, 6, 12, 18),
                     num_classes=2, norm_cfg=dict(type="BN")),
)


def small_step_cuda_vs_cpu():
    """One float32 step of a narrow model from one seed on both devices."""
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl import output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import PretrainType

    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=16, queue_len=64)
    out = {}
    for device in ("cpu", "cuda"):
        state = create_pretrain_state(SSLEncoder(SMALL_MODEL, dim=16),
                                      make_optimizer("sgd", 1e-3), hp, seed=0,
                                      device=device)
        step = make_pretrain_step(hp, output_stride_of(SMALL_MODEL))
        state, metrics = step(state, pre_augmented_batch(2, 64, 0, device))
        out[device] = (metrics["loss"].item(),
                       {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                       state.queue.cpu())
    (l_cpu, sd_cpu, q_cpu), (l_gpu, sd_gpu, q_gpu) = out["cpu"], out["cuda"]
    err_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    err_state = max(max_rel(sd_gpu[k], sd_cpu[k]) for k in sd_cpu if sd_cpu[k].abs().max() > 0)
    err_queue = max_rel(q_gpu, q_cpu)
    log(f"  small step, cuda vs cpu: loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {err_loss:.2e}), "
        f"state max rel {err_state:.2e}, queue max rel {err_queue:.2e}")
    # float32 on both; cuDNN and MKL sum in other orders: 1e-4 normwise
    if not (err_loss <= 1e-4 and err_state <= 1e-4 and err_queue <= 1e-4):
        raise SystemExit("the CP2 step on the card disagrees with the CPU step")


def dense_features(state, batch, output_stride):
    """The step's q_dense / k_dense / masks, formed as ``cp2_objective``
    forms them, for the current state."""
    from cp2_tpu_torch.ops.losses import l2_normalize
    from cp2_tpu_torch.ssl.objectives import (
        composite_foreground, cp2_key_forward, subsample_grid)

    img_a, mask_a = composite_foreground(batch["img_a"], batch["bg0"])
    _, mask_b = composite_foreground(batch["img_b"], batch["bg1"])
    n = img_a.shape[0]
    with torch.no_grad():
        q_out = state.model.dense(img_a)
        k_out = cp2_key_forward(state.ema_model, batch)
    s2 = q_out.shape[1] * q_out.shape[2]
    q = l2_normalize(q_out.reshape(n, s2, -1).float())
    k = l2_normalize(k_out.reshape(n, s2, -1).float())
    a = subsample_grid(mask_a, output_stride).reshape(n, -1)
    b = subsample_grid(mask_b, output_stride).reshape(n, -1)
    return q, k, a, b


def full_step(dl):
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl import output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import BackboneType, PretrainType
    import cp2_tpu_torch

    batch_size, hw = 32, 224
    cfg = Config.fromfile(os.path.join(os.path.dirname(cp2_tpu_torch.__file__),
                                       "configs", "config_pretrain.py"))
    model_cfg = dict(cfg.model)
    hp = SSLHyperParams.for_variant(PretrainType.CP2)  # dim 128, queue 65536
    model = SSLEncoder(model_cfg, pretrain_type=PretrainType.CP2,
                       backbone_type=BackboneType.DEEPLABV3, dim=128,
                       dtype=torch.bfloat16)
    t0 = time.perf_counter()
    state = create_pretrain_state(model, make_optimizer("sgd", 1e-3), hp, seed=0)
    os_ = output_stride_of(model_cfg)
    step = make_pretrain_step(hp, os_, augment_fn=None)
    batch = pre_augmented_batch(batch_size, hw, 0, "cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"  state: {n_params} params, queue {tuple(state.queue.shape)}, output "
        f"stride {os_}, built in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()  # the main path's run starts here
    losses, times = [], []
    for i in range(7):
        ptr = state.queue_ptr
        t = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()  # synchronises
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        if not math.isfinite(loss):
            raise SystemExit(f"step {i}: loss {loss}")
        if state.queue_ptr != (ptr + batch_size) % hp.queue_len:
            raise SystemExit(f"step {i}: queue_ptr {ptr} -> {state.queue_ptr}")
    launches = dict(dl.LAUNCHES)  # read just after the run
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {['%.5f' % l for l in losses]}")
    log(f"  step ms {['%.2f' % t for t in times]}")
    for name, count in launches.items():
        if count != 7:
            raise SystemExit(f"{name} launched {count} times in 7 steps, want 7")
    med = statistics.median(times[2:])
    ips = batch_size / med * 1e3
    log(f"  launches over 7 steps: {launches}")
    log(f"  median of 5 timed steps {med:.2f} ms, {ips:.1f} images/s, peak memory "
        f"{peak / 2**30:.2f} GiB, on {gpu_line()}")

    # the kernel against the plain version on the step's own features
    q, k, a, b = dense_features(state, batch, os_)
    if tuple(q.shape) != STEP_SHAPE:
        raise SystemExit(f"dense features {tuple(q.shape)}, want {STEP_SHAPE}")
    qg = q.detach().clone().requires_grad_()
    loss = dl.dense_pair_loss(qg, k, a, b, hp.dense_logits_temp)
    loss.backward()
    qr = q.detach().clone().requires_grad_()
    ref = dl.dense_pair_loss_reference(qr, k, a, b, hp.dense_logits_temp)
    ref.backward()
    err_loss = abs(loss.item() - ref.item()) / abs(ref.item())
    err_dq = max_rel(qg.grad, qr.grad)
    log(f"  step features: kernel loss {loss.item():.6f} plain {ref.item():.6f} "
        f"(rel {err_loss:.2e}), dq max rel {err_dq:.2e}")
    if err_loss > F32_TOL["loss_rtol"] or err_dq > F32_TOL["grad_rtol"]:
        raise SystemExit("kernel disagrees with the plain version on the step's features")
    return launches, dict(median_step_ms=med, images_per_s=ips, peak_bytes=peak,
                          losses=losses, step_ms=times)


# ---------------------------------------------------------------------------
# phase 6: the on-device pretrain augmentation
# ---------------------------------------------------------------------------

AUG_N, AUG_SRC, AUG_OUT = 32, (256, 256), (224, 224)
N_DRAWS = 4096
AUG_ATOL = 1e-5  # float32 images in [0, 1]; products summed in other orders


def to_device(params, device):
    """A nest of NamedTuples of tensors (the augmentation's parameters) on
    ``device``; host integers (the jitter orders) stay as they are."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, tuple):
        return type(params)(*(to_device(p, device) for p in params))
    return params


def crop_law(m, src_hw, scale, ratio, attempts=10, seed=0):
    """(area fraction, log aspect) of ``m`` crops drawn by the law of
    ``cp2_tpu/augment/functional.py:34-88`` in numpy: the first of
    ``attempts`` candidates that fits, else the centre crop."""
    rs = np.random.RandomState(seed)
    height, width = src_hw
    area = float(height * width)
    target = area * rs.uniform(scale[0], scale[1], (m, attempts))
    aspect = np.exp(rs.uniform(np.log(ratio[0]), np.log(ratio[1]), (m, attempts)))
    ws, hs = np.sqrt(target * aspect), np.sqrt(target / aspect)
    valid = (ws <= width) & (hs <= height)
    first, any_valid = valid.argmax(1), valid.any(1)
    rows = np.arange(m)
    w = np.where(any_valid, ws[rows, first], float(width))  # square source: fallback
    h = np.where(any_valid, hs[rows, first], float(height))  # is the whole frame
    return h * w / area, np.log(w / h)


def erase_law(m, hw, scale, ratio, seed=0):
    """Erased area fraction of ``m`` rectangles drawn by the law of
    ``functional.py:458-482`` in numpy (sides rounded half to even)."""
    rs = np.random.RandomState(seed)
    h, w = hw
    area = h * w * rs.uniform(scale[0], scale[1], m)
    aspect = np.exp(rs.uniform(np.log(ratio[0]), np.log(ratio[1]), m))
    eh = np.clip(np.round(np.sqrt(area * aspect)), 1, h)
    ew = np.clip(np.round(np.sqrt(area / aspect)), 1, w)
    return eh * ew / (h * w)


def check_samplers(cfg):
    """Each sampler on the card's generator over ``N_DRAWS`` draws: the mean
    of each drawn quantity within 4 standard errors of its expectation (the
    law's probability, or a numpy draw of the law over 10^6 samples)."""
    from cp2_tpu_torch.augment import functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    crop = F.sample_resized_crop(g, N_DRAWS, AUG_SRC, cfg.crop_scale, cfg.crop_ratio,
                                 cfg.flip_p)
    jitter = F.sample_color_jitter(g, N_DRAWS, p=cfg.jitter_p)
    gray = F.sample_gate(g, N_DRAWS, cfg.grayscale_p)
    blur = F.sample_gaussian_blur(g, N_DRAWS, cfg.blur_sigma, cfg.blur_p)
    erase = F.sample_random_erase(g, N_DRAWS, AUG_OUT, cfg.erase_scale, cfg.erase_ratio)
    if not all(t.device.type == "cuda" for t in (*crop, jitter.apply, gray, *blur, *erase)):
        raise SystemExit("a sampler drew off the card")
    law_area, law_aspect = crop_law(10 ** 6, AUG_SRC, cfg.crop_scale, cfg.crop_ratio)
    law_erase = erase_law(10 ** 6, AUG_OUT, cfg.erase_scale, cfg.erase_ratio)
    drawn = {
        "crop area fraction": ((crop.h * crop.w).double() / (AUG_SRC[0] * AUG_SRC[1]),
                               law_area.mean(), law_area.std()),
        "crop log aspect": (torch.log(crop.w / crop.h).double(), law_aspect.mean(),
                            law_aspect.std()),
        "flip rate": (crop.flip.double(), cfg.flip_p, None),
        "jitter gate rate": (jitter.apply.double(), cfg.jitter_p, None),
        "grayscale gate rate": (gray.double(), cfg.grayscale_p, None),
        "blur gate rate": (blur.apply.double(), cfg.blur_p, None),
        "erase area fraction": ((erase.eh * erase.ew).double() / (AUG_OUT[0] * AUG_OUT[1]),
                                law_erase.mean(), law_erase.std()),
    }
    for name, (x, want, sd) in drawn.items():
        mean = float(x.mean())
        sd = math.sqrt(want * (1 - want)) if sd is None else sd
        tol = 4 * sd / math.sqrt(N_DRAWS)
        ok = abs(mean - want) <= tol
        log(f"  sampler {name:20s}: {mean:.5f} over {N_DRAWS} draws, expected {want:.5f} "
            f"+- {tol:.5f} (4 standard errors) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"sampler law off: {name}")


def check_augment():
    """Phase 6; returns the augmentation's times per batch."""
    from cp2_tpu_torch.augment import AugmentConfig
    from cp2_tpu_torch.augment.pipeline import (
        apply_pretrain_augment, pretrain_batch_augment, sample_pretrain_params)

    cfg = AugmentConfig(out_hw=AUG_OUT)
    r = np.random.RandomState(0)
    raw = {k: torch.from_numpy(r.randint(0, 256, (AUG_N, *AUG_SRC, 3), dtype=np.uint8))
           for k in ("fg", "bg0", "bg1")}
    raw_gpu = {k: v.cuda() for k, v in raw.items()}
    params = sample_pretrain_params(torch.Generator().manual_seed(0), AUG_N, AUG_SRC, cfg)
    ref = apply_pretrain_augment(raw, params, cfg)
    ours = apply_pretrain_augment(raw_gpu, to_device(params, "cuda"), cfg)
    torch.cuda.synchronize()
    for key, want in ref.items():
        got = ours[key].cpu()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise SystemExit(f"augment {key}: {got.dtype} {tuple(got.shape)} on the card, "
                             f"{want.dtype} {tuple(want.shape)} on the CPU")
        if key.startswith(("pixel_ids", "region_ids")):
            ok, err = torch.equal(got, want), int((got != want).sum())
            log(f"  {key:13s} card vs CPU: {err} ids differ {'ok' if ok else 'FAIL'}")
        else:
            err = float((got - want).abs().max())
            ok = err <= AUG_ATOL
            log(f"  {key:13s} card vs CPU: max abs diff {err:.2e} (atol {AUG_ATOL}) "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"augmentation on the card disagrees with the CPU: {key}")
    for bg, erase in (("bg0", params.erase0), ("bg1", params.erase1)):
        img = ours[bg]
        for i in range(AUG_N):
            y0, x0, eh, ew = (int(v[i]) for v in erase)
            hole = img[i, y0:y0 + eh, x0:x0 + ew]
            if hole.numel() == 0 or bool(hole.any()):
                raise SystemExit(f"{bg}[{i}]: no zero rectangle at its erase")
    log(f"  every background has its zero rectangle ({2 * AUG_N} of {2 * AUG_N})")
    check_samplers(cfg)

    # device time of the applies (a CUDA graph of them: the eager calls'
    # events time the host, which issues ~10^3 small launches a batch), and
    # the eager time of draws and applies as the step runs them
    params_gpu = to_device(params, "cuda")
    dev_ms = graph_ms(lambda: apply_pretrain_augment(raw_gpu, params_gpu, cfg), iters=5)
    gen = torch.Generator(device="cuda").manual_seed(2)
    eager_ms = cuda_ms(lambda: pretrain_batch_augment(gen, raw_gpu, cfg), iters=10, warmup=2)
    log(f"  augmentation, 3 x {AUG_N} frames {AUG_SRC} -> {AUG_OUT}: applies {dev_ms:.2f} "
        f"device ms per batch (CUDA graph); draws + applies eager {eager_ms:.2f} ms per batch "
        f"(CUDA events); on {gpu_line()}")
    return {"device_ms": dev_ms, "eager_ms": eager_ms}


# ---------------------------------------------------------------------------
# phase 7: the pretrain CLI on the card
# ---------------------------------------------------------------------------

CLI_BATCH, CLI_STEPS_PER_EPOCH, CLI_EPOCHS = 32, 12, 2
CLI_WORK = os.path.join("work_dirs", "chip_smoke_cli")


def write_png(path, img: np.ndarray) -> None:
    """An 8-bit RGB (H, W, 3) or grey (H, W) non-interlaced PNG, filter 0 on
    every row, with zlib."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * channels)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if channels == 1 else 2,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def synthetic_frames(directory, count, hw=(256, 256), seed=0):
    """``count`` smooth random RGB frames as PNGs with ``train`` stems."""
    os.makedirs(directory, exist_ok=True)
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    paths = []
    for i in range(count):
        f = r.uniform(1, 6, (3, 2))
        ph = r.uniform(0, 2 * np.pi, (3,))
        img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx) + ph[c])
                        for c in range(3)], axis=-1)
        img += 0.05 * r.rand(*hw, 1)
        path = os.path.join(directory, f"train_{i:04d}.png")
        write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        paths.append(path)
    return paths, img


def probe_decoders():
    """What this machine offers for decoding: PIL, g++, libpng/libjpeg."""
    found = {
        "PIL": importlib.util.find_spec("PIL") is not None,
        "g++": shutil.which("g++") is not None,
        "png.h": os.path.exists("/usr/include/png.h"),
        "jpeglib.h": any(os.path.exists(p) for p in (
            "/usr/include/jpeglib.h", "/usr/include/x86_64-linux-gnu/jpeglib.h")),
        "matplotlib": importlib.util.find_spec("matplotlib") is not None,
    }
    log(f"  decoder probe: {found}")
    return found


# the CP2 step keys of metrics_level 1 (cp2_tpu/ssl/objectives.py:220-243)
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


class StepClock:
    """Wraps the CLI's ``make_pretrain_step`` so that every step ends in
    ``torch.cuda.synchronize()``.  Each step gets two times: the call
    itself (augmentation and step), and the time since the previous step
    ended, which adds the wait for the batch and the loop's own host work
    (logging, the learning rate)."""

    def __init__(self, make):
        self.make = make
        self.rows = []  # (metrics_level, call s, since the previous end s, loss)
        self.last = None

    def __call__(self, hp, output_stride, *, metrics_level=0, **kw):
        step_fn = self.make(hp, output_stride, metrics_level=metrics_level, **kw)

        def timed(state, batch, seed=0):
            start = time.perf_counter()
            state, metrics = step_fn(state, batch, seed)
            loss = metrics["loss"].item()
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.rows.append((metrics_level, now - start, now - self.last, loss))
            self.last = now
            return state, metrics

        return timed


def check_copy_stream():
    """Batches staged by ``DevicePrefetcher`` + ``HostToDevice`` (pinned,
    ``non_blocking`` on the copy stream) read back equal to their host
    arrays on the compute stream, while that stream is kept busy so that
    copies and compute overlap and the allocator recycles staged memory."""
    from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice

    r = np.random.RandomState(3)
    host = [{k: r.randint(0, 256, (CLI_BATCH, 256, 256, 3), dtype=np.uint8)
             for k in ("fg", "bg0", "bg1")} for _ in range(8)]
    busy = torch.randn(4096, 4096, device="cuda")
    for i, staged in enumerate(DevicePrefetcher(iter(host), HostToDevice("cuda"), depth=2)):
        for _ in range(4):
            busy = busy @ busy
            busy = busy / busy.norm()
        got = staged.wait()
        sums = {k: int(v.sum(dtype=torch.int64)) for k, v in got.items()}
        for k, v in got.items():
            if not torch.equal(v.cpu(), torch.from_numpy(host[i][k])) or \
                    sums[k] != int(host[i][k].sum(dtype=np.int64)):
                raise SystemExit(f"staged batch {i} {k} differs from its host array")
        del got
    log(f"  copy stream: {len(host)} staged batches equal their host arrays")


def run_cli(pretrain, argv, clock):
    args = pretrain.get_args(argv)
    clock.last = time.perf_counter()
    return pretrain.main(args)


def check_cli(dl):
    """Phase 7; returns the CLI's launches and numbers."""
    from cp2_tpu_torch.train import pretrain

    probe = probe_decoders()
    check_copy_stream()
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    paths, last = synthetic_frames(os.path.join(CLI_WORK, "data"),
                                   CLI_BATCH * CLI_STEPS_PER_EPOCH)
    log(f"  wrote {len(paths)} PNGs of 256x256 in {time.perf_counter() - t0:.1f} s")
    if probe["PIL"]:  # the writer against the decoder the loader uses
        from PIL import Image

        with Image.open(paths[-1]) as im:
            if not np.array_equal(np.asarray(im.convert("RGB")),
                                  (np.clip(last, 0, 1) * 255).astype(np.uint8)):
                raise SystemExit("PIL decodes the written PNG to other pixels")
    logs = os.path.join(CLI_WORK, "logs")
    steps = CLI_STEPS_PER_EPOCH * CLI_EPOCHS
    common = ["--run_id", "smoke", "--log_dir", logs, "--data_dirs", os.path.join(CLI_WORK, "data"),
              "-b", str(CLI_BATCH), "--img_height", "224", "--img_width", "224",
              "--metrics_level", "1", "--scalar-freq", "3", "--print-freq", "2",
              "--visual-freq", "1" if probe["matplotlib"] else "0"]
    clock = StepClock(pretrain.make_pretrain_step)
    pretrain.make_pretrain_step = clock
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dl.reset_launch_counts()  # the main path's run starts here
        state = run_cli(pretrain, common + ["--epochs", str(CLI_EPOCHS),
                                            "--max_steps", str(steps - 1)], clock)
        launches = dict(dl.LAUNCHES)  # read just after the run
        peak = torch.cuda.max_memory_allocated()
        rows = list(clock.rows)
        ptr = state.queue_ptr
        if state.step != steps or ptr != steps * CLI_BATCH % state.queue.shape[0]:
            raise SystemExit(f"CLI ran {state.step} steps, queue_ptr {ptr}")
        if state.queue.device.type != "cuda":
            raise SystemExit("the CLI's state is not on the card")
        del state
        clock.rows = []
        dl.reset_launch_counts()
        resumed = run_cli(pretrain, common + ["--epochs", str(CLI_EPOCHS + 1),
                                              "--max_steps", str(steps),
                                              "--resume", os.path.join(logs, "smoke")], clock)
        resume_launches = dict(dl.LAUNCHES)
    finally:
        pretrain.make_pretrain_step = clock.make
    if resumed.step != steps + 1 or resumed.queue_ptr != (ptr + CLI_BATCH) % resumed.queue.shape[0]:
        raise SystemExit(f"resume: step {resumed.step}, queue_ptr {resumed.queue_ptr}")
    log(f"  resumed from step {steps}: step {resumed.step}, queue_ptr {ptr} -> "
        f"{resumed.queue_ptr}")
    del resumed

    losses = [row[-1] for row in rows + clock.rows]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"a CLI loss is not finite: {losses}")
    for name in ("dense_pair_loss_fwd", "dense_pair_loss_bwd"):
        if launches.get(name) != steps or resume_launches.get(name) != 1:
            raise SystemExit(f"{name}: {launches.get(name)} launches in {steps} CLI steps, "
                             f"{resume_launches.get(name)} in 1 resumed step")
    log(f"  launches: {launches} in {steps} steps; {resume_launches} in the resumed step")

    run_dir = os.path.join(logs, "smoke")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metric_rows = [json.loads(line) for line in f]
    step_rows = [r for r in metric_rows if "train/loss_step" in r]
    epoch_rows = [r for r in metric_rows if "train/loss" in r]
    missing = [k for r in step_rows for k in CP2_STEP_KEYS if not math.isfinite(r.get(k, math.nan))]
    if not step_rows or missing or len(epoch_rows) != CLI_EPOCHS + 1:
        raise SystemExit(f"metrics.jsonl: {len(step_rows)} step rows, missing/non-finite "
                         f"{sorted(set(missing))}, {len(epoch_rows)} epoch rows")
    with open(os.path.join(run_dir, "log-pretrain.txt")) as f:
        decoder = [line.split("decoder: ")[1].strip() for line in f if "decoder: " in line]
    log(f"  metrics.jsonl: {len(step_rows)} step rows with every CP2 step key, "
        f"{len(epoch_rows)} epoch rows; decoder {decoder[0]}")

    # epoch 1 (after cuDNN's first choices and the allocator's growth): step
    # calls by kind, leaving out the epoch's first step, which starts while
    # the loaders decode their first batches; end to end over the whole
    # epoch, and over it without that first step
    steady = rows[CLI_STEPS_PER_EPOCH:]
    start, rest = steady[0], steady[1:]
    quiet = [call * 1e3 for lvl, call, _, _ in rest if lvl == 0]
    logged = [call * 1e3 for lvl, call, _, _ in rest if lvl > 0]
    ips = CLI_BATCH * len(steady) / sum(gap for _, _, gap, _ in steady)
    ips_rest = CLI_BATCH * len(rest) / sum(gap for _, _, gap, _ in rest)
    log(f"  step call ms: {['%.1f' % (r[1] * 1e3) for r in rows]}; since the previous "
        f"step's end: {['%.1f' % (r[2] * 1e3) for r in rows]} (epochs 0 and 1)")
    half = CLI_STEPS_PER_EPOCH // 2
    halves = [statistics.median(r[1] * 1e3 for r in part)
              for part in (steady[1:half], steady[half:])]
    log(f"  epoch 1: step call median {halves[0]:.1f} ms over steps 1-{half - 1}, "
        f"{halves[1]:.1f} ms over steps {half}-{CLI_STEPS_PER_EPOCH - 1}")
    log(f"  epoch 1: quiet step median {statistics.median(quiet):.2f} ms ({len(quiet)}), "
        f"logged step median {statistics.median(logged):.2f} ms ({len(logged)}), first step "
        f"{start[1] * 1e3:.1f} ms ({start[2] * 1e3:.1f} ms since the epoch's start); end to "
        f"end {ips:.1f} images/s, {ips_rest:.1f} without the first step (loader, copy and "
        f"augmentation included); peak memory {peak / 2**30:.2f} GiB; on {gpu_line()}")
    # the run's checkpoints stay until phase 11 has finetuned from them
    return launches, dict(
        steps=steps, step_call_ms=[r[1] * 1e3 for r in rows],
        step_gap_ms=[r[2] * 1e3 for r in rows], step_levels=[r[0] for r in rows],
        quiet_ms_median=statistics.median(quiet), logged_ms_median=statistics.median(logged),
        epoch_first_step_ms=start[1] * 1e3, half_epoch_medians_ms=halves, images_per_s=ips,
        images_per_s_without_epoch_start=ips_rest, peak_bytes=peak, decoder=decoder[0], probe=probe,
        resume_launches=resume_launches)


# ---------------------------------------------------------------------------
# phase 8: every variant's step, card against CPU, at a narrow width
# ---------------------------------------------------------------------------

SMALL_MOCO_MODEL = dict(  # config_moco.py's shape at width 8
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                  norm_cfg=dict(type="BN")),
    decode_head=dict(type="FCNHead", num_convs=0, concat_input=False, in_channels=64,
                     in_index=3, channels=64, num_classes=2, norm_cfg=dict(type="BN")),
)
PROPOSED_SH = dict(mapping_type="PIXEL_REGION_ID", lmbd_pixel_corr_weight=10.0,
                   lmbd_region_corr_weight=1.0, lmbd_not_corr_weight=0.0)
SYM_COORD = dict(use_symmetrical_loss=True, use_predictor=True, lmbd_coordinate=0.5)
# case -> (pretrain type, model config, backbone type, hyperparameters, batch);
# BYOL's MLP BatchNorms normalise over the batch alone, so it takes 8
VARIANT_CASES = {
    "MOCO": ("MOCO", SMALL_MOCO_MODEL, "DEEPLABV3", {}, 2),
    "BYOL": ("BYOL", SMALL_MOCO_MODEL, "DEEPLABV3", {}, 8),
    "DENSECL": ("DENSECL", SMALL_MOCO_MODEL, "DEEPLABV3", {}, 2),
    "PROPOSED_V2": ("PROPOSED_V2", SMALL_MODEL, "DEEPLABV3", SYM_COORD, 2),
    "PROPOSED_PIXEL_REGION_ID": ("PROPOSED", SMALL_MODEL, "DEEPLABV3", PROPOSED_SH, 2),
    **{f"PROPOSED_{neg}": ("PROPOSED", SMALL_MODEL, "DEEPLABV3",
                           dict(negative_type=neg, negative_scale=2.0), 2)
       for neg in ("FIXED", "AVERAGE", "MEDIAN", "HARD")},
    "CP2_UNET_TRUNCATED": ("CP2", SMALL_MODEL, "UNET_TRUNCATED", {}, 2),
    "CP2_UNET_ENCODER_ONLY": ("CP2", SMALL_MODEL, "UNET_ENCODER_ONLY", {}, 2),
}
# biases whose every path to the loss passes a train-mode BatchNorm (BYOL's
# MLPs; tests/test_torch_variant_steps.py): zero-initialised, with a zero
# gradient in exact arithmetic, they hold rounding noise after a step, so
# each is held to its layer's weight update instead of its own size
BN_FED_BIASES = {"BYOL": ("projector.mlp.fc1.bias", "projector.mlp.fc2.bias",
                          "predictor.fc1.bias")}


def variant_batch(batch, hw, device):
    """The pre-augmented batch with view b's pixel ids shifted by 32 rows and
    new in its right half, and region ids in 8x8 blocks of 0..8 (0 unknown)."""
    out = pre_augmented_batch(batch, hw, 0, "cpu")
    ids_b = torch.roll(out["pixel_ids_a"], 32, dims=1)
    ids_b[:, :, hw // 2:] += hw * hw
    r = np.random.RandomState(1)
    regions = torch.from_numpy(r.randint(0, 9, (batch, hw // 8, hw // 8)).astype(np.int32))
    regions = regions.repeat_interleave(8, 1).repeat_interleave(8, 2)
    out.update(pixel_ids_b=ids_b, region_ids_a=regions,
               region_ids_b=torch.roll(regions, 32, dims=1))
    return {k: v.to(device) for k, v in out.items()}


def narrow_unets():
    """The U-Nets' ResNet-50 at width 8 (they build it at full width)."""
    import functools

    import cp2_tpu_torch.models.unet as unet
    from cp2_tpu_torch.models.resnet import ResNet

    unet.ResNet = functools.partial(ResNet, stem_channels=8, base_channels=8)
    return lambda: setattr(unet, "ResNet", ResNet)


def variant_steps_cuda_vs_cpu(dl):
    """Phase 8: one float32 step of each case from one seed on both
    devices, at phase 4's tolerance; the dense-loss kernel launches once
    forward and once backward in the kernel-route cases, never in the
    others.  Returns the launches by case."""
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl.objectives import uses_dense_kernel
    from cp2_tpu_torch.ssl.train_step import (
        backbone_output_stride_of, dense_output_stride_of, make_optimizer,
        make_pretrain_step)
    from cp2_tpu_torch.types import BackboneType, MappingType, NegativeType, PretrainType

    restore = narrow_unets()
    launches = {}
    try:
        for case, (pt, cfg, bt, kw, batch) in VARIANT_CASES.items():
            pt, bt = PretrainType[pt], BackboneType[bt]
            kw = dict(kw)
            if "mapping_type" in kw:
                kw["mapping_type"] = MappingType[kw["mapping_type"]]
            if "negative_type" in kw:
                kw["negative_type"] = NegativeType[kw["negative_type"]]
            hp = SSLHyperParams.for_variant(pt, dim=16, queue_len=64, backbone_type=bt, **kw)
            out = {}
            for device in ("cpu", "cuda"):
                model = SSLEncoder(cfg, pretrain_type=pt, backbone_type=bt, dim=16,
                                   img_hw=(64, 64))
                state = create_pretrain_state(model, make_optimizer("sgd", 1e-3), hp,
                                              seed=0, device=device)
                start = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
                step = make_pretrain_step(hp, dense_output_stride_of(cfg, bt),
                                          backbone_output_stride_of(cfg, bt))
                if device == "cuda":
                    torch.cuda.synchronize()
                    dl.reset_launch_counts()
                state, metrics = step(state, variant_batch(batch, 64, device))
                if device == "cuda":
                    torch.cuda.synchronize()
                    launches[case] = dict(dl.LAUNCHES)
                out[device] = (metrics["loss"].item(),
                               {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                               state.queue.cpu(), state.queue2.cpu(),
                               (state.queue_ptr, state.queue2_ptr))
                del state, model
            (l_cpu, sd_cpu, q_cpu, q2_cpu, ptr_cpu), (l_gpu, sd_gpu, q_gpu, q2_gpu, ptr_gpu) = (
                out["cpu"], out["cuda"])
            err_loss = abs(l_gpu - l_cpu) / abs(l_cpu)

            def state_err(key):
                if key in BN_FED_BIASES.get(case, ()):
                    weight = key[:-len("bias")] + "weight"
                    scale = (sd_cpu[weight] - start[weight]).abs().max()
                    return float((sd_gpu[key] - sd_cpu[key]).abs().max() / scale)
                return max_rel(sd_gpu[key], sd_cpu[key])

            err_state = max(state_err(k) for k in sd_cpu if sd_cpu[k].abs().max() > 0)
            err_queue = max(max_rel(q_gpu, q_cpu), max_rel(q2_gpu, q2_cpu))
            kernel = uses_dense_kernel(hp) and pt in (PretrainType.CP2, PretrainType.PROPOSED)
            want = 1 if kernel else 0
            ok = (math.isfinite(l_gpu) and err_loss <= 1e-4 and err_state <= 1e-4
                  and err_queue <= 1e-4 and ptr_gpu == ptr_cpu
                  and all(v == want for v in launches[case].values()))
            log(f"  {case:26s} loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {err_loss:.2e}), state "
                f"{err_state:.2e}, queues {err_queue:.2e}, ptrs {ptr_gpu}, dense-loss "
                f"launches {launches[case]} ({'kernel' if kernel else 'plain'} route) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase 8: {case} on the card disagrees with the CPU")
    finally:
        restore()
    return launches


# ---------------------------------------------------------------------------
# phase 9: the pretrain CLI per variant at full width
# ---------------------------------------------------------------------------

CLI9_STEPS = 6
CLI9_WORK = os.path.join("work_dirs", "chip_smoke_variants")
CONFIG_MOCO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cp2_tpu_torch",
                           "configs", "config_moco.py")
# run -> (flags, (queue, queue2) keys enqueued a step, dense-kernel route)
CLI9_RUNS = {
    "MOCO": (["--pretrain_type", "MOCO", "--config", CONFIG_MOCO], (1, 0), False),
    "BYOL": (["--pretrain_type", "BYOL", "--config", CONFIG_MOCO], (0, 0), False),
    "DENSECL": (["--pretrain_type", "DENSECL", "--config", CONFIG_MOCO, "--lr", "1e-3"],
                (1, 1), False),
    "PROPOSED_V2": (["--pretrain_type", "PROPOSED_V2", "--use_symmetrical_loss",
                     "--use_predictor", "--lmbd_coordinate", "0.5", "--lmbd_cp2_dense_loss",
                     "0.5", "--dense_logits_temp", "0.2", "--instance_logits_temp", "0.2"],
                    (1, 1), False),
    "PROPOSED": (["--pretrain_type", "PROPOSED", "--mapping_type", "PIXEL_REGION_ID",
                  "--lmbd_pixel_corr_weight", "10", "--lmbd_region_corr_weight", "1",
                  "--lmbd_not_corr_weight", "0"], (1, 0), False),
    "PROPOSED_MEDIAN": (["--pretrain_type", "PROPOSED", "--negative_type", "MEDIAN",
                         "--negative_scale", "2"], (1, 0), False),
    "CP2_UNET_TRUNCATED": (["--backbone_type", "UNET_TRUNCATED"], (1, 0), True),
    "CP2_UNET_ENCODER_ONLY": (["--backbone_type", "UNET_ENCODER_ONLY"], (1, 0), True),
}
INSTANCE_KEYS = [f"step/instance_{s}_scores" for s in (
    "average_positive", "average_negative", "lower_negative", "median_negative",
    "upper_negative")]
DENSECL_STEP_KEYS = (["train/loss_step", "train/loss_ins_step", "train/loss_dense_step",
                      "step/cross_image_variance_source_step",
                      "step/cross_image_variance_target_step", "step/average_iou",
                      "step/non_zero_iou_ratio", "step/matching_positives_rate",
                      "step/dense_average_positive_scores",
                      "step/dense_average_negative_scores"] + INSTANCE_KEYS)
# the step keys of metrics_level 1 (cp2_tpu/ssl/objectives.py:220-243,320-327,
# 381-385,565-576)
VARIANT_STEP_KEYS = {"MOCO": ["train/loss_step", "train/acc_ins_step"] + INSTANCE_KEYS,
                     "BYOL": ["train/loss_step"], "DENSECL": DENSECL_STEP_KEYS,
                     "PROPOSED_V2": DENSECL_STEP_KEYS, "PROPOSED": CP2_STEP_KEYS,
                     "CP2": CP2_STEP_KEYS}


def write_region_maps(image_paths, hw=(256, 256), seed=0):
    """Synthetic SAM region maps at ``<root>/SAM_Masks/<stem>.png`` for images
    under ``<root>/<dir>/``: ids 0..8 in 32x32 blocks, 0 unknown, as 8-bit
    grey PNGs."""
    from cp2_tpu_torch.data.datasets import region_mask_path

    r = np.random.RandomState(seed)
    for path in image_paths:
        ids = r.randint(0, 9, (hw[0] // 32, hw[1] // 32)).repeat(32, 0).repeat(32, 1)
        mask = region_mask_path(path)
        os.makedirs(os.path.dirname(mask), exist_ok=True)
        write_png(mask, ids.astype(np.uint8))


def augmentation_layout():
    """Strides of the augmentation's img_a, the layout each CLI step's model
    input has (PERF.md §5: it sets the step's speed)."""
    from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment

    raw = {k: torch.zeros((2, 256, 256, 3), dtype=torch.uint8, device="cuda")
           for k in ("fg", "bg0", "bg1")}
    img = pretrain_batch_augment(torch.Generator(device="cuda").manual_seed(0), raw,
                                 AugmentConfig(out_hw=(224, 224)))["img_a"]
    order = sorted(range(4), key=lambda d: -img.stride(d))
    return "".join("NHWC"[d] for d in order)


def check_unet_kernel_on_step_features(dl, state):
    """Phase 5's check at S² = 784: the kernel against the plain version on
    the UNET_TRUNCATED state's own dense features."""
    batch = pre_augmented_batch(32, 224, 0, "cuda")
    q, k, a, b = dense_features(state, batch, 8)
    if tuple(q.shape) != (32, 784, 128):
        raise SystemExit(f"UNET_TRUNCATED dense features {tuple(q.shape)}, want (32, 784, 128)")
    qg = q.detach().clone().requires_grad_()
    loss = dl.dense_pair_loss(qg, k, a, b, 1.0)
    loss.backward()
    qr = q.detach().clone().requires_grad_()
    ref = dl.dense_pair_loss_reference(qr, k, a, b, 1.0)
    ref.backward()
    err_loss = abs(loss.item() - ref.item()) / abs(ref.item())
    err_dq = max_rel(qg.grad, qr.grad)
    log(f"    UNET_TRUNCATED features (32, 784, 128): kernel loss {loss.item():.6f} plain "
        f"{ref.item():.6f} (rel {err_loss:.2e}), dq max rel {err_dq:.2e}")
    if err_loss > F32_TOL["loss_rtol"] or err_dq > F32_TOL["grad_rtol"]:
        raise SystemExit("kernel disagrees with the plain version on the U-Net's features")
    return dict(loss_rel=err_loss, dq_rel=err_dq,
                max_abs_fwd=abs(loss.item() - ref.item()),
                max_abs_bwd=float((qg.grad - qr.grad).abs().max()))


def check_cli_variants(dl):
    """Phase 9; returns the launches by run and the runs' numbers."""
    from cp2_tpu_torch.ssl.train_step import epoch_scalar_names
    from cp2_tpu_torch.train import pretrain
    from cp2_tpu_torch.types import PretrainType

    shutil.rmtree(CLI9_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    images = os.path.join(CLI9_WORK, "data", "images")
    paths, _ = synthetic_frames(images, CLI_BATCH * CLI9_STEPS, seed=1)
    write_region_maps(paths)
    log(f"  wrote {len(paths)} PNGs of 256x256 and their SAM region maps in "
        f"{time.perf_counter() - t0:.1f} s")
    layout = augmentation_layout()
    log(f"  model input layout (the augmentation's img_a, by stride): {layout}")
    logs = os.path.join(CLI9_WORK, "logs")
    common = ["--log_dir", logs, "--data_dirs", images, "-b", str(CLI_BATCH),
              "--img_height", "224", "--img_width", "224", "--metrics_level", "1",
              "--scalar-freq", "3", "--print-freq", "3", "--visual-freq", "0"]
    clock = StepClock(pretrain.make_pretrain_step)
    pretrain.make_pretrain_step = clock
    launches, numbers = {}, {}
    try:
        for run, (flags, enqueues, kernel) in CLI9_RUNS.items():
            clock.rows = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dl.reset_launch_counts()  # this path's run starts here
            state = run_cli(pretrain, ["--run_id", run, "--epochs", "1"] + common + flags,
                            clock)
            launches[run] = dict(dl.LAUNCHES)  # read just after the run
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            rows = list(clock.rows)
            pt_name = (flags[flags.index("--pretrain_type") + 1]
                       if "--pretrain_type" in flags else "CP2")
            k = state.queue.shape[0]
            want_ptrs = tuple(e * CLI9_STEPS * CLI_BATCH % k for e in enqueues)
            losses = [row[-1] for row in rows]
            problems = []
            if state.step != CLI9_STEPS or len(rows) != CLI9_STEPS:
                problems.append(f"{state.step} steps")
            if k != 65536:
                problems.append(f"queue of {k}")
            if (state.queue_ptr, state.queue2_ptr) != want_ptrs:
                problems.append(f"queue ptrs {(state.queue_ptr, state.queue2_ptr)}, want {want_ptrs}")
            if not all(math.isfinite(x) for x in losses):
                problems.append(f"losses {losses}")
            want = CLI9_STEPS if kernel else 0
            if any(v != want for v in launches[run].values()):
                problems.append(f"dense-loss launches {launches[run]}, want {want} each")
            with open(os.path.join(logs, run, "metrics.jsonl")) as f:
                metric_rows = [json.loads(line) for line in f]
            step_rows = [r for r in metric_rows if "train/loss_step" in r]
            epoch_rows = [r for r in metric_rows if "train/loss" in r]
            missing = sorted({key for r in step_rows for key in VARIANT_STEP_KEYS[pt_name]
                              if not math.isfinite(r.get(key, math.nan))})
            epoch_missing = [n for n in epoch_scalar_names(PretrainType[pt_name])
                             if not epoch_rows or not math.isfinite(epoch_rows[-1].get(n, math.nan))]
            if len(step_rows) != 2 or missing or epoch_missing:
                problems.append(f"metrics.jsonl: {len(step_rows)} step rows, missing or "
                                f"non-finite {missing}, epoch keys {epoch_missing}")
            unet_check = None
            if run == "CP2_UNET_TRUNCATED" and not problems:
                unet_check = check_unet_kernel_on_step_features(dl, state)
            quiet = [r[1] * 1e3 for r in rows if r[0] == 0]
            logged = [r[1] * 1e3 for i, r in enumerate(rows) if r[0] > 0 and i > 0]
            ips = CLI_BATCH * (len(rows) - 1) / sum(r[2] for r in rows[1:])
            numbers[run] = dict(
                pretrain_type=pt_name, flags=flags, step_call_ms=[r[1] * 1e3 for r in rows],
                step_gap_ms=[r[2] * 1e3 for r in rows], step_levels=[r[0] for r in rows],
                losses=losses, quiet_ms_median=statistics.median(quiet),
                logged_ms=logged, images_per_s_after_first_step=ips, peak_bytes=peak,
                run_wall_s=wall, queue_ptrs=[state.queue_ptr, state.queue2_ptr],
                launches=launches[run], input_layout=layout, unet_kernel_check=unet_check)
            log(f"  {run:22s} losses {['%.4f' % x for x in losses]}; quiet step median "
                f"{numbers[run]['quiet_ms_median']:.1f} ms, logged {['%.1f' % x for x in logged]} ms,"
                f" first {rows[0][1] * 1e3:.1f} ms; {ips:.1f} images/s after the first step; "
                f"peak {peak / 2**30:.2f} GiB; queue ptrs {(state.queue_ptr, state.queue2_ptr)}; "
                f"dense-loss launches {launches[run]}; run {wall:.1f} s "
                f"{'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
            if problems:
                raise SystemExit(f"phase 9: {run}: {'; '.join(problems)}")
            del state
            torch.cuda.empty_cache()

        # a 1-step --resume of the DenseCL run: step, both pointers, parity
        clock.rows = []
        dl.reset_launch_counts()
        run = "DENSECL"
        resumed = run_cli(pretrain, ["--run_id", run, "--epochs", "2", "--max_steps",
                                     str(CLI9_STEPS), "--resume", os.path.join(logs, run)]
                          + common + CLI9_RUNS[run][0], clock)
        want_ptrs = tuple((CLI9_STEPS + 1) * CLI_BATCH % 65536 for _ in range(2))
        ok = (resumed.step == CLI9_STEPS + 1
              and (resumed.queue_ptr, resumed.queue2_ptr) == want_ptrs
              and all(math.isfinite(r[-1]) for r in clock.rows) and len(clock.rows) == 1)
        log(f"  DENSECL --resume from step {CLI9_STEPS}: step {resumed.step} (parity "
            f"{CLI9_STEPS % 2} at the resumed step), queue ptrs "
            f"{(resumed.queue_ptr, resumed.queue2_ptr)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase 9: the DenseCL resume did not carry its state")
        numbers["DENSECL"]["resume"] = dict(step=resumed.step,
                                            queue_ptrs=[resumed.queue_ptr, resumed.queue2_ptr])
        del resumed
        torch.cuda.empty_cache()
    finally:
        pretrain.make_pretrain_step = clock.make
    shutil.rmtree(CLI9_WORK, ignore_errors=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 10: the finetune path at a narrow width, card against CPU
# ---------------------------------------------------------------------------

# config_finetune.py's structure at width 8 (dilated ResNet-50, OS 16, the
# ASPP classifier) with an FCN auxiliary head; no dropout, so that both
# devices compute the same function
SMALL_SEG_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(SMALL_MODEL["backbone"]),
    decode_head=dict(type="ASPPHead", in_channels=256, in_index=3, channels=16,
                     dilations=(1, 6, 12, 18), dropout_ratio=0.0, num_classes=2,
                     norm_cfg=dict(type="BN")),
    auxiliary_head=dict(type="FCNHead", in_channels=128, in_index=2, channels=8, num_convs=1,
                        concat_input=False, dropout_ratio=0.0, num_classes=2,
                        norm_cfg=dict(type="BN")),
)
FT_AUG_ATOL = 1e-6


def seg_batch(n, hw, seed, classes=2):
    """Images whose brightness and contrast differ per image (the ASPP
    image-pool branch normalises per-image means over the batch), blocky
    masks; numpy."""
    r = np.random.RandomState(seed)
    img = r.rand(n, hw, hw, 3) * r.uniform(0.2, 1.0, (n, 1, 1, 3)) + r.uniform(0, 0.5, (n, 1, 1, 3))
    mask = r.randint(0, classes, (n, hw // 8, hw // 8)).repeat(8, 1).repeat(8, 2)
    return np.clip(img, 0, 1).astype(np.float32), mask.astype(np.int32)


def check_finetune_augment():
    """The finetune augmentation of polyp and lemon (grid distortion forced
    on), parameters drawn once on the CPU: the card's images within
    ``FT_AUG_ATOL`` of the CPU's, masks equal; and the val flips."""
    import dataclasses

    from cp2_tpu_torch.augment import pipeline as P

    out = {}
    cases = {"polyp": (P.FinetuneAugmentConfig(distort_p=1.0), 16, (352, 352), 2),
             "lemon": (dataclasses.replace(P.lemon_augment_config(), distort_p=1.0), 4,
                       (544, 1024), 12)}
    for name, (cfg, n, hw, classes) in cases.items():
        r = np.random.RandomState(5)
        img = torch.from_numpy(r.randint(0, 256, (n, *hw, 3), dtype=np.uint8))
        mask = torch.from_numpy(r.randint(0, classes, (n, *hw)).astype(np.int32))
        params = P.sample_finetune_params(torch.Generator().manual_seed(1), n, hw, cfg)
        ref_img, ref_mask = P.apply_finetune_augment(img, mask, params)
        got_img, got_mask = P.apply_finetune_augment(img.cuda(), mask.cuda(),
                                                     to_device(params, "cuda"))
        err = float((got_img.cpu() - ref_img).abs().max())
        masks_equal = torch.equal(got_mask.cpu(), ref_mask)
        moved = int((ref_mask != mask).sum())
        ev = P.sample_eval_params(torch.Generator().manual_seed(2), n, vflip_p=0.0,
                                  distort_p=1.0)
        ref_ev = P.apply_eval_augment(ref_img, ref_mask, ev)
        got_ev = P.apply_eval_augment(ref_img.cuda(), ref_mask.cuda(), to_device(ev, "cuda"))
        ev_err = float((got_ev[0].cpu() - ref_ev[0]).abs().max())
        ev_equal = torch.equal(got_ev[1].cpu(), ref_ev[1])
        ok = err <= FT_AUG_ATOL and masks_equal and ev_err <= FT_AUG_ATOL and ev_equal
        log(f"  augment {name} ({n}, {hw[0]}, {hw[1]}): images max abs diff {err:.2e}, masks "
            f"{'equal' if masks_equal else 'DIFFER'} ({moved} mask pixels moved by the warp and "
            f"flips); val flips + distortion {ev_err:.2e}, masks "
            f"{'equal' if ev_equal else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 10: the {name} augmentation on the card disagrees")
        out[name] = dict(max_abs_err=err, eval_max_abs_err=ev_err, mask_pixels_moved=moved)
    return out


def check_finetune_step(dl):
    """One float32 train step and a padded eval step of the narrow segmentor
    from one seed on both devices."""
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.train import segmentation_task as task

    img, mask = seg_batch(8, 64, 0)
    ev_img, ev_mask = seg_batch(4, 64, 1)
    valid = np.array([True, True, True, False])
    train_step, eval_step, _ = task.make_seg_steps(2, (64, 64))
    out = {}
    for device in ("cpu", "cuda"):
        model = init_flax_like_(build_segmentor(SMALL_SEG_MODEL), torch.Generator().manual_seed(0))
        state = task.create_seg_state(model, task.make_adam(1e-4, 1e-4), device)
        batch = {"image": torch.from_numpy(img).to(device), "mask": torch.from_numpy(mask).to(device)}
        if device == "cuda":
            torch.cuda.synchronize()
            dl.reset_launch_counts()
        state, conf, m = train_step(state, batch, torch.Generator(device=device).manual_seed(0),
                                    ConfusionState.create(2, device))
        ev_batch = {"image": torch.from_numpy(ev_img).to(device),
                    "mask": torch.from_numpy(ev_mask).to(device),
                    "valid": torch.from_numpy(valid).to(device)}
        ev_conf, ev_m = eval_step(state, ev_batch, ConfusionState.create(2, device))
        if device == "cuda":
            torch.cuda.synchronize()
            launches = dict(dl.LAUNCHES)
        out[device] = dict(
            loss=m["loss"].item(),
            grads={k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
            buffers={k: b.detach().cpu() for k, b in state.model.named_buffers()},
            conf=conf.matrix.cpu(), ev_conf=ev_conf.matrix.cpu(), ev_loss=ev_m["loss"].item())
        del state, model
    cpu, gpu = out["cpu"], out["cuda"]
    err_loss = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    err_grad = max(max_rel(gpu["grads"][k], v) for k, v in cpu["grads"].items() if v.abs().max() > 0)
    err_stats = max(max_rel(gpu["buffers"][k], v) for k, v in cpu["buffers"].items())
    err_ev = abs(gpu["ev_loss"] - cpu["ev_loss"]) / abs(cpu["ev_loss"])
    counts_equal = torch.equal(gpu["conf"], cpu["conf"]) and torch.equal(gpu["ev_conf"], cpu["ev_conf"])
    padded_out = int(cpu["ev_conf"].sum()) == 3 * 64 * 64
    ok = (err_loss <= 1e-4 and err_grad <= 1e-4 and err_stats <= 1e-4 and err_ev <= 1e-4
          and counts_equal and padded_out and all(v == 0 for v in launches.values()))
    log(f"  finetune step, card vs CPU (float32, batch 8, 64x64): loss rel {err_loss:.2e}, "
        f"gradients {err_grad:.2e}, BatchNorm stats {err_stats:.2e} (each normwise, 1e-4); "
        f"eval with a padded row: loss rel {err_ev:.2e}, confusion counts "
        f"{'equal' if counts_equal else 'DIFFER'} ({int(cpu['ev_conf'].sum())} pixels counted); "
        f"dense-loss launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 10: the finetune step on the card disagrees with the CPU")
    return launches, dict(loss_rel=err_loss, grad_rel=err_grad, stats_rel=err_stats,
                          eval_loss_rel=err_ev)


# ---------------------------------------------------------------------------
# phase 11: the finetune CLI at full width
# ---------------------------------------------------------------------------

FT_WORK = os.path.join("work_dirs", "chip_smoke_finetune")
FT_BATCH, FT_EPOCHS = 16, 2
FT_SPLITS = {"train": 4 * FT_BATCH, "val": FT_BATCH + 4, "test": 2 * FT_BATCH + 4}
LEMON_SPLITS = {"train": 2 * FT_BATCH, "val": 8, "test": FT_BATCH}


def synthetic_pairs(root, splits, hw, classes, seed):
    """Smooth RGB frames with blob masks (binary 0/255 for 2 classes, else
    ids 0..classes-1 in blocks) as PNG pairs under ``root/images`` and
    ``root/masks``, stems carrying their split."""
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    for d in ("images", "masks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    count = 0
    for split, n in splits.items():
        for i in range(n):
            f = r.uniform(1, 6, (3, 2))
            ph = r.uniform(0, 2 * np.pi, (3,))
            img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx) + ph[c])
                            for c in range(3)], axis=-1)
            if classes == 2:
                cy, cx, ry, rx = r.uniform(0.3, 0.7), r.uniform(0.3, 0.7), *r.uniform(0.1, 0.3, 2)
                blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
                img[blob] = 0.6 * img[blob] + 0.4 * np.array([0.9, 0.3, 0.3])
                mask = blob.astype(np.uint8) * 255
            else:
                ids = r.randint(0, classes, (hw[0] // 32 + 1, hw[1] // 32 + 1))
                mask = ids.repeat(32, 0).repeat(32, 1)[:hw[0], :hw[1]].astype(np.uint8)
            stem = f"{split}_{i:04d}.png"
            write_png(os.path.join(root, "images", stem), (np.clip(img, 0, 1) * 255).astype(np.uint8))
            write_png(os.path.join(root, "masks", stem), mask)
            count += 1
    return count


class FinetuneClock:
    """Wraps ``make_seg_steps`` so that every train and eval step ends in
    ``torch.cuda.synchronize()``; records (kind, call s, since the previous
    train step's end s, loss) per call."""

    def __init__(self, make):
        self.make = make
        self.rows = []
        self.last = None

    def __call__(self, *a, **kw):
        train_step, eval_step, metrics_of = self.make(*a, **kw)

        def timed_train(state, batch, generator, confusion):
            start = time.perf_counter()
            state, confusion, m = train_step(state, batch, generator, confusion)
            loss = m["loss"].item()
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.rows.append(("train", now - start, now - self.last, loss))
            self.last = now
            return state, confusion, m

        def timed_eval(state, batch, confusion):
            start = time.perf_counter()
            confusion, m = eval_step(state, batch, confusion)
            loss = m["loss"].item()
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.rows.append(("eval", now - start, now - self.last, loss))
            return confusion, m

        return timed_train, timed_eval, metrics_of


class ChannelsLast(torch.nn.Module):
    """The segmentor fed a channels-last copy of its input: what the step
    would run without ``seg_forward``'s explicit NCHW."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.auxiliary_head = inner.auxiliary_head

    def forward(self, x, **kw):
        return self.inner(x.contiguous(memory_format=torch.channels_last), **kw)


def time_layouts(config, hw):
    """The finetune train step on one full-width batch (the polyp run's
    config, batch 16, bfloat16, random weights), the model input contiguous
    NCHW as ``seg_forward`` makes it, and channels-last: median of 5 calls
    after 2 warm-up calls each."""
    from cp2_tpu_torch.augment import FinetuneAugmentConfig, finetune_augment_batch
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.train import segmentation_task as task

    cfg = Config.fromfile(config)
    cfg.model.decode_head.num_classes = 2
    model_cfg = dict(cfg.model, dtype=torch.bfloat16)
    model = init_flax_like_(build_segmentor(model_cfg), torch.Generator().manual_seed(0))
    state = task.create_seg_state(model, task.make_adam(1e-4, 1e-4), "cuda")
    r = np.random.RandomState(0)
    raw = torch.from_numpy(r.randint(0, 256, (FT_BATCH, *hw, 3), dtype=np.uint8)).cuda()
    raw_mask = torch.from_numpy(r.randint(0, 2, (FT_BATCH, *hw)).astype(np.int32)).cuda()
    images, masks = finetune_augment_batch(torch.Generator(device="cuda").manual_seed(0), raw,
                                           raw_mask, FinetuneAugmentConfig())
    batch = {"image": images, "mask": masks}
    train_step, _, _ = task.make_seg_steps(2, hw)
    out = {}
    for name, net in (("nchw", model), ("channels_last", ChannelsLast(model))):
        probe = task.SegTrainState(model=net, optimizer=state.optimizer, step=0)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_step(probe, batch, torch.Generator(device="cuda").manual_seed(0),
                       ConfusionState.create(2, "cuda"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times[2:])
    del state, model
    torch.cuda.empty_cache()
    return out


def eval_seconds(rows, evals_per_epoch):
    """Each epoch's eval time: from the end of its last train step to the
    end of its ``evals_per_epoch``-th eval call (val with flips, then the
    pseudo-test), from ``FinetuneClock`` rows."""
    out = []
    for k, row in enumerate(rows):
        if row[0] != "train" or k + 1 == len(rows) or rows[k + 1][0] != "eval":
            continue
        following = []
        for later in rows[k + 1:]:
            if later[0] != "eval":
                break
            following.append(later)
        out.append(following[evals_per_epoch - 1][2] if len(following) >= evals_per_epoch
                   else math.nan)
    return out


def run_finetune(finetune, argv, clock, reports):
    args = finetune.get_args(argv)
    clock.rows = []
    reports.clear()
    clock.last = time.perf_counter()
    return finetune.main(args), args


def check_finetune_cli(dl):
    """Phase 11; returns the launches by run and the runs' numbers."""
    from cp2_tpu_torch.checkpoint import convert
    from cp2_tpu_torch.ops import metrics
    from cp2_tpu_torch.train import finetune, segmentation_task
    import cp2_tpu_torch

    shutil.rmtree(FT_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    polyp = os.path.join(FT_WORK, "polyp")
    lemon = os.path.join(FT_WORK, "lemon")
    n_polyp = synthetic_pairs(polyp, FT_SPLITS, (384, 448), 2, seed=3)
    n_lemon = synthetic_pairs(lemon, LEMON_SPLITS, (272, 512), 12, seed=4)
    log(f"  wrote {n_polyp} polyp pairs of 384x448 and {n_lemon} lemon pairs of 272x512 in "
        f"{time.perf_counter() - t0:.1f} s")
    pretrain_run = os.path.join(CLI_WORK, "logs", "smoke")  # phase 7's CP2 checkpoints
    logs = os.path.join(FT_WORK, "logs")
    config = os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs",
                          "config_finetune.py")
    reports = []
    real_load = convert.load_pretrained_into_segmentor

    def recording_load(*a, **kw):
        merged, report = real_load(*a, **kw)
        reports.append(report)
        return merged, report

    clock = FinetuneClock(segmentation_task.make_seg_steps)
    segmentation_task.make_seg_steps = clock
    convert.load_pretrained_into_segmentor = recording_load
    common = ["--config", config, "--batch_size", str(FT_BATCH), "--visualize_freq", "0",
              "--prefetch_depth", "2", "--pretrain_type", "CP2", "--pretrain_path", pretrain_run,
              "--log_dir", logs]
    runs = {
        "polyp": ["--run_id", "polyp", "--img_dirs", os.path.join(polyp, "images"),
                  "--mask_dirs", os.path.join(polyp, "masks"), "--epochs", str(FT_EPOCHS)],
        "lemon": ["--run_id", "lemon", "--img_dirs", os.path.join(lemon, "images"),
                  "--mask_dirs", os.path.join(lemon, "masks"), "--lemon_data", "--fast_dev_run"],
        "linear_evaluation": ["--run_id", "linear", "--img_dirs", os.path.join(polyp, "images"),
                              "--mask_dirs", os.path.join(polyp, "masks"), "--linear_evaluation",
                              "--fast_dev_run"],
    }
    launches, numbers = {}, {}
    try:
        for run, flags in runs.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            dl.reset_launch_counts()  # this path's run starts here
            t = time.perf_counter()
            test_metrics, args = run_finetune(finetune, common + flags, clock, reports)
            wall = time.perf_counter() - t
            launches[run] = dict(dl.LAUNCHES)  # read just after the run
            peak = torch.cuda.max_memory_allocated()
            rows = list(clock.rows)
            run_dir = os.path.join(logs, args.run_id)
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                metric_rows = [json.loads(line) for line in f]
            classes = args.num_classes
            monitor = "val_BinaryJaccardIndex" if classes == 2 else "val_MulticlassJaccardIndex"
            binary = classes == 2
            want_test = {f"test_{k}" for k in metrics.compute_metrics(
                metrics.ConfusionState.create(classes), binary=binary,
                ignore_index=None if binary else 0)} | {"test_loss"}
            epoch_rows = [r for r in metric_rows if "epoch" in r]
            best = [d for d in os.listdir(run_dir) if d.isdigit()]
            train_rows = [r for r in rows if r[0] == "train"]
            problems = []
            if not reports or not reports[0]["loaded"]:
                problems.append("the graft loaded no tensor")
            if not all(math.isfinite(r[-1]) for r in rows):
                problems.append(f"losses {[r[-1] for r in rows]}")
            if not epoch_rows or any(not math.isfinite(r.get(monitor, math.nan)) for r in epoch_rows):
                problems.append(f"{monitor} missing from metrics.jsonl")
            if len(best) != 1:
                problems.append(f"{len(best)} checkpoints left: {best}")
            if set(test_metrics) != want_test or not all(math.isfinite(v) for v in test_metrics.values()):
                problems.append(f"test keys {sorted(test_metrics)}")
            if any(v != 0 for v in launches[run].values()):
                problems.append(f"dense-loss launches {launches[run]}")
            numbers[run] = dict(
                flags=flags, img_hw=[args.img_height, args.img_width], classes=classes,
                batch=args.batch_size, loaded_tensors=len(reports[0]["loaded"]) if reports else 0,
                train_step_ms=[r[1] * 1e3 for r in train_rows],
                train_gap_ms=[r[2] * 1e3 for r in train_rows],
                losses=[r[-1] for r in train_rows], peak_bytes=peak, run_wall_s=wall,
                test_metrics=test_metrics, epochs=epoch_rows, launches=launches[run])
            if run == "polyp" and not problems:
                steps_per_epoch = FT_SPLITS["train"] // FT_BATCH
                epoch1 = train_rows[steps_per_epoch:]
                quiet = statistics.median(r[1] * 1e3 for r in epoch1[1:])
                ips = FT_BATCH * (len(epoch1) - 1) / sum(r[2] for r in epoch1[1:])
                evals = eval_seconds(rows, math.ceil(FT_SPLITS["val"] / FT_BATCH)
                                     + FT_SPLITS["test"] // FT_BATCH)
                layouts = time_layouts(config, (args.img_height, args.img_width))
                numbers[run].update(quiet_step_ms_median=quiet, images_per_s_epoch1=ips,
                                    eval_s_per_epoch=evals, layout_step_ms=layouts,
                                    best_checkpoint=best[0])
                log(f"  polyp: {len(train_rows)} steps over {FT_EPOCHS} epochs; epoch 1 step call "
                    f"median {quiet:.1f} ms (steps 1-{len(epoch1) - 1}), {ips:.1f} images/s end to "
                    f"end after step 0 (loader, copy, augmentation included); eval "
                    f"{['%.2f' % e for e in evals]} s per epoch (val with flips + pseudo-test); "
                    f"the step on one batch: {layouts['nchw']:.1f} ms with the explicit NCHW "
                    f"input, {layouts['channels_last']:.1f} ms channels-last")
            log(f"  {run:18s} {args.img_height}x{args.img_width}, {classes} classes, batch "
                f"{args.batch_size}: loaded {numbers[run]['loaded_tensors']} tensors from "
                f"phase 7's CP2 checkpoint; losses {['%.4f' % r[-1] for r in train_rows]}; "
                f"{monitor} {[round(r.get(monitor, math.nan), 4) for r in epoch_rows]}; test "
                f"{test_metrics.get('test_BinaryJaccardIndex', test_metrics.get('test_MulticlassJaccardIndex')):.4f}; "
                f"best checkpoint {best}; peak {peak / 2**30:.2f} GiB; dense-loss launches "
                f"{launches[run]}; run {wall:.1f} s {'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
            if problems:
                raise SystemExit(f"phase 11: {run}: {'; '.join(problems)}")
            torch.cuda.empty_cache()
    finally:
        segmentation_task.make_seg_steps = clock.make
        convert.load_pretrained_into_segmentor = real_load
    shutil.rmtree(FT_WORK, ignore_errors=True)
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    return launches, numbers


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from cp2_tpu_torch.ops import cuda_build
    from cp2_tpu_torch.ops import dense_loss as dl

    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"{card} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matrix products and convolutions: every float32 "
        "comparison below is in full float32")

    # phase 2: build
    t0 = time.perf_counter()
    built = cuda_build.build(["dense_loss"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    for name, info in built.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        with open(os.path.join("chiprun_out", f"ptxas_{name}.txt"), "w") as f:
            f.write(info["log"])
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in info["log"].splitlines() if "registers" in line})
        spills = [line for line in info["log"].splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        log(f"    registers per thread across instantiations: {', '.join(regs)}; "
            f"{len(spills)} with spills (ptxas log in chiprun_out/)")

    # phase 3: kernels against their plain versions
    log("kernels vs plain:")
    dl.reset_launch_counts()
    flagship = check_kernels(dl)

    # phase 4: a narrow step on the card against the CPU
    log("small step:")
    small_step_cuda_vs_cpu()

    # phase 5: the full-width CP2 step
    log("full-width CP2 step:")
    step_launches, step = full_step(dl)

    # phase 6: the on-device augmentation
    log("augment:")
    aug_ms = check_augment()

    # phase 7: the pretrain CLI (CP2)
    log("pretrain CLI:")
    launches, cli = check_cli(dl)

    # phase 8: every variant's step, card against CPU
    log("variant steps, card vs CPU:")
    variant_launches = variant_steps_cuda_vs_cpu(dl)

    # phase 9: the CLI per variant at full width
    log("pretrain CLI per variant:")
    cli9_launches, cli9 = check_cli_variants(dl)

    # phase 10: the finetune path, narrow, card against CPU
    log("finetune augmentation and step, card vs CPU:")
    ft_aug = check_finetune_augment()
    ft_step_launches, ft_step = check_finetune_step(dl)

    # phase 11: the finetune CLI at full width, this slice's main path
    log("finetune CLI:")
    ft_launches, ft_cli = check_finetune_cli(dl)
    with open(os.path.join("chiprun_out", "chip_smoke_step.json"), "w") as f:
        json.dump({"card": card, **step, "step_launches": step_launches,
                   "augment": aug_ms, "cli": cli, "variant_step_launches": variant_launches,
                   "cli_variants": cli9, "finetune_augment": ft_aug, "finetune_step": ft_step,
                   "finetune_cli": ft_cli}, f, indent=1)
    log(f"  per-run numbers in chiprun_out/chip_smoke_step.json; on {gpu_line()}")

    def by_path(name):
        """Launches of one kernel on every path the script drives: the
        pretrain step's paths, and the finetune paths, which run no
        dense-loss kernel."""
        paths = {"phase5_step": step_launches[name], "phase7_cli_CP2": launches[name]}
        paths.update({f"phase8_{case}": n[name] for case, n in variant_launches.items()})
        paths.update({f"phase9_cli_{run}": n[name] for run, n in cli9_launches.items()})
        paths["phase10_finetune_step"] = ft_step_launches[name]
        paths.update({f"phase11_finetune_{run}": n[name] for run, n in ft_launches.items()})
        return paths

    kernels = [
        {"name": "dense_pair_loss_fwd", "route": "cuda",
         "source": "cp2_tpu_torch/csrc/dense_loss.cu",
         "replaces": "cp2_tpu/ops/pallas/dense_loss.py:77",
         "launches": launches["dense_pair_loss_fwd"],
         "max_abs_err": flagship["fwd_abs"], "ms": flagship["fwd_ms"],
         "plain_ms": flagship["fwd_plain_ms"], "bound_ms": flagship["fwd_bound_ms"],
         "bound_by": flagship["fwd_bound_by"], "library_ms": None,
         "fp32_fma_bound_ms": flagship["fwd_fp32_fma_bound_ms"],
         "eager_ms": flagship["fwd_eager_ms"],
         "launches_step_phase": step_launches["dense_pair_loss_fwd"],
         "launches_by_path": by_path("dense_pair_loss_fwd"),
         "check": "pass", "shape": list(STEP_SHAPE)},
        {"name": "dense_pair_loss_bwd", "route": "cuda",
         "source": "cp2_tpu_torch/csrc/dense_loss.cu",
         "replaces": "cp2_tpu/ops/pallas/dense_loss.py:107",
         "launches": launches["dense_pair_loss_bwd"],
         "max_abs_err": flagship["bwd_abs"], "ms": flagship["bwd_ms"],
         "plain_ms": flagship["bwd_plain_ms"], "bound_ms": flagship["bwd_bound_ms"],
         "bound_by": flagship["bwd_bound_by"], "library_ms": None,
         "fp32_fma_bound_ms": flagship["bwd_fp32_fma_bound_ms"],
         "eager_ms": flagship["bwd_eager_ms"],
         "launches_step_phase": step_launches["dense_pair_loss_bwd"],
         "launches_by_path": by_path("dense_pair_loss_bwd"),
         "check": "pass", "shape": list(STEP_SHAPE)},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

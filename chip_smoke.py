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
            and eleven more (every channel width the kernels are built
            for, the U-Net steps' S² = 784 and 49, and the experiment
            drivers' batch 64 and 256 at S² = 196 and lemon.sh's
            UNET_ENCODER_ONLY at 512², S² = 256); two runs of each
            kernel on the same inputs must be bit-equal, and so must
            forwards run on two streams at once, and a forward captured in
            a CUDA graph and replayed on a second stream while eager
            forwards run on the first; kernel and plain times at each shape
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
            and the same step with the network fed channels-last;
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
            ``--resume`` from it, each epoch's figures at the default
            ``--visual-freq 1`` decoded by PIL; first, batches staged through the pinned
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
            ``--fast_dev_run``); ``--linear_evaluation --fast_dev_run``, each
            at the default ``--visualize_freq`` (epoch 0's overlays decoded); the
            graft loads tensors, losses finite, the monitored key in
            ``metrics.jsonl``, one best checkpoint left, the test keys, no
            dense-loss launch; quiet step, images/s, eval time per epoch,
            peak memory, and the step with a channels-last input beside it;
12. mirror  the mirror (CutPaste) path on the card against the CPU:
            CutPaste parameters drawn on the CPU and applied on both to
            10 512x512 images with mirrors, REGULAR and SCAR rotated by up to
            45 degrees, up to 3 patches (images to 1e-6, masks and targets
            equal), the samplers on the card's generator against their laws,
            the CLI's whole ``prepare`` at its shape (images to 1e-5); one
            narrow float32 mirror step of OUTPUT and of NONE (dropout 0) to
            1e-4, an eval step with a padded row (counts equal); no
            dense-loss launch;
13. mir cli the mirror pretrain CLI (``cp2_tpu_torch.train.mirror_pretrain``)
            at its defaults: ``config_finetune.py``, 2 classes, batch 10,
            512x512, bfloat16, ``--variant OUTPUT``, 2 epochs of 8 steps on
            synthetic 544x544 PNGs listed by ``train.csv`` and ``val.csv``;
            ``lemon-cutpaste.sh``'s leg (``--lemon_data --variant NONE
            --batch-size 16 --fast_dev_run``, 576x1056 frames); a finetune
            ``--pretrain_type MIRROR --fast_dev_run`` from the OUTPUT run's
            best checkpoint on phase 11's polyp pairs: finite losses, the
            train keys and ``val_loss_epoch``, checkpoints tagged MIRROR, the
            graft loads tensors; step call, images/s, val time, peak memory;
14. serve   inference and serving from phase 11's polyp best checkpoint
            (352x352, bfloat16): ``init_segmentor``, whole inference at batch
            8, slide inference (256 windows, stride 170: a 2x2 grid whose
            counts equal a count by hand), ``dataset_test`` with a flip view
            on 4 images; ``export_segmentor`` whole at batch 8 (the loaded
            artifact's class map equals the live module's), a symbolic batch
            checked at batches 1 and 3, slide logits in float32 within 1e-5;
            latency eager and exported, images/s, artifact bytes, peak memory;
15. iter    the iteration CLI's path at a narrow width, float32: its SGD
            step (poly rate, momentum, decay) on ``tests/test_iter_train_cli
            .py``'s tiny config and a narrow ViT segmentor's step, card
            against CPU (loss, gradients, parameters and statistics to
            1e-4); the ``with_cp`` step against the plain step on the card
            (1e-5); the mmseg pipeline of ``tests/test_data_layer.py`` over
            16 synthetic PNG pairs (whether cv2 is importable is logged: the
            port never imports it); no dense-loss launch;
16. it cli  the iteration CLI (``cp2_tpu_torch.train.iter_train.main``) on
            ``configs/example_iter_train.py`` (ResNet-50, strides 1,2,2,1,
            dilations 1,1,1,2, ASPP-512, 2 classes, 512x512, batch 8,
            float32, SGD with poly rate) on 64 synthetic 576x576 PNG pairs,
            cut to 40 iterations with eval and checkpoints every 20 (the
            config says 40000 and 4000; the cut copy is written beside the
            run); a ``--resume-from`` the iteration-20 checkpoint (step,
            rate and momentum carried); 10 iterations with
            ``backbone.with_cp``, whose peak memory must be lower; iteration
            time (median after 5), images/s, eval seconds, peak memory;
17. vit     the same CLI with ViT-B/16 (768 wide, 12 layers, 12 heads,
            ``img_size`` 224) under an FCN head at 512x512 (the position
            grid resized 14² → 32² each step), batch 8, 20 iterations; and
            its train step with TF32 matrix products beside it.

18. dist    more than one process.  (a) ``initialize(backend="nccl")`` with
            a world of one: two full-width CP2 steps through the
            distributed code path against the same two steps without a
            process group on the same batch and weights (no further apart
            than two runs without a group are).  (b) Two processes sharing
            the card, started with torchrun's environment, each calling
            ``initialize(backend="gloo")`` and running on ``cuda:0``: NCCL
            refuses two ranks on one device (a probe logs its refusal), gloo
            reduces CUDA tensors through the host.  A narrow float32 CP2 step
            in two ranks against the one-process card step on the same
            global batch of 4 (loss, queue and weights 1e-5 normwise; the
            update 1e-4, since a tensor that starts at zero holds only it;
            states, BatchNorm statistics, queues and pointers equal across
            the ranks; one launch of each dense-loss kernel per rank) and
            gloo's all-reduce times; the pretrain CLI at full width
            (``config_pretrain.py``, global batch 32, 224x224, bfloat16, 96
            synthetic PNGs, 6 steps and a 1-step ``--resume``): step times,
            images/s and peak memory per rank, six launches of each kernel
            per rank; ``--fast_dev_run`` of the finetune CLI (polyp 352x352,
            batch 16: rank 0's best checkpoint restored by both ranks) and of
            the mirror CLI, and 4 iterations of the iteration CLI, each rank
            ending with the other's results.  A rank that fails fails the
            phase.
19. scripts the experiment drivers (``cp2_tpu_torch/scripts/*.sh``), on
            synthetic data made from seeds under ``work_dirs/``: (a) each
            twin's ``CP2_SCRIPT_DRYRUN=1`` list equals the JAX driver's
            (configs mapped; same-foreground.sh's MoCo and BYOL pretrains
            given ``config_moco.py``); (b) every distinct pretrain and
            mirror invocation of the drivers in process on its own argv at
            its script's batch and size (sym-coord.sh's loss-weight loop:
            first and last), ``--epochs 1 --max_steps 3`` on exactly 3
            batches of images (``--cap_queue``: a queue of 3 x batch) or
            ``--fast_dev_run``: finite losses, the dense-loss kernels 3 + 3
            on the kernel route of ``ssl/objectives.py`` and 0 elsewhere,
            lemon.sh's kernel against its plain version on its own
            features at (32, 256, 128), the figures; quiet step, images/s,
            peak memory; (c) polyp.sh's nine finetunes (``--epochs 2``) and
            a ``--fast_dev_run`` finetune of hist.sh, same-foreground.sh's
            MoCo, BYOL and DenseCL, lemon-cutpaste.sh and imgnet-pretrained.sh
            on a synthetic ``.pth`` of each key layout: the graft, the keys,
            one best checkpoint, the overlay, no launch; (d)
            polyp-cutpaste.sh (``EPOCHS=1``: its preflight, then the mirror
            CLI) and dist_train.sh (4 iterations) through bash, each exiting
            0 with its checkpoint.  In-process runs add their launches to
            ``launches_by_path``; the two bash runs count theirs in their
            own processes.
20. tools   the measuring tools, each as a user runs it (``python -m ...``, a
            process of its own, so phase 1's TF32 setting stays here) at its
            JAX twin's defaults with its steps cut: ``cp2_tpu_torch.bench``
            (32 x 224², its end-to-end phases through the loader the CLI
            would choose), ``tools.bench_pretrain_variant`` for DENSECL,
            MOCO, BYOL, PROPOSED and PROPOSED_V2, ``tools.bench_finetune``,
            ``tools.bench_infer``, ``tools.bench_metrics --full-step``,
            ``tools.bench_dense_loss`` (S² 1024, batches 8 to 256: the
            kernel with dk against the plain version at each),
            ``tools.bench_dilated_conv``, ``tools.profile_step`` for both
            tasks, ``python -m cp2_tpu_torch.graft_entry`` (the dry run's
            two gloo ranks on the card) and ``graft_entry.entry()`` here;
            the five variants share one process, and so do profile_step's
            two tasks and the five one-run tools from bench_finetune to
            bench_dilated_conv (each ``main`` in turn).  Each exits 0 with a
            JSON line, rates above 0, ``mfu`` in (0, 1], each counted step's
            FLOPs equal to the count of its configuration on the CPU (meta
            device), the dense-loss kernels once forward and once backward
            per step on the kernel route (``KERNEL_ROUTE``) and never
            elsewhere, against the steps each run counted where they ran
            (its ``LAUNCHES`` line); output in
            ``chiprun_out/chip_smoke_tools_*.log``.
21. gate    the quality gate (``cp2_tpu_torch.tools.quality_gate.main``,
            in process) on a small corpus under ``work_dirs/chip_smoke_gate/``
            (deleted after): 64 train, 8 val and 8 test images at 160x160
            and 32 unlabeled, 2 pretrain epochs of 3 CP2 steps at full width
            (batch 32), then the CP2-initialised and the scratch finetune
            (batch 16, 1 epoch of 4 steps): the JSON's keys, and each leg's,
            equal those of the JAX gate's ``reports/quality/quality_gate.json``,
            both test Dice finite in [0, 1]; the dense-loss kernels once each
            way per pretrain step and never in the finetunes (the gate's
            ``card/`` record); a second gate call in the pattern of the rows
            that share one pretrain (``--pretrain_epochs 1 --seed 1
            --pretrain_seed 0 --reuse_pretrain --scratch_from`` the first
            JSON): no pretrain leg, the first's checkpoint, its scratch leg
            imported and equal to the first's, the keys of
            ``reports/quality/quality_gate_u1600_r1.0_s0.json``, no launch
            in its finetune; and ``test_loop.multi_device_test``
            in a world of one (NCCL) on the CP2 finetune's best checkpoint
            over the 8 test images (one of them a flip-view pair, one cut to
            128x160) equal to ``dataset_test``.
22. corpus  the quality gate's v1 pool-400 corpus (seed 0, 160x160, 400
            train, 60 val, 80 test images and their masks) generated here by
            ``cp2_tpu_torch/tools/synthetic_corpus.py`` under
            ``work_dirs/chip_smoke_corpus/`` (deleted after) and held to the
            digests committed from the JAX tool's corpus
            (``reports/quality_torch/corpus_v1_s0_160.json``): the number of
            files whose decoded pixels differ, whose bytes differ, and the
            largest pixel difference over the files kept whole beside the
            digests; any missing file or pixel difference fails.  And the
            rounding of a bias in bfloat16 on the card: the finetune's
            ``conv_seg`` (512 → 2 channels, batch 16, 22x22) through
            ``models/layers.py::conv2d`` (the bias added after the rounded
            convolution, as flax adds it) must equal cuDNN's
            ``F.conv2d`` with the bias bit for bit; a linear layer's fused
            bias (cuBLASLt) is counted beside it.

23. split  the tap split of ``models/layers.py::conv2d`` against cuDNN's
            dilated convolution in bfloat16 at the cells' shapes, the way
            phase 22 checks rounding: (64, 2048, 14, 14) and (16, 2048, 22,
            22) -> 512 at d = 12 and 18 (where ``tap_split_engages``),
            forward, input gradient and weight gradient; each within 5 % of
            the largest magnitude of cuDNN's (``tests/test_torch_model.py``'s
            bfloat16 tolerance) and no farther from the float32 result on
            the same bfloat16 operands than ``tests/test_torch_tap_split.py``
            lets the CPU's split lie from its plain convolution (2, 2.5 for
            the input gradient, 2 times cuDNN's distance, normwise); the
            share of elements that differ from cuDNN's; a second fwd+bwd run
            under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync,
            so the split can be captured in a CUDA graph); and the time of
            both ways.

``python3 chip_smoke.py --preflight`` runs phases 1-4 alone, as the
experiment drivers' ``preflight`` does; it exits non-zero on any failure.
``python3 chip_smoke.py --tap-split`` runs phase 1's device check and
phase 23 alone.

Phases 16 and 17 run the CLI with PyTorch's default backends (cuDNN
convolutions in TF32, matrix products in float32), as a user runs it.

``python3 chip_smoke.py --compare <dir>`` times phase 5's step, phases
16-17's runs and ``cp2_tpu_torch.bench``'s device-only rate (without its
end-to-end phases; ``null`` for a tree that has no such module) of the
package in ``<dir>`` (another commit, unpacked) and of this one in turns
(parent, change, change, parent), each in a process of its own, and
writes ``chiprun_out/compare.json``.

The last lines are one JSON object on the kernels (with their launches on
every path), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import shlex
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
# (32, 784) and (32, 49) are CP2's in-step shapes on UNET_TRUNCATED and
# UNET_ENCODER_ONLY at 224²; the last three are the experiment drivers' (phase
# 19): batch 64 and 256 at 224², and lemon.sh's UNET_ENCODER_ONLY at 512²
SHAPES = [(32, 196, 128), (8, 1024, 128), (2, 4096, 128), (1, 100, 8), (1, 640, 16),
          (2, 196, 64), (2, 196, 256), (32, 784, 128), (32, 49, 128),
          (64, 196, 128), (256, 196, 128), (32, 256, 128)]
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


def check_graph_replay(dl, q, k, a, b):
    """A forward captured in a CUDA graph on one stream, replayed on a
    second stream while eager forwards run on the first: each replay and
    each eager forward gives the serial loss, bit for bit, and the serial
    loss is the plain version's to the float32 tolerance.  The captured
    forward has a counter of its own, zeroed inside the graph."""
    ops = dl.prepare_operands(q, k, a, b, torch.float32)
    first, second = torch.cuda.Stream(), torch.cuda.Stream()
    first.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(first):
        dl.fwd_kernel(*ops, 0.2)  # warm-up, eager
    torch.cuda.current_stream().wait_stream(first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=first):
        captured, _ = dl.fwd_kernel(*ops, 0.2)
    want, _ = dl.fwd_kernel(*ops, 0.2)
    ref = dl.dense_pair_loss_reference(q, k, a, b, 0.2)
    for s in (first, second):
        s.wait_stream(torch.cuda.current_stream())
    replays, eager = [], []
    for _ in range(16):
        with torch.cuda.stream(second):
            graph.replay()
            replays.append(captured.clone())
        with torch.cuda.stream(first):
            eager.append(dl.fwd_kernel(*ops, 0.2)[0])
    torch.cuda.synchronize()
    rel = abs(want.item() - ref.item()) / abs(ref.item())
    return (all(torch.equal(x, want) for x in replays + eager)
            and rel <= F32_TOL["loss_rtol"]), rel


def check_kernels(dl):
    """Every shape, temperature and operand type, then the times at each
    shape; returns the step shape's float32 numbers for the JSON line, and
    every shape's times and bounds under ``by_shape``."""
    flagship = {"by_shape": {}}
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
            ok, rel = check_graph_replay(dl, q, k, a, b)
            if not ok:
                raise SystemExit("a forward replayed from a CUDA graph on a second stream, "
                                 "beside eager forwards, disagrees")
            log(f"  a captured forward replayed on a second stream beside eager forwards: "
                f"bit-equal to the serial one, which is {rel:.2e} from the plain version")
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
        flagship["by_shape"][f"{n}x{s2}x{c}"] = t
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
    channels_last = channels_last_step_ms(state, step, batch)
    log(f"  the same step with the network fed a channels-last copy of its input instead "
        f"of the encoder's explicit NCHW one: {channels_last:.2f} ms (median of 3 after 2)")

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
                          losses=losses, step_ms=times, channels_last_step_ms=channels_last)


def channels_last_step_ms(state, step, batch):
    """The step with ``SSLEncoder``'s explicit NCHW replaced by a
    channels-last copy (what a contiguous NHWC batch becomes when only
    permuted): median of 3 steps after 2."""
    from cp2_tpu_torch.ssl import model as ssl_model

    explicit = ssl_model._nchw
    ssl_model._nchw = lambda img: img.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    times = []
    try:
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            metrics["loss"].item()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        ssl_model._nchw = explicit
    return statistics.median(times[2:])


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


PRETRAIN_FIGURES = ("iou_histogram.png", "masked_iou_histogram.png",
                    "similarity_heatmaps.png", "train_examples.png")


def decoded_png(path):
    """(height, width) of a PNG that PIL decodes; exits if it does not."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            im.load()
            if im.format != "PNG":
                raise OSError(f"format {im.format}")
            return im.size[1], im.size[0]
    except OSError as e:
        raise SystemExit(f"{path}: not a PNG that PIL decodes ({e})") from e


def pretrain_figures(run_dir, epoch):
    """The pretrain CLI's figures of one visual epoch, each decoded; their
    (height, width) by name."""
    out_dir = os.path.join(run_dir, "visuals", f"epoch_{epoch:04d}")
    found = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if found != sorted(PRETRAIN_FIGURES):
        raise SystemExit(f"{out_dir}: figures {found}, want {sorted(PRETRAIN_FIGURES)}")
    return {name: decoded_png(os.path.join(out_dir, name)) for name in found}


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
              "--metrics_level", "1", "--scalar-freq", "3", "--print-freq", "2"]
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
    figures = {epoch: pretrain_figures(run_dir, epoch) for epoch in range(CLI_EPOCHS + 1)}
    log(f"  --visual-freq 1 (the default): each epoch's figures written and decoded by PIL: "
        f"{figures}")

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
        resume_launches=resume_launches, figures=figures)


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


def check_unet_kernel_on_step_features(dl, state, name="UNET_TRUNCATED", hw=224, stride=8):
    """Phase 5's check on a U-Net state's own dense features at batch 32:
    the kernel against the plain version (UNET_TRUNCATED at 224², S² =
    784, in phase 9; UNET_ENCODER_ONLY at 512², S² = 256, for lemon.sh in
    phase 19)."""
    batch = pre_augmented_batch(32, hw, 0, "cuda")
    q, k, a, b = dense_features(state, batch, stride)
    want = (32, (hw // stride) ** 2, 128)
    if tuple(q.shape) != want:
        raise SystemExit(f"{name} dense features {tuple(q.shape)}, want {want}")
    qg = q.detach().clone().requires_grad_()
    loss = dl.dense_pair_loss(qg, k, a, b, 1.0)
    loss.backward()
    qr = q.detach().clone().requires_grad_()
    ref = dl.dense_pair_loss_reference(qr, k, a, b, 1.0)
    ref.backward()
    err_loss = abs(loss.item() - ref.item()) / abs(ref.item())
    err_dq = max_rel(qg.grad, qr.grad)
    log(f"    {name} features {want}: kernel loss {loss.item():.6f} plain "
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
    """Wraps a step factory (``make_seg_steps``, ``make_mirror_steps``) so
    that every train and eval step ends in ``torch.cuda.synchronize()``;
    records (kind, call s, since the previous train step's end s, loss) per
    call, the losses read under ``train_key`` and ``eval_key``."""

    def __init__(self, make, train_key="loss", eval_key="loss"):
        self.make = make
        self.train_key, self.eval_key = train_key, eval_key
        self.rows = []
        self.last = None

    def __call__(self, *a, **kw):
        train_step, eval_step, *rest = self.make(*a, **kw)

        def timed_train(state, batch, generator, confusion):
            start = time.perf_counter()
            state, confusion, m = train_step(state, batch, generator, confusion)
            loss = m[self.train_key].item()
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.rows.append(("train", now - start, now - self.last, loss))
            self.last = now
            return state, confusion, m

        def timed_eval(state, batch, confusion):
            start = time.perf_counter()
            confusion, m = eval_step(state, batch, confusion)
            loss = m[self.eval_key].item()
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.rows.append(("eval", now - start, now - self.last, loss))
            return confusion, m

        return (timed_train, timed_eval, *rest)


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


def finetune_checks(args, test_metrics, rows, reports, launches, want_loaded=None):
    """What every finetune run of phases 11 and 19 must show: the graft
    loaded tensors (``want_loaded`` of them, where given), finite losses,
    the monitored key in each epoch's row of ``metrics.jsonl``, one best
    checkpoint left, the test keys, no dense-loss launch, and epoch 0's
    overlay grid decoded where ``--visualize_freq`` asks for it.  Returns
    (problems, monitor key, epoch rows, best checkpoints, overlay's
    (height, width) or None)."""
    from cp2_tpu_torch.ops import metrics

    run_dir = os.path.join(args.log_dir, args.run_id)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metric_rows = [json.loads(line) for line in f]
    binary = args.num_classes == 2
    monitor = "val_BinaryJaccardIndex" if binary else "val_MulticlassJaccardIndex"
    want_test = {f"test_{k}" for k in metrics.compute_metrics(
        metrics.ConfusionState.create(args.num_classes), binary=binary,
        ignore_index=None if binary else 0)} | {"test_loss"}
    epoch_rows = [r for r in metric_rows if "epoch" in r]
    best = [d for d in os.listdir(run_dir) if d.isdigit()]
    loaded = len(reports[0]["loaded"]) if reports else 0
    problems = []
    if not loaded or (want_loaded is not None and loaded != want_loaded):
        problems.append(f"the graft loaded {loaded} tensors"
                        + (f", want {want_loaded}" if want_loaded is not None else ""))
    if not rows or not all(math.isfinite(r[-1]) for r in rows):
        problems.append(f"losses {[r[-1] for r in rows]}")
    if not epoch_rows or any(not math.isfinite(r.get(monitor, math.nan)) for r in epoch_rows):
        problems.append(f"{monitor} missing from metrics.jsonl")
    if len(best) != 1:
        problems.append(f"{len(best)} checkpoints left: {best}")
    if set(test_metrics) != want_test or not all(math.isfinite(v) for v in test_metrics.values()):
        problems.append(f"test keys {sorted(test_metrics)}")
    if any(v != 0 for v in launches.values()):
        problems.append(f"dense-loss launches {launches}")
    overlay = None
    if args.visualize_freq > 0:
        path = os.path.join(run_dir, "visuals", "segmentations_epoch_0000.png")
        if os.path.exists(path):
            overlay = decoded_png(path)
        else:
            problems.append(f"no overlay at {path}")
    return problems, monitor, epoch_rows, best, overlay


def run_finetune(finetune, argv, clock, reports):
    args = finetune.get_args(argv)
    clock.rows = []
    reports.clear()
    clock.last = time.perf_counter()
    return finetune.main(args), args


def check_finetune_cli(dl):
    """Phase 11; returns the launches by run and the runs' numbers."""
    from cp2_tpu_torch.checkpoint import convert
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
    common = ["--config", config, "--batch_size", str(FT_BATCH), "--prefetch_depth", "2",
              "--pretrain_type", "CP2", "--pretrain_path", pretrain_run, "--log_dir", logs]
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
            classes = args.num_classes
            train_rows = [r for r in rows if r[0] == "train"]
            problems, monitor, epoch_rows, best, overlay = finetune_checks(
                args, test_metrics, rows, reports, launches[run])
            numbers[run] = dict(
                overlay_hw=overlay, flags=flags, img_hw=[args.img_height, args.img_width],
                classes=classes,
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
                f"best checkpoint {best}; overlay (epoch 0, --visualize_freq "
                f"{args.visualize_freq}) {overlay}; peak {peak / 2**30:.2f} GiB; dense-loss "
                f"launches {launches[run]}; run {wall:.1f} s "
                f"{'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
            if problems:
                raise SystemExit(f"phase 11: {run}: {'; '.join(problems)}")
            torch.cuda.empty_cache()
    finally:
        segmentation_task.make_seg_steps = clock.make
        convert.load_pretrained_into_segmentor = real_load
    # phase 7's checkpoints have served; the polyp pairs and best checkpoint
    # stay until phases 13 and 14 have used them
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 12: the mirror (CutPaste) path, card against CPU
# ---------------------------------------------------------------------------

MIRROR_HW = (512, 512)
MIRROR_BATCH = 10
CUTPASTE_CASES = {  # (config, mirrors): REGULAR, and SCAR rotated by up to 45 degrees
    "regular": dict(num_classes=2, max_num_patches=3),
    "scar": dict(num_classes=3, max_num_patches=3, min_rotation=0, max_rotation=45),
}
SMALL_MIRROR_MODEL = dict(SMALL_SEG_MODEL, auxiliary_head=None)


def cutpaste_law(p, hw, cfg):
    """Problems of CutPaste draws against their law: class and patch-count
    frequencies within 4 standard errors, every area, aspect and rotation
    in its range, every rotated paste box and source patch in the frame."""
    from cp2_tpu_torch.augment.cutpaste import class_probabilities

    p = type(p)(*(v.cpu() for v in p))
    n, slots = p.active.shape
    problems = []

    def within(mean, want, sd, m, what):
        if abs(mean - want) > 4 * sd / math.sqrt(m):
            problems.append(f"{what} {mean:.4f}, want {want:.4f}")

    for k, pk in enumerate(class_probabilities(cfg.num_classes)):
        within(float((p.target == k).float().mean()), pk, math.sqrt(pk * (1 - pk)), n,
               f"class {k} frequency")
    counts = p.active.sum(dim=1)
    for k in range(1, slots + 1):
        within(float((counts == k).float().mean()), 1 / slots,
               math.sqrt((1 / slots) * (1 - 1 / slots)), n, f"{k}-patch frequency")
    h, w = hw
    area = (4 * p.half_h * p.half_w / (h * w)).double()
    aspect = (p.half_w / p.half_h).double()
    degrees = torch.rad2deg(torch.atan2(p.sin, p.cos)).double()
    eps = 1e-4
    laws = {1: ((cfg.min_area_scale, cfg.max_area_scale),
                (cfg.min_aspect_ratio, cfg.max_aspect_ratio), (0.0, 0.0)),
            2: ((cfg.min_area_scale, cfg.max_area_scale / 2), (3.0, 6.0),
                (cfg.min_rotation, cfg.max_rotation))}
    for cls, ranges in laws.items():
        sel = (p.target == cls)[:, None].expand_as(p.active)
        if not sel.any():
            continue
        for name, v, (lo, hi) in zip(("area", "aspect", "rotation"), (area, aspect, degrees),
                                     ranges):
            x = v[sel]
            if float(x.min()) < lo - eps * max(1, abs(lo)) or float(x.max()) > hi + eps * max(1, abs(hi)):
                problems.append(f"class {cls} {name} in [{float(x.min()):.4f}, "
                                f"{float(x.max()):.4f}], want [{lo}, {hi}]")
            if hi > lo:
                within(float(x.mean()), (lo + hi) / 2, (hi - lo) / math.sqrt(12), int(sel.sum()),
                       f"class {cls} mean {name}")
    bh = p.half_h * p.cos.abs() + p.half_w * p.sin.abs()
    bw = p.half_w * p.cos.abs() + p.half_h * p.sin.abs()
    for lo, hi, size, what in ((p.dst_cy - bh, p.dst_cy + bh, h, "paste rows"),
                               (p.dst_cx - bw, p.dst_cx + bw, w, "paste columns"),
                               (p.src_cy - p.half_h, p.src_cy + p.half_h, h, "source rows"),
                               (p.src_cx - p.half_w, p.src_cx + p.half_w, w, "source columns")):
        if float(lo.min()) < -eps or float(hi.max()) > size + eps:
            problems.append(f"{what} in [{float(lo.min()):.3f}, {float(hi.max()):.3f}]")
    return problems


def check_cutpaste():
    """CutPaste and the CLI's whole ``prepare`` at the CLI's shape, drawn on
    the CPU and applied on the card and the CPU; the samplers on the card's
    generator against their laws."""
    from cp2_tpu_torch.augment import cutpaste as C
    from cp2_tpu_torch.train import mirror_pretrain as MP
    from cp2_tpu_torch.types import MirrorVariant

    out = {}
    r = np.random.RandomState(12)
    images = torch.from_numpy(r.rand(MIRROR_BATCH, *MIRROR_HW, 3).astype(np.float32))
    mirrors = torch.from_numpy(r.rand(MIRROR_BATCH, *MIRROR_HW, 3).astype(np.float32))
    for name, fields in CUTPASTE_CASES.items():
        cfg = C.CutPasteConfig(**fields)
        params = C.sample_cutpaste(torch.Generator().manual_seed(3), MIRROR_BATCH, MIRROR_HW, cfg)
        ref = C.apply_cutpaste(images, mirrors, params)
        got = C.apply_cutpaste(images.cuda(), mirrors.cuda(), to_device(params, "cuda"))
        err = max(float((g.cpu() - c).abs().max()) for g, c in zip(got[:2], ref[:2]))
        equal = torch.equal(got[2].cpu(), ref[2]) and torch.equal(got[3].cpu(), ref[3])
        pasted = int((ref[2] > 0).sum())
        if name == "scar" and not bool((params.target == 2).any()):
            raise SystemExit("phase 12: the SCAR case drew no SCAR image")
        law = cutpaste_law(C.sample_cutpaste(torch.Generator(device="cuda").manual_seed(4),
                                             N_DRAWS, MIRROR_HW, cfg), MIRROR_HW, cfg)
        ok = err <= FT_AUG_ATOL and equal and pasted > 0 and not law
        log(f"  cutpaste {name} ({MIRROR_BATCH}, {MIRROR_HW[0]}, {MIRROR_HW[1]}) with mirrors, "
            f"{cfg.max_num_patches} patches max: images and mirrors max abs diff {err:.2e}, masks "
            f"and targets {'equal' if equal else 'DIFFER'} ({pasted} pixels pasted); samplers on "
            f"the card's generator, {N_DRAWS} draws: {'by their law' if not law else law} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 12: CutPaste {name} on the card disagrees")
        out[name] = dict(max_abs_err=err, pixels_pasted=pasted)
    # the CLI's prepare: resized crops of (hw + 32)² frames, jitter, CutPaste
    src_hw = (MIRROR_HW[0] + 32, MIRROR_HW[1] + 32)
    frames = torch.from_numpy(r.randint(0, 256, (MIRROR_BATCH, *src_hw, 3), dtype=np.uint8))
    mirror_frames = torch.from_numpy(r.randint(0, 256, (MIRROR_BATCH, *src_hw, 3),
                                               dtype=np.uint8))
    cfg = C.CutPasteConfig(num_classes=2)
    params = MP.sample_prepare_params(torch.Generator().manual_seed(5), MIRROR_BATCH, src_hw,
                                      MIRROR_HW, cfg, True)
    ref = MP.apply_prepare(frames, mirror_frames, params, MIRROR_HW)
    got = MP.apply_prepare(frames.cuda(), mirror_frames.cuda(), to_device(params, "cuda"),
                           MIRROR_HW)
    err = max(float((got[k].cpu() - ref[k]).abs().max()) for k in ("image", "mirror"))
    equal = all(torch.equal(got[k].cpu(), ref[k]) for k in ("mask", "target"))
    ok = err <= AUG_ATOL and equal
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(6)
    frames_c, mirrors_c = frames.cuda(), mirror_frames.cuda()
    prep_ms = cuda_ms(lambda: MP.prepare(gen, frames_c, mirrors_c, MIRROR_HW, cfg,
                                         MirrorVariant.OUTPUT), iters=10)
    log(f"  the CLI's prepare ({MIRROR_BATCH} frames of {src_hw[0]}x{src_hw[1]} to "
        f"{MIRROR_HW[0]}x{MIRROR_HW[1]}, OUTPUT): images {err:.2e} (1e-5, as phase 6), masks "
        f"and targets {'equal' if equal else 'DIFFER'}; {prep_ms:.2f} ms a batch by CUDA events "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 12: the mirror CLI's prepare on the card disagrees")
    out["prepare"] = dict(max_abs_err=err, ms=prep_ms)
    return out


def check_mirror_steps(dl):
    """One float32 train step of each variant and a padded eval step of the
    narrow segmentor (dropout 0) from one seed on both devices."""
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.train import mirror_task
    from cp2_tpu_torch.train import segmentation_task as task
    from cp2_tpu_torch.types import MirrorVariant

    img, mask = seg_batch(8, 64, 0)
    mirror, _ = seg_batch(8, 64, 2)
    ev_img, ev_mask = seg_batch(4, 64, 1)
    ev_mirror, _ = seg_batch(4, 64, 3)
    valid = np.array([True, True, True, False])
    launches, numbers = {}, {}
    for variant in ("OUTPUT", "NONE"):
        train_step, eval_step = mirror_task.make_mirror_steps(
            2, (64, 64), mirror_variant=MirrorVariant[variant], lmbd_compare_loss=1.0)
        out = {}
        for device in ("cpu", "cuda"):
            model = init_flax_like_(build_segmentor(SMALL_MIRROR_MODEL),
                                    torch.Generator().manual_seed(0))
            state = task.create_seg_state(model, task.make_adam(1e-3, 1e-4), device)

            def put(x):
                return torch.from_numpy(x).to(device)

            if device == "cuda":
                torch.cuda.synchronize()
                dl.reset_launch_counts()  # this path's run starts here
            state, conf, m = train_step(
                state, {"image": put(img), "mirror": put(mirror), "mask": put(mask)},
                torch.Generator(device=device).manual_seed(0), ConfusionState.create(2, device))
            ev_conf, ev_m = eval_step(state, {"image": put(ev_img), "mirror": put(ev_mirror),
                                              "mask": put(ev_mask), "valid": put(valid)},
                                      ConfusionState.create(2, device))
            if device == "cuda":
                torch.cuda.synchronize()
                launches[variant] = dict(dl.LAUNCHES)  # read just after the run
            out[device] = dict(
                metrics={k: v.item() for k, v in m.items()},
                grads={k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
                buffers={k: b.detach().cpu() for k, b in state.model.named_buffers()},
                conf=conf.matrix.cpu(), ev_conf=ev_conf.matrix.cpu(),
                ev_loss=ev_m["val_loss"].item(), ev_weight=ev_m["weight"].item())
            del state, model
        cpu, gpu = out["cpu"], out["cuda"]
        err_loss = max(abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
                       for k, v in cpu["metrics"].items() if v != 0)
        err_grad = max(max_rel(gpu["grads"][k], v) for k, v in cpu["grads"].items()
                       if v.abs().max() > 0)
        err_stats = max(max_rel(gpu["buffers"][k], v) for k, v in cpu["buffers"].items())
        err_ev = abs(gpu["ev_loss"] - cpu["ev_loss"]) / abs(cpu["ev_loss"])
        counts_equal = (torch.equal(gpu["conf"], cpu["conf"])
                        and torch.equal(gpu["ev_conf"], cpu["ev_conf"]))
        views = 2 if variant == "OUTPUT" else 1
        padded_out = (int(cpu["ev_conf"].sum()) == views * 3 * 64 * 64
                      and cpu["ev_weight"] == gpu["ev_weight"] == 3.0)
        compare_live = (cpu["metrics"]["train_compare_loss"] > 0) == (variant == "OUTPUT")
        ok = (err_loss <= 1e-4 and err_grad <= 1e-4 and err_stats <= 1e-4 and err_ev <= 1e-4
              and counts_equal and padded_out and compare_live
              and all(v == 0 for v in launches[variant].values()))
        log(f"  mirror step {variant}, card vs CPU (float32, batch 8, 64x64): losses rel "
            f"{err_loss:.2e}, gradients {err_grad:.2e}, BatchNorm stats {err_stats:.2e} (each "
            f"normwise, 1e-4); eval with a padded row: loss rel {err_ev:.2e}, confusion counts "
            f"{'equal' if counts_equal else 'DIFFER'} ({int(cpu['ev_conf'].sum())} pixels "
            f"counted); dense-loss launches {launches[variant]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 12: the mirror step {variant} on the card disagrees")
        numbers[variant] = dict(loss_rel=err_loss, grad_rel=err_grad, stats_rel=err_stats,
                                eval_loss_rel=err_ev, metrics=cpu["metrics"])
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 13: the mirror CLI at full width
# ---------------------------------------------------------------------------

MIRROR_WORK = os.path.join("work_dirs", "chip_smoke_mirror")
MIRROR_SPLITS = {"train": 8 * MIRROR_BATCH, "val": 2 * MIRROR_BATCH + 4}  # 8 steps an epoch
MIRROR_EPOCHS = 2
LEMON_MIRROR_BATCH = 16
MIRROR_TRAIN_KEYS = {"train_loss", "train_class_loss", "train_compare_loss"}


def csv_listed_frames(directory, splits, hw, seed):
    """Smooth random RGB frames as PNGs, each split listed by its CSV."""
    os.makedirs(directory, exist_ok=True)
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    for split, count in splits.items():
        names = []
        for i in range(count):
            f = r.uniform(1, 8, (3, 2))
            ph = r.uniform(0, 2 * np.pi, (3,))
            img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx) + ph[c])
                            for c in range(3)], axis=-1)
            names.append(f"{split}_{i:04d}.png")
            write_png(os.path.join(directory, names[-1]), (img * 255).astype(np.uint8))
        with open(os.path.join(directory, f"{split}.csv"), "w") as f:
            f.write("\n".join(names) + "\n")
    return sum(splits.values())


def check_mirror_cli(dl, polyp_pairs):
    """Phase 13; returns the launches by run and the runs' numbers."""
    from cp2_tpu_torch.checkpoint import convert
    from cp2_tpu_torch.train import finetune, mirror_pretrain, mirror_task

    shutil.rmtree(MIRROR_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    frames = os.path.join(MIRROR_WORK, "frames")
    lemon = os.path.join(MIRROR_WORK, "lemon")
    n_frames = csv_listed_frames(frames, MIRROR_SPLITS, (544, 544), seed=13)
    n_lemon = csv_listed_frames(lemon, {"train": LEMON_MIRROR_BATCH, "val": 8}, (576, 1056),
                                seed=14)
    log(f"  wrote {n_frames} frames of 544x544 and {n_lemon} of 576x1056 with train.csv and "
        f"val.csv in {time.perf_counter() - t0:.1f} s")
    logs = os.path.join(MIRROR_WORK, "logs")
    clock = FinetuneClock(mirror_task.make_mirror_steps, train_key="train_loss",
                          eval_key="val_loss")
    mirror_task.make_mirror_steps = clock
    reports = []
    real_load = convert.load_pretrained_into_segmentor

    def recording_load(*a, **kw):
        merged, report = real_load(*a, **kw)
        reports.append(report)
        return merged, report

    convert.load_pretrained_into_segmentor = recording_load
    runs = {
        "OUTPUT": ["--run_id", "output", "--data_dirs", frames, "--epochs", str(MIRROR_EPOCHS),
                   "--variant", "OUTPUT"],
        "lemon_NONE": ["--run_id", "lemon", "--data_dirs", lemon, "--lemon_data", "--variant",
                       "NONE", "--batch-size", str(LEMON_MIRROR_BATCH), "--fast_dev_run"],
    }
    launches, numbers = {}, {}
    try:
        for run, flags in runs.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            args = mirror_pretrain.get_args(["--log_dir", logs, "--prefetch_depth", "2"] + flags)
            clock.rows = []
            dl.reset_launch_counts()  # this path's run starts here
            t = time.perf_counter()
            clock.last = t
            mirror_pretrain.main(args)
            wall = time.perf_counter() - t
            launches[f"mirror_cli_{run}"] = dict(dl.LAUNCHES)  # read just after the run
            peak = torch.cuda.max_memory_allocated()
            rows = list(clock.rows)
            train_rows = [r for r in rows if r[0] == "train"]
            run_dir = os.path.join(logs, args.run_id)
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                epoch_rows = [json.loads(line) for line in f]
            epoch_rows = [r for r in epoch_rows if "epoch" in r]
            best = sorted((d for d in os.listdir(run_dir) if d.isdigit()), key=int)
            metas = []
            for d in best:
                with open(os.path.join(run_dir, d, "meta.json")) as f:
                    metas.append(json.load(f))
            problems = []
            if not train_rows or not all(math.isfinite(r[-1]) for r in rows):
                problems.append(f"losses {[r[-1] for r in rows]}")
            for r in epoch_rows:
                if not (MIRROR_TRAIN_KEYS | {"val_loss_epoch"}) <= set(r) or not all(
                        math.isfinite(r[k]) for k in MIRROR_TRAIN_KEYS | {"val_loss_epoch"}):
                    problems.append(f"metrics.jsonl row {r}")
            if len(epoch_rows) != args.epochs:
                problems.append(f"{len(epoch_rows)} epoch rows for {args.epochs} epochs")
            if not metas or any(m.get("pretrain_type") != "MIRROR" for m in metas):
                problems.append(f"checkpoint metas {metas}")
            if any(v != 0 for v in launches[f"mirror_cli_{run}"].values()):
                problems.append(f"dense-loss launches {launches[f'mirror_cli_{run}']}")
            numbers[run] = dict(
                flags=flags, img_hw=[args.img_x_size, args.img_y_size], batch=args.batch_size,
                train_step_ms=[r[1] * 1e3 for r in train_rows],
                train_gap_ms=[r[2] * 1e3 for r in train_rows], losses=[r[-1] for r in train_rows],
                val_losses=[r.get("val_loss_epoch") for r in epoch_rows], peak_bytes=peak,
                run_wall_s=wall, checkpoints=best, launches=launches[f"mirror_cli_{run}"])
            if run == "OUTPUT" and not problems:
                steps_per_epoch = MIRROR_SPLITS["train"] // args.batch_size
                epoch1 = train_rows[steps_per_epoch:]
                quiet = statistics.median(r[1] * 1e3 for r in epoch1[1:])
                ips = args.batch_size * (len(epoch1) - 1) / sum(r[2] for r in epoch1[1:])
                evals = eval_seconds(rows, math.ceil(MIRROR_SPLITS["val"] / args.batch_size))
                numbers[run].update(quiet_step_ms_median=quiet, images_per_s_epoch1=ips,
                                    val_s_per_epoch=evals)
                log(f"  mirror OUTPUT: {len(train_rows)} steps over {args.epochs} epochs; epoch 1 "
                    f"step call median {quiet:.1f} ms (steps 1-{len(epoch1) - 1}), {ips:.1f} "
                    f"images/s end to end after step 0 (each with its mirror; loader, copy and "
                    f"prepare included); val {['%.2f' % e for e in evals]} s per epoch")
            log(f"  mirror {run:10s} {args.img_x_size}x{args.img_y_size}, batch {args.batch_size}: "
                f"step calls {['%.1f' % (r[1] * 1e3) for r in train_rows]} ms; "
                f"losses {['%.4f' % r[-1] for r in train_rows]}; val_loss_epoch "
                f"{[round(r.get('val_loss_epoch', math.nan), 4) for r in epoch_rows]}; checkpoints "
                f"{best} (meta pretrain_type {[m.get('pretrain_type') for m in metas]}); peak "
                f"{peak / 2**30:.2f} GiB; dense-loss launches {launches[f'mirror_cli_{run}']}; "
                f"run {wall:.1f} s {'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
            if problems:
                raise SystemExit(f"phase 13: {run}: {'; '.join(problems)}")
            torch.cuda.empty_cache()

        # a MIRROR finetune from the OUTPUT run's best checkpoint on phase 11's pairs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reports.clear()
        args = finetune.get_args([
            "--run_id", "from_mirror", "--log_dir", logs,
            "--img_dirs", os.path.join(polyp_pairs, "images"),
            "--mask_dirs", os.path.join(polyp_pairs, "masks"), "--batch_size", str(FT_BATCH),
            "--visualize_freq", "0", "--pretrain_type", "MIRROR",
            "--pretrain_path", os.path.join(logs, "output"), "--fast_dev_run"])
        dl.reset_launch_counts()  # this path's run starts here
        t = time.perf_counter()
        test_metrics = finetune.main(args)
        wall = time.perf_counter() - t
        launches["finetune_MIRROR"] = dict(dl.LAUNCHES)  # read just after the run
        loaded = len(reports[0]["loaded"]) if reports else 0
        ok = (loaded > 0 and all(math.isfinite(v) for v in test_metrics.values())
              and all(v == 0 for v in launches["finetune_MIRROR"].values()))
        numbers["finetune_MIRROR"] = dict(loaded_tensors=loaded, test_metrics=test_metrics,
                                          run_wall_s=wall, launches=launches["finetune_MIRROR"],
                                          peak_bytes=torch.cuda.max_memory_allocated())
        log(f"  finetune --pretrain_type MIRROR from the OUTPUT run's best checkpoint: loaded "
            f"{loaded} tensors (dropped {reports[0].get('dropped') if reports else None}); test "
            f"{test_metrics.get('test_BinaryJaccardIndex', math.nan):.4f}; dense-loss launches "
            f"{launches['finetune_MIRROR']}; run {wall:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase 13: the MIRROR finetune did not load the mirror checkpoint")
    finally:
        mirror_task.make_mirror_steps = clock.make
        convert.load_pretrained_into_segmentor = real_load
    shutil.rmtree(MIRROR_WORK, ignore_errors=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 14: inference and serving at full width
# ---------------------------------------------------------------------------

INFER_BATCH = 8
SLIDE_CROP, SLIDE_STRIDE = (256, 256), (170, 170)


def hand_counts(hw, crop, stride):
    """Window visits per pixel, by stepping the grid as mmseg does."""
    counts = np.zeros(hw, np.int64)
    y = 0
    while True:
        x = 0
        while True:
            y0, x0 = min(y, hw[0] - crop[0]), min(x, hw[1] - crop[1])
            counts[y0:y0 + crop[0], x0:x0 + crop[1]] += 1
            if x + crop[1] >= hw[1]:
                break
            x += stride[1]
        if y + crop[0] >= hw[0]:
            break
        y += stride[0]
    return counts


def median_ms(fn, iters=10, warmup=3):
    """Median host-clock time of ``fn()`` ending in a synchronise."""
    times = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def check_inference_serving(dl, checkpoint):
    """Phase 14 from phase 11's polyp best checkpoint; returns the launches
    by path and the numbers."""
    from cp2_tpu_torch import serving
    from cp2_tpu_torch.train import inference, test_loop
    import cp2_tpu_torch

    config = os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs",
                          "config_finetune.py")
    hw = (352, 352)
    r = np.random.RandomState(14)
    raw = torch.from_numpy(r.randint(0, 256, (INFER_BATCH, *hw, 3), dtype=np.uint8)).cuda()
    x = raw.float() / 255.0
    launches, out = {}, {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()  # the inference path's run starts here
    model = inference.init_segmentor(config, checkpoint, num_classes=2, dtype=torch.bfloat16)
    with torch.no_grad():
        whole = inference.whole_inference(model, x)
        classes = inference.inference_segmentor(model, x)
        slide = inference.slide_inference(model, x, SLIDE_CROP, SLIDE_STRIDE, 2)
    counts = inference.slide_counts(hw, SLIDE_CROP, SLIDE_STRIDE, "cuda")
    windows = inference.slide_windows(hw, SLIDE_CROP, SLIDE_STRIDE)
    views = [[{"img": img, "img_metas": {"flip": False}},
              {"img": img[:, ::-1].copy(), "img_metas": {"flip": True}}]
             for img in x[:4].cpu().numpy()]
    preds = test_loop.dataset_test(model, views)
    with torch.no_grad():  # the same average computed here, view by view
        want = []
        for img in x[:4]:
            p = torch.softmax(inference.whole_inference(model, img[None]), -1)
            p = p + torch.softmax(inference.whole_inference(model, img.flip(1)[None]), -1).flip(2)
            want.append(torch.argmax(p, -1)[0].cpu().numpy())
    torch.cuda.synchronize()
    launches["inference"] = dict(dl.LAUNCHES)  # read just after the run
    problems = []
    if tuple(whole.shape) != (INFER_BATCH, *hw, 2) or not torch.isfinite(whole).all():
        problems.append(f"whole logits {tuple(whole.shape)}")
    if not torch.equal(classes, whole.argmax(-1)):
        problems.append("inference_segmentor's class map is not the logits' argmax")
    if len(windows) != 4 or not np.array_equal(counts[0, ..., 0].cpu().numpy(),
                                               hand_counts(hw, SLIDE_CROP, SLIDE_STRIDE)):
        problems.append(f"slide windows {windows} or counts differ from a count by hand")
    if tuple(slide.shape) != tuple(whole.shape) or not torch.isfinite(slide).all():
        problems.append(f"slide logits {tuple(slide.shape)}")
    if len(preds) != 4 or any(p.shape != hw or p.dtype != np.int64 for p in preds) or not all(
            np.array_equal(p, w) for p, w in zip(preds, want)):
        problems.append("dataset_test's flip average differs from the one computed here")
    if any(v != 0 for v in launches["inference"].values()):
        problems.append(f"dense-loss launches {launches['inference']}")
    with torch.no_grad():
        whole_ms = median_ms(lambda: inference.whole_inference(model, x))
        slide_ms = median_ms(lambda: inference.slide_inference(model, x, SLIDE_CROP,
                                                               SLIDE_STRIDE, 2))
    peak = torch.cuda.max_memory_allocated()
    agree = float((slide.argmax(-1) == classes).float().mean())
    log(f"  inference, polyp checkpoint, 352x352, bf16, batch {INFER_BATCH}: whole {whole_ms:.2f} "
        f"ms a batch ({INFER_BATCH / whole_ms * 1e3:.1f} images/s), slide 2x2 windows of 256 "
        f"stride 170 {slide_ms:.2f} ms (counts {sorted(set(counts.flatten().tolist()))} equal a "
        f"count by hand; class maps agree with whole on {100 * agree:.2f} % of pixels); "
        f"dataset_test with a flip view on 4 images; peak {peak / 2**30:.2f} GiB; dense-loss "
        f"launches {launches['inference']} {'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
    if problems:
        raise SystemExit(f"phase 14: inference: {'; '.join(problems)}")
    out["inference"] = dict(whole_ms=whole_ms, slide_ms=slide_ms, peak_bytes=peak,
                            images_per_s=INFER_BATCH / whole_ms * 1e3, slide_whole_agree=agree)
    del model
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()  # the serving path's run starts here
    art_dir = os.path.join(FT_WORK, "serving")
    os.makedirs(art_dir, exist_ok=True)
    numbers = {}
    t = time.perf_counter()
    path = os.path.join(art_dir, "polyp_352_b8.pt2")
    _, meta = serving.export_segmentor(config, checkpoint, path, img_hw=hw,
                                       batch_size=INFER_BATCH, num_classes=2)
    export_s = time.perf_counter() - t
    art = serving.load_exported(path)
    live = serving.make_inference_fn(inference.init_segmentor(config, checkpoint, num_classes=2,
                                                              dtype=torch.bfloat16))
    with torch.no_grad():
        equal = torch.equal(art(raw), live(raw))
        eager_ms = median_ms(lambda: live(raw))
        exported_ms = median_ms(lambda: art(raw))
    numbers["whole_b8"] = dict(bytes=meta["bytes"], export_s=export_s, eager_ms=eager_ms,
                               exported_ms=exported_ms, class_maps_equal=equal,
                               platforms=meta["platforms"])
    t = time.perf_counter()
    sym_path = os.path.join(art_dir, "polyp_352_symbolic.pt2")
    _, sym_meta = serving.export_segmentor(config, checkpoint, sym_path, img_hw=hw,
                                           batch_size=None, num_classes=2)
    sym_s = time.perf_counter() - t
    sym = serving.load_exported(sym_path)
    with torch.no_grad():
        sym_equal = {n: torch.equal(sym(raw[:n]), live(raw[:n])) for n in (1, 3)}
    del live, art, sym
    t = time.perf_counter()
    slide_path = os.path.join(art_dir, "polyp_352_slide_f32.pt2")
    _, slide_meta = serving.export_segmentor(config, checkpoint, slide_path, img_hw=hw,
                                             batch_size=2, mode="slide", num_classes=2,
                                             crop_size=SLIDE_CROP, stride=SLIDE_STRIDE,
                                             bf16=False, return_logits=True)
    slide_s = time.perf_counter() - t
    slide_art = serving.load_exported(slide_path)
    live_slide = serving.make_inference_fn(
        inference.init_segmentor(config, checkpoint, num_classes=2), mode="slide",
        num_classes=2, crop_size=SLIDE_CROP, stride=SLIDE_STRIDE, return_logits=True)
    with torch.no_grad():
        got, want_logits = slide_art(raw[:2]), live_slide(raw[:2])
    slide_err = float((got - want_logits).abs().max())
    slide_ok = bool(torch.allclose(got, want_logits, rtol=1e-5, atol=1e-5))
    torch.cuda.synchronize()
    launches["serving"] = dict(dl.LAUNCHES)  # read just after the run
    peak = torch.cuda.max_memory_allocated()
    ok = (equal and all(sym_equal.values()) and slide_ok and meta["platforms"] == ["cuda"]
          and all(v == 0 for v in launches["serving"].values()))
    numbers["symbolic"] = dict(bytes=sym_meta["bytes"], export_s=sym_s,
                               class_maps_equal={str(k): v for k, v in sym_equal.items()})
    numbers["slide_f32_logits"] = dict(bytes=slide_meta["bytes"], export_s=slide_s,
                                       max_abs_err=slide_err)
    log(f"  serving: whole, batch {INFER_BATCH}, bf16: {meta['bytes'] / 2**20:.1f} MiB artifact "
        f"exported in {export_s:.1f} s; class map {'equal' if equal else 'DIFFERS'} to the live "
        f"module's; {eager_ms:.2f} ms a batch eager, {exported_ms:.2f} ms the loaded program "
        f"({INFER_BATCH / exported_ms * 1e3:.1f} images/s); symbolic batch (exported in "
        f"{sym_s:.1f} s) at 1 and 3: {sym_equal}; slide logits float32 (exported in "
        f"{slide_s:.1f} s) max abs diff {slide_err:.2e} (1e-5); peak {peak / 2**30:.2f} GiB; "
        f"dense-loss launches {launches['serving']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 14: the exported program disagrees with the live module")
    numbers["peak_bytes"] = peak
    out["serving"] = numbers
    return launches, out


# ---------------------------------------------------------------------------
# phase 15: the iteration CLI's path at a narrow width, card against CPU
# ---------------------------------------------------------------------------

# tests/test_iter_train_cli.py's tiny config, dropout off so that both
# devices compute the same function
ITER_TINY_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 2), strides=(1, 2, 2, 1),
                  norm_cfg=dict(type="BN"), contract_dilation=True),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                     dilations=(1, 6), dropout_ratio=0.0, num_classes=2,
                     norm_cfg=dict(type="BN")),
)
NARROW_VIT_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="VisionTransformer", img_size=32, patch_size=8, embed_dims=24,
                  num_layers=3, num_heads=3, out_indices=(2,)),
    decode_head=dict(type="FCNHead", in_channels=24, in_index=0, channels=16,
                     dropout_ratio=0.0, num_classes=2, norm_cfg=dict(type="BN")),
)
NARROW_TOL = 1e-4  # phase 10's, normwise


def iter_sgd_step(model_cfg, device, hw, n=8, seed=0):
    """One step of the iteration CLI's SGD (poly rate at step 0, momentum
    0.9, decay 1e-4) on ``model_cfg`` from one seed; the step's loss,
    gradients, parameters and buffers on the CPU."""
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.train import iter_train
    from cp2_tpu_torch.train import segmentation_task as task

    img, mask = seg_batch(n, hw, seed)
    torch.manual_seed(seed)  # the ViT's position embedding draws at build
    model = init_flax_like_(build_segmentor(model_cfg), torch.Generator().manual_seed(seed))
    state = task.create_seg_state(model, task.make_sgd(0.01, 0.9, 1e-4), device)
    task.set_learning_rate(state.optimizer, iter_train.poly_lr(0.01, 40)(state.step))
    train_step, _, _ = task.make_seg_steps(2, (hw, hw))
    batch = {"image": torch.from_numpy(img).to(device), "mask": torch.from_numpy(mask).to(device)}
    state, _, m = train_step(state, batch, torch.Generator(device=device).manual_seed(seed),
                             ConfusionState.create(2, device))
    return dict(loss=m["loss"].item(),
                grads={k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
                state={k: v.detach().cpu() for k, v in state.model.state_dict().items()})


# an attention key's bias adds the same q·b to every logit of a query's row,
# which the softmax cancels: its exact gradient is 0 and both devices hold
# rounding noise there, which is held to the model's largest gradient
ZERO_GRADIENT = (".attn.key.bias",)


def compare_steps(gpu, cpu):
    """Normwise relative errors of loss, gradients and state (the largest);
    ``ZERO_GRADIENT`` leaves against the largest gradient of the model."""
    def zero_grad(k):
        return k.endswith(ZERO_GRADIENT)

    scale = max(float(v.abs().max()) for v in cpu["grads"].values())
    err_loss = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    err_grad = max(
        float((gpu["grads"][k] - v).abs().max()) / scale if zero_grad(k) else max_rel(
            gpu["grads"][k], v) for k, v in cpu["grads"].items() if v.abs().max() > 0)
    err_state = max(
        float((gpu["state"][k] - v).abs().max()) / scale if zero_grad(k) else max_rel(
            gpu["state"][k].float(), v.float()) for k, v in cpu["state"].items()
        if v.is_floating_point() and v.abs().max() > 0)
    return err_loss, err_grad, err_state


def check_iter_narrow(dl):
    """Phase 15; returns the launches by path and the numbers."""
    import importlib.util as iu

    launches, out = {}, {}
    # the iteration CLI's SGD step and a narrow ViT segmentor's step
    for name, cfg, hw in (("iter_step", ITER_TINY_MODEL, 32), ("vit", NARROW_VIT_MODEL, 32)):
        cpu = iter_sgd_step(cfg, "cpu", hw)
        torch.cuda.synchronize()
        dl.reset_launch_counts()
        gpu = iter_sgd_step(cfg, "cuda", hw)
        torch.cuda.synchronize()
        launches[f"phase15_{name}"] = dict(dl.LAUNCHES)
        err = compare_steps(gpu, cpu)
        ok = max(err) <= NARROW_TOL and math.isfinite(gpu["loss"])
        log(f"  {name} SGD step, card vs CPU (float32, batch 8, 32x32): loss rel {err[0]:.2e}, "
            f"gradients {err[1]:.2e}, parameters and statistics {err[2]:.2e} (normwise, "
            f"{NARROW_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 15: the {name} step on the card disagrees with the CPU")
        out[name] = dict(loss_rel=err[0], grad_rel=err[1], state_rel=err[2])

    # with_cp against the plain step, on the card
    cp_cfg = dict(ITER_TINY_MODEL, backbone=dict(ITER_TINY_MODEL["backbone"], with_cp=True))
    plain = iter_sgd_step(ITER_TINY_MODEL, "cuda", 32)
    torch.cuda.synchronize()
    dl.reset_launch_counts()
    cp = iter_sgd_step(cp_cfg, "cuda", 32)
    torch.cuda.synchronize()
    launches["phase15_with_cp"] = dict(dl.LAUNCHES)
    err = compare_steps(cp, plain)
    stats = [k for k in plain["state"] if k.endswith("running_mean")]
    moved = max(float((plain["state"][k] - cp["state"][k]).abs().max()) for k in stats)
    ok = max(err) <= 1e-5
    log(f"  with_cp step against the plain step on the card: loss rel {err[0]:.2e}, gradients "
        f"{err[1]:.2e}, parameters and running statistics {err[2]:.2e} (normwise, 1e-5: the "
        f"backward's reductions may order their sums otherwise; a second statistics update "
        f"would move them by 10 %); running means apart by at most {moved:.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 15: the with_cp step disagrees with the plain step")
    out["with_cp"] = dict(loss_rel=err[0], grad_rel=err[1], state_rel=err[2])

    # the mmseg pipeline of tests/test_data_layer.py over synthetic PNGs
    from cp2_tpu_torch.data.custom import CustomDataset

    root = os.path.join(ITER_WORK, "mmseg")
    synthetic_pairs(root, {"train": 16}, (40, 48), 2, seed=7)
    ann = os.path.join(root, "ann")
    os.makedirs(ann, exist_ok=True)
    for name in os.listdir(os.path.join(root, "masks")):
        from PIL import Image

        m = np.asarray(Image.open(os.path.join(root, "masks", name)))
        write_png(os.path.join(ann, name), (m > 0).astype(np.uint8))
    pipeline = [
        dict(type="LoadImageFromFile"), dict(type="LoadAnnotations"),
        dict(type="Resize", img_scale=(64, 48), ratio_range=(0.9, 1.1)),
        dict(type="RandomFlip", prob=0.5), dict(type="PhotoMetricDistortion"),
        dict(type="Normalize", mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
        dict(type="Pad", size=(64, 64)), dict(type="DefaultFormatBundle"),
        dict(type="Collect", keys=["img", "gt_semantic_seg"]),
    ]
    dl.reset_launch_counts()
    ds = CustomDataset(pipeline, img_dir=os.path.join(root, "images"), img_suffix=".png",
                       ann_dir=ann, seg_map_suffix=".png", classes=("bg", "fg"))
    t = time.perf_counter()
    items = [ds[i] for i in range(len(ds))]
    item_ms = (time.perf_counter() - t) * 1e3 / len(ds)
    miou = ds.evaluate(list(ds.get_gt_seg_maps()), metric="mIoU")["mIoU"]
    launches["phase15_mmseg_pipeline"] = dict(dl.LAUNCHES)
    has_cv2 = iu.find_spec("cv2") is not None
    ok = (len(items) == 16 and all(x["img"].shape == (64, 64, 3)
                                   and x["gt_semantic_seg"].shape == (64, 64) for x in items)
          and abs(miou - 1.0) < 1e-6)
    log(f"  mmseg pipeline (tests/test_data_layer.py's) over 16 synthetic 40x48 PNG pairs: "
        f"{item_ms:.1f} ms per item, shapes ok, mIoU of the ground truth {miou:.4f}; cv2 "
        f"{'importable' if has_cv2 else 'not importable'} here, and not imported by the port "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 15: the mmseg pipeline failed")
    out["mmseg_pipeline"] = dict(item_ms=item_ms, cv2_importable=has_cv2)
    shutil.rmtree(root, ignore_errors=True)
    return launches, out


# ---------------------------------------------------------------------------
# phases 16 and 17: the iteration CLI at full width
# ---------------------------------------------------------------------------

ITER_WORK = os.path.join("work_dirs", "chip_smoke_iter")
ITER_PAIRS, ITER_SRC_HW, ITER_HW, ITER_BATCH = 64, (576, 576), 512, 8
ITER_MAX, ITER_INTERVAL, ITER_CP_ITERS, VIT_ITERS = 40, 20, 10, 20
VIT_BACKBONE = dict(type="VisionTransformer")  # ViT-B/16 at the JAX defaults
VIT_HEAD = dict(type="FCNHead", in_channels=768, in_index=0, channels=256, num_classes=2)


def iter_config(path, *, max_iters, interval, with_cp=False, vit=False):
    """``configs/example_iter_train.py`` with the phase's cuts written in:
    ``max_iters`` and the eval/checkpoint ``interval`` (the config says
    40000 and 4000), and ``backbone.with_cp`` or the ViT backbone and head."""
    import cp2_tpu_torch

    src = os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs",
                       "example_iter_train.py")
    with open(src) as f:
        text = f.read()
    for a, b in (("max_iters=40000", f"max_iters={max_iters}"),
                 ("interval=4000", f"interval={interval}")):
        if a not in text:
            raise SystemExit(f"phase 16: {a!r} not in {src}")
        text = text.replace(a, b)
    if with_cp:
        text += "\nmodel['backbone']['with_cp'] = True\n"
    if vit:
        text += (f"\nmodel['backbone'] = {VIT_BACKBONE!r}\n"
                 f"model['decode_head'] = {VIT_HEAD!r}\n")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_iter_cli(dl, argv, launches, key):
    """The CLI's ``main`` on the card, with the default backends (cuDNN
    convolutions in TF32, matrix products in float32), each train step
    timed by ``FinetuneClock``; the launch counts of the run under ``key``;
    the peak memory."""
    from cp2_tpu_torch.train import iter_train, segmentation_task

    clock = FinetuneClock(segmentation_task.make_seg_steps)
    segmentation_task.make_seg_steps = clock
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as a user runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()
    t = clock.last = time.perf_counter()
    try:
        out = iter_train.main(iter_train.get_args(argv))
    finally:
        torch.backends.cudnn.allow_tf32 = False  # phase 1's setting
        segmentation_task.make_seg_steps = clock.make
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    launches[key] = dict(dl.LAUNCHES)
    times = [row[1] for row in clock.rows if row[0] == "train"]
    out["iter_times"] = times
    out["iter_ms_median_after_5"] = statistics.median(times[5:] if len(times) > 5 else times) * 1e3
    return out


def iter_problems(out, iters):
    problems = []
    if out["iter"] != iters:
        problems.append(f"ended at iteration {out['iter']}, not {iters}")
    if out["loss"] is None or not math.isfinite(out["loss"]):
        problems.append(f"last loss {out['loss']}")
    if set(out["final_eval"]) != {"aAcc", "IoU", "Acc", "mIoU"}:
        problems.append(f"eval keys {sorted(out['final_eval'])}")
    return problems


def check_iter_cli(dl):
    """Phases 16 and 17; returns the launches by run and the numbers."""
    from cp2_tpu_torch.train import iter_train

    shutil.rmtree(ITER_WORK, ignore_errors=True)
    data = os.path.join(ITER_WORK, "data")
    t = time.perf_counter()
    synthetic_pairs(data, {"train": ITER_PAIRS}, ITER_SRC_HW, 2, seed=11)
    log(f"  {ITER_PAIRS} synthetic {ITER_SRC_HW[0]}x{ITER_SRC_HW[1]} PNG pairs in "
        f"{time.perf_counter() - t:.1f} s")
    for var, sub in (("TRAIN_IMG_DIR", "images"), ("TRAIN_ANN_DIR", "masks"),
                     ("VAL_IMG_DIR", "images"), ("VAL_ANN_DIR", "masks")):
        os.environ[var] = os.path.join(data, sub)
    os.environ["IMG_SIZE"], os.environ["BATCH"] = str(ITER_HW), str(ITER_BATCH)
    launches, out = {}, {}
    cfg = iter_config(os.path.join(ITER_WORK, "example_iter_train_cut.py"),
                      max_iters=ITER_MAX, interval=ITER_INTERVAL)
    straight = os.path.join(ITER_WORK, "straight")
    run = run_iter_cli(dl, [cfg, "--work-dir", straight], launches, "phase16_iter_cli")
    problems = iter_problems(run, ITER_MAX)
    ckpts = sorted(int(d) for d in os.listdir(straight) if d.isdigit())
    if ckpts != [ITER_INTERVAL, ITER_MAX]:
        problems.append(f"checkpoints {ckpts}")
    if len(run["eval_seconds"]) != ITER_MAX // ITER_INTERVAL + 1:
        problems.append(f"{len(run['eval_seconds'])} evals")
    out["resnet50"] = run

    resumed = os.path.join(ITER_WORK, "resumed")
    res = run_iter_cli(dl, [cfg, "--work-dir", resumed, "--resume-from",
                            os.path.join(straight, str(ITER_INTERVAL))],
                       launches, "phase16_iter_cli_resume")
    problems += [f"resume: {p}" for p in iter_problems(res, ITER_MAX)]
    res_ckpts = sorted(int(d) for d in os.listdir(resumed) if d.isdigit())
    a = torch.load(os.path.join(straight, str(ITER_MAX), "state.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, str(ITER_MAX), "state.pt"), weights_only=True)
    lr_want = iter_train.poly_lr(0.003, ITER_MAX)(ITER_MAX - 1)
    lr_got = b["optimizer"]["param_groups"][0]["lr"]
    weight_rel = max(max_rel(b["model"][k].float(), v.float()) for k, v in a["model"].items()
                     if v.is_floating_point() and v.abs().max() > 0)
    momentum_rel = max(max_rel(b["optimizer"]["state"][i]["momentum_buffer"],
                               s["momentum_buffer"])
                       for i, s in a["optimizer"]["state"].items()
                       if s["momentum_buffer"].abs().max() > 0)
    if res_ckpts != [ITER_MAX] or b["step"] != ITER_MAX or abs(lr_got - lr_want) > 1e-9:
        problems.append(f"resume: checkpoints {res_ckpts}, step {b['step']}, lr {lr_got} "
                        f"(want {lr_want})")
    res.update(weights_rel_to_straight=weight_rel, momentum_rel_to_straight=momentum_rel)
    out["resnet50_resume"] = res

    cp_cfg = iter_config(os.path.join(ITER_WORK, "example_iter_train_cut_with_cp.py"),
                         max_iters=ITER_CP_ITERS, interval=ITER_MAX, with_cp=True)
    cp = run_iter_cli(dl, [cp_cfg, "--work-dir", os.path.join(ITER_WORK, "with_cp")],
                      launches, "phase16_iter_cli_with_cp")
    problems += [f"with_cp: {p}" for p in iter_problems(cp, ITER_CP_ITERS)]
    if cp["peak_bytes"] >= run["peak_bytes"]:
        problems.append(f"with_cp peak {cp['peak_bytes']} not below {run['peak_bytes']}")
    out["resnet50_with_cp"] = cp
    for name, r in (("ResNet-50 + ASPP-512", run), (f"  --resume-from {ITER_INTERVAL}", res),
                    ("  backbone.with_cp", cp)):
        ms = r["iter_ms_median_after_5"]
        log(f"  {name}: {r['iter']} iterations, iteration {ms:.1f} ms (median after 5), "
            f"{ITER_BATCH * 1e3 / ms:.1f} images/s, evals {', '.join('%.2f' % e for e in r['eval_seconds'])}"
            f" s, peak {r['peak_bytes'] / 2**30:.2f} GiB, last loss {r['loss']:.4f}, "
            f"mIoU {r['final_eval']['mIoU']:.4f}, wall {r['wall_s']:.1f} s")
    log(f"  resume: step {b['step']}, lr {lr_got:.6g}; at iteration {ITER_MAX} the weights are "
        f"{weight_rel:.2e} and the momentum {momentum_rel:.2e} (normwise) from the "
        f"uninterrupted run's")
    log(f"  with_cp: peak {cp['peak_bytes'] / 2**30:.2f} GiB against "
        f"{run['peak_bytes'] / 2**30:.2f} GiB, iteration "
        f"{cp['iter_ms_median_after_5'] / run['iter_ms_median_after_5']:.2f}x the plain one's; "
        f"on {gpu_line()}")
    if problems:
        raise SystemExit(f"phase 16: {'; '.join(problems)}")

    # phase 17: ViT-B/16 at 512² through the same CLI
    vit_cfg = iter_config(os.path.join(ITER_WORK, "example_iter_train_vit.py"),
                          max_iters=VIT_ITERS, interval=ITER_MAX, vit=True)
    vit = run_iter_cli(dl, [vit_cfg, "--work-dir", os.path.join(ITER_WORK, "vit")],
                       launches, "phase17_iter_cli_vit")
    problems = iter_problems(vit, VIT_ITERS)
    ms = vit["iter_ms_median_after_5"]
    log(f"  ViT-B/16 + FCN at 512² (position grid 14² -> 32²), batch 8, float32: "
        f"{vit['iter']} iterations, iteration {ms:.1f} ms (median after 5), "
        f"{ITER_BATCH * 1e3 / ms:.1f} images/s, peak {vit['peak_bytes'] / 2**30:.2f} GiB, last loss "
        f"{vit['loss']:.4f}, wall {vit['wall_s']:.1f} s; on {gpu_line()}")
    vit["tf32_matmul_iter_ms"] = vit_tf32_ms(vit_cfg)
    log(f"  the same ViT train step with TF32 matrix products: "
        f"{vit['tf32_matmul_iter_ms']:.1f} ms (median of 5 after 2)")
    if problems:
        raise SystemExit(f"phase 17: {'; '.join(problems)}")
    out["vit_b16"] = vit
    shutil.rmtree(ITER_WORK, ignore_errors=True)
    return launches, out


def vit_tf32_ms(cfg_path):
    """The ViT config's train step with ``allow_tf32`` on for matrix
    products too (random weights, batch 8 at 512²): median of 5 after 2."""
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.train import segmentation_task as task

    model = build_segmentor(Config.fromfile(cfg_path))
    state = task.create_seg_state(model, task.make_sgd(0.003, 0.9), "cuda")
    img, mask = seg_batch(ITER_BATCH, ITER_HW, 0)
    batch = {"image": torch.from_numpy(img).cuda(), "mask": torch.from_numpy(mask).cuda()}
    train_step, _, _ = task.make_seg_steps(2, (ITER_HW, ITER_HW))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    times = []
    try:
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_step(state, batch, torch.Generator(device="cuda").manual_seed(0),
                       ConfusionState.create(2, "cuda"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    del state, model
    torch.cuda.empty_cache()
    return statistics.median(times[2:])


# ---------------------------------------------------------------------------
# phase 18: more than one process
# ---------------------------------------------------------------------------

DIST_WORK = os.path.join("work_dirs", "chip_smoke_dist")
DIST_RANK, NCCL_PROBE = "--dist-rank", "--nccl-probe"  # this script's modes for its ranks
DIST_WORLD = 2
DIST_NARROW_BATCH = 4  # two rows a rank, 64x64
DIST_TOL = 1e-5
# a tensor that starts at zero (biases, zero-initialised residual scales)
# holds one update after the step, lr times its gradient: a gradient's
# tolerance there, phase 4's
DIST_UPDATE_TOL = 1e-4
DIST_CLI_BATCH, DIST_CLI_FRAMES = 32, 96  # 3 steps an epoch on each rank's 48 frames
DIST_FT_SPLITS = {"train": 32, "val": 8, "test": 8}  # batch 16: 2 steps of 8 rows a rank
DIST_MIRROR_SPLITS = {"train": 2 * MIRROR_BATCH, "val": MIRROR_BATCH}
DIST_ITER_PAIRS, DIST_ITER_MAX = 16, 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(mode, workdir, timeout):
    """``python3 chip_smoke.py <mode> <workdir>`` in ``DIST_WORLD`` processes
    with torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); waits for all of them, stops the
    others a few seconds after one fails, and stops any still running at
    ``timeout``.  Returns each rank's exit code and output."""
    port = free_port()
    procs, outs = [], []
    for rank in range(DIST_WORLD):
        env = dict(os.environ, WORLD_SIZE=str(DIST_WORLD), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        outs.append(open(os.path.join(workdir, f"{mode.strip('-')}_rank{rank}.log"), "w+b"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, workdir],
                                      env=env, stdout=outs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + 10)
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = []
    for f in outs:
        f.seek(0)
        logs.append(f.read().decode(errors="replace"))
        f.close()
    return [p.returncode for p in procs], logs


def nccl_probe(workdir) -> int:
    """A rank of the probe: NCCL on ``cuda:0`` for both ranks, one
    all-reduce."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl")
    x = torch.ones(4, device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"nccl all_reduce on one card: {x.tolist()}", flush=True)
    dist.destroy_process_group()
    return 0


def narrow_dist_step(device, rows):
    """One float32 CP2 step of phase 4's narrow model from seed 0 on
    ``rows`` of a pre-augmented batch of ``DIST_NARROW_BATCH``; the loss,
    the model's state before and after, the queue and its pointer, on the
    CPU."""
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl import output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import PretrainType

    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=16, queue_len=64)
    state = create_pretrain_state(SSLEncoder(SMALL_MODEL, dim=16), make_optimizer("sgd", 1e-3),
                                  hp, seed=0, device=device)
    step = make_pretrain_step(hp, output_stride_of(SMALL_MODEL))
    batch = pre_augmented_batch(DIST_NARROW_BATCH, 64, 0, "cpu")
    start = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    state, metrics = step(state, {k: v[rows].to(device) for k, v in batch.items()})
    return {"loss": metrics["loss"].item(), "start": start,
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "queue": state.queue.cpu(), "queue_ptr": state.queue_ptr}


def allreduce_ms(n_grads, device):
    """What gloo's all-reduces of CUDA tensors cost on this machine, in
    lockstep on every rank: the step's flat gradient buffer (median of 3)
    and a BatchNorm's (W, 3, 512) statistics (median of 50)."""
    import torch.distributed as dist

    def timed(x, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    return {"gradients": timed(torch.zeros(n_grads, device=device), 3),
            "gradient_values": n_grads,
            "batchnorm": timed(torch.zeros(DIST_WORLD, 3, 512, device=device), 50)}


def dist_rank(workdir) -> int:
    """One rank of phase 18(b): gloo, ``device="cuda:0"`` (the two ranks
    share the card); the narrow step, the pretrain CLI at full width with a
    resume, the finetune and mirror CLIs' ``--fast_dev_run`` and 4
    iterations of the iteration CLI.  Writes ``rank<r>.json`` (numbers and
    launch counts) and ``narrow_rank<r>.pt``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from cp2_tpu_torch import parallel
    from cp2_tpu_torch.ops import dense_loss as dl
    from cp2_tpu_torch.train import finetune, iter_train, mirror_pretrain, pretrain

    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's settings
    torch.backends.cudnn.allow_tf32 = False
    rank, device = int(os.environ["RANK"]), "cuda:0"
    parallel.initialize(backend="gloo")
    log(f"rank {rank} of {dist.get_world_size()}: backend {dist.get_backend()}, "
        f"device {device}")
    out = {"rank": rank, "backend": dist.get_backend(), "device": device, "launches": {}}

    def launched(key):
        out["launches"][key] = dict(dl.LAUNCHES)
        dl.reset_launch_counts()

    n = DIST_NARROW_BATCH // DIST_WORLD
    dl.reset_launch_counts()
    torch.save(narrow_dist_step(device, slice(rank * n, (rank + 1) * n)),
               os.path.join(workdir, f"narrow_rank{rank}.pt"))
    launched("narrow")

    # the pretrain CLI at full width: 6 steps, then a 1-step --resume
    logs = os.path.join(workdir, "logs")
    common = ["--run_id", "cp2", "--log_dir", logs, "--data_dirs", os.path.join(workdir, "frames"),
              "-b", str(DIST_CLI_BATCH), "--img_height", "224", "--img_width", "224",
              "--metrics_level", "1", "--scalar-freq", "3", "--print-freq", "3",
              "--visual-freq", "0"]
    clock = StepClock(pretrain.make_pretrain_step)
    pretrain.make_pretrain_step = clock
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock.last = time.perf_counter()
        state = pretrain.main(pretrain.get_args(common + ["--epochs", "2"]), device=device)
        launched("cli")
        out["cli"] = {"step": state.step, "queue_ptr": state.queue_ptr,
                      "peak_bytes": torch.cuda.max_memory_allocated(), "rows": clock.rows}
        del state
        clock.rows = []
        clock.last = time.perf_counter()
        state = pretrain.main(pretrain.get_args(
            common + ["--epochs", "3", "--max_steps", "6",
                      "--resume", os.path.join(logs, "cp2")]), device=device)
        launched("cli_resume")
        out["cli_resume"] = {"step": state.step, "queue_ptr": state.queue_ptr,
                             "rows": clock.rows}
        out["allreduce_ms"] = allreduce_ms(sum(p.numel() for p in state.model.parameters()),
                                           device)
        del state
    finally:
        pretrain.make_pretrain_step = clock.make

    ft = os.path.join(workdir, "polyp")
    t = time.perf_counter()
    out["finetune"] = finetune.main(finetune.get_args([
        "--run_id", "polyp", "--log_dir", logs, "--img_dirs", os.path.join(ft, "images"),
        "--mask_dirs", os.path.join(ft, "masks"), "--pretrain_type", "NONE",
        "--visualize_freq", "0", "--fast_dev_run"]), device=device)
    out["finetune_s"] = time.perf_counter() - t
    launched("finetune")

    t = time.perf_counter()
    state = mirror_pretrain.main(mirror_pretrain.get_args([
        "--run_id", "mirror", "--log_dir", logs, "--data_dirs",
        os.path.join(workdir, "mirror_frames"), "--fast_dev_run"]), device=device)
    out["mirror"] = {"step": state.step, "mirror_s": time.perf_counter() - t}
    del state
    launched("mirror")

    t = time.perf_counter()
    res = iter_train.main(iter_train.get_args([
        os.path.join(workdir, "example_iter_train_cut.py"), "--work-dir",
        os.path.join(workdir, "iter")]), device=device)
    out["iter"] = {"iter": res["iter"], "loss": res["loss"], "mIoU": res["final_eval"]["mIoU"],
                   "iter_s": time.perf_counter() - t}
    launched("iter")
    parallel.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


@contextlib.contextmanager
def nccl_world_of_one():
    """A NCCL process group of one rank, joined from torchrun's environment
    set here; the group is left and the environment restored after."""
    from cp2_tpu_torch import parallel

    saved = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                                            "MASTER_PORT")}
    os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    try:
        parallel.initialize(backend="nccl")
        yield
    finally:
        parallel.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_dist_nccl_world1(dl):
    """Phase 18(a): two full-width CP2 steps through the distributed code
    path with ``initialize(backend="nccl")`` and a world of one, against
    the same two steps of phase 5's step without a process group, on the
    same batch and weights, with cuDNN's deterministic algorithms; the
    difference of two runs without a group beside it (the run in a group
    may differ by no more: bit-equal where the two runs are)."""
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl import output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_optimizer, make_pretrain_step
    from cp2_tpu_torch.types import PretrainType
    import cp2_tpu_torch

    cfg = Config.fromfile(os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs",
                                       "config_pretrain.py"))
    model_cfg = dict(cfg.model)
    hp = SSLHyperParams.for_variant(PretrainType.CP2)
    batch = pre_augmented_batch(32, 224, 0, "cuda")

    def two_steps():
        state = create_pretrain_state(
            SSLEncoder(model_cfg, pretrain_type=PretrainType.CP2, dim=128, dtype=torch.bfloat16),
            make_optimizer("sgd", 1e-3), hp, seed=0)
        step = make_pretrain_step(hp, output_stride_of(model_cfg))
        losses = [step(state, batch)[1]["loss"].item() for _ in range(2)]
        flat = torch.cat([p.detach().float().reshape(-1) for p in state.model.parameters()]
                         + [b.float().reshape(-1) for b in state.model.buffers()]
                         + [state.queue.reshape(-1)])
        result = (losses, flat, state.queue_ptr)
        del state
        torch.cuda.empty_cache()
        return result

    # cuDNN's deterministic algorithms for this comparison: with its
    # default choices two runs of the same bf16 step part by 1e-4
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    plain = two_steps()
    again = two_steps()
    try:
        with nccl_world_of_one():
            import torch.distributed as dist

            backend, world = dist.get_backend(), dist.get_world_size()
            dl.reset_launch_counts()
            dist_run = two_steps()
            launches = dict(dl.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = False

    def diff(a, b):
        return (max(abs(x - y) for x, y in zip(a[0], b[0])),
                float((a[1] - b[1]).abs().max()), a[2] == b[2])

    d_dist, d_again = diff(dist_run, plain), diff(again, plain)
    log(f"  18(a) {backend}, world {world}: losses {['%.6f' % l for l in dist_run[0]]}; "
        f"against the steps without a group: loss diff {d_dist[0]:.3e}, state and queue max "
        f"abs diff {d_dist[1]:.3e}, queue_ptr equal {d_dist[2]}; two runs without a group "
        f"differ by {d_again[0]:.3e} / {d_again[1]:.3e}; launches {launches}")
    if not (d_dist[2] and d_dist[0] <= d_again[0] and d_dist[1] <= d_again[1]):
        raise SystemExit("phase 18(a): the step in a world of one differs from the step "
                         "without a process group by more than two runs differ")
    if launches != {"dense_pair_loss_fwd": 2, "dense_pair_loss_bwd": 2}:
        raise SystemExit(f"phase 18(a): launches {launches} in 2 steps")
    return launches, dict(backend=backend, world=world, losses=dist_run[0],
                          loss_diff=d_dist[0], state_max_abs_diff=d_dist[1],
                          plain_rerun_loss_diff=d_again[0], plain_rerun_state_diff=d_again[1])


def check_dist():
    """Phase 18; returns the launches by run and the numbers."""
    from cp2_tpu_torch.ops import dense_loss as dl

    launches, numbers = {}, {}
    launches["phase18a_nccl_world1"], numbers["nccl_world1"] = check_dist_nccl_world1(dl)

    shutil.rmtree(DIST_WORK, ignore_errors=True)
    os.makedirs(DIST_WORK)
    work = os.path.abspath(DIST_WORK)
    codes, outs = run_ranks(NCCL_PROBE, work, timeout=90)
    refusal = [line for out in outs for line in out.splitlines()
               if "Duplicate GPU" in line or "ncclInvalidUsage" in line][:1]
    numbers["nccl_two_ranks_one_card"] = {"exit_codes": codes, "refusal": refusal}
    log(f"  NCCL with two ranks on one card: exit codes {codes}"
        f"{'; ' + refusal[0].strip()[:200] if refusal else ''}")

    t = time.perf_counter()
    synthetic_frames(os.path.join(work, "frames"), DIST_CLI_FRAMES)
    synthetic_pairs(os.path.join(work, "polyp"), DIST_FT_SPLITS, (384, 448), 2, seed=21)
    csv_listed_frames(os.path.join(work, "mirror_frames"), DIST_MIRROR_SPLITS, (544, 544),
                      seed=22)
    synthetic_pairs(os.path.join(work, "iter_data"), {"train": DIST_ITER_PAIRS},
                    ITER_SRC_HW, 2, seed=23)
    for var, sub in (("TRAIN_IMG_DIR", "images"), ("TRAIN_ANN_DIR", "masks"),
                     ("VAL_IMG_DIR", "images"), ("VAL_ANN_DIR", "masks")):
        os.environ[var] = os.path.join(work, "iter_data", sub)
    os.environ["IMG_SIZE"], os.environ["BATCH"] = str(ITER_HW), str(ITER_BATCH)
    iter_config(os.path.join(work, "example_iter_train_cut.py"), max_iters=DIST_ITER_MAX,
                interval=DIST_ITER_MAX // 2)
    log(f"  data for the ranks in {time.perf_counter() - t:.1f} s")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    codes, outs = run_ranks(DIST_RANK, work, timeout=420)
    wall = time.perf_counter() - t
    for rank, out in enumerate(outs):
        with open(os.path.join("chiprun_out", f"chip_smoke_dist_rank{rank}.log"), "w") as f:
            f.write(out)
    if codes != [0] * DIST_WORLD:
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n{o[-3000:]}"
                          for r, (c, o) in enumerate(zip(codes, outs)))
        raise SystemExit(f"phase 18(b): ranks exited {codes}\n{tails}")
    ranks = []
    for rank in range(DIST_WORLD):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    log(f"  18(b) {DIST_WORLD} ranks in {wall:.1f} s: backend {ranks[0]['backend']}, device "
        f"{ranks[0]['device']} for both (gloo: NCCL refuses two ranks on one card)")
    problems = []

    # the narrow step against one process on the global batch
    ref = narrow_dist_step("cuda", slice(None))
    got = [torch.load(os.path.join(work, f"narrow_rank{r}.pt"), weights_only=False)
           for r in range(DIST_WORLD)]
    loss = sum(g["loss"] for g in got) / DIST_WORLD  # each rank's loss is its rows' mean
    err_loss = abs(loss - ref["loss"]) / abs(ref["loss"])
    moved = [k for k, v in ref["model"].items() if v.is_floating_point() and v.abs().max() > 0]
    err_state = max(max_rel(got[0]["model"][k], ref["model"][k]) for k in moved
                    if ref["start"][k].abs().max() > 0)
    err_update = max(max_rel(got[0]["model"][k] - ref["start"][k],
                             ref["model"][k] - ref["start"][k]) for k in moved
                     if (ref["model"][k] != ref["start"][k]).any())
    err_queue = max_rel(got[0]["queue"], ref["queue"])
    same = (all(torch.equal(got[1]["model"][k], v) for k, v in got[0]["model"].items())
            and torch.equal(got[1]["queue"], got[0]["queue"])
            and got[0]["queue_ptr"] == got[1]["queue_ptr"] == ref["queue_ptr"])
    log(f"  narrow float32 step, {DIST_WORLD} ranks vs one process on the global batch of "
        f"{DIST_NARROW_BATCH}: loss rel {err_loss:.2e}, state max rel {err_state:.2e}, queue "
        f"max rel {err_queue:.2e} (tolerance {DIST_TOL:g}); update max rel {err_update:.2e} "
        f"({DIST_UPDATE_TOL:g}: tensors that start at zero hold only it); ranks' states, "
        f"BatchNorm statistics, queues and pointers equal: {same}")
    if max(err_loss, err_state, err_queue) > DIST_TOL or err_update > DIST_UPDATE_TOL or \
            not same:
        problems.append("the narrow step in two ranks disagrees with one process")

    want = {"narrow": 1, "cli": 6, "cli_resume": 1, "finetune": 0, "mirror": 0, "iter": 0}
    for r in ranks:
        for key, count in want.items():
            if r["launches"][key] != {"dense_pair_loss_fwd": count, "dense_pair_loss_bwd": count}:
                problems.append(f"rank {r['rank']} {key}: launches {r['launches'][key]}")
        cli, res = r["cli"], r["cli_resume"]
        if (cli["step"], cli["queue_ptr"]) != (6, 6 * DIST_CLI_BATCH) or \
                (res["step"], res["queue_ptr"]) != (7, 7 * DIST_CLI_BATCH):
            problems.append(f"rank {r['rank']} CLI: {cli['step']}, {cli['queue_ptr']}; "
                            f"resume {res['step']}, {res['queue_ptr']}")
        losses = [row[-1] for row in cli["rows"] + res["rows"]]
        if not all(math.isfinite(x) for x in losses):
            problems.append(f"rank {r['rank']} CLI losses {losses}")
        quiet = [row[1] * 1e3 for row in cli["rows"][3:] if row[0] == 0]
        gaps = [row[2] for row in cli["rows"][3:]]
        r["numbers"] = dict(quiet_step_ms_median=statistics.median(quiet) if quiet else None,
                            images_per_s=DIST_CLI_BATCH * len(gaps) / sum(gaps),
                            peak_bytes=cli["peak_bytes"])
        log(f"  rank {r['rank']} pretrain CLI (global batch {DIST_CLI_BATCH}, 224x224, bf16): "
            f"step call ms {['%.1f' % (row[1] * 1e3) for row in cli['rows']]}; epoch 1 quiet "
            f"step median {r['numbers']['quiet_step_ms_median']} ms, "
            f"{r['numbers']['images_per_s']:.1f} global images/s, peak memory "
            f"{cli['peak_bytes'] / 2**30:.2f} GiB; resume to step {res['step']}, queue_ptr "
            f"{res['queue_ptr']}; launches {r['launches']['cli']}; gloo all-reduce of the "
            f"{r['allreduce_ms']['gradient_values']} gradients "
            f"{r['allreduce_ms']['gradients']:.1f} ms, of a BatchNorm's statistics "
            f"{r['allreduce_ms']['batchnorm']:.3f} ms; on {gpu_line()}")
        if not all(math.isfinite(v) for v in r["finetune"].values()):
            problems.append(f"rank {r['rank']} finetune metrics {r['finetune']}")
    if ranks[0]["finetune"] != ranks[1]["finetune"]:
        problems.append("the ranks' finetune test metrics differ")
    best = [d for d in os.listdir(os.path.join(work, "logs", "polyp")) if d.isdigit()]
    if len(best) != 1:
        problems.append(f"finetune checkpoints {best}")
    for key in ("mirror", "iter"):
        if {k: v for k, v in ranks[0][key].items() if not k.endswith("_s")} != \
                {k: v for k, v in ranks[1][key].items() if not k.endswith("_s")}:
            problems.append(f"the ranks' {key} results differ: {ranks[0][key]} {ranks[1][key]}")
    if ranks[0]["mirror"]["step"] != 2 or ranks[0]["iter"]["iter"] != DIST_ITER_MAX:
        problems.append(f"mirror {ranks[0]['mirror']}, iter {ranks[0]['iter']}")
    log(f"  finetune --fast_dev_run (polyp 352x352, batch 16, bf16): test {ranks[0]['finetune']} "
        f"on both ranks, best checkpoint {best}; mirror --fast_dev_run step "
        f"{ranks[0]['mirror']['step']}; iteration CLI {ranks[0]['iter']}")
    if problems:
        raise SystemExit(f"phase 18: {'; '.join(problems)}")
    for r in ranks:
        for key, count in r["launches"].items():
            launches[f"phase18_{key}_rank{r['rank']}"] = count
        numbers[f"rank{r['rank']}"] = {k: v for k, v in r.items() if k != "launches"}
    numbers["ranks_wall_s"] = wall
    numbers["narrow"] = dict(loss_rel=err_loss, state_max_rel=err_state, queue_max_rel=err_queue,
                             update_max_rel=err_update)
    shutil.rmtree(DIST_WORK, ignore_errors=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 19: the experiment drivers (cp2_tpu_torch/scripts/*.sh)
# ---------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPTS_WORK = os.path.join("work_dirs", "chip_smoke_scripts")
PORT_SCRIPTS = os.path.join(HERE, "cp2_tpu_torch", "scripts")
JAX_SCRIPTS = os.path.join(HERE, "scripts")
DRIVERS = ("ablation.sh", "combined.sh", "densecl.sh", "hist.sh", "imgnet-pretrained.sh",
           "lemon.sh", "lemon-cutpaste.sh", "neg_sampling_exp.sh", "polyp.sh",
           "polyp-cutpaste.sh", "proposed.sh", "same-foreground.sh", "sym-coord.sh")
KINDS = ("PRETRAIN", "FINETUNE", "MIRROR")
SCRIPT_STEPS = 3  # each pretrain run: --epochs 1 --max_steps 3 over 3 batches of images
# one synthetic ``.pth`` per key layout that checkpoint/convert.py tells apart:
# torchvision's, MoCo's ``module.encoder_q.`` and PixPro's ``module.encoder.``
IMGNET_LAYOUTS = {"CP2_IMGNET": "", "MOCO_IMGNET": "module.encoder_q.",
                  "PIXPRO_IMGNET": "module.encoder."}


def listed_frames(directory, count, hw, seed):
    """``synthetic_frames`` under ``directory``, listed by its ``train.csv``
    too (the CSV layout of hist.sh and lemon.sh)."""
    paths, _ = synthetic_frames(directory, count, hw, seed)
    with open(os.path.join(directory, "train.csv"), "w") as f:
        f.write("\n".join(os.path.basename(p) for p in paths) + "\n")
    return paths


def torchvision_layout(backbone):
    """The port's ResNet state dict (keys relative to the backbone) in
    torchvision's naming: the inverse of
    ``checkpoint.convert.torchvision_resnet_to_state_dict``."""
    out = {}
    for key, value in backbone.items():
        parts = key.split(".")
        if parts[0] == "conv1":
            name = "conv1.weight" if parts[1] == "conv" else f"bn1.{parts[-1]}"
        else:
            stage, block = parts[0][len("layer"):].split("_")
            base, mod = f"layer{stage}.{block}", parts[1]
            if mod in ("conv1", "conv2"):
                name = (f"{base}.{mod}.weight" if parts[2] == "conv"
                        else f"{base}.bn{mod[-1]}.{parts[-1]}")
            elif mod == "conv3":
                name = f"{base}.conv3.weight"
            elif mod == "norm3":
                name = f"{base}.bn3.{parts[-1]}"
            else:  # downsample.conv / downsample.norm
                name = f"{base}.downsample.{0 if parts[2] == 'conv' else 1}.{parts[-1]}"
        out[name] = value
    return out


def imgnet_checkpoints(directory, config):
    """``<TYPE>.pth`` for each of ``IMGNET_LAYOUTS``: ``config``'s ResNet
    initialised from a seed (one seed a file), in torchvision's names under
    the layout's prefix, beside keys the graft must leave alone (a
    classifier; MoCo's key encoder). Returns the parameters a graft must
    load from each."""
    from cp2_tpu_torch.checkpoint import convert
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.types import PretrainType

    cfg = Config.fromfile(config)
    cfg.model.decode_head.num_classes = 2
    os.makedirs(directory, exist_ok=True)
    params = {}
    for i, (ptype, prefix) in enumerate(IMGNET_LAYOUTS.items()):
        model = init_flax_like_(build_segmentor(dict(cfg.model)),
                                torch.Generator().manual_seed(100 + i))
        backbone = {k[len("backbone."):]: v for k, v in model.state_dict().items()
                    if k.startswith("backbone.") and v.is_floating_point()}
        tv = torchvision_layout(backbone)
        if convert.torchvision_resnet_to_state_dict(tv).keys() != backbone.keys():
            raise SystemExit(f"phase 19: the torchvision layout of {config}'s ResNet does "
                             "not convert back to its keys")
        state = {prefix + k: v for k, v in tv.items()}
        state[prefix + "fc.weight"] = torch.zeros(10, 2048)
        if prefix == "module.encoder_q.":
            state.update({"module.encoder_k." + k: torch.zeros_like(v) for k, v in tv.items()})
        group = ([t for t in convert.MOCO_PREFIX_TYPES] if prefix == "module.encoder_q." else
                 [t for t in convert.PIXPRO_TYPES] if prefix else
                 [t for t in convert.IMGNET_BACKBONE_TYPES])
        if PretrainType[ptype] not in group:
            raise SystemExit(f"phase 19: {ptype} is not of the layout {prefix!r}")
        torch.save({"state_dict": state} if prefix != "module.encoder." else {"model": state},
                   os.path.join(directory, f"{ptype}.pth"))
        params[ptype] = sum(1 for k in tv if not k.endswith(("running_mean", "running_var")))
    return params


def script_data():
    """Phase 19's synthetic data under ``SCRIPTS_WORK``: for each pretrain
    run images for exactly 3 batches at its script's batch (192 256x256 for
    -b 64, with SAM region maps and a train.csv; 96 544x544 for -b 32, with
    a train.csv; 576 more for combined.sh's second directory, 768 in all
    for -b 256), the mirror frames of phase 13's kinds, the polyp and lemon
    pairs of phase 11's kinds, the synthetic ``.pth`` files and 16 pairs
    for the iteration CLI."""
    import cp2_tpu_torch

    root = os.path.abspath(SCRIPTS_WORK)
    shutil.rmtree(root, ignore_errors=True)
    d = {k: os.path.join(root, *k.split("/")) for k in (
        "b64/images", "b32/images", "more/images", "mirror", "mirror_lemon", "pairs",
        "lemon_pairs", "ckpts", "logs", "bash_logs", "iter", "iter_work")}
    for path in d.values():
        os.makedirs(path, exist_ok=True)
    t = time.perf_counter()
    b64 = listed_frames(d["b64/images"], SCRIPT_STEPS * 64, (256, 256), seed=19)
    write_region_maps(b64)
    listed_frames(d["b32/images"], SCRIPT_STEPS * 32, (544, 544), seed=20)
    synthetic_frames(d["more/images"], SCRIPT_STEPS * (256 - 64), seed=21)
    csv_listed_frames(d["mirror"], {"train": 4 * MIRROR_BATCH, "val": MIRROR_BATCH + 2},
                      (544, 544), seed=22)
    csv_listed_frames(d["mirror_lemon"], {"train": LEMON_MIRROR_BATCH, "val": 8}, (576, 1056),
                      seed=23)
    synthetic_pairs(d["pairs"], FT_SPLITS, (384, 448), 2, seed=24)
    synthetic_pairs(d["lemon_pairs"], LEMON_SPLITS, (272, 512), 12, seed=25)
    synthetic_pairs(d["iter"], {"train": 2 * ITER_BATCH}, ITER_SRC_HW, 2, seed=26)
    d["imgnet_params"] = imgnet_checkpoints(d["ckpts"], os.path.join(
        os.path.dirname(cp2_tpu_torch.__file__), "configs", "config_finetune_moco.py"))
    log(f"  data in {time.perf_counter() - t:.1f} s: {SCRIPT_STEPS * 64} frames of 256x256 with "
        f"SAM maps and train.csv, {SCRIPT_STEPS * 32} of 544x544 with train.csv, "
        f"{SCRIPT_STEPS * 192} more of 256x256, mirror frames, polyp and lemon pairs, "
        f"{len(IMGNET_LAYOUTS)} .pth files ({d['imgnet_params']} parameters), "
        f"{2 * ITER_BATCH} iteration pairs")
    return d


def script_env(name, d, dryrun=True):
    """The environment a driver runs in: phase 19's directories, the
    drivers' own EPOCHS/BATCH/BACKBONE defaults."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CP2_SCRIPT_DRYRUN", "EPOCHS", "BATCH", "BACKBONE")}
    env.update(DATA_DIR=d["b64/images"], DATA_DIR2=d["more/images"],
               IMG_DIR=os.path.join(d["pairs"], "images"),
               MASK_DIR=os.path.join(d["pairs"], "masks"), CKPT_DIR=d["ckpts"],
               LOG_DIR=d["logs"])
    if name in ("lemon.sh", "same-foreground.sh"):
        env["DATA_DIR"] = d["b32/images"]
    elif name == "polyp-cutpaste.sh":
        env["DATA_DIR"] = d["mirror"]
    elif name == "lemon-cutpaste.sh":
        env.update(DATA_DIR=d["mirror_lemon"], IMG_DIR=os.path.join(d["lemon_pairs"], "images"),
                   MASK_DIR=os.path.join(d["lemon_pairs"], "masks"))
    if dryrun:
        env["CP2_SCRIPT_DRYRUN"] = "1"
    return env


def dryrun_invocations(script, env):
    out = subprocess.run(["bash", script], env=env, capture_output=True, text=True,
                         timeout=60)
    if out.returncode:
        raise SystemExit(f"phase 19: {script} exits {out.returncode} in dry-run mode:\n"
                         f"{out.stderr[-2000:]}")
    invocations = []
    for line in out.stdout.splitlines():
        kind, _, flags = line.partition("\t")
        if kind in KINDS:
            invocations.append((kind, shlex.split(flags)))
    return out.stdout, invocations


def jax_to_port(stdout):
    """A JAX driver's dry-run output as its twin prints it: the configs
    under ``cp2_tpu_torch/configs``, and ``config_moco.py`` given to
    same-foreground.sh's MoCo and BYOL pretrains, whose JAX invocations
    cannot start (see that twin)."""
    port_configs = os.path.join(HERE, "cp2_tpu_torch", "configs") + os.sep
    stdout = stdout.replace(os.path.join(HERE, "cp2_tpu", "configs") + os.sep, port_configs)
    return "\n".join(
        line + f" --config {port_configs}config_moco.py"
        if re.match(r"^PRETRAIN\t.* --run_id same-fg-(MOCO|BYOL) ", line) else line
        for line in stdout.split("\n"))


def check_dryruns(d):
    """(a): each twin's invocations equal the JAX driver's, mapped."""
    invocations = {}
    for name in DRIVERS:
        env = script_env(name, d)
        ours, inv = dryrun_invocations(os.path.join(PORT_SCRIPTS, name), env)
        theirs, _ = dryrun_invocations(os.path.join(JAX_SCRIPTS, name), env)
        if not inv or ours != jax_to_port(theirs):
            raise SystemExit(f"phase 19: {name}'s twin does not print the JAX driver's "
                             f"invocations:\n{ours}\n---\n{theirs}")
        invocations[name] = inv
    counts = {k: sum(kind == k for inv in invocations.values() for kind, _ in inv)
              for k in KINDS}
    log(f"  (a) dry runs: the {len(DRIVERS)} twins print the JAX drivers' invocations "
        f"(configs mapped): {counts}")
    return invocations


def weight_loop(argvs):
    """Whether ``argvs`` differ only in ``--run_id`` and one loss weight
    (``--lmbd_*``): such a loop runs its first and last iteration."""
    if len(argvs) < 3 or len({len(a) for a in argvs}) != 1:
        return False
    differing = {j for j in range(len(argvs[0])) if len({a[j] for a in argvs}) > 1}
    flags = {argvs[0][j - 1] for j in differing}
    return ("--run_id" in flags and len(flags) == 2
            and all(f == "--run_id" or f.startswith("--lmbd_") for f in flags))


def flag(argv, name):
    """The value after the last ``name`` in ``argv`` (argparse's last one
    wins), or None."""
    at = [i for i, a in enumerate(argv) if a == name]
    return argv[at[-1] + 1] if at else None


def script_runs(invocations):
    """(b)'s pretrain and mirror runs and (c)'s finetunes, as
    (driver, kind, argv, cut) in the drivers' order."""
    runs, finetunes = [], []
    for name in DRIVERS:
        inv = invocations[name]
        pre = [argv for kind, argv in inv if kind == "PRETRAIN"]
        if weight_loop(pre):
            pre = [pre[0], pre[-1]]
        runs += [(name, "PRETRAIN", argv, ["--epochs", "1", "--max_steps", str(SCRIPT_STEPS)])
                 for argv in pre]
        runs += [(name, "MIRROR", argv, ["--fast_dev_run"]) for kind, argv in inv
                 if kind == "MIRROR"]
        ft = [argv for kind, argv in inv if kind == "FINETUNE"]
        if name == "polyp.sh":
            finetunes += [(name, "FINETUNE", argv, ["--epochs", "2"]) for argv in ft]
        elif name in ("hist.sh", "lemon-cutpaste.sh"):
            finetunes += [(name, "FINETUNE", ft[0], ["--fast_dev_run"])]
        elif name in ("same-foreground.sh", "imgnet-pretrained.sh"):
            firsts = {}
            for argv in ft:
                firsts.setdefault(flag(argv, "--pretrain_type"), argv)
            finetunes += [(name, "FINETUNE", argv, ["--fast_dev_run"])
                          for ptype, argv in firsts.items() if ptype != "CP2"]
    return runs, finetunes


def run_script_pretrain(dl, clock, driver, argv, cut):
    """One pretrain run of (b) in process, on the card; its numbers and
    problems."""
    from cp2_tpu_torch.data import get_pretrain_files
    from cp2_tpu_torch.ssl.objectives import uses_dense_kernel
    from cp2_tpu_torch.train import pretrain
    from cp2_tpu_torch.types import PretrainType

    args = pretrain.get_args(argv + cut)
    n_files = len(get_pretrain_files(args.data_dirs, args.directory_type, "train"))
    hp = pretrain.hparams_from_args(args, dataset_size=n_files)
    kernel = args.pretrain_type in (PretrainType.CP2, PretrainType.PROPOSED) and \
        uses_dense_kernel(hp)
    want = SCRIPT_STEPS if kernel else 0
    clock.rows = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()  # this path's run starts here
    t = time.perf_counter()
    state = run_cli(pretrain, argv + cut, clock)
    launches = dict(dl.LAUNCHES)  # read just after the run
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    rows = list(clock.rows)
    run_dir = os.path.join(args.log_dir, args.run_id)
    problems = []
    if n_files != SCRIPT_STEPS * args.batch_size:
        problems.append(f"{n_files} images for batch {args.batch_size}")
    if state.step != SCRIPT_STEPS or len(rows) != SCRIPT_STEPS:
        problems.append(f"{state.step} steps")
    if state.queue.shape[0] != n_files:
        problems.append(f"queue of {state.queue.shape[0]}, want {n_files} (--cap_queue)")
    losses = [r[-1] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"losses {losses}")
    if any(v != want for v in launches.values()):
        problems.append(f"dense-loss launches {launches}, want {want} each")
    if not os.path.isdir(os.path.join(run_dir, str(SCRIPT_STEPS))):
        problems.append(f"no checkpoint {SCRIPT_STEPS} in {run_dir}")
    figures = None
    if args.visual_freq > 0 and args.pretrain_type in (PretrainType.CP2, PretrainType.PROPOSED):
        figures = pretrain_figures(run_dir, 0)
    feature_check = None
    if driver == "lemon.sh" and not problems:
        feature_check = check_unet_kernel_on_step_features(
            dl, state, name="lemon.sh's UNET_ENCODER_ONLY", hw=512, stride=32)
    quiet = [r[1] * 1e3 for r in rows if r[0] == 0]
    ips = args.batch_size * (len(rows) - 1) / sum(r[2] for r in rows[1:]) if len(rows) > 1 \
        else math.nan
    numbers = dict(
        driver=driver, kind="PRETRAIN", argv=argv, cut=cut, batch=args.batch_size,
        img_hw=[args.img_height, args.img_width], pretrain_type=args.pretrain_type.name,
        backbone=args.backbone_type.name, images=n_files, kernel_route=kernel,
        step_call_ms=[r[1] * 1e3 for r in rows], step_gap_ms=[r[2] * 1e3 for r in rows],
        step_levels=[r[0] for r in rows], losses=losses,
        quiet_ms_median=statistics.median(quiet) if quiet else math.nan,
        images_per_s_after_first_step=ips, peak_bytes=peak, run_wall_s=wall,
        launches=launches, figures=figures, lemon_kernel_check=feature_check)
    log(f"  {args.run_id:20s} {args.pretrain_type.name}/{args.backbone_type.name} "
        f"-b {args.batch_size} {args.img_height}x{args.img_width}: losses "
        f"{['%.4f' % x for x in losses]}; quiet step median {numbers['quiet_ms_median']:.1f} ms, "
        f"{ips:.1f} images/s after the first step; peak {peak / 2**30:.2f} GiB; launches "
        f"{launches} ({'kernel' if kernel else 'plain'} route); run {wall:.1f} s "
        f"{'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
    del state
    return args, numbers, problems


def run_script_mirror(dl, clock, driver, argv, cut):
    from cp2_tpu_torch.train import mirror_pretrain

    args = mirror_pretrain.get_args(argv + cut)
    clock.rows = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()  # this path's run starts here
    t = clock.last = time.perf_counter()
    mirror_pretrain.main(args)
    launches = dict(dl.LAUNCHES)  # read just after the run
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    rows = list(clock.rows)
    run_dir = os.path.join(args.log_dir, args.run_id)
    best = sorted((x for x in os.listdir(run_dir) if x.isdigit()), key=int)
    metas = []
    for x in best:
        with open(os.path.join(run_dir, x, "meta.json")) as f:
            metas.append(json.load(f).get("pretrain_type"))
    problems = []
    if not rows or not all(math.isfinite(r[-1]) for r in rows):
        problems.append(f"losses {[r[-1] for r in rows]}")
    if not metas or set(metas) != {"MIRROR"}:
        problems.append(f"checkpoints {best} tagged {metas}")
    if any(v != 0 for v in launches.values()):
        problems.append(f"dense-loss launches {launches}")
    train = [r for r in rows if r[0] == "train"]
    numbers = dict(driver=driver, kind="MIRROR", argv=argv, cut=cut, batch=args.batch_size,
                   img_hw=[args.img_x_size, args.img_y_size],
                   train_step_ms=[r[1] * 1e3 for r in train], losses=[r[-1] for r in rows],
                   peak_bytes=peak, run_wall_s=wall, checkpoints=best, launches=launches)
    log(f"  {args.run_id:20s} mirror {args.variant} -b {args.batch_size} "
        f"{args.img_x_size}x{args.img_y_size}: step calls "
        f"{['%.1f' % (r[1] * 1e3) for r in train]} ms; losses {['%.4f' % r[-1] for r in rows]}; "
        f"checkpoints {best} tagged {metas}; peak {peak / 2**30:.2f} GiB; launches {launches}; "
        f"run {wall:.1f} s {'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
    return args, numbers, problems


def run_script_finetune(dl, clock, reports, driver, argv, cut, imgnet_params):
    from cp2_tpu_torch.train import finetune

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dl.reset_launch_counts()  # this path's run starts here
    t = time.perf_counter()
    test_metrics, args = run_finetune(finetune, argv + cut, clock, reports)
    launches = dict(dl.LAUNCHES)  # read just after the run
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    rows = list(clock.rows)
    problems, monitor, epoch_rows, best, overlay = finetune_checks(
        args, test_metrics, rows, reports, launches,
        want_loaded=imgnet_params.get(args.pretrain_type.name))
    loaded = len(reports[0]["loaded"]) if reports else 0
    train = [r for r in rows if r[0] == "train"]
    numbers = dict(driver=driver, kind="FINETUNE", argv=argv, cut=cut, batch=args.batch_size,
                   img_hw=[args.img_height, args.img_width], classes=args.num_classes,
                   pretrain_type=args.pretrain_type.name, loaded_tensors=loaded,
                   train_step_ms=[r[1] * 1e3 for r in train], losses=[r[-1] for r in train],
                   peak_bytes=peak, run_wall_s=wall, test_metrics=test_metrics,
                   monitor=[r.get(monitor) for r in epoch_rows], best_checkpoint=best,
                   overlay_hw=overlay, launches=launches)
    log(f"  {args.run_id:20s} finetune {args.pretrain_type.name} ratio "
        f"{args.train_data_ratio} seed {args.seed}: loaded {loaded} tensors; "
        f"{len(train)} steps; {monitor} {[round(r.get(monitor, math.nan), 4) for r in epoch_rows]};"
        f" best {best}; overlay {overlay}; peak {peak / 2**30:.2f} GiB; launches {launches}; "
        f"run {wall:.1f} s {'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
    return args, numbers, problems


def run_bash(cmd, env, name, timeout):
    """``bash cmd...`` from the repository's root in a process group of its own
    (killed whole on a timeout); its output in ``chiprun_out/``."""
    t = time.perf_counter()
    proc = subprocess.Popen(["bash", *cmd], cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        out += f"\nkilled after {timeout} s"
    with open(os.path.join("chiprun_out", f"chip_smoke_scripts_{name}.log"), "w") as f:
        f.write(out)
    return proc.returncode, time.perf_counter() - t, out


def check_bash_drivers(d):
    """(d): polyp-cutpaste.sh (its preflight, then the mirror CLI for one
    epoch) and dist_train.sh (the iteration CLI, 4 iterations) for real."""
    problems, numbers = [], {}
    env = dict(script_env("polyp-cutpaste.sh", d, dryrun=False), EPOCHS="1",
               LOG_DIR=d["bash_logs"])
    rc, wall, out = run_bash([os.path.join(PORT_SCRIPTS, "polyp-cutpaste.sh")], env,
                             "polyp-cutpaste", 600)
    run_dir = os.path.join(d["bash_logs"], "cutpaste-polyp")
    ckpts = sorted((x for x in os.listdir(run_dir) if x.isdigit()), key=int) \
        if os.path.isdir(run_dir) else []
    preflight_ok = "preflight: ok" in out
    if rc != 0 or not ckpts or not preflight_ok:
        problems.append(f"polyp-cutpaste.sh: exit {rc}, checkpoints {ckpts}, preflight "
                        f"{'ok' if preflight_ok else 'missing'}")
    numbers["polyp-cutpaste.sh"] = dict(rc=rc, wall_s=wall, checkpoints=ckpts)
    log(f"  (d) bash polyp-cutpaste.sh (EPOCHS=1): exit {rc}, preflight "
        f"{'ok' if preflight_ok else 'missing'}, checkpoints {ckpts}, {wall:.1f} s (output in "
        f"chiprun_out/chip_smoke_scripts_polyp-cutpaste.log)")

    cfg = iter_config(os.path.join(d["iter_work"], "example_iter_train_cut.py"), max_iters=4,
                      interval=4)
    env = {k: v for k, v in os.environ.items() if k != "CP2_SCRIPT_DRYRUN"}
    env.update(TRAIN_IMG_DIR=os.path.join(d["iter"], "images"),
               TRAIN_ANN_DIR=os.path.join(d["iter"], "masks"),
               VAL_IMG_DIR=os.path.join(d["iter"], "images"),
               VAL_ANN_DIR=os.path.join(d["iter"], "masks"), IMG_SIZE=str(ITER_HW),
               BATCH=str(ITER_BATCH))
    work = os.path.join(d["iter_work"], "run")
    rc, wall, out = run_bash([os.path.join(PORT_SCRIPTS, "dist_train.sh"), cfg, "--work-dir",
                              work], env, "dist_train", 300)
    ckpts = sorted(int(x) for x in os.listdir(work) if x.isdigit()) if os.path.isdir(work) else []
    if rc != 0 or ckpts != [4]:
        problems.append(f"dist_train.sh: exit {rc}, checkpoints {ckpts}")
    numbers["dist_train.sh"] = dict(rc=rc, wall_s=wall, checkpoints=ckpts)
    log(f"  (d) bash dist_train.sh (example_iter_train.py cut to 4 iterations): exit {rc}, "
        f"checkpoints {ckpts}, {wall:.1f} s (output in chiprun_out/"
        f"chip_smoke_scripts_dist_train.log)")
    return numbers, problems


def check_scripts(dl):
    """Phase 19; returns the launches by run and the runs' numbers."""
    from cp2_tpu_torch.checkpoint import convert
    from cp2_tpu_torch.train import mirror_task, pretrain, segmentation_task

    t0 = time.perf_counter()
    d = script_data()
    invocations = check_dryruns(d)
    runs, finetunes = script_runs(invocations)
    keep = {flag(argv, "--pretrain_path") for _, _, argv, _ in finetunes}
    launches, numbers = {}, {"runs": {}}
    clock = StepClock(pretrain.make_pretrain_step)
    mclock = FinetuneClock(mirror_task.make_mirror_steps, train_key="train_loss",
                           eval_key="val_loss")
    fclock = FinetuneClock(segmentation_task.make_seg_steps)
    reports = []
    real_load = convert.load_pretrained_into_segmentor

    def recording_load(*a, **kw):
        merged, report = real_load(*a, **kw)
        reports.append(report)
        return merged, report

    pretrain.make_pretrain_step = clock
    mirror_task.make_mirror_steps = mclock
    segmentation_task.make_seg_steps = fclock
    convert.load_pretrained_into_segmentor = recording_load
    try:
        log(f"  (b) {sum(k == 'PRETRAIN' for _, k, _, _ in runs)} pretrain and "
            f"{sum(k == 'MIRROR' for _, k, _, _ in runs)} mirror runs on the drivers' argv "
            f"(sym-coord.sh's loss-weight loop: its first and last iteration)")
        for driver, kind, argv, cut in runs:
            run = (run_script_pretrain if kind == "PRETRAIN" else run_script_mirror)
            args, out, problems = run(dl, clock if kind == "PRETRAIN" else mclock, driver,
                                      argv, cut)
            launches[f"phase19_{args.run_id}"] = out["launches"]
            numbers["runs"][args.run_id] = out
            if problems:
                raise SystemExit(f"phase 19: {args.run_id}: {'; '.join(problems)}")
            run_dir = os.path.join(args.log_dir, args.run_id)
            if run_dir not in keep:  # a checkpoint no finetune reads
                shutil.rmtree(run_dir, ignore_errors=True)
            torch.cuda.empty_cache()
        log(f"  (c) {len(finetunes)} finetunes from (b)'s checkpoints and the synthetic .pth "
            f"files")
        for driver, kind, argv, cut in finetunes:
            args, out, problems = run_script_finetune(dl, fclock, reports, driver, argv, cut,
                                                      d["imgnet_params"])
            launches[f"phase19_{args.run_id}"] = out["launches"]
            numbers["runs"][args.run_id] = out
            if problems:
                raise SystemExit(f"phase 19: {args.run_id}: {'; '.join(problems)}")
            shutil.rmtree(os.path.join(args.log_dir, args.run_id), ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        pretrain.make_pretrain_step = clock.make
        mirror_task.make_mirror_steps = mclock.make
        segmentation_task.make_seg_steps = fclock.make
        convert.load_pretrained_into_segmentor = real_load
    numbers["bash"], problems = check_bash_drivers(d)
    if problems:
        raise SystemExit(f"phase 19: {'; '.join(problems)}")
    numbers["seconds"] = time.perf_counter() - t0
    log(f"  phase 19: {numbers['seconds']:.1f} s; on {gpu_line()}")
    shutil.rmtree(SCRIPTS_WORK, ignore_errors=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 20: the measuring tools (twins of bench.py, tools/bench_*.py,
# tools/profile_step.py and __graft_entry__.py)
# ---------------------------------------------------------------------------

TOOLS_WORK = os.path.join("work_dirs", "chip_smoke_tools")
# each tool at its JAX defaults (widths and batches); only its steps are cut
TOOL_STEPS = ["--steps", "10", "--warmup", "2"]
VARIANTS = ("DENSECL", "MOCO", "BYOL", "PROPOSED", "PROPOSED_V2")
TOOL_RUNS = [  # (names, a module or one a name, one argument list a name, environment)
    (["bench"], "cp2_tpu_torch.bench", [[]],
     {"BENCH_STEPS": "20", "BENCH_WARMUP": "3", "BENCH_E2E_STEPS": "10",
      "BENCH_E2E_REPEATS": "2"}),
    # the five variants in one process: they share its start-up
    ([f"bench_pretrain_variant_{v}" for v in VARIANTS],
     "cp2_tpu_torch.tools.bench_pretrain_variant",
     [["--variant", v, *TOOL_STEPS] for v in VARIANTS], {}),
    # five tools of one run each in one process: its start-up (10-28 s) is
    # paid once; each tool's main zeroes the launch counts it reports
    (["bench_finetune", "bench_infer", "bench_metrics", "bench_dense_loss",
      "bench_dilated_conv"],
     [f"cp2_tpu_torch.tools.{t}" for t in ("bench_finetune", "bench_infer", "bench_metrics",
                                           "bench_dense_loss", "bench_dilated_conv")],
     [TOOL_STEPS, ["--steps", "10"], ["--full-step", "--steps", "10"], ["--steps", "10"], []],
     {}),
    (["profile_step_pretrain", "profile_step_finetune"], "cp2_tpu_torch.tools.profile_step",
     [["--steps", "3", "--out", os.path.join(TOOLS_WORK, "profile_pretrain")],
      ["--task", "finetune", "--steps", "3", "--out",
       os.path.join(TOOLS_WORK, "profile_finetune")]], {}),
    # the dry run's ranks on the card, gloo (NCCL refuses two ranks on one card)
    (["graft_entry_dryrun"], "cp2_tpu_torch.graft_entry", [[]], {"GRAFT_DRYRUN_DEVICES": "2"}),
]
# the runs whose steps take the dense-loss kernels, once forward and once
# backward a step: the CP2 step, and PROPOSED at its defaults (unit
# weights, no negative reshaping, the dense loss of CP2); bench_dense_loss's
# steps are its kernel calls.  Every other run launches them no time.
KERNEL_ROUTE = {"bench", "bench_pretrain_variant_PROPOSED", "bench_metrics",
                "bench_dense_loss", "profile_step_pretrain", "graft_entry_dryrun"}


def run_tool(names, module, argvs, env_extra, timeout=300, cwd=HERE):
    """``module``'s runs from the repository's root, in a process of their
    own (phase 1's TF32 setting stays here): ``python -m module args`` as a
    user runs it for one run, its ``main`` on each argument list in turn
    for several.  Its output goes to ``chiprun_out/``.  Returns ({name:
    (the run's JSON line, its ``LAUNCHES`` line)}, seconds); a failure
    fails the phase.  ``module`` may be a list: one module a run."""
    from cp2_tpu_torch.utils.benchmarking import LAUNCH_TAG

    modules = [module] * len(argvs) if isinstance(module, str) else module
    if len(argvs) == 1:
        cmd = [sys.executable, "-m", modules[0], *argvs[0]]
    else:
        cmd = [sys.executable, "-c",
               "import gc, importlib, torch\n"
               f"for module, argv in {list(zip(modules, argvs))!r}:\n"
               "    importlib.import_module(module).main(argv); gc.collect(); "
               "torch.cuda.empty_cache()"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, env={**os.environ, **env_extra}, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t
    with open(os.path.join("chiprun_out", f"chip_smoke_tools_{names[0]}.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    lines = proc.stdout.strip().splitlines()
    # each run: its LAUNCHES line, then its JSON line (the first after it)
    runs = []
    for i, line in enumerate(lines):
        if line.startswith(LAUNCH_TAG + " "):
            out = next((x for x in lines[i + 1:] if x.startswith("{")), None)
            runs.append((out, line.split(" ", 1)[1]))
    if proc.returncode or len(runs) != len(names) or None in (o for o, _ in runs) or (
            not lines[-1].startswith("{")):
        raise SystemExit(f"phase 20: {names} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                         f"{proc.stderr[-3000:]}")
    return {name: (json.loads(out), json.loads(launch))
            for name, (out, launch) in zip(names, runs)}, seconds


def check_tools():
    """Phase 20: every measuring tool on the card as a user runs it, in
    processes of their own at its JAX defaults (steps cut); rates above 0,
    ``mfu`` in (0, 1], each counted step's FLOPs equal to the count from its
    configuration on the CPU (meta device, no step run), the dense-loss
    kernel against its plain version at bench_dense_loss's five batches
    (the tool fails otherwise), the kernels' launches per path against the
    steps each run counted, the dry run's two ranks on the card, and the
    flagship forward of ``graft_entry.entry()``.  Returns (launches by
    path, numbers)."""
    from cp2_tpu_torch.graft_entry import entry
    from cp2_tpu_torch.tools import bench_finetune, bench_pretrain_variant
    from cp2_tpu_torch.utils.benchmarking import model_config

    t0 = time.perf_counter()
    os.makedirs(TOOLS_WORK, exist_ok=True)
    launches, numbers, problems = {}, {}, []
    for names, module, argvs, env in TOOL_RUNS:
        runs, secs = run_tool(names, module, argvs, env)
        log(f"  {', '.join(names)}: {secs:.1f} s in one process")
        for name, (out, launch) in runs.items():
            numbers[name] = {"process_seconds": secs, **out}
            launches[f"phase20_{name}"] = {k: launch[k] for k in
                                           ("dense_pair_loss_fwd", "dense_pair_loss_bwd")}
            want = launch["steps"] if name in KERNEL_ROUTE else 0
            if launch["steps"] <= 0 or launch["dense_pair_loss_fwd"] != want or \
                    launch["dense_pair_loss_bwd"] != want:
                problems.append(f"{name}: launches {launch}, want {want} each")
            log(f"    {name}: {json.dumps(out)[:400]}")
    b = numbers["bench"]
    counts = {"bench": (b["model_flops_per_step"], bench_pretrain_variant.step_flops(
        model_config("config_pretrain.py"), "CP2", "DEEPLABV3", 32, 224))}
    for v in VARIANTS:
        counts[f"bench_pretrain_variant_{v}"] = (
            numbers[f"bench_pretrain_variant_{v}"]["model_flops_per_step"],
            bench_pretrain_variant.step_flops(
                model_config(bench_pretrain_variant.config_name(v)), v, "DEEPLABV3", 32, 224))
    counts["bench_finetune"] = (numbers["bench_finetune"]["model_flops_per_step"],
                                bench_finetune.step_flops(model_config("config_finetune.py"), 2,
                                                          16, 352))
    for name, (card_count, meta_count) in counts.items():
        if card_count != meta_count:
            problems.append(f"{name}: the card counted {card_count} FLOPs a step, the "
                            f"configuration {meta_count}")
        share = numbers[name]["mfu"]
        if not (share is not None and 0 < share <= 1 and numbers[name]["value"] > 0):
            problems.append(f"{name}: rate {numbers[name]['value']}, mfu {share}")
    if b["e2e_ips"] is None or b["e2e_ips"] <= 0:
        problems.append(f"bench: end-to-end rate {b['e2e_ips']}")
    inf = numbers["bench_infer"]
    if not (inf["whole_images_per_sec"] > 0 and inf["slide_images_per_sec"] > 0):
        problems.append(f"bench_infer: {inf}")
    if not all(v > 0 for v in numbers["bench_metrics"]["ms"].values()):
        problems.append(f"bench_metrics: {numbers['bench_metrics']['ms']}")
    dense = numbers["bench_dense_loss"]["by_batch"]
    if sorted(dense, key=int) != ["8", "32", "64", "128", "256"] or not all(
            r["kernel_ms"] > 0 and r["loss_rel"] <= F32_TOL["loss_rtol"]
            and max(r["dq_rel"], r["dk_rel"]) <= F32_TOL["grad_rtol"] for r in dense.values()):
        problems.append(f"bench_dense_loss: {dense}")
    for name in ("profile_step_pretrain", "profile_step_finetune"):
        if not numbers[name]["busy_share"] or numbers[name]["device_ms"] <= 0:
            problems.append(f"{name}: {numbers[name]}")
    if numbers["profile_step_pretrain"]["dense_loss_ms"] <= 0:
        problems.append("profile_step: no dense-loss kernel time in the pretrain trace")
    dry = numbers["graft_entry_dryrun"]
    if dry["n_processes"] != 2 or len(dry["losses"]) != 2 or not all(
            math.isfinite(x) for x in dry["losses"]) or dry["device"] == "cpu":
        problems.append(f"graft_entry dry run: {dry}")
    fn, args = entry()
    y = fn(*args)
    torch.cuda.synchronize()
    numbers["graft_entry"] = {"shape": list(y.shape), "dtype": str(y.dtype)}
    if tuple(y.shape) != (2, 14, 14, 128) or y.dtype != torch.bfloat16 or not bool(
            torch.isfinite(y).all()):
        problems.append(f"graft_entry.entry(): {tuple(y.shape)} {y.dtype}")
    del fn, args, y
    numbers["flops_card_vs_configuration"] = counts
    shutil.rmtree(TOOLS_WORK, ignore_errors=True)
    if problems:
        raise SystemExit(f"phase 20: {'; '.join(problems)}")
    numbers["seconds"] = time.perf_counter() - t0
    log(f"  phase 20: {numbers['seconds']:.1f} s; bench {b['device_ips']} images/s device-only, "
        f"{b['e2e_ips']} end to end ({b['loader']} loader), mfu {b['mfu']}, "
        f"{b['model_flops_per_step']} FLOPs a step; on {gpu_line()}")
    return launches, numbers


COMPARE, COMPARE_ONE = "--compare", "--compare-one"
PREFLIGHT = "--preflight"
TAP_SPLIT = "--tap-split"


# ---------------------------------------------------------------------------
# phase 21: the quality gate, short, on the card
# ---------------------------------------------------------------------------

GATE_WORK = os.path.join("work_dirs", "chip_smoke_gate")
GATE_SPLITS = {"n_train": 64, "n_val": 8, "n_test": 8, "n_unlabeled": 32}
GATE_PRETRAIN_EPOCHS = 2
GATE_JAX_ROW = os.path.join(HERE, "reports", "quality", "quality_gate.json")
# the JAX row whose pattern the second gate call follows: a pretrain
# reused at fewer epochs than it ran, the scratch leg imported
GATE_JAX_REUSE_ROW = os.path.join(HERE, "reports", "quality", "quality_gate_u1600_r1.0_s0.json")
GATE_LEGS = ("finetune_cp2", "finetune_scratch")


def key_problems(written, ref, what):
    """How ``written``'s key sets, top level and per leg, differ from
    ``ref``'s."""
    problems = []
    if set(written) != set(ref):
        problems.append(f"{what}: keys {sorted(written)} against {sorted(ref)}")
    for leg in GATE_LEGS:
        if set(written.get(leg, ())) != set(ref[leg]):
            problems.append(f"{what}: {leg} keys {sorted(written.get(leg, ()))} against "
                            f"{sorted(ref[leg])}")
    return problems


def gate_test_dataset(corpus):
    """The gate corpus's test images as a test-loop dataset: the second a
    flip-view pair, the third cut to 128x160 (maps of two shapes)."""
    from PIL import Image

    test_dir = os.path.join(corpus, "images")
    names = sorted(n for n in os.listdir(test_dir) if n.startswith("test_"))
    images = [np.asarray(Image.open(os.path.join(test_dir, n)).convert("RGB"),
                         np.float32) / 255.0 for n in names]
    images[2] = images[2][:128].copy()
    data = [{"img": img, "img_metas": {"flip": False}} for img in images]
    data[1] = [data[1], {"img": images[1][:, ::-1].copy(), "img_metas": {"flip": True}}]
    return data


def check_quality_gate(dl):
    """Phase 21; returns the launches by leg and the numbers."""
    from cp2_tpu_torch.checkpoint import latest_checkpoint
    from cp2_tpu_torch.tools import quality_gate
    from cp2_tpu_torch.train import inference, test_loop
    import cp2_tpu_torch

    t0 = time.perf_counter()
    shutil.rmtree(GATE_WORK, ignore_errors=True)
    corpus, logs, out = (os.path.join(GATE_WORK, d) for d in ("corpus", "logs", "out"))
    common = ["--root", corpus, "--log_dir", logs, "--out", out, "--finetune_epochs", "1",
              *[x for k, v in GATE_SPLITS.items() for x in (f"--{k}", str(v))]]
    quality_gate.main([*common, "--pretrain_epochs", str(GATE_PRETRAIN_EPOCHS)])
    gate_s = time.perf_counter() - t0
    first_json = os.path.join(out, f"quality_gate_u{GATE_SPLITS['n_unlabeled']}_r1.0_s0.json")
    # the pattern of the JAX rows that share one pretrain: a finetune seed
    # on the pretrain seed's checkpoint, reused at fewer epochs than it ran,
    # the scratch leg imported from the first row
    t = time.perf_counter()
    quality_gate.main([*common, "--pretrain_epochs", "1", "--seed", "1", "--pretrain_seed", "0",
                       "--reuse_pretrain", "--scratch_from", first_json])
    reuse_s = time.perf_counter() - t
    second_name = f"quality_gate_u{GATE_SPLITS['n_unlabeled']}_r1.0_s1.json"
    with open(first_json) as f:
        written = json.load(f)
    with open(os.path.join(out, second_name)) as f:
        reused = json.load(f)
    with open(os.path.join(out, "card", os.path.basename(first_json))) as f:
        card = json.load(f)
    with open(os.path.join(out, "card", second_name)) as f:
        reuse_card = json.load(f)
    with open(GATE_JAX_ROW) as f:
        jax_row = json.load(f)
    with open(GATE_JAX_REUSE_ROW) as f:
        jax_reuse_row = json.load(f)
    problems = key_problems(written, jax_row, "first call")
    problems += key_problems(reused, jax_reuse_row, "second call")
    for row in (written, reused):
        for leg in GATE_LEGS:
            dice = row[leg].get("test_Dice", float("nan"))
            if not (math.isfinite(dice) and 0.0 <= dice <= 1.0):
                problems.append(f"{leg} test_Dice {dice}")
    images = GATE_SPLITS["n_train"] + GATE_SPLITS["n_unlabeled"]
    steps = images // 32 * GATE_PRETRAIN_EPOCHS
    legs = card["legs"]
    launches = {f"phase21_gate_{leg}": legs[leg]["launches"] for leg in legs}
    launches.update({f"phase21_gate_reuse_{leg}": v["launches"]
                     for leg, v in reuse_card["legs"].items()})
    if legs["pretrain"]["steps"] != steps:
        problems.append(f"pretrain ran {legs['pretrain']['steps']} steps, not {steps}")
    for leg, want in (("pretrain", steps), *((leg, 0) for leg in GATE_LEGS)):
        if legs[leg]["launches"] != {"dense_pair_loss_fwd": want, "dense_pair_loss_bwd": want}:
            problems.append(f"{leg}: launches {legs[leg]['launches']}, want {want} each way")
    if set(reuse_card["legs"]) != {"finetune_cp2"}:
        problems.append(f"the second call ran the legs {sorted(reuse_card['legs'])}, want "
                        f"finetune_cp2 alone (no pretrain, the scratch leg imported)")
    if reuse_card["legs"].get("finetune_cp2", {}).get("launches") != {
            "dense_pair_loss_fwd": 0, "dense_pair_loss_bwd": 0}:
        problems.append(f"the second call's finetune launched {reuse_card['legs']}")
    if reused["pretrain_ckpt"] != written["pretrain_ckpt"] or \
            reused["pretrain_seconds"] is not None:
        problems.append(f"the second call's pretrain {reused['pretrain_ckpt']} "
                        f"({reused['pretrain_seconds']} s), not the first's "
                        f"{written['pretrain_ckpt']} reused")
    imported = dict(reused["finetune_scratch"])
    if imported.pop("imported_from", None) != first_json or \
            imported != written["finetune_scratch"]:
        problems.append(f"the second call's scratch leg {reused['finetune_scratch']} is not "
                        f"the first's imported")

    # multi_device_test in a world of one: the shard-and-gather path
    config = os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs",
                          "config_finetune.py")
    best = latest_checkpoint(os.path.join(logs, f"qg_ft_cp2_u{GATE_SPLITS['n_unlabeled']}_s0"))
    model = inference.init_segmentor(config, best, num_classes=2, dtype=torch.bfloat16)
    data = gate_test_dataset(corpus)
    want = test_loop.dataset_test(model, data)
    with nccl_world_of_one():
        got = test_loop.multi_device_test(model, data)
    same = len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
        for g, w in zip(got, want))
    if not same or len({w.shape for w in want}) != 2:
        problems.append("multi_device_test in a world of one differs from dataset_test")
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(GATE_WORK, ignore_errors=True)
    numbers = {"gate_seconds": gate_s, "reuse_seconds": reuse_s,
               "phase_seconds": time.perf_counter() - t0, "card": card,
               "reuse_card": reuse_card,
               "dice": {leg: written[leg]["test_Dice"] for leg in GATE_LEGS},
               "reuse_dice_cp2": reused["finetune_cp2"]["test_Dice"],
               "pretrain_loss_first": written["pretrain_loss_first"],
               "pretrain_loss_last": written["pretrain_loss_last"],
               "multi_device_test_equal": same}
    log(f"  gate: {gate_s:.1f} s; Dice CP2 {numbers['dice']['finetune_cp2']:.4f}, scratch "
        f"{numbers['dice']['finetune_scratch']:.4f}; " + "; ".join(
            f"{leg} {v['steps']} steps {v['seconds']:.1f} s {v['images_per_s']:.1f} images/s "
            f"peak {v['peak_mib']} MiB launches {v['launches']}" for leg, v in legs.items()))
    log(f"  gate, a second finetune seed on the first's pretrain (--reuse_pretrain at "
        f"--pretrain_epochs 1, --scratch_from): {reuse_s:.1f} s; Dice CP2 "
        f"{numbers['reuse_dice_cp2']:.4f}; legs run {sorted(reuse_card['legs'])}, launches "
        f"{reuse_card['legs'].get('finetune_cp2', {}).get('launches')}")
    log(f"  multi_device_test (NCCL, world 1) equal to dataset_test on {len(want)} samples: "
        f"{same}; phase {numbers['phase_seconds']:.1f} s")
    if problems:
        raise SystemExit(f"phase 21: {'; '.join(problems)}")
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 22: the gate's corpus on the card, and bfloat16 bias rounding
# ---------------------------------------------------------------------------

CORPUS_WORK = os.path.join("work_dirs", "chip_smoke_corpus")
CORPUS_DIGESTS = os.path.join(HERE, "reports", "quality_torch", "corpus_v1_s0_160.json")


def check_corpus_and_rounding():
    """Phase 22; returns its numbers."""
    import torch.nn.functional as F

    from cp2_tpu_torch.models.layers import conv2d, linear
    from cp2_tpu_torch.tools import synthetic_corpus

    t0 = time.perf_counter()
    config, files, pixels = synthetic_corpus.load_digests(CORPUS_DIGESTS)
    shutil.rmtree(CORPUS_WORK, ignore_errors=True)
    synthetic_corpus.generate(CORPUS_WORK, config["size"],
                              {k: config[f"n_{k}"] for k in ("train", "val", "test")},
                              config["seed"], version=config["version"])
    report = synthetic_corpus.compare_digests(CORPUS_WORK, files, pixels)
    shutil.rmtree(CORPUS_WORK, ignore_errors=True)
    corpus = {"files": report["files"], "missing": len(report["missing"]),
              "pixels_differ": len(report["pixels_differ"]),
              "bytes_differ": len(report["bytes_differ"]),
              "largest_pixel_difference": report["largest_pixel_difference"],
              "seconds": time.perf_counter() - t0}
    log(f"  corpus v1 seed 0 at 160x160 ({report['files']} files against the digests of the "
        f"JAX tool's corpus): {corpus['missing']} missing, {corpus['pixels_differ']} differ in "
        f"pixels, {corpus['bytes_differ']} in bytes; largest pixel difference "
        f"{corpus['largest_pixel_difference']} over {len(pixels)} files kept whole; "
        f"{corpus['seconds']:.1f} s")
    if corpus["missing"] or corpus["pixels_differ"]:
        raise SystemExit("phase 22: the card's corpus differs from the committed digests: "
                         f"{(report['missing'] + report['pixels_differ'])[:5]}")

    g = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.nn.Conv2d(512, 2, 1).cuda()
    x = torch.randn(16, 512, 22, 22, device="cuda", generator=g).bfloat16()
    ours = conv2d(conv, x, torch.bfloat16)
    fused = F.conv2d(x, conv.weight.bfloat16(), conv.bias.bfloat16())
    fc = torch.nn.Linear(512, 128).cuda()
    rows = torch.randn(4096, 512, device="cuda", generator=g).bfloat16()
    split = linear(fc, rows, torch.bfloat16)
    lt_fused = F.linear(rows, fc.weight.bfloat16(), fc.bias.bfloat16())
    rounding = {"conv_seg_equal_to_cudnn": bool(torch.equal(ours, fused)),
                "conv_seg_share_differing": float((ours != fused).float().mean()),
                "linear_share_differing_from_fused": float((split != lt_fused).float().mean())}
    log(f"  bfloat16 bias: conv_seg through layers.conv2d equals cuDNN's F.conv2d with its "
        f"bias bit for bit: {rounding['conv_seg_equal_to_cudnn']} (share differing "
        f"{rounding['conv_seg_share_differing']:.2e}); a linear layer's bias added after the "
        f"rounding differs from the fused bias in {rounding['linear_share_differing_from_fused']:.2e}"
        " of its outputs")
    if not rounding["conv_seg_equal_to_cudnn"]:
        raise SystemExit("phase 22: conv_seg in bfloat16 rounds otherwise than cuDNN's biased "
                         "convolution on the card")
    return {"corpus": corpus, "bf16_bias": rounding}


# ---------------------------------------------------------------------------
# phase 23: the tap split against cuDNN's dilated convolution, bfloat16
# ---------------------------------------------------------------------------

TAP_SPLIT_SHAPES = ((64, 14), (16, 22))  # (batch, grid): the pretrain's, the finetune's
TAP_SPLIT_MAX_ABS = 5e-2  # tests/test_torch_model.py's bfloat16 tolerance
TAP_SPLIT_NORM_RATIO = {"output": 2.0, "input_gradient": 2.5, "weight_gradient": 2.0}


def check_tap_split():
    """Phase 23; returns its numbers."""
    import torch.nn.functional as F

    from cp2_tpu_torch.models import layers

    numbers, problems = {}, []
    for n, hw in TAP_SPLIT_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(hw)
        x = torch.randn(n, 2048, hw, hw, device="cuda", generator=g).bfloat16()
        gy = torch.randn(n, 512, hw, hw, device="cuda", generator=g).bfloat16()
        for d in (12, 18):
            conv = torch.nn.Conv2d(2048, 512, 3, padding=d, dilation=d, bias=False).cuda()
            with torch.no_grad():
                conv.weight.normal_(0.0, (2048 * 9) ** -0.5, generator=g)
            if not layers.tap_split_engages(conv, x):
                problems.append(f"({n}, 2048, {hw}, {hw}) d={d}: conv2d does not split")
                continue

            def run(fn, dtype):
                xi = x.to(dtype).requires_grad_()
                y = fn(xi)
                return (y,) + torch.autograd.grad(y, (xi, conv.weight), gy.to(dtype))

            def split(xi):
                return layers.conv2d(conv, xi, xi.dtype)

            def plain(xi):
                return F.conv2d(xi, conv.weight.to(xi.dtype), None, 1, d, d)

            ours, cudnn = run(split, torch.bfloat16), run(plain, torch.bfloat16)
            ref = run(plain, torch.float32)  # TF32 is off (phase 1)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                run(split, torch.bfloat16)
                synced = False
            except RuntimeError:
                synced = True
            finally:
                torch.cuda.set_sync_debug_mode("default")
            row = {"host_sync": synced,
                   "us_split": cuda_ms(lambda: run(split, torch.bfloat16), iters=10) * 1e3,
                   "us_cudnn": cuda_ms(lambda: run(plain, torch.bfloat16), iters=3) * 1e3}
            for name, a, b, e in zip(TAP_SPLIT_NORM_RATIO, ours, cudnn, ref):
                a, b, e = a.detach(), b.detach(), e.detach().float()
                row[name] = {"max_abs_vs_cudnn": float((a.float() - b.float()).abs().max()
                                                       / e.abs().max()),
                             "norm_ratio": float((a.float() - e).norm() / (b.float() - e).norm()),
                             "share_differing": float((a != b).float().mean())}
                if (row[name]["max_abs_vs_cudnn"] > TAP_SPLIT_MAX_ABS
                        or row[name]["norm_ratio"] > TAP_SPLIT_NORM_RATIO[name]):
                    problems.append(f"({n}, 2048, {hw}, {hw}) d={d} {name}: {row[name]}")
            if synced:
                problems.append(f"({n}, 2048, {hw}, {hw}) d={d}: a host sync in the split")
            key = f"{n}x2048x{hw}x{hw}_d{d}"
            numbers[key] = row
            parts = [f"{name} {row[name]['max_abs_vs_cudnn']:.2e} of the largest off cuDNN's, "
                     f"{row[name]['norm_ratio']:.2f}x its distance from float32, "
                     f"{row[name]['share_differing']:.3f} differing"
                     for name in TAP_SPLIT_NORM_RATIO]
            log(f"  {key}: split {row['us_split']:.0f} us, cuDNN {row['us_cudnn']:.0f} us a "
                f"fwd+bwd; {'; '.join(parts)}; host sync: {synced}")
    if problems:
        raise SystemExit(f"phase 23: {'; '.join(problems)}")
    return numbers


def tap_split_alone() -> int:
    """``--tap-split``: phase 1's device check and phase 23."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {gpu_line()}; TF32 off")
    log("the tap split against cuDNN's dilated convolution, bfloat16:")
    numbers = check_tap_split()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_tap_split.json"), "w") as f:
        json.dump({"card": gpu_line(), "tap_split": numbers}, f, indent=1)
    log(f"tap split: ok on {gpu_line()}")
    return 0


def compare_one() -> int:
    """In the tree that is the working directory (its ``cp2_tpu_torch``):
    phase 5's step, phases 16-17's runs and the bench's device-only rate;
    one ``COMPARE {json}`` line."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.getcwd())
    from cp2_tpu_torch.ops import cuda_build
    from cp2_tpu_torch.ops import dense_loss as dl

    torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's settings
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs("chiprun_out", exist_ok=True)
    cuda_build.build(["dense_loss"])
    _, step = full_step(dl)
    _, runs = check_iter_cli(dl)
    bench_ips = None
    if os.path.exists(os.path.join("cp2_tpu_torch", "bench.py")):
        runs, _ = run_tool(["bench"], "cp2_tpu_torch.bench", [[]], {"BENCH_E2E": "0"},
                           cwd=os.getcwd())
        bench_ips = runs["bench"][0]["device_ips"]
    log("COMPARE " + json.dumps({"step_ms": step["median_step_ms"],
                                 "bench_device_ips": bench_ips, **{
        f"{k}_iter_ms": v["iter_ms_median_after_5"] for k, v in runs.items()
        if isinstance(v, dict) and "iter_ms_median_after_5" in v}}))
    return 0


def compare_trees(parent) -> int:
    """Phase 5's step and phases 16-17 of the package in ``parent`` (an
    unpacked tree of another commit) and of this one, in turns on one
    card: parent, this, this, parent; each in a process of its own, by
    this script's code."""
    if not torch.cuda.is_available():
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    log(gpu_line())
    rows = []
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), COMPARE_ONE],
                             cwd=os.path.abspath(root), capture_output=True, text=True)
        found = [line for line in out.stdout.splitlines() if line.startswith("COMPARE ")]
        if out.returncode or not found:
            log(f"{label}: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
            return 1
        rows.append((label, json.loads(found[-1].split(" ", 1)[1])))
        log(f"{label}: {rows[-1][1]}")
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "compare.json"), "w") as f:
        json.dump({"card": gpu_line(), "runs": rows}, f, indent=1)
    return 0


def preflight_phases():
    """Phases 1-4, the experiment drivers' preflight: the device, the
    build, every kernel against its plain version at every shape, and the
    narrow step on the card against the CPU.  Returns (card line, the
    dense-loss module, the step shape's kernel numbers), or None without a
    card."""
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return None
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
        if info["cached"]:
            log(f"  {name}: built before, loaded from cp2_tpu_torch/_build/")
            continue
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
    return card, dl, flagship


def preflight() -> int:
    """``--preflight``: phases 1-4 alone (``cp2_tpu_torch/scripts/common.sh``
    runs it before every experiment)."""
    found = preflight_phases()
    if found is None:
        return 1
    log(f"preflight: ok on {found[0]}")
    return 0


def main() -> int:
    found = preflight_phases()
    if found is None:
        return 1
    card, dl, flagship = found

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

    # phase 11: the finetune CLI at full width
    log("finetune CLI:")
    ft_launches, ft_cli = check_finetune_cli(dl)

    # phase 12: the mirror path, narrow and at the CLI's shape, card against CPU
    log("mirror (CutPaste) augmentation and step, card vs CPU:")
    cutpaste = check_cutpaste()
    mirror_step_launches, mirror_step = check_mirror_steps(dl)

    # phase 13: the mirror CLI at full width, then a MIRROR finetune from it
    log("mirror CLI:")
    mirror_launches, mirror_cli = check_mirror_cli(dl, os.path.join(FT_WORK, "polyp"))

    # phase 14: inference and serving from phase 11's polyp checkpoint
    log("inference and serving:")
    serve_launches, serve = check_inference_serving(
        dl, os.path.join(FT_WORK, "logs", "polyp", ft_cli["polyp"]["best_checkpoint"]))
    shutil.rmtree(FT_WORK, ignore_errors=True)

    # phase 15: the iteration CLI's path, narrow, card against CPU
    log("iteration CLI path, ViT, with_cp and the mmseg pipeline, narrow:")
    iter_narrow_launches, iter_narrow = check_iter_narrow(dl)

    # phases 16 and 17: the iteration CLI at full width, ResNet-50 and ViT-B/16
    log("iteration CLI at full width:")
    iter_launches, iter_cli = check_iter_cli(dl)

    # phase 18: more than one process
    log("more than one process:")
    dist_launches, dist = check_dist()

    # phase 19: the experiment drivers
    log("experiment drivers (cp2_tpu_torch/scripts/*.sh):")
    script_launches, scripts = check_scripts(dl)

    # phase 20: the measuring tools
    log("measuring tools (twins of bench.py, tools/bench_*.py, tools/profile_step.py, "
        "__graft_entry__.py):")
    tool_launches, tools = check_tools()

    # phase 21: the quality gate, short
    log("quality gate (cp2_tpu_torch.tools.quality_gate), short:")
    gate_launches, gate = check_quality_gate(dl)

    # phase 22: the gate's corpus on the card, and bfloat16 bias rounding
    log("the gate's corpus against its committed digests, and bfloat16 bias rounding:")
    corpus = check_corpus_and_rounding()

    # phase 23: the tap split against cuDNN's dilated convolution
    log("the tap split against cuDNN's dilated convolution, bfloat16:")
    tap_split = check_tap_split()
    with open(os.path.join("chiprun_out", "chip_smoke_step.json"), "w") as f:
        json.dump({"card": card, **step, "step_launches": step_launches,
                   "augment": aug_ms, "cli": cli, "variant_step_launches": variant_launches,
                   "cli_variants": cli9, "finetune_augment": ft_aug, "finetune_step": ft_step,
                   "finetune_cli": ft_cli, "cutpaste": cutpaste, "mirror_step": mirror_step,
                   "mirror_cli": mirror_cli, "inference_serving": serve,
                   "iter_narrow": iter_narrow, "iter_cli": iter_cli, "dist": dist,
                   "scripts": scripts, "tools": tools, "quality_gate": gate,
                   "corpus_and_rounding": corpus, "tap_split": tap_split,
                   "kernel_times_by_shape": flagship["by_shape"]}, f,
                  indent=1)
    log(f"  per-run numbers in chiprun_out/chip_smoke_step.json; on {gpu_line()}")

    def by_path(name):
        """Launches of one kernel on every path the script drives: the
        pretrain step's paths, and the finetune, mirror, inference,
        serving and iteration-CLI paths, which run no dense-loss kernel;
        and phase 18's runs, each rank's counted in that rank's process,
        phase 20's tools, each counted in its own process, and phase 21's
        gate legs, each counted by the gate around its CLI call."""
        paths = {"phase5_step": step_launches[name], "phase7_cli_CP2": launches[name]}
        paths.update({f"phase8_{case}": n[name] for case, n in variant_launches.items()})
        paths.update({f"phase9_cli_{run}": n[name] for run, n in cli9_launches.items()})
        paths["phase10_finetune_step"] = ft_step_launches[name]
        paths.update({f"phase11_finetune_{run}": n[name] for run, n in ft_launches.items()})
        paths.update({f"phase12_mirror_step_{v}": n[name] for v, n in mirror_step_launches.items()})
        paths.update({f"phase13_{run}": n[name] for run, n in mirror_launches.items()})
        paths.update({f"phase14_{run}": n[name] for run, n in serve_launches.items()})
        paths.update({run: n[name] for run, n in iter_narrow_launches.items()})
        paths.update({run: n[name] for run, n in iter_launches.items()})
        paths.update({run: n[name] for run, n in dist_launches.items()})
        paths.update({run: n[name] for run, n in script_launches.items()})
        paths.update({run: n[name] for run, n in tool_launches.items()})
        paths.update({run: n[name] for run, n in gate_launches.items()})
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
         "times_by_shape": {k: {m: v for m, v in t.items() if m.startswith("fwd")}
                            for k, t in flagship["by_shape"].items()},
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
         "times_by_shape": {k: {m: v for m, v in t.items() if m.startswith("bwd")}
                            for k, t in flagship["by_shape"].items()},
         "check": "pass", "shape": list(STEP_SHAPE)},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == DIST_RANK:
        sys.exit(dist_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == NCCL_PROBE:
        sys.exit(nccl_probe(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == COMPARE:
        sys.exit(compare_trees(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == COMPARE_ONE:
        sys.exit(compare_one())
    if len(sys.argv) == 2 and sys.argv[1] == PREFLIGHT:
        sys.exit(preflight())
    if len(sys.argv) == 2 and sys.argv[1] == TAP_SPLIT:
        sys.exit(tap_split_alone())
    sys.exit(main())

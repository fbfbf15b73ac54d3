#!/usr/bin/env python3
"""Where the time of the port's full-width pretrain step goes, on one NVIDIA card.

    python3 tools/profile_torch_step.py [--steps 3] [--cli]
        [--pretrain_type CP2] [--config PATH] [--backbone_type DEEPLABV3]

Builds the step as ``chip_smoke.py`` does (by default CP2: dilated
ResNet-50 + ASPP-512, contrast dim 128, queue 65536, 224x224, batch 32,
bfloat16 model, SGD), warms it up, then:

1. times ``--steps`` steps with the host clock, each ending in
   ``torch.cuda.synchronize()``, with cuDNN's default algorithm choice;
2. profiles the same number of steps with ``torch.profiler`` (CPU and
   CUDA activities) and prints the device time by kernel, the share of
   the window the device was busy, and the device time of the dense
   pair-loss kernels;
3. times the same steps again with ``torch.backends.cudnn.benchmark``
   on, which lets cuDNN measure its algorithms once per shape;
4. times each ASPP branch's convolution alone (forward, and forward +
   backward) on the head's real input, (32, 2048, 14, 14) bfloat16, in
   both memory layouts: contiguous NCHW, which ``SSLEncoder.dense`` hands
   the network whatever its input's strides, and channels-last (NHWC in
   memory), what a contiguous NHWC batch becomes when only permuted.

With ``--cli`` the step is the pretrain CLI's quiet step instead: raw
(32, 256, 256, 3) uint8 ``fg``/``bg0``/``bg1`` frames on the card, the
on-device augmentation inside the step (``augment_fn``, a generator per
step), and the epoch scalars; steps 1 and 2 run on it, then

5. the augmentation alone under ``torch.profiler``: its device time per
   batch and its kernels by name, beside the step's device time;
6. the logged step (``metrics_level`` 1) timed like step 1;
7. the step of phase 5 on its pre-augmented batch, timed like step 1,
   with the images contiguous (N, H, W, C) as there and with them laid
   out as the augmentation leaves them ((N, W, H, C) in memory), which
   must now take the same time; and once with the network fed a
   channels-last copy of its input instead of the encoder's explicit
   NCHW one, to keep the record of what the layout costs;
8. the quiet CLI step timed like step 1 while three host loaders, built
   as the CLI builds them (PIL, ``--num-workers`` 4 and 1), decode
   256x256 PNGs as fast as they can in the background, beside the frames
   per second they decode: the host's share of the CLI's time.

``--pretrain_type`` profiles another variant's step the same way, with
the hyperparameters of the repo's run scripts (PROPOSED: ``proposed.sh``'s
PIXEL_REGION_ID 10/1/0; PROPOSED_V2: ``sym-coord.sh``'s symmetric loss,
predictor and coordinate 0.5) and, unless ``--config`` says otherwise,
``config_moco.py`` for MOCO, BYOL and DENSECL and ``config_pretrain.py``
for the rest; ``--backbone_type`` takes CP2 onto a U-Net.  Items 4 and 7
time the CP2 ASPP head and phase 5's CP2 step, and run for the default
CP2 step only.

It prints the card's name and power limit beside the numbers and writes
the profiler table and a Chrome trace under ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import gpu_line, pre_augmented_batch  # noqa: E402


# the run scripts' hyperparameters of the variants that take some
VARIANT_HP = {
    "PROPOSED": dict(mapping_type="PIXEL_REGION_ID", lmbd_pixel_corr_weight=10.0,
                     lmbd_region_corr_weight=1.0, lmbd_not_corr_weight=0.0),
    "PROPOSED_V2": dict(use_symmetrical_loss=True, use_predictor=True, lmbd_coordinate=0.5),
}


def build_step(cli=False, pretrain_type="CP2", config=None, backbone_type="DEEPLABV3"):
    import cp2_tpu_torch
    from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl.train_step import (
        backbone_output_stride_of, dense_output_stride_of, make_optimizer,
        make_pretrain_step)
    from cp2_tpu_torch.types import BackboneType, MappingType, PretrainType

    pt, bt = PretrainType[pretrain_type], BackboneType[backbone_type]
    if config is None:
        name = ("config_moco.py" if pretrain_type in ("MOCO", "BYOL", "DENSECL")
                else "config_pretrain.py")
        config = os.path.join(os.path.dirname(cp2_tpu_torch.__file__), "configs", name)
    model_cfg = dict(Config.fromfile(config).model)
    kw = dict(VARIANT_HP.get(pretrain_type, {}))
    if "mapping_type" in kw:
        kw["mapping_type"] = MappingType[kw["mapping_type"]]
    hp = SSLHyperParams.for_variant(pt, backbone_type=bt, **kw)
    model = SSLEncoder(model_cfg, pretrain_type=pt, backbone_type=bt, dim=hp.dim,
                       dtype=torch.bfloat16, img_hw=(224, 224))
    state = create_pretrain_state(model, make_optimizer("sgd", 1e-3), hp, seed=0)
    strides = (dense_output_stride_of(model_cfg, bt), backbone_output_stride_of(model_cfg, bt))
    if not cli:
        step = make_pretrain_step(hp, *strides, augment_fn=None)
        return state, step, pre_augmented_batch(32, 224, 0, "cuda"), None
    cfg = AugmentConfig(out_hw=(224, 224))

    def augment_fn(generator, raw):
        return pretrain_batch_augment(generator, raw, cfg)

    def make(level):
        return make_pretrain_step(hp, *strides, metrics_level=level,
                                  epoch_scalars=True, augment_fn=augment_fn)

    g = torch.Generator().manual_seed(0)
    raw = {k: torch.randint(0, 256, (32, 256, 256, 3), generator=g, dtype=torch.uint8).cuda()
           for k in ("fg", "bg0", "bg1")}
    return state, make(0), raw, (make(1), augment_fn)


def aspp_branch_times(model):
    """Device ms of each ASPP branch conv on the head's input, via CUDA events."""
    from chip_smoke import cuda_ms
    from cp2_tpu_torch.models.layers import conv2d

    head = model.encoder.decode_head
    nchw = torch.randn(32, 2048, 14, 14, device="cuda", dtype=torch.bfloat16)
    layouts = {"nchw": nchw, "channels_last": nchw.to(memory_format=torch.channels_last)}
    out = {}
    for i in range(head.num_branches):
        conv = getattr(head, f"aspp_{i}").conv
        for layout, x in layouts.items():
            xg = x.detach().clone().requires_grad_()

            def fwd_bwd():
                conv2d(conv, xg, torch.bfloat16).float().sum().backward()

            with torch.no_grad():
                fwd = cuda_ms(lambda: conv2d(conv, x, torch.bfloat16), iters=5, warmup=1)
            both = cuda_ms(fwd_bwd, iters=5, warmup=1)
            out[f"aspp_{i}/{layout}"] = {"kernel": conv.kernel_size[0],
                                         "dilation": conv.dilation[0],
                                         "fwd_ms": fwd, "fwd_bwd_ms": both}
            print(f"aspp_{i}: {conv.kernel_size[0]}x{conv.kernel_size[1]} dilation "
                  f"{conv.dilation[0]:2d} {layout:13s}: forward {fwd:.2f} ms, "
                  f"forward+backward {both:.2f} ms")
    return out


def timed(state, step, batch, n):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return state, times


def cli_breakdown(state, raw, step_quiet, step_logged, augment_fn, n, step_device_ms,
                  layout_experiment=True):
    """The augmentation alone under the profiler, by kernel; the logged
    step's host-clock time; the decode contention; and, for the CP2 step,
    phase 5's step by input layout."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(2):
        augment_fn(gen, raw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            augment_fn(gen, raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    aug_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"augmentation alone, {n} batches: wall {wall_ms:.1f} ms, device {aug_ms:.1f} ms; "
          f"{aug_ms / n:.2f} device ms per batch, {100 * aug_ms / step_device_ms:.1f} % of "
          f"the CLI steps' device time")
    kernels = []
    for e in events[:15]:
        ms = e.self_device_time_total / 1e3
        kernels.append({"kernel": e.key, "device_ms_per_batch": ms / n, "calls": e.count,
                        "share": ms / aug_ms})
        print(f"  {ms / n:8.3f} ms/batch  {100 * ms / aug_ms:5.1f} %  x{e.count // n:<4d} "
              f"{e.key[:100]}")
    state, _ = timed(state, step_logged, raw, 2)  # warm-up
    state, t_logged = timed(state, step_logged, raw, n)
    print(f"logged step (metrics_level 1) ms: {['%.2f' % t for t in t_logged]} "
          f"(median {statistics.median(t_logged):.2f})")

    contention = decode_contention(state, step_quiet, raw, n)
    layouts = {}
    if layout_experiment:
        from cp2_tpu_torch.ssl import model as ssl_model

        step, batch = plain_step()
        explicit = ssl_model._nchw
        for name, swap, net_layout in (
                ("contiguous NHWC", False, explicit),
                ("as augmented, (N, W, H, C) in memory", True, explicit),
                ("contiguous NHWC, the network fed channels-last", False,
                 lambda img: img.permute(0, 3, 1, 2).contiguous(
                     memory_format=torch.channels_last))):
            b = dict(batch)
            if swap:
                for k in ("img_a", "img_b"):
                    b[k] = b[k].transpose(1, 2).contiguous().transpose(1, 2)
            ssl_model._nchw = net_layout
            try:
                state, _ = timed(state, step, b, 3)  # warm-up
                state, t = timed(state, step, b, n)
            finally:
                ssl_model._nchw = explicit
            layouts[name] = t
            print(f"pre-augmented step, images {name}: {['%.2f' % x for x in t]} "
                  f"(median {statistics.median(t):.2f})")
    return {"augment_wall_ms": wall_ms / n, "augment_device_ms": aug_ms / n,
            "augment_kernels": kernels, "logged_step_ms": t_logged,
            "pre_augmented_step_ms_by_layout": layouts, "decode_contention": contention}


def decode_contention(state, step, raw, n):
    """Quiet-step ms while three ``HostDataLoader``s decode PNGs flat out on
    background threads (each batch dropped as soon as it is made), and the
    frames per second they decode, for 4 and 1 decode threads per loader."""
    from chip_smoke import synthetic_frames
    from cp2_tpu_torch.data import HostDataLoader, PretrainDataSource

    work = os.path.join(ROOT, "work_dirs", "profile_pngs")
    files, _ = synthetic_frames(work, 128)
    out = {}
    for workers in (4, 1):
        loaders = [HostDataLoader(PretrainDataSource(files, (256, 256)), 32, seed=seed,
                                  num_workers=workers) for seed in (0, 1024, 2048)]
        stop = threading.Event()
        frames = [0]

        def drain(loader):
            epoch = 0
            while not stop.is_set():
                for batch in loader.epoch_iterator(epoch):
                    frames[0] += len(batch["image"])
                    if stop.is_set():
                        break
                epoch += 1

        threads = [threading.Thread(target=drain, args=(ld,), daemon=True) for ld in loaders]
        for t in threads:
            t.start()
        time.sleep(1.0)  # let the decoders reach their pace
        f0, t0 = frames[0], time.perf_counter()
        state, t = timed(state, step, raw, n)
        rate = (frames[0] - f0) / (time.perf_counter() - t0)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        out[f"{workers}_workers"] = {"step_ms": t, "frames_per_s": rate}
        print(f"quiet CLI step while 3 loaders x {workers} threads decode: "
              f"{['%.2f' % x for x in t]} (median {statistics.median(t):.2f}); they decoded "
              f"{rate:.0f} frames/s (a step takes 96)")
    shutil.rmtree(work, ignore_errors=True)
    return out


def plain_step():
    """Phase 5's step (no augmentation) and its pre-augmented batch."""
    from cp2_tpu_torch.ssl import SSLHyperParams, output_stride_of
    from cp2_tpu_torch.ssl.train_step import make_pretrain_step
    from cp2_tpu_torch.types import PretrainType
    import cp2_tpu_torch
    from cp2_tpu_torch.config import Config

    cfg = Config.fromfile(os.path.join(os.path.dirname(cp2_tpu_torch.__file__),
                                       "configs", "config_pretrain.py"))
    step = make_pretrain_step(SSLHyperParams.for_variant(PretrainType.CP2),
                              output_stride_of(dict(cfg.model)), augment_fn=None)
    return step, pre_augmented_batch(32, 224, 0, "cuda")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--cli", action="store_true",
                        help="profile the pretrain CLI's quiet step on raw frames")
    parser.add_argument("--pretrain_type", default="CP2",
                        choices=["CP2", "PROPOSED", "MOCO", "BYOL", "DENSECL", "PROPOSED_V2"])
    parser.add_argument("--config", default=None, help="model config file (see above)")
    parser.add_argument("--backbone_type", default="DEEPLABV3",
                        choices=["DEEPLABV3", "UNET_ENCODER_ONLY", "UNET_TRUNCATED"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    card = gpu_line()
    print(f"device: {card}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    state, step, batch, cli = build_step(args.cli, args.pretrain_type, args.config,
                                         args.backbone_type)
    flagship = args.pretrain_type == "CP2" and args.backbone_type == "DEEPLABV3"
    tag = ("cli_" if args.cli else "") + ("" if flagship and args.config is None else
                                          f"{args.pretrain_type}_{args.backbone_type}_")

    state, _ = timed(state, step, batch, 3)  # warm-up
    state, t_default = timed(state, step, batch, args.steps)
    print(f"step ms, cudnn.benchmark off: {['%.2f' % t for t in t_default]} "
          f"(median {statistics.median(t_default):.2f})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = timed(state, step, batch, args.steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"profiled {args.steps} steps: wall {wall_ms:.1f} ms, device busy "
          f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f} % of the window)")
    rows = []
    for e in events[:25]:
        ms = e.self_device_time_total / 1e3
        rows.append({"kernel": e.key, "device_ms": ms, "calls": e.count,
                     "share": ms / device_ms})
        print(f"  {ms:9.2f} ms  {100 * ms / device_ms:5.1f} %  x{e.count:<5d} {e.key[:110]}")
    dense = [e for e in events  # csrc/dense_loss.cu's kernels
             if "namespace)::fwd_kernel<" in e.key or "namespace)::bwd_kernel<" in e.key]
    dense_ms = sum(e.self_device_time_total for e in dense) / 1e3
    print(f"dense pair-loss kernels: {dense_ms:.3f} ms over {args.steps} steps "
          f"({100 * dense_ms / device_ms:.2f} % of device time)")
    prof.export_chrome_trace(os.path.join(out_dir, f"torch_{tag}step_trace.json"))
    if cli is not None:
        summary = cli_breakdown(state, batch, step, *cli, args.steps, device_ms,
                                layout_experiment=flagship)
        summary.update({"card": card, "steps": args.steps, "step_ms_default": t_default,
                        "profiled_wall_ms": wall_ms, "device_busy_ms": device_ms,
                        "dense_loss_ms": dense_ms, "top_kernels": rows,
                        "pretrain_type": args.pretrain_type})
        with open(os.path.join(out_dir, f"torch_{tag}step_profile.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return 0

    torch.backends.cudnn.benchmark = True
    state, _ = timed(state, step, batch, 3)  # cuDNN measures its algorithms here
    state, t_bench = timed(state, step, batch, args.steps)
    print(f"step ms, cudnn.benchmark on: {['%.2f' % t for t in t_bench]} "
          f"(median {statistics.median(t_bench):.2f})")

    torch.backends.cudnn.benchmark = False
    branches = aspp_branch_times(state.model) if flagship else None

    summary = {"card": card, "steps": args.steps, "step_ms_default": t_default,
               "step_ms_cudnn_benchmark": t_bench, "profiled_wall_ms": wall_ms,
               "device_busy_ms": device_ms, "dense_loss_ms": dense_ms,
               "top_kernels": rows, "aspp_branches": branches,
               "pretrain_type": args.pretrain_type}
    with open(os.path.join(out_dir, f"torch_{tag}step_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

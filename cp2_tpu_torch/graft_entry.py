"""Driver entry points: the flagship forward, and a small run of the CP2
step in more than one process.

Twin of ``__graft_entry__.py``:

* ``entry(device="cuda")`` returns ``(fn, args)``: ``fn(*args)`` is the
  flagship ``SSLEncoder.dense`` (CP2: dilated ResNet-50 + ASPP contrast
  head, ``config_pretrain.py``) in eval mode at bfloat16 with zero
  weights, on a (2, 224, 224, 3) float32 input, on the card or on the
  device the caller names (``"meta"`` gives shapes alone).
* ``dryrun_multichip(n, device="cuda")`` runs the full CP2 step
  (on-device augmentation, both encoders forward and backward, SGD, EMA
  and queue updates) on tiny shapes (a ResNet-18 at width 8, batch 2n at
  32², a queue of 64) in ``n`` processes over gloo, started with
  ``torchrun``'s environment, the global batch sharded by rank; each
  checks a finite loss and step 1, and rank 0 writes a checkpoint through
  ``checkpoint/io.py`` (under ``GRAFT_DRYRUN_CKPT_DIR`` when it is set,
  else in a temporary directory removed after).  On the card rank r runs
  on card r modulo the cards present; gloo, since NCCL refuses two ranks
  on one card.  ``device="cpu"`` runs the ranks on the CPU, as the JAX
  function runs its leg on virtual CPU devices.

    python -m cp2_tpu_torch.graft_entry     # dryrun_multichip(GRAFT_DRYRUN_DEVICES=8) on the card

It prints each rank's lines, one ``LAUNCHES`` line with the dense-loss
kernels' launches summed over the ranks beside the steps they ran, and
last one JSON line.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flagship_model(dtype: torch.dtype):
    from cp2_tpu_torch.ssl import SSLEncoder
    from cp2_tpu_torch.types import BackboneType, PretrainType
    from cp2_tpu_torch.utils.benchmarking import model_config

    model_cfg = model_config("config_pretrain.py")
    return SSLEncoder(model_cfg, pretrain_type=PretrainType.CP2,
                      backbone_type=BackboneType.DEEPLABV3, dim=128, dtype=dtype), model_cfg


def entry(device="cuda"):
    """``(fn, (model, x))`` of the flagship forward step on ``device``."""
    from cp2_tpu_torch.parallel import resolve_device

    device = resolve_device(device)
    with torch.device(device):
        model, _ = _flagship_model(torch.bfloat16)
    if device.type != "meta":
        with torch.no_grad():
            for t in model.state_dict().values():
                t.zero_()
    model.eval()
    x = torch.zeros((2, 224, 224, 3), dtype=torch.float32, device=device)

    def fn(model, x):
        with torch.no_grad():
            return model.dense(x)

    return fn, (model, x)


def _tiny_model_cfg(dim: int = 16) -> dict:
    return dict(
        type="EncoderDecoder",
        backbone=dict(type="ResNet", depth=18, stem_channels=8, base_channels=8,
                      num_stages=4, out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 2),
                      strides=(1, 2, 2, 1), norm_cfg=dict(type="BN"), contract_dilation=True),
        decode_head=dict(type="ASPPHead", in_channels=64, in_index=3, channels=16,
                         contrast=True, contrast_dim=dim, dilations=(1, 6), num_classes=2,
                         norm_cfg=dict(type="BN")),
    )


def _dryrun_body(ckpt_dir: str, device: str) -> float:
    """The tiny CP2 step in this process on ``device``, one rank of the
    group that ``torchrun``'s environment describes; prints its line and
    its ``LAUNCHES`` line and returns the loss."""
    import numpy as np

    from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
    from cp2_tpu_torch.checkpoint import save_checkpoint
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.parallel import barrier, current_layout, initialize, resolve_device
    from cp2_tpu_torch.ssl import SSLEncoder, SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl import output_stride_of
    from cp2_tpu_torch.ssl.train_step import (
        backbone_output_stride_of, make_optimizer, make_pretrain_step)
    from cp2_tpu_torch.types import BackboneType, PretrainType
    from cp2_tpu_torch.utils.benchmarking import Counted, print_launches

    device = resolve_device(device)
    if not initialize(backend="gloo", device=device):
        raise RuntimeError("dryrun rank: no torchrun environment to join")
    layout = current_layout(device)
    n = layout.world
    hw, batch, dim = 32, 2 * n, 16
    model_cfg = _tiny_model_cfg(dim)
    hp = SSLHyperParams.for_variant(PretrainType.CP2, dim=dim, queue_len=64)
    state = create_pretrain_state(SSLEncoder(model_cfg, dim=dim), make_optimizer("sgd", 0.05),
                                  hp, seed=0, device=device)
    aug_cfg = AugmentConfig(out_hw=(hw, hw))
    step = Counted(make_pretrain_step(
        hp, output_stride_of(model_cfg),
        backbone_output_stride_of(model_cfg, BackboneType.DEEPLABV3), metrics_level=1,
        augment_fn=lambda gen, raw: pretrain_batch_augment(gen, raw, aug_cfg)))
    r = np.random.RandomState(0)
    raw = {k: (r.rand(batch, hw + 16, hw + 16, 3) * 255).astype(np.uint8)
           for k in ("fg", "bg0", "bg1")}
    # this process's rows of the global batch
    local = {k: torch.from_numpy(v[layout.rank * 2:(layout.rank + 1) * 2]).to(device)
             for k, v in raw.items()}
    dense_loss.reset_launch_counts()
    state, metrics = step(state, local, 1)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"dryrun rank {layout.rank}: loss {loss}, step {state.step}")
    if layout.is_main:
        save_checkpoint(ckpt_dir, 1, state, meta={"dryrun": True, "n_processes": n})
    barrier()
    print_launches(step.calls)
    print(f"dryrun_multichip({n}) OK: loss={loss:.4f} rank={layout.rank} device={device} "
          f"ckpt={os.path.join(ckpt_dir, '1')}", flush=True)
    return loss


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 900.0) -> dict:
    """The tiny CP2 step in ``n_devices`` gloo processes (one rank each,
    started with ``torchrun``'s environment) on the card, or on the CPU with
    ``device="cpu"``; raises unless every rank reports a finite loss and
    rank 0's checkpoint is there.  Prints the ``LAUNCHES`` line summed over
    the ranks; returns the run's JSON dict."""
    import json
    import socket

    from cp2_tpu_torch.parallel import resolve_device
    from cp2_tpu_torch.utils.benchmarking import LAUNCH_TAG, card_line

    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    keep = os.environ.get("GRAFT_DRYRUN_CKPT_DIR")
    ckpt_dir = keep or tempfile.mkdtemp(prefix="cp2_dryrun_ckpt_")
    procs = []
    try:
        for rank in range(n_devices):
            rank_device = f"cuda:{rank % cards}" if cards else "cpu"
            env = dict(os.environ, WORLD_SIZE=str(n_devices), RANK=str(rank),
                       LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1")
            code = ("from cp2_tpu_torch.graft_entry import _dryrun_rank; "
                    f"_dryrun_rank({ckpt_dir!r}, {rank_device!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        outputs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outputs.append(out.decode(errors="replace"))
        losses, launches = [], {}
        for rank, p in enumerate(procs):
            ok = [line for line in outputs[rank].splitlines() if "OK: loss=" in line]
            counts = [json.loads(line.split(" ", 1)[1]) for line in outputs[rank].splitlines()
                      if line.startswith(LAUNCH_TAG + " ")]
            if p.returncode != 0 or len(ok) != 1 or len(counts) != 1:
                raise RuntimeError(f"dryrun rank {rank} failed (rc={p.returncode}):\n"
                                   f"{outputs[rank][-4000:]}")
            print(ok[0], flush=True)
            losses.append(float(ok[0].split("loss=", 1)[1].split()[0]))
            for k, v in counts[0].items():
                launches[k] = launches.get(k, 0) + v
        if not os.path.isdir(os.path.join(ckpt_dir, "1")):
            raise RuntimeError(f"dryrun: no checkpoint written under {ckpt_dir}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if not keep:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"{LAUNCH_TAG} {json.dumps(launches)}", flush=True)
    print(f"dryrun_multichip({n_devices}) OK ({n_devices} gloo processes on {device.type}, "
          "rank 0's checkpoint written)", flush=True)
    return {"metric": "dryrun_multichip", "n_processes": n_devices, "losses": losses,
            "device": card_line(device)}


def _dryrun_rank(ckpt_dir: str, device: str) -> None:
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False  # its channels-last conv backward, tiny nets
    _dryrun_body(ckpt_dir, device)


if __name__ == "__main__":
    import json

    print(json.dumps(dryrun_multichip(int(os.environ.get("GRAFT_DRYRUN_DEVICES", "8")))),
          flush=True)

"""CP2 pretraining, driven as ``cp2_tpu_torch/train/pretrain.py::_train``
drives it: the CLI's own flags and hyperparameters, the state of
``ssl/state.py``, ``make_pretrain_step`` with
``augment.pretrain_batch_augment`` as its ``augment_fn``, per-epoch cosine
rate, the quiet step with the epoch scalars on every step and the metrics
step on the first of each ``--scalar-freq`` steps, the loss read every
``--print-freq`` steps and the epoch's sums read at its end.  Figures and
checkpoints are left out (``--visual-freq 0``, no ``--ckpt-freq`` epoch
is reached).

The weights and the queue come from the seed on the device
(``bmk/weights.py``) instead of ``create_pretrain_state``'s CPU init.
"""

from __future__ import annotations

import copy
import time

import torch

from bmk import counts, faults, weights
from bmk.checks import host, host_copy, moment
from bmk.feeds import Feed
from bmk.loop import Loop
from reference import cp2_pretrain as ref
from reference import nets

STREAM_OFFSETS = {"fg": 0, "bg0": 1024, "bg1": 2048}  # the CLI's three loader seeds
CHECK_STEPS = 3


class Runner(Loop):
    def __init__(self, cell, spans, pairs):
        from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
        from cp2_tpu_torch.ssl import SSLEncoder
        from cp2_tpu_torch.ssl.state import PretrainState
        from cp2_tpu_torch.ssl.train_step import (backbone_output_stride_of,
                                                  cosine_lr_schedule, dense_output_stride_of,
                                                  make_optimizer, make_pretrain_step)
        from cp2_tpu_torch.train.pretrain import get_args, hparams_from_args

        cfg = self.cfg = cell.config
        self.cell, self.span = cell, spans
        self.device = torch.device(cell.device)
        self.seed = cell.program_seed
        n = len(pairs)
        args = self.args = get_args(["--run_id", "bench", "--log_dir", cell.scratch,
                                     "--data_dirs", cell.scratch, "--seed", str(self.seed),
                                     "--visual-freq", "0", *cfg["cli"]])
        hp = hparams_from_args(args, dataset_size=n)
        if hp.queue_len != cfg["objective"]["queue_len"]:
            raise ValueError(f"queue {hp.queue_len} != the configuration's "
                             f"{cfg['objective']['queue_len']}")
        self.hw = (args.img_height, args.img_width)
        base_hw = (args.img_height + 32, args.img_width + 32)
        self.batch = args.batch_size
        self.feed = Feed(cell.traffic, {k: self.seed + v for k, v in STREAM_OFFSETS.items()},
                         pairs, self.batch, self.device, spans, base_hw=base_hw)
        self.spec = nets.param_spec(cfg["model"], "encoder.")
        self.names = nets.trainable(self.spec)

        with torch.device(self.device):
            model = SSLEncoder(cfg["model"], pretrain_type=args.pretrain_type,
                               backbone_type=args.backbone_type, dim=hp.dim,
                               unet_truncated_dec_blocks=hp.unet_truncated_dec_blocks,
                               dtype=torch.bfloat16 if args.bf16 else torch.float32,
                               img_hw=self.hw)
        model.load_state_dict(weights.make(self.spec, self.seed, self.device,
                                         cfg["init"]["branch_bn_scale"]))
        model.train()
        ema = copy.deepcopy(model).requires_grad_(False)
        queue = weights.queue(hp.queue_len, hp.dim, self.seed, self.device)
        tx = make_optimizer(args.optim, args.lr, momentum=args.momentum,
                            weight_decay=args.weight_decay)
        self.state = PretrainState(step=0, model=model, ema_model=ema,
                                   optimizer=tx(model.parameters()), queue=queue,
                                   queue_ptr=0, queue2=queue.clone(), queue2_ptr=0)
        if cell.fault == "frozen":  # planted faults (bmk/faults.py)
            self.state.optimizer.step = lambda *a, **k: None
        elif cell.fault == "ema_skipped":
            self.state.ema_update = lambda momentum: None
        elif cell.fault == "conv_roll":
            faults.roll_conv(model)
            faults.roll_conv(ema)
        aug_cfg = AugmentConfig(out_hw=self.hw,
                                erase_scale=(args.foreground_min, args.foreground_max),
                                pixel_ids_stride=hp.pixel_ids_stride)
        half = cell.fault == "half_batch"

        def augment_fn(generator, raw):
            with spans("augment"):
                out = pretrain_batch_augment(generator, raw, aug_cfg)
            if half:  # a planted fault: half of the batch left out
                out = {k: v[: v.shape[0] // 2] for k, v in out.items()}
            return out

        os_ = dense_output_stride_of(cfg["model"], args.backbone_type,
                                     hp.unet_truncated_dec_blocks)
        bos = backbone_output_stride_of(cfg["model"], args.backbone_type,
                                        hp.unet_truncated_dec_blocks)
        self.step_quiet, self.step_metrics = (
            make_pretrain_step(hp, os_, backbone_output_stride=bos, metrics_level=level,
                               epoch_scalars=args.metrics_level > 0, augment_fn=augment_fn)
            for level in (0, args.metrics_level))
        self.schedule = cosine_lr_schedule(args.lr, args.epochs, self.feed.steps_per_epoch)
        self.steps, self.epoch_sum = 0, None
        self.capture = {"loss": [], "raw": []}

    # -- the loop ------------------------------------------------------------
    def run_epoch(self, epoch: int, stop_at=None) -> bool:
        """One epoch of the CLI's loop; stops after the step that passes
        ``stop_at`` (then False)."""
        from cp2_tpu_torch.parallel import pmean_metrics, psum_metrics

        args, state = self.args, self.state
        it = self.feed.epoch(epoch)
        try:
            for i, batch in enumerate(it):
                checking = epoch == 0 and i < CHECK_STEPS
                if checking and i == 0:
                    self.capture["p0"] = host(state.model.named_parameters())
                for group in state.optimizer.param_groups:
                    group["lr"] = float(self.schedule(state.step))
                run = self.step_metrics if i % args.scalar_freq == 0 else self.step_quiet
                with self.span("step"):
                    state, metrics = run(state, batch, self.seed)
                if args.metrics_level > 0:
                    vec = metrics["_epoch_vec"].double()
                    self.epoch_sum = vec if self.epoch_sum is None else self.epoch_sum + vec
                if i % args.print_freq == 0:
                    with self.span("sync"):
                        float(pmean_metrics({"loss": metrics["loss"]})["loss"])
                self.steps += 1
                if checking:
                    self._capture(i, batch, metrics)
                if stop_at is not None and time.perf_counter() >= stop_at:
                    return False
        finally:
            it.close()
        if self.epoch_sum is not None:
            with self.span("sync"):
                psum_metrics({"v": self.epoch_sum})["v"].cpu()
            self.epoch_sum = None
        return True

    def _capture(self, i, batch, metrics):
        """The check's readings of the set-up's first steps."""
        cap, opt = self.capture, self.state.optimizer
        cap["loss"].append(metrics["loss"].detach())
        if self.feed.kind == "files":
            cap["raw"].append({k: host_copy(v) for k, v in batch.items()})
        if i == 0:
            wd = self.args.weight_decay
            cap["grad0"] = {k: moment(opt, p, "momentum_buffer") - wd * cap["p0"][k]
                            for k, p in self.state.model.named_parameters()}
        if i == CHECK_STEPS - 1:
            cap["params"] = host(self.state.model.named_parameters())
            cap["ema"] = host(self.state.ema_model.named_parameters())
            cap["loss"] = [float(v) for v in cap["loss"]]

    def free(self):
        del self.state, self.step_quiet, self.step_metrics
        self.feed.dev = None

    # -- the check -----------------------------------------------------------
    def reference_side(self, prec: nets.Precision) -> dict:
        from bmk import checks
        from reference import data

        cfg, dev, feed = self.cfg, self.device, self.feed
        p0 = weights.make(self.spec, self.seed, dev, cfg["init"]["branch_bn_scale"])
        queue0 = weights.queue(cfg["objective"]["queue_len"], cfg["objective"]["dim"],
                               self.seed, dev)
        self.loader_diff = 0.0

        def raw_of(i):
            rows = feed.reference_rows(0, i)
            if feed.kind == "resident":
                frames = {k: feed.host["frames"][r] for k, r in rows.items()}
            else:
                frames = {k: data.decode_frames([feed.pairs[j][0] for j in r], feed.base_hw)
                          for k, r in rows.items()}
                if self.capture["raw"]:
                    got = self.capture["raw"][i]
                    self.loader_diff = max(self.loader_diff, *(
                        checks.max_diff(got[k], v) for k, v in frames.items()))
            return {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}

        lr = float(self.schedule(0))
        out = ref.run(p0, queue0, raw_of, self.seed, [lr] * CHECK_STEPS, cfg["model"],
                      cfg["objective"], cfg["augment"], cfg["optimizer"], self.names, prec,
                      steps=CHECK_STEPS)
        return checks.side(out["loss"], out["grad0"], out["params"], p0, ema=out["ema"])

    def counts(self, peak) -> dict:
        return step_counts(self.cfg, self.batch, self.hw, 2 if self.args.bf16 else 4, peak)


def step_counts(cfg: dict, batch: int, hw, bytes_per_element: int, peak) -> dict:
    """FLOPs of one step and the least times of its convolutions and of its
    dense loss, from the reference's step on the meta device."""
    (h, w), obj = hw, cfg["objective"]
    spec = nets.param_spec(cfg["model"], "encoder.")
    names = nets.trainable(spec)
    with torch.device("meta"):
        params = {n: torch.empty(s, requires_grad=n in names) for n, s, _ in spec}
        images = {k: torch.empty(batch, h, w, 3) for k in ("img_a", "img_b", "bg0", "bg1")}
        queue = torch.empty(obj["queue_len"], obj["dim"])

    def step():
        loss, _ = ref.objective(params, params, images, queue, obj, cfg["model"], nets.FP32)
        torch.autograd.grad(loss, [params[k] for k in names])

    flops, ledger = counts.count(step, bytes_per_element)
    out = {"flops_per_step": flops}
    if peak:
        s2 = (h // obj["output_stride"]) * (w // obj["output_stride"])
        out["conv_bound_s"] = ledger.bound_s(peak)
        out["dense_loss_bound_s"] = counts.dense_loss_bound_s(batch, s2, obj["dim"], peak)
    return out

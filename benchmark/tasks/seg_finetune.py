"""DeepLabV3 finetuning, driven as ``cp2_tpu_torch/train/finetune.py``'s
epoch loop drives it: the CLI's own flags, ``build_segmentor`` at the
configuration's dtype, Adam from ``make_adam``, and per batch
``finetune_augment_batch`` then ``make_seg_steps``' train step, each with
the CLI's generator streams; at each epoch's end the train metrics are
summed and read.  Validation, overlays and checkpoints are left out.

The weights come from the seed on the device (``bmk/weights.py``), where
the CLI would load a pretrained checkpoint.
"""

from __future__ import annotations

import time

import torch

from bmk import counts, faults, weights
from bmk.checks import host, host_copy, moment
from bmk.feeds import Feed
from bmk.loop import Loop
from reference import nets
from reference import seg_finetune as ref

CHECK_STEPS = 3


class Runner(Loop):
    def __init__(self, cell, spans, pairs):
        from cp2_tpu_torch.augment import FinetuneAugmentConfig, finetune_augment_batch
        from cp2_tpu_torch.models import build_segmentor
        from cp2_tpu_torch.ssl.train_step import step_generator
        from cp2_tpu_torch.train import finetune as cli
        from cp2_tpu_torch.train.segmentation_task import create_seg_state, make_adam, make_seg_steps

        cfg = self.cfg = cell.config
        self.cell, self.span = cell, spans
        self.device = torch.device(cell.device)
        self.seed = cell.program_seed
        args = self.args = cli.get_args(["--run_id", "bench", "--log_dir", cell.scratch,
                                         "--img_dirs", cell.scratch, "--mask_dirs",
                                         cell.scratch, "--seed", str(self.seed), *cfg["cli"]])
        self.hw = (args.img_height, args.img_width)
        self.batch = args.batch_size
        train = pairs[: cell.traffic["corpus"]["train"]]
        self.feed = Feed(cell.traffic, {"image": self.seed}, train, self.batch, self.device,
                         spans, crop=args.img_height)
        model_cfg = dict(cfg["model"])
        model_cfg["decode_head"] = dict(model_cfg["decode_head"], num_classes=args.num_classes)
        model_cfg["dtype"] = torch.bfloat16 if args.bf16 else torch.float32
        self.spec = nets.param_spec(cfg["model"])
        self.names = nets.trainable(self.spec)
        with torch.device(self.device):
            model = build_segmentor(model_cfg)
        model.load_state_dict(weights.make(self.spec, self.seed, self.device,
                                         cfg["init"]["branch_bn_scale"]))
        self.train_step, _, self.metrics_of = make_seg_steps(args.num_classes, self.hw)
        self.state = create_seg_state(model, make_adam(args.learning_rate, args.weight_decay),
                                      self.device)
        if cell.fault == "frozen":  # planted faults (bmk/faults.py)
            self.state.optimizer.step = lambda *a, **k: None
        elif cell.fault == "conv_roll":
            faults.roll_conv(model)
        aug_cfg = FinetuneAugmentConfig()
        half = cell.fault == "half_batch"

        def augment(step, images, masks):
            with spans("augment"):
                gen = step_generator(self.seed, step, self.device, stream=cli.AUG_STREAM)
                images, masks = finetune_augment_batch(gen, images, masks, aug_cfg)
            if half:  # a planted fault: half of the batch left out
                images, masks = images[: images.shape[0] // 2], masks[: masks.shape[0] // 2]
            return images, masks

        self.augment = augment
        self.dropout_gen = lambda step: step_generator(self.seed, step, self.device,
                                                       stream=cli.DROPOUT_STREAM)
        self.steps = 0
        self.capture = {"loss": [], "raw": []}

    def run_epoch(self, epoch: int, stop_at=None) -> bool:
        from cp2_tpu_torch.ops.metrics import ConfusionState
        from cp2_tpu_torch.parallel import psum_metrics

        args = self.args
        confusion = ConfusionState.create(args.num_classes, self.device)
        it, m = self.feed.epoch(epoch), None
        try:
            for i, batch in enumerate(it):
                checking = epoch == 0 and i < CHECK_STEPS
                state = self.state
                if checking and i == 0:
                    self.capture["p0"] = host(state.model.named_parameters())
                with self.span("step"):
                    images, masks = self.augment(state.step, batch["image"], batch["mask"])
                    self.state, confusion, m = self.train_step(
                        state, {"image": images, "mask": masks}, self.dropout_gen(state.step),
                        confusion)
                self.steps += 1
                if checking:
                    self._capture(i, batch, m)
                if stop_at is not None and time.perf_counter() >= stop_at:
                    return False
        finally:
            it.close()
        if m is not None:
            with self.span("sync"):
                tot = psum_metrics({"counts": confusion.matrix, "loss": m["loss"]})
                {k: float(v) for k, v in self.metrics_of(
                    ConfusionState(matrix=tot["counts"]), "train_").items()}
                float(tot["loss"])
        return True

    def _capture(self, i, batch, m):
        cap, opt = self.capture, self.state.optimizer
        cap["loss"].append(m["loss"].detach())
        if self.feed.kind == "files":
            cap["raw"].append({k: host_copy(batch[k]) for k in ("image", "mask")})
        if i == 0:
            b1, wd = opt.param_groups[0]["betas"][0], self.args.weight_decay
            cap["grad0"] = {k: moment(opt, p, "exp_avg") / (1.0 - b1) - wd * cap["p0"][k]
                            for k, p in self.state.model.named_parameters()}
        if i == CHECK_STEPS - 1:
            cap["params"] = host(self.state.model.named_parameters())
            cap["loss"] = [float(v) for v in cap["loss"]]

    def free(self):
        del self.state, self.train_step
        self.feed.dev = None

    def reference_side(self, prec: nets.Precision) -> dict:
        from bmk import checks
        from reference import data

        cfg, dev, feed = self.cfg, self.device, self.feed
        p0 = weights.make(self.spec, self.seed, dev, cfg["init"]["branch_bn_scale"])
        self.loader_diff = 0.0

        def raw_of(i):
            rows = feed.reference_rows(0, i)["image"]
            if feed.kind == "resident":
                img, mask = feed.host["image"][rows], feed.host["mask"][rows]
            else:
                img, mask = data.crop_pairs(feed.pairs, rows, self.hw[0], self.seed, 0)
                if self.capture["raw"]:
                    got = self.capture["raw"][i]
                    self.loader_diff = max(self.loader_diff, checks.max_diff(got["image"], img),
                                           checks.max_diff(got["mask"], mask))
            return torch.from_numpy(img).to(dev), torch.from_numpy(mask).to(dev)

        opt = dict(cfg["optimizer"], feature_hw=self._feature_hw())
        out = ref.run(p0, raw_of, self.seed, cfg["model"], cfg["augment"], opt, self.names,
                      prec, steps=CHECK_STEPS)
        return checks.side(out["loss"], out["grad0"], out["params"], p0)

    def _feature_hw(self):
        stride = self.cfg["objective"]["output_stride"]
        return (-(-self.hw[0] // stride), -(-self.hw[1] // stride))

    def counts(self, peak) -> dict:
        return step_counts(self.cfg, self.batch, self.hw, 2 if self.args.bf16 else 4, peak)


def step_counts(cfg: dict, batch: int, hw, bytes_per_element: int, peak) -> dict:
    """FLOPs of one step and the least time of its convolutions, from the
    reference's step on the meta device."""
    (h, w), head = hw, cfg["model"]["decode_head"]
    stride = cfg["objective"]["output_stride"]
    spec = nets.param_spec(cfg["model"])
    names = nets.trainable(spec)
    with torch.device("meta"):
        params = {n: torch.empty(s, requires_grad=n in names) for n, s, _ in spec}
        images = torch.empty(batch, h, w, 3)
        masks = torch.empty(batch, h, w, dtype=torch.int64)
        keep = torch.empty(batch, head["channels"], -(-h // stride), -(-w // stride),
                           dtype=torch.bool)

    def step():
        loss = ref.loss_of(params, cfg["model"], images, masks, keep,
                           1.0 - head["dropout_ratio"], nets.FP32)
        torch.autograd.grad(loss, [params[k] for k in names])

    flops, ledger = counts.count(step, bytes_per_element)
    out = {"flops_per_step": flops}
    if peak:
        out["conv_bound_s"] = ledger.bound_s(peak)
    return out

"""Observability: meters, loggers, and a pluggable metric sink.

A copy of ``cp2_tpu/utils/logging.py`` with the same JSONL and wandb keys;
``collect_env`` reports torch, CUDA and the card instead of JAX.

Covers the reference's three channels (SURVEY §5): wandb scalar families,
python logging with per-process files (main.py:292-312), and
AverageMeter/ProgressMeter console meters (builder.py:51-73,
main.py:673-690).  wandb is optional here — when the package is absent
(or offline), metrics stream to a JSONL file with identical keys so
curves stay comparable.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


class AverageMeter:
    """Running value/average meter."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**vars(self))


class ProgressMeter:
    def __init__(self, num_batches: int, meters, logger, prefix: str = ""):
        digits = len(str(num_batches))
        self._fmt = "[{:" + str(digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix
        self.logger = logger

    def display(self, batch: int):
        entries = [self.prefix + self._fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        self.logger.info("    ".join(entries))


def setup_logger(name: str, log_dir: Optional[str] = None, *, to_console: bool = True):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    formatter = logging.Formatter(
        "%(asctime)s,%(msecs)03d %(levelname)-8s "
        "[%(filename)s:%(funcName)s:%(lineno)d] %(message)s"
    )
    if to_console:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"log-{name}.txt"))
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def collect_env() -> Dict[str, str]:
    """Environment report (mmseg_/utils/collect_env.py parity): Python,
    torch, CUDA and the cards."""
    import platform
    import sys

    import torch

    info = {
        "sys.platform": sys.platform,
        "Python": sys.version.replace("\n", ""),
        "machine": platform.machine(),
        "torch": torch.__version__,
        "torch.version.cuda": str(torch.version.cuda),
        "cuda.is_available": str(torch.cuda.is_available()),
    }
    if torch.cuda.is_available():
        info["cuda.devices"] = ", ".join(
            torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count()))
    return info


class MetricLogger:
    """Scalar sink: JSONL always, wandb when available and requested.

    Keys match the reference's wandb names (train/loss_step,
    step/instance_*, …) so dashboards/curve comparisons carry over.
    """

    def __init__(
        self,
        log_dir: str,
        run_id: str,
        *,
        use_wandb: bool = False,
        wandb_project: str = "ssl-pretraining",
        wandb_team: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        tags=(),
        offline: bool = False,
    ):
        self.run_dir = os.path.join(os.path.abspath(os.path.expanduser(log_dir)), run_id)
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        self._step = 0
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb
                wandb.init(
                    name=run_id,
                    project=wandb_project,
                    entity=wandb_team,
                    dir=log_dir,
                    tags=list(tags),
                    mode="offline" if offline else "online",
                )
                if config:
                    wandb.config.update(config)
            except Exception:
                self._wandb = None
        if config:
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                json.dump(config, f, default=str, indent=2)
        self.define_summary_metrics()

    # the reference configures wandb summary behavior for every score-stat
    # family (builder.py:499-541, summary='last' per key) so run tables
    # show the final value instead of wandb's default aggregate
    _SUMMARY_LAST_FAMILIES = tuple(
        f"{scope}{family}_{side}_scores"
        for scope in ("step/", "")
        for family in (
            "dense_per_sample_average", "dense_per_sample_lower",
            "dense_per_sample_median", "dense_per_sample_upper",
            "instance_average", "instance_lower",
            "instance_median", "instance_upper",
        )
        for side in ("positive", "negative")
        # instance-* families only exist for the negative side except avg
        if not (family.startswith("instance_")
                and side == "positive"
                and family != "instance_average")
    )

    def define_summary_metrics(self):
        """wandb ``define_metric(key, summary='last')`` for the reference's
        scalar families (no-op without wandb; JSONL keeps every row)."""
        if self._wandb is None:
            return
        for key in self._SUMMARY_LAST_FAMILIES:
            try:
                self._wandb.define_metric(key, summary="last")
            except Exception:
                return

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        step = self._step if step is None else step
        self._step = step + 1
        row = {"_step": step, "_time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, images: Dict[str, Any], step: Optional[int] = None):
        """Log image artifacts: PNG paths (or lists of paths) per key.

        Paths are recorded in the JSONL row; under wandb they are uploaded
        as wandb.Image (the reference's image-artifact channel,
        builder.py:1450-1549, finetune.py:130-139).
        """
        step = self._step if step is None else step
        row = {"_step": step, "_time": time.time()}
        for k, v in images.items():
            paths = v if isinstance(v, (list, tuple)) else [v]
            row[k] = [str(p) for p in paths]
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            payload = {}
            for k, v in images.items():
                paths = v if isinstance(v, (list, tuple)) else [v]
                payload[k] = [self._wandb.Image(str(p)) for p in paths]
            self._wandb.log(payload, step=step)

    def close(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullSink:
    """A ``MetricLogger`` that keeps nothing: the sink of every rank but
    rank 0 in a run of more than one process."""

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        del metrics, step

    def log_images(self, images: Dict[str, Any], step: Optional[int] = None):
        del images, step

    def close(self):
        pass

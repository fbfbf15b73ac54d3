"""Tiny cells for the CPU tests: the benchmark's own cells with narrow
widths, few frames and small images, so that a whole run (set-up, window,
check) takes seconds on the CPU."""

from __future__ import annotations

import copy

from bmk import spec

CORPUS = {"frames": 16, "hw": [48, 64], "train": 14, "seed": 0}


def narrow(model: dict, contrast: bool) -> dict:
    m = copy.deepcopy(model)
    m["backbone"].update(base_channels=4, stem_channels=8)
    head = m["decode_head"]
    head.update(in_channels=128, channels=8)
    return m


def cell(name: str, root: str, seconds: float = 0.5, trace: bool = False, **kw) -> spec.Cell:
    """``name`` as the benchmark has it, cut to a size a test can run, on
    the CPU; its corpus and trace go under ``root``."""
    c = spec.Cell.load(name, seed=kw.pop("seed", 1234), seconds=seconds, trace=trace,
                       device="cpu", cache=root, **kw)
    c.config = copy.deepcopy(c.config)
    c.traffic = dict(c.traffic, corpus=dict(CORPUS), num_workers=2)
    if c.config["task"] == "cp2_pretrain":
        c.config["cli"] = c.config["cli"] + ["-b", "4", "--img_height", "32", "--img_width", "32"]
        c.config["objective"]["queue_len"] = CORPUS["frames"]
        c.config["augment"]["out_hw"] = [32, 32]
    else:
        c.config["cli"] = c.config["cli"] + ["--batch_size", "4", "--img_height", "32",
                                             "--img_width", "32"]
    c.config["model"] = narrow(c.config["model"], c.config["task"] == "cp2_pretrain")
    return c

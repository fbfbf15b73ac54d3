"""Readings for the limits of the check, on the chip, in one process.

For each seed it reads the check's numbers (``bmk/checks.py``) of one
side against the float32 reference, the side being:

* ``program``: the program as the cell runs it (its set-up's first steps);
* ``program_fp32``: the program with ``--no-bf16``;
* ``control``: the reference itself in the precision below the
  configuration's (float8 e4m3 operands, ``reference/nets.py``);
* ``half_batch``, ``frozen``, ``conv_roll``, ``ema_skipped``: the program
  with that fault planted (``bmk/faults.py``);
* ``reference_fp64``: the reference in float64 (the float32 reference's
  own rounding).

One JSON line per mode and seed, with each side's losses and the worst
leaves of the gradient, of the change and of the key encoder's move, and
for each leaf the ``ema`` number could hold, the norms of its move on the
two sides and of its float32 ulps (``checks.EMA_ULPS`` is set from them).
``--branch-scale`` reads the configuration with other scales of the
residual branches' last BatchNorm (``init.branch_bn_scale``).  The
benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --modes program control --seeds 1 2 3
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from bmk import checks, faults, main, spec  # noqa: E402
from reference import nets  # noqa: E402

MODES = ("program", "program_fp32", "control", "reference_fp64") + faults.FAULTS


def worst(prog: dict, ref: dict, key: str, keep=None, n: int = 3):
    gaps = checks.leaf_gaps(prog[key], ref[key], keep)
    return sorted(((v, k) for k, v in gaps.items()), reverse=True)[:n]


def reading(cell, mode: str) -> dict:
    import torch

    runner = main.build(cell)
    if mode in ("control", "reference_fp64"):
        runner.free()
        with main.no_tf32():
            prog = runner.reference_side(nets.Precision("fp8" if mode == "control" else "fp64"))
    else:
        runner.setup()
        main.synchronize(runner.device)
        runner.free()
    gc.collect()
    torch.cuda.empty_cache()
    with main.no_tf32():
        ref = runner.reference_side(nets.FP32)
    if mode not in ("control", "reference_fp64"):
        prog = runner.program_side()
    keep = checks.kept_leaves(ref)
    out = {"readings": checks.readings(prog, ref), "loss_prog": prog["loss"],
           "loss_ref": ref["loss"],
           "grad_worst": worst(prog, ref, "grad0"),
           "change_worst": worst(prog, ref, "change", keep),
           "left_out": sorted(set(ref["grad0"]) - keep)}
    if "ema" in prog and "ema" in ref:
        moving = checks.moving_leaves(ref, keep)
        out["ema_worst"] = worst(prog, ref, "ema", moving)
        out["ema_leaves"] = {k: [float(prog["ema"][k].norm()), float(ref["ema"][k].norm()),
                                 ref["ema_ulp"][k]] for k in sorted(keep)}
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--modes", choices=MODES, nargs="+", default=["program"])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--branch-scale", type=float, nargs="+", default=[None])
    args = ap.parse_args(argv)
    main.cache_env(spec.ROOT)
    for scale in args.branch_scale:
        for mode in args.modes:
            for seed in args.seeds:
                cell = spec.Cell.load(args.workload, seed, 0.0, False,
                                      fault=mode if mode in faults.FAULTS else None)
                if mode == "program_fp32":
                    cell.config = dict(cell.config, cli=cell.config["cli"] + ["--no-bf16"])
                if scale is not None:
                    cell.config = dict(cell.config, init=dict(cell.config["init"],
                                                              branch_bn_scale=scale))
                t0 = time.perf_counter()
                out = reading(cell, mode)
                print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                                  "branch_bn_scale": cell.config["init"]["branch_bn_scale"],
                                  "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli())

"""A seed group of quality-gate rows against the JAX rows of the same settings.

Reads gate JSONs (``quality_gate.py``'s) of one of two shapes: rows that
share one pretrain (or, scratch legs alone, none) and differ in the
finetune seed, or rows that share the finetune seed and each finetune from
a pretrain of its own seed.  It reads the JAX rows under
``reports/quality/`` at the same training settings (the pretrain epochs
aside), and applies
the rule that ``tests/test_torch_quality_rows.py::test_seed_group_means_agree``
holds them to: the means agree when |x̄ − ȳ| ≤ t · s · √(1/n + 1/m), with
s² the pooled variance (both groups' squared deviations from their own
means over n + m − 2) and t Student's 97.5 % quantile at n + m − 2 degrees
of freedom.  Prints one line per leg, and with ``--out`` writes them as a
short Markdown summary.

Example: ``python -m cp2_tpu_torch.tools.seed_group
reports/quality_torch/seed_spread/v1_r0.3 --out
reports/quality_torch/seed_spread/v1_r0.3/SUMMARY.md``
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LEGS = {"cp2": "finetune_cp2", "scratch": "finetune_scratch"}
T_975 = {4: 2.776, 5: 2.571}  # Student's t, 97.5 %, at the groups' degrees of freedom
# the keys that fix what a row trains; rows of one group differ in the seed
TRAINING = ("corpus_version", "n_unlabeled", "n_train", "n_val", "n_test", "size",
            "img_size", "pretrain_batch", "finetune_epochs", "finetune_batch", "train_ratio")
DEFAULTS = {"corpus_version": 1, "n_unlabeled": 0}


def _load(path):
    with open(path) as f:
        return json.load(f)


def training(row):
    return tuple(row["config"].get(k, DEFAULTS.get(k)) for k in TRAINING)


def varied(rows):
    """What the group's rows vary: ``"seed"`` (finetune seeds on one
    pretrain, or on none) or ``"pretrain_seed"`` (one finetune seed, a
    pretrain of each seed); raises for anything else."""
    if len({training(r) for r in rows}) != 1:
        raise ValueError("the rows differ in their training settings")
    ckpts = {r["pretrain_ckpt"] for r in rows}
    seeds = {r["config"]["seed"] for r in rows}
    pretrain_seeds = {r["config"]["pretrain_seed"] for r in rows}
    if len(ckpts) == 1 and len(seeds) == len(rows):
        return "seed"
    if len(seeds) == 1 and len(ckpts) == len(pretrain_seeds) == len(rows):
        return "pretrain_seed"
    raise ValueError("the rows are neither finetune seeds on one pretrain nor one "
                     "finetune seed on a pretrain each")


def rule(x, y):
    """(x̄, ȳ, pooled s, |x̄ − ȳ|, margin t · s · √(1/n + 1/m), agree)."""
    n, m = len(x), len(y)
    mx, my = sum(x) / n, sum(y) / m
    s = math.sqrt((sum((v - mx) ** 2 for v in x) + sum((v - my) ** 2 for v in y)) / (n + m - 2))
    margin = T_975[n + m - 2] * s * math.sqrt(1 / n + 1 / m)
    return mx, my, s, abs(mx - my), margin, abs(mx - my) <= margin


def sd(x):
    mean = sum(x) / len(x)
    return math.sqrt(sum((v - mean) ** 2 for v in x) / (len(x) - 1))


def gather(path, into):
    """Copy a gate row and its ``card/`` twin into ``into`` as
    ``<name>_p<pretrain seed>.json``; returns the copy's path."""
    stem, ext = os.path.splitext(os.path.basename(path))
    name = f"{stem}_p{_load(path)['config']['pretrain_seed']}{ext}"
    os.makedirs(os.path.join(into, "card"), exist_ok=True)
    shutil.copyfile(path, os.path.join(into, name))
    shutil.copyfile(os.path.join(os.path.dirname(path), "card", os.path.basename(path)),
                    os.path.join(into, "card", name))
    return os.path.join(into, name)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("port", nargs="+", help="gate JSONs of one group, or a directory of them")
    p.add_argument("--out", default="", help="write the summary here as Markdown")
    p.add_argument("--gather", default="",
                   help="first copy the rows and their card/ twins into this directory, "
                        "each named by its pretrain seed (<name>_p<seed>.json): the rows "
                        "of a pretrain-seed group share one name")
    args = p.parse_args(argv)
    paths = []
    for item in args.port:
        paths += sorted(glob.glob(os.path.join(item, "quality_gate*.json"))) \
            if os.path.isdir(item) else [item]
    if args.gather:
        paths = [gather(path, args.gather) for path in paths]
    rows = [_load(path) for path in paths]
    try:
        kind = varied(rows)
    except ValueError as e:
        raise SystemExit(str(e))
    # the JAX rows at the group's training settings, the pretrain epochs aside
    jax_paths = [path for path in sorted(glob.glob(os.path.join(REPO, "reports", "quality",
                                                                "quality_gate*.json")))
                 if training(_load(path)) == training(rows[0])]
    ref = [_load(path) for path in jax_paths]
    ckpts = sorted({r["pretrain_ckpt"] for r in rows}, key=str)
    if kind == "pretrain_seed":
        title = f"finetune seed {rows[0]['config']['seed']} on {len(rows)} pretrain seeds"
    else:
        title = f"{len(rows)} finetune seeds on " + ("one pretrain" if ckpts[0] else
                                                     "no pretrain (scratch legs)")
    named = ", ".join(f"`{os.path.basename(os.path.dirname(c))}/{os.path.basename(c)}`"
                      for c in ckpts if c)
    lines = [f"# Seed group: {title}", "",
             (f"Pretrain checkpoint{"s" if len(ckpts) > 1 else ""} {named}; " if named else "")
             + "JAX rows: " + ", ".join(f"`{os.path.basename(q)}`" for q in jax_paths) + ".", "",
             "| leg | port Dice by seed | port mean, SD | JAX Dice | JAX mean | pooled s | "
             "\\|x̄ − ȳ\\| | margin | verdict |", "|---|---|---|---|---|---|---|---|---|"]
    for leg, key in LEGS.items():
        if not all(key in r for r in rows + ref):
            continue
        x = [r[key]["test_Dice"] for r in rows]
        y = [r[key]["test_Dice"] for r in ref]
        mx, my, s, diff, margin, agree = rule(x, y)
        label = "p" if kind == "pretrain_seed" else "s"
        seeds = ", ".join(f"{label}{r['config'][kind]} {v:.4f}" for r, v in zip(rows, x))
        lines.append(f"| {leg} | {seeds} | {mx:.4f}, {sd(x):.4f} | "
                     f"{', '.join(f'{v:.4f}' for v in y)} | {my:.4f} | {s:.4f} | {diff:.4f} | "
                     f"{margin:.4f} | {'seed noise' if agree else 'fault'} |")
    lines += ["", "Rule (`tests/test_torch_quality_rows.py::test_seed_group_means_agree`): "
              "seed noise when |x̄ − ȳ| ≤ t · s · √(1/n + 1/m), s² the pooled variance over "
              "n + m − 2, t Student's 97.5 % quantile; otherwise a fault.",
              "Written by `python -m cp2_tpu_torch.tools.seed_group`."]
    text = "\n".join(lines) + "\n"
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

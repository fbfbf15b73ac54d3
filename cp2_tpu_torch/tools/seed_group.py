"""A seed group of quality-gate rows against the JAX rows of the same settings.

Reads gate JSONs (``quality_gate.py``'s) that share one pretrain and differ
in the finetune seed, and the JAX rows under ``reports/quality/`` at the
same training settings (the pretrain epochs aside), and applies
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("port", nargs="+", help="gate JSONs of one group, or a directory of them")
    p.add_argument("--out", default="", help="write the summary here as Markdown")
    args = p.parse_args(argv)
    paths = []
    for item in args.port:
        paths += sorted(glob.glob(os.path.join(item, "quality_gate*.json"))) \
            if os.path.isdir(item) else [item]
    rows = [_load(path) for path in paths]
    if len({training(r) for r in rows}) != 1 or len({r["pretrain_ckpt"] for r in rows}) != 1:
        raise SystemExit("the rows do not share one pretrain and one set of training settings")
    # the JAX rows at the group's training settings, the pretrain epochs aside
    jax_paths = [path for path in sorted(glob.glob(os.path.join(REPO, "reports", "quality",
                                                                "quality_gate*.json")))
                 if training(_load(path)) == training(rows[0])]
    ref = [_load(path) for path in jax_paths]
    ckpt = rows[0]["pretrain_ckpt"]
    lines = [f"# Seed group: {len(rows)} finetune seeds on one pretrain", "",
             f"Pretrain checkpoint `{os.path.basename(os.path.dirname(ckpt))}/"
             f"{os.path.basename(ckpt)}`; JAX rows: "
             + ", ".join(f"`{os.path.basename(q)}`" for q in jax_paths) + ".", "",
             "| leg | port Dice by seed | port mean, SD | JAX Dice | JAX mean | pooled s | "
             "\\|x̄ − ȳ\\| | margin | verdict |", "|---|---|---|---|---|---|---|---|---|"]
    for leg, key in LEGS.items():
        if not all(key in r for r in rows + ref):
            continue
        x = [r[key]["test_Dice"] for r in rows]
        y = [r[key]["test_Dice"] for r in ref]
        mx, my, s, diff, margin, agree = rule(x, y)
        seeds = ", ".join(f"s{r['config']['seed']} {v:.4f}" for r, v in zip(rows, x))
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

"""The port's quality-gate rows against the JAX package's (JSON only, CPU).

``reports/quality_torch/quality_gate*.json`` are full runs of
``cp2_tpu_torch/tools/quality_gate.py`` on an H100 (CP2 pretrain →
finetune → test Dice, beside the same finetune from scratch);
``reports/quality/quality_gate*.json`` are the JAX package's rows.

* **The bounds.**  A row's leg passes when its test Dice is within a
  bound of its JAX counterpart's.  Each bound is the widest range of that
  leg's Dice over the JAX rows that differ only in the seed (every other
  training setting equal): 0.0343 for the CP2-initialised leg (v4, pool
  1600, ratio 0.1, seeds 0–1) and 0.0533 for the scratch leg (v1, pool
  1600, ratio 0.1, seeds 1–2).  They are computed here from the files and
  pinned, so neither can drift.
* **Each committed port row** has exactly one JAX row with the same
  training configuration (corpus version, pool, splits, image size,
  pretrain and finetune epochs and batches, label ratio, seed); its keys,
  top level and per leg, equal that row's; its Dice values are finite; and
  each leg is within its bound.  A leg that misses stays in the record as
  a strict xfail whose reason names its entry in ROADMAP.md §3, so a later
  fix shows up as an unexpected pass.
"""

import glob
import json
import math
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROWS = sorted(glob.glob(os.path.join(REPO, "reports", "quality", "quality_gate*.json")))
PORT_ROWS = sorted(glob.glob(os.path.join(REPO, "reports", "quality_torch",
                                          "quality_gate*.json")))
LEGS = {"cp2": "finetune_cp2", "scratch": "finetune_scratch"}
BOUNDS = {"cp2": 0.0343, "scratch": 0.0533}
# what a run trains on and how; the seeds are matched apart from these
TRAINING = ("corpus_version", "n_unlabeled", "n_train", "n_val", "n_test", "size",
            "img_size", "pretrain_epochs", "pretrain_batch", "finetune_epochs",
            "finetune_batch", "train_ratio")
DEFAULTS = {"corpus_version": 1, "n_unlabeled": 0}  # keys older JAX rows lack
# (port row file, leg): its ROADMAP.md §3 entry, for a leg outside its bound
MISSES = {
    ("quality_gate_r0.3_s0.json", "cp2"):
        "ROADMAP.md §3, 'the v1 ratio-0.3 row's CP2-init leg': Dice 0.8393 against "
        "JAX's 0.8044, 0.0349 apart, over the bound of 0.0343",
    ("quality_gate_v4_u1600_r0.1_s1.json", "cp2"):
        "ROADMAP.md §3, 'the v4 ratio-0.1 seed-1 row's CP2-init leg': Dice 0.4196 "
        "against JAX's 0.4594, 0.0399 apart, over the bound of 0.0343",
}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _training(row):
    cfg = row["config"]
    return tuple(cfg.get(k, DEFAULTS.get(k)) for k in TRAINING)


def _counterparts(row):
    return [p for p in JAX_ROWS
            if _training(_load(p)) == _training(row)
            and _load(p)["config"]["seed"] == row["config"]["seed"]]


def seed_spreads():
    """{leg: the widest Dice range over JAX rows equal but for the seed}."""
    groups = {}
    for path in JAX_ROWS:
        row = _load(path)
        groups.setdefault(_training(row), []).append(row)
    return {leg: max(max(r[key]["test_Dice"] for r in rows) - min(r[key]["test_Dice"]
                                                                  for r in rows)
                     for rows in groups.values())
            for leg, key in LEGS.items()}


def test_the_bounds_are_the_jax_rows_widest_seed_spreads():
    spreads = seed_spreads()
    for leg, bound in BOUNDS.items():
        assert spreads[leg] == pytest.approx(bound, abs=1e-4), leg


def _rows():
    return [pytest.param(p, id=os.path.basename(p)) for p in PORT_ROWS]


def _legs():
    params = []
    for path in PORT_ROWS:
        for leg in LEGS:
            name = os.path.basename(path)
            reason = MISSES.get((name, leg))
            marks = [pytest.mark.xfail(strict=True, reason=reason)] if reason else []
            params.append(pytest.param(path, leg, id=f"{name}-{leg}", marks=marks))
    return params


@pytest.mark.parametrize("path", _rows())
def test_row_has_exactly_one_jax_counterpart(path):
    assert len(_counterparts(_load(path))) == 1


@pytest.mark.parametrize("path", _rows())
def test_row_keys_equal_its_jax_rows(path):
    row = _load(path)
    (ref,) = (_load(p) for p in _counterparts(row))
    assert set(row) == set(ref)
    for key in LEGS.values():
        assert set(row[key]) == set(ref[key]), key


@pytest.mark.parametrize("path", _rows())
def test_row_dice_is_finite(path):
    row = _load(path)
    for key in LEGS.values():
        assert math.isfinite(row[key]["test_Dice"]) and 0.0 <= row[key]["test_Dice"] <= 1.0
    assert math.isfinite(row["dice_gain_over_scratch"])


@pytest.mark.parametrize("path,leg", _legs())
def test_leg_is_within_its_bound_of_the_jax_row(path, leg):
    row = _load(path)
    (ref,) = (_load(p) for p in _counterparts(row))
    key = LEGS[leg]
    assert abs(row[key]["test_Dice"] - ref[key]["test_Dice"]) <= BOUNDS[leg]

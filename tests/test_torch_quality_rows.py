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
  fix shows up as an unexpected pass.  Its ``card/`` twin names an NVIDIA
  card and its power limit, and counts one launch of each dense-loss
  kernel a pretrain step and none in a finetune.
* **Shared pretrains.**  The five v1 pool-1600 rows, in JAX as in the
  port, finetune from one 96-epoch pretrain (5952 steps); a scratch leg
  imported with ``--scratch_from`` equals the port row it names.
* **Seed groups.**  ``reports/quality_torch/seed_spread/<group>/`` holds
  five legs of one setting; their mean is held to the JAX rows' of the
  same settings by a pooled two-sample t rule, fixed before the runs
  (``test_seed_group_means_agree``).  Three shapes: five CP2 legs on one
  port pretrain, finetune seeds 0-4 (``v4_u1600_r0.1``, ``v1_r0.3``);
  five scratch legs alone, finetune seeds 0-4, no pretrain
  (``v1_r0.3_scratch``); and five CP2 legs at finetune seed 0, each on a
  pretrain of its own seed 0-4 (``v1_r0.3_pretrain_seeds``).  The
  scratch group is also run with its finetunes in float32
  (``v1_r0.3_scratch_fp32``), held to the same (bfloat16) JAX row.
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
    ("quality_gate_u1600_r0.1_s1.json", "cp2"):
        "ROADMAP.md §3, 'the v1 pool-1600 ratio-0.1 seed-1 row': CP2-init Dice 0.7351 "
        "against JAX's 0.6791, 0.0560 apart, over the bound of 0.0343",
    ("quality_gate_u1600_r0.1_s1.json", "scratch"):
        "ROADMAP.md §3, 'the v1 pool-1600 ratio-0.1 seed-1 row': scratch Dice 0.7215 "
        "against JAX's 0.6569, 0.0646 apart, over the bound of 0.0533",
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


@pytest.mark.parametrize("path", _rows())
def test_row_card_names_the_card_and_counts_launches(path):
    with open(os.path.join(os.path.dirname(path), "card", os.path.basename(path))) as f:
        card = json.load(f)
    assert card["card"].startswith("NVIDIA ") and card["card"].endswith(" W")
    row = _load(path)
    # a reused pretrain or an imported scratch leg ran no CLI call here
    want = {"finetune_cp2"} | ({"pretrain"} if row["pretrain_seconds"] is not None else set())
    if "imported_from" not in row["finetune_scratch"]:
        want.add("finetune_scratch")
    assert set(card["legs"]) == want
    for leg, cost in card["legs"].items():
        steps = cost["steps"] if leg == "pretrain" else 0
        assert cost["launches"] == {"dense_pair_loss_fwd": steps, "dense_pair_loss_bwd": steps}
    if "pretrain" in card["legs"]:
        assert os.path.basename(row["pretrain_ckpt"]) == str(card["legs"]["pretrain"]["steps"])


U1600_STEPS = "5952"  # 96 epochs of 62 batches of 32 (400 train + 1600 unlabeled images)


@pytest.mark.parametrize("rows", [JAX_ROWS, PORT_ROWS], ids=["jax", "port"])
def test_u1600_rows_share_one_96_epoch_pretrain(rows):
    """Every v1 pool-1600 row finetunes from one checkpoint at step 5952,
    the 60-epoch rows too: the gate reuses a checkpoint whose epoch is at
    least the epochs asked for (``tools/quality_gate.py:156``)."""
    u1600 = [_load(p) for p in rows if _training(_load(p))[:2] == (1, 1600)]
    assert len(u1600) == 5
    (first,) = (r for r in u1600 if r["config"]["train_ratio"] == 1.0)
    assert first["config"]["pretrain_epochs"] == 96 and first["pretrain_seconds"] is not None
    for row in u1600:
        assert os.path.basename(row["pretrain_ckpt"]) == U1600_STEPS
        assert row["pretrain_ckpt"] == first["pretrain_ckpt"]
        for key in ("pretrain_loss_first", "pretrain_loss_last"):
            assert row[key] == first[key]
    assert sorted(r["config"]["pretrain_epochs"] for r in u1600) == [60, 60, 96, 96, 96]


def _imported():
    return [pytest.param(p, id=os.path.basename(p)) for p in PORT_ROWS
            if "imported_from" in _load(p)["finetune_scratch"]]


@pytest.mark.parametrize("path", _imported())
def test_imported_scratch_leg_equals_its_source(path):
    leg = dict(_load(path)["finetune_scratch"])
    source = leg.pop("imported_from")
    source = os.path.normpath(os.path.join(REPO, source))
    assert os.path.dirname(source) == os.path.join(REPO, "reports", "quality_torch")
    assert source in PORT_ROWS and source != path  # a port row, never a JAX row
    assert leg == _load(source)["finetune_scratch"]


SPREAD = os.path.join(REPO, "reports", "quality_torch", "seed_spread")
# group: (the leg it runs, what its five rows vary)
SEED_GROUP_SHAPES = {
    "v4_u1600_r0.1": ("cp2", "seed"),
    "v1_r0.3": ("cp2", "seed"),
    "v1_r0.3_scratch": ("scratch", "seed"),
    "v1_r0.3_pretrain_seeds": ("cp2", "pretrain_seed"),
    "v1_r0.3_scratch_fp32": ("scratch", "seed"),
}
FLOAT32_GROUPS = {"v1_r0.3_scratch_fp32"}  # finetuned with --no-bf16, held to JAX's bf16 row
SEED_GROUPS = tuple(SEED_GROUP_SHAPES)
# Student's t, 97.5 % quantile, by degrees of freedom
T_975 = {4: 2.776, 5: 2.571}
# (group, leg): its ROADMAP.md §3 entry, for a group whose rule says fault
GROUP_FAULTS = {
    ("v1_r0.3", "cp2"):
        "ROADMAP.md §3, 'the v1 ratio-0.3 row's CP2-init leg': five finetune seeds on one "
        "port pretrain average 0.8291 (SD 0.0073) against JAX's 0.8044, 0.0247 apart, over "
        "the rule's margin of 0.0221",
    ("v1_r0.3_scratch", "scratch"):
        "ROADMAP.md §3, 'the v1 ratio-0.3 row's CP2-init leg': five scratch finetune seeds "
        "average 0.8720 (SD 0.0027) against JAX's 0.8613, 0.0107 apart, over the rule's "
        "margin of 0.0081: the finetune alone sits above JAX",
    ("v1_r0.3_pretrain_seeds", "cp2"):
        "ROADMAP.md §3, 'the v1 ratio-0.3 row's CP2-init leg': finetune seed 0 on five port "
        "pretrain seeds averages 0.8343 (SD 0.0049) against JAX's 0.8044, 0.0299 apart, over "
        "the rule's margin of 0.0149",
    ("v1_r0.3_scratch_fp32", "scratch"):
        "ROADMAP.md §3, 'the v1 ratio-0.3 row's CP2-init leg': the scratch group finetuned in "
        "float32 averages 0.8738 (SD 0.0013), as in bfloat16, against JAX's 0.8613, over the "
        "rule's margin of 0.0040: the finetune's precision does not move it",
}


def _group_rows(group):
    return sorted(glob.glob(os.path.join(SPREAD, group, "quality_gate*.json")))


def _jax_at(training):
    return [_load(p) for p in JAX_ROWS if _training(_load(p)) == training]


def _u1600_r01(rows):
    """The v1 pool-1600 ratio-0.1 rows on the 5952-step checkpoint: one
    pretrain, training settings equal apart from ``pretrain_epochs``."""
    out = [_load(p) for p in rows]
    out = [r for r in out if _training(r)[:2] == (1, 1600) and r["config"]["train_ratio"] == 0.1
           and os.path.basename(r["pretrain_ckpt"]) == U1600_STEPS]
    epochs = TRAINING.index("pretrain_epochs")
    assert len({_training(r)[:epochs] + _training(r)[epochs + 1:] for r in out}) == 1
    return out


# the five-seed groups' CP2 legs, and both legs of the v1 pool-1600 ratio-0.1
# rows (seeds 0-2 on one pretrain, in JAX as in the port)
GROUP_CASES = [(g, leg) for g, (leg, _) in SEED_GROUP_SHAPES.items()] + [
    ("u1600_r0.1", leg) for leg in LEGS]


def _groups():
    params = []
    for group, leg in GROUP_CASES:
        reason = GROUP_FAULTS.get((group, leg))
        marks = [pytest.mark.xfail(strict=True, reason=reason)] if reason else []
        params.append(pytest.param(group, leg, id=f"{group}-{leg}", marks=marks))
    return params


def group_values(group, leg):
    """(the port's Dice values x, the JAX rows' y) of a seed group's leg."""
    key = LEGS[leg]
    if group in SEED_GROUPS:
        rows = [_load(p) for p in _group_rows(group)]
        ref = _jax_at(_training(rows[0]))
    else:
        rows, ref = _u1600_r01(PORT_ROWS), _u1600_r01(JAX_ROWS)
    return [r[key]["test_Dice"] for r in rows], [r[key]["test_Dice"] for r in ref]


@pytest.mark.parametrize("group,leg", _groups())
def test_seed_group_means_agree(group, leg):
    """The port's mean Dice agrees with the JAX rows' mean at the same
    settings when |x̄ − ȳ| ≤ t · s · √(1/n + 1/m), with s² the pooled
    variance Σ(x − x̄)² + Σ(y − ȳ)² over n + m − 2, and t Student's 97.5 %
    quantile at n + m − 2 degrees of freedom; otherwise the difference is a
    fault.  The rule was fixed before the runs; each group's finetune seeds
    share one pretrain on either side."""
    x, y = group_values(group, leg)
    assert (len(x), len(y)) in ((5, 2), (5, 1), (3, 3))
    difference, margin = _pooled_rule(x, y)
    assert difference <= margin


def _pooled_rule(x, y):
    n, m = len(x), len(y)
    mx, my = sum(x) / n, sum(y) / m
    s = math.sqrt((sum((v - mx) ** 2 for v in x) + sum((v - my) ** 2 for v in y)) / (n + m - 2))
    return abs(mx - my), T_975[n + m - 2] * s * math.sqrt(1 / n + 1 / m)


@pytest.mark.parametrize("group,leg", GROUP_CASES, ids=[f"{g}-{leg}" for g, leg in GROUP_CASES])
def test_seed_group_tool_gives_the_rules_numbers(group, leg):
    """``cp2_tpu_torch/tools/seed_group.py``, which writes each group's
    SUMMARY.md, computes the margin and verdict of the rule above."""
    from cp2_tpu_torch.tools import seed_group

    x, y = group_values(group, leg)
    _, _, _, difference, margin, agree = seed_group.rule(x, y)
    assert (difference, margin) == pytest.approx(_pooled_rule(x, y), abs=1e-12)
    assert agree == (difference <= margin)


def test_the_t_constants_are_students_quantiles():
    stats = pytest.importorskip("scipy.stats")
    for df, t in T_975.items():
        assert stats.t.ppf(0.975, df) == pytest.approx(t, abs=5e-4)


@pytest.mark.parametrize("group", SEED_GROUPS)
def test_seed_group_is_five_finetune_seeds_on_one_pretrain(group):
    """Each group's shape: five finetune seeds 0-4 on one pretrain trained
    by the first seed's call (CP2 legs alone), or on none (scratch legs
    alone); or finetune seed 0 on five pretrains, one of each seed 0-4,
    each trained by its own call (CP2 legs alone).  Every row at one
    training setting that a JAX row has, each card naming an NVIDIA card
    and counting one launch of each dense-loss kernel a pretrain step."""
    leg, varied = SEED_GROUP_SHAPES[group]
    paths = _group_rows(group)
    rows = [_load(p) for p in paths]
    assert len(rows) == 5
    assert len({_training(r) for r in rows}) == 1 and _jax_at(_training(rows[0]))
    seeds = sorted(r["config"]["seed"] for r in rows)
    ckpts = {r["pretrain_ckpt"] for r in rows}
    if varied == "seed":
        assert seeds == [0, 1, 2, 3, 4] and len(ckpts) == 1
    else:
        assert seeds == [0] * 5 and len(ckpts) == 5
        assert sorted(r["config"]["pretrain_seed"] for r in rows) == [0, 1, 2, 3, 4]
    pretrains = 0
    for path, row in zip(paths, rows):
        assert row["config"].get("finetune_float32", False) == (group in FLOAT32_GROUPS)
        assert set(row) & set(LEGS.values()) == {LEGS[leg]}
        assert math.isfinite(row[LEGS[leg]]["test_Dice"])
        if leg == "scratch":
            assert row["pretrain_ckpt"] is None and row["pretrain_seconds"] is None
        else:
            assert row["config"]["pretrain_seed"] in (0, 1, 2, 3, 4)
            assert varied == "pretrain_seed" or row["config"]["pretrain_seed"] == 0
        with open(os.path.join(os.path.dirname(path), "card", os.path.basename(path))) as f:
            card = json.load(f)
        assert card["card"].startswith("NVIDIA ") and card["card"].endswith(" W")
        assert set(card["legs"]) - {"pretrain"} == {LEGS[leg]}
        pretrains += "pretrain" in card["legs"]
        for name, cost in card["legs"].items():
            steps = cost["steps"] if name == "pretrain" else 0
            assert cost["launches"] == {"dense_pair_loss_fwd": steps,
                                        "dense_pair_loss_bwd": steps}
    # the first seed's call trained the shared pretrain; each pretrain seed's
    # call trained its own; a scratch group trains none
    assert pretrains == {"scratch": 0, "cp2": 1 if varied == "seed" else 5}[leg]


@pytest.mark.parametrize("group", SEED_GROUPS)
def test_seed_group_tool_reads_each_shape(group, capsys):
    """``seed_group`` tells the group's shape from its rows and writes the
    verdict of each leg the rows have."""
    from cp2_tpu_torch.tools import seed_group

    leg, varied = SEED_GROUP_SHAPES[group]
    assert seed_group.varied([_load(p) for p in _group_rows(group)]) == varied
    assert seed_group.main([os.path.join(SPREAD, group)]) == 0
    table = [line for line in capsys.readouterr().out.splitlines() if line.startswith("| ")]
    verdict = "fault" if (group, leg) in GROUP_FAULTS else "seed noise"
    assert [line.split(" | ")[0] for line in table[1:]] == [f"| {leg}"]  # after the header
    assert table[1].endswith(f"| {verdict} |")


def test_seed_group_tool_gathers_a_pretrain_seed_group(tmp_path):
    """``--gather``: rows of one name in a directory each come into the
    group named by their pretrain seed, with their card twins."""
    import shutil

    from cp2_tpu_torch.tools import seed_group

    sources = []
    for path in _group_rows("v1_r0.3_pretrain_seeds"):
        pseed = _load(path)["config"]["pretrain_seed"]
        src = tmp_path / f"p{pseed}"
        (src / "card").mkdir(parents=True)
        shutil.copyfile(path, src / "quality_gate_r0.3_s0.json")
        shutil.copyfile(os.path.join(os.path.dirname(path), "card", os.path.basename(path)),
                        src / "card" / "quality_gate_r0.3_s0.json")
        sources.append(str(src))
    into = tmp_path / "group"
    assert seed_group.main([*sources, "--gather", str(into), "--out", str(into / "S.md")]) == 0
    names = sorted(os.path.basename(p) for p in _group_rows("v1_r0.3_pretrain_seeds"))
    assert sorted(os.listdir(into)) == sorted(names + ["S.md", "card"])
    assert sorted(os.listdir(into / "card")) == names
    with open(os.path.join(SPREAD, "v1_r0.3_pretrain_seeds", "SUMMARY.md")) as f:
        assert (into / "S.md").read_text() == f.read()

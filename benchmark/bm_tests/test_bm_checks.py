"""The check must fail what it is there to catch.

On the CPU, at a test size: a whole run (``main.run_cell``, which skips
only the look for a card) with the timed path broken underneath comes out
not correct, once for each fault of ``bmk/faults.py`` the cell can have,
and the number that catches each fault reads far above the same number of
a sound run; the control (the reference computed in float8 in the program's
place) comes out not correct.  On the card, at the cells' own size, the
control on three seeds."""

import time

import pytest
import torch

import calibrate
import tiny
from bmk import checks, faults, main, spec
from reference import nets

CELLS = ["cp2_pretrain.resident", "seg_finetune.resident"]


def _cell(name, root, fault=None, fp32=True, seed=1234):
    c = tiny.cell(name, str(root), fault=fault, seed=seed)
    if fp32:
        c.config["cli"] = c.config["cli"] + ["--no-bf16"]
    return c


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in faults.FAULTS
    if fault != "ema_skipped" or name.startswith("cp2_pretrain")])
def test_a_broken_step_is_not_correct(tmp_path, name, fault):
    limits = spec.config(spec.Cell.load(name, 1, 1.0, False).workload["config"])["limits"]
    result = main.run_cell(_cell(name, tmp_path, fault), time.perf_counter())
    assert result["correct"] is False
    failed = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    sound = checks.readings(*_sides(_cell(name, tmp_path)))
    assert any(result["checks"][k]["value"] > 3 * sound[k] for k in failed), (failed, sound)
    assert {"loss", "grad", "change"} <= set(result["checks"]) <= set(limits)
    if fault == "ema_skipped":
        assert "ema" in failed


def _ema_sides(program_moves: bool):
    """Two key leaves: ``bn`` near 1, whose reference moves one element by
    one float32 ulp; ``conv`` near 0.01, moving by about 1e-5 on both sides
    (or, with ``program_moves`` false, not at all on the program's)."""
    p0 = {"bn": torch.ones(64) * 0.75, "conv": torch.full((64,), 0.01)}
    ulp = float(torch.nextafter(torch.tensor(0.75), torch.tensor(1.0)) - 0.75)
    grad = {k: torch.ones(64) for k in p0}
    ref_ema = {"bn": p0["bn"].clone(), "conv": p0["conv"] + 1e-5}
    ref_ema["bn"][3] += ulp
    prog_ema = {"bn": p0["bn"].clone(),
                "conv": p0["conv"] + (1e-5 + 1e-9 if program_moves else 0.0)}
    ref = checks.side([1.0], grad, p0, p0, ema=ref_ema)
    prog = checks.side([1.0], grad, p0, p0, ema=prog_ema)
    return prog, ref


def test_ema_leaves_a_move_of_one_ulp_out():
    """The one-ulp leaf would read 1 by itself; it is left out of ``ema``,
    and the leaf that moves is still compared."""
    prog, ref = _ema_sides(program_moves=True)
    assert checks.moving_leaves(ref, {"bn", "conv"}) == {"conv"}
    assert checks.readings(prog, ref)["ema"] < 1e-3
    assert checks.leaf_gaps(prog["ema"], ref["ema"], {"bn"})["bn"] == pytest.approx(1.0)
    prog, ref = _ema_sides(program_moves=False)
    assert checks.readings(prog, ref)["ema"] == pytest.approx(1.0)


def _sides(cell):
    runner = main.build(cell)
    runner.setup()
    runner.free()
    ref = runner.reference_side(nets.FP32)
    return runner.program_side(), ref


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tmp_path, name):
    cell = _cell(name, tmp_path)
    ok, checks_ = checks.verdict(calibrate.reading(cell, "control")["readings"],
                                 cell.config["limits"])
    assert not ok, checks_


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    """At the cell's own size, three seeds (minutes of card time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    main.cache_env(spec.ROOT)
    for seed in (301, 302, 303):
        cell = spec.Cell.load(name, seed, 0.0, False)
        ok, checks_ = checks.verdict(calibrate.reading(cell, "control")["readings"],
                                     cell.config["limits"])
        assert not ok, (seed, checks_)

"""Whole runs that must fail: no card, no program, an unknown cell; and the
look for modules no run may load."""

import os
import shutil
import subprocess
import sys

from bmk import main, spec

RUN = os.path.join(spec.ROOT, "benchmark", "run.py")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, RUN if cwd == spec.ROOT else "benchmark/run.py",
                           *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_fails_and_prints_nothing():
    """Measuring needs the card: without one the run exits non-zero and
    prints no result; it never carries on on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["--workload", "cp2_pretrain.resident", "--seed", "1", "--seconds", "1"],
               spec.ROOT, env)
    assert out.returncode == main.EXIT_NO_CARD and out.stdout == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", "seg_finetune.resident", "--seed", "1", "--seconds", "1"],
               str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


def test_an_unknown_cell_fails():
    out = _run(["--workload", "no_such.cell", "--seed", "1", "--seconds", "1"], spec.ROOT)
    assert out.returncode == main.EXIT_USAGE and out.stdout == ""


def test_forbidden_modules_are_named_by_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "cp2_tpu_torch_fake", object())
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert main.forbidden_modules() == ["jaxlib"]

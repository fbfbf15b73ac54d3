"""BENCHMARK.json against its contract, and the files it names found by
name; a configuration, a traffic mix and a metric added as new files."""

import ast
import json
import os
import shutil

import pytest

from bmk import spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cp2_tpu"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    seen = set()
    for entry in BENCH[section]:
        assert spec.NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
        if "unit" in entry:
            assert spec.UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
        for key in entry.get("reduced", []):
            assert spec.NAME.match(key)


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.Cell.load(w["name"], 1, 1.0, False)
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(cell):
    c = spec.Cell.load(cell, 1, 1.0, True)
    assert c.config["task"] in ("cp2_pretrain", "seg_finetune")
    assert spec.task(c.config["task"]).Runner
    assert c.traffic["feed"] in ("resident", "files")
    for m in c.per_layer():
        assert callable(spec.reader(m["name"]))
    cfg_entry = next(x for x in BENCH["configs"] if x["name"] == c.workload["config"])
    assert os.path.isfile(os.path.join(ROOT, cfg_entry["file"]))


def test_new_config_mix_and_metric_are_picked_up(tmp_path):
    """A later change adds files and entries, and edits no file."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.config("cp2_r50_aspp_224")
    cfg["cli"] = cfg["cli"] + ["--img_height", "256", "--img_width", "256"]
    (tmp_path / "benchmark/configs/cp2_r50_aspp_256.json").write_text(json.dumps(cfg))
    mix = dict(spec.traffic("files"), num_workers=8)
    (tmp_path / "benchmark/traffic/files8.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/steps_in_window.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    bench["configs"].append(dict(bench["configs"][0], name="cp2_r50_aspp_256",
                                 file="benchmark/configs/cp2_r50_aspp_256.json"))
    bench["workloads"].append({"name": "cp2_pretrain.files8", "config": "cp2_r50_aspp_256",
                               "traffic": "files8", "chips": 1, "why": "eight workers"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "pretrain_images_per_s",
                               "workloads": ["cp2_pretrain.files8"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cp2_pretrain.resident" in m["workloads"]:
            m["workloads"].append("cp2_pretrain.files8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*.py")}
    cell = spec.Cell.load("cp2_pretrain.files8", 1, 1.0, True, root=str(tmp_path))
    assert cell.traffic["num_workers"] == 8 and "256" in cell.config["cli"]
    assert [m["name"] for m in cell.per_layer()][-1] == "steps_in_window"
    reading = type("R", (), {"steps": 7})()
    assert spec.reader("steps_in_window", str(tmp_path))(reading) == 7.0
    assert all(p.read_bytes() == b for p, b in before.items() if p.exists())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(ROOT, "benchmark", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``cp2_tpu_torch`` starts with
    ``cp2_tpu`` and is allowed outside the reference."""
    for path in _sources():
        assert not FORBIDDEN.intersection(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "cp2_tpu_torch" not in set(_imports(path)), path

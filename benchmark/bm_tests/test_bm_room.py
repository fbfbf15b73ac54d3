"""Room for a new configuration: a later change adds a configuration, a
traffic mix, a task, its reference and a metric that reads the task's own
program span, as new files and entries only, and the harness runs its cell
traced with no edit to any file it had.

The checkout is copied to a temporary root and the new files are written
there; the cell runs in a process of its own whose harness (``bmk``,
``tasks``, ``reference``) is the copy's, on the CPU, through
``main.run_cell`` (all of a run but the look for a card).  The task is a
per-pixel logistic probe of the corpus's masks, trained by SGD, each step
inside the program's spans ``probe.step`` and ``probe.forward``; names that
no list of the harness holds.
"""

import json
import os
import shutil
import subprocess
import sys

from bmk import spec

TASK = '''"""A per-pixel logistic probe of the corpus's masks, by SGD."""

import time

import torch

from bmk import checks
from bmk.loop import Loop
from cp2_tpu_torch.utils.profiling import span
from reference import probe as ref


class Runner(Loop):
    def __init__(self, cell, spans, pairs):
        self.cell, self.span, self.cfg = cell, spans, cell.config
        self.device = torch.device(cell.device)
        self.x, self.y = ref.pixels(pairs, self.device)
        self.batch = self.cfg["batch"]
        self.w = ref.init(cell.seed, self.device).requires_grad_(True)
        self.p0 = {"w": self.w.detach().clone()}
        self.steps, self.capture = 0, {"loss": []}

    def run_epoch(self, epoch, stop_at=None):
        for i in range(len(self.x) // self.batch):
            x, y = ref.rows(self.x, self.y, i, self.batch)
            with self.span("step"), span("probe.step"):
                with span("probe.forward"):
                    loss = ref.loss_of(self.w, x, y)
                loss.backward()
                with torch.no_grad():
                    grad = self.w.grad.clone()
                    self.w -= self.cfg["lr"] * grad
                    self.w.grad = None
            self.steps += 1
            if epoch == 0 and i < 3:
                self.capture["loss"].append(float(loss))
                if i == 0:
                    self.capture["grad0"] = {"w": grad}
                if i == 2:
                    self.capture["params"] = {"w": self.w.detach().clone()}
            if stop_at is not None and time.perf_counter() >= stop_at:
                return False
        return True

    def free(self):
        del self.w

    def program_side(self):
        c = self.capture
        return checks.side(c["loss"], c["grad0"], c["params"], self.p0)

    def reference_side(self, prec):
        out = ref.run(ref.init(self.cell.seed, self.device), self.x, self.y, self.batch,
                      self.cfg["lr"])
        return checks.side(out["loss"], {"w": out["grad0"]}, {"w": out["params"]}, self.p0)

    def counts(self, peak):
        return {"flops_per_step": 4 * self.batch * self.x.shape[1]}
'''

REFERENCE = '''"""The probe's three SGD steps in plain float32."""

import numpy as np
import torch
from PIL import Image


def pixels(pairs, device):
    x = np.concatenate([np.asarray(Image.open(i), np.float32).reshape(-1, 3) / 255
                        for i, _ in pairs])
    y = np.concatenate([np.asarray(Image.open(m), np.float32).reshape(-1) / 255
                        for _, m in pairs])
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def init(seed, device):
    g = torch.Generator().manual_seed(seed % 2**31)
    return torch.randn(3, generator=g).to(device)


def rows(x, y, i, batch):
    return x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch]


def loss_of(w, x, y):
    return torch.nn.functional.binary_cross_entropy_with_logits(x @ w, y)


def run(w, x, y, batch, lr, steps=3):
    losses, grad0 = [], None
    for i in range(steps):
        w = w.detach().requires_grad_(True)
        loss = loss_of(w, *rows(x, y, i, batch))
        g, = torch.autograd.grad(loss, [w])
        losses.append(float(loss))
        grad0 = g if grad0 is None else grad0
        w = w.detach() - lr * g
    return {"loss": losses, "grad0": grad0, "params": w}
'''

METRIC = '''"""``probe_forward_ms``: host ms per step in the program's ``probe.forward`` span."""

from bmk import readers


def read(r):
    return readers.span_host_ms(r, "probe.forward")
'''

CHILD = '''
import json, sys, time
sys.path[:0] = [{bench!r}, {repo!r}]
from bmk import main, spec
out = {{}}
for traced in (False, True):
    cell = spec.Cell.load("probe.pixels", 2718281831, 0.3, traced, device="cpu",
                          cache={cache!r})
    out[str(traced)] = main.run_cell(cell, time.perf_counter())
print(json.dumps(out))
'''


def _add_configuration(root):
    """The new files, and the entries a change adds to BENCHMARK.json."""
    b = root / "benchmark"
    (b / "tasks/probe.py").write_text(TASK)
    (b / "reference/probe.py").write_text(REFERENCE)
    (b / "metrics/probe_forward_ms.py").write_text(METRIC)
    (b / "configs/probe_rgb.json").write_text(json.dumps(
        {"task": "probe", "batch": 256, "lr": 0.5,
         "limits": {"loss": 1e-5, "grad": 1e-4, "change": 1e-4}}))
    (b / "traffic/pixels.json").write_text(json.dumps(
        {"feed": "resident", "corpus": {"frames": 4, "hw": [16, 16], "train": 4, "seed": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "probe_rgb", "source": "https://example.org/probe",
                             "file": "benchmark/configs/probe_rgb.json", "reduced": [],
                             "why": "a per-pixel probe"})
    bench["workloads"].append({"name": "probe.pixels", "config": "probe_rgb",
                               "traffic": "pixels", "chips": 1, "why": "the probe's span"})
    for m in bench["end_to_end"]:
        if m["name"] == "finetune_images_per_s":
            m["workloads"].append("probe.pixels")
    bench["per_layer"].append({"name": "probe_forward_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "probe",
                               "moves": "finetune_images_per_s", "workloads": ["probe.pixels"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_configuration_added_as_new_files_runs_traced_and_reads_its_span(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    _add_configuration(root)
    code = CHILD.format(bench=str(root / "benchmark"), repo=spec.ROOT,
                        cache=str(tmp_path / "cache"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    runs = json.loads(out.stdout.strip().splitlines()[-1])
    untraced, traced = runs["False"], runs["True"]
    assert untraced["correct"] and traced["correct"], (untraced["checks"], traced["checks"])
    assert set(untraced["metrics"]) == {"finetune_images_per_s", "peak_mib", "setup_s"}
    assert untraced["metrics"]["finetune_images_per_s"]["value"] > 0
    assert set(traced["metrics"]) == {"probe_forward_ms"}
    assert traced["metrics"]["probe_forward_ms"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
    added = {p for p in (root / "benchmark").rglob("*.py") if p not in before
             and "__pycache__" not in p.parts}
    assert {p.relative_to(root).as_posix() for p in added} == {
        "benchmark/tasks/probe.py", "benchmark/reference/probe.py",
        "benchmark/metrics/probe_forward_ms.py"}

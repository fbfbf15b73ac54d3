"""The port stands alone: ``cp2_tpu_torch`` and ``chip_smoke.py`` import no
JAX, flax or optax and nothing of the JAX package ``cp2_tpu``; the port
imports no cv2, which the card machine lacks (its mmseg pipelines compute
what cv2 computes), and no matplotlib, which it lacks too (its figures are
drawn with PIL); and every module of the port imports on a machine without
a card."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cp2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cp2_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cv2_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] == "cv2"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_matplotlib_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in ("matplotlib", "pylab")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_a_card():
    for path in sorted(PORT.rglob("*.py")):
        name = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(name.removesuffix(".__init__"))


@pytest.mark.parametrize("package", ["parallel", "tools"])
def test_the_scan_covers_the_process_layer_and_the_tools(package):
    """``parallel/`` (collectives built on ``all_reduce``) and ``tools/``
    (the quality gate and its corpus) are in the scan above, and what they
    import is all of the port, torch, numpy, PIL or the standard library."""
    files = [p for p in SOURCES if p.parent == PORT / package]
    assert {p.name for p in files} >= {"__init__.py"} and len(files) >= 3, files
    allowed = {"cp2_tpu_torch", "torch", "numpy", "PIL", "__future__"}
    import sys

    for path in files:
        for module in _imported(path):
            top = module.split(".")[0]
            assert top in allowed or top in sys.stdlib_module_names, (path.name, module)


def test_the_checkpoint_converter_stays_outside_the_package():
    """The one file that imports both packages is ``tools/`` at the repo's
    root, which the scan does not cover."""
    converter = ROOT / "tools" / "jax_to_torch_checkpoint.py"
    tops = {m.split(".")[0] for m in _imported(converter)}
    assert {"cp2_tpu", "cp2_tpu_torch", "jax"} <= tops
    assert converter not in SOURCES

"""The port stands alone: ``cp2_tpu_torch`` and ``chip_smoke.py`` import no
JAX, flax or optax and nothing of the JAX package ``cp2_tpu``; the port
imports no cv2, which the card machine lacks (its mmseg pipelines compute
what cv2 computes); and every module of the port imports on a machine
without a card."""

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


def test_every_port_module_imports_without_a_card():
    for path in sorted(PORT.rglob("*.py")):
        name = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(name.removesuffix(".__init__"))

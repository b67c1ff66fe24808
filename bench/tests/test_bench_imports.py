"""Nothing under ``bench/`` imports JAX or the JAX package (``repro``),
top-level names compared whole (``repro_torch`` is the program and
allowed); the reference imports nothing of the program, at the source
and once run."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from bench_testing import BENCH

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] not in {"torch", "reference", "__future__"}]
    assert bad == [], f"{path.name} imports {bad}"


def test_reference_run_loads_nothing_of_the_program():
    """Drawing the weights and running a reference forward in a fresh
    process leaves no module of the program or of JAX in it."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(BENCH)!r})\n"
        "import run\n"
        "cfg = json.loads(open(run.BENCH / 'configs' / 'resnet34-2xT.json')"
        ".read())\n"
        "cfg['input_shape'] = [32, 32, 3]\n"
        "ad = run.load_module('configs', 'resnet34-2xT')\n"
        "ref = run.load_module('reference', cfg['reference'])\n"
        "flat = ad.draw(cfg, 3, 'cpu')\n"
        "ref.forward(flat, torch.zeros((1, 32, 32, 3)) + 0.5, cfg)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr

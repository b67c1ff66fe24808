"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``;
importing the port builds nothing; ``chip_smoke.py`` refuses to run
outside a checkout."""
import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert bad == [], f"{path.name} imports {bad}"


def test_port_imports_build_nothing():
    import repro_torch
    from repro_torch.kernels import _build
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
    assert _build._LIBS == {}
    assert "triton" not in sys.modules


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text(encoding="utf-8"))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

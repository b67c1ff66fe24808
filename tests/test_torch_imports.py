"""The port stands alone: no module of ``src/repro_torch``, no example of
the port (``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``;
importing the port builds nothing; ``chip_smoke.py`` refuses to run
outside a checkout.  And the port's tests keep one PyTorch thread a
process (``tests/torch_testing.py``)."""
import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    sorted((REPO / "examples").glob("torch_*.py")) + \
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


def test_every_module_imports_first():
    """Each module of the port imports in a fresh interpreter state of the
    package, whichever is imported first (no import cycle depends on the
    order)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [i.name for i in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for name in names:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 30


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text(encoding="utf-8"))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


TRAINING_MODULES = ("repro_torch.tree", "repro_torch.optim",
                    "repro_torch.data", "repro_torch.checkpoint",
                    "repro_torch.launch.steps", "repro_torch.launch.train",
                    "repro_torch.runtime")


def test_training_modules_stand_alone():
    """The training slice (optimizers, steps, data, checkpoints, the
    elastic loop, the launcher) and its examples are among the checked
    sources, and importing them in a fresh interpreter loads no JAX and
    nothing of ``repro``."""
    for name in TRAINING_MODULES + ("examples.torch_train_qat",
                                    "examples.torch_widening_tradeoff"):
        rel = Path("src", *name.split(".")) if name.startswith("repro") \
            else Path(*name.split("."))
        assert any(p in SOURCES for p in (REPO / rel.with_suffix(".py"),
                                          REPO / rel / "__init__.py")), name
    code = ("import sys\n"
            f"for m in {TRAINING_MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


MESH_MODULES = ("repro_torch.launch.mesh", "repro_torch.parallel",
                "repro_torch.parallel.comm", "repro_torch.parallel.sharding",
                "repro_torch.parallel.moe_shard_map",
                "repro_torch.launch.serve")


def test_mesh_modules_stand_alone():
    """The mesh slice (the mesh, the sharding rules, the collectives, the
    expert-parallel MoE, the launcher's ``--mesh``) is among the checked
    sources; importing it in a fresh interpreter loads no JAX, nothing of
    ``repro``, starts no process group and builds nothing."""
    for name in MESH_MODULES:
        rel = Path("src", *name.split("."))
        assert any(p in SOURCES for p in (REPO / rel.with_suffix(".py"),
                                          REPO / rel / "__init__.py")), name
    code = ("import sys\n"
            f"for m in {MESH_MODULES!r}: __import__(m)\n"
            "import torch.distributed as dist\n"
            "from repro_torch.kernels import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(bad, dist.is_initialized(), _build._LIBS)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False {}", proc.stdout


MESH_TRAINING_MODULES = ("repro_torch.parallel.pipeline",
                         "repro_torch.launch.steps", "repro_torch.optim",
                         "repro_torch.checkpoint")


@pytest.mark.parametrize("name", MESH_TRAINING_MODULES)
def test_mesh_training_modules_stand_alone(name):
    """Training over a mesh (the GPipe stack, the mesh train step, the
    optimizers' ``state_specs``, checkpoints cut over a mesh) is among the
    checked sources; importing each module in a fresh interpreter loads no
    JAX, nothing of ``repro``, starts no process group and builds
    nothing."""
    rel = Path("src", *name.split("."))
    assert any(p in SOURCES for p in (REPO / rel.with_suffix(".py"),
                                      REPO / rel / "__init__.py")), name
    code = ("import sys\n"
            f"__import__({name!r})\n"
            "import torch.distributed as dist\n"
            "from repro_torch.kernels import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(bad, dist.is_initialized(), _build._LIBS)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False {}", proc.stdout


ANALYSIS_MODULES = ("repro_torch.analysis", "repro_torch.analysis.report",
                    "repro_torch.analysis.op_walker",
                    "repro_torch.analysis.rules",
                    "repro_torch.analysis.steps",
                    "repro_torch.analysis.astlint",
                    "repro_torch.analysis.cli")


def test_analysis_modules_stand_alone():
    """The auditor (``repro_torch.analysis``) is among the checked sources
    and keeps its own copies of what it takes from ``repro.analysis``: in
    a fresh interpreter, importing every module and running the linter
    (``python -m repro_torch.analysis lint``: exit 0, no finding) loads no
    JAX and nothing of ``repro``, and builds nothing."""
    for name in ANALYSIS_MODULES:
        rel = Path("src", *name.split("."))
        assert any(p in SOURCES for p in (REPO / rel.with_suffix(".py"),
                                          REPO / rel / "__init__.py")), name
    code = ("import sys\n"
            f"for m in {ANALYSIS_MODULES!r}: __import__(m)\n"
            "from repro_torch.analysis import cli\n"
            "from repro_torch.kernels import _build\n"
            "rc = cli.main(['lint'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(rc, bad, _build._LIBS)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "0 [] {}", proc.stdout


DRY_RUN_MODULES = ("repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
                   "repro_torch.kernels.costs")


def test_dry_run_modules_stand_alone():
    """The dry run (``launch.dryrun``, ``launch.hillclimb`` and the
    kernels' work counts) is among the checked sources; importing it in a
    fresh interpreter loads no JAX, nothing of ``repro``, starts no process
    group and builds nothing."""
    for name in DRY_RUN_MODULES:
        assert REPO / Path("src", *name.split(".")).with_suffix(".py") \
            in SOURCES, name
    code = ("import sys\n"
            f"for m in {DRY_RUN_MODULES!r}: __import__(m)\n"
            "import torch.distributed as dist\n"
            "from repro_torch.kernels import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(bad, dist.is_initialized(), _build._LIBS)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False {}", proc.stdout


TEST_FILES = sorted((REPO / "tests").glob("test_torch_*.py")) + \
    sorted((REPO / "tests").glob("torch_*_ranks.py"))
# fault C6's check that a backward's bits do not depend on the run sets 4
# threads on purpose (and restores the count after)
MORE_THREADS = {("test_torch_train_spmd.py",
                 "test_token_gathers_backward_bit_equal_run_to_run")}


def _imports_torch(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "torch" for a in node.names):
            return True
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "importorskip" and \
                node.args and getattr(node.args[0], "value", None) == "torch":
            return True
    return False


def _calls(tree, attr):
    """(call, enclosing function, with-item names) of every call of
    ``<x>.attr(...)`` or of a call that is handed ``<x>.attr`` (an
    executor's ``submit(tmesh.spawn, ...)``)."""
    out = []

    def walk(node, func, withs):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.With):
            withs = withs + tuple(
                getattr(i.context_expr.func, "id", None) for i in node.items
                if isinstance(i.context_expr, ast.Call))
        if isinstance(node, ast.Call) and attr in [
                getattr(f, "attr", None) for f in [node.func, *node.args]]:
            out.append((node, func, withs))
        for child in ast.iter_child_nodes(node):
            walk(child, func, withs)

    walk(tree, None, ())
    return out


@pytest.mark.parametrize("path", TEST_FILES, ids=lambda p: p.name)
def test_port_tests_take_one_thread(path):
    """Every port test file that imports torch takes the shared one-thread
    fixture (``tests/torch_testing.py``), every rank entry of a rank file
    starts with ``torch.set_num_threads(1)``, every spawn of CPU ranks runs
    inside ``ranks_one_thread()``, and no file sets another thread count
    but fault C6's check (``MORE_THREADS``)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    if not _imports_torch(tree):
        return
    if path.name.startswith("test_"):
        assert any(isinstance(n, ast.ImportFrom)
                   and n.module == "torch_testing"
                   and "one_thread" in [a.name for a in n.names]
                   for n in tree.body), \
            f"{path.name}: from torch_testing import one_thread"
    else:
        entry = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "run_checks"]
        assert entry, f"{path.name} has no run_checks"
        body = [n for n in entry[0].body if not (
            isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
        assert ast.unparse(body[0]) == "torch.set_num_threads(1)", path.name
    for call, func, _ in _calls(tree, "set_num_threads"):
        if (path.name, func) in MORE_THREADS:
            continue
        assert ast.unparse(call) == "torch.set_num_threads(1)", \
            f"{path.name}:{call.lineno} {ast.unparse(call)}"
    for call, func, withs in _calls(tree, "spawn"):
        device = [k.value for k in call.keywords if k.arg == "device"]
        if device and getattr(device[0], "value", None) == "cpu":
            assert "ranks_one_thread" in withs, f"{path.name}:{call.lineno}"

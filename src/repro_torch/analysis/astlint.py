"""Architecture linter: rules over the ``ast`` of the port's own sources
(``repro.analysis.astlint``, pointed at ``src/repro_torch/`` and the
port's tests).

  ==========================  ===========================================
  rule id                     contract
  ==========================  ===========================================
  kernel-import-boundary      the raw matmul kernel modules
                              (binary/ternary/packed_matmul) are private
                              to the engine — no imports outside
                              ``src/repro_torch/kernels/``
  batcher-config-bypass       every ContinuousBatcher/PagedBatcher
                              construction passes a ServingConfig (third
                              positional arg or ``config=``)
  device-get-in-hot-loop      no host sync (``.item()``, ``.tolist()``,
                              ``.cpu()``, ``torch.cuda.synchronize``)
                              inside scheduler hot loops (``step``/``run``
                              and their ``_step``/``_sample``/``_advance``
                              helpers): it serializes the device
  tracing-in-jit              the flight recorder stays around the model
                              calls: no tracer call and no
                              ``repro_torch.runtime.tracing`` import under
                              ``models/``, ``kernels/`` or ``parallel/``
                              (the reference's jit-land)
  ==========================  ===========================================

The reference's ``legacy-kwargs`` has no counterpart: the port never took
the reference's back-compat constructor shim, so there are no loose
constructor keywords to confine.  Its ``tracing-in-jit`` also looks for
tracer calls in functions handed to ``jax.jit``; the port compiles no
Python function, so the rule keeps its module half.

Findings reuse :class:`~repro_torch.analysis.report.Finding` with
``step = "<path>:<lineno>"``.
"""
from __future__ import annotations

import ast
import os

from .report import Finding

_KERNEL_MODULES = ("binary_matmul", "ternary_matmul", "packed_matmul")
_BATCHERS = ("ContinuousBatcher", "PagedBatcher")
_HOT_LOOP_FNS = ("step", "run")
_HOT_LOOP_PREFIXES = ("_step", "_sample", "_advance")
_SYNC_METHODS = ("item", "tolist", "cpu")

# tracing-in-jit: tracer receivers by convention (self.tracer / a `tr` or
# `tracer` local) and the module trees that hold the model's math
_TRACER_NAMES = ("tracer", "_tracer", "tr")
_JIT_LAND_PREFIXES = ("src/repro_torch/models/", "src/repro_torch/kernels/",
                      "src/repro_torch/parallel/")
_TRACING_MODULE = "repro_torch.runtime.tracing"

# per-rule path-prefix exemptions (repo-relative, forward slashes): the
# kernels package, whose engine imports the kernel modules, as the
# reference exempts its own
DEFAULT_EXEMPT = {
    "kernel-import-boundary": ("src/repro_torch/kernels/",),
    "batcher-config-bypass": (),
    "device-get-in-hot-loop": (),
    "tracing-in-jit": (),
}

AST_RULES = tuple(DEFAULT_EXEMPT)


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _host_sync(node: ast.Call) -> str | None:
    """``x.item()`` / ``x.tolist()`` / ``x.cpu()`` /
    ``torch.cuda.synchronize()``: the spelling, else None."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _SYNC_METHODS:
        return f".{f.attr}()"
    if f.attr == "synchronize" and isinstance(f.value, ast.Attribute) \
            and f.value.attr == "cuda":
        return "torch.cuda.synchronize()"
    return None


def _is_tracer_call(node: ast.Call) -> bool:
    """A method call on a tracer receiver: ``tracer.x(...)``, ``tr.x(...)``,
    ``self.tracer.x(...)``."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    v = f.value
    if isinstance(v, ast.Name):
        return v.id in _TRACER_NAMES
    if isinstance(v, ast.Attribute):
        return v.attr in _TRACER_NAMES
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, rules: tuple):
        self.path = path
        self.rules = rules
        self.findings: list[Finding] = []
        self._fn_stack: list[str] = []

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, step=f"{self.path}:{node.lineno}", message=message,
            locus=ast.unparse(node)[:160]))

    def _in_jit_land(self) -> bool:
        return self.path.startswith(_JIT_LAND_PREFIXES)

    def _tracing_import(self, node, module: str) -> None:
        self._emit("tracing-in-jit", node,
                   f"{self.path}: models/kernels/parallel must not import "
                   f"the flight recorder ({module}) — tracing is wired "
                   "around the model calls, never inside")

    # ---- imports: kernel-import-boundary, tracing-in-jit ------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if "kernel-import-boundary" in self.rules and \
                    alias.name.rsplit(".", 1)[-1] in _KERNEL_MODULES:
                self._emit("kernel-import-boundary", node,
                           f"direct import of kernel module "
                           f"{alias.name!r} — go through "
                           "repro_torch.kernels.engine (qmatmul)")
            if "tracing-in-jit" in self.rules and self._in_jit_land() \
                    and alias.name == _TRACING_MODULE:
                self._tracing_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if "kernel-import-boundary" in self.rules and mod:
            tail = mod.rsplit(".", 1)[-1]
            hits = [mod] if tail in _KERNEL_MODULES else \
                [f"{mod}.{a.name}" for a in node.names
                 if a.name in _KERNEL_MODULES]
            for m in hits:
                self._emit("kernel-import-boundary", node,
                           f"direct import from kernel module {m!r} — go "
                           "through repro_torch.kernels.engine (qmatmul)")
        if "tracing-in-jit" in self.rules and self._in_jit_land() and (
                mod == _TRACING_MODULE or (
                    mod == _TRACING_MODULE.rsplit(".", 1)[0]
                    and any(a.name == "tracing" for a in node.names))):
            self._tracing_import(node, mod)
        self.generic_visit(node)

    # ---- function scope (hot-loop rule) -----------------------------------
    def _visit_fn(self, node) -> None:
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _in_hot_loop(self) -> bool:
        return any(name in _HOT_LOOP_FNS
                   or name.startswith(_HOT_LOOP_PREFIXES)
                   for name in self._fn_stack)

    # ---- calls -------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        kw_names = {kw.arg for kw in node.keywords if kw.arg}
        if "batcher-config-bypass" in self.rules and name in _BATCHERS:
            if len(node.args) < 3 and "config" not in kw_names:
                self._emit("batcher-config-bypass", node,
                           f"{name}() constructed without a ServingConfig "
                           "(pass it as the third argument or config=)")
        if "device-get-in-hot-loop" in self.rules and self._in_hot_loop():
            sync = _host_sync(node)
            if sync is not None:
                self._emit("device-get-in-hot-loop", node,
                           f"{sync} inside hot loop "
                           f"{'.'.join(self._fn_stack)}() — a host sync "
                           "serializes the device; batch transfers outside "
                           "the loop")
        if "tracing-in-jit" in self.rules and self._in_jit_land() \
                and _is_tracer_call(node):
            self._emit("tracing-in-jit", node,
                       f"tracer call in {self.path}: the flight recorder "
                       "stays out of models/kernels/parallel")
        self.generic_visit(node)


def lint_source(src: str, path: str, rules=None) -> list[Finding]:
    """Lint one file's source text.  ``rules`` defaults to every AST rule;
    exemptions are NOT applied here (callers own path policy)."""
    rules = tuple(rules) if rules is not None else AST_RULES
    unknown = [r for r in rules if r not in AST_RULES]
    if unknown:
        raise KeyError(f"unknown AST rule(s) {unknown}; known: "
                       f"{sorted(AST_RULES)}")
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(rule="syntax-error", step=f"{path}:{e.lineno or 0}",
                        message=str(e))]
    v = _Visitor(path, rules)
    v.visit(tree)
    return v.findings


def _iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git", ".venv")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths, *, repo_root: str | None = None) -> list[Finding]:
    """Lint files/directories with every rule, each but where
    :data:`DEFAULT_EXEMPT` exempts its path.  Paths in findings are
    repo-root-relative."""
    repo_root = repo_root or os.getcwd()
    findings: list[Finding] = []
    files: list[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(repo_root, p)
        if os.path.isdir(full):
            files.extend(_iter_py_files(full))
        elif os.path.isfile(full):
            files.append(full)
    for f in files:
        rel = os.path.relpath(f, repo_root).replace(os.sep, "/")
        active = tuple(r for r in AST_RULES
                       if not any(rel.startswith(pfx)
                                  for pfx in DEFAULT_EXEMPT.get(r, ())))
        if not active:
            continue
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        findings.extend(lint_source(src, rel, rules=active))
    return findings


def default_lint_roots(repo_root: str) -> list[str]:
    """The sources the linter covers by default: the port's package and
    its tests."""
    roots = ["src/repro_torch"] if os.path.isdir(
        os.path.join(repo_root, "src/repro_torch")) else []
    tests = os.path.join(repo_root, "tests")
    if os.path.isdir(tests):
        roots += sorted(f"tests/{n}" for n in os.listdir(tests)
                        if n.startswith(("test_torch_", "torch_"))
                        and n.endswith(".py"))
    return roots

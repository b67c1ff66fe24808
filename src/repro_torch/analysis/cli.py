"""``python -m repro_torch.analysis audit`` — the front door
(``repro.analysis.cli``).

Runs both passes over the serving config matrix:

  * the contract checker: every serving step of every {cell, mesh}, run
    once under the recorders and held to its rules
    (:mod:`~repro_torch.analysis.steps`, :mod:`~repro_torch.analysis.rules`);
  * the AST architecture linter over the port's sources,

then prints a summary and exits non-zero on any finding.  ``--json``
writes the report.  ``--device`` picks where the cells run: the card
(``cuda``, the default), where the card-only rules bind, or the host with
``--device cpu``, where those rules are listed as not bound.  As the
launcher, the audit refuses to start when no card is visible and
``--device cpu`` was not given: a run that cannot bind the kernel rules
says so by its exit code.  A mesh of several ranks is spawned, one process
a rank::

    PYTHONPATH=src python -m repro_torch.analysis audit --mesh 1,1 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.analysis audit \\
        --configs tp-d1024 --mesh 1,2 --no-lint --device cpu
    PYTHONPATH=src python -m repro_torch.analysis lint
"""
from __future__ import annotations

import argparse
import os
import sys


def _parse_mesh(spec: str):
    if spec in ("none", "null"):
        return None
    d, m = spec.split(",")
    return (int(d), int(m))


def _repo_root() -> str:
    # src/repro_torch/analysis/cli.py -> the repo root holds src/
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    return os.path.dirname(root) if os.path.basename(root) == "src" else root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="checks of the kernel, sharding and precision "
                    "contracts of the serving steps, and of the sources")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_audit = sub.add_parser(
        "audit", help="run every serving step of the config matrix under "
                      "the recorders and lint the sources")
    ap_audit.add_argument(
        "--configs", nargs="*", default=None, metavar="CELL",
        help="audit cell names (default: the full matrix; see "
             "repro_torch.analysis.steps.CELLS)")
    ap_audit.add_argument(
        "--mesh", nargs="*", default=None, metavar="D,M",
        help='mesh shapes like "2,1" (or "none"); default: each cell\'s '
             "own mesh list; a single-host cell runs with no mesh")
    ap_audit.add_argument("--json", nargs="?", const="-", default=None,
                          metavar="PATH", help="write the JSON report "
                          "(PATH, or stdout with no value)")
    ap_audit.add_argument("--no-lint", action="store_true",
                          help="skip the AST architecture linter pass")
    ap_audit.add_argument("--no-steps", action="store_true",
                          help="skip the contract checker pass")
    ap_audit.add_argument("--device", default="cuda",
                          help="cuda (default; refused when no card is "
                               "visible) | cpu")

    ap_lint = sub.add_parser("lint", help="run only the AST linter")
    ap_lint.add_argument("paths", nargs="*", default=None)

    args = ap.parse_args(argv)
    if args.cmd == "audit" and not args.no_steps \
            and args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("audit --device cuda: no CUDA device is visible, so the "
                  "kernel rules cannot bind (pass --device cpu to audit the "
                  "plain versions on the host)", file=sys.stderr)
            return 2
    from .report import Report
    report = Report()
    root = _repo_root()

    if args.cmd == "lint" or (args.cmd == "audit" and not args.no_lint):
        from . import astlint
        paths = getattr(args, "paths", None) or \
            astlint.default_lint_roots(root)
        report.extend(astlint.lint_paths(paths, repo_root=root),
                      cell="astlint")
        report.checked.append({"cell": "astlint", "paths": list(paths),
                               "rules": list(astlint.AST_RULES)})

    if args.cmd == "audit" and not args.no_steps:
        from .steps import CELLS, audit_cell, cell_by_name
        device = args.device
        cells = ([cell_by_name(n) for n in args.configs]
                 if args.configs else list(CELLS))
        meshes_override = ([_parse_mesh(m) for m in args.mesh]
                           if args.mesh else None)
        cache: dict = {}
        for cell in cells:
            meshes = meshes_override if meshes_override is not None \
                else list(cell.meshes)
            for mesh_shape in meshes:
                label = f"{cell.name}@{mesh_shape}"
                print(f"[audit] {label} on {device} ...", flush=True)
                findings, checked = audit_cell(cell, mesh_shape,
                                               device=device, _cache=cache)
                report.extend(findings, cell=label)
                report.checked.extend(checked)

    out_json = getattr(args, "json", None)
    if out_json == "-":
        print(report.to_json())
    elif out_json:
        with open(out_json, "w", encoding="utf-8") as f:
            f.write(report.to_json() + "\n")
        print(f"[audit] report written to {out_json}")
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":          # pragma: no cover - exercised via -m
    raise SystemExit(main())

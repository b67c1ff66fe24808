"""Helpers of the benchmark's tests: a temporary checkout to run the
harness in on the CPU, and small configurations and mixes."""
from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def tiny_mix(batch: int, **kw) -> dict:
    mix = {"loop": "closed", "clients": 1, "batch": batch, "pool_batches": 2,
           "images": "standard_normal", "warmup_s": 0.0, "trace_batches": 2,
           "sample_batches": 3, "why": "a test's mix"}
    mix.update(kw)
    return mix


def checkout(tmp_path: Path, workloads: list[dict], mixes: dict,
             configs: dict | None = None, per_layer: list | None = None,
             files: dict | None = None) -> Path:
    """A checkout in ``tmp_path``: a copy of ``bench/`` (its tests left
    out), the port's sources linked, and a ``BENCHMARK.json`` naming
    ``workloads``.  ``mixes``: ``{name: mix}`` written to ``traffic/``;
    ``configs``: ``{name: (config, adapter source file)}`` written to
    ``configs/``; ``files``: further ``{relative path: text}``."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, mix in mixes.items():
        (root / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for name, (cfg, adapter) in (configs or {}).items():
        (root / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        shutil.copy(BENCH / "configs" / f"{adapter}.py",
                    root / "bench" / "configs" / f"{name}.py")
        manifest["configs"].append(
            {"name": name, "source": "https://arxiv.org/abs/1512.03385",
             "file": f"bench/configs/{name}.json", "reduced": [],
             "why": "a test's configuration"})
    for rel, text in (files or {}).items():
        (root / rel).write_text(text)
    manifest["workloads"] = workloads
    if per_layer is not None:
        manifest["per_layer"] = per_layer
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def harness(root: Path):
    """The harness of the checkout ``root`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"bench_run_{abs(hash(str(root)))}", root / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resnet_tiny(size: int = 32) -> dict:
    """ResNet-34 at 2xT at the published widths on ``size`` x ``size``
    images: a test's configuration."""
    cfg = json.loads((BENCH / "configs" / "resnet34-2xT.json").read_text())
    cfg["input_shape"] = [size, size, 3]
    return cfg

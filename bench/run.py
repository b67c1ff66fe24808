#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  ``BENCHMARK.json`` at the root names the cell's configuration and
traffic mix; each is a file of its own under ``bench/`` that this finds by
name (``configs/<config>.json`` with its adapter ``configs/<config>.py``,
``traffic/<mix>.json``, ``metrics/<metric>.py``, ``reference/<name>.py``).

A run: the float weights and the input pool drawn on the card from the
seed; the program's set-up (packing); a warm-up of ``warmup_s`` seconds of
batches; with ``--trace 1`` a traced slice of ``trace_batches`` batches;
the measured window of ``--seconds``; then, the program's state freed, the
reference over the sampled batches' inputs and the comparison that decides
``correct``.  The last line of standard output is one JSON object; the
compared numbers with their limits are the last lines of standard error
and the last key of that object.

Exits 2 without a result when there is no card (or fewer than the cell
asks for), when the checkout holds no ``src/repro_torch``, and 3 when the
process holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import devtrace  # noqa: E402
import judge  # noqa: E402
import loadgen  # noqa: E402
import weights  # noqa: E402

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# warm-up batches inside the profiler before the traced slice
PROFILER_WARMUP = 2
GIB = 2 ** 30


class Refused(Exception):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {kind} file {path.relative_to(ROOT)}", 2)
    mod_name = f"bench_{kind}_" + "".join(c if c.isalnum() else "_"
                                          for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Cell:
    """One workload of ``BENCHMARK.json``: its entries, files and modules."""

    def __init__(self, workload: str):
        self.manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
        found = [w for w in self.manifest["workloads"]
                 if w["name"] == workload]
        if not found:
            raise Refused(f"no workload {workload!r} in BENCHMARK.json", 2)
        self.workload = found[0]
        entry = [c for c in self.manifest["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.cfg = json.loads((ROOT / entry["file"]).read_text())
        self.mix = loadgen.load(BENCH / "traffic"
                                f"/{self.workload['traffic']}.json")
        self.adapter = load_module("configs", entry["name"])
        self.reference = load_module("reference", self.cfg["reference"])
        self.layers = [layer for _, layer in
                       self.adapter.walk(self.cfg, self.mix.batch)]

    def metrics(self, section: str) -> list[dict]:
        """The manifest's metrics of ``section`` that this cell reports."""
        return [m for m in self.manifest[section]
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]


def prepare_environment():
    """Caches inside the checkout at fixed paths, the port importable."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise Refused("the checkout holds no src/repro_torch", 2)
    cache = BENCH / ".cache"
    os.environ["REPRO_TUNING_CACHE"] = str(cache / "tuning.json")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))


def pick_device(chips: int, need_card: bool):
    import torch
    if not need_card:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: torch.cuda.is_available() is false", 2)
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} visible", 2)
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(forward, pool, seconds: float, device) -> int:
    """Batches for ``seconds`` (two at least): every kernel built and
    loaded, the allocator and the clocks settled."""
    n, start = 0, time.perf_counter()
    while n < 2 or time.perf_counter() - start < seconds:
        forward(pool[n % len(pool)]).cpu()
        n += 1
    sync(device)
    return n


def traced_slice(forward, pool, batches: int, device) -> devtrace.Trace:
    """``batches`` batches under ``torch.profiler``, each in the harness's
    spans; two unmarked batches first, as the profiler's own warm-up."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for i in range(PROFILER_WARMUP):
            forward(pool[i % len(pool)]).cpu()
        for i in range(batches):
            with record_function(devtrace.BATCH):
                with record_function(devtrace.PICK):
                    x = pool[i % len(pool)]
                with record_function(devtrace.FORWARD):
                    y = forward(x)
                with record_function(devtrace.SYNC):
                    y.cpu()
        sync(device)
    return devtrace.from_profile(prof)


def window(forward, pool, seconds: float, sample: loadgen.Reservoir):
    """The measured window: batches back to back until ``seconds`` have
    passed; each timed from the call to its logits on the host.  Returns
    (batch seconds, window seconds, batches of the wrong shape)."""
    times, bad = [], 0
    start = end = time.perf_counter()
    i = 0
    while end - start < seconds:
        x = pool[i % len(pool)]
        t = time.perf_counter()
        out = forward(x).cpu()
        end = time.perf_counter()
        times.append(end - t)
        if out.shape[0] != x.shape[0]:
            bad += 1
        sample.offer(i, out)
        i += 1
    return times, end - start, bad


def p95(values: list[float]) -> float:
    """The 95th percentile, nearest rank."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30, check=False)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None


def reference_logits(cell: Cell, seed: int, pool, indices, device,
                     tf32: bool = False, checksum: float | None = None):
    """The reference's logits of each pool batch in ``indices``, from the
    float weights drawn again from the seed (held to the first draw by
    ``checksum``)."""
    import torch
    flat = cell.adapter.draw(cell.cfg, seed, device)
    if checksum is not None and weights.checksum(flat) != checksum:
        raise RuntimeError("the weights drawn again differ from set-up's")
    with torch.no_grad():
        out = {j: cell.reference.forward(flat, pool[j], cell.cfg, tf32=tf32
                                         ).cpu() for j in sorted(indices)}
    del flat
    return out


def run(args, need_card: bool = True, wrap=None) -> dict:
    """One run; returns the result object.  ``wrap`` (tests) takes the
    program's forward and returns the one the window drives."""
    cell = Cell(args.workload)
    prepare_environment()
    import torch
    device = pick_device(int(cell.workload["chips"]), need_card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.set_num_threads(1)
    mix = cell.mix

    flat = cell.adapter.draw(cell.cfg, args.seed, device)
    drawn = weights.checksum(flat)
    state = cell.adapter.prepare(flat, cell.cfg)
    del flat
    pool = loadgen.make_pool(mix, cell.cfg["input_shape"], args.seed, device)

    def forward(x):
        return cell.adapter.forward(state, x, cell.cfg)

    if wrap is not None:
        forward = wrap(forward)
    with torch.no_grad():
        warm_up(forward, pool, mix.warmup_s, device)
        trace = traced_slice(forward, pool, mix.trace_batches, device) \
            if args.trace else None
        setup_peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - T0
        sample = loadgen.Reservoir(mix.sample_batches, args.seed)
        times, window_s, bad = window(forward, pool, args.seconds, sample)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
    del state, forward
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kept = sample.items
    ref = reference_logits(cell, args.seed, pool,
                           {i % len(pool) for i in kept}, device,
                           checksum=drawn)
    order = sorted(kept)
    gap = judge.logit_gap([kept[i].numpy() for i in order],
                          [ref[i % len(pool)].numpy() for i in order])
    correct, checks = judge.decide({"logit_gap": gap},
                                   cell.cfg["limits"])
    failed = mix.batch * (bad + sum(
        1 for i in order if not torch.isfinite(kept[i]).all()))
    images_per_s = mix.batch * len(times) / window_s

    loaded = sorted({m.split(".")[0] for m in sys.modules} &
                    set(FORBIDDEN))
    if loaded:
        raise Refused("the process holds " + ", ".join(loaded) +
                      " after the window", 3)

    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": card, "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(max(setup_peak, peak))}
    limit = power_limit() if device.type == "cuda" else None
    if limit:
        dev["power"] = limit
    result = {"correct": correct, "attempted": mix.batch * len(times),
              "failed": failed, "metrics": {}, "device": dev}
    if args.trace:
        lo, hi, _ = devtrace.window(trace)
        dev["busy_s"] = devtrace.busy_us(trace) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        run_ = devtrace.Run(trace, cell.layers, mix.batch, images_per_s,
                            devtrace.port_kernels(ROOT / "src" / "repro_torch"
                                                  / "csrc"))
        for m in cell.metrics("per_layer"):
            value = load_module("metrics", m["name"]).read(run_)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = devtrace.breakdown(trace)
    else:
        known = {"images_per_s": images_per_s,
                 "batch_p95_ms": 1e3 * p95(times),
                 "peak_mem_gib": peak / GIB,
                 "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": known[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.metrics("end_to_end")}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = run(args)
    except Refused as e:
        print(f"bench: {e}", file=sys.stderr)
        return e.code
    line = json.dumps(result)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

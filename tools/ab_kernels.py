#!/usr/bin/env python3
"""Kernels timed in two checkouts on one card, alternately: a before /
after reading of a kernel change.

    python3 tools/ab_kernels.py --before DIR [--rounds 2] [--set NAME]

``DIR`` is another checkout (for example ``git archive`` of the parent
commit unpacked into ``build/``).  Each round runs ``--time`` in ``DIR``,
in this checkout, in this checkout and in ``DIR`` again, each in a
process of its own that builds the two kernels from its own checkout's
sources (``build/repro_torch/`` of that checkout).  A process times, each
``REPS`` times with ``chip_smoke.time_ms`` (CUDA-graph replay, medians of
CUDA-event samples):

- B4 at phase 3's serving shape (kv8, an f32 wo of (576, 576), the 4
  slots live), ``chip_smoke._fused_decode_record``'s timed call;
- B8 bf16 at gemma2's whole prefill (B 1, S 4608, KV 16, G 2, Dh 128,
  causal, window 4096, softcap 50), a causal prefill at glm4's heads (B 1,
  S 2048, KV 2, G 16, Dh 128) and phase 3's record shape (B 2, S 2048,
  KV 3, G 3, Dh 64).

That is ``--set attention`` (the default).  ``--set act_quant`` times the
activation quantizers, bf16 at 2 bits, through calls both checkouts have:

- B7a ``act_quant`` and B7b ``act_quant_signed`` (one given scale) at
  phase 3's record shape (25088, 64) and at ResNet-34's stem rows at batch
  32, (401408, 64), past the L2;
- the whole ``core.act_quant_codes_signed`` call at (4, 576) and
  (25088, 64);
- B7c's row form over one layer's seven decode quantizations (phase 3's
  record of B7c).

Prints the card, each process's times, and per checkout and shape the
median, minimum and maximum over all its samples; the build report's
register and spill lines.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS = 5
# B8 shapes: (label, B, S, KV, G, Dh, window, softcap)
FLASH = (("gemma2 S 4608 window + softcap, Dh 128", 1, 4608, 16, 2, 128,
          4096, 50.0),
         ("glm4 heads causal S 2048, Dh 128", 1, 2048, 2, 16, 128, 0, 0.0),
         ("record: forward S 2048, Dh 64", 2, 2048, 3, 3, 64, 0, 0.0))


def _time_act_quant(cs, device) -> dict:
    """The ``--set act_quant`` times, by call and shape."""
    import importlib
    import torch
    from repro_torch.core import act_quant_codes_signed
    aq = importlib.import_module("repro_torch.kernels.act_quant")
    gen = torch.Generator().manual_seed(0)
    out = {}
    for m, f in ((8 * 56 * 56, 64), (32 * 112 * 112, 64)):
        x = (torch.randn((m, f), generator=gen) * 2).to(device, torch.bfloat16)
        xu = torch.relu(x) / 4
        s = x.abs().amax().clamp_min(1e-8).reshape(1)       # / qmax = 1
        out[f"B7a act_quant ({m}, {f}) bf16"] = [cs.time_ms(
            lambda: aq.act_quant(xu, bits=2, compute_dtype=torch.bfloat16))[0]
            for _ in range(REPS)]
        out[f"B7b act_quant_signed ({m}, {f}) bf16"] = [cs.time_ms(
            lambda: aq.act_quant_signed(x, s, bits=2,
                                        compute_dtype=torch.bfloat16))[0]
            for _ in range(REPS)]
    for m, f in ((4, 576), (8 * 56 * 56, 64)):
        x = (torch.randn((m, f), generator=gen) * 2).to(device, torch.bfloat16)
        out[f"core.act_quant_codes_signed ({m}, {f}) bf16"] = [cs.time_ms(
            lambda: act_quant_codes_signed(x, 2))[0] for _ in range(REPS)]
        if hasattr(aq, "act_quant_signed_tensor"):     # B7b's tensor form
            out[f"B7b tensor form ({m}, {f}) bf16"] = [cs.time_ms(
                lambda: aq.act_quant_signed_tensor(x, bits=2))[0]
                for _ in range(REPS)]
    rows = [(torch.randn((m, f), generator=gen) * 2).to(device, torch.bfloat16)
            for m, f in cs.QUANT_DECODE_ROWS]
    out["B7c row form, one layer's 7 decode quantizations, bf16"] = [
        sum(cs.time_ms(lambda: aq.act_quant_signed_rows(x, bits=2))[0]
            for x in rows) for _ in range(REPS)]
    return out


def time_checkout(root: Path, which: str) -> dict:
    """The times of one process in checkout ``root``, by shape."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    device = torch.device("cuda", 0)
    if which == "act_quant":
        out = _time_act_quant(cs, device)
    else:
        out = _time_attention(cs, device)
    regs = [f"{name}: {line.strip()}"
            for name, log in sorted(_build.BUILD_LOG.items())
            for line in log.splitlines()
            if "registers" in line or "spill" in line]
    return {"times": out, "build": regs}


def _time_attention(cs, device) -> dict:
    """The ``--set attention`` times, by kernel and shape."""
    import torch
    from repro_torch.kernels.decode_fused import fused_decode
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator().manual_seed(0)
    args = cs._paged_operands(gen, device, 8)
    wo = (torch.randn((args[0][0].numel(), cs.D_MODEL), generator=gen)
          / 24).to(device)
    sm = torch.arange(cs.N_SLOTS, dtype=torch.int32, device=device)
    out = {"B4 phase 3 serving shape, kv8": [
        cs.time_ms(lambda: fused_decode(*args, sm, wo, kv_bits=8))[0]
        for _ in range(REPS)]}
    for label, b, s, kv, g, dh, window, softcap in FLASH:
        q = torch.randn((b, s, kv, g, dh), generator=gen).to(device,
                                                             torch.bfloat16)
        k, v = (torch.randn((b, s, kv, dh), generator=gen).to(device,
                                                              torch.bfloat16)
                for _ in range(2))
        fn = lambda: flash_attention(q, k, v, causal=True, window=window,
                                     softcap=softcap)
        check = fn()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(check).all()):
            raise SystemExit(f"B8 {label}: non-finite output")
        out[f"B8 bf16 {label}"] = [cs.time_ms(fn, reps=5)[0]
                                   for _ in range(REPS)]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--set", default="attention",
                    choices=("attention", "act_quant"))
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.time is not None:
        print(json.dumps(time_checkout(a.time.resolve(), a.set)))
        return
    if a.before is None:
        ap.error("--before DIR is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    roots = {"before": a.before.resolve(), "after": HERE}
    samples, shown = {"before": {}, "after": {}}, set()
    for rnd in range(a.rounds):
        for side in ("before", "after", "after", "before"):
            env = dict(os.environ, PYTHONPATH="")
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--time",
                 str(roots[side]), "--set", a.set], capture_output=True,
                text=True, env=env,
                cwd=roots[side])
            if res.returncode:
                sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
                raise SystemExit(f"{side} ({roots[side]}): exit "
                                 f"{res.returncode}")
            got = json.loads(res.stdout.strip().splitlines()[-1])
            if side not in shown:
                shown.add(side)
                for line in got["build"]:
                    print(f"  {side} build: {line}")
            for shape, ts in got["times"].items():
                samples[side].setdefault(shape, []).extend(ts)
                print(f"[{card}] round {rnd} {side}: {shape}: "
                      + ", ".join(f"{t:.5f}" for t in ts) + " ms", flush=True)
    for shape in samples["after"]:
        if shape not in samples["before"]:
            ts = samples["after"][shape]
            print(f"[{card}] {shape}: after median {statistics.median(ts):.5f} "
                  f"ms (min {min(ts):.5f}, max {max(ts):.5f}, n {len(ts)}); "
                  "not in the other checkout")
            continue
        row = []
        for side in ("before", "after"):
            ts = samples[side][shape]
            row.append(f"{side} median {statistics.median(ts):.5f} ms "
                       f"(min {min(ts):.5f}, max {max(ts):.5f}, n {len(ts)})")
        ratio = (statistics.median(samples["after"][shape])
                 / statistics.median(samples["before"][shape]))
        print(f"[{card}] {shape}: " + "; ".join(row)
              + f"; after / before {ratio:.4f}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The paged kernels alone: B2 ``paged_attention`` and B4 ``fused_decode``
built, checked against their plain versions and timed, as ``chip_smoke.py``
phase 3 does (its own functions), without the serving phases.

    python3 tools/bench_paged.py

Prints each kernel's build report (registers, spills), the serving-shape
and long-context checks and times, kv8 / kv16, and the cluster-size x
span-limit sweep of ``csrc/paged_attention.cu``.  Needs a CUDA device and
nvcc; exits non-zero on a failed check.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: needs a GPU")
    from repro_torch.kernels import _build
    device = torch.device("cuda", 0)
    card = chip_smoke.phase_env()
    t0 = time.time()
    for name in ("paged_attention", "decode_fused"):
        _build.library(name)
    print(f"built paged_attention, decode_fused in {time.time() - t0:.1f} s")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"  {name}: {line.strip()}")
    gen = torch.Generator().manual_seed(0)
    for rec in (chip_smoke._paged_attention_record(gen, device),
                chip_smoke._fused_decode_record(gen, device)):
        print(f"[{card}] {rec}")
    fused_ablation(gen, device, card)


def fused_ablation(gen, device, card) -> None:
    """B4 at the serving shape, L = 4, whole and without each half, with
    and without the staged wo slice, and a per-phase cycle trace
    (``fused_decode_variant`` bits): where its time goes."""
    import torch
    from repro_torch.kernels import _build
    q, k, ks, v, vs, pt, pos = chip_smoke._paged_operands(gen, device, 8)
    wo = (torch.randn((q[0].numel(), chip_smoke.D_MODEL), generator=gen)
          / 24).to(device)
    sm = torch.arange(chip_smoke.N_SLOTS, dtype=torch.int32, device=device)
    out = torch.empty((sm.numel(), wo.shape[1]), device=device)
    lib = _build.library("decode_fused")

    def run(variant, span=0):
        _build.check(lib.fused_decode_variant(
            q.data_ptr(), 2, k.data_ptr(), ks.data_ptr(), v.data_ptr(),
            vs.data_ptr(), 0, pt.data_ptr(), pos.data_ptr(), sm.data_ptr(),
            wo.data_ptr(), out.data_ptr(), q.shape[0], sm.numel(), k.shape[0],
            k.shape[1], pt.shape[1], q.shape[1], q.shape[2], q.shape[3],
            wo.shape[1], variant, span, _build.stream_ptr(q)),
            "fused_decode_variant")
    for span in (8, 16, 32):
        print(f"[{card}] fused_decode kv8 L=4 span limit {span}: "
              f"{chip_smoke.time_ms(lambda: run(0, span))[0]:.5f} ms")
    times = {name: chip_smoke.time_ms(lambda v=v: run(v))[0]
             for name, v in (("whole", 0), ("no projection", 1),
                             ("no attention", 2), ("neither", 3),
                             ("whole, wo unstaged", 4),
                             ("no projection, unstaged", 5),
                             ("no attention, unstaged", 6),
                             ("neither, unstaged", 7))}
    print(f"[{card}] fused_decode kv8 L=4 ablation (ms): " +
          ", ".join(f"{n} {t:.5f}" for n, t in times.items()))
    # cycles since each block's start at its phase ends (variant bit 8)
    phases = ("wo issued", "q staged", "attention", "merged and pushed",
              "cluster sync 1", "attention rows", "wo landed", "projection",
              "sums pushed", "cluster sync 2", "end")
    dc = -(-wo.shape[1] // 8 // 4) * 4
    for variant, label in ((8, "staged"), (12, "unstaged")):
        for _ in range(3):
            run(variant)
        torch.cuda.synchronize()
        t = out.reshape(sm.numel(), -1)[:, :8 * dc].reshape(sm.numel(), 8, dc)
        span_t = t[:, :, 11:16].cpu()        # warp 0's first span, if any
        t = t[:, :, :len(phases)].cpu()
        med = t.reshape(-1, len(phases)).median(dim=0).values
        mx = t.reshape(-1, len(phases)).max(dim=0).values
        print(f"[{card}] fused_decode trace ({label}; cycles since block "
              f"start, median / max over the {sm.numel() * 8} blocks): " +
              ", ".join(f"{p} {a:.0f}/{b:.0f}" for p, a, b in
                        zip(phases, med.tolist(), mx.tolist())))
        # slot 0 (80 positions): ranks 0-2 hold head 0-2's first span
        for r in range(3):
            print(f"  slot 0 rank {r} warp 0, first span: " + ", ".join(
                f"{p} {v:.0f}" for p, v in zip(
                    ("operands in flight", "rows staged", "scores", "softmax",
                     "P.V"), span_t[0, r].tolist())))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""B5 ``decode_attention`` and B8 ``flash_attention`` alone: built, checked
against their plain versions and timed, without the serving phases.

    python3 tools/bench_attention.py [--flash-time-only | --step-seeds N]

The checks and times are ``chip_smoke.py``'s own (``_attention_record``:
B5 at the dense serving step and at 2048 positions; ``_flash_record``: B8
in f32 and bf16 on ``chip_smoke.FLASH_CASES``).  Then B5's error against a
float64 evaluation over 200 random f32 steps, and ``chip_smoke.py``'s fp32
decode-step check alone (weights from seed 0).  ``--step-seeds N`` runs
only that check, once for each weight seed 0 .. N-1; ``--flash-time-only``
times B8 f32 at the forward shape and checks nothing (for ablated copies of
the kernel).  It runs the checkout it lies in, so a copy of it in another
checkout measures that checkout's kernels.  Needs a CUDA device and nvcc;
exits non-zero on a failed check.
"""
from __future__ import annotations

import importlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def decode_error_stats(gen, device, card, n: int = 200) -> None:
    """B5's distance from its f32 plain version and from a float64
    evaluation of the same formula, over ``n`` random f32 decode steps at
    the serving shape (f32 q, as the fp32 model sends): medians and maxima
    of max |diff| / max |out|."""
    import statistics
    import torch
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    b, kv, g, dh, s = (chip_smoke.N_SLOTS, chip_smoke.KV_HEADS, chip_smoke.GROUP,
                       chip_smoke.DH, chip_smoke.S_MAX)
    rows = {"kernel - plain": [], "kernel - f64": [], "plain - f64": []}
    for _ in range(n):
        q = torch.randn((b, kv, g, dh), generator=gen).to(device)
        kc, vc = (torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                                dtype=torch.int8).to(device) for _ in range(2))
        ks, vs = ((torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3).to(device)
                  for _ in range(2))
        pos = torch.randint(0, s, (b,), generator=gen, dtype=torch.int32).to(device)
        args = (q, kc, ks, vc, vs, pos)
        out, ref = da.decode_attention(*args), da.decode_attention_ref(*args)
        kd, vd = kc.double() * ks.double(), vc.double() * vs.double()
        sc = torch.einsum("bkgd,bskd->bkgs", q.double(), kd) / dh ** 0.5
        live = torch.arange(s, device=device)[None, :] <= pos[:, None].long()
        sc = sc.masked_fill(~live[:, None, None, :], float("-inf"))
        exact = torch.einsum("bkgs,bskd->bkgd", torch.softmax(sc, -1), vd)
        scale = exact.abs().max().item()
        for name, a, c in (("kernel - plain", out, ref), ("kernel - f64", out, exact),
                           ("plain - f64", ref, exact)):
            rows[name].append((a.double() - c.double()).abs().max().item() / scale)
    print(f"[{card}] decode_attention f32 q, {n} random steps (B={b} S={s}), "
          "max |diff| / max|out|: " + "; ".join(
              f"{k} median {statistics.median(v):.3e} max {max(v):.3e}"
              for k, v in rows.items()))


def fp32_step(device, card, seeds=(0,)) -> None:
    """chip_smoke phase 4's fp32 decode-step check alone (smollm-135m at
    full width, fp32 weights, kv8, random weights from each seed): the
    logits of one decode step through the kernels against the plain
    versions, and between two plain versions that differ only in summation
    order (the attention kernel's f32 plain version against the serving
    version), the size of a rounding-only difference after 30 layers."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.serving import ServingConfig
    cfg = chip_smoke.model_config(precision="fp32", kv_bits=8, dtype="float32")
    model = build_model(cfg)
    sc = ServingConfig(n_slots=chip_smoke.N_SLOTS, s_max=chip_smoke.S_MAX,
                       chunk_size=chip_smoke.CHUNK)
    prompt = chip_smoke._requests(cfg, 1, chip_smoke.GEN)[0].tokens
    for seed in seeds:
        params = model.init(torch.Generator().manual_seed(seed), device)
        c = chip_smoke._compare_backends(model, params, sc, prompt, device)
        tol = 1e-4 * c["scale"]
        print(f"[{card}] fp32 decode step, weight seed {seed}, kernels vs plain "
              f"versions: max |dlogit| {c['decode']:.3e} ({c['decode'] / tol:.3f} "
              f"of the 1e-4 * max|logit| bound); layer 0 attention "
              f"{c['attn0']:.3e}; two plain versions (summation order only): "
              f"max |dlogit| {c['dequant']:.3e} ({c['dequant'] / tol:.3f} of "
              f"the bound)", flush=True)
        del params
        torch.cuda.empty_cache()


def flash_time_only(gen, device, card) -> None:
    """B8 f32 at the forward shape, timed and not checked: for copies of
    the kernel with parts of its arithmetic taken out (ablations)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    b, s, kv, g, dh = 2, 2048, chip_smoke.KV_HEADS, chip_smoke.GROUP, chip_smoke.DH
    q = torch.randn((b, s, kv, g, dh), generator=gen).to(device)
    k, v = (torch.randn((b, s, kv, dh), generator=gen).to(device) for _ in range(2))
    tk, _ = chip_smoke.time_ms(lambda: flash_attention(q, k, v), reps=5)
    print(f"[{card}] flash_attention f32 forward B={b} S={s} KV={kv} G={g} Dh={dh} "
          f"(time only, unchecked): kernel {tk:.4f} ms")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: needs a GPU")
    from repro_torch.kernels import _build
    device = torch.device("cuda", 0)
    print(f"== {ROOT}", flush=True)
    card = chip_smoke.phase_env()
    if "--flash-time-only" in sys.argv:
        flash_time_only(torch.Generator().manual_seed(0), device, card)
        return
    t0 = time.time()
    _build.build_all()
    print(f"built every kernel in {time.time() - t0:.1f} s", flush=True)
    if "--step-seeds" in sys.argv:
        n = int(sys.argv[sys.argv.index("--step-seeds") + 1])
        fp32_step(device, card, range(n))
        return
    for name, log in sorted(_build.BUILD_LOG.items()):
        if name not in ("decode_attention", "flash_attention"):
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"  {name}: {line.strip()}")
    gen = torch.Generator().manual_seed(0)
    for record in (chip_smoke._attention_record, chip_smoke._flash_record):
        print(f"[{card}] record {record(gen, device)}", flush=True)
    decode_error_stats(gen, device, card)
    fp32_step(device, card)


if __name__ == "__main__":
    main()

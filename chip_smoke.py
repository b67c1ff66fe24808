#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel of the serving path, built from
     ``src/repro_torch/csrc`` with nvcc (one process per source, in
     parallel), with its time;
  3. kernels against their plain PyTorch versions at the serving path's
     shapes, with the kernel's time, the plain version's time, one PyTorch
     library call's time (a yardstick the port never calls) and the least
     time the card could take (bytes over memory rate, or operations over
     peak rate, whichever is larger);
  4. the serving path at full width: smollm-135m, 2xT weights/activations,
     int8 KV cache, bf16, random weights from seed 0, served by the
     continuous batcher (8 requests over 4 slots); the kernel launch counts
     of that run; one prefill chunk and one decode step through the kernels
     against the same calls through the plain versions; a shorter 4x4 run
     for the packed kernel;
  5. decode steps of the 2xT path under ``torch.profiler``: device
     operations per step, device busy time and idle share.
The last lines are the per-kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository checkout around it; it imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM3 bytes/s, int8 tensor ops/s, and
# f32 outside the tensor cores.
MEM_BW = 3.35e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12

SMOLLM_DECODE_PROJ = (            # (N, K) of one layer's seven projections
    (576, 576), (192, 576), (192, 576), (576, 576),      # wq wk wv wo
    (1536, 576), (1536, 576), (576, 1536))               # w_gate w_up w_down
MAIN_SHAPES = sorted(set(SMOLLM_DECODE_PROJ))
N_SLOTS, CHUNK, PROMPT, GEN, N_REQ = 4, 32, 64, 16, 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _event_ms(run, iters: int) -> float:
    import torch
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms(fn, iters: int = 20, reps: int = 20) -> tuple[float, float]:
    """(device ms, eager ms) of one ``fn()`` call, medians over ``iters``
    CUDA-event samples.  Device time: ``reps`` calls captured in a CUDA graph
    and replayed, divided by ``reps`` — the host's launch cost drops out.
    Eager time: one call as the serving loop issues it, launch cost
    included."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _event_ms(graph.replay, iters) / reps
    return device, _event_ms(fn, iters)


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_env():
    import torch
    print("== 1. environment", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 yardsticks in f32
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from repro_torch.kernels import _build
    print("== 2. build", flush=True)
    t0 = time.time()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}")


def _rand_packed(gen, n, k, bits, device):
    import torch
    from repro_torch.core import packing
    lo = -1 if bits == 2 else -(1 << (bits - 1))
    hi = 1 if bits == 2 else (1 << (bits - 1)) - 1
    codes = torch.randint(lo, hi + 1, (n, k), generator=gen, dtype=torch.int8)
    return packing.pack(codes, bits).to(device), codes.to(device)


def _matmul_record(name, gen, device, bits, timed=True):
    """Check one matmul kernel at every main-path shape (int path at
    M in {4, 32}, float path at M = 4) and time one layer's seven decode
    projections at M = 4 (the decode batch)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.packed_matmul import packed_matmul
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    if name == "ternary_matmul":
        kern = lambda x, w, s: ternary_matmul(x, w, s)
        plain = lambda x, w, s: ref.ternary_matmul_ref(x, w, s)
    else:
        kern = lambda x, w, s: packed_matmul(x, w, s, bits=bits)
        plain = lambda x, w, s: ref.packed_matmul_ref(x, w, s, bits)
    qmax_a = (1 << (bits - 1)) - 1        # activation codes of a bits x bits config
    ops, err_int = {}, 0.0
    for (n, k) in MAIN_SHAPES:
        w, codes = _rand_packed(gen, n, k, bits, device)
        scale = (torch.rand(n, generator=gen) + 0.5).to(device)
        wdq = (codes.to(torch.float32) * scale[:, None]).T.to(torch.bfloat16)
        for m in (4, 32):
            x = torch.randint(-qmax_a, qmax_a + 1, (m, k), generator=gen,
                              dtype=torch.int8).to(device)
            y, y_ref = kern(x, w, scale), plain(x, w, scale)
            torch.cuda.synchronize()
            err_int = max(err_int, (y - y_ref).abs().max().item())
            check(torch.equal(y, y_ref),
                  f"{name} bits={bits} int path M={m} N={n} K={k}: not equal "
                  f"to the plain version (max |diff| "
                  f"{(y - y_ref).abs().max().item()})")
            ops[(m, n, k)] = (x, w, scale, wdq)
        xf = torch.randn((4, k), generator=gen).to(device, torch.bfloat16)
        yf, yf_ref = kern(xf, w, scale), plain(xf, w, scale)
        # f32 sums of exact products, in another order: the error is far
        # below 1e-4 of the output's magnitude
        err = (yf - yf_ref).abs().max().item()
        tol = 1e-4 * yf_ref.abs().max().item()
        check(err <= tol, f"{name} bits={bits} float path N={n} K={k}: "
                          f"max |diff| {err} > {tol}")
    print(f"{name} (bits={bits}): int path torch.equal to the plain version at "
          f"M in (4, 32) x (N, K) in {MAIN_SHAPES}; float (bf16) path within "
          "1e-4 of max|out|")
    if not timed:
        return None

    t_k = t_p = t_l = b_ms = 0.0
    b_by = {"bytes": 0, "operations": 0}
    for (n, k) in SMOLLM_DECODE_PROJ:
        x, w, scale, wdq = ops[(4, n, k)]
        xb = x.to(torch.bfloat16)
        tk, tk_eager = time_ms(lambda: kern(x, w, scale))
        tp, _ = time_ms(lambda: plain(x, w, scale))
        tl, _ = time_ms(lambda: torch.matmul(xb, wdq))
        bt, by = bound(4 * k + n * k * bits / 8 + 4 * n + 4 * 4 * n,
                       2 * 4 * n * k, PEAK_INT8)
        print(f"  M=4 N={n:5d} K={k:5d}: kernel {tk:.5f} ms (eager call "
              f"{tk_eager:.4f} ms), plain {tp:.5f} ms, torch.matmul bf16 "
              f"{tl:.5f} ms, bound {bt:.6f} ms ({by})")
        t_k, t_p, t_l, b_ms = t_k + tk, t_p + tp, t_l + tl, b_ms + bt
        b_by[by] += 1
    return {"name": name, "bits": bits, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": max(b_by, key=b_by.get),
            "library_ms": t_l, "max_abs_err": err_int,
            "shape": "one layer's 7 decode projections, M=4"}


def _attention_record(gen, device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    b, kv, g, dh, s = N_SLOTS, 3, 3, 64, PROMPT + GEN
    q = torch.randn((b, kv, g, dh), generator=gen).to(device, torch.bfloat16)
    kc = torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                       dtype=torch.int8).to(device)
    vc = torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                       dtype=torch.int8).to(device)
    ks = (torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3).to(device)
    vs = (torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3).to(device)
    pos_list = [s - 1, 40, 5, 63]                     # ragged slot positions
    pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
    args = (q, kc, ks, vc, vs, pos)
    out, out_ref = decode_attention(*args), decode_attention_ref(*args)
    torch.cuda.synchronize()
    err = (out - out_ref).abs().max().item()
    # f32 online softmax vs one-shot softmax: rounding only
    tol = 1e-5 + 1e-4 * out_ref.abs().max().item()
    check(err <= tol, f"decode_attention: max |diff| {err} > {tol}")
    print(f"decode_attention B={b} KV={kv} G={g} Dh={dh} S={s} pos={pos_list}: "
          f"max |diff| vs f32 plain version {err:.3e} (tolerance {tol:.3e})")

    kf = (kc.float() * ks).permute(0, 2, 1, 3)            # (B, KV, S, Dh)
    vf = (vc.float() * vs).permute(0, 2, 1, 3)
    qf = q.float().reshape(b, kv * g, 1, dh)
    kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    mask = (torch.arange(s, device=device)[None, :] <= pos[:, None].long()
            )[:, None, None, :]
    tk, tk_eager = time_ms(lambda: decode_attention(*args))
    tp, _ = time_ms(lambda: decode_attention_ref(*args))
    tl, _ = time_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf,
                                                           attn_mask=mask))
    valid = sum(min(p + 1, s) for p in pos_list)
    nbytes = (q.numel() * 2 + valid * kv * (2 * dh + 2 * 4) + 4 * b
              + 4 * b * kv * g * dh)
    bt, by = bound(nbytes, valid * kv * g * 4 * dh, PEAK_F32)
    print(f"  kernel {tk:.5f} ms (eager call {tk_eager:.4f} ms), plain "
          f"{tp:.5f} ms, sdpa f32 {tl:.5f} ms, bound {bt:.6f} ms ({by})")
    return {"name": "decode_attention", "ms": tk, "plain_ms": tp,
            "bound_ms": bt, "bound_by": by, "library_ms": tl,
            "max_abs_err": err,
            "shape": f"B={b} KV={kv} G={g} Dh={dh} S={s} pos={pos_list}"}


def phase_kernels(device):
    import torch
    print("== 3. kernels against their plain versions", flush=True)
    gen = torch.Generator().manual_seed(0)
    return [_matmul_record("ternary_matmul", gen, device, 2),
            _matmul_record("packed_matmul", gen, device, 2, timed=False),
            _matmul_record("packed_matmul", gen, device, 4),
            _attention_record(gen, device)]


def _serve(device, card, precision: str, n_req: int, gen: int):
    """Serve ``n_req`` requests of ``gen`` tokens at full width through the
    continuous batcher, after one warm-up request; returns (model, params,
    serving config, requests, kernel launches of the measured run)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import engine
    from repro_torch.models import build_model, to_serving
    from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                             RequestOptions, ServingConfig)
    cfg = get_config("smollm-135m", precision=precision, kv_bits=8)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator().manual_seed(0), device)
    params = to_serving(params, cfg, tp=1)
    torch.cuda.synchronize()
    print(f"params: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.padded_vocab}, {cfg.dtype}, {precision}; init + to_serving "
          f"{time.time() - t0:.1f} s")
    sc = ServingConfig(n_slots=N_SLOTS, s_max=PROMPT + GEN, chunk_size=CHUNK)
    rng = np.random.default_rng(1)

    def requests(n):
        return [Request(rid, rng.integers(0, cfg.vocab, (1, PROMPT - rid % 3)
                                          ).astype(np.int64),
                        options=RequestOptions(max_new=gen))
                for rid in range(n)]

    warm = ContinuousBatcher(model, params, sc)       # first-call set-up
    for r in requests(1):
        warm.submit(r)
    warm.run()
    torch.cuda.synchronize()

    batcher = ContinuousBatcher(model, params, sc)
    reqs = requests(n_req)
    for r in reqs:
        batcher.submit(r)
    engine.reset_launch_counts()
    done = batcher.run()
    torch.cuda.synchronize()
    launches = engine.launch_counts()
    print(f"{precision} path launches: {launches}")
    check(len(done) == n_req, f"served {len(done)} of {n_req} requests")
    for r in done:
        check(len(r.output) == gen, f"request {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.output),
              f"request {r.rid}: token out of vocabulary {r.output}")
    s = batcher.metrics.summary()
    print(batcher.metrics.format())
    decode_tps = batcher.metrics.decode_slot_tokens / s["throughput"]["wall_s"]
    print(f"[{card}] {precision}: served {n_req} requests x {gen} tokens: "
          f"{s['throughput']['tok_per_s']:.1f} tok/s overall, TTFT p50 "
          f"{s['ttft_ms']['p50']:.1f} ms, ITL p50 {s['itl_ms']['p50']:.2f} ms, "
          f"decode tok/s {decode_tps:.1f} (decode-step tokens per wall second)")
    toks = np.array([r.output[:8] for r in sorted(done, key=lambda r: r.rid)])
    print(f"sample generations (first 8 tokens/request):\n{toks}")
    return model, params, sc, reqs, launches


def phase_serve(device, card):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    print("== 4. serving path: smollm-135m 2xT kv8 bf16 (full width)",
          flush=True)
    model, params, sc, reqs, launches = _serve(device, card, "2xT", N_REQ, GEN)
    check(launches["ternary_matmul"] > 0, "ternary_matmul never launched")
    check(launches["decode_attention"] > 0, "decode_attention never launched")

    # whole model, kernels vs plain versions.  A prefill chunk differs only
    # in the matmul kernels, whose int paths are bit-equal: tolerance 0.  In
    # a decode step the plain side runs the attention kernel's own plain
    # version (f32 K/V dequant): layer 0 sees identical inputs on both sides
    # (checked), so its attention output may differ by f32 summation order
    # only and is bounded like phase 3.  Past layer 0 the two sides see
    # different inputs once one bf16 rounding of an attention output
    # differs, and 2-bit activation codes amplify that: the logits are
    # reported with the layer where the outputs first part, not bounded.
    # The plain versions alone, with f32 against bf16 (the reference's
    # serving semantics) K/V dequant, are run too, to show the size of that
    # effect with no kernel in the comparison.
    cmp = _compare_backends(model, params, sc, reqs[0].tokens, device)
    per_call = cmp["launches"]
    print(f"launches per prefill chunk (C={CHUNK}): {per_call['chunk']}; "
          f"per decode step (B={N_SLOTS}): {per_call['decode']}")
    check(cmp["chunk"] == 0.0, f"2xT prefill_chunk logits differ by "
                               f"{cmp['chunk']}")
    check(cmp["q0_equal"], "2xT decode step: layer 0 attention inputs "
                           "differ between kernels and plain versions")
    tol0 = 1e-5 + 1e-4 * cmp["attn0_scale"]
    print(f"2xT bf16, kernels vs plain versions (f32 K/V dequant): "
          f"prefill_chunk max |dlogit| {cmp['chunk']:.3e} (tolerance 0); "
          f"decode step layer 0 attention max |diff| {cmp['attn0']:.3e} "
          f"(tolerance {tol0:.3e}, identical inputs); attention outputs "
          f"equal in bf16 in the first {cmp['layers_equal']} of "
          f"{cmp['n_layers']} layers; logits max |dlogit| {cmp['decode']:.3e} "
          f"of max|logit| {cmp['scale']:.3e}, greedy tokens agree on "
          f"{cmp['agree']}/{N_SLOTS} rows (not bounded, see above)")
    check(cmp["attn0"] <= tol0, f"2xT decode step layer 0 attention differs "
                                f"by {cmp['attn0']} > {tol0}")
    print(f"2xT bf16, plain versions only, f32 vs bf16 K/V dequant: decode "
          f"logits max |dlogit| {cmp['dequant']:.3e}, greedy tokens agree on "
          f"{cmp['dequant_agree']}/{N_SLOTS} rows; attention outputs equal "
          f"in bf16 in the first {cmp['dequant_layers_equal']} layers")

    cfg32 = get_config("smollm-135m", precision="fp32", kv_bits=8,
                       dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator().manual_seed(0), device)
    c32 = _compare_backends(model32, params32, sc, reqs[0].tokens, device)
    print(f"fp32 weights, float32, kv8, kernels vs plain versions: "
          f"decode_step max |dlogit| {c32['decode']:.3e} (tolerance "
          f"{1e-4 * c32['scale']:.3e} = 1e-4 of max|logit| "
          f"{c32['scale']:.3e}), greedy tokens agree on {c32['agree']}/"
          f"{N_SLOTS} rows; launches {c32['launches']['decode']}")
    check(c32["launches"]["decode"]["decode_attention"] > 0,
          "fp32 decode step launched no decode_attention")
    check(c32["decode"] <= 1e-4 * c32["scale"],
          f"fp32 decode_step logits differ by {c32['decode']}")

    # the same entry point at --precision 4x4 runs the packed_matmul kernel
    print("== 4b. serving path: smollm-135m 4x4 kv8 bf16 (full width)",
          flush=True)
    _, _, _, _, launches4 = _serve(device, card, "4x4", N_SLOTS, 4)
    check(launches4["packed_matmul"] > 0, "packed_matmul never launched")
    launches = dict(launches, packed_matmul=launches4["packed_matmul"])
    return launches, (model, params, sc)


def phase_profile(card, model, params, sc, steps: int = 5):
    """Decode steps of the 2xT serving path under ``torch.profiler``: the
    device operations (kernels, copies, fills) per step, the device's busy
    time (the union of their intervals) and its idle share of the step's
    wall time.  The same steps are timed without the profiler first."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                             RequestOptions)
    print("== 5. decode steps under torch.profiler (2xT, all slots live)",
          flush=True)
    batcher = ContinuousBatcher(model, params, sc)
    rng = np.random.default_rng(2)
    for rid in range(N_SLOTS):                # one-chunk prompts, long runs
        batcher.submit(Request(rid, rng.integers(
            0, model.cfg.vocab, (1, CHUNK - rid % 3)).astype(np.int64),
            options=RequestOptions(max_new=sc.s_max - CHUNK)))
    for _ in range(2 * N_SLOTS):              # admission: chunks + decode
        if not batcher.queue and not any(batcher.done):
            break
        batcher.step()
    check(not batcher.queue and not any(batcher.done),
          "profile: the slots did not all fill")
    batcher.step()
    torch.cuda.synchronize()

    def timed_steps():
        t0 = time.perf_counter()
        for _ in range(steps):
            batcher.step()                    # ends in a host copy
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    plain_ms = timed_steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = timed_steps()
    check(not any(batcher.done), "a slot finished inside the profiled steps")
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = [e for e in prof.events() if e.device_type == DeviceType.CPU
                and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                               "cuLaunchKernel", "cudaMemcpyAsync",
                               "cudaMemsetAsync")]
    check(bool(dev), "torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + (hi - lo), a, b
        else:
            hi = max(hi, b)
    busy_ms = (busy + hi - lo) / 1e3 / steps
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    print(f"[{card}] 2xT decode step (B={N_SLOTS}, 30 layers): wall "
          f"{plain_ms:.2f} ms unprofiled, {prof_ms:.2f} ms profiled; device "
          f"operations {len(dev) / steps:.0f} per step (host launch calls "
          f"{len(launches) / steps:.0f}); device busy {busy_ms:.3f} ms per "
          f"step, idle share {1 - busy_ms / prof_ms:.4f} of the profiled "
          f"step, {max(0.0, 1 - busy_ms / plain_ms):.4f} of the unprofiled")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, t) in top:
        print(f"  {t / 1e3 / steps:8.3f} ms/step  {n / steps:5.0f}/step  "
              f"{name[:90]}")


@contextlib.contextmanager
def _attention_probe(plain_f32: bool):
    """Register recording decode-attention entries for kv8 (the kernel for
    "cuda"; for "torch" the kernel's f32 plain version, or with
    ``plain_f32=False`` the model-dtype serving version) and restore the
    registered ones on exit.  Yields the list of (q, f32 output) per call,
    one per layer and decode step."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref, decode_attention_serving_ref)
    key = (engine.ATTN_DECODE, 8)
    saved = {b: engine.resolve_attention_entry(*key, b)[0]
             for b in engine.BACKENDS}
    calls = []

    def kernel(q, k, ks, v, vs, pos, *, kv_bits, dtype):
        out = decode_attention(q.contiguous(), k, ks, v, vs, pos)
        calls.append((q.clone(), out))
        return out.to(dtype)

    def plain(q, k, ks, v, vs, pos, *, kv_bits, dtype):
        if plain_f32:
            out = decode_attention_ref(q, k, ks, v, vs, pos)
        else:
            out = decode_attention_serving_ref(q, k, ks, v, vs, pos,
                                               kv_bits=kv_bits, dtype=dtype)
        calls.append((q.clone(), out.to(torch.float32)))
        return out.to(dtype)

    engine.register_attention(*key, engine.BACKEND_CUDA)(kernel)
    engine.register_attention(*key, engine.BACKEND_TORCH)(plain)
    try:
        yield calls
    finally:
        for b, fn in saved.items():
            engine.register_attention(*key, b)(fn)


def _compare_backends(model, params, sc, prompt, device):
    """One prefill chunk, then one decode step over N_SLOTS slots holding
    that chunk's cache at ragged positions, three ways: the kernels
    (backend "cuda"), the plain versions with the attention kernel's f32
    K/V dequant, and the plain versions with the model-dtype dequant of the
    serving version.  Returns a dict of launches per call and the
    differences between the first two (and between the last two)."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serving import write_slot
    cfg = model.cfg
    tokens = torch.as_tensor(prompt[:, :CHUNK], device=device)
    pos = torch.tensor([CHUNK, CHUNK - 3, CHUNK - 7, 5], device=device)
    launches, runs = {}, {}
    for run, backend, f32 in (("cuda", "cuda", True), ("plain", "torch", True),
                              ("serving", "torch", False)):
        engine.reset_launch_counts()
        cache = tfm.make_cache(cfg, 1, sc.s_max, device)
        lc, cache = model.prefill_chunk(params, tokens, cache, 0,
                                        backend=backend)
        torch.cuda.synchronize()
        launches[f"chunk_{run}"] = engine.launch_counts()
        slots = tfm.make_cache(cfg, N_SLOTS, sc.s_max, device)
        for i in range(N_SLOTS):
            write_slot(slots, cache, i)
        tok = lc[:, -1:].argmax(-1).expand(N_SLOTS, 1).contiguous()
        engine.reset_launch_counts()
        with _attention_probe(plain_f32=f32) as attn:
            ld, _ = model.decode_step(params, tok, slots, pos, backend=backend)
        torch.cuda.synchronize()
        launches[f"decode_{run}"] = engine.launch_counts()
        check(len(attn) == cfg.n_layers,
              f"{len(attn)} decode attention calls for {cfg.n_layers} layers")
        check(bool(torch.isfinite(lc).all() and torch.isfinite(ld).all()),
              f"non-finite logits ({cfg.precision}, {run})")
        runs[run] = (lc, ld, attn)
    check(not any(n for run in ("plain", "serving")
                  for c in ("chunk", "decode")
                  for n in launches[f"{c}_{run}"].values()),
          "backend='torch' launched a kernel")
    dtype = getattr(torch, cfg.dtype)           # the model dtype

    def layers_equal(a, b):
        n = 0
        for (_, x), (_, y) in zip(a, b):
            if not torch.equal(x.to(dtype), y.to(dtype)):
                break
            n += 1
        return n

    (cc, cd, ca), (pc, pd, pa), (_, sd, sa) = (runs["cuda"], runs["plain"],
                                               runs["serving"])
    return {
        "launches": {"chunk": launches["chunk_cuda"],
                     "decode": launches["decode_cuda"]},
        "chunk": (cc - pc).abs().max().item(),
        "q0_equal": torch.equal(ca[0][0], pa[0][0]),
        "attn0": (ca[0][1] - pa[0][1]).abs().max().item(),
        "attn0_scale": pa[0][1].abs().max().item(),
        "layers_equal": layers_equal(ca, pa), "n_layers": cfg.n_layers,
        "decode": (cd - pd).abs().max().item(),
        "scale": pd.abs().max().item(),
        "agree": int((cd.argmax(-1) == pd.argmax(-1)).sum()),
        "dequant": (sd - pd).abs().max().item(),
        "dequant_agree": int((sd.argmax(-1) == pd.argmax(-1)).sum()),
        "dequant_layers_equal": layers_equal(sa, pa),
    }


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found: run chip_smoke.py from the root of "
             "a repository checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    device = torch.device("cuda", 0)
    card = phase_env()
    phase_build()
    records = [r for r in phase_kernels(device) if r is not None]
    launches, served = phase_serve(device, card)
    phase_profile(card, *served)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    replaces = {
        "ternary_matmul": ("src/repro_torch/csrc/qmatmul.cu",
                           "src/repro/kernels/ternary_matmul.py:74"),
        "packed_matmul": ("src/repro_torch/csrc/qmatmul.cu",
                          "src/repro/kernels/packed_matmul.py:78"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:68"),
    }
    kernels = [{"name": r["name"], "route": "cuda",
                "source": replaces[r["name"]][0],
                "replaces": replaces[r["name"]][1], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": r["shape"]} for r in records]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

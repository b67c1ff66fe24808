#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel of the serving paths, built from
     ``src/repro_torch/csrc`` with nvcc (one process per source, in
     parallel), with its time;
  3. kernels against their plain PyTorch versions at the serving paths'
     shapes, with the kernel's time, the plain version's time, one PyTorch
     library call's time (a yardstick the port never calls) and the least
     time the card could take (bytes over memory rate, or operations over
     peak rate, whichever is larger): the matmuls (the ternary one also at
     two CNN conv shapes and over K at a decode shape; both kernels of
     ``csrc/qmatmul.cu`` at bits 2/4/8 over the whole field range, M across
     M_SMALL, an unaligned K, with and without a bias, each timed at
     M = 4..128 and at Model.forward's w_gate shape), the XNOR-popcount
     binary matmul on random bits
     (the 1x1 LM's decode and chunk shapes, a ragged shape, a CNN conv
     shape; both of its kernels by name across their switch, timed at
     M = 4..128 and at AlexNet's fc shapes), the dense decode attention
     (the serving step and a 2048-position cache, each with its plan),
     the paged attention at kv 8/4/16 (kv8 / kv16; kv8 at a 2048-position
     context; a sweep of cluster sizes and span limits over context
     lengths), the fused decode at kv8 (also at 2048 positions), the
     three activation quantizers (f32 and bf16 rows, ``torch.equal``;
     B7a/B7b also at ResNet-34's stem rows at batch 32, past the L2),
     B7b's tensor form (scale and codes in one launch, timed beside
     ``core.act_quant_codes_signed`` and its former five-operation chain)
     and B7c's row form (scale and codes in one launch, timed beside the
     former abs/amax/clamp_min/div chain) and the
     full-sequence flash attention (prefill,
     forward, window + softcap; bf16 and f32 (TF32 tensor cores, three
     products), each timed beside SDPA; with ``probs_bf16``, the reference's
     ``attn_probs_bf16``, at the forward shape and whisper-base's encoder,
     also held by mean |diff| to a share of the flag's own effect that the
     flag-off kernel misses, timed beside the flag-off kernel and SDPA);
  4. the dense serving path at full width: smollm-135m, 2xT
     weights/activations, int8 KV cache, bf16, random weights from seed 0,
     served by the continuous batcher (8 requests over 4 slots); the kernel
     launch counts of that run (the per-row activation quantizer and the
     ternary matmul once per projection); one prefill chunk and one decode
     step through the kernels against the same calls through the plain
     versions; a shorter 4x4 run for the packed kernel;
  4c. the paged serving path at full width (2xT, kv8 blocks of 16
     positions, the same 8 requests, which share a 32-token prefix): prefix
     hits, ``paged_attention`` launches per decode step, one paged prefill
     chunk and decode step through the kernels against the plain versions,
     the streams against the dense run's; then an overcommitted 10-block
     pool that preempts, with ``check_pool()`` after every step;
  4d. the fused decode: fp32 weights, paged kv8, bf16 (``fused_decode``
     launches per decode step), and a float32 paged decode step through the
     kernel against the plain versions;
  4e. the 1x1 (XNOR) serving path at full width: smollm-135m, 1-bit signed
     activations x binary weights, kv8, bf16, 4 requests x 8 tokens through
     the dense batcher (``binary_matmul`` launches per decode step and per
     prefill chunk), one prefill chunk and decode step through the kernels
     against the plain versions, then the same requests through the paged
     batcher (launches per step, streams equal to the dense run's);
  4f. the paper's CNNs at full width (AlexNet and ResNet-34, 1000 classes,
     224x224x3, random weights from a seed), f32 throughout (TF32 off): at
     2xT and 1x1 the kernel launches per forward and the logits through the
     kernels against the same forward through the plain versions on the
     card, at fp32 finite logits; images/s at 2xT and 1x1 (AlexNet batch
     64, ResNet-34 batch 32) and each forward's device time by kernel under
     ``torch.profiler``;
  4g. whole-prompt admission (chunk size 0) on the dense phase's requests:
     ``flash_attention`` launches per prefill, the streams against the
     chunked run's (reported);
  4h. ``Model.forward`` / ``Model.loss`` at B=2, S=2048: fp32 weights in
     float32 through the kernels against the plain versions (bounded), 2xT
     bf16 (reported), launches and time per forward, and one forward under
     ``torch.profiler`` (device busy time, flash attention's share); each
     again with ``attn_probs_bf16`` (B8 launched with ``probs_bf16`` on
     every layer; fp32 over three batches, held by mean |diff| to a share
     of the flag's own effect that plain paths rounding only P or only V
     miss; 2xT reported);
  4i. the integer-code quantizers of ``core`` (``act_quant`` and
     ``act_quant_signed`` launches) against their plain versions, the
     signed scale against the host's float64 quotient rounded to bf16, and
     one device operation a signed call (``torch.profiler``);
  4j. sampling and the flight recorder on the 2xT paths: phase 4's
     requests with odd rids sampled (temperature 0.8, top-k 50, seed 11),
     greedy rows against phase 4's streams, four sampled requests each
     served alone against the mixed run, a second run against the first,
     the paged batcher beside the dense run (reported); the dense and the
     paged workloads traced and profiled (streams against the untraced
     runs, the Perfetto document's consistency, step-span coverage,
     distinct dispatch instants, ``StepProfiler`` summaries); the decode
     step's wall time with every row sampled beside all-greedy and the
     selection's own time, and the serving CLI's ITL with ``--profile`` and
     without;
  4l. self-speculative decoding and the adaptive server, fp32 weights in
     float32: phase 4's requests through the paged kv16 batcher with and
     without speculation (2xT draft, k=3; then the 8x8 draft on 4
     requests): the speculative counters, launches per draft step, the
     streams against the non-speculative run's (equal, or parted where
     that run's top-2 logit gap is within 1e-4 of max|logit|), the verify
     step's time beside a decode step's; the adaptive server (4 premium
     requests active, then 12 standard / batch ones; a shared 256 MiB
     budget): ``check_pool()`` after every step, the routed rungs,
     per-class SLO attainment, per-lane ITL and launches, premium streams
     against an unloaded run's; the CLI with ``--brownout --speculative``
     and its refusal of a quantized primary;
  4m. the MoE, Mamba and hybrid stacks: B1 at their projection shapes
     and B8 at granite's prefill against the plain versions; then
     granite-moe-1b-a400m at full size (24 layers, 32 experts top-8,
     random weights from seed 0 drawn on the card, 2xT kv8 bf16): the dense
     batcher (phase 4's 8 requests, chunked and whole-prompt), the paged
     kv8 batcher, launches per chunk and step, one chunk and decode step
     (dense and paged) through the kernels against the plain versions with
     the tokens whose expert set differs counted, a profiled decode step;
     fp32 weights in float32: the dense kv8 step under fault C2's contract
     and the fused paged step (B4) at kv16 (bounded) and kv8 (C2's swap);
     falcon-mamba-7b at full width and depth (2xT bf16, whole-prompt
     admission, 4 requests x 8 tokens; one prefill and decode step
     through the kernels equal to the plain versions in bf16 and float32;
     a profiled decode step); jamba-v0.1-52b at reduce_for_smoke shapes
     (one prefill and three decode steps, fp32 and 2xT bounded);
     the weights' bytes before and after ``to_serving``, decode tok/s and
     ITL p50 of each run; the expert product's and the scan's own times;
  4n. the enc-dec backbone (whisper-base), the embeds frontend
     (internvl2-76b), gemma2-27b, glm4-9b, starcoder2-15b and kimi-k2:
     B8's new modes against its plain version, launches per prefill and
     step, kernels against the plain versions (fp32 under fault C2's
     contract for whisper, glm4 and starcoder2);
  4q. QAT training at 2xT, bf16 params, adamw, batch 8 x 256 tokens:
     smollm-135m's full-size (30-layer) train step timed (wall p50,
     tokens/s, peak memory) and under ``torch.profiler`` (its loss finite;
     its grad norm printed: the reference's 2xT gradient overflows at that
     depth); at full width with 2 layers, a run through ``launch.train``
     (ElasticTrainer, checkpoints in the run's temp dir) with finite
     losses, the loss on one fixed batch against a stated drop, one train
     step of reduced smollm on the card against the CPU's (fp32, and 2xT
     with the activation codes that differ counted and taken from the CPU
     run), a restart from the step-20 checkpoint (restored state
     ``torch.equal`` to the saved one, the data position continuing); the
     trained weights packed (``to_serving``) and served by the dense
     batcher at kv8: B1, B7c and B5 launched on every layer, and B1 and
     B7c ``torch.equal`` to their plain versions on layer 0's trained
     projections;
  4r. serving over a mesh of ranks (``ServingConfig.mesh``; two ranks
     spawned on the one card, over gloo: the NCCL branch is not run here):
     B7c's given-scale codes of a K-split row ``torch.equal`` to its row
     form's; smollm-135m 2xT kv8 bf16 at full size (pure DP) on meshes 2,1
     and 1,2, dense chunked and paged, streams equal to the one-rank run's;
     glm4-9b 2xT kv8 at full size on 1,2 (tensor parallel) streams equal to
     the one-rank run's, and fp32 at 2 layers (f32 cache) within 1e-4 of
     max|logit|; granite-moe-1b-a400m on 1,2 with the expert-parallel MoE
     (``moe_impl="shard_map"``): fp32 within the bound, 2xT streams
     reported; per rank, one decode step's kernel launches and collectives
     against the expected counts, its wall beside the one-rank step's
     (glm4's next step under ``torch.profiler``: device busy ms);
  4s. training over a mesh of ranks (two ranks spawned on the one card,
     over gloo): smollm-135m 2xT bf16, adamw, batch 8 x 256 on a 2,1 mesh
     (pure DP): 2 layers for 3 steps from phase 4q's params and batches,
     the replicas ``torch.equal`` after every step, the loss and the
     params (in bf16 ulps) against the one-rank run's; the 30-layer step
     timed; glm4-9b 2xT at 2 layers on 1,2 (tensor parallel), 2 adafactor
     steps of 2 x 128: collectives per step forward and backward, peak
     memory per rank; its params saved by both ranks (each its slices),
     restored on one rank ``torch.equal`` to the gathered params, both
     packed and served (4 x 8 tokens through B1, B7c and B5, the tokens
     equal); one ``pipeline_blocks`` call on 2 stages (4 fp32 periods)
     within 1e-5 of the sequential stack, and its gradients (blocks and x)
     within 1e-5 of one rank's sequential autograd, the same bits on both
     ranks; granite-moe-1b-a400m fp32 at 2 layers with the expert-parallel
     MoE (``moe_impl="shard_map"``) trained on 1,2, nothing dropped: loss
     and grad norm against one rank's;
  5. decode steps of the dense and the paged 2xT paths, of the dense 1x1
     path and of the paged fp32-weight path (phase 4d's) under
     ``torch.profiler``: device operations per step, device busy time and
     idle share, and the decode-attention kernels' share of it (B5 dense,
     B2 paged, B4 fused);
  4k. the tuning cache (``kernels/tuning.py``), after phase 5: the matmul
     shape classes of the 2xT, 4x4 and 1x1 serving paths swept
     (``tune_serving_shapes``: each class's candidates, pick and default,
     and the pick through ``engine.qmatmul`` ``torch.equal`` to the
     automatic choice and the plain version); B5's launch plan swept at
     the dense serving shape and at 2048 positions (the tuned plan within
     B5's per-call bound); the serving CLI with ``--paged --kv-block-size 0
     --autotune`` (s_max 128: the B2 and B4 block-size sweeps and the
     pick); the dense 2xT batcher on the warm cache (no sweep, no miss;
     streams against phase 4's, or with a tuned B5 plan one decode step at
     phase 4's bound); the decode step's wall p50 warm beside cold, and one
     memoised lookup's host time.
Every phase before 4k runs on a fresh, empty tuning cache (the automatic
kernel choices), whatever the user's cache holds.
The last lines are the per-kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository checkout around it; it imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import os
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM3 bytes/s, int8 and bf16 tensor
# ops/s, f32 outside the tensor cores, and TF32 tensor ops/s.
MEM_BW = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
# The binary matmul's +/-1 products are counted at the int8 peak, the
# narrowest type in the published table (the 1-bit tensor rate is not in it).
PEAK_BINARY = PEAK_INT8

SMOLLM_DECODE_PROJ = (            # (N, K) of one layer's seven projections
    (576, 576), (192, 576), (192, 576), (576, 576),      # wq wk wv wo
    (1536, 576), (1536, 576), (576, 1536))               # w_gate w_up w_down
N_PROJ = len(SMOLLM_DECODE_PROJ)
MAIN_SHAPES = sorted(set(SMOLLM_DECODE_PROJ))
N_SLOTS, CHUNK, PROMPT, GEN, N_REQ = 4, 32, 64, 16, 8
S_MAX = PROMPT + GEN
BLOCK = 16                        # positions per paged KV block
KV_HEADS, GROUP, DH, D_MODEL = 3, 3, 64, 576


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def model_config(**kw):
    """The configuration every serving phase runs, at full width."""
    from repro_torch.configs import get_config
    return get_config("smollm-135m", **kw)


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
    return bound_terms(nbytes, ((ops, peak),))


def bound_terms(nbytes: float, terms) -> tuple[float, str]:
    """The bound (ms, "bytes" or "operations") of work whose operations come
    in (ops, peak) terms of several types, each at its own peak."""
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = sum(ops / peak for ops, peak in terms) * 1e3
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
        fn = spill = ""
        for line in log.splitlines():
            if "Function properties for" in line:      # ptxas -v, per kernel
                fn = _kernel_name(line.split()[-1])
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line or "error" in line.lower():
                print(f"  [{name}] {fn}: {line.split(':', 1)[-1].strip()}; {spill}")


def _kernel_name(sym: str) -> str:
    """A kernel's mangled symbol as ``name<integer template arguments>``."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?kernel))", sym):
        if int(m.group(1)) == len(m.group(2)):
            end = m.start() + len(m.group(1)) + len(m.group(2))
            args = re.findall(r"Li(\d+)E", sym[end:end + 40])
            return f"{m.group(2)}<{','.join(args)}>"
    return sym[:48]


def _rand_packed(gen, n, k, bits, device):
    """Random codes over the whole signed field range (the most negative
    field, -2 / -8 / -128, included: the kernels sign-extend every bit
    pattern) and their packed words."""
    import torch
    from repro_torch.core import packing
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    codes = torch.randint(lo, hi + 1, (n, k), generator=gen, dtype=torch.int8,
                          device=gen.device)
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


# B1 and B6 at CNN conv shapes: (label, M, N, K), batch 8 at 224x224
CNN_SHAPES = (("ResNet-34 stage-1 3x3 conv", 8 * 56 * 56, 64, 576),
              ("ResNet-34 stage-3 3x3 conv", 8 * 14 * 14, 256, 2304))


def _ternary_cnn_times(gen, device):
    """``ternary_matmul`` at two CNN conv shapes (M = batch x output pixels,
    2xT activation codes in {-1, 0, 1}): equal to the plain version, with
    its time beside ``torch.matmul`` bf16 on the dequantized weight and its
    bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    for label, m, n, k in CNN_SHAPES:
        w, codes = _rand_packed(gen, n, k, 2, device)
        scale = (torch.rand(n, generator=gen) + 0.5).to(device)
        x = torch.randint(-1, 2, (m, k), generator=gen, dtype=torch.int8).to(device)
        y, y_ref = ternary_matmul(x, w, scale), ref.ternary_matmul_ref(x, w, scale)
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref), f"ternary_matmul {label} M={m} N={n} K={k}: "
                                     "not equal to the plain version")
        xb = x.to(torch.bfloat16)
        wdq = (codes.to(torch.float32) * scale[:, None]).T.to(torch.bfloat16)
        tk, _ = time_ms(lambda: ternary_matmul(x, w, scale), reps=5)
        tp, _ = time_ms(lambda: ref.ternary_matmul_ref(x, w, scale), reps=5)
        tl, _ = time_ms(lambda: torch.matmul(xb, wdq), reps=5)
        bt, by = bound(m * k + n * k / 4 + 4 * n + 4 * m * n, 2 * m * n * k,
                       PEAK_INT8)
        print(f"ternary_matmul at {label} M={m} N={n} K={k} (int8 codes): equal "
              f"to the plain version; kernel {tk:.4f} ms, plain {tp:.4f} ms, "
              f"torch.matmul bf16 {tl:.4f} ms, bound {bt:.5f} ms ({by}), "
              f"{2 * m * n * k / tk / 1e9:.1f} TOP/s")


def _ternary_k_steps(gen, device):
    """``ternary_matmul`` at M = 4, N = 576 over K in (64, 576, 1536): how
    its time grows with the reduction length at a decode shape."""
    import torch
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    line = []
    for k in (64, 576, 1536):
        w, _ = _rand_packed(gen, 576, k, 2, device)
        scale = (torch.rand(576, generator=gen) + 0.5).to(device)
        x = torch.randint(-1, 2, (4, k), generator=gen, dtype=torch.int8).to(device)
        tk, _ = time_ms(lambda: ternary_matmul(x, w, scale))
        line.append(f"K={k} {tk:.5f} ms")
    print(f"ternary_matmul M=4 N=576 by K: {', '.join(line)}")


# B1 / B3 (csrc/qmatmul.cu) beyond the records: a K per width whose packed
# W^T rows are not a multiple of 16 bytes (the word-wise loads), and
# Model.forward's w_gate / w_up at B=2, S=2048
QMM_UNALIGNED_K = {2: 592, 4: 584, 8: 588}
FORWARD_PROJ = (4096, 1536, 576)
# AlexNet's fc6 / fc7 at batch 8 and 64 (the CNN phase's two batches)
ALEXNET_FC = ((8, 4096, 9216), (8, 4096, 4096), (64, 4096, 9216),
              (64, 4096, 4096))


def _qmm_variant(lib, x, w, scale, bias, bits, variant):
    """int8 codes through one named kernel of csrc/qmatmul.cu (0 = rows, 1
    = tensor cores) whatever M is: a comparison launch, not counted."""
    import torch
    from repro_torch.kernels import _build
    out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32,
                      device=x.device)
    _build.check(lib.qmatmul_int8_variant(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        x.shape[0], w.shape[0], x.shape[1], bits, variant,
        _build.stream_ptr(x)), "qmatmul_int8_variant")
    return out


def _qmatmul_variants(gen, device):
    """B1 / B3 int8 paths, ``torch.equal`` to the plain versions: through
    the wrappers at M across M_SMALL (decode rows / tensor cores), at the
    CNN shapes and Model.forward's, every field width, the whole field
    range, with and without a bias, an unaligned K; each kernel by name at
    every width at M = 4 and 128.  Timed: each kernel at AlexNet's fc
    shapes, and over one layer's seven decode projections at M in (4, 8,
    16, 32, 64, 128) and at Model.forward's w_gate shape beside
    ``torch.matmul`` bf16 and the bound."""
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.packed_matmul import packed_matmul
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    lib = _build.library("qmatmul")
    m_small = lib.qmatmul_m_small()
    print(f"qmatmul: M_SMALL = {m_small} (rows kernel at M <= M_SMALL and "
          "M * N <= M_SMALL * 1536, tensor cores otherwise)")

    def operands(m, n, k, bits):
        w, codes = _rand_packed(gen, n, k, bits, device)
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(device)
        scale = (torch.rand(n, generator=gen) + 0.5).to(device)
        bias = torch.randn(n, generator=gen).to(device)
        return x, w, codes, scale, bias

    def plain(x, w, scale, b, bits):
        return ref.packed_matmul_ref(x, w, scale, bits, bias=b)

    kinds = (("ternary_matmul", 2), ("packed_matmul", 2), ("packed_matmul", 4),
             ("packed_matmul", 8))
    ms = sorted({1, 4, 17, 32, 33, m_small, m_small + 1, 128})
    n_checked = 0
    for name, bits in kinds:
        if name == "ternary_matmul":
            wrap = lambda x, w, s, b: ternary_matmul(x, w, s, b)
        else:
            wrap = lambda x, w, s, b, bits=bits: packed_matmul(x, w, s, b, bits=bits)
        cases = ([(m, n, k) for m in ms for n, k in
                  ((576, 576), (1536, 576), (576, 1536),
                   (200, QMM_UNALIGNED_K[bits]))]
                 + [(m, n, k) for _, m, n, k in CNN_SHAPES] + [FORWARD_PROJ]
                 + list(ALEXNET_FC))
        for m, n, k in cases:
            x, w, _, scale, bias = operands(m, n, k, bits)
            for b in (None, bias):
                y, y_ref = wrap(x, w, scale, b), plain(x, w, scale, b, bits)
                torch.cuda.synchronize()
                check(torch.equal(y, y_ref),
                      f"{name} bits={bits} M={m} N={n} K={k} bias="
                      f"{b is not None}: not equal to the plain version "
                      f"(max |diff| {(y - y_ref).abs().max().item()})")
                n_checked += 1
        for m in (4, 128):
            for n, k in ((1536, 576), (200, QMM_UNALIGNED_K[bits])):
                x, w, _, scale, bias = operands(m, n, k, bits)
                y_ref = plain(x, w, scale, bias, bits)
                for v in (0, 1):
                    y = _qmm_variant(lib, x, w, scale, bias, bits, v)
                    torch.cuda.synchronize()
                    check(torch.equal(y, y_ref),
                          f"qmatmul kernel {v} bits={bits} M={m} N={n} K={k}: "
                          "not equal to the plain version")
                    n_checked += 1
    print(f"qmatmul int8 paths: {n_checked} calls torch.equal to the plain "
          f"versions (B1 and B3 bits 2/4/8, fields over their whole range, "
          f"x over all of int8, M in {ms} at (N, K) in (576, 576), "
          f"(1536, 576), (576, 1536) and an unaligned K "
          f"{QMM_UNALIGNED_K}, the CNN shapes, M, N, K = {FORWARD_PROJ}, "
          f"AlexNet's fc {ALEXNET_FC}; "
          "with and without a bias; both kernels by name at M = 4 and 128)")

    def seven(m, bits, v):
        t_k = t_l = b_ms = 0.0
        for n, k in SMOLLM_DECODE_PROJ:
            x, w, codes, scale, _ = operands(m, n, k, bits)
            xb = x.to(torch.bfloat16)
            wdq = (codes.to(torch.float32) * scale[:, None]).T.to(torch.bfloat16)
            t_k += time_ms(lambda: _qmm_variant(lib, x, w, scale, None, bits, v))[0]
            t_l += time_ms(lambda: torch.matmul(xb, wdq))[0]
            b_ms += bound(m * k + n * k * bits / 8 + 4 * n + 4 * m * n,
                          2 * m * n * k, PEAK_INT8)[0]
        return t_k, t_l, b_ms

    for m, n, k in ALEXNET_FC:
        x, w, _, scale, _ = operands(m, n, k, 2)
        t = [time_ms(lambda v=v: _qmm_variant(lib, x, w, scale, None, 2, v),
                     reps=5)[0] for v in (0, 1)]
        print(f"  bits=2 AlexNet fc M={m} N={n} K={k}: rows kernel {t[0]:.4f} "
              f"ms, tensor-core kernel {t[1]:.4f} ms")
    for bits in (2, 4):
        for m in (4, 8, 16, 32, 64, 128):
            (t0, tl, bt), (t1, _, _) = seven(m, bits, 0), seven(m, bits, 1)
            print(f"  bits={bits} seven decode projections M={m:3d}: rows "
                  f"kernel {t0:.5f} ms, tensor-core kernel {t1:.5f} ms, "
                  f"torch.matmul bf16 {tl:.5f} ms, bound {bt:.6f} ms")
        m, n, k = FORWARD_PROJ
        x, w, codes, scale, _ = operands(m, n, k, bits)
        xb = x.to(torch.bfloat16)
        wdq = (codes.to(torch.float32) * scale[:, None]).T.to(torch.bfloat16)
        t = [time_ms(lambda v=v: _qmm_variant(lib, x, w, scale, None, bits, v),
                     reps=5)[0] for v in (0, 1)]
        tl = time_ms(lambda: torch.matmul(xb, wdq), reps=5)[0]
        bt, by = bound(m * k + n * k * bits / 8 + 4 * n + 4 * m * n,
                       2 * m * n * k, PEAK_INT8)
        print(f"  bits={bits} M={m} N={n} K={k} (Model.forward w_gate): rows "
              f"kernel {t[0]:.4f} ms, tensor-core kernel {t[1]:.4f} ms, "
              f"torch.matmul bf16 {tl:.4f} ms, bound {bt:.5f} ms ({by}), "
              f"tensor cores {2 * m * n * k / t[1] / 1e9:.1f} TOP/s")


def _binary_variant(lib, a, w, alpha, bias, k, variant):
    """+/-1 bits through one named kernel of csrc/binary_matmul.cu (0 =
    decode rows, 1 = tensor cores) whatever M is: a comparison launch, not
    counted."""
    import torch
    from repro_torch.kernels import _build
    out = torch.empty((a.shape[0], w.shape[0]), dtype=torch.float32,
                      device=a.device)
    _build.check(lib.binary_matmul_variant(
        a.data_ptr(), w.data_ptr(), alpha.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        a.shape[0], w.shape[0], k, variant, _build.stream_ptr(a)),
        "binary_matmul_variant")
    return out


def _binary_record(gen, device):
    """``binary_matmul`` on random bits against its plain version,
    ``torch.equal`` (exact integer path): through the wrapper at the 1x1
    LM's seven decode projections at M = 4 and its (N, K) at M = 32 (a
    prefill chunk), a ragged M/N and a CNN conv shape, with and without a
    bias; each kernel by name at M across the switch, ragged N and an odd
    word count.  Timed: one layer's seven decode projections at M = 4,
    summed (the record), both kernels over M in (4, 8, 16, 32, 64, 128) and
    at AlexNet's fc shapes, and the CNN shape, each beside ``torch.matmul``
    bf16 on the +/-1 operands."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import _build
    from repro_torch.kernels.binary_matmul import binary_matmul
    from repro_torch.kernels.ref import binary_matmul_ref
    lib = _build.library("binary_matmul")
    m_small = lib.binary_matmul_m_small()
    print(f"binary_matmul: M_SMALL = {m_small} (decode-rows kernel at M <= "
          "M_SMALL and M * N <= M_SMALL * 1536, 1-bit tensor cores otherwise)")

    def bits(rows, k):
        pm1 = torch.randint(0, 2, (rows, k), generator=gen, dtype=torch.int8) * 2 - 1
        return packing.pack_binary_pm1(pm1).to(device), pm1.to(device)

    def plain(a, w, alpha, b, k):
        y = binary_matmul_ref(a, w, k, alpha=alpha)
        return y if b is None else y + b[None, :]

    def operands(m, n, k):
        a, a_pm1 = bits(m, k)
        w, w_pm1 = bits(n, k)
        alpha = (torch.rand(n, generator=gen) + 0.5).to(device)
        bias = torch.randn(n, generator=gen).to(device)
        wdq = (w_pm1.to(torch.float32) * alpha[:, None]).T.to(torch.bfloat16)
        return a, w, alpha, bias, a_pm1.to(torch.bfloat16), wdq

    ops, err = {}, 0.0
    cases = ([(4, n, k) for n, k in MAIN_SHAPES] + [(32, n, k) for n, k in MAIN_SHAPES]
             + [(37, 200, 320)] + [(m, n, k) for _, m, n, k in CNN_SHAPES[1:]])
    for m, n, k in cases:
        a, w, alpha, bias, xb, wdq = operands(m, n, k)
        for b in (None, bias):
            y, y_ref = binary_matmul(a, w, alpha, b, k=k), plain(a, w, alpha, b, k)
            torch.cuda.synchronize()
            err = max(err, (y - y_ref).abs().max().item())
            check(torch.equal(y, y_ref),
                  f"binary_matmul M={m} N={n} K={k} bias={b is not None}: not "
                  f"equal to the plain version (max |diff| "
                  f"{(y - y_ref).abs().max().item()})")
        ops[(m, n, k)] = (a, w, alpha, xb, wdq)
    ms = sorted({1, 4, 32, m_small, m_small + 1, 128, 1568})
    n_named = 0
    for m in ms:
        for n, k in ((576, 576), (1536, 576), (576, 1536), (200, 32 * 37),
                     (4096, 9216)):
            a, w, alpha, bias, _, _ = operands(m, n, k)
            for b in (None, bias):
                y_ref = plain(a, w, alpha, b, k)
                for v in (0, 1):
                    y = _binary_variant(lib, a, w, alpha, b, k, v)
                    torch.cuda.synchronize()
                    check(torch.equal(y, y_ref),
                          f"binary_matmul kernel {v} M={m} N={n} K={k} bias="
                          f"{b is not None}: not equal to the plain version")
                    n_named += 1
    print(f"binary_matmul: torch.equal to the plain version (with and without "
          f"bias) at M in (4, 32) x (N, K) in {MAIN_SHAPES}, M=37 N=200 K=320, "
          f"and M={CNN_SHAPES[1][1]} N={CNN_SHAPES[1][2]} K={CNN_SHAPES[1][3]}; "
          f"both kernels by name at M in {ms} x (N, K) in (576, 576), "
          f"(1536, 576), (576, 1536), (200, 1184), (4096, 9216): {n_named} "
          "calls")

    def times(m, n, k):
        a, w, alpha, xb, wdq = ops[(m, n, k)]
        tk, tk_eager = time_ms(lambda: binary_matmul(a, w, alpha, k=k))
        tp, _ = time_ms(lambda: binary_matmul_ref(a, w, k, alpha=alpha))
        tl, _ = time_ms(lambda: torch.matmul(xb, wdq))
        bt, by = bound(m * k / 8 + n * k / 8 + 4 * n + 4 * m * n,
                       2 * m * n * k, PEAK_BINARY)
        return tk, tk_eager, tp, tl, bt, by

    t_k = t_p = t_l = b_ms = 0.0
    b_by = {"bytes": 0, "operations": 0}
    for (n, k) in SMOLLM_DECODE_PROJ:
        tk, tk_eager, tp, tl, bt, by = times(4, n, k)
        print(f"  M=4 N={n:5d} K={k:5d}: kernel {tk:.5f} ms (eager call "
              f"{tk_eager:.4f} ms), plain {tp:.5f} ms, torch.matmul bf16 "
              f"{tl:.5f} ms, bound {bt:.6f} ms ({by})")
        t_k, t_p, t_l, b_ms = t_k + tk, t_p + tp, t_l + tl, b_ms + bt
        b_by[by] += 1
    print(f"  seven decode projections M=4: kernel {t_k:.5f} ms, torch.matmul "
          f"bf16 {t_l:.5f} ms, kernel / torch.matmul {t_k / t_l:.3f}")
    _, m, n, k = CNN_SHAPES[1]
    tk, _, tp, tl, bt, by = times(m, n, k)
    print(f"  {CNN_SHAPES[1][0]} M={m} N={n} K={k}: kernel {tk:.5f} ms, plain "
          f"{tp:.5f} ms, torch.matmul bf16 {tl:.5f} ms, bound {bt:.6f} ms "
          f"({by}), {2 * m * n * k / tk / 1e9:.1f} TOP/s")

    def seven(m, v):
        t_v, t_l = 0.0, 0.0
        for n, k in SMOLLM_DECODE_PROJ:
            a, w, alpha, _, xb, wdq = operands(m, n, k)
            t_v += time_ms(lambda: _binary_variant(lib, a, w, alpha, None, k, v))[0]
            t_l += time_ms(lambda: torch.matmul(xb, wdq))[0]
        return t_v, t_l

    for m in (4, 8, 16, 32, 64, 128):
        (t0, tl), (t1, _) = seven(m, 0), seven(m, 1)
        print(f"  seven decode projections M={m:3d}: rows kernel {t0:.5f} ms, "
              f"tensor-core kernel {t1:.5f} ms, torch.matmul bf16 {tl:.5f} ms")
    for m, n, k in ALEXNET_FC:
        a, w, alpha, _, _, _ = operands(m, n, k)
        t = [time_ms(lambda v=v: _binary_variant(lib, a, w, alpha, None, k, v),
                     reps=5)[0] for v in (0, 1)]
        print(f"  AlexNet fc M={m} N={n} K={k}: rows kernel {t[0]:.4f} ms, "
              f"tensor-core kernel {t[1]:.4f} ms")
    return {"name": "binary_matmul", "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": max(b_by, key=b_by.get),
            "library_ms": t_l, "max_abs_err": err,
            "shape": "one layer's 7 decode projections, M=4"}


# B5's cases: the dense serving step (S = S_MAX, ragged slot positions;
# the record) and a 2048-position cache (an 8-block cluster a head)
DECODE_CASES = ((S_MAX, [S_MAX - 1, 40, 5, 63]), (2048, [2047, 1023, 511, 0]))


def _attention_record(gen, device):
    """``decode_attention`` (B5) against its f32 plain version at the dense
    serving step and at a 2048-position cache, each with its launch plan,
    timed beside the plain version and SDPA f32; the serving step is the
    record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref,
                                                      launch_plan)
    b, kv, g, dh = N_SLOTS, KV_HEADS, GROUP, DH
    rec, err_max = None, 0.0
    for s, pos_list in DECODE_CASES:
        q = torch.randn((b, kv, g, dh), generator=gen).to(device, torch.bfloat16)
        kc = torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                           dtype=torch.int8).to(device)
        vc = torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                           dtype=torch.int8).to(device)
        ks = (torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3).to(device)
        vs = (torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3).to(device)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        args = (q, kc, ks, vc, vs, pos)
        out, out_ref = decode_attention(*args), decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = (out - out_ref).abs().max().item()
        # f32 online softmax vs one-shot softmax: rounding only
        tol = 1e-5 + 1e-4 * out_ref.abs().max().item()
        check(err <= tol, f"decode_attention S={s}: max |diff| {err} > {tol}")
        err_max = max(err_max, err)
        plan = launch_plan(q, kc, vc)
        print(f"decode_attention B={b} KV={kv} G={g} Dh={dh} S={s} "
              f"pos={pos_list} (plan {plan}): max |diff| vs f32 plain version "
              f"{err:.3e} (tolerance {tol:.3e})")

        kf = (kc.float() * ks).permute(0, 2, 1, 3)            # (B, KV, S, Dh)
        vf = (vc.float() * vs).permute(0, 2, 1, 3)
        qf = q.float().reshape(b, kv * g, 1, dh)
        kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
        mask = (torch.arange(s, device=device)[None, :] <= pos[:, None].long()
                )[:, None, None, :]
        tk, tk_eager = time_ms(lambda: decode_attention(*args))
        tp, _ = time_ms(lambda: decode_attention_ref(*args), reps=5)
        tl, _ = time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask), reps=5)
        valid = sum(min(p + 1, s) for p in pos_list)
        nbytes = (q.numel() * 2 + valid * kv * (2 * dh + 2 * 4) + 4 * b
                  + 4 * b * kv * g * dh)
        bt, by = bound(nbytes, valid * kv * g * 4 * dh, PEAK_F32)
        print(f"  kernel {tk:.5f} ms (eager call {tk_eager:.4f} ms), plain "
              f"{tp:.5f} ms, sdpa f32 {tl:.5f} ms, bound {bt:.6f} ms ({by})")
        if rec is None:
            rec = {"name": "decode_attention", "ms": tk, "plain_ms": tp,
                   "bound_ms": bt, "bound_by": by, "library_ms": tl,
                   "shape": f"B={b} KV={kv} G={g} Dh={dh} S={s} pos={pos_list}"}
    rec["max_abs_err"] = err_max
    return rec


# the paged kernels' serving shapes: one decode step of 4 slots at ragged
# positions (0, and one in the last of S_MAX/BLOCK = 5 blocks)
PAGED_POS = [S_MAX - 1, 0, 40, 63]


# the long-context shape: 2048 positions a sequence (128 blocks), ragged
PAGED_LONG_POS = [2047, 1023, 511, 0]
PAGED_LONG_CTX = 2048
# the cluster sweep: context lengths (all four sequences full) x cluster
# sizes x span limits of csrc/paged_attention.cu
SWEEP_CTX = (80, 256, 512, 1024, 2048, 4096)
SWEEP_CLUSTER = (1, 2, 4, 8)
SWEEP_SPAN = (8, 16, 32)


def _paged_operands(gen, device, kv_bits: int, pos_list=PAGED_POS,
                    n_ctx: int = S_MAX):
    """(q, k_pool, k_scale, v_pool, v_scale, page_table, pos) of one paged
    decode step: q (B, KV, G, Dh) bf16; a pool of 1 + B*n_ctx/BLOCK random
    blocks (kv8 int8 codes, kv4 nibble pairs, both with f32 scales; kv16
    bf16); a random permuted page table whose entries past each sequence's
    last live block are the null block 0."""
    import torch
    b, nb = len(pos_list), n_ctx // BLOCK
    nb_pool = 1 + b * nb
    q = torch.randn((b, KV_HEADS, GROUP, DH), generator=gen).to(
        device, torch.bfloat16)
    shape = (nb_pool, BLOCK, KV_HEADS, DH // 2 if kv_bits == 4 else DH)
    if kv_bits == 16:
        k, v = (torch.randn(shape, generator=gen).to(device, torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    else:
        lo = -128 if kv_bits == 4 else -127     # kv4: any byte is a nibble pair
        k, v = (torch.randint(lo, 128, shape, generator=gen,
                              dtype=torch.int8).to(device) for _ in range(2))
        ks, vs = ((torch.rand((nb_pool, BLOCK, KV_HEADS, 1), generator=gen)
                   * 0.02 + 1e-3).to(device) for _ in range(2))
    pt = (torch.randperm(nb_pool - 1, generator=gen) + 1).reshape(b, nb)
    for i, p in enumerate(pos_list):
        pt[i, p // BLOCK + 1:] = 0
    pos = torch.tensor(pos_list, dtype=torch.int32)
    return (q, k, ks, v, vs, pt.to(device, torch.int32), pos.to(device))


def _sdpa_paged(q, k, ks, v, vs, pt, pos, kv_bits):
    """Yardstick: gather the blocks dense, dequantize in f32, then f32
    ``scaled_dot_product_attention``.  Returns (B, KV, G, Dh)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.packing import unpack_nibbles
    from repro_torch.kernels.paged_attention import gather_pool
    b, kv, g, dh = q.shape

    def dense(leaf, scale):
        x = gather_pool(leaf, pt)                     # (B, S, KV, Dh')
        if kv_bits == 4:
            x = unpack_nibbles(x)
        x = x.float() if scale is None else x.float() * gather_pool(scale, pt)
        return x.permute(0, 2, 1, 3).repeat_interleave(g, 1)
    kf, vf = dense(k, ks), dense(v, vs)
    mask = (torch.arange(kf.shape[2], device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    out = F.scaled_dot_product_attention(
        q.float().reshape(b, kv * g, 1, dh), kf, vf, attn_mask=mask)
    return out.reshape(b, kv, g, dh)


def _paged_cost(q, k, ks, pt, rows: int, pos_list) -> tuple[float, float]:
    """(bytes, f32 operations) of paged attention for ``rows`` query rows
    over the positions <= pos of the sequences in ``pos_list``: each input
    read once (q rows, K and V of those positions with their scales, page
    table, pos), the f32 output written once."""
    kv, g, dh = q.shape[1:]
    valid = sum(min(p + 1, pt.shape[1] * BLOCK) for p in pos_list)
    row = k.shape[-1] * k.element_size() + (4 if ks is not None else 0)
    nbytes = (rows * q[0].numel() * q.element_size() + valid * kv * 2 * row
              + 4 * (pt.numel() + len(pos_list)) + 4 * rows * kv * g * dh)
    return nbytes, valid * kv * g * 4 * dh


def _paged_attention_record(gen, device):
    """``paged_attention`` against its f32 plain version at kv 8, 4 and 16
    (bf16 pool); the record carries kv8, the paged serving path's width."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    rec, err_max, times = None, 0.0, {}
    for kv_bits in (8, 4, 16):
        args = _paged_operands(gen, device, kv_bits)
        out = paged_attention(*args, kv_bits=kv_bits)
        ref = paged_attention_ref(*args, kv_bits=kv_bits,
                                  out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 + 1e-4 * ref.abs().max().item()
        check(err <= tol, f"paged_attention kv{kv_bits}: max |diff| {err} > "
                          f"{tol}")
        err_max = max(err_max, err)
        tk, tk_eager = time_ms(lambda: paged_attention(*args, kv_bits=kv_bits))
        tp, _ = time_ms(lambda: paged_attention_ref(
            *args, kv_bits=kv_bits, out_dtype=torch.float32))
        tl, _ = time_ms(lambda: _sdpa_paged(*args, kv_bits))
        nbytes, ops = _paged_cost(args[0], args[1], args[2], args[5],
                                  N_SLOTS, PAGED_POS)
        bt, by = bound(nbytes, ops, PEAK_F32)
        print(f"paged_attention kv{kv_bits} B={N_SLOTS} KV={KV_HEADS} "
              f"G={GROUP} Dh={DH} bs={BLOCK} pos={PAGED_POS}: max |diff| vs "
              f"f32 plain version {err:.3e} (tolerance {tol:.3e}); kernel "
              f"{tk:.5f} ms (eager call {tk_eager:.4f} ms), plain {tp:.5f} ms, "
              f"gather + sdpa f32 {tl:.5f} ms, bound {bt:.6f} ms ({by})")
        times[kv_bits] = tk
        if kv_bits == 8:
            rec = {"name": "paged_attention", "ms": tk, "plain_ms": tp,
                   "bound_ms": bt, "bound_by": by, "library_ms": tl,
                   "shape": f"kv8 B={N_SLOTS} KV={KV_HEADS} G={GROUP} Dh={DH} "
                            f"bs={BLOCK} pos={PAGED_POS}"}
    print(f"  kv8 / kv16 (bf16 pool) kernel time: {times[8] / times[16]:.3f}; "
          f"kv4 / kv16: {times[4] / times[16]:.3f}")
    rec["max_abs_err"] = max(err_max, _paged_long(gen, device))
    _cluster_sweep(gen, device)
    return rec


def _paged_check(out, ref, what: str) -> float:
    import torch
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-5 + 1e-4 * ref.abs().max().item()
    check(err <= tol, f"{what}: max |diff| {err} > {tol}")
    return err


def _paged_long(gen, device) -> float:
    """``paged_attention`` at the long-context shape against its f32 plain
    version at kv 4, 16 and 8; kv8 timed beside it, with the launch plan
    it takes."""
    import torch
    from repro_torch.kernels.paged_attention import (launch_plan,
                                                     paged_attention,
                                                     paged_attention_ref)
    err = 0.0
    for kv_bits in (4, 16, 8):
        args = _paged_operands(gen, device, kv_bits, PAGED_LONG_POS,
                               PAGED_LONG_CTX)
        err = max(err, _paged_check(
            paged_attention(*args, kv_bits=kv_bits),
            paged_attention_ref(*args, kv_bits=kv_bits,
                                out_dtype=torch.float32),
            f"paged_attention kv{kv_bits} long context"))
    plan = launch_plan(0, N_SLOTS, KV_HEADS, GROUP, DH, BLOCK,
                       PAGED_LONG_CTX // BLOCK, args[1], args[3])
    tk, tk_eager = time_ms(lambda: paged_attention(*args, kv_bits=8))
    tp, _ = time_ms(lambda: paged_attention_ref(
        *args, kv_bits=8, out_dtype=torch.float32), reps=5)
    tl, _ = time_ms(lambda: _sdpa_paged(*args, 8), reps=5)
    nbytes, ops = _paged_cost(args[0], args[1], args[2], args[5], N_SLOTS,
                              PAGED_LONG_POS)
    bt, by = bound(nbytes, ops, PEAK_F32)
    print(f"paged_attention long context pos={PAGED_LONG_POS} "
          f"(n_blocks {PAGED_LONG_CTX // BLOCK}, kv8 plan {plan}): max |diff| "
          f"at kv 4/16/8 {err:.3e}; kv8 kernel {tk:.5f} ms (eager call "
          f"{tk_eager:.4f} ms), plain {tp:.5f} ms, gather + sdpa f32 "
          f"{tl:.5f} ms, bound {bt:.6f} ms ({by})")
    return err


def _cluster_sweep(gen, device) -> None:
    """B2 kv8 with every sequence at the context length, through
    ``paged_attention_config`` at each cluster size and span limit, checked
    against the plain version and timed; the automatic plan beside it."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (launch_plan,
                                                     paged_attention_ref)
    lib = _build.library("paged_attention")
    print("  cluster sweep (kv8, B=4, every pos = n_ctx - 1; kernel ms at "
          "cluster size C x span limit):")
    for n_ctx in SWEEP_CTX:
        pos_list = [n_ctx - 1] * N_SLOTS
        n_ctx_pool = -(-n_ctx // BLOCK) * BLOCK
        q, k, ks, v, vs, pt, pos = _paged_operands(gen, device, 8, pos_list,
                                                   n_ctx_pool)
        ref = paged_attention_ref(q, k, ks, v, vs, pt, pos, kv_bits=8,
                                  out_dtype=torch.float32)
        out = torch.empty_like(ref)

        def run(c, span):
            _build.check(lib.paged_attention_config(
                q.data_ptr(), 2, k.data_ptr(), ks.data_ptr(), v.data_ptr(),
                vs.data_ptr(), 0, pt.data_ptr(), pos.data_ptr(),
                out.data_ptr(), N_SLOTS, k.shape[0], BLOCK, pt.shape[1],
                KV_HEADS, GROUP, DH, c, span, _build.stream_ptr(q)),
                "paged_attention_config")
        cells = []
        for c in SWEEP_CLUSTER:
            for span in SWEEP_SPAN:
                run(c, span)
                _paged_check(out, ref, f"paged_attention cluster {c} span "
                                       f"{span} n_ctx {n_ctx}")
                cells.append(f"C{c}/s{span} {time_ms(lambda: run(c, span))[0]:.5f}")
        plan = launch_plan(0, N_SLOTS, KV_HEADS, GROUP, DH, BLOCK, pt.shape[1],
                           k, v)
        print(f"    n_ctx {n_ctx:5d}: " + ", ".join(cells) +
              f"; automatic plan C={plan['cluster']} span {plan['span']}")


def _fused_decode_record(gen, device):
    """``fused_decode`` at kv8 with an f32 (576, 576) wo against its f32
    plain version for slot maps of 1, 3 and 4 rows (the last repeats a
    slot, as occupancy padding does); timed with all 4 slots live."""
    import torch
    from repro_torch.kernels.decode_fused import fused_decode, fused_decode_ref
    args = _paged_operands(gen, device, 8)
    q = args[0]
    wo = (torch.randn((q[0].numel(), D_MODEL), generator=gen) / 24).to(device)
    err_max = 0.0
    for sm_list in ([2], [0, 1, 3], [0, 2, 3, 3]):
        sm = torch.tensor(sm_list, dtype=torch.int32, device=device)
        out = fused_decode(*args, sm, wo, kv_bits=8)
        ref = fused_decode_ref(*args, sm, wo, kv_bits=8)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 + 1e-4 * ref.abs().max().item()
        check(err <= tol, f"fused_decode slot_map {sm_list}: max |diff| "
                          f"{err} > {tol}")
        for i, s in enumerate(sm_list):
            j = sm_list.index(s)
            check(torch.equal(out[i], out[j]),
                  f"fused_decode slot_map {sm_list}: rows {j} and {i} of "
                  f"slot {s} differ")
        err_max = max(err_max, err)
        print(f"fused_decode kv8 L={len(sm_list)} slot_map={sm_list} "
              f"wo=({q[0].numel()}, {D_MODEL}) f32: max |diff| vs f32 plain "
              f"version {err:.3e} (tolerance {tol:.3e}); duplicate rows equal")
    sm = torch.arange(N_SLOTS, dtype=torch.int32, device=device)
    tk, tk_eager = time_ms(lambda: fused_decode(*args, sm, wo, kv_bits=8))
    tp, _ = time_ms(lambda: fused_decode_ref(*args, sm, wo, kv_bits=8))
    tl, _ = time_ms(lambda: torch.matmul(
        _sdpa_paged(*args, 8).reshape(N_SLOTS, -1), wo))
    nbytes, ops = _paged_cost(q, args[1], args[2], args[5], N_SLOTS, PAGED_POS)
    k_in = q[0].numel()
    bt, by = bound(nbytes + 4 * k_in * D_MODEL + 4 * N_SLOTS
                   + 4 * N_SLOTS * (D_MODEL - k_in),     # out is (L, D)
                   ops + 2 * N_SLOTS * k_in * D_MODEL, PEAK_F32)
    print(f"  L={N_SLOTS}: kernel {tk:.5f} ms (eager call {tk_eager:.4f} ms), "
          f"plain {tp:.5f} ms, gather + sdpa f32 + torch.matmul {tl:.5f} ms, "
          f"bound {bt:.6f} ms ({by})")

    # the long-context shape, all four slots live
    largs = _paged_operands(gen, device, 8, PAGED_LONG_POS, PAGED_LONG_CTX)
    err_max = max(err_max, _paged_check(
        fused_decode(*largs, sm, wo, kv_bits=8),
        fused_decode_ref(*largs, sm, wo, kv_bits=8),
        "fused_decode long context"))
    lk, lk_eager = time_ms(lambda: fused_decode(*largs, sm, wo, kv_bits=8))
    lp, _ = time_ms(lambda: fused_decode_ref(*largs, sm, wo, kv_bits=8),
                    reps=5)
    ll, _ = time_ms(lambda: torch.matmul(
        _sdpa_paged(*largs, 8).reshape(N_SLOTS, -1), wo), reps=5)
    nbytes, ops = _paged_cost(q, largs[1], largs[2], largs[5], N_SLOTS,
                              PAGED_LONG_POS)
    lbt, lby = bound(nbytes + 4 * k_in * D_MODEL + 4 * N_SLOTS
                     + 4 * N_SLOTS * (D_MODEL - k_in),
                     ops + 2 * N_SLOTS * k_in * D_MODEL, PEAK_F32)
    print(f"fused_decode kv8 long context pos={PAGED_LONG_POS} L={N_SLOTS}: "
          f"max |diff| within 1e-5 + 1e-4 max|ref|; kernel {lk:.5f} ms (eager "
          f"call {lk_eager:.4f} ms), plain {lp:.5f} ms, gather + sdpa f32 + "
          f"torch.matmul {ll:.5f} ms, bound {lbt:.6f} ms ({lby})")
    return {"name": "fused_decode", "ms": tk, "plain_ms": tp, "bound_ms": bt,
            "bound_by": by, "library_ms": tl, "max_abs_err": err_max,
            "shape": f"kv8 L={N_SLOTS} KV={KV_HEADS} G={GROUP} Dh={DH} "
                     f"bs={BLOCK} pos={PAGED_POS} wo=({k_in}, {D_MODEL}) f32"}


# the activation quantizers' callers: one layer's seven decode projections
# quantize their (4, K) bf16 rows (K = 576 six times, 1536 once); ResNet-34
# stage-1 im2col rows; post-ReLU CNN rows (ResNet-34 stage 1, 64 channels;
# its stem at batch 32, 112x112x64, whose 77 MB in bf16 exceed the L2)
QUANT_DECODE_ROWS = [(4, k) for _, k in SMOLLM_DECODE_PROJ]
QUANT_HBM_ROWS = (32 * 112 * 112, 64)
QUANT_SHAPES = {
    "act_quant_signed_grouped": [(4, 576), (4, 1536), (8 * 56 * 56, 576)],
    "act_quant": [(8 * 56 * 56, 64), (4, 576), QUANT_HBM_ROWS],
    "act_quant_signed": [(8 * 56 * 56, 64), (4, 576), QUANT_HBM_ROWS],
}
# B7b's tensor form (the scale from all of x, then the codes: the card's
# path of core.act_quant_codes_signed), timed at an LM row block and the
# record's CNN rows
QUANT_TENSOR_TIMED = [(4, 576), (8 * 56 * 56, 64)]


def _quant_call(name, x, bits):
    """(kernel call, plain call) of one quantizer on rows ``x``, computed
    in x's dtype, with the scale its caller gives it: the engine's per-row
    absmax (B7c), the tensor absmax (B7b); B7a takes post-ReLU rows."""
    aq = importlib.import_module("repro_torch.kernels.act_quant")
    from repro_torch.kernels import ref
    qmax = (1 << (bits - 1)) - 1
    cd = x.dtype
    if name == "act_quant":
        return (lambda: aq.act_quant(x, bits=bits, compute_dtype=cd),
                lambda: ref.act_quant_ref(x, bits, compute_dtype=cd))
    if name == "act_quant_signed":
        amax = x.abs().amax().clamp_min(1e-8)
        s = (amax / amax.new_full((), qmax)).reshape(1)
        return (lambda: aq.act_quant_signed(x, s, bits=bits, compute_dtype=cd),
                lambda: ref.act_quant_signed_ref(x, bits, s, compute_dtype=cd))
    s = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax
    return (lambda: aq.act_quant_signed_grouped(x, s, bits=bits,
                                                compute_dtype=cd),
            lambda: ref.act_quant_signed_grouped_ref(x, bits, s,
                                                     compute_dtype=cd))


def _quant_rows(gen, device, name, m, f, dtype):
    import torch
    x = torch.randn((m, f), generator=gen) * 2
    if name == "act_quant":
        x = torch.relu(x) / 2                       # post-ReLU, some above 1
    return x.to(device, dtype)


def _quant_tensor_check(x, bits) -> None:
    """B7b's tensor form on x against its plain version: codes and scale
    ``torch.equal``, one ``act_quant_signed`` launch."""
    import torch
    from repro_torch.kernels import _build, ref
    aq = importlib.import_module("repro_torch.kernels.act_quant")
    before = _build.LAUNCHES["act_quant_signed"]
    q, s = aq.act_quant_signed_tensor(x, bits=bits)
    check(_build.LAUNCHES["act_quant_signed"] == before + 1,
          "act_quant_signed_tensor: not one launch")
    q_ref, s_ref = ref.act_quant_signed_tensor_ref(x, bits)
    torch.cuda.synchronize()
    check(torch.equal(s, s_ref) and torch.equal(q, q_ref),
          f"act_quant_signed_tensor {tuple(x.shape)} {x.dtype} bits={bits}: "
          f"scale {s.item()!r} against {s_ref.item()!r}, "
          f"{int((q != q_ref).sum())} codes differ from the plain version")


def _quant_tensor_times(gen, device) -> None:
    """B7b's tensor form timed in bf16 at 2 bits beside its plain version,
    the whole ``core.act_quant_codes_signed`` call and the former chain of
    that call (abs, amax, clamp_min, ``/ qmax`` by a Python number, then
    the given-scale kernel).  Returns {shape: (kernel ms, plain ms, bound
    ms, bound_by)}."""
    from repro_torch.core import act_quant_codes_signed
    from repro_torch.kernels import ref
    aq = importlib.import_module("repro_torch.kernels.act_quant")

    def chain(x):
        s = x.abs().amax().clamp_min(1e-8) / 1      # / qmax, 1 at 2 bits
        return aq.act_quant_signed(x, s.reshape(1), bits=2, compute_dtype=x.dtype), s

    import torch
    out = {}
    for (m, f) in QUANT_TENSOR_TIMED:
        x = _quant_rows(gen, device, "act_quant_signed", m, f, torch.bfloat16)
        tk = time_ms(lambda: aq.act_quant_signed_tensor(x, bits=2))[0]
        tp = time_ms(lambda: ref.act_quant_signed_tensor_ref(x, 2))[0]
        tc = time_ms(lambda: act_quant_codes_signed(x, 2))[0]
        tf = time_ms(lambda: chain(x))[0]
        bt, by = bound(3 * m * f + 4, 3 * m * f, PEAK_F32)
        print(f"  tensor form ({m}, {f}) bf16: kernel {tk:.5f} ms, "
              f"core.act_quant_codes_signed {tc:.5f} ms, former chain "
              f"(abs, amax, clamp_min, div, kernel) {tf:.5f} ms, plain "
              f"{tp:.5f} ms, bound {bt:.6f} ms ({by}), bound / kernel "
              f"{bt / tk:.2f}")
        out[(m, f)] = (tk, tp, bt, by)
    return out


def _quant_records(gen, device):
    """B7a/b/c against their plain versions, ``torch.equal``, at their
    callers' shapes in f32 and bf16 (compute in the rows' dtype) and at 2, 4
    and 8 bits, B7b also in its tensor form; timed in bf16 at 2 bits:
    B7a/B7b at the post-ReLU CNN shape, LM rows and the stem rows past the
    L2, B7b's tensor form at QUANT_TENSOR_TIMED (B7b's record: the form
    the port runs, at the CNN shape; B7a's: the CNN shape), B7c's
    scale-taking form at its shapes (its record comes from its row form,
    :func:`_quant_rows_record`)."""
    import torch
    records = []
    for name, shapes in QUANT_SHAPES.items():
        for (m, f) in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x = _quant_rows(gen, device, name, m, f, dtype)
                for bits in (2, 4, 8):
                    kern, plain = _quant_call(name, x, bits)
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"{name} ({m}, {f}) {dtype} bits={bits}: not equal "
                          f"to the plain version ({int((got != want).sum())} "
                          "codes differ)")
                    if name == "act_quant_signed":
                        _quant_tensor_check(x, bits)
                del x
        print(f"{name}: torch.equal to the plain version at {shapes} x "
              "(f32, bf16) x bits (2, 4, 8)"
              + (", and its tensor form (codes and scale, one launch)"
                 if name == "act_quant_signed" else ""))

        def times(m, f):
            x = _quant_rows(gen, device, name, m, f, torch.bfloat16)
            kern, plain = _quant_call(name, x, 2)
            tk, tk_eager = time_ms(kern)
            tp, _ = time_ms(plain)
            scale_bytes = {"act_quant": 0, "act_quant_signed": 2}.get(name, 2 * m)
            bt, by = bound(2 * m * f + scale_bytes + m * f, 3 * m * f, PEAK_F32)
            return tk, tk_eager, tp, bt, by

        if name == "act_quant_signed_grouped":
            rows, label = QUANT_DECODE_ROWS, "one layer's 7 decode projections, bf16"
        else:
            rows, label = shapes[:1], f"post-ReLU CNN rows {shapes[0]}, bf16"
            if name == "act_quant_signed":
                label = "given scale, " + label
        t_k = t_p = b_ms = 0.0
        for (m, f) in rows:
            tk, tk_eager, tp, bt, by = times(m, f)
            t_k, t_p, b_ms = t_k + tk, t_p + tp, b_ms + bt
        print(f"  {label}: kernel {t_k:.5f} ms (last eager call "
              f"{tk_eager:.4f} ms), plain {t_p:.5f} ms, bound {b_ms:.6f} ms "
              f"({by}), bound / kernel {b_ms / t_k:.2f}; no single PyTorch "
              "call computes it")
        for (m, f) in shapes:
            if (m, f) in rows:
                continue
            tk, tk_eager, tp, bt, by = times(m, f)
            print(f"  ({m}, {f}) bf16: kernel {tk:.5f} ms, plain {tp:.5f} ms, "
                  f"bound {bt:.6f} ms ({by}), bound / kernel {bt / tk:.2f}, "
                  f"{(3 * m * f) / tk / 1e6:.1f} GB/s")
        if name == "act_quant_signed_grouped":
            records.append(_quant_rows_record(gen, device))
        elif name == "act_quant_signed":
            # the record is the tensor form: the one the port runs (core.
            # act_quant_codes_signed), whose launches phase 4i counts
            (m, f) = shapes[0]
            tk, tp, bt, by = _quant_tensor_times(gen, device)[(m, f)]
            records.append({"name": name, "ms": tk, "plain_ms": tp,
                            "bound_ms": bt, "bound_by": by,
                            "library_ms": None, "max_abs_err": 0.0,
                            "shape": f"tensor form, post-ReLU CNN rows "
                                     f"{(m, f)}, bf16"})
        else:
            records.append({"name": name, "ms": t_k, "plain_ms": t_p,
                            "bound_ms": b_ms, "bound_by": by,
                            "library_ms": None, "max_abs_err": 0.0,
                            "shape": label})
    return records


# the row form of B7c (scale and codes in one launch): the engine's rows at
# decode and in a prefill chunk, the CNNs' im2col rows (ResNet-34 stage 1
# and stage 3 at batch 8), AlexNet's fc inputs at batch 8 and 64, a ragged F
QUANT_ROW_SHAPES = [(4, 576), (4, 1536), (32, 576), (32, 1536),
                    (8 * 56 * 56, 576), (8 * 14 * 14, 2304), (8, 9216),
                    (64, 9216), (37, 100)]


def _quant_rows_record(gen, device):
    """B7c's row form (``act_quant_signed_rows``: the scale ``max(amax|x|,
    1e-8) / qmax`` and the codes in one launch) against its plain version,
    ``torch.equal`` for codes and scales, at QUANT_ROW_SHAPES plus all-zero
    rows, f32 and bf16, 2/4/8 bits, one launch each; and against the
    engine's former chain (abs, amax, clamp_min, ``/ qmax`` by a Python
    number, then the scale-taking kernel), whose scale PyTorch's CUDA
    division computes as a product with 1/qmax (the scales that differ are
    counted).  Timed in bf16 at 2 bits beside that chain: one layer's seven
    decode quantizations (the record) and the CNN rows in f32 and bf16."""
    import torch
    from repro_torch.kernels import _build, ref
    aq = importlib.import_module("repro_torch.kernels.act_quant")

    def chain(x, bits):
        s = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / ((1 << (bits - 1)) - 1)
        return aq.act_quant_signed_grouped(x, s, bits=bits, compute_dtype=x.dtype), s

    n_calls, recip = 0, {}
    for (m, f) in QUANT_ROW_SHAPES + [(3, 576)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = _quant_rows(gen, device, "act_quant_signed_rows", m, f, dtype)
            if m == 3:
                x = torch.zeros_like(x)
            for bits in (2, 4, 8):
                before = _build.LAUNCHES["act_quant_signed_grouped"]
                q, s = aq.act_quant_signed_rows(x, bits=bits)
                check(_build.LAUNCHES["act_quant_signed_grouped"] == before + 1,
                      "act_quant_signed_rows: not one launch")
                q_ref, s_ref = ref.act_quant_signed_rows_ref(x, bits)
                _, s_chain = chain(x, bits)
                torch.cuda.synchronize()
                check(torch.equal(s, s_ref) and torch.equal(q, q_ref),
                      f"act_quant_signed_rows ({m}, {f}) {dtype} bits={bits}: "
                      f"{int((s != s_ref).sum())} scales and "
                      f"{int((q != q_ref).sum())} codes differ from the plain "
                      "version")
                key = (str(dtype)[6:], bits)
                recip[key] = recip.get(key, 0) + int((s != s_chain).sum())
                n_calls += 1
    print(f"act_quant_signed_rows: {n_calls} calls torch.equal to the plain "
          f"version (codes and scales) at {QUANT_ROW_SHAPES} and all-zero rows "
          "x (f32, bf16) x bits (2, 4, 8), one launch each; scales that the "
          f"former chain's reciprocal product rounds otherwise: {recip}")

    def cost(m, f, in_bytes):
        return bound(in_bytes * m * f + m * f + in_bytes * m, 3 * m * f, PEAK_F32)

    t_k = t_p = t_c = t_g = b_ms = 0.0
    for (m, f) in QUANT_DECODE_ROWS:
        x = _quant_rows(gen, device, "act_quant_signed_rows", m, f, torch.bfloat16)
        s = chain(x, 2)[1]
        t_k += time_ms(lambda: aq.act_quant_signed_rows(x, bits=2))[0]
        t_p += time_ms(lambda: ref.act_quant_signed_rows_ref(x, 2))[0]
        t_c += time_ms(lambda: chain(x, 2))[0]
        t_g += time_ms(lambda: aq.act_quant_signed_grouped(
            x, s, bits=2, compute_dtype=x.dtype))[0]
        b_ms += cost(m, f, 2)[0]
    print(f"  one layer's 7 decode quantizations, bf16: row form {t_k:.5f} ms, "
          f"former chain (abs, amax, clamp_min, div, kernel) {t_c:.5f} ms, of "
          f"which the scale-taking kernel {t_g:.5f} ms; plain row form "
          f"{t_p:.5f} ms, bound {b_ms:.6f} ms (bytes); no single PyTorch call "
          "computes it")
    for (m, f) in ((8 * 56 * 56, 576), (8 * 14 * 14, 2304), (64, 9216)):
        for dtype in (torch.float32, torch.bfloat16):
            x = _quant_rows(gen, device, "act_quant_signed_rows", m, f, dtype)
            tk = time_ms(lambda: aq.act_quant_signed_rows(x, bits=2), reps=5)[0]
            tc = time_ms(lambda: chain(x, 2), reps=5)[0]
            ib = x.element_size()
            bt, by = cost(m, f, ib)
            print(f"  ({m}, {f}) {str(dtype)[6:]}: row form {tk:.5f} ms, former "
                  f"chain {tc:.5f} ms, bound {bt:.6f} ms ({by}), row form / "
                  f"bound {tk / bt:.2f}, {(ib + 1) * m * f / tk / 1e6:.1f} GB/s")
    return {"name": "act_quant_signed_grouped", "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None,
            "max_abs_err": 0.0,
            "shape": "row form, one layer's 7 decode quantizations, bf16"}


# flash attention: (label, B, S, KV, G, Dh, window, softcap, timed)
FLASH_CASES = (("prefill", 1, PROMPT, KV_HEADS, GROUP, DH, 0, 0.0, True),
               ("forward", 2, 2048, KV_HEADS, GROUP, DH, 0, 0.0, True),
               ("window 256 + softcap 50", 1, 1024, 2, 2, 128, 256, 50.0, False))


def _flash_cost(b, s, kv, g, dh, window, in_bytes):
    """(bytes, operations) of causal attention over these inputs: q, k, v
    read once, the f32 output written once; 4 * Dh operations (q.k and
    p.v) per visible (query head, key) pair."""
    pairs = sum(min(i + 1, window) if window > 0 else i + 1 for i in range(s))
    nbytes = b * s * kv * (g + 2) * dh * in_bytes + 4 * b * s * kv * g * dh
    return nbytes, 4 * dh * b * kv * g * pairs


def _flash_record(gen, device):
    """``flash_attention`` against its f32 plain version at the prefill,
    forward and a window + softcap shape, in f32 and bf16, within 1e-5 of
    max|out|; timed in both dtypes (bf16: the bf16 tensor-core kernel, f32:
    the TF32 one, three products a pair) beside
    ``scaled_dot_product_attention`` in the same dtype (is_causal, K/V
    expanded to KV * G heads), the bf16 forward shape being the record.
    The f32 bound counts the three TF32 products at the TF32 peak; the f32
    CUDA-core figure is printed beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    rec, err_max = None, 0.0
    for label, b, s, kv, g, dh, window, softcap, timed in FLASH_CASES:
        kw = dict(causal=True, window=window, softcap=softcap)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, kv, g, dh), generator=gen).to(device, dtype)
            k, v = (torch.randn((b, s, kv, dh), generator=gen).to(device, dtype)
                    for _ in range(2))
            out = flash_attention(q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            check(err <= tol, f"flash_attention {label} {dtype}: max |diff| "
                              f"{err} > {tol}")
            err_max = max(err_max, err)
            print(f"flash_attention {label} B={b} S={s} KV={kv} G={g} Dh={dh} "
                  f"{dtype}: max |diff| vs f32 plain version {err:.3e} "
                  f"(tolerance {tol:.3e} = 1e-5 of max|out|)")
            if not timed:
                continue
            bf16 = dtype == torch.bfloat16
            qh = q.reshape(b, s, kv * g, dh).transpose(1, 2).contiguous()
            kh, vh = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                      for t in (k, v))
            tk, tk_eager = time_ms(lambda: flash_attention(q, k, v, **kw), reps=5)
            tp, _ = time_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=5)
            tl, _ = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), reps=5)
            nbytes, ops = _flash_cost(b, s, kv, g, dh, window, 2 if bf16 else 4)
            if bf16:
                bt, by = bound(nbytes, ops, PEAK_BF16)
                name, extra = "bf16 (bf16 tensor cores)", ""
            else:
                bt, by = bound(nbytes, 3 * ops, PEAK_TF32)
                name = "f32 (TF32 tensor cores, three products)"
                extra = (f"; f32 CUDA-core bound "
                         f"{bound(nbytes, ops, PEAK_F32)[0]:.5f} ms")
            print(f"  {label} {name}: kernel {tk:.4f} ms (eager call "
                  f"{tk_eager:.4f} ms), plain {tp:.4f} ms, sdpa "
                  f"{str(dtype)[6:]} is_causal {tl:.4f} ms, kernel / sdpa "
                  f"{tk / tl:.2f}, bound {bt:.5f} ms ({by}){extra}, "
                  f"{ops / tk / 1e9:.1f} TFLOP/s")
            if label == "forward" and bf16:
                rec = {"name": "flash_attention", "ms": tk, "plain_ms": tp,
                       "bound_ms": bt, "bound_by": by, "library_ms": tl,
                       "shape": f"bf16 B={b} S={s} KV={kv} G={g} Dh={dh} causal"}
    rec["max_abs_err"] = err_max
    _flash_probs_bf16(device)
    return rec


# probs_bf16 (the reference's attn_probs_bf16): the record's forward shape
# and whisper-base's encoder (B 4, S 1500, 8 heads, no mask)
FLASH_PB_CASES = (("forward", 2, 2048, KV_HEADS, GROUP, DH, True),
                  ("whisper encoder", 4, 1500, 8, 1, 64, False))


def _flash_probs_bf16(device) -> None:
    """B8 with ``probs_bf16`` against the plain version of the flag (the
    kernel's key tiles, P and V rounded to bf16) in bf16 and f32.  Two
    checks: max |diff| within 2^-7 max|v| + 1e-5 max|out| (the two round
    the same tiles' P from f32 scores that differ in the last bits: a p
    next to a rounding boundary may take the neighbouring bf16 value, one
    ulp, at most 2^-7 p); and mean |diff| within PB_KERNEL_SHARE of the
    flag's own effect (mean |plain with the flag - plain without|), where
    flips are rare, so that a kernel that ignored the flag would fail: the
    flag-off kernel, the control, must exceed the share.  Timed beside the
    flag-off kernel and SDPA.  The bound counts the tensor-core products
    the flag leaves (``kernels.costs.flash_attention_mma``): bf16 one term
    for q.k and one for p.v (flag off: two for p.v), f32 three TF32 terms
    for q.k and one product of bf16 values for p.v (flag off: three TF32),
    each at its type's peak.  Inputs from a generator of its own (the
    later records keep their draws)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import costs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator().manual_seed(31)
    for label, b, s, kv, g, dh, causal in FLASH_PB_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q = torch.randn((b, s, kv, g, dh), generator=gen).to(device, dtype)
            k, v = (torch.randn((b, s, kv, dh), generator=gen).to(device, dtype)
                    for _ in range(2))
            on = dict(causal=causal, probs_bf16=True)
            out = flash_attention(q, k, v, **on)
            out_off = flash_attention(q, k, v, causal=causal)
            ref = flash_attention_ref(q, k, v, **on)
            ref_off = flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 2.0 ** -7 * v.float().abs().max().item() + \
                1e-5 * ref.abs().max().item()
            effect = (ref - ref_off).abs().mean().item()
            share = (out - ref).abs().mean().item() / effect
            control = (out_off - ref).abs().mean().item() / effect
            what = f"flash_attention probs_bf16 {label} {dtype}"
            check(err <= tol, f"{what}: max |diff| {err} > {tol}")
            check(share <= PB_KERNEL_SHARE, f"{what}: mean |diff| {share} of "
                  f"the flag's effect > {PB_KERNEL_SHARE}")
            check(control > PB_KERNEL_SHARE, f"{what}: the flag-off kernel "
                  f"is within {control} <= {PB_KERNEL_SHARE} of the flag's "
                  "effect")
            qh = q.reshape(b, s, kv * g, dh).transpose(1, 2).contiguous()
            kh, vh = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                      for t in (k, v))
            tk, _ = time_ms(lambda: flash_attention(q, k, v, **on), reps=5)
            toff, _ = time_ms(lambda: flash_attention(q, k, v, causal=causal),
                              reps=5)
            tp, _ = time_ms(lambda: flash_attention_ref(q, k, v, **on), reps=2)
            tl, _ = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal), reps=5)
            _, nbytes = costs.flash_attention(b, s, s, kv, g, dh,
                                              2 if bf16 else 4, causal, 0)
            qk, pv = costs.flash_attention_mma(b, s, s, kv, g, dh,
                                               2 if bf16 else 4, causal, 0,
                                               probs_bf16=True)
            bt, by = bound_terms(nbytes, (
                (qk, PEAK_BF16 if bf16 else PEAK_TF32), (pv, PEAK_BF16)))
            print(f"{what}: B={b} S={s} KV={kv} G={g} Dh={dh} "
                  f"{'causal' if causal else 'no mask'}: max |diff| vs its "
                  f"plain version {err:.3e} (tolerance {tol:.3e} = 2^-7 "
                  f"max|v| + 1e-5 max|out|); mean |diff| {share:.5f} of the "
                  f"flag's own effect {effect:.4e} (limit {PB_KERNEL_SHARE}; "
                  f"control, the flag-off kernel: {control:.5f}); kernel "
                  f"{tk:.4f} ms, flag off {toff:.4f} ms (ratio "
                  f"{tk / toff:.3f}), plain {tp:.4f} ms, sdpa {tl:.4f} ms "
                  f"(kernel / sdpa {tk / tl:.2f}), bound {bt:.5f} ms ({by}; "
                  f"q.k {qk / 1e9:.2f} G, p.v {pv / 1e9:.2f} G tensor-core "
                  "operations)")


# mean |kernel - plain version| of B8 with probs_bf16, as a share of the
# flag's own effect on the plain version (mean |with - without|)
PB_KERNEL_SHARE = 0.25


def phase_kernels(device):
    import torch
    print("== 3. kernels against their plain versions", flush=True)
    gen = torch.Generator().manual_seed(0)
    records = [_matmul_record("ternary_matmul", gen, device, 2),
               _matmul_record("packed_matmul", gen, device, 2, timed=False),
               _matmul_record("packed_matmul", gen, device, 4),
               _matmul_record("packed_matmul", gen, device, 8, timed=False),
               _binary_record(gen, device),
               _attention_record(gen, device),
               _paged_attention_record(gen, device),
               _fused_decode_record(gen, device),
               *_quant_records(gen, device),
               _flash_record(gen, device)]
    _ternary_cnn_times(gen, device)
    _ternary_k_steps(gen, device)
    _qmatmul_variants(gen, device)
    return records


# ---------------------------------------------------------------------------
def _requests(cfg, n: int, gen: int):
    """``n`` requests of 62-64 prompt tokens (PROMPT - rid % 3) whose first
    CHUNK tokens are one shared prefix, ``gen`` new tokens each; every call
    makes the same tokens."""
    import numpy as np
    from repro_torch.runtime.serving import Request, RequestOptions
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, CHUNK)
    return [Request(rid, np.concatenate(
                [prefix, rng.integers(0, cfg.vocab, PROMPT - rid % 3 - CHUNK)]
            )[None].astype(np.int64), options=RequestOptions(max_new=gen))
            for rid in range(n)]


def _warm(batcher, cfg):
    """First-call set-up (one request through a throw-away batcher)."""
    import torch
    for r in _requests(cfg, 1, 2):
        batcher.submit(r)
    batcher.run()
    torch.cuda.synchronize()


def _run(batcher, reqs, card, label, each_step=None):
    """Serve ``reqs`` through ``batcher``, the launch counts set to 0 just
    before and read just after; check that every request completed with
    in-vocabulary tokens, print the metrics.  ``each_step(batcher)`` runs
    after every scheduler step.  Returns ({rid: tokens}, launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import engine
    for r in reqs:
        batcher.submit(r)
    engine.reset_launch_counts()
    done = []
    for _ in range(10_000):
        done += batcher.step()
        if each_step is not None:
            each_step(batcher)
        if batcher.idle:
            break
    torch.cuda.synchronize()
    launches = engine.launch_counts()
    print(f"{label} launches: {launches}")
    # the logits span the padded vocabulary (granite: 49155 -> 49664), and
    # random weights give the padding rows logits like any other
    vocab = batcher.model.cfg.padded_vocab
    check(len(done) == len(reqs), f"{label}: served {len(done)} of "
                                  f"{len(reqs)} requests")
    for r in done:
        check(len(r.output) == r.max_new,
              f"{label} request {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < vocab for t in r.output),
              f"{label} request {r.rid}: token outside the logits' "
              f"{vocab} rows {r.output}")
    m = batcher.metrics
    s = m.summary()
    print(m.format())
    decode_tps = m.decode_slot_tokens / s["throughput"]["wall_s"]
    print(f"[{card}] {label}: served {len(reqs)} requests x "
          f"{reqs[0].max_new} tokens: {s['throughput']['tok_per_s']:.1f} tok/s "
          f"overall, TTFT p50 {s['ttft_ms']['p50']:.1f} ms, ITL p50 "
          f"{s['itl_ms']['p50']:.2f} ms, decode tok/s {decode_tps:.1f} "
          "(decode-step tokens per wall second)")
    done.sort(key=lambda r: r.rid)
    print("sample generations (first 8 tokens/request):\n"
          f"{np.array([r.output[:8] for r in done])}")
    return {r.rid: list(r.output) for r in done}, launches


def _serve(device, card, precision: str, n_req: int, gen: int):
    """Serve ``n_req`` requests of ``gen`` tokens at full width through the
    continuous batcher, after one warm-up request; returns (model, params,
    serving config, requests, streams, kernel launches of the measured
    run, its metrics)."""
    import torch
    from repro_torch.models import build_model, to_serving
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    cfg = model_config(precision=precision, kv_bits=8)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator().manual_seed(0), device)
    params = to_serving(params, cfg, tp=1)
    torch.cuda.synchronize()
    print(f"params: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.padded_vocab}, {cfg.dtype}, {precision}; init + to_serving "
          f"{time.time() - t0:.1f} s")
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK)
    _warm(ContinuousBatcher(model, params, sc), cfg)
    reqs = _requests(cfg, n_req, gen)
    batcher = ContinuousBatcher(model, params, sc)
    streams, launches = _run(batcher, reqs, card, precision)
    return model, params, sc, reqs, streams, launches, batcher.metrics


def phase_serve(device, card):
    import torch
    from repro_torch.models import build_model
    print("== 4. serving path: smollm-135m 2xT kv8 bf16 (full width)",
          flush=True)
    model, params, sc, reqs, streams, launches, m = _serve(device, card,
                                                           "2xT", N_REQ, GEN)
    calls, n_proj = _model_calls(m), N_PROJ * model.cfg.n_layers
    print(f"act_quant_signed_grouped launches {launches['act_quant_signed_grouped']}"
          f" over {m.decode_steps} decode steps + {m.prefill_chunks} prefill "
          f"chunks; ternary_matmul {launches['ternary_matmul']}")
    for name in ("act_quant_signed_grouped", "ternary_matmul"):
        check(launches[name] == n_proj * calls,
              f"2xT: {name} launched {launches[name]} times in {calls} model "
              f"calls, not {n_proj} per call")
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
          f"per decode step (B={N_SLOTS}): {per_call['decode']}; activation "
          f"quantizer dispatches traced per chunk / step: "
          f"{cmp['quant_dispatches']}")
    for c in ("chunk", "decode"):
        check(per_call[c]["act_quant_signed_grouped"] == n_proj
              and cmp["quant_dispatches"][c] == n_proj,
              f"2xT {c}: {per_call[c]['act_quant_signed_grouped']} quantizer "
              f"launches ({cmp['quant_dispatches'][c]} traced), not {n_proj}")
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

    cfg32 = model_config(precision="fp32", kv_bits=8, dtype="float32")
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
    launches4 = _serve(device, card, "4x4", N_SLOTS, 4)[5]
    check(launches4["packed_matmul"] > 0, "packed_matmul never launched")
    launches = dict(launches, packed_matmul=launches4["packed_matmul"])
    return launches, (model, params, sc, streams)


def phase_whole_prompt(device, card, dense):
    """4g: whole-prompt admission (chunk_size 0) on the dense phase's
    params and requests: each prompt prefilled in one call, its attention
    through ``flash_attention``; ``dense`` is that phase's (model, params,
    sc, streams)."""
    from repro_torch.runtime.serving import ContinuousBatcher
    print("== 4g. whole-prompt serving: smollm-135m 2xT kv8 bf16, "
          "chunk_size 0 (full width)", flush=True)
    model, params, sc, chunked = dense
    cfg = model.cfg
    whole = dataclasses.replace(sc, chunk_size=0)
    _warm(ContinuousBatcher(model, params, whole), cfg)
    batcher = ContinuousBatcher(model, params, whole)
    streams, launches = _run(batcher, _requests(cfg, N_REQ, GEN), card,
                             "2xT whole-prompt")
    m = batcher.metrics
    calls, n_proj = m.decode_steps + m.prefill_full, N_PROJ * cfg.n_layers
    print(f"flash_attention launches {launches['flash_attention']} over "
          f"{m.prefill_full} whole prefills ({cfg.n_layers} layers); "
          f"act_quant_signed_grouped {launches['act_quant_signed_grouped']} and "
          f"ternary_matmul {launches['ternary_matmul']} over {calls} model "
          f"calls; decode_attention {launches['decode_attention']} over "
          f"{m.decode_steps} decode steps")
    check(m.prefill_full == N_REQ and m.prefill_chunks == 0,
          f"whole-prompt run: {m.prefill_full} whole prefills, "
          f"{m.prefill_chunks} chunks")
    check(launches["flash_attention"] == cfg.n_layers * m.prefill_full,
          f"flash_attention launched {launches['flash_attention']} times for "
          f"{m.prefill_full} prefills, not {cfg.n_layers} per prefill")
    for name in ("act_quant_signed_grouped", "ternary_matmul"):
        check(launches[name] == n_proj * calls,
              f"whole-prompt: {name} launched {launches[name]} times in "
              f"{calls} model calls, not {n_proj} per call")
    check(launches["decode_attention"] == cfg.n_layers * m.decode_steps,
          "whole-prompt: not one decode_attention launch per layer and step")
    agree = sum(streams[r] == chunked[r] for r in streams)
    print(f"2xT whole-prompt streams equal to the chunked run's: "
          f"{agree}/{N_REQ} (not required: whole-prompt and chunked prefill "
          "are not bit-identical in the reference either)")
    return launches


FWD_B, FWD_S = 2, 2048


def _forward_pair(model, params, batch):
    """Model.forward and Model.loss through the kernels and through the
    plain versions on the card; the kernels' launches of one forward, its
    time (CUDA events, after a warm-up) and one forward under
    ``torch.profiler``: wall time, device busy time and the flash-attention
    kernels' share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import engine
    model.forward(params, batch)
    torch.cuda.synchronize()
    engine.reset_launch_counts()
    lk, aux = model.forward(params, batch)
    torch.cuda.synchronize()
    launches = engine.launch_counts()
    ms = _event_ms(lambda: model.forward(params, batch), 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    dev, busy, by_name = _profile_device(prof)
    flash = [v for name, v in by_name.items() if "flash_attn" in name]
    lp, _ = model.forward(params, batch, backend="torch")
    loss_k = model.loss(params, batch).item()
    loss_p = model.loss(params, batch, backend="torch").item()
    check(bool(torch.isfinite(lk).all()) and lk.shape == (
        FWD_B, FWD_S, model.cfg.padded_vocab) and float(aux) == 0.0,
          f"forward: logits {tuple(lk.shape)} not finite or aux {float(aux)}")
    return {"launches": launches, "ms": ms, "prof_ms": prof_ms,
            "busy_ms": busy / 1e3, "device_ops": len(dev),
            "flash_ms": sum(t for _, t in flash) / 1e3,
            "flash_n": sum(n for n, _ in flash),
            "gap": (lk - lp).abs().max().item(),
            "scale": lp.abs().max().item(),
            "argmax": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item(),
            "loss_k": loss_k, "loss_p": loss_p}


def phase_forward(device, card):
    """4h: Model.forward / Model.loss at full width, B=2, S=2048: fp32
    weights in float32 (bounded against the plain versions), 2xT bf16
    (reported)."""
    import torch
    from repro_torch.models import build_model, to_serving
    print(f"== 4h. Model.forward / loss: smollm-135m, B={FWD_B}, S={FWD_S} "
          "(full width)", flush=True)
    gen = torch.Generator().manual_seed(3)
    for precision, dtype in (("fp32", "float32"), ("2xT", "bfloat16")):
        cfg = model_config(precision=precision, kv_bits=8, dtype=dtype)
        model = build_model(cfg)
        params = to_serving(model.init(torch.Generator().manual_seed(0),
                                       device), cfg, tp=1)
        batch = {k: torch.randint(0, cfg.vocab, (FWD_B, FWD_S),
                                  generator=gen).to(device)
                 for k in ("tokens", "labels")}
        r = _forward_pair(model, params, batch)
        got = {k: v for k, v in r["launches"].items() if v}
        rel = abs(r["loss_k"] - r["loss_p"]) / abs(r["loss_p"])
        print(f"[{card}] {precision} {dtype}: forward {r['ms']:.2f} ms "
              f"({FWD_B * FWD_S / r['ms'] * 1e3:.0f} tokens/s), launches per "
              f"forward {got}; logits kernels vs plain versions max |diff| "
              f"{r['gap']:.3e} of max|logit| {r['scale']:.3e}, argmax equal "
              f"on {r['argmax']:.4f} of positions; loss {r['loss_k']:.6f} vs "
              f"{r['loss_p']:.6f} (relative {rel:.2e})")
        print(f"  profiled forward: wall {r['prof_ms']:.2f} ms, device "
              f"operations {r['device_ops']}, device busy {r['busy_ms']:.3f} "
              f"ms (idle share {1 - r['busy_ms'] / r['prof_ms']:.4f}); "
              f"flash_attention kernels {r['flash_ms']:.3f} ms over "
              f"{r['flash_n']} launches ({r['flash_ms'] / r['busy_ms']:.4f} "
              f"of busy time)")
        check(r["launches"]["flash_attention"] == cfg.n_layers,
              f"{precision} forward: {r['launches']['flash_attention']} "
              f"flash_attention launches, not {cfg.n_layers}")
        if precision == "fp32":
            check(r["gap"] <= 1e-4 * r["scale"],
                  f"fp32 forward logits differ by {r['gap']} > "
                  f"{1e-4 * r['scale']}")
            check(rel <= 1e-5, f"fp32 loss differs by {rel} relative")
        else:
            n_proj = N_PROJ * cfg.n_layers
            check(r["launches"]["act_quant_signed_grouped"] == n_proj
                  and r["launches"]["ternary_matmul"] == n_proj,
                  f"2xT forward: launches {got}, not {n_proj} quantizer and "
                  "matmul launches")
            print("  2xT bf16: not bounded (one bf16 rounding of an attention "
                  "output flips 2-bit codes downstream)")
        _forward_probs_bf16(cfg, params, batch, card)
        del model, params
        torch.cuda.empty_cache()


def _forward_probs_bf16(cfg, params, batch, card) -> None:
    """``Model.forward`` with ``attn_probs_bf16`` at S = FWD_S (past the
    reference's 1024-position chunk): B8 launched with ``probs_bf16`` on
    every layer (launch counts and dispatch kinds), the logits against the
    plain path's (``backend="torch"``: the plain version of the flag, the
    kernel's tiles) and against the flag-off forward's.  The two paths
    round the same tiles' P, but a p next to a rounding boundary may take
    the neighbouring bf16 value in one of them (one ulp, 2^-7 p at most,
    where the flag's own rounding moves every p by up to 2^-8 p), and
    through 30 layers those flips move the fp32 logits by more than the
    flag-off forward's 1e-4 of max|logit|.  So at fp32, on this batch and
    PB_FWD_BATCHES - 1 more, mean |kernels - plain| is held to PB_FWD_SHARE
    of the flag's own effect (mean |plain with the flag - the flag-off
    forward|), and two controls must exceed it: plain paths that round only
    P or only V (what a kernel applying half the flag would give).  At 2xT
    it is reported."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    model, off_model = build_model(dataclasses.replace(
        cfg, attn_probs_bf16=True)), build_model(cfg)
    fp32 = cfg.precision == "fp32"
    gen = torch.Generator().manual_seed(31)
    batches = [batch] + [{k: torch.randint(0, cfg.vocab, v.shape,
                                           generator=gen).to(v.device)
                          for k, v in batch.items()}
                         for _ in range(PB_FWD_BATCHES - 1 if fp32 else 0)]
    for i, bt in enumerate(batches):
        engine.reset_launch_counts()
        with engine.dispatch_trace() as ev:
            lk, _ = model.forward(params, bt)
        torch.cuda.synchronize()
        launches = engine.launch_counts()["flash_attention"]
        kinds = {e.kind for e in ev if e.op == "flash_attention"}
        lp, _ = model.forward(params, bt, backend="torch")
        off, _ = off_model.forward(params, bt)
        gap = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        print(f"[{card}] {cfg.precision} {cfg.dtype} attn_probs_bf16 batch "
              f"{i}: flash_attention launches {launches}, dispatch kinds "
              f"{sorted(kinds)}; logits kernels vs plain versions max |diff| "
              f"{gap:.3e} of max|logit| {scale:.3e}, against the flag-off "
              f"forward {(lk - off).abs().max().item():.3e}; argmax equal on "
              f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}")
        check(bool(torch.isfinite(lk).all()), "attn_probs_bf16 forward: "
              "logits not finite")
        check(launches == cfg.n_layers
              and kinds == {engine.ATTN_FLASH_PROBS_BF16},
              f"attn_probs_bf16 forward: {launches} launches, kinds {kinds}")
        if not fp32:
            continue
        effect = (lp - off).abs().mean().item()
        share = (lk - lp).abs().mean().item() / effect
        ctl = {}
        for half in ("P", "V"):
            with _half_probs_bf16(half):
                lh, _ = model.forward(params, bt, backend="torch")
            ctl[half] = (lh - lp).abs().mean().item() / effect
        print(f"  fp32 batch {i}: mean |kernels - plain| {share:.5f} of the "
              f"flag's own effect {effect:.4e} (max: "
              f"{gap / (lp - off).abs().max().item():.4f}); limit "
              f"{PB_FWD_SHARE}; controls, plain paths rounding only P / only "
              f"V: {ctl['P']:.5f} / {ctl['V']:.5f}")
        check(share <= PB_FWD_SHARE, f"fp32 attn_probs_bf16 forward batch "
              f"{i}: mean |diff| {share} of the flag's effect > "
              f"{PB_FWD_SHARE}")
        check(min(ctl.values()) > PB_FWD_SHARE, f"fp32 attn_probs_bf16 "
              f"forward batch {i}: a half-rounding control within "
              f"{PB_FWD_SHARE} of the flag's effect: {ctl}")


# mean |kernels - plain path| of the fp32 attn_probs_bf16 forward, as a
# share of the flag's own effect; the batches it is read on
PB_FWD_SHARE = 0.25
PB_FWD_BATCHES = 3


@contextlib.contextmanager
def _half_probs_bf16(half: str):
    """The plain version of B8's ``probs_bf16`` rounding only P ("P") or
    only V ("V"), in place of the whole flag, for the controls of
    :func:`_forward_probs_bf16`.  Only P: P_bf16 V = P_bf16 bf16(V) +
    P_bf16 (V - bf16(V)), the second product from the flag's plain version
    too (it rounds V - bf16(V), already 2^-9 of |v|, by 2^-9 of itself)."""
    import torch
    from repro_torch.kernels import ref
    full = ref.flash_attention_ref

    def half_ref(q, k, v, *, probs_bf16=False, **kw):
        if not probs_bf16:
            return full(q, k, v, **kw)
        vb = v.to(torch.bfloat16).to(v.dtype)
        if half == "V":
            return full(q, k, vb, **kw)
        return full(q, k, v, probs_bf16=True, **kw) + \
            full(q, k, v - vb, probs_bf16=True, **kw)
    ref.flash_attention_ref = half_ref
    try:
        yield
    finally:
        ref.flash_attention_ref = full


def phase_core_quant(device, card):
    """4i: the port's integer-code quantizers, ``core.act_quant_codes_unsigned``
    on post-ReLU CNN activations (batch 8, ResNet-34 stage 1: 56x56x64) and
    ``core.act_quant_codes_signed`` on LM rows (4 tokens' embeddings of the
    served model, bf16), each against its plain version; the signed scale
    also against the true quotient max(amax, 1e-8) / qmax computed in
    float64 on the host and rounded to bf16, and the signed call's device
    operations under ``torch.profiler`` (one launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import act_quant_codes_signed, act_quant_codes_unsigned
    from repro_torch.kernels import engine, ref
    print("== 4i. core activation quantizers (act_quant_codes_unsigned / "
          "_signed)", flush=True)
    gen = torch.Generator(device=device).manual_seed(4)
    relu = torch.relu(torch.randn((8, 56, 56, 64), generator=gen,
                                  device=device)) / 2
    cfg = model_config(precision="2xT", kv_bits=8)
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                      device=device).to(torch.bfloat16)
    rows = emb[torch.arange(4, device=device) * 97 + 1]
    engine.reset_launch_counts()
    codes_u = act_quant_codes_unsigned(relu, 2)
    codes_s, scale = act_quant_codes_signed(rows, 8)
    torch.cuda.synchronize()
    launches = engine.launch_counts()
    print(f"launches: {{'act_quant': {launches['act_quant']}, "
          f"'act_quant_signed': {launches['act_quant_signed']}}}")
    check(launches["act_quant"] == 1 and launches["act_quant_signed"] == 1
          and sum(launches.values()) == 2, f"core quantizers: {launches}")
    want_u = ref.act_quant_ref(relu.reshape(-1, 64), 2).reshape(relu.shape)
    want_s, want_scale = ref.act_quant_signed_tensor_ref(rows, 8)
    check(torch.equal(codes_u, want_u) and torch.equal(codes_s, want_s)
          and torch.equal(scale, want_scale),
          "core quantizers differ from the plain versions")
    amax = max(rows.cpu().double().abs().max().item(), 1e-8)
    host = torch.tensor(amax / 127, dtype=torch.float64).to(torch.bfloat16)
    check(scale.item() == host.item(), f"act_quant_codes_signed scale "
          f"{scale.item()!r}, the true quotient {host.item()!r}")
    # many calls between idle margins: the profiler drops the device
    # operations of a window of a few microseconds
    calls = 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(calls):
            act_quant_codes_signed(rows, 8)
        torch.cuda.synchronize()
        time.sleep(0.01)
    dev, _, by_name = _profile_device(prof)
    print(f"act_quant_codes_signed: {len(dev)} device operation(s) over "
          f"{calls} calls (torch.profiler): {sorted(by_name)}")
    check(len(by_name) == 1 and "act_quant_tensor_kernel" in next(iter(by_name))
          and calls // 2 <= len(dev) <= calls,
          f"act_quant_codes_signed: {len(dev)} device operations of "
          f"{sorted(by_name)} over {calls} calls, not one launch a call")
    print(f"unsigned 2-bit codes of {tuple(relu.shape)} f32 (histogram "
          f"{torch.bincount(codes_u.flatten().long(), minlength=4).tolist()}) "
          f"and signed 8-bit codes of {tuple(rows.shape)} bf16 (scale "
          f"{scale.item():.6e}, equal to the host's float64 quotient rounded "
          "to bf16): torch.equal to the plain versions")
    return launches


def _paged_config(**kw):
    """The paged batcher's configuration: kv8 blocks of BLOCK positions,
    the dense phase's slots, s_max and chunk."""
    from repro_torch.runtime.serving import ServingConfig
    return ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK,
                         kv_bits=8, block_size=BLOCK, **kw)


def phase_paged(device, card, dense):
    """4c: the paged batcher at full width on the dense phase's params and
    requests; ``dense`` is that phase's (model, params, sc, streams)."""
    from repro_torch.models import build_model
    from repro_torch.runtime.kvcache import PagedBatcher
    print("== 4c. paged serving path: smollm-135m 2xT kv8 bf16, blocks of "
          f"{BLOCK} (full width)", flush=True)
    dense_model, params, _, dense_streams = dense
    cfg = dense_model.cfg
    # paged serving quantizes KV in its block pool: the model's own dense
    # cache quantizer stays off
    model = build_model(dataclasses.replace(cfg, kv_bits=0))
    _warm(PagedBatcher(model, params, _paged_config()), cfg)
    reqs = _requests(cfg, N_REQ, GEN)
    batcher = PagedBatcher(model, params, _paged_config())
    streams, launches = _run(batcher, reqs, card, "2xT paged kv8")
    m = batcher.metrics
    print(f"paged_attention launches {launches['paged_attention']} over "
          f"{m.decode_steps} decode steps ({cfg.n_layers} layers); prefix-hit "
          f"tokens {m.prefix_hit_tokens} of {m.prompt_tokens} prompt tokens; "
          f"kv blocks peak {m.kv_blocks_peak} of {m.kv_blocks_total}")
    check(launches["paged_attention"] == cfg.n_layers * m.decode_steps,
          f"paged_attention launched {launches['paged_attention']} times in "
          f"{m.decode_steps} decode steps, not {cfg.n_layers} per step")
    check(launches["ternary_matmul"] > 0, "paged run launched no "
                                          "ternary_matmul")
    check(m.prefix_hit_tokens > 0, "no prefix-cache hit on shared prefixes")
    agree = sum(streams[r] == dense_streams[r] for r in streams)
    print(f"2xT paged kv8 streams equal to the dense kv8 batcher's on the "
          f"same requests: {agree}/{N_REQ}")

    # one paged chunk and decode step, kernels vs plain versions, as the
    # dense phase compares them (the plain side's paged attention is the
    # kernel's own f32-dequant plain version)
    cmp = _compare_paged(model, params, reqs[0].tokens, device, probe=True)
    tol0 = 1e-5 + 1e-4 * cmp["attn0_scale"]
    print(f"launches per paged prefill chunk (C={CHUNK}): "
          f"{cmp['launches']['chunk']}; per paged decode step (B={N_SLOTS}): "
          f"{cmp['launches']['decode']}")
    print(f"2xT bf16 paged, kernels vs plain versions (f32 K/V dequant): "
          f"prefill_chunk_paged max |dlogit| {cmp['chunk']:.3e} (tolerance "
          f"0); decode_step_paged layer 0 attention max |diff| "
          f"{cmp['attn0']:.3e} (tolerance {tol0:.3e}, identical inputs); "
          f"attention outputs equal in bf16 in the first "
          f"{cmp['layers_equal']} of {cmp['n_layers']} layers; logits max "
          f"|dlogit| {cmp['decode']:.3e} of max|logit| {cmp['scale']:.3e}, "
          f"greedy tokens agree on {cmp['agree']}/{N_SLOTS} rows (not "
          "bounded)")
    check(cmp["chunk"] == 0.0, f"2xT prefill_chunk_paged logits differ by "
                               f"{cmp['chunk']}")
    check(cmp["q0_equal"], "2xT decode_step_paged: layer 0 attention inputs "
                           "differ between kernels and plain versions")
    check(cmp["attn0"] <= tol0, f"2xT decode_step_paged layer 0 attention "
                                f"differs by {cmp['attn0']} > {tol0}")
    check(cmp["launches"]["decode"]["paged_attention"] == cfg.n_layers,
          "paged decode step: not one paged_attention launch per layer")

    # an overcommitted pool: 9 allocatable blocks for 4 slots of up to 5
    over = PagedBatcher(model, params, _paged_config(num_blocks=10))
    n_checked = []

    def check_pool(b):
        b.check_pool()
        n_checked.append(1)
    ostreams, _ = _run(over, _requests(cfg, N_REQ, GEN), card,
                       "2xT paged kv8, 10-block pool", each_step=check_pool)
    om = over.metrics
    agree = sum(ostreams[r] == streams[r] for r in streams)
    print(f"overcommitted pool: {om.preemptions} preemptions, "
          f"{om.recomputed_tokens} recomputed tokens, {om.blocks_evicted} "
          f"evicted blocks; check_pool() clean after each of {len(n_checked)} "
          f"steps; streams equal to the unpreempted run: {agree}/{N_REQ}")
    check(om.preemptions > 0, "the 10-block pool preempted nothing")
    return launches, model, streams


def phase_fused(device, card):
    """4d: fp32 weights (float ``wo``) through the fused decode kernel."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.kvcache import PagedBatcher
    print("== 4d. paged serving path, fp32 weights (fused decode): "
          "smollm-135m kv8 bf16 (full width)", flush=True)
    cfg = model_config(precision="fp32", kv_bits=0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    _warm(PagedBatcher(model, params, _paged_config()), cfg)
    batcher = PagedBatcher(model, params, _paged_config())
    _, launches = _run(batcher, _requests(cfg, N_SLOTS, GEN), card,
                       "fp32 paged kv8")
    steps = batcher.metrics.decode_steps
    print(f"fused_decode launches {launches['fused_decode']} over {steps} "
          f"decode steps ({cfg.n_layers} layers)")
    check(launches["fused_decode"] == cfg.n_layers * steps,
          f"fused_decode launched {launches['fused_decode']} times in "
          f"{steps} decode steps, not {cfg.n_layers} per step")
    prompt = _requests(cfg, 1, GEN)[0].tokens
    served = (model, params)
    del batcher

    cfg32 = model_config(precision="fp32", kv_bits=0, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator().manual_seed(0), device)
    c32 = _compare_paged(model32, params32, prompt, device, probe=False)
    tol = 1e-4 * c32["scale"]
    print(f"fp32 weights, float32, paged kv8, kernels vs plain versions: "
          f"prefill_chunk_paged max |dlogit| {c32['chunk']:.3e}; "
          f"decode_step_paged max |dlogit| {c32['decode']:.3e} (tolerance "
          f"{tol:.3e} = 1e-4 of max|logit| {c32['scale']:.3e}), greedy tokens "
          f"agree on {c32['agree']}/{N_SLOTS} rows; launches "
          f"{c32['launches']['decode']}")
    check(c32["launches"]["decode"]["fused_decode"] == cfg32.n_layers,
          "float32 paged decode step: not one fused_decode launch per layer")
    check(c32["decode"] <= tol, f"float32 decode_step_paged logits differ by "
                                f"{c32['decode']} > {tol}")
    return launches, served


GEN_1X1 = 8


def _model_calls(m) -> int:
    """Model calls (decode steps, prefill chunks, whole prefills) a batcher
    made, from its metrics."""
    return m.decode_steps + m.prefill_chunks + m.prefill_full


def phase_serve_1x1(device, card):
    """4e: the 1x1 (XNOR-popcount) path at full width, dense then paged."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.kvcache import PagedBatcher
    print("== 4e. 1x1 serving path: smollm-135m, 1-bit signed activations x "
          "binary weights, kv8 bf16 (full width)", flush=True)
    model, params, sc, reqs, streams, launches, m = _serve(
        device, card, "1x1", N_SLOTS, GEN_1X1)
    cfg = model.cfg
    # every projection whose K packs into 32-bit words runs the XNOR kernel
    # (the single-card layout, tp=1, packs all seven: K = 576 or 1536)
    per_call = sum(p["wt_packed"].shape[0] for layer in params["blocks"].values()
                   for part in layer.values() for p in part.values()
                   if isinstance(p, dict) and "wt_packed" in p
                   and p["wt_packed"].dtype == torch.int32)
    calls = _model_calls(m)
    print(f"binary_matmul launches {launches['binary_matmul']} over "
          f"{m.decode_steps} decode steps + {m.prefill_chunks} prefill chunks "
          f"= {per_call} per call ({per_call // cfg.n_layers} packed "
          f"projections x {cfg.n_layers} layers); decode_attention "
          f"{launches['decode_attention']}")
    check(launches["binary_matmul"] == per_call * calls,
          f"1x1: binary_matmul launched {launches['binary_matmul']} times in "
          f"{calls} model calls, not {per_call} per call")
    check(launches["decode_attention"] == cfg.n_layers * m.decode_steps,
          "1x1: not one decode_attention launch per layer and decode step")

    cmp = _compare_backends(model, params, sc, reqs[0].tokens, device)
    tol0 = 1e-5 + 1e-4 * cmp["attn0_scale"]
    print(f"launches per prefill chunk (C={CHUNK}): {cmp['launches']['chunk']}; "
          f"per decode step (B={N_SLOTS}): {cmp['launches']['decode']}")
    print(f"1x1 bf16, kernels vs plain versions (f32 K/V dequant): "
          f"prefill_chunk max |dlogit| {cmp['chunk']:.3e} (tolerance 0); "
          f"decode step layer 0 attention max |diff| {cmp['attn0']:.3e} "
          f"(tolerance {tol0:.3e}, identical inputs); attention outputs "
          f"equal in bf16 in the first {cmp['layers_equal']} of "
          f"{cmp['n_layers']} layers; logits max |dlogit| {cmp['decode']:.3e} "
          f"of max|logit| {cmp['scale']:.3e}, greedy tokens agree on "
          f"{cmp['agree']}/{N_SLOTS} rows (not bounded)")
    for c in ("chunk", "decode"):
        check(cmp["launches"][c]["binary_matmul"] == per_call,
              f"1x1 {c}: {cmp['launches'][c]['binary_matmul']} binary_matmul "
              f"launches, not {per_call}")
    check(cmp["chunk"] == 0.0, f"1x1 prefill_chunk logits differ by "
                               f"{cmp['chunk']}")
    check(cmp["q0_equal"], "1x1 decode step: layer 0 attention inputs "
                           "differ between kernels and plain versions")
    check(cmp["attn0"] <= tol0, f"1x1 decode step layer 0 attention differs "
                                f"by {cmp['attn0']} > {tol0}")

    paged = build_model(dataclasses.replace(cfg, kv_bits=0))
    _warm(PagedBatcher(paged, params, _paged_config()), cfg)
    batcher = PagedBatcher(paged, params, _paged_config())
    pstreams, plaunch = _run(batcher, _requests(cfg, N_SLOTS, GEN_1X1), card,
                             "1x1 paged kv8")
    pm = batcher.metrics
    pcalls = _model_calls(pm)
    agree = sum(pstreams[r] == streams[r] for r in streams)
    print(f"1x1 paged: binary_matmul {plaunch['binary_matmul']} over "
          f"{pcalls} model calls ({pm.decode_steps} decode steps, "
          f"{pm.prefill_chunks} prefill chunks) = "
          f"{plaunch['binary_matmul'] / pcalls:.0f} per call; paged_attention "
          f"{plaunch['paged_attention']} = "
          f"{plaunch['paged_attention'] / pm.decode_steps:.0f} per decode step; "
          f"prefix-hit tokens {pm.prefix_hit_tokens}; streams equal to the "
          f"dense 1x1 run's: {agree}/{len(streams)}")
    check(plaunch["binary_matmul"] == per_call * pcalls,
          "1x1 paged: not one binary_matmul launch per packed projection "
          "and model call")
    check(plaunch["paged_attention"] == cfg.n_layers * pm.decode_steps,
          "1x1 paged: not one paged_attention launch per layer and step")
    return launches, (model, params, sc)


# the CNNs: batch of the kernel-vs-plain check, and of the images/s timing
CNN_BATCH = 8
CNN_RATE_BATCH = {"alexnet": 64, "resnet34": 32}


def _profile_device(prof):
    """(device events, busy us, {name: (count, us)}) of a profile: busy is
    the union of the device operations' intervals."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(dev), "torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + (hi - lo), a, b
        else:
            hi = max(hi, b)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    return dev, busy + hi - lo, by_name


def phase_cnn(device, card):
    """4f: AlexNet and ResNet-34 at full width in serving form."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import engine
    from repro_torch.models import cnn
    print("== 4f. the paper's CNNs: AlexNet (width 1) and ResNet-34, 1000 "
          "classes, 224x224x3, float32 (TF32 off), random weights from seed 0",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    nets = {
        "alexnet": (cnn.alexnet_init(gen, device),
                    lambda p, x, prec, backend=None: cnn.alexnet_apply(
                        p, x, prec, backend=backend), 6),
        "resnet34": (cnn.resnet_init(gen, device, depth=34),
                     lambda p, x, prec, backend=None: cnn.resnet_apply(
                         p, x, 34, prec, backend=backend), 35)}
    launches = {}
    for name, (params, apply, n_packed) in nets.items():
        x = torch.randn((CNN_BATCH, 224, 224, 3), generator=gen, device=device)
        lf = apply(params, x, "fp32")
        torch.cuda.synchronize()
        check(lf.shape == (CNN_BATCH, 1000) and bool(torch.isfinite(lf).all()),
              f"{name} fp32: logits {tuple(lf.shape)} not finite")
        print(f"{name} fp32 batch {CNN_BATCH}: logits {tuple(lf.shape)} finite, "
              f"max|logit| {lf.abs().max().item():.4e}")
        for prec, kern in (("2xT", "ternary_matmul"), ("1x1", "binary_matmul")):
            sv = cnn.cnn_to_serving(params, prec)
            engine.reset_launch_counts()
            lk = apply(sv, x, prec)
            torch.cuda.synchronize()
            got = engine.launch_counts()
            lp = apply(sv, x, prec, backend="torch")
            torch.cuda.synchronize()
            gap, scale = (lk - lp).abs().max().item(), lp.abs().max().item()
            top1 = int((lk.argmax(-1) == lp.argmax(-1)).sum())
            print(f"{name} {prec} batch {CNN_BATCH}: launches per forward "
                  f"{ {k: v for k, v in got.items() if v} }; logits kernels vs "
                  f"plain versions max |diff| {gap:.3e} (tolerance "
                  f"{1e-5 * scale:.3e} = 1e-5 of max|logit| {scale:.4e}), "
                  f"top-1 identical on {top1}/{CNN_BATCH}")
            if scale == 0.0:
                # the reference's 1x1 semantics (unsigned 1-bit requant, so
                # {0, 1} activations) with random weights: they die out
                # before the head, and this comparison checks nothing
                print(f"  {name} {prec}: every logit is 0 (activations die "
                      "out; see ROADMAP.md, reference caveats)")
            # at 2xT every quantized conv (the int8-codes first layer too)
            # quantizes its im2col rows per row through B7c first
            n_quant = n_packed + 1 if prec == "2xT" else 0
            check(got[kern] == n_packed
                  and got["act_quant_signed_grouped"] == n_quant
                  and sum(got.values()) == n_packed + n_quant,
                  f"{name} {prec}: launches {got}, not {n_packed} {kern} and "
                  f"{n_quant} act_quant_signed_grouped")
            check(bool(torch.isfinite(lk).all()), f"{name} {prec}: non-finite")
            check(gap <= 1e-5 * scale and top1 == CNN_BATCH,
                  f"{name} {prec}: kernel logits differ by {gap} (top-1 "
                  f"{top1}/{CNN_BATCH})")
            launches[(name, prec)] = got[kern]

            b = CNN_RATE_BATCH[name]
            xb = torch.randn((b, 224, 224, 3), generator=gen, device=device)
            apply(sv, xb, prec)                              # warm-up
            torch.cuda.synchronize()
            ms = _event_ms(lambda: apply(sv, xb, prec), 5)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                apply(sv, xb, prec)
                torch.cuda.synchronize()
            dev, busy, by_name = _profile_device(prof)
            kern_us = sum(t for n_, (c, t) in by_name.items()
                          if "qmm_int8" in n_ or "xnor_" in n_)
            print(f"[{card}] {name} {prec} batch {b}: forward {ms:.2f} ms "
                  f"(median of 5, CUDA events), {b / ms * 1e3:.1f} images/s; "
                  f"profiled forward: {len(dev)} device operations, busy "
                  f"{busy / 1e3:.2f} ms, {kern} kernels {kern_us / 1e3:.2f} ms")
            for n_, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]:
                print(f"  {t / 1e3:8.3f} ms  {c:4d}x  {n_[:90]}")
            del sv, xb
        del params
        torch.cuda.empty_cache()
    return launches


SAMPLING = dict(temperature=0.8, top_k=50, seed=11)


def _sampled(reqs, rids=None):
    """``reqs`` with SAMPLING set on the rids in ``rids`` (all when None)."""
    for r in reqs:
        if rids is None or r.rid in rids:
            r.options = dataclasses.replace(r.options, **SAMPLING)
    return reqs


def _streams(batcher, reqs):
    """Serve ``reqs`` quietly; check every request completed in-vocabulary;
    returns {rid: tokens}."""
    import torch
    for r in reqs:
        batcher.submit(r)
    done = batcher.run()
    torch.cuda.synchronize()
    vocab = batcher.model.cfg.vocab
    check(len(done) == len(reqs), f"served {len(done)} of {len(reqs)}")
    check(all(len(r.output) == r.max_new and all(0 <= t < vocab
                                                 for t in r.output)
              for r in done), "a request's tokens are short or out of range")
    return {r.rid: list(r.output) for r in done}


def _select_ms(cfg, reqs, device) -> tuple[float, float]:
    """Host ms of one next-token selection over N_SLOTS rows of logits of
    the model's width on the card (median of 30, synced): the greedy argmax
    alone, and every row sampled (a generator each, the sort, the mask)."""
    import torch
    from repro_torch.runtime.serving import select_tokens
    lg = torch.randn((N_SLOTS, cfg.padded_vocab),
                     generator=torch.Generator().manual_seed(3)).to(device)
    rows = _sampled(reqs[:N_SLOTS])
    out = []
    for sampled in (False, True):
        ts = []
        for _ in range(30):
            t0 = time.perf_counter()
            greedy = lg.argmax(-1)
            tok = select_tokens(lg, greedy, rows) if sampled else greedy
            tok.cpu()
            ts.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(ts))
    return out[0], out[1]


def _check_trace(doc, label) -> None:
    """Chrome-trace consistency of an exported document: B/E balance per
    track, flow edges after their start, complete events with a duration;
    step spans covering >= 95% of the window; each engine dispatch instant
    distinct."""
    from repro_torch.runtime.tracing import span_coverage
    stacks, started = {}, set()
    for e in doc["traceEvents"]:
        ph = e["ph"]
        if ph == "B":
            stacks.setdefault(e["tid"], []).append(e["name"])
        elif ph == "E":
            check(bool(stacks.get(e["tid"])), f"{label}: E without B {e}")
            stacks[e["tid"]].pop()
        elif ph == "X":
            check(e["dur"] >= 0.0, f"{label}: negative duration {e}")
        elif ph == "s":
            started.add(e["id"])
        elif ph in ("t", "f"):
            check(e["id"] in started, f"{label}: flow edge before start {e}")
    check(all(not st for st in stacks.values()), f"{label}: unclosed spans")
    cov = span_coverage(doc)
    dispatch = [json.dumps([e["name"], e["args"]], sort_keys=True)
                for e in doc["traceEvents"]
                if e.get("cat") == "engine" and e["ph"] == "i"]
    n_tuning = sum(e.get("name") == "tuning_cache" for e in doc["traceEvents"])
    names = {e.get("name") for e in doc["traceEvents"]}
    print(f"{label} trace: {len(doc['traceEvents'])} events "
          f"({doc['otherData']['dropped_events']} dropped), step-span "
          f"coverage {cov:.4f}, {len(dispatch)} dispatch instants "
          f"({len(set(dispatch))} distinct), {n_tuning} tuning_cache "
          "counter samples")
    check(n_tuning > 0, f"{label}: no tuning_cache counter in the trace")
    check(cov >= 0.95, f"{label}: step spans cover {cov:.4f} < 0.95")
    check(len(dispatch) == len(set(dispatch)) > 0,
          f"{label}: dispatch instants not distinct")
    for name in ("step", "decode", "prefill_chunk", "admit", "first_token",
                 "finish", "device:decode", "host_gap"):
        check(name in names, f"{label}: no {name!r} event in the trace")


def _traced(card, label, make, reqs, want):
    """Serve ``reqs`` through ``make(trace_config)`` with the flight
    recorder and the profiler on; the streams must equal ``want`` (the
    untraced run's); the exported document is checked; prints the
    profiler's summary."""
    from repro_torch.runtime.tracing import TraceConfig
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        batcher = make(TraceConfig(profile=True, path=path))
        got = _streams(batcher, reqs)
        batcher.tracer.detach_engine()
        doc = batcher.tracer.to_perfetto(path)
        check(json.loads(Path(path).read_text()) == doc,
              f"{label}: the written trace differs from the document")
    agree = sum(got[r] == want[r] for r in want)
    print(f"{label}: traced + profiled streams equal to the untraced run's: "
          f"{agree}/{len(want)}")
    check(agree == len(want), f"{label}: tracing changed a stream")
    _check_trace(doc, label)
    summ = batcher.profiler.summary()
    for step in ("decode", "prefill_chunk"):
        s = summ[step]
        print(f"[{card}] {label} profile[{step}]: {s['steps']} steps, device "
              f"{s['device_ms']['p50']:.3f} ms p50 (p90 "
              f"{s['device_ms']['p90']:.3f}), host gap "
              f"{s['host_ms']['p50']:.3f} ms p50 (p90 "
              f"{s['host_ms']['p90']:.3f}), host_frac {s['host_frac']:.4f}")
    return summ


def _cli_itl(args) -> float:
    """The serving CLI's ITL p50 (ms) with ``args``, read from the metrics
    summary it writes."""
    from repro_torch.launch import serve as cli
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "metrics.json")
        cli.main(args + ["--metrics-json", path])
        return json.loads(Path(path).read_text())["itl_ms"]["p50"]


def phase_sampling(device, card, dense, paged):
    """4j: sampling and the flight recorder at full width; ``dense`` is
    phase 4's (model, params, sc, streams), ``paged`` phase 4c's (model,
    streams)."""
    from repro_torch.kernels import engine
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    from repro_torch.runtime.tracing import TraceConfig
    print("== 4j. sampling and the flight recorder: smollm-135m 2xT kv8 bf16 "
          "(full width)", flush=True)
    model, params, sc, greedy = dense
    paged_model, paged_greedy = paged
    cfg = model.cfg
    odd = {r for r in range(N_REQ) if r % 2}
    mixed, launches = _run(ContinuousBatcher(model, params, sc),
                           _sampled(_requests(cfg, N_REQ, GEN), odd), card,
                           "2xT dense, odd rids sampled (T 0.8, top-k 50, "
                           "seed 11)")
    check(launches["ternary_matmul"] > 0 and launches["decode_attention"] > 0,
          "the sampled run launched no kernel")
    same = sum(mixed[r] == greedy[r] for r in range(N_REQ) if r not in odd)
    print(f"greedy rows of the mixed batch equal to phase 4's streams: "
          f"{same}/{N_REQ - len(odd)}; sampled rows differing from phase 4's "
          f"greedy streams: {sum(mixed[r] != greedy[r] for r in odd)}/"
          f"{len(odd)}")
    check(same == N_REQ - len(odd), "a greedy row of the mixed batch differs "
                                    "from the all-greedy run")
    check(any(mixed[r] != greedy[r] for r in odd), "sampling changed nothing")
    solo_sc = ServingConfig(n_slots=1, s_max=S_MAX, chunk_size=CHUNK)
    solo = {}
    for r in _sampled(_requests(cfg, N_REQ, GEN // 2), odd):
        if r.rid in odd:
            solo.update(_streams(ContinuousBatcher(model, params, solo_sc),
                                 [r]))
    agree = sum(solo[r] == mixed[r][:GEN // 2] for r in odd)
    print(f"sampled requests served alone (1 slot, {GEN // 2} tokens) equal "
          f"to the mixed run's first {GEN // 2}: {agree}/{len(odd)}")
    check(agree == len(odd), "a sampled stream depends on the batch")
    again = _streams(ContinuousBatcher(model, params, sc),
                     _sampled(_requests(cfg, N_REQ, GEN), odd))
    print(f"second identical run equal to the first: "
          f"{sum(again[r] == mixed[r] for r in mixed)}/{N_REQ}")
    check(again == mixed, "a second identical run gave other streams")
    paged_mixed = _streams(PagedBatcher(paged_model, params, _paged_config()),
                           _sampled(_requests(cfg, N_REQ, GEN), odd))
    n_eq = sum(paged_mixed[r] == mixed[r] for r in mixed)
    n_greedy = sum(paged_mixed[r] == mixed[r] for r in mixed if r not in odd)
    print(f"paged batcher, the same requests: streams equal to the dense "
          f"run's {n_eq}/{N_REQ} (greedy rows {n_greedy}/{N_REQ - len(odd)}; "
          "phase 4c requires no paged-dense equality)")

    summ = {
        "dense": _traced(card, "2xT dense", lambda t: ContinuousBatcher(
            model, params, dataclasses.replace(sc, trace=t)),
            _requests(cfg, N_REQ, GEN), greedy),
        "paged": _traced(card, "2xT paged kv8", lambda t: PagedBatcher(
            paged_model, params, _paged_config(trace=t)),
            _requests(cfg, N_REQ, GEN), paged_greedy)}
    check(engine._DISPATCH_LISTENER is None, "a tracer left its listener")

    # the decode step with every row sampled beside the all-greedy traced
    # run: the profiler's decode bracket is the step's wall time (the step
    # ends in the host copy of the tokens), and the selection alone
    prof = ContinuousBatcher(model, params, dataclasses.replace(
        sc, trace=TraceConfig(enabled=False, profile=True)))
    _streams(prof, _sampled(_requests(cfg, N_REQ, GEN)))
    g = summ["dense"]["decode"]["device_ms"]["p50"]
    smp = prof.profiler.summary()["decode"]["device_ms"]["p50"]
    sel_g, sel_s = _select_ms(cfg, _requests(cfg, N_REQ, GEN), device)
    print(f"[{card}] dense 2xT decode step wall time p50 (B={N_SLOTS}): all "
          f"greedy {g:.3f} ms (the traced run), every row sampled {smp:.3f} "
          f"ms ({smp - g:+.3f} ms, one run each: host spread); the "
          f"selection alone over {N_SLOTS} rows of {cfg.padded_vocab}: greedy "
          f"argmax {sel_g:.3f} ms, every row sampled {sel_s:.3f} ms "
          f"({sel_s - sel_g:+.3f} ms a step)")

    args = ["--requests", str(N_SLOTS), "--slots", str(N_SLOTS),
            "--prompt-len", str(CHUNK), "--gen", str(GEN)]
    itl = {False: [], True: []}
    for profiled in (False, True, True, False):
        itl[profiled].append(_cli_itl(args + ["--profile"] * profiled))
    print(f"[{card}] serving CLI (dense 2xT kv8 bf16, {N_SLOTS} x {GEN} "
          f"tokens, prompts of {CHUNK}; runs without, with, with, without "
          f"--profile): ITL p50 without {itl[False][0]:.2f} / "
          f"{itl[False][1]:.2f} ms, with {itl[True][0]:.2f} / "
          f"{itl[True][1]:.2f} ms")
    return summ


# ---------------------------------------------------------------------------
# 4l: self-speculative decoding and the adaptive server
# ---------------------------------------------------------------------------
SPEC_K = 3
ADAPTIVE_POOL = 256 << 20        # bytes; every lane sizes its pool to it
N_PREMIUM, N_BURST = 4, 12


def _top2_gap(model, params, prompt, stream, d, device):
    """(top-2 gap, max|logit|) of the plain versions' logits after
    ``prompt`` + ``stream[:d]`` (the token ``stream[d]`` is chosen from)."""
    import numpy as np
    import torch
    toks = np.concatenate([prompt[0], np.asarray(stream[:d], prompt.dtype)])
    tokens = torch.from_numpy(toks[None]).to(device)
    logits, _ = model.prefill(params, {"tokens": tokens}, tokens.shape[1] + 1,
                              backend="torch")
    row = logits[0, -1].to(torch.float32)
    top = row.topk(2).values
    return (top[0] - top[1]).item(), row.abs().max().item()


def _equal_or_near_tie(label, model, params, reqs, got, want, device) -> int:
    """Every stream of ``got`` equals its stream in ``want``, or parts from
    it where ``want``'s token was a near tie: a top-2 logit gap at most 1e-4
    of max|logit| (phase 4's bound; the gap from the plain versions).
    Prints each parting; returns the count of equal streams."""
    n_eq = 0
    for r in reqs:
        g, w = got[r.rid], want[r.rid]
        if g == w:
            n_eq += 1
            continue
        d = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        gap, scale = _top2_gap(model, params, r.tokens, w, d, device)
        print(f"{label}: request {r.rid} parts at token {d} ({g[d]} for "
              f"{w[d]}): top-2 logit gap {gap:.3e}, 1e-4 of max|logit| "
              f"{1e-4 * scale:.3e} (near-tie exception)")
        check(gap <= 1e-4 * scale,
              f"{label}: request {r.rid} parts at token {d} where the top-2 "
              f"gap {gap:.3e} > 1e-4 of max|logit| {scale:.3e}")
    print(f"{label}: streams equal {n_eq}/{len(reqs)}")
    return n_eq


def _count_draft_steps(batcher, first_trace: list):
    """Wrap ``batcher``'s draft steps: the launch counts of each (a list of
    dicts, returned) and the first one's engine dispatches into
    ``first_trace``."""
    from repro_torch.kernels import engine
    steps, step_rows = [], batcher._step_rows

    def counted(model, params, live, tokens, pos):
        if model is not batcher._draft_model:
            return step_rows(model, params, live, tokens, pos)
        before = engine.launch_counts()
        if steps:
            out = step_rows(model, params, live, tokens, pos)
        else:
            with engine.dispatch_trace() as ev:
                out = step_rows(model, params, live, tokens, pos)
            first_trace.extend(ev)
        after = engine.launch_counts()
        steps.append({k: after[k] - before[k] for k in after
                      if after[k] != before[k]})
        return out
    batcher._step_rows = counted
    return steps


def _speculative(device, card, model, params, draft: str, n_req: int,
                 timed: bool):
    """The fp32 paged kv16 batcher with the ``draft`` draft beside the same
    configuration without speculation, on ``n_req`` of phase 4's requests:
    streams, counters, launches per draft step; with ``timed`` the verify
    and draft steps' device ms beside a sequential decode step's."""
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.tracing import TraceConfig
    cfg = model.cfg
    plain_sc = dataclasses.replace(_paged_config(), kv_bits=16)
    sc = dataclasses.replace(plain_sc, speculative=True,
                             draft_precision=draft, draft_k=SPEC_K)
    for conf in (plain_sc, sc):
        _warm(PagedBatcher(model, params, conf), cfg)
    reqs = _requests(cfg, n_req, GEN)
    plain, plain_launches = _run(PagedBatcher(model, params, plain_sc),
                                 _requests(cfg, n_req, GEN), card,
                                 "fp32 paged kv16")
    check(plain_launches["fused_decode"] > 0,
          "the fp32 kv16 decode steps launched no fused_decode")
    b = PagedBatcher(model, params, sc)
    trace = []
    steps = _count_draft_steps(b, trace)
    label = f"fp32 paged kv16, speculative ({draft} draft, k={SPEC_K})"
    got, _ = _run(b, reqs, card, label)
    s = b.metrics.summary()["speculative"]
    print(f"{label}: verify_steps {s['verify_steps']}, draft_tokens "
          f"{s['draft_tokens']}, accepted_tokens {s['accepted_tokens']}, "
          f"acceptance rate {s['draft_accept_rate']:.4f} (accepted / "
          f"drafted), {s['accepted_per_verify']:.3f} tokens a verify step")
    kinds = sorted({tuple(st.items()) for st in steps})
    print(f"{label}: launches per draft step ({len(steps)} draft steps): "
          + " | ".join(str(dict(k)) for k in kinds))
    plain_ops = sorted({(e.op, e.kind) for e in trace
                        if e.impl_backend == "torch"})
    print(f"{label}: plain-path dispatches of a draft step (dispatch_trace, "
          f"impl_backend torch): {plain_ops or 'none'}")
    # every draft projection quantizes its rows (B7c); the quantized wo
    # composes B2 with qmatmul; 2xT packs its matrices for B1, while 8x8
    # stores int8 codes unpacked (pack_weights False: the plain codes path)
    need = ("act_quant_signed_grouped",) + (
        ("ternary_matmul",) if draft == "2xT" else ())
    n = cfg.n_layers
    check(steps and all(st.get("paged_attention") == n
                        and all(st.get(k, 0) > 0 for k in need)
                        for st in steps),
          f"{label}: a draft step missed {need} or one paged_attention a "
          "layer")
    check(s["verify_steps"] == b.metrics.decode_steps > 0,
          f"{label}: no verify step")
    _equal_or_near_tie(f"{label} against the non-speculative run", model,
                       params, reqs, got, plain, device)
    if not timed:
        return s
    prof, draft_ms = {}, []
    for spec, conf in ((False, plain_sc), (True, sc)):
        pb = PagedBatcher(model, params, dataclasses.replace(
            conf, trace=TraceConfig(enabled=False, profile=True)))
        if spec:
            import torch
            step_rows = pb._step_rows

            def synced(m, *a, step_rows=step_rows, pb=pb):
                if m is not pb._draft_model:
                    return step_rows(m, *a)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_rows(m, *a)          # ends in a host copy
                draft_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            pb._step_rows = synced
        _streams(pb, _requests(cfg, n_req, GEN))
        prof[spec] = pb.profiler.summary()
    v, d = prof[True]["verify"]["device_ms"], prof[False]["decode"]["device_ms"]
    print(f"[{card}] {label}: verify step (B={N_SLOTS} x W={SPEC_K + 1}, "
          f"plain PyTorch) {v['p50']:.3f} ms p50 (p90 {v['p90']:.3f}) beside "
          f"one sequential fp32 kv16 decode step (B4) {d['p50']:.3f} ms p50 "
          f"(p90 {d['p90']:.3f}); a draft step {statistics.median(draft_ms):.3f}"
          f" ms p50 over {len(draft_ms)} (StepProfiler brackets, synced; one "
          "profiled run each)")
    return s


def _lane_counters(srv):
    """Wrap each lane's step to count the kernel launches made inside it
    (the counts' change across the step); returns one Counter a lane."""
    from collections import Counter
    from repro_torch.kernels import engine
    per_lane = [Counter() for _ in srv.lanes]
    for i, lane in enumerate(srv.lanes):
        def step(lane_step=lane.step, c=per_lane[i]):
            before = engine.launch_counts()
            out = lane_step()
            after = engine.launch_counts()
            c.update({k: after[k] - before[k] for k in after})
            return out
        lane.step = step
    return per_lane


def _adaptive(device, card, model, params):
    """The adaptive server at full width: four premium requests go active,
    then a burst of standard / batch requests arrives."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.runtime.adaptive import AdaptiveServer
    from repro_torch.runtime.serving import ServingConfig
    cfg = model.cfg
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK,
                       block_size=BLOCK, pool_bytes=ADAPTIVE_POOL,
                       brownout=True, speculative=True, draft_k=SPEC_K)
    stamps = {}

    def on_token(req, tok, finished):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    def premium():
        reqs = _requests(cfg, N_PREMIUM, GEN)
        for r in reqs:
            r.options = dataclasses.replace(r.options, slo="premium",
                                            on_token=on_token)
        return reqs

    def serve(burst: bool):
        srv = AdaptiveServer(model, params, sc)
        per_lane = _lane_counters(srv)
        reqs = premium()
        for r in reqs:
            srv.submit(r)
        done, n_checked = [], 0
        for _ in range(200):                 # the premium slots go active
            if all(r.output for r in reqs):
                break
            done += srv.step()
            srv.check_pool()
            n_checked += 1
        check(all(r.output for r in reqs), "premium requests never active")
        if burst:
            extra = _requests(cfg, N_PREMIUM + N_BURST, GEN // 2)[N_PREMIUM:]
            for j, r in enumerate(extra):
                r.options = dataclasses.replace(
                    r.options, slo=("standard", "batch")[j % 2],
                    on_token=on_token)
                srv.submit(r)
            reqs += extra
        engine.reset_launch_counts()
        for _ in range(10_000):
            if srv.idle:
                break
            done += srv.step()
            srv.check_pool()                 # the ledger's bound included
            n_checked += 1
        torch.cuda.synchronize()
        check(srv.idle and len(done) == len(reqs),
              f"adaptive: served {len(done)} of {len(reqs)} requests")
        for r in done:
            check(len(r.output) == r.max_new
                  and all(0 <= t < cfg.vocab for t in r.output),
                  f"adaptive request {r.rid}: short or out-of-range tokens")
        return srv, reqs, {r.rid: list(r.output) for r in done}, \
            per_lane, n_checked

    srv0, _, base, _, _ = serve(False)
    del srv0
    stamps.clear()
    srv, reqs, got, per_lane, n_checked = serve(True)
    m = srv.metrics
    rungs = {r.rid: r.routed_rung for r in reqs}
    print(f"adaptive: {len(srv.lanes)} lanes "
          f"({', '.join(l.trace_track for l in srv.lanes)}), shared budget "
          f"{ADAPTIVE_POOL >> 20} MiB, check_pool() clean after each of "
          f"{n_checked} steps (ledger peak within budget); routed rung by "
          f"request: {rungs}; brownout_raises {m.brownout_raises}, "
          f"degraded_admissions {m.degraded_admissions}")
    for name, c in sorted(srv.summary()["slo"].items()):
        print(f"adaptive SLO {name}: finished {c['finished']}, attainment "
              f"{c['attainment']:.3f} (targets {c['target']})")
    for i, lane in enumerate(srv.lanes):
        itl = [(b - a) * 1e3 for r in reqs if rungs[r.rid] == i
               for a, b in zip(stamps[r.rid], stamps[r.rid][1:])]
        launched = {k: v for k, v in per_lane[i].items() if v}
        print(f"[{card}] adaptive lane {lane.trace_track}: "
              f"{sum(rungs[r.rid] == i for r in reqs)} requests, ITL p50 "
              + (f"{statistics.median(itl):.2f} ms" if itl else "n/a")
              + f"; launches {launched}")
    check(all(rungs[r.rid] == 0 for r in reqs[:N_PREMIUM]),
          "a premium request left rung 0")
    check(m.brownout_raises > 0 and m.degraded_admissions > 0,
          "the burst never browned out")
    for i in (1, 2):
        check(per_lane[i]["fused_decode"] > 0,
              f"rung {i}: no fused_decode launch")
    check(all(per_lane[3][k] > 0 for k in ("paged_attention",
                                           "ternary_matmul",
                                           "act_quant_signed_grouped")),
          "rung 3: B2, B1 or B7c never launched")
    prem = reqs[:N_PREMIUM]
    _equal_or_near_tie("adaptive premium streams against an unloaded run",
                       model, params, prem, got, base, device)
    del srv


def _cli_adaptive() -> None:
    """The serving CLI with --brownout --speculative, and its refusal of a
    quantized primary."""
    from repro_torch.launch import serve as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = cli.main(["--precision", "fp32", "--brownout", "--speculative",
                         "--slo", "mixed", "--requests", "12", "--slots",
                         str(N_SLOTS)])
    out = buf.getvalue().splitlines()
    lanes = [ln for ln in out if ln.startswith("adaptive serving:")]
    print("CLI --precision fp32 --brownout --speculative --slo mixed: "
          + (lanes[0] if lanes else "no lanes line"))
    check(len(lanes) == 1 and len(done) == 12,
          "CLI --brownout --speculative: no lanes line or requests missing")
    try:
        cli.main(["--precision", "2xT", "--speculative"])
    except SystemExit as e:
        check(isinstance(e.code, str) and "need a float primary" in e.code,
              f"CLI --precision 2xT --speculative: exit {e.code!r}")
        print(f"CLI --precision 2xT --speculative refuses: {e.code[:60]}...")
    else:
        fail("CLI --precision 2xT --speculative did not refuse")


def phase_speculative(device, card):
    """4l: self-speculative decoding and the adaptive server at full width,
    fp32 weights in float32."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    print("== 4l. self-speculative decoding and the adaptive server: "
          "smollm-135m fp32 float32 (full width)", flush=True)
    t0 = time.time()
    model = build_model(model_config(precision="fp32", kv_bits=0,
                                     dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device)
    _speculative(device, card, model, params, "2xT", N_REQ, timed=True)
    s8 = _speculative(device, card, model, params, "8x8", N_SLOTS,
                      timed=False)
    check(s8["accepted_tokens"] > 0, "the 8x8 draft accepted nothing")
    _adaptive(device, card, model, params)
    _cli_adaptive()
    engine.clear_variants()
    torch.cuda.empty_cache()
    print(f"phase 4l: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 4m: MoE, Mamba and hybrid stacks
# ---------------------------------------------------------------------------
FALCON_REQ, FALCON_GEN = 4, 8
# falcon-mamba's depth in phase 4m (64: no cut)
FALCON_LAYERS = 64
JAMBA_STEPS = 3
# B1 at the new shapes: (label, N, K) of granite's attention projections
# and falcon-mamba's four, each at decode (M 4) and prefill rows (M 64:
# N 16384 past the rows kernel's M.N limit, so the tensor cores)
FAMILY_PROJ = (("granite wq/wo", 1024, 1024), ("granite wk/wv", 512, 1024),
               ("falcon w_in", 16384, 4096), ("falcon w_x", 288, 8192),
               ("falcon w_dt", 8192, 256), ("falcon w_out", 4096, 8192))


def _family_model(arch, device, reduced=False, reduced_kw=None, tp=1, **kw):
    """(model, serving params) of ``arch`` from seed 0, drawn on the card;
    prints the weights' bytes before and after ``to_serving`` (with
    ``tp``).  ``kw`` overrides the config, ``reduced_kw`` the
    reduce_for_smoke one."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke, to_serving
    from repro_torch.models.convert import serving_param_bytes
    cfg = get_config(arch, **kw)
    if reduced:
        cfg = dataclasses.replace(reduce_for_smoke(cfg),   # float32
                                  **(reduced_kw or {}))
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    base = serving_param_bytes(params)
    params = to_serving(params, cfg, tp=tp)
    torch.cuda.synchronize()
    packed = serving_param_bytes(params)
    print(f"{arch}{' (reduced)' if reduced else ''}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {f'Dh {cfg.dh}, ' if cfg.n_heads else ''}"
          f"vocab {cfg.padded_vocab}, "
          f"{cfg.dtype}, "
          f"{cfg.precision}: weights {base / 1e9:.4f} GB {cfg.dtype}-form -> "
          f"{packed / 1e9:.4f} GB serving form ({base / packed:.2f}x "
          f"smaller); init + to_serving {time.time() - t0:.1f} s")
    return model, params


@contextlib.contextmanager
def _routing_probe():
    """Record every MoE layer's routing: per call, each token's expert set
    (sorted) and the gap between its k-th and (k+1)-th router
    probabilities, computed as ``moe_apply`` computes them (f32, TF32
    off).  Yields the list of (sets, gaps) per call."""
    import torch
    from repro_torch.models import layers as L
    saved, calls = L.moe_apply, []

    def probe(p, x, cfg, backend=None, shard=None):
        xin = L.rmsnorm(p["norm"], x, cfg.norm_eps).reshape(-1, x.shape[-1])
        probs = torch.softmax(xin.to(torch.float32) @ p["w_router"], -1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        sets = torch.topk(probs, cfg.top_k, dim=-1).indices.sort(-1).values
        calls.append((sets, top[:, -2] - top[:, -1]))
        return saved(p, x, cfg, backend, shard)

    L.moe_apply = probe
    try:
        yield calls
    finally:
        L.moe_apply = saved


def _routing_flips(calls, n_runs: int, first: int = 0, second: int = 1):
    """Tokens whose expert set differs between two runs of the same calls
    (the probe's list holds ``n_runs`` runs back to back), the smallest
    top-k margin among them, and the index of the first call (MoE layer,
    in call order) where one differs (None: none does)."""
    per = len(calls) // n_runs
    flips, margin, where = 0, float("inf"), None
    for i, ((a, ga), (b, _)) in enumerate(zip(
            calls[first * per:(first + 1) * per],
            calls[second * per:(second + 1) * per])):
        diff = (a != b).any(-1)
        flips += int(diff.sum())
        if bool(diff.any()):
            margin = min(margin, ga[diff].min().item())
            where = i if where is None else where
    return flips, margin, where


def _c2_contract(card, model, params, prompt, device, start=None):
    """Fault C2's contract (ROADMAP Queue C; ``tests/test_torch_c2.py``
    holds it on smollm) on another model's fp32 kv8 decode step, through
    ``tools/probe_c2.py``'s layer report: B5 within its per-call bound in
    every layer; before the first K/V code that differs between the kernel
    and the plain runs, K/V within 1e-3 code steps and attention within
    2e-6; the first differing code within 1e-3 steps of its rounding
    boundary; every differing code one step from the other; the plain run
    given the kernel run's K/V codes within 0.05 of phase 4's bound.  The
    smollm contract bounds the later codes' distance from their boundary
    by 0.1 steps; past the first step the runs drift apart by the printed
    ``du``, so here each later differing code is held within that layer's
    ``du`` of its boundary (a code step that the drift upstream does not
    explain, such as a dequantization error, fails).  Returns the first
    layer with a code step (None: none, and then the step is within 0.05
    of the bound as it stands).  ``start`` = (token, cache, pos): decode
    from copies of that one cache instead of phase 4's chunk (the enc-dec
    backbone: one prefill holds the encoder output fixed across the
    runs)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import probe_c2
    rep = probe_c2.layer_report(model, params, prompt, device, start=start)
    probe_c2._print(card, 0, rep)
    flipped = [r["layer"] for r in rep["layers"]
               if r["k"]["flips"] or r["v"]["flips"]]
    first = flipped[0] if flipped else None
    later = 0.0
    for r in rep["layers"]:
        check(r["per_call"] <= r["per_call_tol"],
              f"C2 contract: B5 off its bound at layer {r['layer']}")
        before = first is None or r["layer"] < first
        check(not before or r["attn_rel"] <= 2e-6,
              f"C2 contract: attention parts before a code step: {r}")
        for kv in (r["k"], r["v"]):
            check(kv["max_step"] <= 1, f"C2 contract: layer {r['layer']} "
                                       f"codes more than one step apart {kv}")
            check(not before or kv["du"] <= 1e-3,
                  f"C2 contract: K/V part before a code step: {kv}")
            check(r["layer"] != first or kv["flip_dist"] <= 1e-3,
                  f"C2 contract: first code step {kv['flip_dist']} steps "
                  "from its boundary")
            if first is not None and r["layer"] > first:
                check(kv["flip_dist"] <= kv["du"],
                      f"C2 contract: layer {r['layer']} code step "
                      f"{kv['flip_dist']} steps from its boundary, past the "
                      f"runs' drift {kv['du']}")
                later = max(later, kv["flip_dist"])
    check(rep["cuda_swap"] <= 0.05, f"C2 contract: with the kernel run's "
          f"K/V codes the plain run is {rep['cuda_swap']:.3f} of the bound")
    check(first is not None or rep["cuda_plain"] <= 0.05,
          f"C2 contract: no code step, yet {rep['cuda_plain']:.3f} of the "
          "bound")
    print(f"C2 contract holds: first code step at layer {first}; later "
          f"differing codes lie up to {later:.3f} steps from their boundary, "
          "each within its layer's drift du")
    return first


def _family_kernel_shapes(gen, device) -> None:
    """B1 and B8 through the kernels against their plain versions at this
    phase's new shapes: B1 (2-bit activation codes x ternary words)
    ``torch.equal`` at M in (4, 64); B8 at granite's whole prefill (B 1,
    S PROMPT, KV 8, G 2, Dh 64, causal) in f32 and bf16 within 1e-5 of
    max|out| (phase 3's bound).  B5, B2 and B4 are held at granite's
    shapes inside the model comparisons below."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    for label, n, k in FAMILY_PROJ:
        w, _ = _rand_packed(gen, n, k, 2, device)
        scale = (torch.rand(n, generator=gen) + 0.5).to(device)
        for m in (4, 64):
            x = torch.randint(-1, 2, (m, k), generator=gen,
                              dtype=torch.int8).to(device)
            y, y_ref = ternary_matmul(x, w, scale), \
                ref.ternary_matmul_ref(x, w, scale)
            torch.cuda.synchronize()
            check(torch.equal(y, y_ref), f"ternary_matmul {label} M={m} "
                  f"N={n} K={k}: not equal to the plain version")
    print("ternary_matmul torch.equal to the plain version at M in (4, 64) x "
          + ", ".join(f"{label} ({n}, {k})" for label, n, k in FAMILY_PROJ))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, PROMPT, 8, 2, 64), generator=gen).to(device, dtype)
        k, v = (torch.randn((1, PROMPT, 8, 64), generator=gen).to(device, dtype)
                for _ in range(2))
        out = flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, tol = (out - want).abs().max().item(), \
            1e-5 * want.abs().max().item()
        print(f"flash_attention granite prefill B=1 S={PROMPT} KV=8 G=2 Dh=64 "
              f"{dtype}: max |diff| vs f32 plain version {err:.3e} (tolerance "
              f"{tol:.3e})")
        check(err <= tol, f"flash_attention at granite's shape {dtype}: "
                          f"{err} > {tol}")


def _compare_recurrent(model, params, prompt, device, steps: int = 1):
    """A whole-prompt prefill of ``prompt`` (1, L), then ``steps`` decode
    steps over N_SLOTS slots each holding that prefill's cache, through the
    kernels and through the plain versions.  Returns the launches of the
    kernel run per prefill and per decode step, and the largest logit
    differences (prefill, decode) with the plain run's max|logit|."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serving import write_slot
    cfg = model.cfg
    tokens = torch.as_tensor(prompt, device=device)
    length = tokens.shape[1]
    runs, launches = {}, {}
    for run, backend in (("cuda", "cuda"), ("plain", "torch")):
        engine.reset_launch_counts()
        lp, one = model.prefill(params, {"tokens": tokens}, length + steps + 1,
                                backend=backend)
        torch.cuda.synchronize()
        launches[f"prefill_{run}"] = engine.launch_counts()
        cache = tfm.make_cache(cfg, N_SLOTS, length + steps + 1, device)
        for i in range(N_SLOTS):
            write_slot(cache, one, i)
        tok = lp[:, -1:].argmax(-1).expand(N_SLOTS, 1).contiguous()
        logits = [lp]
        for s in range(steps):
            engine.reset_launch_counts()
            ld, cache = model.decode_step(params, tok, cache, length + s,
                                          backend=backend)
            torch.cuda.synchronize()
            launches[f"decode_{run}"] = engine.launch_counts()
            logits.append(ld)
            tok = ld[:, -1:].argmax(-1)
        check(all(bool(torch.isfinite(x).all()) for x in logits),
              f"non-finite logits ({cfg.name}, {run})")
        runs[run] = logits
    check(not any(n for c in ("prefill", "decode")
                  for n in launches[f"{c}_plain"].values()),
          "backend='torch' launched a kernel")
    diffs = [(a - b).abs().max().item()
             for a, b in zip(runs["cuda"], runs["plain"])]
    return {"launches": {"prefill": launches["prefill_cuda"],
                         "decode": launches["decode_cuda"]},
            "prefill": diffs[0], "decode": max(diffs[1:]),
            "scale": max(x.abs().max().item() for x in runs["plain"])}


def _family_times(device, card, granite_cfg, falcon_cfg) -> None:
    """The two plain pieces of this slice by design, timed on the card:
    one granite decode step's expert product (three per layer, E 32, one
    slot an expert: the unpack of every expert's words each call) and one
    falcon-mamba layer's chunked scan at the prompt's length."""
    import torch
    from repro_torch.core.precision import get_precision, signed
    from repro_torch.kernels import engine
    from repro_torch.models import layers as L
    from repro_torch.models.convert import to_serving
    gen = torch.Generator(device=device).manual_seed(3)
    e, d, f = granite_cfg.n_experts, granite_cfg.d_model, granite_cfg.moe_d_ff
    pcfg = signed(get_precision("2xT"))
    w = to_serving({"moe": {"w_gate": torch.randn(
        (e, d, f), generator=gen, device=device)}}, granite_cfg)["moe"]["w_gate"]
    x = torch.randn((e, 1, d), generator=gen, device=device,
                    dtype=torch.bfloat16)
    ms, eager = time_ms(lambda: engine.qmatmul_experts(x, w, pcfg))
    words = w["wt_packed"].numel() * 4
    print(f"[{card}] qmatmul_experts (E {e}, C 1, K {d}, N {f}, 2xT words "
          f"{words / 1e6:.2f} MB): {ms:.4f} ms device ({eager:.4f} ms eager); "
          f"x {3 * granite_cfg.n_layers} a decode step = "
          f"{ms * 3 * granite_cfg.n_layers:.2f} ms")
    di, n = falcon_cfg.d_inner, falcon_cfg.ssm_state
    dt = torch.rand((1, PROMPT, di), generator=gen, device=device) * 0.1
    xs = torch.randn((1, PROMPT, di), generator=gen, device=device)
    bm = torch.randn((1, PROMPT, n), generator=gen, device=device)
    cm = torch.randn((1, PROMPT, n), generator=gen, device=device)
    a = -torch.arange(1, n + 1, device=device, dtype=torch.float32
                      ).repeat(di, 1)
    h0 = torch.zeros((1, di, n), device=device)
    scan = lambda: L._ssm_scan_chunked(dt, xs, bm, cm, a, h0,
                                       falcon_cfg.ssm_chunk)
    ms, eager = time_ms(scan)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            scan()
        torch.cuda.synchronize()
    # the host's launch calls (phase 5 reads them beside the device
    # operations, which the profiler can drop for short windows)
    ops = sum(ev.device_type == DeviceType.CPU and ev.name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cudaMemcpyAsync", "cudaMemsetAsync") for ev in prof.events()) / calls
    print(f"[{card}] _ssm_scan_chunked (B 1, S {PROMPT}, Di {di}, N {n}): "
          f"{ms:.4f} ms device ({eager:.4f} ms eager), {ops:.0f} host "
          f"launch calls a call; x {falcon_cfg.n_layers} a prefill = "
          f"{ms * falcon_cfg.n_layers:.2f} ms")


def _granite(device, card) -> dict:
    """granite-moe-1b-a400m at full size, 2xT kv8 bf16: the dense batcher
    (chunked and whole-prompt), the paged kv8 batcher, kernels against the
    plain versions (2xT bf16 and fp32 float32, routing flips counted), an
    fp32-weight paged decode step (B4) and a profiled decode step."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    print("-- 4m granite-moe-1b-a400m 2xT kv8 bf16 (full size)", flush=True)
    model, params = _family_model("granite-moe-1b-a400m", device,
                                  precision="2xT", kv_bits=8)
    cfg = model.cfg
    n_proj, n_l = 4 * cfg.n_layers, cfg.n_layers
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK)
    _warm(ContinuousBatcher(model, params, sc), cfg)
    batcher = ContinuousBatcher(model, params, sc)
    streams, launches = _run(batcher, _requests(cfg, N_REQ, GEN), card,
                             "granite 2xT kv8")
    m = batcher.metrics
    for name in ("act_quant_signed_grouped", "ternary_matmul"):
        check(launches[name] == n_proj * _model_calls(m),
              f"granite: {name} launched {launches[name]} times in "
              f"{_model_calls(m)} model calls, not {n_proj} per call")
    check(launches["decode_attention"] == n_l * m.decode_steps,
          "granite: not one decode_attention launch per layer and step")

    with _routing_probe() as routes:
        cmp = _compare_backends(model, params, sc, _requests(cfg, 1, GEN)[0]
                                .tokens, device)
    flips, margin, where = _routing_flips(routes, 3)
    print(f"granite launches per prefill chunk (C={CHUNK}): "
          f"{cmp['launches']['chunk']}; per decode step (B={N_SLOTS}): "
          f"{cmp['launches']['decode']}")
    tol0 = 1e-5 + 1e-4 * cmp["attn0_scale"]
    print(f"granite 2xT bf16, kernels vs plain versions: prefill_chunk max "
          f"|dlogit| {cmp['chunk']:.3e} (tolerance 0); decode step layer 0 "
          f"attention max |diff| {cmp['attn0']:.3e} (tolerance {tol0:.3e}); "
          f"attention outputs equal in bf16 in the first "
          f"{cmp['layers_equal']} of {n_l} layers; logits max |dlogit| "
          f"{cmp['decode']:.3e} of max|logit| {cmp['scale']:.3e}, greedy "
          f"tokens agree on {cmp['agree']}/{N_SLOTS} rows (not bounded, as "
          f"phase 4); tokens routed to another expert set {flips} (first "
          f"at MoE call {where} of {2 * n_l}: chunk layers, then decode "
          f"layers; smallest top-k margin among them {margin:.3e})")
    check(cmp["chunk"] == 0.0, f"granite prefill_chunk differs by "
                               f"{cmp['chunk']}")
    check(cmp["q0_equal"] and cmp["attn0"] <= tol0,
          f"granite decode step layer 0 attention differs by {cmp['attn0']}")

    whole = dataclasses.replace(sc, chunk_size=0)
    wb = ContinuousBatcher(model, params, whole)
    _, wl = _run(wb, _requests(cfg, N_REQ, GEN), card,
                 "granite 2xT kv8 whole-prompt")
    print(f"granite flash_attention launches {wl['flash_attention']} over "
          f"{wb.metrics.prefill_full} whole prefills ({n_l} per prefill)")
    check(wl["flash_attention"] == n_l * wb.metrics.prefill_full > 0,
          "granite whole-prompt: not one flash_attention launch per layer")

    pmodel = build_model(dataclasses.replace(cfg, kv_bits=0))
    pb = PagedBatcher(pmodel, params, _paged_config())
    pstreams, pl = _run(pb, _requests(cfg, N_REQ, GEN), card,
                        "granite 2xT paged kv8")
    check(pl["paged_attention"] == n_l * pb.metrics.decode_steps,
          "granite paged: not one paged_attention launch per layer and step")
    pc = _compare_paged(pmodel, params, _requests(cfg, 1, GEN)[0].tokens,
                        device, probe=True)
    ptol0 = 1e-5 + 1e-4 * pc["attn0_scale"]
    print(f"granite 2xT bf16 paged, kernels vs plain versions: "
          f"prefill_chunk_paged max |dlogit| {pc['chunk']:.3e} (tolerance 0); "
          f"decode_step_paged layer 0 attention max |diff| {pc['attn0']:.3e} "
          f"(tolerance {ptol0:.3e}); logits max |dlogit| {pc['decode']:.3e} "
          f"of max|logit| {pc['scale']:.3e} (not bounded, as phase 4c); "
          f"launches per paged decode step {pc['launches']['decode']}")
    check(pc["chunk"] == 0.0 and pc["q0_equal"] and pc["attn0"] <= ptol0,
          f"granite paged: chunk {pc['chunk']}, layer 0 attention "
          f"{pc['attn0']}")
    check(pc["launches"]["decode"]["paged_attention"] == n_l,
          "granite paged decode step: not one paged_attention per layer")
    agree = sum(pstreams[r] == streams[r] for r in streams)
    print(f"granite paged_attention launches {pl['paged_attention']} over "
          f"{pb.metrics.decode_steps} decode steps; streams equal to the dense "
          f"run's {agree}/{N_REQ} (not required: the paged decode batches "
          "live slots only, and MoE capacity depends on the batch)")
    phase_profile(card, "granite 2xT dense", ContinuousBatcher(model, params,
                                                               sc))
    del batcher, wb, pb, params
    torch.cuda.empty_cache()

    model32, params32 = _family_model("granite-moe-1b-a400m", device,
                                      precision="fp32", kv_bits=8,
                                      dtype="float32")
    prompt = _requests(model32.cfg, 1, GEN)[0].tokens
    with _routing_probe() as routes:
        c32 = _compare_backends(model32, params32, sc, prompt, device)
    flips32, margin32, where32 = _routing_flips(routes, 3)
    tol = 1e-4 * c32["scale"]
    print(f"granite fp32 weights, float32, kv8, kernels vs plain versions: "
          f"prefill_chunk max |dlogit| {c32['chunk']:.3e}, decode_step max "
          f"|dlogit| {c32['decode']:.3e} (tolerance {tol:.3e} = 1e-4 of "
          f"max|logit| {c32['scale']:.3e}), greedy tokens agree on "
          f"{c32['agree']}/{N_SLOTS} rows; tokens routed to another expert "
          f"set {flips32} (first at MoE call {where32} of {2 * n_l}, "
          f"smallest top-k margin among them {margin32:.3e})")
    check(c32["launches"]["decode"]["decode_attention"] == n_l,
          "granite fp32 decode step: not one decode_attention per layer")
    check(c32["chunk"] == 0.0, f"granite fp32 prefill_chunk differs by "
                               f"{c32['chunk']}")
    first = _c2_contract(card, model32, params32, prompt, device)
    check(c32["decode"] <= tol or first is not None,
          f"granite fp32 decode_step logits differ by {c32['decode']} > "
          f"{tol} with no K/V code step")
    fused = _fused_checks("granite", model32, params32, prompt, device)
    del params32
    torch.cuda.empty_cache()
    return {"2xT dense": launches, "whole": wl, "paged": pl,
            "fused": fused, "cfg": cfg}


def _fused_checks(label, model32, params32, prompt, device) -> dict:
    """The fused decode (B4) at a model's shapes, fp32 weights in float32:
    with raw f32 blocks (kv16: no K/V code to step, as phase 4l) within
    the bound; at kv8 under C2's swap, as the dense step: given the kernel
    run's K/V codes, the plain run within 0.05 of the bound (within the
    bound outright when no code steps).  Returns the decode step's
    launches by kv width."""
    from repro_torch.models import build_model
    n_l = model32.cfg.n_layers
    p32 = build_model(dataclasses.replace(model32.cfg, kv_bits=0))
    fused = {}
    for kv_bits in (16, 8):
        f32 = _compare_paged(p32, params32, prompt, device, probe=False,
                             kv_bits=kv_bits, swap=kv_bits == 8)
        bound = 1e-4 * f32["scale"]
        print(f"{label} fp32 weights, float32, paged kv{kv_bits} (fused "
              f"decode), kernels vs plain versions: prefill_chunk_paged max "
              f"|dlogit| {f32['chunk']:.3e}, decode_step_paged max |dlogit| "
              f"{f32['decode']:.3e} ({f32['decode'] / bound:.3f} of the bound "
              f"{bound:.3e})"
              + ("" if kv_bits == 16 else
                 f" with {f32['code_steps']} K/V codes apart; plain given the "
                 f"kernel run's K/V codes {f32['swap'] / bound:.4f} of the "
                 "bound (tolerance 0.05)")
              + f"; greedy tokens agree on {f32['agree']}/{N_SLOTS} rows; "
              f"launches {f32['launches']['decode']}")
        check(f32["launches"]["decode"]["fused_decode"] == n_l,
              f"{label} fp32 paged kv{kv_bits} decode step: not one "
              "fused_decode per layer")
        check(f32["chunk"] == 0.0, f"{label} fp32 paged kv{kv_bits} "
                                   f"prefill_chunk_paged differs by "
                                   f"{f32['chunk']}")
        if kv_bits == 16 or f32["code_steps"] == 0:
            check(f32["decode"] <= bound, f"{label} fp32 paged kv{kv_bits} "
                                          f"decode differs by {f32['decode']}")
        else:
            check(f32["swap"] <= 0.05 * bound,
                  f"{label} fp32 paged kv8: with the kernel run's K/V codes "
                  f"the plain run is {f32['swap'] / bound:.4f} of the bound")
        fused[kv_bits] = f32["launches"]["decode"]
    return fused


def _falcon(device, card, layers: int) -> dict:
    """falcon-mamba-7b at full width, 2xT bf16, whole-prompt admission
    (``layers`` of its 64: a stated cut when fewer)."""
    import torch
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    print(f"-- 4m falcon-mamba-7b 2xT bf16 (full width, {layers} layers)",
          flush=True)
    model, params = _family_model("falcon-mamba-7b", device,
                                  precision="2xT", n_layers=layers)
    cfg = model.cfg
    n_proj = 4 * cfg.n_layers
    sc = ServingConfig(n_slots=N_SLOTS, s_max=PROMPT + FALCON_GEN)
    _warm(ContinuousBatcher(model, params, sc), cfg)
    batcher = ContinuousBatcher(model, params, sc)
    check(batcher.chunk_size == 0, "falcon-mamba: chunked admission chosen")
    streams, launches = _run(batcher, _requests(cfg, FALCON_REQ, FALCON_GEN),
                             card, "falcon-mamba 2xT")
    m = batcher.metrics
    check(m.prefill_full == FALCON_REQ and m.prefill_chunks == 0,
          f"falcon-mamba: {m.prefill_full} whole prefills, "
          f"{m.prefill_chunks} chunks")
    for name in ("act_quant_signed_grouped", "ternary_matmul"):
        check(launches[name] == n_proj * _model_calls(m),
              f"falcon-mamba: {name} launched {launches[name]} times in "
              f"{_model_calls(m)} model calls, not {n_proj} per call")
    prompt = _requests(cfg, 1, FALCON_GEN)[0].tokens
    out = {"dense": launches}
    for dtype in ("bfloat16", "float32"):
        mdl, p = _as_dtype(model, params, dtype)
        cmp = _compare_recurrent(mdl, p, prompt, device)
        print(f"falcon-mamba 2xT {dtype}, kernels vs plain versions: prefill "
              f"max |dlogit| {cmp['prefill']:.3e}, decode step max |dlogit| "
              f"{cmp['decode']:.3e} (tolerance 0: only B1 and B7c differ, "
              f"both integer-exact) of max|logit| {cmp['scale']:.3e}; "
              f"launches per prefill {cmp['launches']['prefill']}, per decode "
              f"step (B={N_SLOTS}) {cmp['launches']['decode']}")
        check(cmp["prefill"] == 0.0 and cmp["decode"] == 0.0,
              f"falcon-mamba {dtype}: logits differ by {cmp['prefill']} / "
              f"{cmp['decode']}")
        for name in ("act_quant_signed_grouped", "ternary_matmul"):
            check(cmp["launches"]["decode"][name] == n_proj,
                  f"falcon-mamba {dtype}: {name} not {n_proj} a step")
        out[dtype] = cmp["launches"]
        del p
    phase_profile(card, "falcon-mamba 2xT dense",
                  ContinuousBatcher(model, params, sc))
    del batcher
    torch.cuda.empty_cache()
    out["cfg"] = cfg
    # phase 4t serves the same weights and requests over a mesh
    out["serving"] = {"model": model, "params": params, "streams": streams}
    return out


def _as_dtype(model, params, dtype: str):
    """``model`` rebuilt at ``dtype`` and ``params`` with every float leaf
    cast to it (packed words, codes and f32 scales unchanged in value)."""
    import torch
    from repro_torch.models import build_model
    target = getattr(torch, dtype)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(target) if t.is_floating_point() else t
    if model.cfg.dtype == dtype:
        return model, params
    return build_model(dataclasses.replace(model.cfg, dtype=dtype)), \
        cast(params)


def _n_proj(cfg) -> int:
    """Quantized projections a model call runs: 4 per attention or Mamba
    layer, 3 (or 2) per dense FFN; the expert products are not among
    them."""
    per = sum(4 + {"dense": 3 if cfg.ffn_gated else 2}.get(f, 0)
              for f in cfg.ffn_pattern)
    return per * cfg.n_periods


def _n_packed(params) -> int:
    """Projections a model call runs on packed words: the period-stacked
    qlinear leaves ``(P, N, KW)`` int32 (expert words are (P, E, N, KW))."""
    import torch
    if not isinstance(params, dict):
        return 0
    wt = params.get("wt_packed")
    if wt is not None:
        return wt.shape[0] if wt.ndim == 3 and wt.dtype == torch.int32 else 0
    return sum(_n_packed(v) for v in params.values())


def _reduced_stack(device, card, arch: str, label: str, steps: int,
                   **reduced_kw) -> dict:
    """``arch`` at reduce_for_smoke shapes (f32; ``reduced_kw`` overrides
    them): one whole prefill and ``steps`` decode steps, kernels against
    the plain versions, fp32 and 2xT weights each within 1e-4 of
    max|logit|; one B8 / B5 launch per attention layer, B7c per quantized
    projection, B1 per packed one."""
    out = {}
    for precision in ("fp32", "2xT"):
        model, params = _family_model(arch, device, reduced=True,
                                      reduced_kw=reduced_kw,
                                      precision=precision, kv_bits=8)
        cfg = model.cfg
        prompt = _requests(cfg, 1, GEN)[0].tokens
        cmp = _compare_recurrent(model, params, prompt, device, steps=steps)
        tol = 1e-4 * cmp["scale"]
        print(f"{label} {precision} float32 kv8, kernels vs plain versions: "
              f"prefill max |dlogit| {cmp['prefill']:.3e}, {steps} "
              f"decode steps max |dlogit| {cmp['decode']:.3e} of max|logit| "
              f"{cmp['scale']:.3e}"
              + f" (tolerance {tol:.3e}); launches per prefill {cmp['launches']['prefill']}, per "
              f"decode step {cmp['launches']['decode']}")
        n_attn = sum(m.startswith("attn") for m in cfg.layer_pattern) \
            * cfg.n_periods
        check(cmp["launches"]["prefill"]["flash_attention"] == n_attn and
              cmp["launches"]["decode"]["decode_attention"] == n_attn,
              f"{label} {precision}: not one B8 / B5 launch per attention "
              "layer")
        check(cmp["prefill"] <= tol and cmp["decode"] <= tol,
              f"{label} {precision} logits differ by {cmp['prefill']} / "
              f"{cmp['decode']} > {tol}")
        if precision == "2xT":
            # w_dt's K (dt_rank 8) packs into no whole word: int8 codes,
            # the plain path, after B7c's codes
            want = {"act_quant_signed_grouped": _n_proj(cfg),
                    "ternary_matmul": _n_packed(params)}
            for name, n in want.items():
                check(cmp["launches"]["decode"][name] == n,
                      f"{label} 2xT: {name} not {n} a step")
        out[precision] = cmp["launches"]
    return out


def phase_families(device, card) -> tuple[dict, dict]:
    """4m: the MoE, Mamba and hybrid stacks (granite at full size,
    falcon-mamba at full width, jamba reduced).  Returns the launches of
    their runs by kernel, summed, and falcon-mamba's model, serving params
    and streams (phase 4t's one-rank run)."""
    import torch
    from repro_torch.kernels import engine
    print("== 4m. MoE, Mamba and hybrid stacks", flush=True)
    t0 = time.time()
    _family_kernel_shapes(torch.Generator().manual_seed(7), device)
    granite = _granite(device, card)
    falcon = _falcon(device, card, FALCON_LAYERS)
    print("-- 4m jamba-v0.1-52b (reduce_for_smoke shapes, float32)",
          flush=True)
    jamba = _reduced_stack(device, card, "jamba-v0.1-52b", "jamba",
                           JAMBA_STEPS)
    _family_times(device, card, granite["cfg"], falcon["cfg"])
    total = {}

    def add(counts):
        for name, n in counts.items():
            if isinstance(n, dict):
                add(n)
            elif isinstance(n, int) and name in engine.KERNELS:
                total[name] = total.get(name, 0) + n
    serving = falcon.pop("serving")
    for runs in (granite, falcon, jamba):
        add(runs)
    print(f"phase 4m launches by kernel: {total}")
    for name in ("ternary_matmul", "act_quant_signed_grouped",
                 "decode_attention", "flash_attention", "paged_attention",
                 "fused_decode"):
        check(total.get(name, 0) > 0, f"phase 4m never launched {name}")
    print(f"phase 4m: {time.time() - t0:.1f} s")
    return total, serving


# ---------------------------------------------------------------------------
# 4n: the enc-dec backbone, the embeds frontend and the last LM configs
# ---------------------------------------------------------------------------
WHISPER_B, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_GEN = 4, 1500, 32, 16
GEMMA_LAYERS, GEMMA_PREFILL = 4, 4608   # 2 of 23 periods; S past the window
WIDE_LAYERS = 2                         # starcoder2, internvl2, glm4 fp32
# B8 in this phase's modes: (label, B, Sq, Sk, KV, G, Dh, causal, window,
# softcap, timed)
FLASH_4N = (
    ("whisper encoder", 4, 1500, 1500, 8, 1, 64, False, 0, 0.0, True),
    ("whisper cross-attention, prefill", 4, 32, 1500, 8, 1, 64, False, 0,
     0.0, True),
    ("whisper cross-attention, decode step", 4, 1, 1500, 8, 1, 64, False, 0,
     0.0, True),
    ("kimi-k2 Dh 112", 1, 512, 512, 8, 8, 112, True, 0, 0.0, True),
    ("gemma2 window 4096 + softcap 50", 1, GEMMA_PREFILL, GEMMA_PREFILL, 16,
     2, 128, True, 4096, 50.0, False))


# B1 and B7c at the projection shapes of these families (glm4's are held
# by its prefill_chunk's equality with the plain run)
PROJ_4N = ("whisper-base", "gemma2-27b", "starcoder2-15b", "internvl2-76b")


def _proj_kernel_shapes_4n(gen, device) -> None:
    """B1 (2-bit activation codes x ternary words) ``torch.equal`` to its
    plain version at M in (4, 64) at every projection (N, K) of PROJ_4N's
    configs (wq, wk / wv, wo, the FFN's up / gate and down), and B7c's
    row form (2 bits, f32 and bf16) codes and scales ``torch.equal`` to
    its plain version at the same M and each K."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.act_quant import act_quant_signed_rows
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    shapes = {}
    for arch in PROJ_4N:
        cfg = get_config(arch)
        d, f = cfg.d_model, cfg.d_ff
        q, kv = cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
        for nk in ((q, d), (kv, d), (d, q), (f, d), (d, f)):
            shapes.setdefault(nk, arch.split("-")[0])
    for (n, k), label in shapes.items():
        w, _ = _rand_packed(gen, n, k, 2, device)
        scale = torch.rand(n, generator=gen, device=device) + 0.5
        for m in (4, 64):
            x = torch.randint(-1, 2, (m, k), generator=gen, dtype=torch.int8,
                              device=device)
            y, y_ref = ternary_matmul(x, w, scale), \
                ref.ternary_matmul_ref(x, w, scale)
            torch.cuda.synchronize()
            check(torch.equal(y, y_ref), f"ternary_matmul {label} M={m} "
                  f"N={n} K={k}: not equal to the plain version")
        del w
    ks = sorted({k for _, k in shapes})
    for k in ks:
        for m in (4, 64):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, k), generator=gen, device=device
                                ).to(dtype)
                (c, s), (c_ref, s_ref) = act_quant_signed_rows(x, bits=2), \
                    ref.act_quant_signed_rows_ref(x, 2)
                torch.cuda.synchronize()
                check(torch.equal(c, c_ref) and torch.equal(s, s_ref),
                      f"act_quant_signed_rows ({m}, {k}) {dtype}: "
                      f"{int((c != c_ref).sum())} codes, "
                      f"{int((s != s_ref).sum())} scales differ from the "
                      "plain version")
    torch.cuda.empty_cache()
    print("ternary_matmul torch.equal to the plain version at M in (4, 64) x "
          "(N, K) " + ", ".join(f"{label} ({n}, {k})"
                                for (n, k), label in shapes.items()))
    print(f"act_quant_signed_rows 2 bits, f32 and bf16: codes and scales "
          f"torch.equal to the plain version at M in (4, 64) x K {ks}")


def _flash_cost_4n(b, sq, sk, kv, g, dh, causal, window, in_bytes):
    """(bytes, operations) of attention over these inputs: q, k, v read
    once, the f32 output written once; 4 * Dh operations per visible
    (query head, key) pair (every pair without the causal mask)."""
    if causal:
        pairs = sum(min(i + 1, window) if window > 0 else i + 1
                    for i in range(sq))
    else:
        pairs = sq * sk
    nbytes = b * kv * (sq * g + 2 * sk) * dh * in_bytes + 4 * b * sq * kv * g * dh
    return nbytes, 4 * dh * b * kv * g * pairs


def _flash_4n(gen, device, card) -> None:
    """B8 in its new modes against its f32 plain version, f32 and bf16,
    within 1e-5 of max|out| (phase 3's per-call bound): no mask with
    Sq = Sk (whisper's encoder) and Sq != Sk (its cross-attention at a
    prefill and at a decode step: one query row of a 64-row tile, a ragged
    key tail), kimi-k2's Dh 112, gemma2's window + softcap at full width.
    Timed beside the plain version and SDPA in the same dtype (K/V
    expanded to KV * G heads; no SDPA call takes the softcap)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    for (label, b, sq, sk, kv, g, dh, causal, window, softcap,
         timed) in FLASH_4N:
        kw = dict(causal=causal, window=window, softcap=softcap)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, kv, g, dh), generator=gen).to(device, dtype)
            k, v = (torch.randn((b, sk, kv, dh), generator=gen).to(device, dtype)
                    for _ in range(2))
            out = flash_attention(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            tol = 1e-5 * want.abs().max().item()
            print(f"flash_attention {label} B={b} Sq={sq} Sk={sk} KV={kv} "
                  f"G={g} Dh={dh} causal={causal} {str(dtype)[6:]}: max |diff| "
                  f"vs f32 plain version {err:.3e} (tolerance {tol:.3e}, "
                  f"{err / tol:.3f} of it)")
            check(err <= tol, f"flash_attention {label} {dtype}: max |diff| "
                              f"{err} > {tol}")
            del want
            if not timed:
                continue
            bf16 = dtype == torch.bfloat16
            qh = q.reshape(b, sq, kv * g, dh).transpose(1, 2).contiguous()
            kh, vh = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                      for t in (k, v))
            tk, tk_eager = time_ms(lambda: flash_attention(q, k, v, **kw),
                                   reps=5)
            tp, _ = time_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=5)
            tl, _ = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal), reps=5)
            nbytes, ops = _flash_cost_4n(b, sq, sk, kv, g, dh, causal, window,
                                         2 if bf16 else 4)
            bt, by = bound(nbytes, ops if bf16 else 3 * ops,
                           PEAK_BF16 if bf16 else PEAK_TF32)
            print(f"  [{card}] {label} {str(dtype)[6:]}: kernel {tk:.4f} ms "
                  f"(eager call {tk_eager:.4f} ms), plain {tp:.4f} ms, sdpa "
                  f"is_causal={causal} {tl:.4f} ms, kernel / sdpa "
                  f"{tk / tl:.2f}, bound {bt:.5f} ms ({by}: "
                  f"{ops:.3e} FLOP{'' if bf16 else ' x 3 TF32 products'}), "
                  f"{ops / tk / 1e9:.1f} TFLOP/s")


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def _compare_steps(model, params, batch, step_in, device) -> dict:
    """One whole prefill of ``batch`` and one decode step (input
    ``step_in``, every row at the prompt's end) through the kernels and
    through the plain versions.  Both decode steps start from a copy of
    the plain run's cache (a prefill's K/V codes may step between the runs:
    fault C2), and a third run, the plain versions given the kernel run's
    decoded-token K/V codes, gives ``swap`` (C2's swap).  A fourth run
    takes the kernels with B8 and B5 swapped for their plain versions
    (``_plain_attention``): its prefill and step must equal the plain
    run's, so any gap between the kernel and plain runs comes from the
    attention kernels.  Returns the launches per prefill and per step, the
    logits' differences, the K/V codes apart, the largest distance
    between two of them in code steps (kv8) and the plain runs'
    max|logit|."""
    import torch
    from repro_torch.kernels import engine
    s = next(iter(batch.values())).shape[1]
    launches, logits, codes = {}, {}, {}
    for run, backend in (("cuda", "cuda"), ("plain", "torch"),
                         ("attn_plain", "cuda")):
        engine.reset_launch_counts()
        with _plain_attention(run == "attn_plain"):
            lp, c = model.prefill(params, batch, s + 2, backend=backend)
        torch.cuda.synchronize()
        launches[f"prefill_{run}"] = engine.launch_counts()
        logits[f"prefill_{run}"] = lp
        if run == "plain":
            cache = c
    for run, backend in (("cuda", "cuda"), ("plain", "torch"),
                         ("swap", "torch"), ("attn_plain", "cuda")):
        engine.reset_launch_counts()
        with _decode_kv_codes(codes["cuda"] if run == "swap" else None) \
                as codes[run], _plain_attention(run == "attn_plain"):
            ld, _ = model.decode_step(params, step_in, _tree_clone(cache), s,
                                      backend=backend)
        torch.cuda.synchronize()
        launches[f"decode_{run}"] = engine.launch_counts()
        logits[f"decode_{run}"] = ld
    check(all(bool(torch.isfinite(x).all()) for x in logits.values()),
          f"non-finite logits ({model.cfg.name})")
    check(not any(n for key, c in launches.items() if "cuda" not in key
                  and "attn_plain" not in key for n in c.values()),
          "backend='torch' launched a kernel")
    for step in ("prefill", "decode"):
        attn = launches[f"{step}_attn_plain"]
        check(not any(attn.get(name, 0) for name in ("flash_attention",
                                                     "decode_attention")),
              f"{model.cfg.name}: the plain-attention run launched B8 or B5")
        check(all(attn.get(name, 0) == n
                  for name, n in launches[f"{step}_cuda"].items()
                  if name not in ("flash_attention", "decode_attention")),
              f"{model.cfg.name}: the plain-attention {step} launched "
              f"{attn}, not the kernel run's other launches")
        check(torch.equal(logits[f"{step}_attn_plain"],
                          logits[f"{step}_plain"]),
              f"{model.cfg.name}: with B8 and B5 plain, the kernels' {step} "
              "differs from the plain one: a kernel other than the "
              "attention's parts from its plain version")
    d = lambda a, b: (logits[a] - logits[b]).abs().max().item()
    return {"launches": {"prefill": launches["prefill_cuda"],
                         "decode": launches["decode_cuda"]},
            "max_step": max((int((a[i].to(torch.int16)
                                  - b[i].to(torch.int16)).abs().max())
                             for a, b in zip(codes["cuda"], codes["plain"])
                             for i in (0, 2)), default=0),
            "prefill": d("prefill_cuda", "prefill_plain"),
            "prefill_scale": logits["prefill_plain"].abs().max().item(),
            "decode": d("decode_cuda", "decode_plain"),
            "swap": d("decode_cuda", "decode_swap"),
            "scale": logits["decode_plain"].abs().max().item(),
            "code_steps": sum(int((a[i] != b[i]).sum())
                              for a, b in zip(codes["cuda"], codes["plain"])
                              for i in (0, 2)),
            "agree": int((logits["decode_cuda"].argmax(-1)
                          == logits["decode_plain"].argmax(-1)).sum())}


def _report_steps(label, cmp, bounded: bool) -> None:
    """Print one ``_compare_steps`` result; when ``bounded``, hold the
    prefill within 1e-4 of max|logit| and the decode step within it too,
    or, where a K/V code stepped between the runs, hold C2's swap (the
    plain run given the kernel run's codes) within 0.05 of it and every
    differing code one step from the other."""
    tp, td = 1e-4 * cmp["prefill_scale"], 1e-4 * cmp["scale"]
    print(f"{label}, kernels vs plain versions: prefill max |dlogit| "
          f"{cmp['prefill']:.3e} ({cmp['prefill'] / tp:.4f} of 1e-4 "
          f"max|logit|), decode step {cmp['decode']:.3e} "
          f"({cmp['decode'] / td:.4f}) with {cmp['code_steps']} K/V codes "
          f"apart (at most {cmp['max_step']} step), plain given the kernel "
          f"run's codes {cmp['swap'] / td:.4f}; greedy rows agree "
          f"{cmp['agree']}/{N_SLOTS}"
          + ("" if bounded else " (reported, not bounded)")
          + "; with B8 and B5 plain and the other kernels on the card, "
          "prefill and step equal to the plain run's"
          + f"; launches per prefill {cmp['launches']['prefill']}, per "
          f"decode step {cmp['launches']['decode']}")
    if bounded:
        check(cmp["prefill"] <= tp, f"{label}: prefill differs by "
                                    f"{cmp['prefill']} > {tp}")
        if cmp["code_steps"] == 0:
            check(cmp["decode"] <= td, f"{label}: decode step differs by "
                                       f"{cmp['decode']} > {td}")
        else:
            check(cmp["swap"] <= 0.05 * td, f"{label}: with the kernel run's "
                  f"K/V codes the plain run is {cmp['swap'] / td:.4f} of the "
                  "bound")
            check(cmp["max_step"] <= 1, f"{label}: K/V codes "
                  f"{cmp['max_step']} steps apart")


def _report_c2(card, label, model, params, cmp, prompt, device,
               start=None) -> None:
    """An fp32 ``_compare_steps`` result held by fault C2's contract
    (``_c2_contract``, per layer) instead of ``_report_steps``'s bound on
    the logits alone: the prefill within 1e-4 of max|logit|, the contract
    on the decode step, and the step within 1e-4 of max|logit| unless a
    K/V code stepped."""
    _report_steps(label, cmp, bounded=False)
    tp = 1e-4 * cmp["prefill_scale"]
    check(cmp["prefill"] <= tp, f"{label}: prefill differs by "
                                f"{cmp['prefill']} > {tp}")
    first = _c2_contract(card, model, params, prompt, device, start=start)
    check(cmp["decode"] <= 1e-4 * cmp["scale"] or first is not None,
          f"{label}: decode step differs by {cmp['decode']} with no K/V "
          "code step")


def _check_counts(label, got: dict, want: dict) -> None:
    for name, n in want.items():
        check(got.get(name, 0) == n, f"{label}: {name} launched "
                                     f"{got.get(name, 0)} times, not {n}")


def _profile_call(card, label, fn, calls: int = 3) -> None:
    """``fn`` (one model call) under ``torch.profiler``: device busy time a
    call, its operations, the leading kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    dev, busy, by_name = _profile_device(prof)
    busy_ms = busy / 1e3 / calls
    print(f"[{card}] {label} under torch.profiler: wall {wall:.2f} ms, device "
          f"operations {len(dev) / calls:.0f}, device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall):.4f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"  {t / 1e3 / calls:8.3f} ms  {n / calls:5.0f}x  {name[:90]}")


def _whisper(device, card) -> dict:
    """whisper-base at full size (6 + 6 layers, d 512, vocab 51865 padded),
    2xT kv8 bf16: stub frames (4, 1500, 512), a 32-token prompt, 16 greedy
    steps; launches per prefill and step against the code's counts; a
    profiled decode step; kernels against the plain versions (2xT
    reported, fp32 in float32 under fault C2's contract, the encoder
    output held fixed); the launcher's legacy loop."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.launch import serve as cli
    from repro_torch.models import frontends
    print("-- 4n whisper-base 2xT kv8 bf16 (full size)", flush=True)
    model, params = _family_model("whisper-base", device, precision="2xT",
                                  kv_bits=8)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(5)
    frames = frontends.audio_frames_stub(gen, WHISPER_B, WHISPER_FRAMES,
                                         cfg.d_model)
    tokens = torch.randint(0, cfg.vocab, (WHISPER_B, WHISPER_PROMPT),
                           generator=gen, device=device)
    batch = {"tokens": tokens, "frames": frames}
    # from the code: an encoder layer 4 + 2 projections, a decoder layer 4
    # self + 4 cross + 2 FFN at prefill, 4 + 2 (cross wq, wo) + 2 a step
    e, dl = cfg.n_enc_layers, cfg.n_layers
    want_prefill = {"ternary_matmul": 6 * e + 10 * dl,
                    "act_quant_signed_grouped": 6 * e + 10 * dl,
                    "flash_attention": e + 2 * dl, "decode_attention": 0}
    want_step = {"ternary_matmul": 8 * dl, "act_quant_signed_grouped": 8 * dl,
                 "flash_attention": dl, "decode_attention": dl}
    s_max = WHISPER_PROMPT + WHISPER_GEN
    model.prefill(params, batch, s_max)                  # warm
    torch.cuda.synchronize()
    engine.reset_launch_counts()
    t0 = time.perf_counter()
    lp, cache = model.prefill(params, batch, s_max)
    torch.cuda.synchronize()
    t_prefill = (time.perf_counter() - t0) * 1e3
    prefill = engine.launch_counts()
    _check_counts("whisper prefill", prefill, want_prefill)
    tok = lp[:, -1:].argmax(-1)
    stream = [tok]
    engine.reset_launch_counts()
    ld, cache = model.decode_step(params, tok, cache, WHISPER_PROMPT)
    torch.cuda.synchronize()
    step = engine.launch_counts()
    _check_counts("whisper decode step", step, want_step)
    tok = ld[:, -1:].argmax(-1)
    stream.append(tok)
    t0 = time.perf_counter()
    for i in range(1, WHISPER_GEN - 1):
        ld, cache = model.decode_step(params, tok, cache, WHISPER_PROMPT + i)
        tok = ld[:, -1:].argmax(-1)
        stream.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = torch.cat(stream, dim=1)
    check(bool(torch.isfinite(ld).all()) and toks.shape == (WHISPER_B,
                                                            WHISPER_GEN)
          and int(toks.max()) < cfg.padded_vocab, "whisper: bad stream")
    print(f"[{card}] whisper 2xT kv8 bf16: prefill (frames {WHISPER_B} x "
          f"{WHISPER_FRAMES}, prompt {WHISPER_PROMPT}) {t_prefill:.1f} ms; "
          f"decode {WHISPER_B * (WHISPER_GEN - 2) / wall:.1f} tok/s "
          f"({wall * 1e3 / (WHISPER_GEN - 2):.2f} ms a step); launches per "
          f"prefill {prefill}, per decode step {step}; first tokens "
          f"{toks[:, :8].tolist()}")
    _profile_call(card, "whisper 2xT decode step (B 4)",
                  lambda: model.decode_step(params, tok, cache,
                                            WHISPER_PROMPT + WHISPER_GEN - 1))
    step_in = tokens[:, -1:]
    cmp = _compare_steps(model, params, batch, step_in, device)
    _report_steps("whisper 2xT bf16 kv8", cmp, bounded=False)
    out = {"prefill": prefill, "step": step, "2xT": cmp["launches"]}
    del params, cache
    m32, p32 = _family_model("whisper-base", device, precision="fp32",
                             kv_bits=8, dtype="float32")
    cmp = _compare_steps(m32, p32, batch, step_in, device)
    # one plain prefill holds the encoder output (and the cross K/V) fixed
    # across the contract's decode runs
    _, cache32 = m32.prefill(p32, batch, WHISPER_PROMPT + 2, backend="torch")
    _report_c2(card, "whisper fp32 weights, float32, kv8", m32, p32, cmp,
               None, device, start=(step_in, cache32, WHISPER_PROMPT))
    del cache32
    _check_counts("whisper fp32 decode step", cmp["launches"]["decode"],
                  {"flash_attention": dl, "decode_attention": dl})
    out["fp32"] = cmp["launches"]
    del p32
    argv = ["--arch", "whisper-base", "--precision", "2xT", "--kv-bits", "8",
            "--requests", "4", "--prompt-len", "64", "--gen", "16"]
    print(f"serving CLI: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    toks = cli.main(argv)
    check(toks.shape == (4, 16), f"CLI: tokens {toks.shape}")
    _check_counts("CLI decode steps", engine.launch_counts(),
                  {k: 15 * n for k, n in want_step.items()})
    torch.cuda.empty_cache()
    return out


def _glm4(device, card) -> dict:
    """glm4-9b at full size (40 layers, d 4096, 32 / 2 heads: G 16), 2xT
    kv8 bf16 through the dense batcher (chunked and whole-prompt) and the
    paged kv8 batcher, kernels against the plain versions, a profiled
    decode step; fp32 weights in float32 at 2 of 40 layers: B5 under C2's
    contract, B4 at kv16 (bound) and kv8 (C2's swap)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    print("-- 4n glm4-9b 2xT kv8 bf16 (full size)", flush=True)
    model, params = _family_model("glm4-9b", device, precision="2xT",
                                  kv_bits=8)
    cfg = model.cfg
    n_l, n_proj = cfg.n_layers, _n_proj(cfg)
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK)
    _warm(ContinuousBatcher(model, params, sc), cfg)
    batcher = ContinuousBatcher(model, params, sc)
    streams, launches = _run(batcher, _requests(cfg, N_REQ, GEN), card,
                             "glm4 2xT kv8")
    m = batcher.metrics
    for name in ("act_quant_signed_grouped", "ternary_matmul"):
        check(launches[name] == n_proj * _model_calls(m),
              f"glm4: {name} launched {launches[name]} times in "
              f"{_model_calls(m)} model calls, not {n_proj} per call")
    check(launches["decode_attention"] == n_l * m.decode_steps,
          "glm4: not one decode_attention launch per layer and step")
    prompt = _requests(cfg, 1, GEN)[0].tokens
    cmp = _compare_backends(model, params, sc, prompt, device)
    tol0 = 1e-5 + 1e-4 * cmp["attn0_scale"]
    print(f"glm4 launches per prefill chunk (C={CHUNK}): "
          f"{cmp['launches']['chunk']}; per decode step (B={N_SLOTS}): "
          f"{cmp['launches']['decode']}")
    print(f"glm4 2xT bf16, kernels vs plain versions: prefill_chunk max "
          f"|dlogit| {cmp['chunk']:.3e} (tolerance 0); decode step layer 0 "
          f"attention (B5, G 16) max |diff| {cmp['attn0']:.3e} (tolerance "
          f"{tol0:.3e}); attention outputs equal in bf16 in the first "
          f"{cmp['layers_equal']} of {n_l} layers; logits max |dlogit| "
          f"{cmp['decode']:.3e} of max|logit| {cmp['scale']:.3e}, greedy "
          f"tokens agree on {cmp['agree']}/{N_SLOTS} rows (not bounded, as "
          "phase 4)")
    check(cmp["chunk"] == 0.0, f"glm4 prefill_chunk differs by {cmp['chunk']}")
    check(cmp["q0_equal"] and cmp["attn0"] <= tol0,
          f"glm4 decode step layer 0 attention differs by {cmp['attn0']}")
    check(cmp["launches"]["decode"]["ternary_matmul"] == n_proj,
          f"glm4 decode step: ternary_matmul not {n_proj}")

    wb = ContinuousBatcher(model, params, dataclasses.replace(sc,
                                                              chunk_size=0))
    _, wl = _run(wb, _requests(cfg, N_REQ, GEN), card,
                 "glm4 2xT kv8 whole-prompt")
    print(f"glm4 flash_attention launches {wl['flash_attention']} over "
          f"{wb.metrics.prefill_full} whole prefills ({n_l} per prefill)")
    check(wl["flash_attention"] == n_l * wb.metrics.prefill_full > 0,
          "glm4 whole-prompt: not one flash_attention launch per layer")

    pmodel = build_model(dataclasses.replace(cfg, kv_bits=0))
    pb = PagedBatcher(pmodel, params, _paged_config())
    pstreams, pl = _run(pb, _requests(cfg, N_REQ, GEN), card,
                        "glm4 2xT paged kv8")
    check(pl["paged_attention"] == n_l * pb.metrics.decode_steps,
          "glm4 paged: not one paged_attention launch per layer and step")
    pc = _compare_paged(pmodel, params, prompt, device, probe=True)
    ptol0 = 1e-5 + 1e-4 * pc["attn0_scale"]
    print(f"glm4 2xT bf16 paged, kernels vs plain versions: "
          f"prefill_chunk_paged max |dlogit| {pc['chunk']:.3e} (tolerance 0); "
          f"decode_step_paged layer 0 attention (B2, G 16) max |diff| "
          f"{pc['attn0']:.3e} (tolerance {ptol0:.3e}); logits max |dlogit| "
          f"{pc['decode']:.3e} of max|logit| {pc['scale']:.3e} (not bounded); "
          f"launches per paged decode step {pc['launches']['decode']}; "
          f"streams equal to the dense run's "
          f"{sum(pstreams[r] == streams[r] for r in streams)}/{N_REQ}")
    check(pc["chunk"] == 0.0 and pc["q0_equal"] and pc["attn0"] <= ptol0,
          f"glm4 paged: chunk {pc['chunk']}, layer 0 attention {pc['attn0']}")
    phase_profile(card, "glm4 2xT dense", ContinuousBatcher(model, params, sc))
    del batcher, wb, pb, params
    torch.cuda.empty_cache()

    print(f"-- 4n glm4-9b fp32 weights, float32 ({WIDE_LAYERS} of 40 layers "
          "at full width: a depth cut for memory)", flush=True)
    model32, params32 = _family_model("glm4-9b", device, precision="fp32",
                                      kv_bits=8, dtype="float32",
                                      n_layers=WIDE_LAYERS)
    c32 = _compare_backends(model32, params32, sc, prompt, device)
    tol = 1e-4 * c32["scale"]
    print(f"glm4 fp32 weights, float32, kv8, kernels vs plain versions: "
          f"prefill_chunk max |dlogit| {c32['chunk']:.3e}, decode_step max "
          f"|dlogit| {c32['decode']:.3e} (tolerance {tol:.3e} = 1e-4 of "
          f"max|logit| {c32['scale']:.3e}), greedy tokens agree on "
          f"{c32['agree']}/{N_SLOTS} rows")
    check(c32["launches"]["decode"]["decode_attention"] == WIDE_LAYERS,
          "glm4 fp32 decode step: not one decode_attention per layer")
    check(c32["chunk"] == 0.0, f"glm4 fp32 prefill_chunk differs by "
                               f"{c32['chunk']}")
    first = _c2_contract(card, model32, params32, prompt, device)
    check(c32["decode"] <= tol or first is not None,
          f"glm4 fp32 decode_step logits differ by {c32['decode']} > {tol} "
          "with no K/V code step")
    fused = _fused_checks("glm4", model32, params32, prompt, device)
    del params32
    torch.cuda.empty_cache()
    return {"2xT dense": launches, "whole": wl, "paged": pl, "fused": fused}


def _gemma2(device, card) -> dict:
    """gemma2-27b at full width, 2 periods (4 of 46 layers: a depth cut
    for memory): 2xT bf16 through the dense batcher, chunked (every layer
    has a softcap: the plain attention path) and whole-prompt (B8 with the
    window and the softcap); fp32 weights in float32, a whole prefill of
    GEMMA_PREFILL positions (past the 4096 window) through the kernels
    against the plain versions within 1e-4 of max|logit|; 2xT one prefill
    and one step through the kernels against the plain versions,
    reported, and equal to them with B8 plain."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    print(f"-- 4n gemma2-27b 2xT bf16 (full width, {GEMMA_LAYERS} of 46 "
          "layers: a depth cut for memory)", flush=True)
    model, params = _family_model("gemma2-27b", device, precision="2xT",
                                  kv_bits=8, n_layers=GEMMA_LAYERS)
    cfg = model.cfg
    n_proj = _n_proj(cfg)
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK)
    _warm(ContinuousBatcher(model, params, sc), cfg)
    batcher = ContinuousBatcher(model, params, sc)
    _, launches = _run(batcher, _requests(cfg, N_REQ, GEN), card,
                       "gemma2 2xT kv8")
    m = batcher.metrics
    for name in ("act_quant_signed_grouped", "ternary_matmul"):
        check(launches[name] == n_proj * _model_calls(m),
              f"gemma2: {name} not {n_proj} per model call")
    check(launches["decode_attention"] == 0,
          "gemma2: decode_attention launched (every layer has a softcap)")
    wb = ContinuousBatcher(model, params, dataclasses.replace(sc,
                                                              chunk_size=0))
    _, wl = _run(wb, _requests(cfg, N_REQ, GEN), card,
                 "gemma2 2xT kv8 whole-prompt")
    check(wl["flash_attention"] == cfg.n_layers * wb.metrics.prefill_full > 0,
          "gemma2 whole-prompt: not one flash_attention launch per layer")
    toks = torch.randint(0, cfg.vocab, (N_SLOTS, PROMPT), device=device,
                         generator=torch.Generator(device=device
                                                   ).manual_seed(6))
    cmp = _compare_steps(model, params, {"tokens": toks}, toks[:, -1:],
                         device)
    _report_steps("gemma2 2xT bf16 kv8", cmp, bounded=False)
    del batcher, wb, params
    torch.cuda.empty_cache()
    model32, params32 = _family_model("gemma2-27b", device, precision="fp32",
                                      kv_bits=0, dtype="float32",
                                      n_layers=GEMMA_LAYERS)
    tokens = torch.randint(0, cfg.vocab, (1, GEMMA_PREFILL), device=device,
                           generator=torch.Generator(device=device
                                                     ).manual_seed(4))
    runs, counts = {}, {}
    for run, backend in (("cuda", "cuda"), ("plain", "torch")):
        engine.reset_launch_counts()
        runs[run], _ = model32.prefill(params32, {"tokens": tokens},
                                       GEMMA_PREFILL, backend=backend)
        torch.cuda.synchronize()
        counts[run] = engine.launch_counts()
    err = (runs["cuda"] - runs["plain"]).abs().max().item()
    tol = 1e-4 * runs["plain"].abs().max().item()
    print(f"gemma2 fp32 weights, float32, whole prefill S={GEMMA_PREFILL} "
          f"(local layers' window 4096, softcap 50, final softcap 30), "
          f"kernels vs plain versions: max |dlogit| {err:.3e} (tolerance "
          f"{tol:.3e}, {err / tol:.4f} of it); launches {counts['cuda']}")
    check(err <= tol, f"gemma2 fp32 prefill differs by {err} > {tol}")
    check(counts["cuda"]["flash_attention"] == GEMMA_LAYERS
          and not any(counts["plain"].values()),
          "gemma2 fp32 prefill: not one flash_attention per layer")
    del params32
    torch.cuda.empty_cache()
    return {"2xT dense": launches, "whole": wl, "fp32": counts["cuda"]}


def _wide_two_layers(device, card, arch: str) -> dict:
    """``arch`` at full width, WIDE_LAYERS layers (a depth cut for memory):
    one prefill of 4 prompts of PROMPT tokens (or, for the embeds
    frontend, the vision stub's patch embeddings) and one decode step
    through the kernels against the plain versions, 2xT bf16 reported and
    fp32 in float32 bounded (a token stack: under fault C2's contract);
    the embeds stack also through the launcher's legacy loop."""
    import argparse
    import torch
    from repro_torch.launch import serve as cli
    from repro_torch.models import frontends
    label = arch.split("-")[0]
    print(f"-- 4n {arch} (full width, {WIDE_LAYERS} layers: a depth cut for "
          "memory)", flush=True)
    out = {}
    for precision, dtype in (("2xT", "bfloat16"), ("fp32", "float32")):
        model, params = _family_model(arch, device, precision=precision,
                                      kv_bits=8, dtype=dtype,
                                      n_layers=WIDE_LAYERS)
        cfg = model.cfg
        gen = torch.Generator(device=device).manual_seed(6)
        if cfg.frontend == "embeds":
            batch = {"embeds": frontends.vision_patches_stub(
                gen, N_SLOTS, PROMPT, cfg.d_model)}
            step_in = torch.zeros((N_SLOTS, 1, cfg.d_model), device=device)
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab, (N_SLOTS, PROMPT),
                                             generator=gen, device=device)}
            step_in = batch["tokens"][:, -1:]
        cmp = _compare_steps(model, params, batch, step_in, device)
        if precision == "fp32" and cfg.frontend != "embeds":
            _report_c2(card, f"{label} {precision} {dtype} kv8", model,
                       params, cmp, _requests(cfg, 1, GEN)[0].tokens, device)
        else:
            _report_steps(f"{label} {precision} {dtype} kv8", cmp,
                          bounded=precision == "fp32")
        want = {"flash_attention": WIDE_LAYERS}
        if precision == "2xT":
            want.update(ternary_matmul=_n_packed(params),
                        act_quant_signed_grouped=_n_proj(cfg))
        _check_counts(f"{label} {precision} prefill",
                      cmp["launches"]["prefill"], want)
        want.update(flash_attention=0, decode_attention=WIDE_LAYERS)
        _check_counts(f"{label} {precision} decode step",
                      cmp["launches"]["decode"], want)
        out[precision] = cmp["launches"]
        if cfg.frontend == "embeds" and precision == "2xT":
            args = argparse.Namespace(autotune=False, requests=N_SLOTS,
                                      prompt_len=PROMPT, gen=8)
            print(f"{label} through the launcher's legacy loop (embeds "
                  f"input, {N_SLOTS} x {PROMPT} patches, 8 steps):")
            toks = cli._legacy_loop(model, params, cfg, args, device)
            check(toks.shape == (N_SLOTS, 8), f"{label} legacy loop: {toks.shape}")
        del params
        torch.cuda.empty_cache()
    return out


def phase_encdec(device, card) -> dict:
    """4n: the enc-dec backbone, the embeds frontend, gemma2's post-norms
    and the last LM configs.  Returns the launches of its runs by kernel,
    summed."""
    import torch
    from repro_torch.kernels import engine
    print("== 4n. enc-dec, embeds frontend and the last LM families",
          flush=True)
    t0 = time.time()
    _flash_4n(torch.Generator().manual_seed(8), device, card)
    _proj_kernel_shapes_4n(torch.Generator(device=device).manual_seed(9),
                           device)
    runs = [_whisper(device, card), _glm4(device, card),
            _gemma2(device, card),
            _wide_two_layers(device, card, "starcoder2-15b"),
            _wide_two_layers(device, card, "internvl2-76b")]
    print("-- 4n kimi-k2-1t-a32b (reduce_for_smoke shapes, Dh 112, float32)",
          flush=True)
    runs.append(_reduced_stack(device, card, "kimi-k2-1t-a32b", "kimi-k2",
                               2, head_dim=112))
    total = {}

    def add(counts):
        for name, n in counts.items():
            if isinstance(n, dict):
                add(n)
            elif isinstance(n, int) and name in engine.KERNELS:
                total[name] = total.get(name, 0) + n
    for r in runs:
        add(r)
    print(f"phase 4n launches by kernel: {total}")
    for name in ("ternary_matmul", "act_quant_signed_grouped",
                 "decode_attention", "flash_attention", "paged_attention",
                 "fused_decode"):
        check(total.get(name, 0) > 0, f"phase 4n never launched {name}")
    print(f"phase 4n: {time.time() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# 4q: QAT training, then serving the trained weights
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S = 8, 256               # batch x sequence of a train step
# The trained run's depth cut: the reference's 2xT straight-through
# gradient grows ~10^2-10^3 a layer going back through the stack (both
# packages, on the CPU: the grad norm is ~5e4 at 2 layers, ~1e9 at 4,
# inf at 12 at full width; NaN at 30 at reduce_for_smoke widths), so past
# a few layers an update is NaN.  The uncut 30-layer step is timed, not
# trained.
TRAIN_LAYERS = 2
TRAIN_LR = 3e-3                         # examples/train_qat.py's
TRAIN_FIRST, TRAIN_STEPS = 20, 30       # the run checkpoints at 20, resumes
FULL_STEPS = 5                          # timed steps of the 30-layer model
LEARN_STEPS, LEARN_MARGIN = 20, 0.5
STEP_LR = 1e-3                          # the card-vs-CPU step's adamw lr
# the card's train step against the CPU's (reduced smollm, float32, TF32
# off): loss and grad norm relative, every updated leaf in units of lr (an
# Adam step moves an entry by ~lr g / (|g| + eps): near +-lr whatever the
# summation order, except where g itself is at the f32 ulps' level);
# activation codes that differ (2xT), each one step from the other and
# within CODE_DIST steps of the boundary between them
STEP_METRIC_RTOL, STEP_LEAF_LR, CODE_DIST = 1e-5, 0.1, 1e-3


@contextlib.contextmanager
def _act_codes(take_from=None):
    """Record ``u = x / scale`` of every signed activation quantizer call
    (the fake-quant forward, ``models.layers.act_fake_quant``) on the host.
    With ``take_from`` (another run's records), each call keeps its own
    values and gradient except where its code, or its clip gradient
    factor (1 inside, 1/2 on the bound, 0 outside), differs from that
    run's call: there it takes the other run's (fault C1's swap, as
    ``tests/test_torch_qat.py`` holds the port to the reference).  Yields
    (records, differing entries as (kind, steps apart, distance of this
    run's u from the boundary in steps))."""
    import torch
    from repro_torch.core.precision import A_SIGNED
    from repro_torch.models import layers
    orig = layers.act_fake_quant
    recs, flips = [], []

    def factor(u, qmax):
        a = u.abs()
        return torch.where(a < qmax, 1.0, torch.where(a == qmax, 0.5, 0.0))

    def quantizer(x, cfg):
        y = orig(x, cfg)
        if cfg.a_mode != A_SIGNED or cfg.a_bits == 1:
            return y
        qmax = (1 << (cfg.a_bits - 1)) - 1
        xs = x.detach()
        s = xs.abs().amax().clamp_min(1e-8) / qmax        # the quantizer's ops
        u = xs / s
        recs.append(u.cpu())
        if take_from is None:
            return y
        ur = take_from[len(recs) - 1].to(u.device)
        own = torch.round(u.clamp(-qmax, qmax))
        want = torch.round(ur.clamp(-qmax, qmax))
        d = want - own
        for i in torch.nonzero(d.reshape(-1)).reshape(-1).tolist():
            flips.append(("code", abs(float(d.reshape(-1)[i])),
                          abs(float(u.reshape(-1)[i]
                                    - (want + own).reshape(-1)[i] / 2))))
        df = factor(ur, qmax) - factor(u, qmax)
        for i in torch.nonzero(df.reshape(-1)).reshape(-1).tolist():
            flips.append(("clip", 0.0, abs(abs(float(u.reshape(-1)[i]))
                                           - qmax)))
        return y + (d * s).to(y.dtype) + df.to(x.dtype) * (x - x.detach())

    layers.act_fake_quant = quantizer
    try:
        yield recs, flips
    finally:
        layers.act_fake_quant = orig


def train_step_vs_cpu(precision: str, device) -> dict:
    """One adamw train step (lr STEP_LR) of reduced smollm in float32 from
    the same params, optimizer state and batch on the card and on the CPU.
    At a quantized precision the card also runs with the CPU run's
    activation codes where its own differ (``_act_codes``); the bounded
    numbers are that run's, the raw run's are reported.  Returns the
    relative loss and grad-norm gaps, the largest updated-leaf gap in
    units of lr, and the differing codes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_precision, signed
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, reduce_for_smoke
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduce_for_smoke(get_config("smollm-135m", precision=precision))
    check(cfg.dtype == "float32", f"reduced smollm in {cfg.dtype}")
    model, opt = build_model(cfg), make_optimizer("adamw", lr=STEP_LR)
    step = make_train_step(model, opt)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen)
    batch = {"tokens": tokens, "labels": tokens}
    state = opt.init(params)

    def run(dev, take_from=None):
        on = lambda t: t.to(dev)
        with _act_codes(take_from) as (recs, flips):
            p, s, m = step(tree_map(on, params), tree_map(on, state),
                           {k: on(v) for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return ([x.cpu() for x in tree_leaves(p)],
                {k: float(v) for k, v in m.items()}, recs, flips)

    cpu_p, cpu_m, cpu_u, _ = run(torch.device("cpu"))

    def gaps(p, m):
        return {"loss_rel": abs(m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"]),
                "gnorm_rel": abs(m["grad_norm"] - cpu_m["grad_norm"])
                / abs(cpu_m["grad_norm"]),
                "leaf_lr": max(float((a - b).abs().max())
                               for a, b in zip(p, cpu_p)) / STEP_LR}
    raw_p, raw_m, raw_u, _ = run(device)
    out = {"precision": precision, "quant_calls": len(cpu_u),
           "cpu_loss": cpu_m["loss"], "cpu_grad_norm": cpu_m["grad_norm"],
           "raw": gaps(raw_p, raw_m), "bounded": gaps(raw_p, raw_m),
           "raw_codes_apart": 0, "flips": []}
    if cpu_u:
        qmax = (1 << (signed(get_precision(precision)).a_bits - 1)) - 1
        code = lambda u: torch.round(u.clamp(-qmax, qmax))
        out["raw_codes_apart"] = sum(int((code(a) != code(b)).sum())
                                     for a, b in zip(raw_u, cpu_u))
        sw_p, sw_m, _, out["flips"] = run(device, take_from=cpu_u)
        out["bounded"] = gaps(sw_p, sw_m)
    return out


def _check_step(rep: dict) -> None:
    b, r = rep["bounded"], rep["raw"]
    print(f"card vs CPU, one train step of reduced smollm {rep['precision']} "
          f"float32 (adamw lr {STEP_LR}, TF32 off): loss {rep['cpu_loss']:.6f} "
          f"(CPU), grad norm {rep['cpu_grad_norm']:.6g}; "
          f"{rep['quant_calls']} activation quantizer calls, "
          f"{rep['raw_codes_apart']} codes apart on the card's own run "
          f"(loss {r['loss_rel']:.3e} rel, grad norm {r['gnorm_rel']:.3e} "
          f"rel, leaves {r['leaf_lr']:.4f} lr); with the CPU's codes where "
          f"they differ ({len(rep['flips'])} entries {rep['flips'][:8]}): "
          f"loss {b['loss_rel']:.3e} rel, grad norm {b['gnorm_rel']:.3e} "
          f"rel, updated leaves within {b['leaf_lr']:.4f} lr (bounds "
          f"{STEP_METRIC_RTOL}, {STEP_METRIC_RTOL}, {STEP_LEAF_LR} lr)")
    check(b["loss_rel"] <= STEP_METRIC_RTOL and
          b["gnorm_rel"] <= STEP_METRIC_RTOL and b["leaf_lr"] <= STEP_LEAF_LR,
          f"{rep['precision']}: the card's train step leaves the CPU's bound")
    for kind, steps, dist in rep["flips"]:
        check((kind == "clip" or steps == 1) and dist <= CODE_DIST,
              f"{rep['precision']}: an activation code parts from the CPU's "
              f"by {steps} steps, {dist} steps from its boundary")


def _train_batch(cfg, device):
    """The data pipeline's first batch of TRAIN_B x TRAIN_S tokens, on the
    card."""
    import torch
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)
    return {k: torch.from_numpy(v).to(device, torch.int64)
            for k, v in next(data).items()}


def _full_depth_step(device, card) -> float:
    """smollm-135m at full size (30 layers), 2xT, bf16 params, adamw: the
    train step's wall time (FULL_STEPS steps, each from the same initial
    state, after a warm-up step), tokens/s, peak memory and a profiled
    step.  Its loss is finite; its grad norm is printed (the reference's
    2xT gradient overflows at this depth, see TRAIN_LAYERS).  Returns the
    wall p50 ms."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves
    cfg = model_config(precision="2xT")
    check(cfg.n_layers == 30 and cfg.d_model == 576 and cfg.vocab == 49152
          and cfg.dtype == "bfloat16", f"not smollm-135m at full size: {cfg}")
    model, opt = build_model(cfg), make_optimizer("adamw", lr=TRAIN_LR)
    step = make_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator().manual_seed(0), device)
    state = opt.init(params)
    batch = _train_batch(cfg, device)
    metrics = []
    times = []
    for i in range(FULL_STEPS + 1):
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        m = {k: float(v) for k, v in m.items()}
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(times[1:])
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(all(np.isfinite(m["loss"]) for m in metrics),
          f"30-layer 2xT train step: loss {metrics}")
    print(f"[{card}] train step, smollm-135m 2xT bf16 at full size ({cfg.n_layers} "
          f"layers, {n_params / 1e6:.1f} M params), adamw, {TRAIN_B} x "
          f"{TRAIN_S} tokens: wall p50 {p50:.2f} ms over {FULL_STEPS} steps "
          f"(first {times[0]:.1f} ms), {TRAIN_B * TRAIN_S / p50 * 1e3:.0f} "
          f"tokens/s; peak memory {peak / 1e9:.3f} GB "
          f"(max_memory_allocated); loss {metrics[0]['loss']:.4f}, grad norm "
          f"{metrics[0]['grad_norm']} (the reference's 2xT gradient overflows "
          "at this depth: not trained)")
    _profile_call(card, f"smollm-135m 2xT train step ({cfg.n_layers} layers, "
                  f"B {TRAIN_B}, S {TRAIN_S})",
                  lambda: step(params, state, batch))
    del params, state
    torch.cuda.empty_cache()
    return p50


def phase_train(device, card, tmp: str) -> dict:
    """4q: QAT training of smollm-135m at 2xT, bf16 params, adamw, batch
    TRAIN_B x TRAIN_S: the full-size (30-layer) step timed and profiled
    (``_full_depth_step``); at full width with the depth cut to
    TRAIN_LAYERS, a run through ``launch.train`` (ElasticTrainer,
    checkpoints under ``tmp``) with finite losses, the loss on one fixed
    batch against LEARN_MARGIN, the card's step against the CPU's
    (``train_step_vs_cpu``, fp32 and 2xT), a restart from the
    step-TRAIN_FIRST checkpoint; then the trained weights packed and
    served through the kernels.  Returns the 30-layer step's wall p50 ms
    and the launch.train run's losses, for phase 4s."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels import engine, ref
    from repro_torch.kernels.act_quant import act_quant_signed_rows
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, to_serving
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    from repro_torch.tree import tree_leaves
    print("== 4q. QAT training: smollm-135m 2xT bf16, then serving the "
          "trained weights", flush=True)
    t0 = time.time()
    full_p50 = _full_depth_step(device, card)

    cfg = dataclasses.replace(model_config(precision="2xT"),
                              n_layers=TRAIN_LAYERS)
    ckpt = str(Path(tmp) / "train_ckpt")
    argv = ["--arch", "smollm-135m", "--precision", "2xT", "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", str(TRAIN_LR),
            "--optimizer", "adamw", "--save-every", "100", "--ckpt-dir", ckpt,
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    first = train.train(train.parse_args(argv + ["--steps", str(TRAIN_FIRST)]),
                        cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in first.metrics]
    check(first.status == "done" and len(losses) == TRAIN_FIRST
          and all(np.isfinite(losses)), f"train run: {first.status} {losses}")
    p50 = statistics.median(first.step_ms)
    print(f"[{card}] launch.train smollm-135m 2xT bf16, full width, "
          f"{TRAIN_LAYERS} layers (a depth cut: the reference's 2xT gradient "
          f"overflows deeper), adamw lr {TRAIN_LR}: {TRAIN_FIRST} steps of "
          f"{TRAIN_B} x {TRAIN_S} tokens in {first.wall_s:.1f} s; step wall "
          f"p50 {p50:.2f} ms (first {first.step_ms[0]:.1f}); "
          f"{TRAIN_B * TRAIN_S / p50 * 1e3:.0f} tokens/s at p50; peak memory "
          f"{peak / 1e9:.3f} GB; losses {[round(x, 3) for x in losses]}")

    # one fixed batch, repeated: the loss must fall
    model = first.model
    opt = make_optimizer("adamw", lr=TRAIN_LR)
    step = make_train_step(model, opt)
    batch = _train_batch(cfg, device)
    params = model.init(torch.Generator().manual_seed(0), device)
    state = opt.init(params)
    learn = []
    for _ in range(LEARN_STEPS):
        params, state, m = step(params, state, batch)
        learn.append(float(m["loss"]))
    del params, state
    print(f"[{card}] one fixed batch x {LEARN_STEPS} steps: loss "
          f"{learn[0]:.4f} -> {learn[-1]:.4f} (drop {learn[0] - learn[-1]:.4f}"
          f", margin {LEARN_MARGIN}); {[round(x, 3) for x in learn]}")
    check(all(np.isfinite(learn)) and learn[-1] <= learn[0] - LEARN_MARGIN,
          f"the loss on a fixed batch fell {learn[0] - learn[-1]:.4f}, not "
          f"{LEARN_MARGIN}")

    # attention under autograd: the reference's plain training attention,
    # traced as a plain dispatch; without gradients B8 as before
    engine.reset_launch_counts()
    with engine.dispatch_trace() as ev:
        step(first.state["params"], first.state["opt"], batch)
    torch.cuda.synchronize()
    plain = sum(e.op == "flash_attention" and e.impl_backend == "torch"
                for e in ev)
    b8_grad = engine.launch_counts()["flash_attention"]
    engine.reset_launch_counts()
    with torch.no_grad():
        model.forward(first.state["params"], batch)
    torch.cuda.synchronize()
    b8_fwd = engine.launch_counts()["flash_attention"]
    print(f"attention in a train step: {plain} plain dispatches traced "
          f"(impl_backend torch), {b8_grad} B8 launches; a forward without "
          f"gradients: {b8_fwd} B8 launches")
    check(plain == cfg.n_layers and b8_grad == 0 and b8_fwd == cfg.n_layers,
          "attention routing under autograd")

    for precision in ("fp32", "2xT"):
        _check_step(train_step_vs_cpu(precision, device))

    # restart from the step-TRAIN_FIRST checkpoint
    ck = Checkpointer(ckpt)
    check(ck.all_steps() == [TRAIN_FIRST], f"checkpoints {ck.all_steps()}")
    saved = tree_leaves(first.state)
    back = tree_leaves(ck.restore(TRAIN_FIRST, first.state))
    check(len(saved) == len(back) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(saved, back)),
        "the restored state differs from the saved one")
    del back
    resumed = train.train(train.parse_args(argv + ["--steps",
                                                   str(TRAIN_STEPS)]), cfg)
    rl = [m["loss"] for m in resumed.metrics]
    check(resumed.status == "done" and len(rl) == TRAIN_STEPS - TRAIN_FIRST
          and resumed.data.state_dict() == {"step": TRAIN_STEPS}
          and all(np.isfinite(rl)),
          f"resume: {resumed.status}, {len(rl)} steps, data at "
          f"{resumed.data.state_dict()}")
    print(f"restart: {len(saved)} leaves restored torch.equal to the saved "
          f"step-{TRAIN_FIRST} state; the resumed run took steps "
          f"{TRAIN_FIRST}..{TRAIN_STEPS - 1} (data position {TRAIN_FIRST} -> "
          f"{resumed.data.state_dict()['step']}); losses "
          f"{[round(x, 3) for x in rl]}; checkpoints {ck.all_steps()}")
    del first, saved

    # deploy: pack the trained weights, serve through the kernels
    scfg = dataclasses.replace(cfg, kv_bits=8)
    smodel = build_model(scfg)
    sparams = to_serving(resumed.state["params"], scfg, tp=1)
    del resumed
    torch.cuda.empty_cache()
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK)
    _warm(ContinuousBatcher(smodel, sparams, sc), scfg)
    reqs = _requests(scfg, N_SLOTS, GEN)
    _run(ContinuousBatcher(smodel, sparams, sc), reqs, card,
         "trained 2xT kv8")
    n_proj = N_PROJ * scfg.n_layers
    cmp = _compare_backends(smodel, sparams, sc, reqs[0].tokens, device)
    want = {"ternary_matmul": n_proj, "act_quant_signed_grouped": n_proj,
            "decode_attention": scfg.n_layers}
    _check_counts("trained decode step", cmp["launches"]["decode"], want)
    check(cmp["quant_dispatches"]["decode"] == n_proj,
          f"trained decode step: {cmp['quant_dispatches']['decode']} "
          "quantizer dispatches traced")
    cache = tfm.make_cache(scfg, N_SLOTS, S_MAX, device)
    with engine.dispatch_trace() as ev:
        smodel.decode_step(sparams, torch.zeros((N_SLOTS, 1), dtype=torch.long,
                                                device=device), cache,
                           torch.tensor([3, 4, 5, 6], device=device))
    torch.cuda.synchronize()
    traced = {op: sum(e.op == op and e.impl_backend == "cuda" for e in ev)
              for op in ("qmatmul", "decode_attention")}
    check(traced == {"qmatmul": n_proj, "decode_attention": scfg.n_layers},
          f"trained decode step traced {traced}")
    # B7c then B1 on layer 0's seven trained projections at M = N_SLOTS
    gen = torch.Generator(device=device).manual_seed(12)
    lp = sparams["blocks"]["layer_0"]
    projs = [lp["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [lp["ffn"][n] for n in ("w_gate", "w_up", "w_down")]
    for p in projs:
        w, scale = p["wt_packed"][0], p["scale"][0]
        k = w.shape[1] * 16
        x = torch.randn((N_SLOTS, k), generator=gen, device=device
                        ).to(torch.bfloat16)
        (c, s), (c_ref, s_ref) = act_quant_signed_rows(x, bits=2), \
            ref.act_quant_signed_rows_ref(x, 2)
        y, y_ref = ternary_matmul(c, w, scale), \
            ref.ternary_matmul_ref(c, w, scale)
        torch.cuda.synchronize()
        check(torch.equal(c, c_ref) and torch.equal(s, s_ref),
              f"trained layer 0 (N, K) ({w.shape[0]}, {k}): B7c differs from "
              "its plain version")
        check(torch.equal(y, y_ref), f"trained layer 0 (N, K) ({w.shape[0]}, "
              f"{k}): B1 differs from its plain version")
    print(f"trained weights served: launches per decode step "
          f"{cmp['launches']['decode']} ({N_PROJ} / {N_PROJ} / 1 a layer, as "
          f"phase 4's), traced {traced}; B7c and B1 torch.equal to their "
          f"plain versions on layer 0's {len(projs)} projections (M = "
          f"{N_SLOTS}); tokens within the logits' {scfg.padded_vocab} rows")
    print(f"phase 4q: {time.time() - t0:.1f} s")
    del sparams, cache
    torch.cuda.empty_cache()
    return {"full_p50": full_p50, "losses": losses, "step_p50": p50}


# ---------------------------------------------------------------------------
# 4r: serving over a mesh of ranks
# ---------------------------------------------------------------------------
MESH_REQ, MESH_GEN = 4, 8          # the large models' requests on a mesh


def _serve_probed(batcher, reqs, profile: bool = False):
    """Serve ``reqs``; the first step with no admission left (one decode
    step of the live slots alone) runs between synchronizations with the
    kernel launches and the collectives set to 0 just before and read just
    after, and with ``profile`` the next such step under
    ``torch.profiler``.  Returns ({rid: tokens}, (launches, collectives,
    wall ms, device busy ms or None, the three largest device ops))."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.parallel import comm
    for r in reqs:
        batcher.submit(r)
    done, probe, busy = [], None, None
    top = []
    for _ in range(10_000):
        if batcher.idle:
            break
        decode_only = not batcher.queue and batcher._adm is None \
            and bool(batcher._live_slots())
        if decode_only and probe is None:
            torch.cuda.synchronize()
            engine.reset_launch_counts()
            comm.reset_collective_counts()
            t0 = time.perf_counter()
            done += batcher.step()
            torch.cuda.synchronize()
            probe = (engine.launch_counts(), comm.collective_counts(),
                     (time.perf_counter() - t0) * 1e3)
        elif decode_only and profile and busy is None:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                done += batcher.step()
                torch.cuda.synchronize()
            _, us, by_name = _profile_device(prof)
            busy = us / 1e3
            top = [(n[:40], c, round(t / 1e3, 3)) for n, (c, t) in
                   sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]]
        else:
            done += batcher.step()
    return {r.rid: list(r.output) for r in done}, probe + (busy, top)


def _mesh_logits(cfg, params, prompt, mesh=None):
    """f32 logits of one CHUNK-token prefill chunk and one decode step on
    its cache, on one card or (``mesh``) this rank's tensor-parallel share
    (the caller's params cut by ``param_specs``)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.comm import StepSharding
    from repro_torch.tree import tree_map
    model = build_model(cfg)
    kw = {}
    dev = params["embed"]["w"].device
    if mesh is not None:
        dev = mesh.device
        params = tree_map(lambda t: t.to(dev), shd.shard_tree(
            params, shd.param_specs(params, cfg, mesh), mesh))
        kw["shard"] = StepSharding(mesh, tp=mesh.axis("model"))
    tokens = torch.from_numpy(prompt[:, :CHUNK]).to(dev)
    with torch.no_grad():
        cache = tfm.make_cache(cfg, 1, S_MAX, dev, mesh=mesh)
        chunk, cache = model.prefill_chunk(params, tokens, cache, 0, **kw)
        step, _ = model.decode_step(params, tokens[:, -1:], cache,
                                    torch.tensor([CHUNK], device=dev), **kw)
    torch.cuda.synchronize()
    return chunk.cpu(), step.cpu()


def _mesh_job(job, mesh=None):
    """One phase-4r job on one card or over ``mesh``: a batcher's streams
    and probed decode step (``kind`` "dense" / "paged"), or ``_mesh_logits``
    ("logits")."""
    from repro_torch.models import build_model
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    cfg, params = job["cfg"], job["params"]
    prompt = _requests(cfg, 1, GEN)[0].tokens
    if job["kind"] == "logits":
        return _mesh_logits(cfg, params, prompt, mesh)
    if job["kind"] == "paged":
        cfg = dataclasses.replace(cfg, kv_bits=0)
        sc = _paged_config(mesh=mesh)
        batcher = PagedBatcher(build_model(cfg), params, sc)
    else:
        sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK,
                           mesh=mesh)
        batcher = ContinuousBatcher(build_model(cfg), params, sc)
    return _serve_probed(batcher, _requests(cfg, job["n_req"], job["gen"]),
                         profile=job.get("profile", False))


def _rank_4r(world, small, jobs):
    """One rank of phase 4r: ``small``'s jobs over the two ranks as a 2,1
    mesh, then ``jobs`` over ``world`` (1,2), in order."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    m21 = make_mesh(2, 1, device=world.device)
    out = {"2,1": {name: _mesh_job(job, m21) for name, job in small.items()},
           "1,2": {name: _mesh_job(job, world) for name, job in jobs.items()}}
    torch.cuda.synchronize()
    return out


def _expect(label, got: dict, want: dict) -> None:
    for k, v in want.items():
        check(got.get(k) == v, f"{label}: {k} = {got.get(k)}, expected {v}")


def _split_row_codes(device) -> None:
    """B7c's given-scale form on the halves of K-split rows at the
    all-reduced max: codes and scale ``torch.equal`` to the row form's on
    whole rows (glm4's w_down rows, bf16 and f32)."""
    import torch
    from repro_torch.kernels.act_quant import (act_quant_signed_grouped,
                                               act_quant_signed_rows)
    gen = torch.Generator(device=device).manual_seed(27)
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn((N_SLOTS, 13696), generator=gen, device=device)
             * 3).to(dtype)
        codes, scale = act_quant_signed_rows(x, bits=8)
        halves = x.chunk(2, dim=1)
        amax = torch.maximum(*(h.abs().amax(dim=1, keepdim=True)
                               for h in halves)).clamp_min(1e-8)
        s2 = amax / amax.new_full((), 127)
        split = torch.cat([act_quant_signed_grouped(h.contiguous(), s2,
                                                    bits=8,
                                                    compute_dtype=dtype)
                           for h in halves], dim=1)
        torch.cuda.synchronize()
        check(torch.equal(s2, scale) and torch.equal(split, codes),
              f"B7c given-scale codes of split {dtype} rows differ from the "
              "row form's")
    print("B7c: given-scale codes of K-split rows (bf16, f32) torch.equal "
          "to the row form's on whole rows")


def phase_mesh(device, card) -> None:
    """4r: the batchers over meshes of two ranks sharing the card (gloo):
    pure-DP smollm-135m (2,1 and 1,2), tensor-parallel glm4-9b and
    granite-moe-1b-a400m (1,2), each against its one-rank run."""
    import torch
    from repro_torch.launch.mesh import parse_mesh, spawn
    from repro_torch.parallel.comm import choose_backend
    t0 = time.time()
    print("== 4r. serving over a mesh of ranks: two ranks on "
          f"{torch.cuda.device_count()} card(s), backend "
          f"{choose_backend('cuda', 2)} (NCCL needs a card a rank; its "
          "branch is not run here)", flush=True)
    _split_row_codes(device)
    jobs, one = {}, {}
    # glm4 2xT first: its bf16 draw is the phase's largest transient
    for name, kind, arch, kw in (
            ("glm4 2xT", "dense", "glm4-9b", dict(precision="2xT",
                                                   kv_bits=8)),
            ("glm4 fp32", "logits", "glm4-9b", dict(
                precision="fp32", kv_bits=0, dtype="float32",
                n_layers=WIDE_LAYERS)),
            ("granite fp32", "logits", "granite-moe-1b-a400m", dict(
                precision="fp32", kv_bits=0, dtype="float32",
                moe_impl="shard_map")),
            ("granite 2xT", "dense", "granite-moe-1b-a400m", dict(
                precision="2xT", kv_bits=8, moe_impl="shard_map"))):
        model, params = _family_model(arch, device, tp=2, **kw)
        jobs[name] = {"kind": kind, "cfg": model.cfg, "params": params,
                      "n_req": MESH_REQ, "gen": MESH_GEN,
                      "profile": name == "glm4 2xT"}
    model, params = _family_model("smollm-135m", device, precision="2xT",
                                  kv_bits=8)
    small = {f"smollm {k}": {"kind": k, "cfg": model.cfg, "params": params,
                             "n_req": N_REQ, "gen": GEN}
             for k in ("dense", "paged")}
    jobs.update(small)
    for name, job in jobs.items():
        one[name] = _mesh_job(job)
        if job["kind"] != "logits":
            launches, _, wall, busy, top = one[name][1]
            print(f"[{card}] 4r {name} one rank: one decode step: launches "
                  f"{launches}, wall {wall:.2f} ms"
                  + ("" if busy is None else
                     f"; the next step's device busy {busy:.3f} ms, largest "
                     f"device ops {top}"))
    torch.cuda.synchronize()
    t_one = time.time() - t0
    # one spawn of two ranks (after the parent built every library in
    # phase 2) serves both meshes
    ranks = spawn(_rank_4r, parse_mesh("1,2"), small, jobs, device="cuda")
    torch.cuda.ipc_collect()        # the ranks' handles on the params
    got = {spec: [res[spec] for res in ranks] for spec in ("2,1", "1,2")}

    n30, n40 = 30, 40
    want = {"smollm dense": ({"ternary_matmul": 7 * n30,
                              "act_quant_signed_grouped": 7 * n30,
                              "decode_attention": n30},
                             {"all_reduce_sum": 0, "all_reduce_max": 0,
                              "all_gather": 1}),
            "smollm paged": ({"ternary_matmul": 7 * n30,
                              "act_quant_signed_grouped": 7 * n30,
                              "paged_attention": n30},
                             {"all_reduce_sum": 0, "all_reduce_max": 0,
                              "all_gather": 0}),
            # a max and a sum around wo and w_down a layer, the embedding's
            # sum, the logits' gather (data 1: no next-token gather)
            "glm4 2xT": ({"ternary_matmul": 7 * n40,
                          "act_quant_signed_grouped": 7 * n40,
                          "decode_attention": n40},
                         {"all_reduce_sum": 2 * n40 + 1,
                          "all_reduce_max": 2 * n40, "all_gather": 1}),
            # four attention projections a layer (the experts are plain);
            # a max and a sum around wo, the experts' partial outputs' sum
            "granite 2xT": ({"ternary_matmul": 4 * 24,
                             "act_quant_signed_grouped": 4 * 24,
                             "decode_attention": 24},
                            {"all_reduce_sum": 2 * 24 + 1,
                             "all_reduce_max": 24, "all_gather": 1})}
    for spec, ranks in got.items():
        for r, res in enumerate(ranks):
            for name, (streams, probe) in (
                    (n, v) for n, v in res.items()
                    if jobs[n]["kind"] != "logits"):
                same = streams == one[name][0]
                n_same = sum(streams[k] == v for k, v in one[name][0].items())
                launches, colls, wall, busy, top = probe
                print(f"[{card}] 4r {name} mesh {spec} rank {r}: streams "
                      f"equal to the one-rank run's: {same} ({n_same} of "
                      f"{len(streams)} requests); one decode step: launches "
                      f"{launches}, collectives {colls}, wall {wall:.2f} ms "
                      f"(one rank: {one[name][1][2]:.2f} ms)"
                      + ("" if busy is None else
                         f"; the next step profiled: device busy "
                         f"{busy:.3f} ms (one rank: {one[name][1][3]:.3f} "
                         f"ms), largest device ops {top}"))
                # granite's streams are reported: its top-8 experts' partial
                # outputs sum in another order over the ranks
                check(same or name == "granite 2xT",
                      f"4r {name} on {spec}: streams differ from the "
                      "one-rank run's")
                _expect(f"4r {name} {spec} rank {r} launches", launches,
                        want[name][0])
                _expect(f"4r {name} {spec} rank {r} collectives", colls,
                        want[name][1])
    for name in ("glm4 fp32", "granite fp32"):
        scale = max(float(t.abs().max()) for t in one[name])
        for r, res in enumerate(got["1,2"]):
            gap = max(float((a - b).abs().max())
                      for a, b in zip(one[name], res[name]))
            print(f"[{card}] 4r {name} (f32 cache) mesh 1,2 rank {r}: "
                  f"prefill chunk and decode step logits max |dlogit| "
                  f"{gap:.3e} (bound {1e-4 * scale:.3e} = 1e-4 of "
                  f"max|logit| {scale:.3e})")
            check(gap <= 1e-4 * scale, f"4r {name}: logits gap {gap}")
    del jobs, small, params
    torch.cuda.empty_cache()
    print(f"phase 4r: {time.time() - t0:.1f} s (one-rank runs "
          f"{t_one:.1f} s)")


# ---------------------------------------------------------------------------
# 4s: training over a mesh of ranks
# ---------------------------------------------------------------------------
MESH_TRAIN_STEPS = 3                    # smollm 2,1 steps, against one rank
MESH_FULL_STEPS = 3                     # timed 30-layer 2,1 steps
TP_B, TP_S, TP_STEPS = 2, 128, 2        # glm4-9b 1,2
# glm4's optimizer: adafactor's factored state (O(n + m) a matrix, its
# means over the cut dims all-reduced); adamw's f32 moments, old and new
# in an update, took a rank to ~39 GB, and two such ranks beside the
# earlier phases' live tensors ran the card out of memory
TP_OPTIMIZER = "adafactor"
PIPE_LAYERS, PIPE_MICRO, PIPE_TOL = 4, 4, 1e-5


def _ulps(a, b):
    """Each entry's distance between two tensors of one dtype (bf16 or f32),
    in ulps of that dtype (their bit patterns as ordered integers)."""
    import torch
    bits, mask = {torch.bfloat16: (torch.int16, 0x7FFF),
                  torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mask), i)
    return (ordered(a) - ordered(b)).abs()


def _replicas_equal(axis, tensors) -> bool:
    """Every rank of ``axis`` holds the same ``tensors``, bit for bit (the
    ranks' copies gathered and compared; bf16 travels as its exact f32)."""
    import torch
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    got = axis.all_gather(flat[None], dim=0)
    return all(torch.equal(got[0], got[i]) for i in range(1, axis.size))


def _timed_steps(step, params, state, batches, mesh=None):
    """Run ``step`` over ``batches`` (the state carried along): per step the
    loss, grad norm, wall ms (ending in the loss read back), collectives
    forward and backward and, with ``mesh``, whether the replicas are
    equal after it.  Returns (params, state, records)."""
    import torch
    from repro_torch.parallel import comm
    from repro_torch.tree import tree_leaves
    recs = []
    for batch in batches:
        torch.cuda.synchronize()
        comm.reset_collective_counts()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
        rec = {"loss": loss, "grad_norm": float(m["grad_norm"]), "ms": wall,
               "colls": comm.collective_counts(),
               "backward": comm.backward_counts()}
        if mesh is not None:
            rec["equal"] = _replicas_equal(mesh.axis(mesh.axis_names),
                                           tree_leaves(params))
        recs.append(rec)
    return params, state, recs


def _smollm_dp(mesh, cfg, n_steps):
    """smollm on the pure-DP ``mesh``: the launch.train run's params (seed
    0) and data, ``n_steps`` steps; the final params on the host."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves
    model, opt = build_model(cfg), make_optimizer("adamw", lr=TRAIN_LR)
    params = model.init(torch.Generator().manual_seed(0), mesh.device)
    state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    params, state, recs = _timed_steps(
        step, params, state, _train_batches(cfg, mesh.device, n_steps), mesh)
    return {"recs": recs, "peak": torch.cuda.max_memory_allocated(),
            "params": [t.cpu() for t in tree_leaves(params)]}


def _train_batches(cfg, device, n: int):
    """The data pipeline's first ``n`` batches of TRAIN_B x TRAIN_S tokens
    (the launch.train run's), on ``device``."""
    import torch
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)
    return [{k: torch.from_numpy(v).to(device, torch.int64)
             for k, v in next(data).items()} for _ in range(n)]


def _smollm_full_depth(mesh, cfg):
    """The 30-layer step on ``mesh``, each step from the same initial state
    (as 4q times it): wall ms of a warm-up and MESH_FULL_STEPS steps, the
    collectives of one, the bucket's bytes, peak memory."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves
    model, opt = build_model(cfg), make_optimizer("adamw", lr=TRAIN_LR)
    params = model.init(torch.Generator().manual_seed(0), mesh.device)
    state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh)
    batch = _train_batches(cfg, mesh.device, 1)[0]
    torch.cuda.reset_peak_memory_stats()
    recs = [_timed_steps(step, params, state, [batch])[2][0]
            for _ in range(MESH_FULL_STEPS + 1)]
    n = sum(t.numel() for t in tree_leaves(params))
    return {"recs": recs, "bucket_bytes": 4 * (n + 1),
            "peak": torch.cuda.max_memory_allocated()}


def _glm4_tp(mesh, cfg, ckpt_dir):
    """glm4-9b on the tensor-parallel ``mesh``: the params drawn whole on
    the card from seed 0 (the same on each rank) and cut to this rank's
    slices, TP_STEPS steps (TP_OPTIMIZER) of TP_B x TP_S tokens, the
    params saved (each
    rank its slices) and gathered whole; rank 0 restores the checkpoint on
    its own, compares it with the gathered params and serves both, packed,
    through the kernels."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_map
    model, opt = build_model(cfg), make_optimizer(TP_OPTIMIZER, lr=TRAIN_LR)
    params = model.init(torch.Generator(device=mesh.device).manual_seed(0),
                        mesh.device)
    specs = shd.param_specs(params, cfg, mesh)
    local = tree_map(lambda t: t.clone(), shd.shard_tree(params, specs,
                                                         mesh))
    del params
    torch.cuda.empty_cache()
    state = opt.init(local)
    step = make_train_step(model, opt, mesh=mesh)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TP_S, global_batch=TP_B)
    batches = [{k: torch.from_numpy(v).to(mesh.device, torch.int64)
                for k, v in next(data).items()} for _ in range(TP_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    local, state, recs = _timed_steps(step, local, state, batches)
    peak = torch.cuda.max_memory_allocated()
    del state
    t0 = time.perf_counter()
    Checkpointer(ckpt_dir).save(TP_STEPS, {"params": local},
                                shardings=shd.TreeSharding(
                                    {"params": specs}, mesh))
    save_s = time.perf_counter() - t0
    model_axis = mesh.axis("model")

    def gather(t, spec):
        for d, entry in enumerate(spec):
            if entry == "model":
                return model_axis.all_gather(t, dim=d)
        return t
    whole = tree_map(gather, local, specs)
    out = {"recs": recs, "peak": peak, "save_s": save_s}
    del local
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        out.update(_restore_and_serve(cfg, whole, ckpt_dir))
    mesh.barrier()
    return out


def _restore_and_serve(cfg, whole, ckpt_dir) -> dict:
    """The tensor-parallel checkpoint restored on this one rank (no
    shardings) against ``whole`` (the gathered params), and both packed
    and served (4 x 8 tokens, dense kv8) through the kernels."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import build_model, to_serving
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    back = Checkpointer(ckpt_dir).restore(TP_STEPS, {"params": whole})
    restore_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                zip(tree_leaves(back["params"]), tree_leaves(whole)))
    scfg = dataclasses.replace(cfg, kv_bits=8)
    smodel = build_model(scfg)
    sc = ServingConfig(n_slots=N_SLOTS, s_max=S_MAX, chunk_size=CHUNK)
    served = {}
    for name, p in (("restored", back["params"]), ("gathered", whole)):
        sp = to_serving(p, scfg, tp=1)
        served[name] = _serve_probed(ContinuousBatcher(smodel, sp, sc),
                                     _requests(scfg, MESH_REQ, MESH_GEN))
        del sp
    del back
    torch.cuda.empty_cache()
    return {"restore_s": restore_s, "restored_equal": equal,
            "streams": {k: v[0] for k, v in served.items()},
            "launches": served["restored"][1][0]}


def _pipeline(mesh, cfg):
    """One ``pipeline_blocks`` call over the model axis (2 stages, fp32,
    PIPE_LAYERS periods, PIPE_MICRO microbatches) and the sequential
    period stack on the same blocks and input: the largest gap, the
    sends and receives."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_blocks
    gen = torch.Generator(device=mesh.device).manual_seed(28)
    blocks = build_model(cfg).init(gen, mesh.device)["blocks"]
    x = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=gen,
                    device=mesh.device)
    comm.reset_collective_counts()
    with torch.no_grad():
        y = pipeline_blocks(blocks, x, cfg, mesh, axis="model",
                            n_micro=PIPE_MICRO)
        p2p = comm.p2p_counts()
        pos = torch.arange(TRAIN_S, device=x.device)[None].expand(TRAIN_B,
                                                                 TRAIN_S)
        h = x
        for i in range(cfg.n_periods):
            h, _ = tfm._apply_period(tfm._period(blocks, i), h, cfg, pos)
    torch.cuda.synchronize()
    out = {"gap": float((y - h).abs().max()), "scale": float(h.abs().max()),
           "close": bool(torch.allclose(y, h, rtol=PIPE_TOL, atol=PIPE_TOL)),
           "p2p": p2p}
    out.update(_pipeline_grads(mesh, cfg, blocks, x, gen))
    return out


def _pipeline_grads(mesh, cfg, blocks, x, gen) -> dict:
    """``pipeline_blocks`` under autograd on the same blocks and input, the
    objective sum(y * c): each leaf's gradient (and x's) against one rank's
    sequential autograd, relative to the leaf's largest magnitude; whether
    the two ranks' gradients are the same bits; the backward's sends,
    receives and collectives."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_blocks
    from repro_torch.tree import tree_leaves, tree_map
    c = torch.randn(x.shape, generator=gen, device=x.device)

    def leaves():
        return tree_map(lambda t: t.detach().clone().requires_grad_(),
                        blocks), x.detach().clone().requires_grad_()
    pb, px = leaves()
    comm.reset_collective_counts()
    (pipeline_blocks(pb, px, cfg, mesh, axis="model", n_micro=PIPE_MICRO)
     * c).sum().backward()
    counts = {"p2p": comm.p2p_counts(), "p2p_backward":
              comm.p2p_counts(backward=True),
              "backward": comm.backward_counts()}
    sb, sx = leaves()
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(x.shape[:2])
    h = sx
    for i in range(cfg.n_periods):
        h, _ = tfm._apply_period(tfm._period(sb, i), h, cfg, pos)
    (h * c).sum().backward()
    got = [t.grad for t in tree_leaves(pb)] + [px.grad]
    want = [t.grad for t in tree_leaves(sb)] + [sx.grad]
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(got, want))
    return {"grad_rel": rel, "grad_equal": _replicas_equal(mesh.axis("model"), got), **counts}


# the expert-parallel MoE in a train step: granite-moe-1b-a400m fp32 at
# full width, EP_LAYERS layers, EP_STEPS adamw steps of EP_B x EP_S on 1,2
# against one rank; capacity factor E / k, so no token drops and the
# per-shard routing is the one-rank step's.  The batch is phase 4v's FSDP
# one: at 4 x 128, f32 rounding flipped a near-tied top-8 routing there
EP_LAYERS, EP_STEPS, EP_TOL = 2, 2, 1e-5
EP_B, EP_S = 4, 64


def _granite_ep_cfg():
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-1b-a400m", precision="fp32",
                     dtype="float32")
    return dataclasses.replace(cfg, n_layers=EP_LAYERS, moe_impl="shard_map",
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _granite_ep(cfg, device, mesh=None) -> dict:
    """EP_STEPS train steps of ``cfg`` from seed 0's params (drawn whole on
    the card, cut to this rank's slices over ``mesh``): per step the loss,
    grad norm, wall and collectives; the peak memory."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_map
    model, opt = build_model(cfg), make_optimizer("adamw", lr=TRAIN_LR)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    if mesh is not None:
        params = tree_map(lambda t: t.clone(), shd.shard_tree(
            params, shd.param_specs(params, cfg, mesh), mesh))
    state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=EP_S, global_batch=EP_B)
    batches = [{k: torch.from_numpy(v).to(device, torch.int64)
                for k, v in next(data).items()} for _ in range(EP_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    _, _, recs = _timed_steps(step, params, state, batches)
    return {"recs": recs, "peak": torch.cuda.max_memory_allocated()}


def _rank_4s(world, jobs):
    """One rank of phase 4s: smollm on a 2,1 mesh of the two ranks (2
    layers checked, 30 timed), then glm4-9b and the pipeline on ``world``
    (1,2)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    m21 = make_mesh(2, 1, device=world.device)
    out = {"dp": _smollm_dp(m21, jobs["smollm"], MESH_TRAIN_STEPS)}
    if world.rank:
        out["dp"].pop("params")
    torch.cuda.empty_cache()
    out["full"] = _smollm_full_depth(m21, jobs["smollm30"])
    torch.cuda.empty_cache()
    out["tp"] = _glm4_tp(world, jobs["glm4"], jobs["ckpt"])
    torch.cuda.empty_cache()
    out["pipe"] = _pipeline(world, jobs["pipe"])
    torch.cuda.empty_cache()
    out["ep"] = _granite_ep(jobs["ep"], world.device, world)
    torch.cuda.synchronize()
    return out


def phase_mesh_train(device, card, tmp: str, trained: dict) -> None:
    """4s: training over meshes of two ranks sharing the card (gloo):
    pure-DP smollm-135m 2xT (2,1: 2 layers against the one-rank run on the
    same batches, replicas equal after every step; 30 layers timed),
    tensor-parallel glm4-9b 2xT (1,2: 2 layers, its checkpoint restored on
    one rank and served), the GPipe stack on 2 stages (forward and
    gradients), the expert-parallel MoE of granite-moe in a train step
    (1,2) against one rank."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import parse_mesh, spawn
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves
    t0 = time.time()
    print("== 4s. training over a mesh of ranks: two ranks on "
          f"{torch.cuda.device_count()} card(s) over gloo", flush=True)
    small = dataclasses.replace(model_config(precision="2xT"),
                                n_layers=TRAIN_LAYERS)
    # the one-rank run: launch.train's params and batches (phase 4q's)
    model, opt = build_model(small), make_optimizer("adamw", lr=TRAIN_LR)
    params = model.init(torch.Generator().manual_seed(0), device)
    state = opt.init(params)
    params, _, one = _timed_steps(make_train_step(model, opt), params, state,
                                  _train_batches(small, device,
                                                 MESH_TRAIN_STEPS))
    one_params = [t.cpu() for t in tree_leaves(params)]
    del params, state, _
    same = [r["loss"] for r in one] == trained["losses"][:MESH_TRAIN_STEPS]
    print(f"4s one-rank run (phase 4q's params and batches): losses "
          f"{[r['loss'] for r in one]}, equal to phase 4q's launch.train "
          f"run's first {MESH_TRAIN_STEPS}: {same}")
    glm4 = dataclasses.replace(get_config("glm4-9b", precision="2xT"),
                               n_layers=WIDE_LAYERS)
    ep_one = _granite_ep(_granite_ep_cfg(), device)
    torch.cuda.empty_cache()
    jobs = {"smollm": small, "smollm30": model_config(precision="2xT"),
            "ep": _granite_ep_cfg(),
            "glm4": glm4, "ckpt": str(Path(tmp) / "tp_ckpt"),
            "pipe": dataclasses.replace(model_config(precision="fp32"),
                                        n_layers=PIPE_LAYERS,
                                        dtype="float32")}
    torch.cuda.empty_cache()
    # the ranks' caching allocators share the card: segments that grow in
    # place keep the two from stranding each other's free memory
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn(_rank_4s, parse_mesh("1,2"), jobs, device="cuda")
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc

    # pure DP
    dp = [r["dp"] for r in ranks]
    for i in range(MESH_TRAIN_STEPS):
        r0, o = dp[0]["recs"][i], one[i]
        losses = [d["recs"][i]["loss"] for d in dp]
        print(f"[{card}] 4s smollm 2xT 2,1 step {i}: loss {losses} (one rank "
              f"{o['loss']:.6f}, gap {abs(r0['loss'] - o['loss']) / abs(o['loss']):.3e} "
              f"rel), grad norm {r0['grad_norm']:.6g} (one rank "
              f"{o['grad_norm']:.6g}); replicas torch.equal: "
              f"{[d['recs'][i]['equal'] for d in dp]}; wall per rank "
              f"{[round(d['recs'][i]['ms'], 2) for d in dp]} ms (one rank "
              f"{o['ms']:.2f}); collectives {r0['colls']}, backward "
              f"{r0['backward']}")
        check(all(d["recs"][i]["equal"] for d in dp),
              f"4s smollm 2,1 step {i}: the replicas differ")
        check(len(set(losses)) == 1 and np.isfinite(losses[0]),
              f"4s smollm 2,1 step {i}: losses {losses}")
    ulps = torch.cat([_ulps(a, b).reshape(-1)
                      for a, b in zip(dp[0]["params"], one_params)])
    n_small = ulps.numel()
    absgap = max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(dp[0]["params"], one_params))
    within = {u: float((ulps <= u).sum()) / n_small for u in (0, 1, 4)}
    print(f"[{card}] 4s smollm 2,1 after {MESH_TRAIN_STEPS} steps, params "
          f"against the one-rank run's, in ulps of each leaf's dtype (bf16; "
          f"f32 norm gains): largest "
          f"{int(ulps.max())} ({absgap:.3e} absolute), 99.9th percentile "
          f"{int(torch.quantile(ulps[::97].float(), 0.999))}; the share of "
          f"entries within 0 / 1 / 4 ulps "
          f"{' / '.join(f'{v:.4f}' for v in within.values())}; "
          "gradient bucket "
          f"{4 * (n_small + 1) / 1e6:.1f} MB ({n_small} f32 values + the "
          f"loss); peak per rank {[round(d['peak'] / 1e9, 3) for d in dp]} "
          "GB (max_memory_allocated)")
    full = [r["full"] for r in ranks]
    p50s = [statistics.median(x["ms"] for x in f["recs"][1:]) for f in full]
    print(f"[{card}] 4s smollm-135m 2xT 30 layers on 2,1 ({TRAIN_B // 2} x "
          f"{TRAIN_S} a rank): step wall p50 per rank "
          f"{[round(p, 2) for p in p50s]} ms over {MESH_FULL_STEPS} steps "
          f"(one rank, 4q: {trained['full_p50']:.2f} ms at {TRAIN_B} x "
          f"{TRAIN_S}); collectives a step {full[0]['recs'][1]['colls']}; "
          f"bucket {full[0]['bucket_bytes'] / 1e6:.1f} MB; peak per rank "
          f"{[round(f['peak'] / 1e9, 3) for f in full]} GB")
    check(all(np.isfinite(f["recs"][1]["loss"]) for f in full),
          "4s 30-layer loss")

    # tensor parallel
    tp = [r["tp"] for r in ranks]
    for i in range(TP_STEPS):
        recs = [t["recs"][i] for t in tp]
        print(f"[{card}] 4s glm4-9b 2xT {WIDE_LAYERS} layers 1,2 step {i} "
              f"({TP_B} x {TP_S}, {TP_OPTIMIZER}): loss {[r['loss'] for r in recs]}, grad "
              f"norm {recs[0]['grad_norm']:.6g}; wall per rank "
              f"{[round(r['ms'], 2) for r in recs]} ms; collectives "
              f"{recs[0]['colls']}, of them backward {recs[0]['backward']}")
        check(len({r["loss"] for r in recs}) == 1
              and np.isfinite(recs[0]["loss"]),
              f"4s glm4 step {i}: losses {[r['loss'] for r in recs]}")
    t_ = tp[0]
    print(f"[{card}] 4s glm4 1,2: peak per rank "
          f"{[round(t['peak'] / 1e9, 3) for t in tp]} GB; checkpoint saved "
          f"in {t_['save_s']:.1f} s (each rank its slices), restored on one "
          f"rank in {t_['restore_s']:.1f} s, torch.equal to the gathered "
          f"params: {t_['restored_equal']}; served {MESH_REQ} x {MESH_GEN}, "
          f"tokens equal to the gathered params': "
          f"{t_['streams']['restored'] == t_['streams']['gathered']}; "
          f"launches a decode step {t_['launches']}")
    check(t_["restored_equal"], "4s: the restored checkpoint differs from "
          "the gathered params")
    check(t_["streams"]["restored"] == t_["streams"]["gathered"],
          "4s: the restored checkpoint serves other tokens")
    _check_counts("4s restored glm4 decode step", t_["launches"],
                  {"ternary_matmul": 7 * WIDE_LAYERS,
                   "act_quant_signed_grouped": 7 * WIDE_LAYERS,
                   "decode_attention": WIDE_LAYERS})

    # the pipeline
    for r, res in enumerate(ranks):
        p = res["pipe"]
        print(f"[{card}] 4s pipeline_blocks, 2 stages, {PIPE_LAYERS} fp32 "
              f"periods of smollm, {PIPE_MICRO} microbatches, rank {r}: max "
              f"|y - sequential| {p['gap']:.3e} (max|y| {p['scale']:.3e}, "
              f"bound {PIPE_TOL}); {p['p2p']}")
        check(p["close"], f"4s pipeline rank {r}: gap {p['gap']}")
        stage_bwd = {"send": 0, "recv": PIPE_MICRO} if r == 0 else \
            {"send": PIPE_MICRO, "recv": 0}
        print(f"[{card}] 4s pipeline_blocks gradients, rank {r}: largest "
              f"|grad - sequential autograd's| {p['grad_rel']:.3e} of its "
              f"leaf's max|grad| (bound {PIPE_TOL}); the ranks' gradients "
              f"torch.equal: {p['grad_equal']}; p2p {p['p2p']}, of them "
              f"backward {p['p2p_backward']} (want {stage_bwd}); backward "
              f"collectives {p['backward']}")
        check(p["grad_rel"] <= PIPE_TOL and p["grad_equal"]
              and p["p2p_backward"] == stage_bwd
              and p["backward"]["all_reduce_sum"] == 1,
              f"4s pipeline gradients rank {r}: {p['grad_rel']}, equal "
              f"{p['grad_equal']}, p2p {p['p2p_backward']}, "
              f"{p['backward']}")
    _report_ep(card, ep_one, [r["ep"] for r in ranks])
    print(f"phase 4s: {time.time() - t0:.1f} s")


def _report_ep(card, one, eps) -> None:
    """4s: the expert-parallel granite-moe train steps on 1,2 against one
    rank's: loss and grad norm within EP_TOL relative at every step, no
    gather of the rows."""
    for i in range(EP_STEPS):
        o, recs = one["recs"][i], [e["recs"][i] for e in eps]
        gaps = [max(abs(r["loss"] - o["loss"]) / abs(o["loss"]),
                    abs(r["grad_norm"] - o["grad_norm"]) / abs(o["grad_norm"]))
                for r in recs]
        print(f"[{card}] 4s granite-moe fp32 {EP_LAYERS} layers, "
              f"moe_impl=shard_map on 1,2, step {i} ({EP_B} x {EP_S}, "
              f"nothing dropped): loss {[r['loss'] for r in recs]} (one rank "
              f"{o['loss']:.6f}), grad norm {recs[0]['grad_norm']:.6g} (one "
              f"rank {o['grad_norm']:.6g}), largest relative gap "
              f"{max(gaps):.3e} (bound {EP_TOL}); wall per rank "
              f"{[round(r['ms'], 2) for r in recs]} ms (one rank "
              f"{o['ms']:.2f}); collectives {recs[0]['colls']}, of them "
              f"backward {recs[0]['backward']}; peak per rank "
              f"{[round(e['peak'] / 1e9, 3) for e in eps]} GB")
        check(max(gaps) <= EP_TOL, f"4s granite EP step {i}: gaps {gaps}")
        check(recs[0]["colls"]["all_gather"] == 0, "4s granite EP: rows "
              f"gathered {recs[0]['colls']}")


# ---------------------------------------------------------------------------
# 4t: Mamba and hybrid stacks over a mesh
# ---------------------------------------------------------------------------
MAMBA_FP32_LAYERS = 2                   # falcon-mamba fp32 at full width
# jamba tensor parallel: d_model 1024 (the reduced 128 is pure DP), one
# period of its 8 layers, the other reduced shapes kept but the scan chunk:
# the reduced 16 refuses the 62-token prompts (ROADMAP, reference caveats)
JAMBA_TP = dict(d_model=1024, n_layers=8, ssm_chunk=64)


def _mamba_logits(cfg, params, prompt, mesh=None):
    """f32 logits of one whole-prompt prefill and one decode step from its
    state, on one card or (``mesh``) this rank's tensor-parallel share."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.comm import StepSharding
    from repro_torch.tree import tree_map
    kw = {}
    dev = params["embed"]["w"].device
    if mesh is not None:
        dev = mesh.device
        params = tree_map(lambda t: t.to(dev), shd.shard_tree(
            params, shd.param_specs(params, cfg, mesh), mesh))
        kw["shard"] = StepSharding(mesh, tp=mesh.axis("model"))
    tokens = torch.from_numpy(prompt).to(dev)
    with torch.no_grad():
        pre, cache = tfm.prefill(params, tokens, cfg, tokens.shape[1] + 1,
                                 **kw)
        step, _ = tfm.decode_step(params, tokens[:, -1:], cache,
                                  torch.tensor([tokens.shape[1]], device=dev),
                                  cfg, **kw)
    torch.cuda.synchronize()
    return pre.cpu(), step.cpu()


def _mamba_job(job, mesh=None):
    """One phase-4t job on one card or over ``mesh``: the dense batcher's
    streams, probed decode step, peak memory (GB) and wall (s) over the
    job's requests, whole prompts; or ``_mamba_logits`` ("logits")."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.runtime.serving import ContinuousBatcher, ServingConfig
    cfg, params = job["cfg"], job["params"]
    if job["kind"] == "logits":
        return _mamba_logits(cfg, params, _requests(cfg, 1, 1)[0].tokens,
                             mesh)
    sc = ServingConfig(n_slots=N_SLOTS, s_max=PROMPT + job["gen"], mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batcher = ContinuousBatcher(build_model(cfg), params, sc)
    streams, probe = _serve_probed(batcher, _requests(cfg, job["n_req"],
                                                      job["gen"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(batcher.metrics.prefill_full == job["n_req"]
          and batcher.metrics.prefill_chunks == 0,
          f"4t {cfg.name}: not {job['n_req']} whole-prompt admissions")
    return streams, probe, torch.cuda.max_memory_allocated() / 1e9, wall


def _rank_4t(world, jobs):
    import torch
    out = {name: _mamba_job(job, world) for name, job in jobs.items()}
    torch.cuda.synchronize()
    return out


def _mamba_collectives(cfg) -> dict:
    """Collectives of one decode step on a model axis of 2 (data 1):
    per Mamba layer a gather of the xz rows and a max and a sum around w_x
    and around w_out; per attention layer and dense FFN a max and a sum;
    per MoE layer the partial outputs' sum; the embedding's sum and the
    logits' gather."""
    n_per = cfg.n_periods
    n_mamba = cfg.layer_pattern.count("mamba") * n_per
    n_split = (len(cfg.layer_pattern) * n_per - n_mamba) + \
        cfg.ffn_pattern.count("dense") * n_per
    n_moe = cfg.ffn_pattern.count("moe") * n_per
    return {"all_reduce_sum": 2 * n_mamba + n_split + n_moe + 1,
            "all_reduce_max": 2 * n_mamba + n_split,
            "all_gather": n_mamba + 1, "broadcast": 0}


def phase_mesh_mamba(device, card, falcon) -> None:
    """4t: falcon-mamba-7b (phase 4m's weights and requests, full width and
    depth, 2xT bf16) and jamba (tensor-parallel widths, 2xT kv8) served
    over a 1,2 mesh of two ranks sharing the card (gloo), d_inner cut over
    the model axis; falcon-mamba fp32 at 2 layers of full width, one
    prefill and decode step against one rank's."""
    import torch
    from repro_torch.launch.mesh import parse_mesh, spawn
    t0 = time.time()
    print("== 4t. Mamba and hybrid stacks over a 1,2 mesh of two ranks on "
          f"{torch.cuda.device_count()} card(s), gloo", flush=True)
    fcfg = falcon["model"].cfg
    jobs = {"falcon 2xT": {"kind": "dense", "cfg": fcfg,
                           "params": falcon["params"], "n_req": FALCON_REQ,
                           "gen": FALCON_GEN}}
    model, params = _family_model("falcon-mamba-7b", device, precision="fp32",
                                  dtype="float32", n_layers=MAMBA_FP32_LAYERS)
    jobs["falcon fp32"] = {"kind": "logits", "cfg": model.cfg,
                           "params": params}
    model, params = _family_model("jamba-v0.1-52b", device, reduced=True,
                                  reduced_kw=JAMBA_TP, tp=2, precision="2xT",
                                  kv_bits=8)
    jobs["jamba 2xT"] = {"kind": "dense", "cfg": model.cfg,
                         "params": params, "n_req": FALCON_REQ,
                         "gen": FALCON_GEN}
    one = {name: _mamba_job(job) for name, job in jobs.items()}
    check(one["falcon 2xT"][0] == falcon["streams"],
          "4t falcon-mamba: the one-rank rerun's streams differ from phase "
          "4m's")
    torch.cuda.synchronize()
    t_one = time.time() - t0
    ranks = spawn(_rank_4t, parse_mesh("1,2"), jobs, device="cuda")
    torch.cuda.ipc_collect()        # the ranks' handles on the params
    for name in ("falcon 2xT", "jamba 2xT"):
        cfg = jobs[name]["cfg"]
        want = _mamba_collectives(cfg)
        streams1, probe1, peak1, wall1 = one[name]
        for r, (streams, probe, peak, wall) in enumerate(
                res[name] for res in ranks):
            n_same = sum(streams.get(k) == v for k, v in streams1.items())
            launches, colls, step_ms = probe[:3]
            launches = {k: v for k, v in launches.items() if v}
            print(f"[{card}] 4t {name} mesh 1,2 rank {r}: streams equal to "
                  f"the one-rank run's: {n_same} of {len(streams1)} requests;"
                  f" one decode step: launches {launches} (one rank "
                  f"{ {k: v for k, v in probe1[0].items() if v} }), collectives {colls} (predicted {want}), "
                  f"wall {step_ms:.2f} ms (one rank {probe1[2]:.2f} ms); "
                  f"run wall {wall:.2f} s (one rank {wall1:.2f} s); peak "
                  f"{peak:.2f} GB (one rank {peak1:.2f} GB)")
            check(n_same == len(streams1),
                  f"4t {name} rank {r}: streams differ from one rank's")
            check(colls == want, f"4t {name} rank {r}: collectives {colls}, "
                                 f"predicted {want}")
            for k in ("ternary_matmul", "act_quant_signed_grouped",
                      "decode_attention"):
                check(launches.get(k, 0) == probe1[0].get(k, 0),
                      f"4t {name} rank {r}: {k} launched "
                      f"{launches.get(k, 0)} times, one rank "
                      f"{probe1[0].get(k, 0)}")
    pre1, step1 = one["falcon fp32"]
    scale = max(float(pre1.abs().max()), float(step1.abs().max()))
    for r, res in enumerate(ranks):
        pre, step = res["falcon fp32"]
        gp = float((pre - pre1).abs().max())
        gs = float((step - step1).abs().max())
        print(f"[{card}] 4t falcon fp32 ({MAMBA_FP32_LAYERS} layers, f32) "
              f"mesh 1,2 rank {r}: prefill max |dlogit| {gp:.3e}, decode "
              f"step max |dlogit| {gs:.3e} (bound {1e-4 * scale:.3e} = 1e-4 "
              f"of max|logit| {scale:.3e})")
        check(gs <= 1e-4 * scale, f"4t falcon fp32 decode step gap {gs}")
    del jobs, params, model
    torch.cuda.empty_cache()
    print(f"phase 4t: {time.time() - t0:.1f} s (one-rank runs "
          f"{t_one:.1f} s)")


# ---------------------------------------------------------------------------
# 4u: the invariant auditor on the card
# ---------------------------------------------------------------------------
def phase_audit(device, card) -> None:
    """4u: ``repro_torch.analysis`` on the card: the seven cells on a 1,1
    mesh (zero findings; the card-only rules and the fused decode's bound),
    one seeded violation (the ``torch`` backend forced on CUDA tensors:
    ``cuda_kernel_launched`` alone fires), ``tp-d1024`` on 1,2 as two
    ranks."""
    import torch
    from repro_torch.analysis import rules as R
    from repro_torch.analysis.report import CARD_ONLY_RULES, Report
    from repro_torch.analysis.steps import (CELLS, audit_cell,
                                            build_cell_steps, cell_by_name)
    from repro_torch.launch.mesh import make_mesh
    t0 = time.time()
    print("== 4u. the invariant auditor on the card", flush=True)
    report, cache = Report(), {}
    for cell in CELLS:
        findings, checked = audit_cell(cell, (1, 1), device="cuda",
                                       _cache=cache)
        report.extend(findings, cell=f"{cell.name}@(1, 1)")
        report.checked.extend(checked)
    t_cells = time.time() - t0
    findings, checked = audit_cell(cell_by_name("tp-d1024"), (1, 2),
                                   device="cuda")
    report.extend(findings, cell="tp-d1024@(1, 2)")
    report.checked.extend(checked)
    bound = {}
    for c in report.checked:
        for r in c["rules"]:
            bound[r] = bound.get(r, 0) + 1
    print(f"[{card}] 4u audit: {len(report.checked)} steps (seven cells on "
          f"1,1 in {t_cells:.1f} s, tp-d1024 on 1,2 as 2 ranks), rules "
          f"applied {bound}, not bound "
          f"{sum(len(c['not_bound']) for c in report.checked)}, findings "
          f"{len(report.findings)}")
    for f in report.findings:
        print(f"  {f}")
    check(report.ok, f"4u: {len(report.findings)} audit finding(s)")
    for r in CARD_ONLY_RULES + ("fused_decode_single_dispatch",):
        check(bound.get(r, 0) > 0, f"4u: {r} never bound")
    spec = next(s for s in build_cell_steps(cell_by_name("smollm-2xT"),
                                            make_mesh(1, 1), device="cuda")
                if s.name == "decode")
    seeded, _ = R.audit_step(dataclasses.replace(spec, run_backend="torch"))
    fired = sorted({f.rule for f in seeded})
    print(f"[{card}] 4u seeded violation (backend 'torch' forced on CUDA "
          f"tensors, smollm-2xT decode): fired {fired}, "
          f"{len(seeded)} finding(s); first: {seeded[0] if seeded else None}")
    check(fired == ["cuda_kernel_launched"],
          f"4u: the seeded violation fired {fired}")
    torch.cuda.empty_cache()
    print(f"phase 4u: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 4v: the dry run beside the card, sequence-parallel decode, FSDP
# ---------------------------------------------------------------------------
# (arch, shape, keywords) of the dry-run cells beside the card, on rank 0 of
# 16x16; the two train cells cut to 1 layer at full width (a whole kimi-k2
# train cell traces for minutes)
DRY_CELLS = (("smollm-135m", "decode_32k", {"precision": "2xT",
                                            "kv_bits": 8}),
             ("glm4-9b", "decode_32k", {"precision": "2xT", "kv_bits": 8,
                                        "kv_seq_shard": True}),
             ("jamba-v0.1-52b", "long_500k", {}),
             ("internvl2-76b", "train_4k", {"n_layers": 1}),
             ("kimi-k2-1t-a32b", "train_4k", {"n_layers": 1}))
# glm4-9b 2xT kv8, the decode step of phase 4r on 1,2 (its slots), depth
# cut, against its dry run
DRY_LAYERS, DRY_S = 4, 1024
# smollm B = 1, the cache over 2,1: 16 greedy tokens at 2xT kv8, one step
# at fp32 (its logits against one rank's)
SP_S, SP_NEW = 8192, {"2xT kv8": 16, "fp32": 1}
FSDP_ARCH, FSDP_LAYERS, FSDP_B, FSDP_S, FSDP_STEPS = (
    "granite-moe-1b-a400m", 2, 4, 64, 3)
FSDP_LR = 1e-3


def _dry_vs_real(mesh, cfg):
    """One glm4 decode step on this rank of the 1,2 ``mesh`` (a warm-up
    first): launches by kernel, collective counts and wire bytes, the
    arguments' bytes, the bytes allocated above the arguments at the peak
    (``max_memory_allocated``); and the dry run of the same step on this
    rank of a dry 1,2 mesh."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_decode_fn, step_sharding
    from repro_torch.models import build_model, to_serving
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_leaves
    dev, b = mesh.device, N_SLOTS
    model = build_model(cfg)
    whole = to_serving(model.init(torch.Generator(device=dev).manual_seed(0),
                                  dev), cfg, tp=2)
    params = shd.shard_tree(whole, shd.param_specs(whole, cfg, mesh), mesh)
    del whole
    cache = tfm.make_cache(cfg, b, DRY_S, dev, mesh=mesh)
    cspecs = shd.cache_specs(tfm.make_cache(cfg, b, DRY_S, "meta"), cfg,
                             mesh, b)
    step = make_decode_fn(model, step_sharding(cfg, mesh, b, cspecs))
    token = torch.randint(0, cfg.vocab, (b, 1), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    pos = torch.tensor(DRY_S // 2, device=dev)
    args = (params, token, cache, pos)
    with torch.no_grad():
        step(*args)                                      # warm-up
        torch.cuda.synchronize()
        comm.reset_collective_counts()
        engine.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(*args)
        torch.cuda.synchronize()
    real = {"launches": {k: v for k, v in engine.launch_counts().items()
                         if v},
            "counts": comm.collective_counts(),
            "bytes": comm.collective_bytes(),
            "args": sum(t.numel() * t.element_size()
                        for t in tree_leaves(args)),
            "peak": torch.cuda.max_memory_allocated() - before}
    shapes = to_serving(build_model(cfg).init(torch.Generator(), "meta"),
                        cfg, tp=2)
    rec = dryrun.trace(dryrun.decode_cell(
        cfg, Mesh(mesh.shape, rank=mesh.rank, dry=True), shapes, b, DRY_S))
    dry = {"launches": {k: v["launches"] for k, v in rec["kernels"].items()},
           "counts": rec["collectives"]["counts"],
           "bytes": rec["collectives"]["bytes"],
           "args": rec["memory_analysis"]["argument_size_in_bytes"],
           "peak": rec["peak_live_bytes"]}
    del params, cache, args
    torch.cuda.empty_cache()
    return {"real": real, "dry": dry}


def _sp_stream(cfg, prompt, dev, n_new: int, mesh=None):
    """smollm (seed 0) on ``dev``: a prefill of ``prompt`` into a cache of
    SP_S, then ``n_new`` greedy decode steps, on one card or with the cache
    cut over ``mesh``'s data axis (B = 1: sequence-parallel); the stream,
    the first step's f32 logits and the steps' launches by kernel."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.launch.steps import make_decode_fn, step_sharding
    from repro_torch.models import build_model, to_serving
    from repro_torch.parallel import sharding as shd
    model = build_model(cfg)
    params = to_serving(model.init(torch.Generator(device=dev).manual_seed(0),
                                   dev), cfg, tp=1)
    tokens = torch.from_numpy(prompt).to(dev)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens}, SP_S)
        shard = None
        if mesh is not None:
            cspecs = shd.cache_specs(cache, cfg, mesh, 1)
            cache = shd.shard_tree(cache, cspecs, mesh)
            shard = step_sharding(cfg, mesh, 1, cspecs)
        step = make_decode_fn(model, shard)
        tok = logits[:, -1].argmax(-1)
        stream, first = [int(tok)], None
        engine.reset_launch_counts()
        for i in range(n_new):
            out, cache = step(params, tok[:, None], cache,
                              torch.tensor([prompt.shape[1] + i], device=dev))
            if first is None:
                first = out[:, -1].float().cpu()
            tok = out[:, -1].argmax(-1)
            stream.append(int(tok))
        torch.cuda.synchronize()
    return {"stream": stream, "first": first,
            "launches": {k: v for k, v in engine.launch_counts().items()
                         if v}}


def _fsdp_steps(cfg, dev, mesh=None, fsdp=True):
    """FSDP_STEPS adamw steps of ``cfg`` (seed 0) on FSDP_B x FSDP_S token
    batches, on one card or over ``mesh`` (with ``fsdp``, or plain data
    parallel): per step the loss, grad norm and collectives (forward and
    backward) and whether the replicated leaves are equal on every rank;
    the final params whole on the host (the FSDP leaves gathered)."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_leaves, tree_leaves_along, tree_map
    model, opt = build_model(cfg), make_optimizer("adamw", lr=FSDP_LR)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    specs = None
    if mesh is not None:
        specs = shd.param_specs(params, cfg, mesh, fsdp=fsdp)
        params = shd.shard_tree(params, specs, mesh)
    state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh, fsdp=fsdp and mesh is not None)
    rng = np.random.default_rng(5)
    recs = []
    for _ in range(FSDP_STEPS):
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, (FSDP_B, FSDP_S))).to(dev) for k in ("tokens",
                                                            "labels")}
        comm.reset_collective_counts()
        params, state, m = step(params, state, batch)
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "colls": comm.collective_counts(),
               "backward": comm.backward_counts()}
        if mesh is not None:
            whole = [t for t, s in zip(tree_leaves(params),
                                       tree_leaves_along(params, specs))
                     if not shd.cut_axes(s, mesh)]
            rec["equal"] = _replicas_equal(mesh.axis("data"), whole)
        recs.append(rec)
    if mesh is not None:
        data = mesh.axis("data")
        params = tree_map(lambda t, s: data.all_gather(t, dim=-2)
                          if "data" in shd.cut_axes(s, mesh) else t,
                          params, specs)
    return {"recs": recs, "params": [t.cpu() for t in tree_leaves(params)]}


def _rank_4v(world, jobs):
    """One rank of phase 4v's spawn of two ranks on the card: glm4's 1,2
    decode step against its dry run, then on 2,1 the sequence-parallel
    smollm streams (2xT kv8, fp32) and the steps with and without FSDP."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    m21 = make_mesh(2, 1, device=world.device)
    out = {"dry": _dry_vs_real(world, jobs["glm4"]),
           "sp": {k: _sp_stream(cfg, jobs["prompt"], world.device,
                                SP_NEW[k], m21)
                  for k, cfg in jobs["sp"].items()},
           "fsdp": _fsdp_steps(jobs["fsdp"], world.device, m21),
           "dp": _fsdp_steps(jobs["fsdp"], world.device, m21, fsdp=False)}
    torch.cuda.synchronize()
    return out


def _lse_record(device, card) -> None:
    """B5 with its log-sum-exp at phase 3's shapes (B 4, KV 3, G 3, Dh 64,
    S 80 and 2048): the output ``torch.equal`` with the lse on and off, the
    lse within 1e-5 max(1, |lse|) of the plain version's; both timed."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    gen = torch.Generator().manual_seed(41)
    b, kv, g, dh = N_SLOTS, KV_HEADS, GROUP, DH
    for s, pos_list in DECODE_CASES:
        q = torch.randn((b, kv, g, dh), generator=gen).to(device,
                                                          torch.bfloat16)
        kc, vc = (torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                                dtype=torch.int8).to(device) for _ in "kv")
        ks, vs = ((torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3)
                  .to(device) for _ in "kv")
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        args = (q, kc, ks, vc, vs, pos)
        off = decode_attention(*args)
        on, lse = decode_attention(*args, lse=True)
        _, want = decode_attention_ref(*(a.cpu() for a in args), lse=True)
        torch.cuda.synchronize()
        err = float(((lse.cpu() - want).abs()
                     / want.abs().clamp_min(1.0)).max())
        t_off, _ = time_ms(lambda: decode_attention(*args))
        t_on, _ = time_ms(lambda: decode_attention(*args, lse=True))
        print(f"[{card}] 4v B5 S={s} pos={pos_list}: lse on / off "
              f"{t_on:.5f} / {t_off:.5f} ms; output torch.equal on and off: "
              f"{torch.equal(on, off)}; lse max |diff| / max(1, |lse|) "
              f"{err:.3e} (bound 1e-5)")
        check(torch.equal(on, off), f"4v B5 S={s}: the output changes with "
              "the lse on")
        check(err <= 1e-5, f"4v B5 S={s}: lse off by {err}")


def phase_dryrun(device, card) -> None:
    """4v: the dry run at production scale beside the card, against a real
    step, sequence-parallel decode and FSDP training on two ranks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import parse_mesh, spawn
    from repro_torch.models import build_model
    t0 = time.time()
    print("== 4v. the dry run at production scale, sequence-parallel "
          "decode, FSDP", flush=True)
    _lse_record(device, card)
    mem = torch.cuda.get_device_properties(0).total_memory
    print(f"[{card}] 4v the card's memory (total_memory): {mem} bytes "
          f"(launch.dryrun.H100_MEMORY: {dryrun.H100_MEMORY})")
    with tempfile.TemporaryDirectory() as out:
        for arch, shape, kw in DRY_CELLS:
            rec = dryrun.run_cell(arch, shape, out_dir=out, verbose=False,
                                  **kw)
            check(rec["status"] == "ok", f"4v dry run {arch} {shape}: "
                  f"{rec.get('error')}")
            ma = rec["memory_analysis"]
            print(f"[{card}] 4v dry run {arch} {shape} {kw} on rank 0 of "
                  f"16x16: {ma['total_bytes'] / 1e9:.3f} GB a rank "
                  f"(arguments {ma['argument_size_in_bytes'] / 1e9:.3f}, "
                  f"temp {ma['temp_size_in_bytes'] / 1e9:.3f}), fits "
                  f"{rec['fits']}, {rec['cost_analysis']['flops']:.4e} "
                  f"FLOPs, collectives {rec['collectives']['total_bytes'] / 1e9:.4f} "
                  f"GB {rec['collectives']['counts']}, launches "
                  f"{ {k: v['launches'] for k, v in rec['kernels'].items()} }, "
                  f"trace {rec['trace_s']} s")
    t_dry = time.time() - t0

    glm4 = dataclasses.replace(get_config("glm4-9b", precision="2xT",
                                          kv_bits=8), n_layers=DRY_LAYERS)
    small = {"2xT kv8": model_config(precision="2xT", kv_bits=8),
             "fp32": model_config(precision="fp32", kv_bits=0,
                                  dtype="float32")}
    fsdp = dataclasses.replace(get_config(FSDP_ARCH, precision="fp32"),
                               n_layers=FSDP_LAYERS, dtype="float32")
    prompt = np.random.default_rng(9).integers(0, small["fp32"].vocab,
                                               (1, PROMPT))
    one = {k: _sp_stream(cfg, prompt, device, SP_NEW[k])
           for k, cfg in small.items()}
    one_fsdp = _fsdp_steps(fsdp, device)
    torch.cuda.empty_cache()
    ranks = spawn(_rank_4v, parse_mesh("1,2"), {"glm4": glm4, "sp": small,
                                                "prompt": prompt,
                                                "fsdp": fsdp},
                  device="cuda")

    # the dry run against the real glm4 step
    for r, res in enumerate(ranks):
        real, dry = res["dry"]["real"], res["dry"]["dry"]
        ratio = dry["peak"] / real["peak"]
        print(f"[{card}] 4v glm4-9b 2xT kv8 {DRY_LAYERS} layers, "
              f"{N_SLOTS} x {DRY_S} decode step on 1,2 rank {r}: launches "
              f"real {real['launches']} / dry {dry['launches']}; "
              f"collectives real {real['counts']} {real['bytes']} B / dry "
              f"{dry['counts']} {dry['bytes']} B; argument bytes real "
              f"{real['args']} / dry {dry['args']}; bytes above the "
              f"arguments at the peak: dry {dry['peak']} / real "
              f"{real['peak']} (max_memory_allocated), ratio {ratio:.4f}")
        for key in ("launches", "counts", "bytes", "args"):
            check(real[key] == dry[key], f"4v dry run rank {r}: {key} "
                  f"{dry[key]} != the real step's {real[key]}")

    # sequence-parallel decode
    want_b5 = model_config().n_layers * SP_NEW["2xT kv8"]
    for name in small:
        for r, res in enumerate(ranks):
            got = res["sp"][name]
            gap = float((got["first"] - one[name]["first"]).abs().max())
            scale = float(one[name]["first"].abs().max())
            print(f"[{card}] 4v smollm {name} B=1, cache of {SP_S} cut over "
                  f"2,1, rank {r}: {SP_NEW[name]} tokens equal to one rank's: "
                  f"{got['stream'] == one[name]['stream']}; first step's "
                  f"logits max |diff| {gap:.3e} (max|logit| {scale:.3e}); "
                  f"launches {got['launches']} (one rank "
                  f"{one[name]['launches']})")
            if name == "fp32":
                check(gap <= 1e-4 * scale, f"4v SP fp32 rank {r}: {gap}")
            else:
                check(got["stream"] == one[name]["stream"],
                      f"4v SP 2xT rank {r}: the stream differs")
                check(got["launches"].get("decode_attention") == want_b5,
                      f"4v SP rank {r}: B5 launches {got['launches']}, "
                      f"predicted {want_b5}")

    # FSDP: against the same mesh's plain data-parallel steps (bit-equal:
    # the same sums) and against one rank's (f32 rounding: at 128 tokens a
    # row the step's rounding flipped a near-tied top-8 routing, PERF.md)
    n_moe = FSDP_LAYERS
    for i in range(FSDP_STEPS):
        o = one_fsdp["recs"][i]
        for r, res in enumerate(ranks):
            g, d = res["fsdp"]["recs"][i], res["dp"]["recs"][i]
            rel = abs(g["loss"] - d["loss"]) / abs(d["loss"])
            rel_one = abs(g["loss"] - o["loss"]) / abs(o["loss"])
            print(f"[{card}] 4v {FSDP_ARCH} fp32 {FSDP_LAYERS} layers FSDP "
                  f"on 2,1 step {i} rank {r}: loss {g['loss']:.7f} (data "
                  f"parallel on 2,1 {d['loss']:.7f}, {rel:.2e} rel; one rank "
                  f"{o['loss']:.7f}, {rel_one:.2e} rel), grad norm "
                  f"{g['grad_norm']:.6g} ({d['grad_norm']:.6g}, "
                  f"{o['grad_norm']:.6g}); replicated leaves equal: "
                  f"{g['equal']}; collectives {g['colls']}, backward "
                  f"{g['backward']} (data parallel {d['colls']})")
            check(rel <= 1e-5, f"4v FSDP step {i} rank {r}: loss {rel} from "
                  "the data-parallel step's")
            check(rel_one <= 1e-5, f"4v FSDP step {i} rank {r}: loss "
                  f"{rel_one} from one rank's")
            check(g["equal"], f"4v FSDP step {i} rank {r}: replicas differ")
            check(g["colls"]["all_gather"] == 7 * n_moe,
                  f"4v FSDP gathers {g['colls']}, predicted {7 * n_moe}")
            check(g["backward"]["all_reduce_sum"] == 4 * n_moe,
                  f"4v FSDP reduce-scatters {g['backward']}, predicted "
                  f"{4 * n_moe}")
    for r, res in enumerate(ranks):
        for label, want in (("data parallel", res["dp"]["params"]),
                            ("one rank", one_fsdp["params"])):
            d = np.concatenate([(a.float() - b.float()).abs().reshape(-1)
                                .numpy() for a, b in
                                zip(res["fsdp"]["params"], want)])
            n_out = int((d > 1e-4).sum())
            print(f"[{card}] 4v FSDP rank {r} after {FSDP_STEPS} steps: "
                  f"params max |diff| {d.max():.3e} from the {label} run's, "
                  f"{n_out} of {d.size} entries beyond 1e-4")
            check(n_out <= max(1, d.size // 10000)
                  and d.max() <= 2.2 * FSDP_LR * FSDP_STEPS,
                  f"4v FSDP rank {r}: params {d.max()} from the {label} "
                  f"run's ({n_out} beyond 1e-4)")
    torch.cuda.empty_cache()
    print(f"phase 4v: {time.time() - t0:.1f} s (dry runs {t_dry:.1f} s)")


# ---------------------------------------------------------------------------
# 4k: the tuning cache
# ---------------------------------------------------------------------------
TUNE_PRECISIONS = ("2xT", "4x4", "1x1")
TUNE_CLI_PROMPT, TUNE_CLI_GEN = 96, 32   # s_max 128: bs 16..128 all divide it


def _tile_name(block) -> str:
    return "rows" if tuple(block)[:2] == (8, 1) else "tensor cores"


def _tune_matmuls(device, card) -> int:
    """4k.1: ``tune_serving_shapes`` at each precision; every shape class's
    candidates, pick and default, and the pick through ``engine.qmatmul``
    against the automatic choice and the plain version (``torch.equal``).
    Returns the number of picks that differ from the automatic choice."""
    import torch
    from repro_torch.core.precision import get_precision, signed
    from repro_torch.kernels import engine, tuning
    gen = torch.Generator().manual_seed(5)
    changed = 0
    for prec in TUNE_PRECISIONS:
        mcfg = model_config(precision=prec, kv_bits=8)
        pcfg = signed(get_precision(prec))
        entries = engine.tune_serving_shapes(mcfg, pcfg, n_slots=N_SLOTS,
                                             chunk_size=CHUNK, iters=5)
        kind, bits = pcfg.w_mode, engine.weight_bits(pcfg)
        a_bits = engine._act_bits(pcfg)
        plan = [c for c in engine.serving_tune_plan(
            mcfg, pcfg, n_slots=N_SLOTS, chunk_size=CHUNK)
            if engine._tunable_k(pcfg, c[2])]
        check(len(entries) == len(plan) > 0,
              f"{prec}: {len(entries)} tuned classes of {len(plan)}")
        for m, n, k in plan:
            e = tuning.lookup(m, n, k, kind=kind, a_bits=a_bits, w_bits=bits,
                              backend="cuda")
            check(e is not None, f"{prec} ({m}, {n}, {k}): no cache entry")
            pick, auto = tuple(e["block"]), tuning.fallback_block(m, n, k,
                                                                  kind, bits)
            changed += pick != auto
            pw = engine.pack_weight(torch.randn((k, n), generator=gen)
                                    .to(device), pcfg)
            x = torch.randn((m, k), generator=gen).to(device, torch.bfloat16)
            outs = [engine.qmatmul(x, pw, pcfg, block=b) for b in (pick, auto)]
            plain = engine.qmatmul(x, pw, pcfg, backend="torch")
            torch.cuda.synchronize()
            print(f"[{card}] tune {prec} {kind} (M={m}, N={n}, K={k}): "
                  + ", ".join(f"{_tile_name(c['block'])} {c['us']:.2f} us"
                              for c in e["swept"])
                  + f" -> {_tile_name(pick)} {e['us']:.2f} us (default "
                  f"{_tile_name(auto)} {e['default_us']:.2f} us)")
            check(torch.equal(outs[0], outs[1]),
                  f"{prec} ({m}, {n}, {k}): the pick {pick} differs from "
                  f"the automatic {auto}")
            check(torch.equal(outs[0], plain),
                  f"{prec} ({m}, {n}, {k}): the pick differs from the plain "
                  "version")
    return changed


def _tune_decode_attention(device, card) -> bool:
    """4k.2: B5's plan swept at the dense serving shape and at 2048
    positions; the tuned plan (through the engine's lookup) within B5's
    per-call bound of its plain version.  Returns whether the serving
    shape's pick differs from the automatic plan."""
    import torch
    from repro_torch.kernels import engine
    decode_attention = importlib.import_module(
        "repro_torch.kernels.decode_attention")
    gen = torch.Generator().manual_seed(6)
    b, kv, g, dh = N_SLOTS, KV_HEADS, GROUP, DH
    changed = False
    for s, pos_list in DECODE_CASES:
        e = engine.autotune_decode_attention(b=b, s=s, kv=kv, g=g, dh=dh,
                                             iters=5)
        q = torch.randn((b, kv, g, dh), generator=gen).to(device,
                                                         torch.bfloat16)
        kc, vc = (torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                                dtype=torch.int8).to(device) for _ in "kv")
        ks, vs = ((torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3)
                  .to(device) for _ in "kv")
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        auto = decode_attention.launch_plan(q, kc, vc)
        auto = (auto["cluster"], dh, auto["span"])
        with engine.dispatch_trace() as ev:
            out = engine.decode_attention(q, kc, ks, vc, vs, pos, kv_bits=8)
        ref = decode_attention.decode_attention_ref(q, kc, ks, vc, vs, pos)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 + 1e-4 * ref.abs().max().item()
        pick = tuple(e["block"])
        print(f"[{card}] tune decode_attention B={b} S={s}: " + ", ".join(
            f"({c['block'][0]}, {c['block'][2]}) {c['us']:.2f} us"
            for c in e["swept"]) + f" -> plan (cluster, span) ({pick[0]}, "
            f"{pick[2]}) {e['us']:.2f} us (automatic ({auto[0]}, {auto[2]}) "
            f"{e['default_us']:.2f} us); max |diff| vs plain {err:.3e} "
            f"(tolerance {tol:.3e})")
        check(ev[0].block == pick, f"S={s}: the engine ran {ev[0].block}, "
                                   f"not the tuned {pick}")
        check(err <= tol, f"decode_attention tuned plan S={s}: max |diff| "
                          f"{err} > {tol}")
        if s == S_MAX:
            changed = pick != auto
    return changed


def _tune_cli(card) -> None:
    """4k.3: ``--paged --kv-block-size 0 --autotune`` through the serving
    CLI at full width (2xT kv8, s_max 128)."""
    from repro_torch.launch import serve as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = cli.main(["--paged", "--kv-bits", "8", "--kv-block-size", "0",
                         "--autotune", "--requests", str(N_SLOTS), "--slots",
                         str(N_SLOTS), "--prompt-len", str(TUNE_CLI_PROMPT),
                         "--gen", str(TUNE_CLI_GEN)])
    out = buf.getvalue().splitlines()
    keep = [ln for ln in out if "block size sweep" in ln or "->" in ln
            or "autotune" in ln or ln.startswith("paged KV cache")
            or "itl" in ln]
    for ln in keep:
        print(f"[{card}] cli: {ln.strip()}")
    check(any("(tuned pick)" in ln for ln in out),
          "the CLI printed no tuned block-size pick")
    check(len(done) == N_SLOTS and all(
        len(r.output) == TUNE_CLI_GEN and all(
            0 <= t < model_config().vocab for t in r.output) for r in done),
        "the CLI's tuned paged run returned short or out-of-range tokens")


def _decode_wall_p50(model, params, sc, reqs) -> tuple[dict, float]:
    """Serve ``reqs`` with the step profiler on; returns the streams and
    the decode step's wall p50 (ms: dispatch to device sync)."""
    from repro_torch.runtime.serving import ContinuousBatcher
    from repro_torch.runtime.tracing import TraceConfig
    b = ContinuousBatcher(model, params, dataclasses.replace(
        sc, trace=TraceConfig(enabled=False, profile=True)))
    streams = _streams(b, reqs)
    return streams, b.profiler.summary()["decode"]["device_ms"]["p50"]


def phase_tuning(device, card, dense, tmp: str):
    """4k: the tuning cache at full width: matmul sweeps, B5's plan, the
    CLI's tuned pool block size, then the dense 2xT batcher on the warm
    cache (no sweep, no miss) beside a cold one; ``dense`` is phase 4's
    (model, params, sc, streams); ``tmp`` a directory for cache files."""
    from repro_torch.core.precision import get_precision, signed
    from repro_torch.kernels import engine, tuning
    print("== 4k. tuning cache: sweeps, tuned serving, --kv-block-size 0",
          flush=True)
    t0 = time.time()
    tuning.reset()
    os.environ["REPRO_TUNING_CACHE"] = warm = str(Path(tmp) / "tuned.json")
    n_mm = _tune_matmuls(device, card)
    b5 = _tune_decode_attention(device, card)
    _tune_cli(card)

    model, params, sc, streams = dense
    cfg = model.cfg
    # re-read the file: each class of the run resolves (and counts) afresh
    tuning.reset(clear_stats=False)
    n_classes = 1 + len(engine.serving_tune_plan(
        cfg, signed(get_precision("2xT")), n_slots=N_SLOTS, chunk_size=CHUNK))
    before = tuning.stats()
    got, warm_ms = _decode_wall_p50(model, params, sc,
                                    _requests(cfg, N_REQ, GEN))
    d = {k: tuning.stats()[k] - before[k] for k in before}
    agree = sum(got[r] == streams[r] for r in streams)
    print(f"[{card}] 2xT dense on the warm cache: tuning-cache hits {d['hits']}"
          f" ({n_classes} shape classes: {n_classes - 1} matmul, B5), misses "
          f"{d['misses']}, sweeps {d['sweeps']}; {n_mm} matmul "
          f"picks differ from the automatic choice, B5's plan "
          f"{'differs' if b5 else 'does not differ'}; streams equal to "
          f"phase 4's: {agree}/{len(streams)}")
    check(d["sweeps"] == 0, "the warm-cache run swept")
    check(d["misses"] == 0 and d["hits"] == n_classes,
          f"the warm-cache run: {d['hits']} hits and {d['misses']} misses "
          f"over {n_classes} tunable shape classes")
    if not b5:
        check(agree == len(streams), "tuned matmul picks changed a stream")
    else:
        # a tuned B5 plan sums in another f32 order; 2-bit codes amplify
        # that past layer 0 (fault C2): hold one decode step at phase 4's
        # bound instead
        cmp = _compare_backends(model, params, sc, _requests(cfg, 1, 2)[0]
                                .tokens, device)
        tol0 = 1e-5 + 1e-4 * cmp["attn0_scale"]
        print(f"2xT decode step on the warm cache, kernels vs plain versions:"
              f" layer 0 attention max |diff| {cmp['attn0']:.3e} (tolerance "
              f"{tol0:.3e}); prefill_chunk max |dlogit| {cmp['chunk']:.3e}")
        check(cmp["q0_equal"] and cmp["attn0"] <= tol0 and cmp["chunk"] == 0,
              "tuned B5 plan: the decode step leaves phase 4's bound")

    os.environ["REPRO_TUNING_CACHE"] = str(Path(tmp) / "cold.json")
    _, cold_ms = _decode_wall_p50(model, params, sc,
                                  _requests(cfg, N_REQ, GEN))
    os.environ["REPRO_TUNING_CACHE"] = warm
    n = 20000
    t1 = time.perf_counter()
    for _ in range(n):
        tuning.get_block_sizes(N_SLOTS, 576, 576, kind="ternary", a_bits=2,
                               w_bits=2, backend="cuda")
    lookup_us = (time.perf_counter() - t1) / n * 1e6
    print(f"[{card}] 2xT dense decode step wall p50 (StepProfiler, {N_REQ} x "
          f"{GEN} tokens, one run each): warm cache {warm_ms:.3f} ms, cold "
          f"cache {cold_ms:.3f} ms; one memoised lookup {lookup_us:.3f} us "
          f"(host, x210 a step: {lookup_us * 210 / 1e3:.4f} ms)")
    print(f"phase 4k: {time.time() - t0:.1f} s")
    check(engine._DISPATCH_LISTENER is None, "a tracer left its listener")


# device kernels of B5, B2 and B4 whose share of a profiled step is printed
DECODE_KERNELS = ("decode_attn_kernel", "paged_attn_kernel",
                  "fused_decode_kernel")


def phase_profile(card, label, batcher, steps: int = 5):
    """Decode steps of a batcher with all slots live under
    ``torch.profiler``: the device operations (kernels, copies, fills) per
    step, the device's busy time (the union of their intervals) and its
    idle share of the step's wall time.  The same steps are timed without
    the profiler first."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serving import Request, RequestOptions
    print(f"== 5. decode steps under torch.profiler ({label}, all slots live)",
          flush=True)
    rng = np.random.default_rng(2)
    for rid in range(N_SLOTS):                # one-chunk prompts, long runs
        batcher.submit(Request(rid, rng.integers(
            0, batcher.model.cfg.vocab, (1, CHUNK - rid % 3)).astype(np.int64),
            options=RequestOptions(max_new=batcher.s_max - CHUNK)))
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
    launches = [e for e in prof.events() if e.device_type == DeviceType.CPU
                and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                               "cuLaunchKernel", "cudaMemcpyAsync",
                               "cudaMemsetAsync")]
    dev, busy, by_name = _profile_device(prof)
    busy_ms = busy / 1e3 / steps
    print(f"[{card}] {label} decode step (B={N_SLOTS}, "
          f"{batcher.model.cfg.n_layers} layers): wall "
          f"{plain_ms:.2f} ms unprofiled, {prof_ms:.2f} ms profiled; device "
          f"operations {len(dev) / steps:.0f} per step (host launch calls "
          f"{len(launches) / steps:.0f}); device busy {busy_ms:.3f} ms per "
          f"step, idle share {1 - busy_ms / prof_ms:.4f} of the profiled "
          f"step, {max(0.0, 1 - busy_ms / plain_ms):.4f} of the unprofiled")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, t) in top:
        print(f"  {t / 1e3 / steps:8.3f} ms/step  {n / steps:5.0f}/step  "
              f"{name[:90]}")
    for kernel in DECODE_KERNELS:
        n = sum(c for name, (c, _) in by_name.items() if kernel in name)
        t = sum(u for name, (_, u) in by_name.items() if kernel in name)
        if n:
            print(f"  {kernel}: {t / 1e3 / steps:.4f} ms/step over "
                  f"{n / steps:.0f} launches/step "
                  f"({t / 1e3 / steps / busy_ms:.4f} of busy time)")


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

    def kernel(q, k, ks, v, vs, pos, *, kv_bits, dtype, block=None):
        plan = None if block is None else (block[0], block[2])
        out = decode_attention(q.contiguous(), k, ks, v, vs, pos, plan=plan)
        calls.append((q.clone(), out))
        return out.to(dtype)

    def plain(q, k, ks, v, vs, pos, *, kv_bits, dtype, block=None):
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


def _layers_equal(a, b, dtype) -> int:
    """How many leading layers' attention outputs are equal in ``dtype``."""
    import torch
    n = 0
    for (_, x), (_, y) in zip(a, b):
        if not torch.equal(x.to(dtype), y.to(dtype)):
            break
        n += 1
    return n


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
    launches, runs, quant = {}, {}, {}

    def n_quant(events):
        return sum(e.op == "act_quant_signed_grouped" for e in events)
    for run, backend, f32 in (("cuda", "cuda", True), ("plain", "torch", True),
                              ("serving", "torch", False)):
        engine.reset_launch_counts()
        cache = tfm.make_cache(cfg, 1, sc.s_max, device)
        with engine.dispatch_trace() as ev:
            lc, cache = model.prefill_chunk(params, tokens, cache, 0,
                                            backend=backend)
        torch.cuda.synchronize()
        quant[f"chunk_{run}"] = n_quant(ev)
        launches[f"chunk_{run}"] = engine.launch_counts()
        slots = tfm.make_cache(cfg, N_SLOTS, sc.s_max, device)
        for i in range(N_SLOTS):
            write_slot(slots, cache, i)
        tok = lc[:, -1:].argmax(-1).expand(N_SLOTS, 1).contiguous()
        engine.reset_launch_counts()
        with _attention_probe(plain_f32=f32) as attn, \
                engine.dispatch_trace() as ev:
            ld, _ = model.decode_step(params, tok, slots, pos, backend=backend)
        torch.cuda.synchronize()
        quant[f"decode_{run}"] = n_quant(ev)
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
    (cc, cd, ca), (pc, pd, pa), (_, sd, sa) = (runs["cuda"], runs["plain"],
                                               runs["serving"])
    check(not any(quant[f"{c}_{run}"] for run in ("plain", "serving")
                  for c in ("chunk", "decode")),
          "backend='torch' traced a quantizer launch")
    return {
        "launches": {"chunk": launches["chunk_cuda"],
                     "decode": launches["decode_cuda"]},
        "quant_dispatches": {"chunk": quant["chunk_cuda"],
                             "decode": quant["decode_cuda"]},
        "chunk": (cc - pc).abs().max().item(),
        "q0_equal": torch.equal(ca[0][0], pa[0][0]),
        "attn0": (ca[0][1] - pa[0][1]).abs().max().item(),
        "attn0_scale": pa[0][1].abs().max().item(),
        "layers_equal": _layers_equal(ca, pa, dtype), "n_layers": cfg.n_layers,
        "decode": (cd - pd).abs().max().item(),
        "scale": pd.abs().max().item(),
        "agree": int((cd.argmax(-1) == pd.argmax(-1)).sum()),
        "dequant": (sd - pd).abs().max().item(),
        "dequant_agree": int((sd.argmax(-1) == pd.argmax(-1)).sum()),
        "dequant_layers_equal": _layers_equal(sa, pa, dtype),
    }


@contextlib.contextmanager
def _paged_probe():
    """Record each layer's paged attention in a quantized-``wo`` decode
    step on both sides: the kernel inside the engine's ``cuda`` fused entry
    (which composes it with ``qmatmul``), and, in the ``torch`` slot of the
    fused kind, the kernel's f32 plain version composed the same way.
    Restores both on exit.  Yields the list of (q rows, f32 output)."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.kernels.paged_attention import paged_attention_ref
    key = (engine.ATTN_FUSED, 8)
    saved_plain = engine.resolve_attention_entry(*key, engine.BACKEND_TORCH)[0]
    saved_kernel = engine._paged_attention_kernel
    calls = []

    def kernel(q, *args, **kw):
        out = saved_kernel(q, *args, **kw)
        calls.append((q.clone(), out))
        return out

    def plain(q, k, ks, v, vs, extras, *, kv_bits, dtype):
        page_table, pos, slot_map, wo_p, pcfg, reduce = extras
        ql, ptl, posl = engine._live_rows(q, page_table, pos, slot_map)
        out = paged_attention_ref(ql, k, ks, v, vs, ptl, posl,
                                  kv_bits=kv_bits, out_dtype=torch.float32)
        calls.append((ql.clone(), out))
        return engine._project_wo(out.to(dtype).reshape(ql.shape[0], 1, -1),
                                  wo_p, pcfg, dtype, engine.BACKEND_TORCH,
                                  reduce)

    engine._paged_attention_kernel = kernel
    engine.register_attention(*key, engine.BACKEND_TORCH)(plain)
    try:
        yield calls
    finally:
        engine._paged_attention_kernel = saved_kernel
        engine.register_attention(*key, engine.BACKEND_TORCH)(saved_plain)


@contextlib.contextmanager
def _plain_attention(on: bool = True):
    """With ``on``, route B8 and B5 (``engine.flash_attention``,
    ``engine.decode_attention``) to their plain versions whatever backend
    the model passes, so the other kernels run alone on the card.
    Restores both on exit."""
    from repro_torch.kernels import engine
    saved = engine.flash_attention, engine.decode_attention
    if on:
        engine.decode_attention = lambda *a, backend=None, **kw: saved[1](
            *a, backend="torch", **kw)
        engine.flash_attention = lambda *a, backend=None, **kw: saved[0](
            *a, backend="torch", **kw)
    try:
        yield
    finally:
        engine.flash_attention, engine.decode_attention = saved


@contextlib.contextmanager
def _decode_kv_codes(kv_from=None):
    """Record the decoded token's K/V codes and scales in each layer
    (``layers._kv_quantize`` on a one-position input); with ``kv_from``,
    hand back that run's codes and scales, in call order, instead of
    quantizing.  Restores the quantizer on exit."""
    from repro_torch.models import layers as L
    quantize, codes = L._kv_quantize, []

    def kv_quantize(k, v, bits):
        out = quantize(k, v, bits)
        if k.shape[1] == 1:
            if kv_from is not None:
                out = kv_from[len(codes)]
            codes.append(out)
        return out

    L._kv_quantize = kv_quantize
    try:
        yield codes
    finally:
        L._kv_quantize = quantize


def _compare_paged(model, params, prompt, device, probe: bool,
                   kv_bits: int = 8, swap: bool = False):
    """One ``prefill_chunk_paged`` of the prompt's first chunk into blocks
    1-2, then one ``decode_step_paged`` over N_SLOTS slots, each holding its
    own copy of those blocks and decoding at a ragged position, through the
    kernels (backend "cuda") and the plain versions (backend "torch").  With
    ``probe`` (a quantized ``wo``) the plain side's paged attention is the
    kernel's f32 plain version and each layer's attention is recorded on
    both sides.  With ``swap`` a third run, the plain versions given the
    kernel run's decoded-token K/V codes (fault C2's swap), adds ``swap``
    (its logits' distance from the kernel run's) and ``code_steps`` (the
    K/V codes that differ between the kernel and the plain runs).  Returns
    launches per call and the differences."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    nb, n_chunk = S_MAX // BLOCK, CHUNK // BLOCK
    tokens = torch.as_tensor(prompt[:, :CHUNK], device=device)
    chunk_row = torch.zeros((1, nb), dtype=torch.int32)
    chunk_row[0, :n_chunk] = torch.arange(1, 1 + n_chunk)
    pos_list = [CHUNK, CHUNK - 3, CHUNK - 7, 5]
    pt = torch.zeros((N_SLOTS, nb), dtype=torch.int32)
    src, dst = [], []
    for i, p in enumerate(pos_list):
        base = 1 + n_chunk + i * nb
        pt[i, :p // BLOCK + 1] = torch.arange(base, base + p // BLOCK + 1)
        src += list(range(1, 1 + n_chunk))
        dst += list(range(base, base + n_chunk))
    chunk_row, pt = chunk_row.to(device), pt.to(device)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
    launches, runs, codes = {}, {}, {}
    order = (("cuda", "cuda"), ("plain", "torch")) + \
        ((("swap", "torch"),) if swap else ())
    for run, backend in order:
        pool = tfm.make_pool(cfg, 1 + n_chunk + N_SLOTS * nb, BLOCK, kv_bits,
                             device)
        engine.reset_launch_counts()
        lc, pool = model.prefill_chunk_paged(params, tokens, pool, chunk_row,
                                             0, kv_bits, backend=backend)
        torch.cuda.synchronize()
        launches[f"chunk_{run}"] = engine.launch_counts()
        for leaves in pool.values():                # every slot's own copy
            for t in leaves.values():
                t[:, dst] = t[:, src]
        tok = lc[:, -1:].argmax(-1).expand(N_SLOTS, 1).contiguous()
        engine.reset_launch_counts()
        with (_paged_probe() if probe else contextlib.nullcontext([])) as attn, \
                _decode_kv_codes(codes["cuda"] if run == "swap" else None) \
                as codes[run]:
            ld, _ = model.decode_step_paged(params, tok, pool, pt, pos, kv_bits,
                                            backend=backend)
        torch.cuda.synchronize()
        launches[f"decode_{run}"] = engine.launch_counts()
        check(not probe or len(attn) == cfg.n_layers,
              f"{len(attn)} paged attention calls for {cfg.n_layers} layers")
        check(bool(torch.isfinite(lc).all() and torch.isfinite(ld).all()),
              f"non-finite paged logits ({cfg.precision}, {run})")
        runs[run] = (lc, ld, attn)
    check(not any(n for c in ("chunk", "decode") for run, b in order
                  if b == "torch" for n in launches[f"{c}_{run}"].values()),
          "backend='torch' launched a kernel")
    (cc, cd, ca), (pc, pd, pa) = runs["cuda"], runs["plain"]
    out = {"launches": {"chunk": launches["chunk_cuda"],
                        "decode": launches["decode_cuda"]},
           "chunk": (cc - pc).abs().max().item(),
           "decode": (cd - pd).abs().max().item(),
           "scale": pd.abs().max().item(),
           "agree": int((cd.argmax(-1) == pd.argmax(-1)).sum())}
    if swap:
        out.update(swap=(cd - runs["swap"][1]).abs().max().item(),
                   code_steps=sum(int((a[i] != b[i]).sum())
                                  for a, b in zip(codes["cuda"],
                                                  codes["plain"])
                                  for i in (0, 2)))
    if probe:
        out.update(q0_equal=torch.equal(ca[0][0], pa[0][0]),
                   attn0=(ca[0][1] - pa[0][1]).abs().max().item(),
                   attn0_scale=pa[0][1].abs().max().item(),
                   layers_equal=_layers_equal(ca, pa, getattr(torch,
                                                              cfg.dtype)),
                   n_layers=cfg.n_layers)
    return out


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found: run chip_smoke.py from the root of "
             "a repository checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    with tempfile.TemporaryDirectory() as tmp:
        # every phase before 4k runs on a cold tuning cache (the automatic
        # kernel choices): a user's cache never changes what they check
        os.environ["REPRO_TUNING_CACHE"] = str(Path(tmp) / "cold.json")
        _main(torch, tmp)


def _main(torch, tmp: str) -> None:
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.serving import ContinuousBatcher
    t_start = time.time()
    device = torch.device("cuda", 0)
    card = phase_env()
    phase_build()
    records = [r for r in phase_kernels(device) if r is not None]
    launches, served = phase_serve(device, card)
    paged_launches, paged_model, paged_streams = phase_paged(device, card,
                                                             served)
    fused_launches, fused_served = phase_fused(device, card)
    xnor_launches, xnor_served = phase_serve_1x1(device, card)
    phase_cnn(device, card)
    whole_launches = phase_whole_prompt(device, card, served)
    phase_forward(device, card)
    core_launches = phase_core_quant(device, card)
    phase_sampling(device, card, served, (paged_model, paged_streams))
    phase_speculative(device, card)
    _, falcon = phase_families(device, card)
    phase_mesh_mamba(device, card, falcon)
    del falcon
    torch.cuda.empty_cache()
    phase_encdec(device, card)
    trained = phase_train(device, card, tmp)
    phase_mesh(device, card)
    phase_mesh_train(device, card, tmp, trained)
    launches.update(paged_attention=paged_launches["paged_attention"],
                    fused_decode=fused_launches["fused_decode"],
                    binary_matmul=xnor_launches["binary_matmul"],
                    flash_attention=whole_launches["flash_attention"],
                    act_quant=core_launches["act_quant"],
                    act_quant_signed=core_launches["act_quant_signed"])
    model, params, sc, _ = served
    phase_profile(card, "2xT dense", ContinuousBatcher(model, params, sc))
    phase_profile(card, "2xT paged kv8",
                  PagedBatcher(paged_model, params, _paged_config()))
    phase_profile(card, "1x1 dense", ContinuousBatcher(*xnor_served))
    phase_profile(card, "fp32 paged kv8",
                  PagedBatcher(*fused_served, _paged_config()))
    phase_tuning(device, card, served, tmp)
    phase_audit(device, card)
    phase_dryrun(device, card)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    replaces = {
        "ternary_matmul": ("src/repro_torch/csrc/qmatmul.cu",
                           "src/repro/kernels/ternary_matmul.py:74"),
        "packed_matmul": ("src/repro_torch/csrc/qmatmul.cu",
                          "src/repro/kernels/packed_matmul.py:78"),
        "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                          "src/repro/kernels/binary_matmul.py:51"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:68"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:99"),
        "fused_decode": ("src/repro_torch/csrc/decode_fused.cu",
                         "src/repro/kernels/decode_fused.py:117"),
        "act_quant": ("src/repro_torch/csrc/act_quant.cu",
                      "src/repro/kernels/act_quant.py:60"),
        "act_quant_signed": ("src/repro_torch/csrc/act_quant.cu",
                             "src/repro/kernels/act_quant.py:77"),
        "act_quant_signed_grouped": ("src/repro_torch/csrc/act_quant.cu",
                                     "src/repro/kernels/act_quant.py:98"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
    }
    kernels = [{"name": r["name"], "route": "cuda",
                "source": replaces[r["name"]][0],
                "replaces": replaces[r["name"]][1], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": r["shape"]} for r in records]
    print(f"all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

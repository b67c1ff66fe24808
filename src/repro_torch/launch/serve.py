"""Serving launcher — quantized weights + chunked-prefill continuous batching
on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --precision 2xT --kv-bits 8 --requests 8 --slots 4 --gen 16

Flow: seeded params -> ``to_serving(tp=1)`` packs the weights to k-bit words
-> the continuous batcher admits prompts in prefill chunks while the
batched decode (greedy, or sampled) serves every active slot -> TTFT / ITL /
tok/s and the per-kernel launch counts are printed.

``--paged`` serves through the paged KV cache instead (block pool, radix
prefix sharing, lazy allocation and preemption; ``runtime.kvcache``):

    PYTHONPATH=src python -m repro_torch.launch.serve --paged --kv-bits 8 \
        --requests 8 --slots 4 --gen 16

Sampling and observability, as the reference's launcher spells them:
``--temperature``/``--top-k`` sample every request (seeded by ``--seed``,
the request id and the token index; streams on the card differ from those
on the CPU, see ``runtime.serving``), ``--stream`` prints tokens as they
come, ``--trace OUT.json`` exports the flight recorder's Perfetto timeline
(``--trace-buffer`` events in its ring), ``--profile`` prints each step
kind's device time and host gap, and ``--metrics-interval N`` streams a
metrics snapshot every N scheduler steps next to ``--metrics-json``:

    PYTHONPATH=src python -m repro_torch.launch.serve --temperature 0.8 \
        --top-k 50 --trace /tmp/serve.json --profile

``--autotune`` sweeps the kernel choice of every matmul shape class the
batcher dispatches before serving (``kernels.tuning``: the cache file is
``~/.cache/repro_torch/tuning.json`` or ``REPRO_TUNING_CACHE``; a rerun
finds the entries and sweeps nothing).  With ``--paged``, ``--kv-block-size
0`` takes the pool's block size from that cache (16 on a cold cache);
with ``--autotune`` it sweeps the paged and the fused decode kernels over
block sizes 16-128 first:

    PYTHONPATH=src python -m repro_torch.launch.serve --paged --kv-bits 8 \
        --kv-block-size 0 --autotune --prompt-len 96 --gen 32

``--speculative`` serves through the paged batcher with self-speculative
decoding (the ``--draft-precision`` variant drafts ``--draft-k`` tokens a
slot, the float weights verify them in one windowed step), and
``--brownout`` through the adaptive server (SLO-routed lanes down a kv
16/8/4 ladder, then the draft weights; ``--slo`` tags the requests); both
need a float ``--precision``:

    PYTHONPATH=src python -m repro_torch.launch.serve --precision fp32 \
        --brownout --speculative --slo mixed --requests 12 --slots 4

``--arch`` takes every LM architecture of the reference.  The stacks with
Mamba layers (falcon-mamba-7b, jamba-v0.1-52b) admit whole prompts and
refuse ``--paged`` and a chunk size:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --requests 4 --gen 8

The enc-dec backbone (whisper-base) and the embeds frontend (internvl2-76b)
are served as the reference serves them, by a plain batched prefill and
greedy decode loop (their inputs are the stub frontends' embeddings, not
token streams the batchers can chunk; ``--paged`` and the sampling,
tracing and adaptive flags do not apply):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --precision 2xT --kv-bits 8 --requests 4 --prompt-len 64 --gen 16

``--mesh DP,MP`` serves SPMD over a (data, model) mesh of DP*MP ranks, one
process each (``launch.mesh.spawn``; rank r on ``cuda:(r % device_count)``,
or the CPU with ``--device cpu``), as the reference's ``--mesh`` does:
models with d_model < 1024 are pure data-parallel (params replicated, the
decode batch split over both axes), larger ones tensor-parallel over
'model' (packed with ``to_serving(tp=MP)``).  The params are drawn and
packed once, before the ranks start, and the kernels are built there too.
The ranks talk over NCCL when each has a card of its own, else over gloo
(ranks sharing a card, or the CPU); the launcher prints which.  Rank 0
alone prints the metrics, the launch counts and the collective counts:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --mesh 2,1 --requests 4 --slots 4 --gen 8

The Mamba and hybrid stacks take a model axis too (d_inner cut over it;
one gather of the xz rows a Mamba layer, see ``models.layers.mamba_apply``)
and still admit whole prompts:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --mesh 1,2 --requests 4 --gen 8

Runs on the card (``--device cuda``, the default) and refuses to start when
no card is visible; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import A_FLOAT, W_FLOAT, get_precision, signed
from repro_torch.kernels import _build, engine, tuning
from repro_torch.launch.mesh import parse_mesh, spawn
from repro_torch.models import (ShapeConfig, build_model, make_batch,
                                 reduce_for_smoke, to_serving)
from repro_torch.models.convert import serving_param_bytes
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import pure_dp, serving_shard_factors
from repro_torch.runtime.adaptive import AdaptiveServer
from repro_torch.runtime.kvcache import PagedBatcher, paged_block_bytes
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         RequestOptions, ServingConfig,
                                         supports_chunked_prefill)
from repro_torch.runtime.tracing import TraceConfig


def resolve_device(name: str) -> torch.device:
    """The requested device; CUDA must be present when it is asked for."""
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible (pass --device cpu to "
            "run the plain PyTorch versions on the host)")
    return torch.device(name)


def _trace_config(args):
    """``--trace/--profile/--metrics-interval`` -> a TraceConfig (or None).

    The flight recorder is also armed when only profiling or snapshot
    streaming is requested — both ride on the tracer — but the Perfetto
    file is written only when --trace names one.
    """
    if not (args.trace or args.profile or args.metrics_interval):
        return None
    snapshot_path = None
    if args.metrics_interval:
        if not args.metrics_json:
            raise SystemExit("--metrics-interval needs --metrics-json "
                             "(snapshot stream path is derived from it)")
        base = args.metrics_json
        base = base[:-5] if base.endswith(".json") else base
        snapshot_path = base + ".snapshots.jsonl"
    return TraceConfig(
        enabled=True, buffer=args.trace_buffer, path=args.trace,
        snapshot_path=snapshot_path,
        snapshot_interval=args.metrics_interval,
        profile=args.profile)


def _report_trace(batcher, args):
    """Post-run flight-recorder export: Perfetto file, snapshot stream
    tail, per-phase device/host profile summary.  The run is over, so the
    tracer's engine listener comes off first (a later run in the same
    process dispatches without it)."""
    tracer = batcher.tracer
    tracer.detach_engine()
    if not tracer.enabled:
        return
    if args.trace:
        doc = tracer.to_perfetto(args.trace)
        print(f"trace -> {args.trace} ({len(doc['traceEvents'])} events, "
              f"{tracer.dropped} dropped)")
    if tracer.snapshotter is not None:
        tracer.snapshotter.final(batcher.metrics)
        print(f"metrics snapshots -> {tracer.snapshotter.path} "
              f"({tracer.snapshotter.lines_written} lines)")
    # the adaptive server's lanes each carry their own profiler
    lanes = getattr(batcher, "lanes", None)
    for b in lanes or [batcher]:
        if b.profiler is None:
            continue
        where = f" {b.trace_track}" if lanes else ""
        for label, s in sorted(b.profiler.summary().items()):
            print(f"profile[{label}]{where}: {s['steps']} steps, device "
                  f"{s['device_ms']['p50']:.2f} ms p50, host gap "
                  f"{s['host_ms']['p50']:.2f} ms p50 "
                  f"(host_frac {s['host_frac']:.1%})")


def stream_cb(req, tok, finished):
    """``--stream``: print each token as it is emitted."""
    mark = "<eos>" if finished else ""
    print(f"  [rid {req.rid}] tok {tok}{mark}", flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _legacy_loop(model, params, cfg, args, device) -> np.ndarray:
    """Batched prefill + greedy decode for the embeds / enc-dec archs, as
    the reference's launcher serves them: one ``make_batch`` of
    ``--requests`` x ``--prompt-len`` (generator seed 1; the stub frontend's
    frames or patches), one prefill, ``--gen - 1`` decode steps (zero
    embeddings as the embeds model's step input).  Returns the (requests,
    gen) tokens."""
    if args.autotune:
        sweeps0 = tuning.stats()["sweeps"]
        entries = engine.tune_model_shapes(
            cfg, signed(get_precision(args.precision)),
            m_rows=(args.requests, args.requests * args.prompt_len),
            device=device)
        print(f"autotune: {len(entries)} shape classes -> "
              f"{tuning.cache_path()} (sweeps this run: "
              f"{tuning.stats()['sweeps'] - sweeps0})")
    s_max = args.prompt_len + args.gen
    shape = ShapeConfig("serve", args.prompt_len, args.requests, "prefill")
    batch = make_batch(cfg, shape, torch.Generator(device=device).manual_seed(1))

    engine.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, s_max)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_launches = engine.launch_counts()

    tok = logits[:, -1:].argmax(-1)
    generated = [tok]
    engine.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        if cfg.frontend == "embeds":
            step_in = torch.zeros((args.requests, 1, cfg.d_model),
                                  dtype=torch.float32, device=device)
        else:
            step_in = tok
        logits, cache = model.decode_step(params, step_in, cache,
                                          args.prompt_len + i)
        tok = logits[:, -1:].argmax(-1)
        generated.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    toks = torch.cat(generated, dim=1).cpu().numpy()
    steps = max(args.gen - 1, 1)
    tps = args.requests * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"prefill: {args.requests} reqs x {args.prompt_len} tok in "
          f"{t_prefill * 1e3:.0f} ms; decode: {tps:.1f} tok/s "
          f"({t_decode / steps * 1e3:.1f} ms/step)")
    print(f"sample generations (first 8 tokens/request):\n{toks[:, :8]}")
    decode_launches = engine.launch_counts()
    print("kernel launches per prefill: " + ", ".join(
        f"{k}={v}" for k, v in prefill_launches.items()))
    print(f"kernel launches per decode step ({args.gen - 1} steps): "
          + ", ".join(f"{k}={v / steps:g}"
                      for k, v in decode_launches.items()))
    return toks


def serve(args):
    device = resolve_device(args.device)
    # one process per rank: a mesh asks for no more ranks than host cores
    mesh = parse_mesh(args.mesh, max_ranks=os.cpu_count())
    # the adaptive server's lanes and the speculative batcher are paged
    args.paged = args.paged or args.brownout or args.speculative
    if args.brownout or args.speculative:
        p = signed(get_precision(args.precision))
        if p.w_mode != W_FLOAT or p.a_mode != A_FLOAT:
            raise SystemExit(
                f"--precision {args.precision}: --brownout/--speculative "
                "need a float primary — the low-bit lanes and the draft "
                "variant are packed down from the float weights at startup "
                "(try --precision fp32)")
    if args.paged and args.kv_bits == 0:
        args.kv_bits = 16                  # dense spelling of "unquantized"
    if not args.paged and args.kv_bits not in (0, 4, 8):
        raise SystemExit(
            f"--kv-bits {args.kv_bits}: the dense cache stores int8/int4 "
            "codes (or model dtype with 0); 16 is a --paged storage width")
    # paged serving owns KV quantization in the block pool; the in-model
    # dense-cache quantizer stays off
    cfg = get_config(args.arch, precision=args.precision,
                     kv_bits=0 if args.paged else args.kv_bits)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    legacy = cfg.kind != "lm" or cfg.frontend == "embeds"
    if mesh is not None and legacy:
        print("--mesh: legacy (embeds/enc-dec) loop is single-device; "
              "ignoring the mesh")
        mesh = None
    if mesh is not None:
        _check_mesh(args, cfg, mesh)
    model = build_model(cfg)
    # drawn on the serving device: falcon-mamba-7b's ~7e9 draws take
    # minutes on a host generator
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    base_bytes = serving_param_bytes(params)
    # pack under per-shard K alignment only when TP will shard the params:
    # pure-DP models replicate (tp=1 keeps the laxer global alignment)
    pack_tp = 1 if mesh is None or pure_dp(cfg, mesh) \
        else mesh.shape["model"]
    params = to_serving(params, cfg, tp=pack_tp)
    packed_bytes = serving_param_bytes(params)
    print(f"weights: {base_bytes/1e6:.1f} MB {cfg.dtype}-form -> "
          f"{packed_bytes/1e6:.1f} MB {args.precision} serving form "
          f"({base_bytes/packed_bytes:.2f}x smaller)")
    if legacy:
        return _legacy_loop(model, params, cfg, args, device)

    sc = ServingConfig(n_slots=args.slots or args.requests,
                       s_max=args.prompt_len + args.gen,
                       chunk_size=args.chunk_size, autotune=args.autotune,
                       kv_bits=args.kv_bits, block_size=args.kv_block_size,
                       pool_bytes=args.pool_bytes or None,
                       prefix_cache=args.prefix_cache, reserve=args.reserve,
                       preemption=args.preemption, brownout=args.brownout,
                       speculative=args.speculative,
                       draft_precision=args.draft_precision,
                       draft_k=args.draft_k, trace=_trace_config(args))
    sweeps0 = tuning.stats()["sweeps"]
    if args.paged and not sc.block_size:
        attn_shape = dict(
            b=sc.n_slots, kv=cfg.n_kv_heads,
            g=max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1), dh=cfg.dh,
            s_max=sc.s_max, kv_bits=args.kv_bits, device=device)
        if args.autotune:
            # the pool block is the sequence tile of both decode dispatch
            # shapes (two-dispatch paged attention, fused attention + wo):
            # sweep both, the lookup below reads the paged one
            for e in (engine.autotune_kv_block_size(**attn_shape),
                      engine.autotune_fused_block_size(d=cfg.d_model,
                                                       **attn_shape)):
                print("  block size sweep: " + ", ".join(
                    f"{s['block'][2]}: {s['us']:.2f} us" for s in e["swept"])
                    + f" -> {e['block'][2]}")
        sc = dataclasses.replace(
            sc, block_size=engine.preferred_kv_block_size(**attn_shape))
        print(f"--kv-block-size 0 -> {sc.block_size} "
              f"({'tuned' if args.autotune else 'tuning-cache'} pick)")
    if mesh is None:
        return _serve_batcher(args, cfg, params, sc, device, sweeps0)
    if device.type == "cuda":
        _build.build_all()          # once, before the ranks load them
    backend = comm.choose_backend(device.type, mesh.size)
    where = (f"{torch.cuda.device_count()} card(s)" if device.type == "cuda"
             else "the CPU")
    print(f"mesh: {mesh.size} ranks (data={mesh.shape['data']} "
          f"model={mesh.shape['model']}) over {backend} on {where}")
    return spawn(_serve_rank, mesh, args, cfg, params, sc, sweeps0,
                 device=device.type)[0]


def _check_mesh(args, cfg, mesh) -> None:
    """Refuse what the mesh path does not serve, before drawing weights."""
    if args.brownout:
        raise SystemExit("--brownout with --mesh: the adaptive server is "
                         "served on one device")
    if args.speculative:
        raise SystemExit("--speculative with --mesh: speculative decoding "
                         "is single-host for now (the windowed verify step "
                         "has no sharded dispatch)")


def _serve_rank(mesh, args, cfg, params, sc, sweeps0):
    """One rank of ``--mesh``: the batcher over ``mesh`` (on the rank's
    device); rank 0 reports (the others run silent, and record no
    trace)."""
    sc = dataclasses.replace(sc, mesh=mesh,
                             trace=sc.trace if mesh.rank == 0 else None)
    return _serve_batcher(args, cfg, params, sc, mesh.device, sweeps0,
                          verbose=mesh.rank == 0)


def _serve_batcher(args, cfg, params, sc, device, sweeps0,
                   verbose: bool = True):
    """Build the batcher of the flags, serve the launcher's requests and
    report; returns the finished requests."""
    say = print if verbose else (lambda *a, **k: None)
    model = build_model(cfg)
    if args.brownout:
        batcher = AdaptiveServer(model, params, sc)
        say(f"adaptive serving: {len(batcher.lanes)} precision lanes "
            f"(rung 0 {'speculative, ' if sc.speculative else ''}"
            "kv ladder 16/8/4"
            + (f", rung 3 = {sc.draft_precision} weights"
               if len(batcher.lanes) > 3 else "")
            + f"); SLO classes: {sorted(batcher.classes)}")
    elif args.paged:
        batcher = PagedBatcher(model, params, sc)
        say(f"paged KV cache: {batcher.num_blocks - 1} blocks x "
            f"{batcher.block_size} positions at kv_bits={args.kv_bits} "
            f"({paged_block_bytes(cfg, batcher.block_size, args.kv_bits)} "
            f"B/block), prefix cache "
            f"{'on' if args.prefix_cache else 'off'}, "
            f"reserve={args.reserve}, preemption={args.preemption}")
        if sc.speculative:
            say(f"self-speculative decoding: {sc.draft_precision} "
                f"draft, k={sc.draft_k}, fp-verified (lossless)")
    else:
        batcher = ContinuousBatcher(model, params, sc)
    mesh = sc.mesh
    if mesh is not None:
        dp, tp = serving_shard_factors(cfg, mesh, batcher.n_slots)
        say(f"SPMD serving on mesh data={mesh.shape['data']} "
            f"model={mesh.shape['model']}: decode batch sharded {dp}-way, "
            f"tensor-parallel {tp}-way "
            f"({'pure-DP (params replicated)' if tp == 1 else 'TP'})"
            + ("; the paged pool does not split over data: every rank runs "
               "the whole paged step" if args.paged else ""))
    lanes = getattr(batcher, "lanes", [batcher])
    if args.autotune:
        say(f"autotune: {sum(len(b.tuned) for b in lanes)} shape classes "
            f"-> {tuning.cache_path()} (sweeps this run: "
            f"{tuning.stats()['sweeps'] - sweeps0})")
    if lanes[0].chunk_size:
        say(f"chunked prefill: chunk={lanes[0].chunk_size}")
    else:
        why = ("--chunk-size 0" if supports_chunked_prefill(cfg) else
               "chunked prefill unsupported: recurrent state")
        say(f"whole-prompt admission ({why}): each prompt is prefilled in "
            "one call"
            + (", its full-sequence attention through "
               + ("the flash_attention kernel" if device.type == "cuda"
                  else "the reference's plain attention")
               if cfg.has_attention else ""))

    rng = np.random.default_rng(1)
    slo_cycle = (["premium", "standard", "batch"] if args.slo == "mixed"
                 else [args.slo])
    for rid in range(args.requests):
        plen = max(1, args.prompt_len - (rid % 3))   # ragged prompts
        batcher.submit(Request(
            rid, rng.integers(0, cfg.vocab, (1, plen)).astype(np.int64),
            options=RequestOptions(
                max_new=args.gen, temperature=args.temperature,
                top_k=args.top_k, seed=args.seed,
                slo=slo_cycle[rid % len(slo_cycle)],
                on_token=stream_cb if args.stream and verbose else None)))
    engine.reset_launch_counts()
    comm.reset_collective_counts()
    done = batcher.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    if not verbose:
        return done

    print(batcher.metrics.format())
    toks = np.array([r.output[:8] for r in sorted(done, key=lambda r: r.rid)])
    print(f"sample generations (first 8 tokens/request):\n{toks}")
    print("kernel launches: " + ", ".join(
        f"{k}={v}" for k, v in engine.launch_counts().items()))
    if mesh is not None:
        print("collectives (rank 0): " + ", ".join(
            f"{k}={v}" for k, v in comm.collective_counts().items()))
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(batcher.metrics.summary(), f, indent=1)
        print(f"metrics -> {args.metrics_json}")
    _report_trace(batcher, args)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--precision", default="2xT")
    ap.add_argument("--kv-bits", type=int, default=8, choices=(0, 4, 8, 16),
                    help="KV-cache storage width.  Dense batcher: 0 = model "
                         "dtype, 8/4 = quantized in-cache.  --paged: 16 (or "
                         "0) = raw blocks, 8/4 = quantized blocks")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV cache (block pool + "
                         "radix prefix sharing, runtime.kvcache)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="positions per paged KV block (0 -> the tuned pick "
                         "from the tuning cache; 16 on a cold cache)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix prefix sharing across requests (--paged)")
    ap.add_argument("--reserve", choices=["prompt", "budget"],
                    default="prompt",
                    help="--paged admission policy: 'prompt' reserves only "
                         "the prompt's blocks (decode allocates on demand), "
                         "'budget' reserves the whole generation budget up "
                         "front (never preempts)")
    ap.add_argument("--preemption", choices=["recompute", "off"],
                    default="recompute",
                    help="--paged pool-exhaustion policy: 'recompute' "
                         "preempts the latest-admitted request and replays "
                         "it via chunked prefill; 'off' stalls starved "
                         "slots until blocks free up")
    ap.add_argument("--pool-bytes", type=int, default=0,
                    help="--paged pool byte budget (0 -> size the pool to "
                         "n_slots+1 full sequences)")
    ap.add_argument("--slo", default="standard",
                    choices=["premium", "standard", "batch", "mixed"],
                    help="SLO class tagged on the requests ('mixed' cycles "
                         "premium/standard/batch).  With --brownout the "
                         "class sets the request's latency targets and how "
                         "deep down the precision ladder it may go; the "
                         "plain batchers ignore it")
    ap.add_argument("--brownout", action="store_true",
                    help="serve through the AdaptiveServer: SLO-routed "
                         "lanes (kv 16/8/4 rungs, then the "
                         "--draft-precision weights) that degrade new "
                         "admissions under pressure instead of queueing "
                         "them; active slots keep their streams.  Needs a "
                         "float --precision")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding: the --draft-precision "
                         "variant drafts --draft-k tokens a slot, the float "
                         "weights verify them in one windowed decode step.  "
                         "Implies the paged cache; needs a float "
                         "--precision")
    ap.add_argument("--draft-precision", default="2xT",
                    help="precision of the low-bit weight variant "
                         "(speculative drafts and brownout rung 3)")
    ap.add_argument("--draft-k", type=int, default=3,
                    help="draft tokens per speculative round")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots (0 -> one per request)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="prefill chunk (None -> auto; 0 -> whole-prompt)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with noise seeded by "
                         "(--seed, request id, token index)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed, and the sampling seed of every "
                         "request")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--metrics-json", default=None,
                    help="dump the serving metrics summary to this file")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the serving flight recorder and export a "
                         "Perfetto/chrome://tracing timeline to this file "
                         "(scheduler steps, admissions, prefill chunks, "
                         "decode dispatches, per-request flow arrows)")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="flight-recorder ring capacity in events "
                         "(drop-oldest beyond this; drops are counted)")
    ap.add_argument("--profile", action="store_true",
                    help="bracket each step call with a device sync and "
                         "measure device time vs host gap per step (adds "
                         "sync overhead; implies the flight recorder)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="stream a Metrics.summary() snapshot (+numeric "
                         "delta) every N scheduler steps to "
                         "<metrics-json stem>.snapshots.jsonl "
                         "(needs --metrics-json)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the architecture at reduce_for_smoke shapes "
                         "(a few layers, narrow widths, float32)")
    ap.add_argument("--autotune", action="store_true",
                    help="pre-tune the kernel choice of the scheduler's "
                         "matmul shape classes (persists to the tuning "
                         "cache; serving then never re-tunes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DP,MP",
                    help="serve SPMD over a (data, model) mesh of DP*MP "
                         "ranks, one process each, e.g. '2,1' (token-LM "
                         "batcher path only)")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()

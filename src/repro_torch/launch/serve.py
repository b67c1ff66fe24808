"""Serving launcher — quantized weights + chunked-prefill continuous batching
on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --precision 2xT --kv-bits 8 --requests 8 --slots 4 --gen 16

Flow: seeded params -> ``to_serving(tp=1)`` packs the weights to k-bit words
-> the continuous batcher admits prompts in prefill chunks while the
batched greedy decode serves every active slot -> TTFT / ITL / tok/s and
the per-kernel launch counts are printed.

Runs on the card (``--device cuda``, the default) and refuses to start when
no card is visible; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import engine
from repro_torch.models import build_model, reduce_for_smoke, to_serving
from repro_torch.models.convert import serving_param_bytes
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         RequestOptions, ServingConfig)


def resolve_device(name: str) -> torch.device:
    """The requested device; CUDA must be present when it is asked for."""
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible (pass --device cpu to "
            "run the plain PyTorch versions on the host)")
    return torch.device(name)


def serve(args) -> list:
    device = resolve_device(args.device)
    cfg = get_config(args.arch, precision=args.precision, kv_bits=args.kv_bits)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    params = model.init(gen, device)
    base_bytes = serving_param_bytes(params)
    params = to_serving(params, cfg, tp=1)
    packed_bytes = serving_param_bytes(params)
    print(f"weights: {base_bytes/1e6:.1f} MB {cfg.dtype}-form -> "
          f"{packed_bytes/1e6:.1f} MB {args.precision} serving form "
          f"({base_bytes/packed_bytes:.2f}x smaller)")

    sc = ServingConfig(n_slots=args.slots or args.requests,
                       s_max=args.prompt_len + args.gen,
                       chunk_size=args.chunk_size)
    batcher = ContinuousBatcher(model, params, sc)
    if batcher.chunk_size:
        print(f"chunked prefill: chunk={batcher.chunk_size}")
    else:
        print("whole-prompt admission")

    rng = np.random.default_rng(1)
    for rid in range(args.requests):
        plen = max(1, args.prompt_len - (rid % 3))   # ragged prompts
        batcher.submit(Request(
            rid, rng.integers(0, cfg.vocab, (1, plen)).astype(np.int64),
            options=RequestOptions(max_new=args.gen)))
    engine.reset_launch_counts()
    done = batcher.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")

    print(batcher.metrics.format())
    toks = np.array([r.output[:8] for r in sorted(done, key=lambda r: r.rid)])
    print(f"sample generations (first 8 tokens/request):\n{toks}")
    print("kernel launches: " + ", ".join(
        f"{k}={v}" for k, v in engine.launch_counts().items()))
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(batcher.metrics.summary(), f, indent=1)
        print(f"metrics -> {args.metrics_json}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--precision", default="2xT")
    ap.add_argument("--kv-bits", type=int, default=8, choices=(0, 4, 8),
                    help="KV-cache storage: 0 = model dtype, 8/4 = int codes")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots (0 -> one per request)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="prefill chunk (None -> auto; 0 -> whole-prompt)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default=None,
                    help="dump the serving metrics summary to this file")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()

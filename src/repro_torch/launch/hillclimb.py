"""The perf hillclimb battery — ``repro.launch.hillclimb`` for the port:
re-traces the three chosen cells under each candidate change with the dry
run (``launch.dryrun``) and records the roofline terms per variant.

Cells (the reference's choice):
  A kimi-k2-1t-a32b/train_4k    — worst absolute memory+collective terms
  B granite-moe-1b-a400m/decode_32k — most collective-bound
  C glm4-9b/decode_32k          — most representative of the paper's lever
                                   (weights/KV are the decode bytes)

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb

Records go to results/hillclimb_torch/ (one per variant, as the dry run
writes them, skipping those already there), and the brownout policy's
search to results/hillclimb_torch/brownout_policy.json.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.launch.dryrun import run_cell

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "results", "hillclimb_torch")

BATTERY = [
    # --- A: kimi train ---
    ("kimi-k2-1t-a32b", "train_4k", {}),                       # slot-map dispatch
    ("kimi-k2-1t-a32b", "train_4k", {"capacity_factor": 1.0}),
    ("kimi-k2-1t-a32b", "train_4k", {"capacity_factor": 1.0,
                                     "grad_compress_bits": 8}),
    # --- B: granite decode ---
    ("granite-moe-1b-a400m", "decode_32k", {}),                # slot-map dispatch
    ("granite-moe-1b-a400m", "decode_32k", {"force_pure_dp": True}),
    ("granite-moe-1b-a400m", "decode_32k", {"force_pure_dp": True,
                                            "precision": "2xT", "kv_bits": 8}),
    # --- C: glm4 decode ---
    ("glm4-9b", "decode_32k", {"kv_seq_shard": True}),
    ("glm4-9b", "decode_32k", {"kv_seq_shard": True, "kv_bits": 8}),
    ("glm4-9b", "decode_32k", {"kv_seq_shard": True, "kv_bits": 8,
                               "precision": "2xT"}),
    ("glm4-9b", "decode_32k", {"kv_seq_shard": True, "kv_bits": 8,
                               "precision": "2xT", "quantize_lm_head": True}),
]


def seed_brownout_policy(out_dir=OUT, iters: int = 64):
    """Hillclimb the adaptive server's brownout thresholds on the bursty
    synthetic trace (the perf battery's coordinate descent, on the host
    simulator instead of re-tracing).  The winning
    :class:`repro_torch.runtime.policy.BrownoutPolicy` is dumped to
    ``brownout_policy.json``: ``AdaptiveServer`` callers load it as the
    ``ServingConfig.brownout_policy`` seed."""
    from repro_torch.runtime.policy import bursty_trace, search_policy
    policy, out = search_policy(bursty_trace(), iters=iters)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "brownout_policy.json")
    with open(path, "w") as f:
        json.dump({"policy": dataclasses.asdict(policy), "sim": out}, f,
                  indent=1)
    print(f"brownout policy search: score={out['score']:.1f} "
          f"completed={out['completed']:.0f} max_level={out['max_level']} "
          f"-> {path}")
    return policy, out


def main(out_dir=OUT) -> None:
    for arch, shape, kw in BATTERY:
        kw = dict(kw)
        prec = kw.pop("precision", "fp32")
        kvb = kw.pop("kv_bits", 0)
        run_cell(arch, shape, multi_pod=False, precision=prec, kv_bits=kvb,
                 out_dir=out_dir, skip_existing=True, **kw)
    seed_brownout_policy(out_dir)


if __name__ == "__main__":
    main()

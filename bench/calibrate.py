#!/usr/bin/env python3
"""The readings that a cell's comparison limit is set from, on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the cell's weights, inputs and set-up as a
run makes them, a short window at the cell's own load (``--seconds``,
sampled as a run samples), and then, the program's state freed, the
reference's logits of the sampled batches' inputs and the control's: the
reference with every product's operands rounded to TF32, the nearest
precision below the configuration's f32 with TF32 off; and, beside it, the
reference with the card's own TF32 switched on.  And one reading of what a
change of rounding alone in the glue does: the reference with BNS as one
fused multiply-add (``addcmul``) in place of a product and a sum, each
rounded.  Prints one JSON line a
seed (``program`` and ``control`` are ``logit_gap`` against the
reference) and a last line with the largest program reading and the
smallest control reading.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import judge  # noqa: E402
import loadgen  # noqa: E402
import run  # noqa: E402
import weights  # noqa: E402


@contextlib.contextmanager
def fused_bns():
    """The reference's layers with ``y * gamma + beta`` as one fused
    multiply-add, for the duration."""
    import torch
    from reference import cnn_ops
    plain = cnn_ops.qdense

    def qdense(rows, w, gamma, beta, bits, requant, tf32):
        codes, scale = cnn_ops.act_codes(rows, bits)
        wcodes, alpha = cnn_ops.ternarize(w)
        y = cnn_ops.mm(codes, wcodes, tf32) * alpha[None, :] * scale
        y = torch.relu(torch.addcmul(beta, y, gamma))
        return cnn_ops.levels(y, bits) if requant else y

    cnn_ops.qdense = qdense
    try:
        yield
    finally:
        cnn_ops.qdense = plain


def readings(cell, seed: int, seconds: float, device) -> dict:
    import torch
    mix = cell.mix
    flat = cell.adapter.draw(cell.cfg, seed, device)
    drawn = weights.checksum(flat)
    state = cell.adapter.prepare(flat, cell.cfg)
    del flat
    pool = loadgen.make_pool(mix, cell.cfg["input_shape"], seed, device)

    def forward(x):
        return cell.adapter.forward(state, x, cell.cfg)

    with torch.no_grad():
        run.warm_up(forward, pool, 0.0, device)
        sample = loadgen.Reservoir(mix.sample_batches, seed)
        times, _, _ = run.window(forward, pool, seconds, sample)
    del state, forward
    torch.cuda.empty_cache()
    kept = sample.items
    order = sorted(kept)
    idx = {i % len(pool) for i in kept}
    got = [kept[i].numpy() for i in order]
    t = time.perf_counter()
    ref = run.reference_logits(cell, seed, pool, idx, device, checksum=drawn)
    ref_s = time.perf_counter() - t
    want = [ref[i % len(pool)].numpy() for i in order]
    emulated = run.reference_logits(cell, seed, pool, idx, device, tf32=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    card = run.reference_logits(cell, seed, pool, idx, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with fused_bns():
        fused = run.reference_logits(cell, seed, pool, idx, device)
    return {"seed": seed, "batches": len(times), "compared": len(order),
            "program": judge.logit_gap(got, want),
            "control": judge.logit_gap(
                [emulated[i % len(pool)].numpy() for i in order], want),
            "control_card_tf32": judge.logit_gap(
                [card[i % len(pool)].numpy() for i in order], want),
            "fused_bns": judge.logit_gap(
                [fused[i % len(pool)].numpy() for i in order], want),
            "max_abs_logit": max(float(abs(w).max()) for w in want),
            "reference_s": ref_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    run.prepare_environment()
    import torch
    device = run.pick_device(int(cell.workload["chips"]), True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(cell, seed, args.seconds, device))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": max(r["program"] for r in rows),
                      "control_min": min(r["control"] for r in rows),
                      "control_card_tf32_min":
                          min(r["control_card_tf32"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the fp32 decode step through the kernels parts from its plain
versions (``chip_smoke.py`` phase 4's fp32 check), layer by layer.

    python3 tools/probe_c2.py [SEED ...]      # default: weight seeds 0 1 7

For each weight seed: smollm-135m at full width, fp32 weights, float32,
kv8, random weights from the seed; one prefill chunk, then one decode step
over 4 slots at ragged positions (phase 4's ``_compare_backends`` set-up),
run three ways:

  * ``cuda``: the kernels (B5 ``decode_attention`` in every layer);
  * ``plain``: the plain versions (B5's f32-dequant plain version);
  * ``swap``: the plain versions, with each layer's decoded-token K/V codes
    and scales taken from the ``cuda`` run instead of its own quantizer.

Per layer it prints how far the two runs' decoded-token K and V lie apart
before quantization (relative, and in code steps ``t / s``), how many of
their int8 codes differ and by how many steps, how near the rounding
boundary the differing codes lay, the attention outputs' distance, and B5
against its plain version on the kernel run's own inputs (the per-call
bound ``1e-5 + 1e-4 max|out|``).  Then the logits' distance for
``cuda - plain`` and ``cuda - swap`` as a fraction of phase 4's bound
``1e-4 max|logit|``, and the gap between two plain versions that differ
only in summation order.  A JSON copy goes to
``chiprun_out/probe_c2.json``.

``layer_report`` is what ``tests/test_torch_c2.py`` holds to the
contract.  ``--reduced`` runs the reduced model on the CPU (plain versions
on both sides: no code differs), to try the script without a card.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

POS = (chip_smoke.CHUNK, chip_smoke.CHUNK - 3, chip_smoke.CHUNK - 7, 5)


@contextlib.contextmanager
def _recorders(per_call: bool, kv_from=None, serving: bool = False):
    """Record each decode layer's K/V quantization (inputs and codes; with
    ``kv_from``, return that run's codes and scales instead of quantizing)
    and each kv8 decode attention (q, output, and with ``per_call`` the
    plain version on the same inputs).  The plain side runs B5's f32 plain
    version, or with ``serving`` the serving version (the same f32 values
    at float32, summed in another order).  Restores everything on exit."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref, decode_attention_serving_ref)
    from repro_torch.models import layers
    kvq, attn = [], []
    quantize = layers._kv_quantize

    def kv_quantize(k, v, bits):
        out = quantize(k, v, bits)
        if k.shape[1] == 1:                      # the decode step's token
            if kv_from is not None:
                out = kv_from[len(kvq)]["codes"]
            kvq.append({"k": k.to(torch.float32), "v": v.to(torch.float32),
                        "codes": out})
        return out

    key = (engine.ATTN_DECODE, 8)
    saved = {b: engine.resolve_attention_entry(*key, b)[0]
             for b in engine.BACKENDS}

    def kernel(q, k, ks, v, vs, pos, *, kv_bits, dtype, block=None):
        plan = None if block is None else (block[0], block[2])
        out = decode_attention(q.contiguous(), k, ks, v, vs, pos, plan=plan)
        ref = decode_attention_ref(q, k, ks, v, vs, pos) if per_call else None
        attn.append({"q": q.clone(), "out": out, "ref": ref})
        return out.to(dtype)

    def plain(q, k, ks, v, vs, pos, *, kv_bits, dtype, block=None):
        out = decode_attention_serving_ref(
            q, k, ks, v, vs, pos, kv_bits=kv_bits, dtype=dtype).to(
                torch.float32) if serving else \
            decode_attention_ref(q, k, ks, v, vs, pos)
        attn.append({"q": q.clone(), "out": out, "ref": out})
        return out.to(dtype)

    layers._kv_quantize = kv_quantize
    engine.register_attention(*key, engine.BACKEND_CUDA)(kernel)
    engine.register_attention(*key, engine.BACKEND_TORCH)(plain)
    try:
        yield kvq, attn
    finally:
        layers._kv_quantize = quantize
        for b, fn in saved.items():
            engine.register_attention(*key, b)(fn)


def decode_run(model, params, prompt, device, backend: str, kv_from=None,
               serving: bool = False, start=None):
    """Phase 4's chunk + decode step through ``backend``; returns the decode
    logits and the per-layer records (K/V quantization, attention).
    ``start`` = (token, cache, pos) replaces the chunk: every run decodes
    from its own copy of that one cache (the enc-dec backbone, whose
    prefill through B8 would otherwise move the encoder output between
    the runs)."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serving import write_slot
    cfg, c = model.cfg, chip_smoke.CHUNK
    if start is not None:
        tok, cache, pos = start
        slots = chip_smoke._tree_clone(cache)
    else:
        tokens = torch.as_tensor(prompt[:, :c], device=device)
        cache = tfm.make_cache(cfg, 1, chip_smoke.S_MAX, device)
        lc, cache = model.prefill_chunk(params, tokens, cache, 0,
                                        backend=backend)
        slots = tfm.make_cache(cfg, len(POS), chip_smoke.S_MAX, device)
        for i in range(len(POS)):
            write_slot(slots, cache, i)
        tok = lc[:, -1:].argmax(-1).expand(len(POS), 1).contiguous()
        pos = torch.tensor(POS, device=device)
    with _recorders(backend == "cuda", kv_from, serving) as (kvq, attn):
        ld, _ = model.decode_step(params, tok, slots, pos, backend=backend)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ld, kvq, attn


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def layer_report(model, params, prompt, device, kernels: str = "cuda",
                 start=None) -> dict:
    """The three runs of one weight seed and the per-layer comparison of
    the ``kernels`` backend's run against ``plain`` (see the module
    docstring); ``start`` as :func:`decode_run`'s."""
    import torch
    ld_c, kv_c, at_c = decode_run(model, params, prompt, device, kernels,
                                  start=start)
    ld_p, kv_p, at_p = decode_run(model, params, prompt, device, "torch",
                                  start=start)
    ld_s, _, _ = decode_run(model, params, prompt, device, "torch",
                            kv_from=kv_c, start=start)
    ld_o, kv_o, _ = decode_run(model, params, prompt, device, "torch",
                               serving=True, start=start)
    layers = []
    for i, (kc, kp, ac, ap) in enumerate(zip(kv_c, kv_p, at_c, at_p)):
        row = {"layer": i}
        for name, (ci, si) in (("k", (0, 1)), ("v", (2, 3))):
            codes_c, codes_p = kc["codes"][ci], kp["codes"][ci]
            u_c = kc[name] / kc["codes"][si]          # t / s, in code steps
            u_p = kp[name] / kp["codes"][si]
            diff = (codes_c.to(torch.int32) - codes_p.to(torch.int32)).abs()
            flip = diff > 0
            edge = (codes_c.to(torch.float32) + codes_p.to(torch.float32)) / 2
            near = torch.maximum((u_c - edge).abs(), (u_p - edge).abs())
            row[name] = {
                "rel": _rel(kc[name], kp[name]),
                "du": (u_c - u_p).abs().max().item(),
                "flips": int(flip.sum()),
                "max_step": int(diff.max()),
                "flip_dist": near[flip].max().item() if flip.any() else 0.0,
                "scale_rel": _rel(kc["codes"][si], kp["codes"][si]),
            }
        out_c, ref_c = ac["out"], ac["ref"]
        row["q_rel"] = _rel(ac["q"], ap["q"])
        row["attn_rel"] = _rel(out_c, ap["out"])
        row["per_call"] = (out_c - ref_c).abs().max().item()
        row["per_call_tol"] = 1e-5 + 1e-4 * ref_c.abs().max().item()
        layers.append(row)
    tol = 1e-4 * ld_p.abs().max().item()
    return {"layers": layers, "bound": tol,
            "cuda_plain": (ld_c - ld_p).abs().max().item() / tol,
            "cuda_swap": (ld_c - ld_s).abs().max().item() / tol,
            "plain_order": (ld_o - ld_p).abs().max().item() / tol,
            "order_flips": sum(int((a["codes"][i] != b["codes"][i]).sum())
                               for a, b in zip(kv_o, kv_p) for i in (0, 2)),
            "agree": int((ld_c.argmax(-1) == ld_p.argmax(-1)).sum()),
            "rows": ld_p.shape[0]}


def _print(card, seed, rep) -> None:
    first = next((r["layer"] for r in rep["layers"]
                  if r["k"]["flips"] or r["v"]["flips"]), None)
    print(f"[{card}] fp32 kv8 decode step, weight seed {seed}: logits "
          f"cuda - plain {rep['cuda_plain']:.3f} of the 1e-4 max|logit| "
          f"bound ({rep['bound']:.3e}), cuda - swap (plain with the kernel "
          f"run's K/V codes) {rep['cuda_swap']:.3f}; two plain versions "
          f"(summation order only) {rep['plain_order']:.3f}, with "
          f"{rep['order_flips']} K/V codes apart; greedy rows agree "
          f"{rep['agree']}/{rep['rows']}; first layer with a K/V code "
          f"difference: {first}", flush=True)
    print("  layer  q_rel     attn_rel  B5-plain/tol |  K: rel  du(steps) "
          "flips max dist |  V: rel  du(steps) flips max dist")
    for r in rep["layers"]:
        k, v = r["k"], r["v"]
        print(f"  {r['layer']:5d}  {r['q_rel']:.2e}  {r['attn_rel']:.2e}  "
              f"{r['per_call'] / r['per_call_tol']:.3f}        |  "
              f"{k['rel']:.2e} {k['du']:.2e} {k['flips']:4d} {k['max_step']:2d}"
              f" {k['flip_dist']:.2e} |  {v['rel']:.2e} {v['du']:.2e} "
              f"{v['flips']:4d} {v['max_step']:2d} {v['flip_dist']:.2e}")


def main() -> None:
    import torch
    from repro_torch.models import build_model, reduce_for_smoke
    reduced = "--reduced" in sys.argv
    seeds = [int(a) for a in sys.argv[1:] if not a.startswith("--")] \
        or [0, 1, 7]
    if reduced:
        device, card = torch.device("cpu"), "cpu (reduced, plain both sides)"
    else:
        if not torch.cuda.is_available():
            chip_smoke.fail("torch.cuda.is_available() is false: needs a GPU")
        device, card = torch.device("cuda", 0), chip_smoke.phase_env()
    cfg = chip_smoke.model_config(precision="fp32", kv_bits=8,
                                  dtype="float32")
    if reduced:
        cfg = reduce_for_smoke(cfg)
    model = build_model(cfg)
    prompt = chip_smoke._requests(cfg, 1, chip_smoke.GEN)[0].tokens
    out = {}
    for seed in seeds:
        params = model.init(torch.Generator().manual_seed(seed), device)
        rep = layer_report(model, params, prompt, device,
                           "torch" if reduced else "cuda")
        _print(card, seed, rep)
        out[seed] = rep
        del params
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_c2.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()

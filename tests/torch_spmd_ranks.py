"""Rank-side checks of tests/test_torch_spmd.py: run on every rank of one
spawn of 4 CPU ranks over gloo (``launch.mesh.spawn``).  This module
imports the port only (the ranks start without JAX); the test module holds
the reference's side and every assertion.

:func:`run_checks` returns, per rank, plain data: greedy streams, logits
gaps, collective counts, cache shapes, a checkpoint restore's equality."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.kernels import engine
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import make_decode_fn, step_sharding
from repro_torch.models import build_model, to_serving
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.comm import StepSharding
from repro_torch.parallel.moe_shard_map import moe_apply_shard_map
from repro_torch.runtime.kvcache import PagedBatcher
from repro_torch.runtime.serving import (ContinuousBatcher, Request,
                                         RequestOptions, ServingConfig)
from repro_torch.tree import tree_leaves


def serve(cfg, params, mesh, kind: str, n_reqs: int, n_slots: int,
          max_new: int = 4, s_max: int = 24, chunk: int = 4):
    """Greedy streams {rid: tokens} of ``n_reqs`` seeded prompts of 5 + i
    tokens through the dense or paged batcher (kv8 blocks of 4 when
    paged), with the collectives the run made and its model calls."""
    rng = np.random.default_rng(0)
    if kind == "paged":
        cfg = dataclasses.replace(cfg, kv_bits=0)
        extra = {"kv_bits": 8, "block_size": 4}
    else:
        extra = {}
    sc = ServingConfig(n_slots=n_slots, s_max=s_max, chunk_size=chunk,
                       mesh=mesh, **extra)
    cls = PagedBatcher if kind == "paged" else ContinuousBatcher
    b = cls(build_model(cfg), params, sc)
    for i in range(n_reqs):
        b.submit(Request(i, rng.integers(0, cfg.vocab, (1, 5 + i)
                                         ).astype(np.int64),
                         RequestOptions(max_new=max_new)))
    comm.reset_collective_counts()
    done = b.run()
    calls = {"decode": b.metrics.decode_steps,
             "chunks": b.metrics.prefill_chunks,
             "prefills": b.metrics.prefill_full}
    return ({r.rid: list(r.output) for r in done},
            comm.collective_counts(), calls)


def _logits_gap(cfg, params, mesh, tokens):
    """max |logit| difference of a 4-token prefill chunk (a whole-prompt
    prefill for a stack with Mamba layers) and one decode step over
    ``mesh`` (tensor parallel) against the same calls on the whole params,
    and max |logit| of the one-rank run."""
    from repro_torch.models import transformer as tfm
    model = build_model(cfg)
    local = shd.shard_tree(params, shd.param_specs(params, cfg, mesh), mesh)
    shard = StepSharding(mesh, tp=mesh.axis("model"))
    out = {}
    for name, p, kw, m in (("one", params, {}, None),
                           ("mesh", local, {"shard": shard}, mesh)):
        if tfm.attention_only(cfg):
            cache = tfm.make_cache(cfg, 1, 16, "cpu", mesh=m)
            lc, cache = model.prefill_chunk(p, tokens, cache, 0, **kw)
        else:
            lc, cache = tfm.prefill(p, tokens, cfg, 16, **kw)
        ld, _ = model.decode_step(p, tokens[:, -1:], cache,
                                  torch.tensor([4]), **kw)
        out[name] = (lc, ld)
    scale = max(float(x.abs().max()) for x in out["one"])
    gap = max(float((a - b).abs().max())
              for a, b in zip(out["one"], out["mesh"]))
    return gap, scale


def cache_shapes(cfg, params, mesh, n_slots: int = 4) -> dict:
    """The dense batcher's slot-cache leaf shapes over ``mesh`` (this
    rank's), by layer and leaf."""
    b = ContinuousBatcher(build_model(cfg), params, ServingConfig(
        n_slots=n_slots, s_max=24, chunk_size=0, mesh=mesh))
    return {(layer, name): tuple(leaf.shape)
            for layer, leaves in b.cache.items() for name, leaf in
            leaves.items()}


def _checkpoint_restore(cfg, params, mesh, one, ckpt_dir) -> bool | None:
    """Save ``params``' slices over ``mesh`` (every rank of it writes its
    own); the first rank restores the checkpoint on its one-rank mesh
    ``one``: True when every leaf is ``torch.equal`` to the whole
    params (None on the other ranks)."""
    specs = shd.param_specs(params, cfg, mesh)
    ck = Checkpointer(ckpt_dir)
    ck.save(1, shd.shard_tree(params, specs, mesh),
            shardings=shd.TreeSharding(specs, mesh))
    mesh.barrier()
    if mesh.axis("model").index != 0:
        return None
    got = ck.restore(1, params, shd.TreeSharding(
        shd.param_specs(params, cfg, one), one))
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(params)))


def _dispatches(events) -> dict:
    out: dict = {}
    for ev in events:
        by = out.setdefault(ev.op, {})
        by[ev.impl_backend] = by.get(ev.impl_backend, 0) + 1
    return out


def sp_decode(job, mesh):
    """Greedy decode of one prompt (B = 1) with the cache cut over its
    sequence: a one-rank prefill (the same on every rank), the cache cut by
    ``cache_specs`` (the data axes at B = 1, or 'model' under
    ``kv_seq_shard``) and the params by ``param_specs``, then ``n_new``
    decode steps of ``make_decode_fn(model, step_sharding(...))``.
    Returns (the stream, the decode steps' f32 logits, the first step's
    probe: collective counts and wire bytes, dispatches, argument bytes),
    and with ``job["dry"]`` the dry run of the same step on this rank of a
    dry mesh of the same shape (meta tensors on the host's routes)."""
    cfg, params, prompt = job["cfg"], job["params"], job["prompt"]
    model = build_model(cfg)
    tokens = torch.from_numpy(prompt)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      job["s_max"])
        cspecs = shd.cache_specs(cache, cfg, mesh, 1,
                                 kv_seq_shard=job["kv_seq_shard"])
        cache = shd.shard_tree(cache, cspecs, mesh)
        local = shd.shard_tree(params, shd.param_specs(params, cfg, mesh),
                               mesh)
        step = make_decode_fn(model, step_sharding(cfg, mesh, 1, cspecs))
        tok = logits[:, -1].argmax(-1)
        stream, steps, probe = [int(tok)], [], None
        for i in range(job["n_new"]):
            pos = torch.tensor([prompt.shape[1] + i])
            args = (local, tok[:, None], cache, pos)
            comm.reset_collective_counts()
            events = []
            engine.set_dispatch_listener(events.append)
            try:
                out, cache = step(*args)
            finally:
                engine.set_dispatch_listener(None)
            if probe is None:
                probe = (comm.collective_counts(), comm.collective_bytes(),
                         _dispatches(events),
                         sum(t.numel() * t.element_size()
                             for t in tree_leaves(args)))
            steps.append(out[:, -1].clone())
            tok = out[:, -1].argmax(-1)
            stream.append(int(tok))
    res = {"stream": stream, "logits": torch.cat(steps).numpy(),
           "probe": probe}
    if job.get("dry"):
        dry = Mesh(mesh.shape, rank=mesh.rank, dry=True)
        shapes = build_model(cfg).init(torch.Generator(), "meta")
        if cfg.precision != "fp32":
            shapes = to_serving(shapes, cfg, tp=job["tp"])
        cell = dryrun.decode_cell(cfg, dry, shapes, 1, job["s_max"],
                                  kv_seq_shard=job["kv_seq_shard"])
        rec = dryrun.trace(cell, as_card=False)
        res["dry"] = (rec["collectives"]["counts"],
                      rec["collectives"]["bytes"], rec["dispatch"],
                      rec["memory_analysis"]["argument_size_in_bytes"])
    return res


def _moe_checks(mesh, moe):
    """moe_apply_shard_map on this rank's data shard of x and expert shard
    of p; and the slot-map moe_apply under TP (the global slot map, rows
    split over data, experts over model) against the one-device call."""
    from repro_torch.models import layers as L
    cfg = moe["cfg"]
    tp, data = mesh.axis("model"), mesh.axis("data")
    p, x = moe["p"], moe["x"]
    e_loc = cfg.n_experts // tp.size
    b_loc = x.shape[0] // data.size
    lp = dict(p)
    for name in ("w_gate", "w_up", "w_down"):
        lp[name] = p[name][tp.index * e_loc:(tp.index + 1) * e_loc]
    lx = x[data.index * b_loc:(data.index + 1) * b_loc]
    shard = StepSharding(mesh, tp=tp, rows=data)
    out = {}
    for cap in (64.0, 1.0):
        c = dataclasses.replace(cfg, capacity_factor=cap)
        got, aux = moe_apply_shard_map(lp, lx, c, shard)
        out[f"shard_map_{cap}"] = (got.numpy(), float(aux))
    c = dataclasses.replace(cfg, capacity_factor=1.0)
    want, _ = L.moe_apply(p, x, c)
    got, _ = L.moe_apply(lp, lx, c, shard=shard)
    want = want[data.index * b_loc:(data.index + 1) * b_loc]
    out["pjit_gap"] = (float((got - want).abs().max()),
                       float(want.abs().max()))
    return out


def run_checks(world, payload):
    """Every rank of a 2x2 world: one-rank meshes, a 2,1 mesh on ranks 0-1
    beside a 1,2 mesh on ranks 2-3, the 2,2 world, a 1,4 and a 4,1
    mesh."""
    torch.set_num_threads(1)
    r = world.rank
    # every make_mesh over several ranks is collective: all ranks call each
    one = make_mesh(1, 1, ranks=[r])
    m21 = make_mesh(2, 1, ranks=[0, 1])
    m12 = make_mesh(1, 2, ranks=[2, 3])
    m12_low = make_mesh(1, 2, ranks=[0, 1])
    m14 = make_mesh(1, 4)
    m41 = make_mesh(4, 1)
    pair = m21 if r < 2 else m12
    res = {"rank": r, "pair": dict(pair.shape)}

    # the four collectives on the world's axes (bf16 travels as f32 on gloo)
    every, model = world.axis(("data", "model")), world.axis("model")
    x = torch.tensor([float(r), -float(r)])
    comm.reset_collective_counts()
    res["collectives"] = (
        every.all_reduce_sum(x).tolist(),
        every.all_reduce_max(x.to(torch.bfloat16)).float().tolist(),
        every.all_gather(x[None], dim=0).tolist(),
        model.broadcast(x, src=1).tolist(),
        world.axis("data").all_gather(x[None], dim=1).tolist(),
        comm.collective_counts())

    small = payload["smollm"]
    for kind in ("dense", "paged"):
        for label, mesh in (("1,1", one), ("pair", pair), ("2,2", world)):
            res[f"smollm_{kind}_{label}"] = serve(
                small["cfg"], small["params"], mesh, kind, n_reqs=3,
                n_slots=4)

    tpg = payload["tp_golden"]
    for kind in ("dense", "paged"):
        for label, mesh in (("pair", pair), ("2,2", world)):
            res[f"tp_{kind}_{label}"] = serve(
                tpg["cfg"], tpg["params"], mesh, kind, n_reqs=2, n_slots=2,
                s_max=16)

    f32 = payload["tp_fp32"]
    tokens = torch.from_numpy(f32["tokens"])
    if r >= 2:
        for name in ("tp_fp32", "tp_1x1"):
            c, p = payload[name]["cfg"], payload[name]["params"]
            res[f"{name}_gap"] = _logits_gap(c, p, m12, tokens)
            res[f"{name}_streams"] = serve(c, p, m12, "dense", 2, 2,
                                           s_max=16)[0]

    mixed = payload["mixed"]
    res["mixed_1,4"] = serve(mixed["cfg"], mixed["params"], m14, "dense",
                             2, 2, s_max=16)
    res["mixed_1,4_paged"] = serve(mixed["cfg"], mixed["params"], m14,
                                   "paged", 2, 2, s_max=16)

    res["moe"] = _moe_checks(world, payload["moe"])
    mg = payload["moe_golden"]
    for impl in ("pjit", "shard_map"):
        cfg = dataclasses.replace(mg["cfg"], moe_impl=impl)
        res[f"moe_golden_{impl}"] = serve(cfg, mg["params"], pair, "dense",
                                          2, 2, s_max=16)[0]

    mamba = payload["mamba"]
    res["mamba_pair"] = serve(mamba["cfg"], mamba["params"], pair, "dense",
                              2, 4, chunk=0)[0]
    # Mamba and hybrid stacks on a model axis: d_inner cut over it
    wide = payload["mamba_tp"]
    for label, mesh in (("pair", pair), ("2,2", world)):
        res[f"mamba_tp_{label}"] = serve(wide["cfg"], wide["params"], mesh,
                                         "dense", 2, 4, chunk=0)
        res[f"mamba_tp_cache_{label}"] = cache_shapes(
            wide["cfg"], wide["params"], mesh)
    if r >= 2:
        jam = payload["jamba_tp"]
        res["jamba_tp"] = serve(jam["cfg"], jam["params"], m12, "dense", 2,
                                4, chunk=0)
        res["jamba_tp_cache"] = cache_shapes(jam["cfg"], jam["params"], m12)
    else:
        mf = payload["mamba_fp32"]
        res["mamba_fp32_gap"] = _logits_gap(mf["cfg"], mf["params"],
                                            m12_low, tokens)
        res["mamba_fp32_streams"] = serve(mf["cfg"], mf["params"], m12_low,
                                          "dense", 2, 4, chunk=0)[0]
        res["mamba_tp_restore"] = _checkpoint_restore(
            wide["cfg"], wide["params"], m12_low, one,
            payload["mamba_ckpt"])

    # sequence-parallel decode: B = 1, the cache cut over its sequence
    meshes = {"4,1": m41, "1,4": m14, "2,2": world}
    for name, job in payload["sp"].items():
        res[f"sp_{name}"] = sp_decode(job, meshes[job["mesh"]])
    return res

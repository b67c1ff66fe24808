"""Dry run at production scale — ``repro.launch.dryrun`` for the port: one
rank's step of every (arch x shape x mesh) cell, traced on tensors with no
data.

The reference lowers and compiles each cell over the 16x16 pod and the
2x16x16 multi-pod mesh with XLA; the port has no compiler to ask, so it
runs one rank's step (rank 0 unless ``--rank``) once, eagerly, on ``meta``
tensors (shapes and dtypes, no memory, no data: a host read such as
``.item()`` raises) over a dry mesh (``launch.mesh.make_production_mesh``:
its collectives count themselves and send nothing).  Inside
``engine.trace_as_card`` the engine takes the card's routes and stands in
for each kernel launch: nothing is built or loaded, and the dispatch trace
says ``cuda`` as it does on the card.  Per cell the record keeps:

  * ``memory_analysis`` — ``argument_size_in_bytes`` (this rank's params,
    optimizer state, batch and cache), ``output_size_in_bytes``,
    ``temp_size_in_bytes`` (the peak of the bytes live above the arguments,
    less the outputs it holds), ``alias_size_in_bytes`` (outputs that are
    arguments: the cache updated in place) and ``total_bytes`` by the
    reference's formula (argument + output + temp - alias); ``fits``:
    ``total_bytes`` within the card's memory; ``peak_live_bytes`` the
    peak itself;
  * ``cost_analysis`` — ``flops`` (``torch.utils.flop_counter`` over the
    aten ops plus the kernels' own, ``kernels.costs``) and ``bytes
    accessed`` (each aten op's inputs and outputs, no fusion in eager
    code, plus the kernels' bytes); ``kernels`` the traced launches by
    kernel with their flops and bytes;
  * ``collectives`` — ``{"bytes", "counts", "total_bytes"}`` by kind
    (``parallel.comm``: wire bytes a rank);
  * ``dispatch`` — the engine's dispatches by op and ``impl_backend``;
  * ``model_flops``, ``n_params``, ``n_active_params``, ``status``,
    ``error`` / ``traceback``, ``trace_s`` (the step's trace; the
    reference's ``lower_s`` / ``compile_s``) and ``wall_s``.

Train cells run the reference's recipe: adamw, or for the FSDP archs
(kimi-k2, internvl2, jamba) ``param_specs(fsdp=True)``, adafactor and
bf16 gradient accumulation, microbatched so each data shard takes one row
a microbatch.  (The trace runs on ``meta`` tensors rather than
``FakeTensorMode``'s fake CUDA tensors: those cost about five times the
time an op, which the Mamba scans' and the microbatches' many ops
multiply, and a CPU-only torch build cannot index them.)

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--skip-existing]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch X \\
      --shape decode_32k --precision 2xT --kv-bits 8

Records go to results/dryrun_torch/<arch>__<shape>__<mesh>__<variant>.json,
beside the reference's results/dryrun/.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, iter_cells
from repro_torch.kernels import engine
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_decode_fn, make_prefill_fn,
                                      make_train_step, step_sharding)
from repro_torch.models import build_model, make_batch, to_serving
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# archs whose training state needs FSDP + factored optimizer (the
# reference's dry run)
FSDP_ARCHS = {"kimi-k2-1t-a32b", "internvl2-76b", "jamba-v0.1-52b"}

# bytes of device memory ``fits`` holds a rank to when no card is visible:
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (700 W limit), read by chip_smoke.py phase 4v
H100_MEMORY = 85_017_493_504

# aten ops that move no data (beside the views): uninitialized factories
# and metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh"}
# aten ops that write given rows of their first argument in place
_WRITES_ROWS = {"index_put_", "index_put", "_index_put_impl_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> dict[int, int]:
    """{id of the storage: its bytes} of ``tensors`` (each storage once)."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages an op makes, live until they die: each
    output's storage is added when first seen and subtracted when it is
    freed (a weak reference's callback: views and autograd's saved tensors
    keep it alive), ``peak`` the most at once.  The storages of
    ``args`` (:meth:`hold`) are not counted.  ``accessed`` sums each aten
    op's tensor inputs and outputs, but for views, metadata and
    uninitialized factories."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._refs: dict[int, weakref.ref] = {}
        self._held: dict[int, weakref.ref] = {}

    def hold(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            self._held[id(st)] = weakref.ref(st)

    def _seen(self, st) -> bool:
        for refs in (self._held, self._refs):
            r = refs.get(id(st))
            if r is not None and r() is st:
                return True
        return False

    def _freed(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        if func.namespace == "aten" and not func.is_view and \
                name not in _NO_TRAFFIC:
            ins = _tensors((args, kwargs))
            if name in _WRITES_ROWS:
                # indices and values read, the values' rows written: the
                # rest of the destination is not touched
                self.accessed += sum(_nbytes(t) for t in ins[1:]) + \
                    _nbytes(ins[-1])
            else:
                self.accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            if self._seen(st):
                continue
            n, key = st.nbytes(), id(st)
            self._refs[key] = weakref.ref(
                st, lambda _r, k=key, n=n: self._freed(k, n))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def input_specs(cfg, shape, for_training=None):
    """Meta stand-ins for every model input of ``shape`` (no allocation):
    ``make_batch``'s leaves, with the labels of a train batch
    (``for_training`` None: as ``shape.mode`` says)."""
    train = shape.mode == "train" if for_training is None else for_training
    tiny = dataclasses.replace(shape, seq_len=1, global_batch=1)
    batch = {k: torch.empty((shape.global_batch, shape.seq_len,
                             *v.shape[2:]), dtype=v.dtype, device="meta")
             for k, v in make_batch(cfg, tiny, torch.Generator()).items()}
    if train and "labels" not in batch:
        batch["labels"] = torch.empty(batch["tokens"].shape,
                                      dtype=torch.int64, device="meta")
    if not train:
        batch.pop("labels", None)
    return batch


def _rows(tree, n: int):
    """Meta leaves with their leading (row) dim divided by ``n``."""
    return {k: torch.empty((v.shape[0] // n, *v.shape[1:]), dtype=v.dtype,
                           device="meta") for k, v in tree.items()}


def _row_count(mesh, axes) -> int:
    n = 1
    for a in axes or ():
        n *= mesh.shape[a]
    return n


def _fresh(tree):
    """A meta tensor of its own storage for each leaf of ``tree`` (a
    ``shard_tree`` slice may be a view of the whole leaf's storage)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")
    return tree_map(lambda t: None if t is None else _fresh(t), tree)


class Cell:
    """One rank's step of a cell: ``fn(*args)`` on meta tensors (this
    rank's slices, each of its own storage) and its config."""

    def __init__(self, fn, args, cfg):
        self.fn, self.cfg = fn, cfg
        self.args = tuple(_fresh(a) for a in args)


def _accum_steps(cfg, mesh, shape) -> int:
    """The reference's default: microbatches so each data shard takes one
    row a microbatch (when the microbatch still divides the batch cut)."""
    nshard = _row_count(mesh, shd._batch_axes(cfg, mesh, shape.global_batch))
    want = shape.global_batch // nshard
    for cand in range(want, 0, -1):
        if shape.global_batch % cand == 0 and \
                (shape.global_batch // cand) % nshard == 0:
            return cand
    return 1


def build_cell(arch: str, shape_name: str, mesh, precision: str = "fp32",
               kv_bits: int = 0, fsdp=None, remat: bool = True,
               capacity_factor: float = None, grad_compress_bits: int = 0,
               accum_steps: int = None, kv_seq_shard: bool = False,
               force_pure_dp: bool = False, quantize_lm_head: bool = False,
               moe_ep_constraints: str = "", attn_probs_bf16: bool = False,
               moe_impl: str = "", n_layers: int = None) -> Cell:
    """One rank's step of a cell over ``mesh`` (the reference's
    ``build_cell`` keywords; ``remat`` is accepted and, as in the
    reference, changes nothing; ``n_layers`` cuts the depth, at full
    width).  Params come from ``model.init(..., "meta")`` (and
    ``to_serving(tp=mesh.shape["model"])`` at a precision other than
    fp32), cut by ``param_specs`` / ``state_specs`` / ``batch_specs`` /
    ``cache_specs`` through ``shard_tree``."""
    shape = SHAPES[shape_name]
    over = {}
    if capacity_factor is not None:
        over["capacity_factor"] = capacity_factor
    if force_pure_dp:
        over["force_pure_dp"] = True
    if quantize_lm_head:
        over["quantize_lm_head"] = True
    if moe_ep_constraints:
        over["moe_ep_constraints"] = moe_ep_constraints
    if attn_probs_bf16:
        over["attn_probs_bf16"] = True
    if moe_impl:
        over["moe_impl"] = moe_impl
    if n_layers:
        over["n_layers"] = n_layers
    cfg = get_config(arch, precision=precision, kv_bits=kv_bits, **over)
    model = build_model(cfg)
    shapes = model.init(torch.Generator(), "meta")
    if fsdp is None:
        fsdp = arch in FSDP_ARCHS

    if shape.mode == "train":
        opt = make_optimizer("adafactor" if fsdp else "adamw")
        pspecs = shd.param_specs(shapes, cfg, mesh, fsdp=fsdp)
        ospecs = opt.state_specs(pspecs)
        state = opt.init(shapes)
        batch = input_specs(cfg, shape, for_training=True)
        if accum_steps is None:
            accum_steps = _accum_steps(cfg, mesh, shape)
        rows = _row_count(mesh, shd._batch_axes(
            cfg, mesh, shape.global_batch // accum_steps))
        step = make_train_step(
            model, opt, grad_compress_bits=grad_compress_bits,
            accum_steps=accum_steps,
            accum_dtype=torch.bfloat16 if fsdp else torch.float32,
            mesh=mesh, fsdp=fsdp, global_batch=shape.global_batch)
        return Cell(step, (shd.shard_tree(shapes, pspecs, mesh),
                           shd.shard_tree(state, ospecs, mesh),
                           _rows(batch, rows)), cfg)

    if precision != "fp32":
        shapes = to_serving(shapes, cfg, tp=mesh.shape["model"])
    if shape.mode == "prefill":
        return prefill_cell(cfg, mesh, shapes, shape)
    return decode_cell(cfg, mesh, shapes, shape.global_batch, shape.seq_len,
                       kv_seq_shard=kv_seq_shard)


def prefill_cell(cfg, mesh, shapes, shape) -> Cell:
    """A prefill of ``shape`` (the rank's rows) with params of global
    ``shapes`` (meta) cut by ``param_specs``."""
    model = build_model(cfg)
    params = shd.shard_tree(shapes, shd.param_specs(shapes, cfg, mesh), mesh)
    b = shape.global_batch
    batch = _rows(input_specs(cfg, shape, for_training=False),
                  _row_count(mesh, shd._batch_axes(cfg, mesh, b)))
    return Cell(make_prefill_fn(model, shape.seq_len,
                                step_sharding(cfg, mesh, b)),
                (params, batch), cfg)


def decode_cell(cfg, mesh, shapes, b: int, s_max: int,
                kv_seq_shard: bool = False) -> Cell:
    """One decode step of ``b`` global rows against a cache of ``s_max``
    positions, params of global ``shapes`` (meta) cut by ``param_specs``,
    the cache by ``cache_specs`` (sequence-parallel where the rows do not
    cover the data axes, or over 'model' with ``kv_seq_shard``), the
    rank's rows of the new token, a 0-d position."""
    model = build_model(cfg)
    params = shd.shard_tree(shapes, shd.param_specs(shapes, cfg, mesh), mesh)
    if cfg.kind == "encdec":
        cache = {"self": L.make_kv_cache(cfg, b, s_max, "meta",
                                         stacked=cfg.n_layers)}
        cross = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.dh)
        for name in ("cross_k", "cross_v"):
            cache[name] = torch.empty(cross, dtype=L.pdtype(cfg),
                                      device="meta")
    else:
        cache = tfm.make_cache(cfg, b, s_max, "meta")
    cspecs = shd.cache_specs(cache, cfg, mesh, b, kv_seq_shard=kv_seq_shard)
    local = b // _row_count(mesh, shd._batch_axes(cfg, mesh, b))
    if cfg.frontend == "embeds":
        token = torch.empty((local, 1, cfg.d_model), dtype=torch.float32,
                            device="meta")
    else:
        token = torch.empty((local, 1), dtype=torch.int64, device="meta")
    pos = torch.empty((), dtype=torch.int64, device="meta")
    shard = step_sharding(cfg, mesh, b, cspecs)
    return Cell(make_decode_fn(model, shard),
                (params, token, shd.shard_tree(cache, cspecs, mesh), pos),
                cfg)


def model_flops(cfg, shape) -> float:
    """The reference's: 6 N_active D for a train step, 2 N_active D for a
    prefill (D its tokens), 2 N_active a row for a decode step."""
    na = cfg.n_active_params
    if shape.mode == "train":
        return 6.0 * na * shape.seq_len * shape.global_batch
    if shape.mode == "prefill":
        return 2.0 * na * shape.seq_len * shape.global_batch
    return 2.0 * na * shape.global_batch


def device_memory() -> int:
    """The card's memory (the visible card's, else :data:`H100_MEMORY`)."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_MEMORY


def trace(cell: Cell, as_card: bool = True) -> dict:
    """Run ``cell``'s step once under the flop counter and the live-bytes
    tracker; the record's measured keys.  ``as_card``: the meta tensors
    take the card's routes (``engine.trace_as_card``); without it the
    plain versions, as a real step on the host does."""
    from torch.utils.flop_counter import FlopCounterMode
    comm.reset_collective_counts()
    engine.reset_traced_work()
    args = cell.args
    arg_tensors = _tensors(args)
    arg_bytes = _storage_bytes(arg_tensors)
    live = LiveBytes()
    live.hold(arg_tensors)
    t0 = time.time()
    card = engine.trace_as_card() if as_card else contextlib.nullcontext()
    with engine.dispatch_trace() as events, card:
        with FlopCounterMode(display=False) as flops, live:
            out = cell.fn(*args)
    trace_s = time.time() - t0
    outs = _storage_bytes(_tensors(out))
    alias = sum(n for k, n in outs.items() if k in arg_bytes)
    out_bytes = sum(outs.values())
    mem = {"argument_size_in_bytes": sum(arg_bytes.values()),
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": max(0, live.peak - (out_bytes - alias)),
           "alias_size_in_bytes": alias}
    mem["total_bytes"] = (mem["argument_size_in_bytes"]
                          + mem["output_size_in_bytes"]
                          + mem["temp_size_in_bytes"]
                          - mem["alias_size_in_bytes"])
    kernels = engine.traced_work()
    dispatch: dict[str, dict[str, int]] = {}
    for ev in events:
        by = dispatch.setdefault(ev.op, {})
        by[ev.impl_backend] = by.get(ev.impl_backend, 0) + 1
    coll_bytes = comm.collective_bytes()
    return {
        "memory_analysis": mem,
        "peak_live_bytes": live.peak,
        "cost_analysis": {
            "flops": float(flops.get_total_flops()
                           + sum(k["flops"] for k in kernels.values())),
            "bytes accessed": float(live.accessed
                                    + sum(k["bytes"] for k in
                                          kernels.values()))},
        "kernels": kernels,
        "collectives": {"bytes": coll_bytes,
                        "counts": comm.collective_counts(),
                        "total_bytes": sum(coll_bytes.values())},
        "dispatch": dispatch,
        "trace_s": round(trace_s, 2),
    }


def cell_id(arch, shape_name, multi_pod, precision, kv_bits, **kw) -> str:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    variant = precision + (f"_kv{kv_bits}" if kv_bits else "")
    for k, v in sorted(kw.items()):
        if v is not None and v is not False:
            variant += f"_{k}{v}"
    return f"{arch}__{shape_name}__{mesh_name}__{variant}"


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             precision: str = "fp32", kv_bits: int = 0, out_dir: str = None,
             skip_existing: bool = False, verbose: bool = True,
             rank: int = 0, **kw) -> dict:
    """Trace one cell on rank ``rank`` of the production mesh and write its
    record (module docstring) to ``out_dir``; returns the record."""
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    cid = cell_id(arch, shape_name, multi_pod, precision, kv_bits, **kw)
    path = os.path.join(out_dir, cid + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "rank": rank,
           "precision": precision, "kv_bits": kv_bits, **kw}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
        cell = build_cell(arch, shape_name, mesh, precision=precision,
                          kv_bits=kv_bits, **kw)
        rec.update(trace(cell))
        rec["fits"] = rec["memory_analysis"]["total_bytes"] <= device_memory()
        shape = SHAPES[shape_name]
        rec["model_flops"] = model_flops(cell.cfg, shape)
        rec["n_params"] = int(cell.cfg.n_params)
        rec["n_active_params"] = int(cell.cfg.n_active_params)
        rec["status"] = "ok"
        if verbose:
            ma = rec["memory_analysis"]
            print(f"[ok] {cid}: trace {rec['trace_s']}s flops "
                  f"{rec['cost_analysis']['flops']:.3e} bytes "
                  f"{rec['cost_analysis']['bytes accessed']:.3e} coll "
                  f"{rec['collectives']['total_bytes']:.3e}B mem "
                  f"{ma['total_bytes']:.3e}B fits {rec['fits']}", flush=True)
    except Exception as e:  # noqa: BLE001 - record and continue
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[ERR] {cid}: {rec['error']}", flush=True)
    rec["wall_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--kv-bits", type=int, default=0)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh whose step is traced")
    args = ap.parse_args(argv)

    if args.all:
        failures = 0
        for arch, shape, skip in iter_cells():
            if skip:
                print(f"[skip] {arch}__{shape.name}: {skip}")
                continue
            for mp in ([False, True] if not args.multi_pod else [True]):
                rec = run_cell(arch, shape.name, multi_pod=mp,
                               precision=args.precision, kv_bits=args.kv_bits,
                               out_dir=args.out_dir,
                               skip_existing=args.skip_existing,
                               rank=args.rank)
                failures += rec["status"] != "ok"
        print(f"done; failures={failures}")
        raise SystemExit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        run_cell(args.arch, args.shape, multi_pod=mp,
                 precision=args.precision, kv_bits=args.kv_bits,
                 out_dir=args.out_dir, skip_existing=args.skip_existing,
                 rank=args.rank)


if __name__ == "__main__":
    main()

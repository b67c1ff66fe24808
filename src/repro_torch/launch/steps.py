"""Step functions — ``repro.launch.steps``'s, for the port's ``Model``:

  make_train_step(model, opt, mesh=None, fsdp=False)
                               -> train_step(params, opt_state, batch)
  make_prefill_fn(model, s_max, shard=None) -> prefill(params, batch)
  make_decode_fn(model, shard=None) -> decode(params, token, cache, pos)
  step_sharding(cfg, mesh, b, cache_specs=None) -> a serving step's shard

The reference's functions are pure and ``jax.jit`` lowers them, over a mesh
with ``in_shardings``; here they run eagerly: a train step takes its
gradients with autograd (one backward pass per microbatch) and returns new
tensors, leaving its inputs as they were.  Over a mesh (one process a rank,
``launch.mesh``) the step holds this rank's slices of the params and the
optimizer state and takes this rank's rows of each microbatch, as the
reference's ``micro_shardings`` keep them; the collectives in the model
carry the gradients (``parallel.comm``), and one f32 bucket a step
all-reduces the gradients over the data axes.  With ``fsdp`` the expert
weights' K is cut over 'data' too (``param_specs(fsdp=True)``), each
gathered where its layer uses it; their gradients come back summed over
'data' already and stay out of that bucket.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import true_div
from repro_torch.models import Model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.comm import StepSharding
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _compress(g: torch.Tensor, bits: int, cut=None) -> torch.Tensor:
    """Per-tensor symmetric int quantization of a gradient, dequantized:
    what the reference's int8 gradient channel carries.  ``cut``: the mesh
    axis the leaf is cut over, whose max the scale takes (the whole
    leaf's)."""
    qmax = (1 << (bits - 1)) - 1
    amax = g.abs().max()
    if cut is not None:
        amax = cut.all_reduce_max(amax)
    s = true_div(torch.clamp_min(amax, 1e-12), qmax)
    q = torch.clamp(torch.round(g / s), -qmax, qmax).to(torch.int8)
    return q.to(torch.float32) * s


class _MeshStep:
    """What a train step over ``mesh`` needs: the params' specs (from
    their global shapes, ``model.init`` on the meta device; with ``fsdp``
    the expert weights' K over 'data'), the model axis when tensor
    parallelism applies, the data axis of the FSDP cut, and the row axes
    of a microbatch of ``b`` global rows
    (``parallel.sharding._batch_axes``)."""

    def __init__(self, model: Model, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.cfg = model.cfg
        shapes = model.init(torch.Generator(), "meta")
        self.specs = shd.param_specs(shapes, model.cfg, mesh, fsdp=fsdp)
        self.tp = None if shd.pure_dp(model.cfg, mesh) \
            else mesh.axis("model")
        # the leaves cut over data (FSDP): gathered by their layer, their
        # gradients summed over data by the gather's backward
        self.data_cut = tree_map(
            lambda _, spec: "data" in shd.cut_axes(spec, mesh), shapes,
            self.specs)
        self.fsdp = mesh.axis("data") if any(tree_leaves(self.data_cut)) \
            else None

    def shard(self, b: int):
        """(StepSharding of a microbatch of ``b`` global rows, its row
        axis or None)."""
        axes = shd._batch_axes(self.cfg, self.mesh, b)
        rows = self.mesh.axis(axes) if axes else None
        return StepSharding(self.mesh, tp=self.tp, rows=rows,
                            global_rows=True, fsdp=self.fsdp), rows

    def cut(self, spec):
        """The mesh axis a leaf of ``spec`` is cut over, else None."""
        axes = shd.cut_axes(spec, self.mesh)
        return self.mesh.axis(axes) if axes else None


def _local_rows(batch: dict, rows) -> dict:
    """This rank's rows of a global (micro)batch (all of them with no row
    axis)."""
    if rows is None:
        return batch
    n = next(iter(batch.values())).shape[0] // rows.size
    return {k: v.narrow(0, rows.index * n, n) for k, v in batch.items()}


def _bucket_mean(grads, loss, rows, summed=None, rest=None):
    """The gradients and the loss averaged over the row axes in one
    all-reduce of a flat f32 bucket (leaves in tree order, the loss last);
    returned in the gradients' dtypes.

    ``summed`` (a tree of bools, FSDP): the leaves whose gradients the
    backward already summed over 'data' (the gather's reduce-scatter).
    They stay out of the bucket, go into a second one over ``rest`` (the
    other row axes, e.g. 'pod'; none when None) and are divided by the
    row count as the bucket is: summing them over 'data' again would count
    each rank's rows twice."""
    if rows is None:
        return grads, loss
    leaves = tree_leaves(grads)
    done = [False] * len(leaves) if summed is None else tree_leaves(summed)

    def mean(parts, axis):
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in parts])
        if axis is not None:
            flat = axis.all_reduce_sum(flat)
        return flat / rows.size
    flat = mean([g for g, d in zip(leaves, done) if not d] + [loss], rows)
    cut = [g for g, d in zip(leaves, done) if d]
    flat_cut = mean(cut, rest) if cut else None
    out, at, at_cut = [], 0, 0
    for g, d in zip(leaves, done):
        src, start = (flat_cut, at_cut) if d else (flat, at)
        out.append(src[start:start + g.numel()].view(g.shape).to(g.dtype))
        if d:
            at_cut += g.numel()
        else:
            at += g.numel()
    return tree_unflatten(grads, out), flat[at]


def make_train_step(model: Model, opt, grad_compress_bits: int = 0,
                    accum_steps: int = 1, accum_dtype=torch.float32,
                    mesh=None, fsdp: bool = False,
                    global_batch: int | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``metrics`` {"loss", "grad_norm"} as 0-d f32 tensors.

    ``accum_steps``: gradient accumulation — the batch is processed in
    ``accum_steps`` microbatches along its first axis, one forward and
    backward each, their gradients summed into an accumulator of
    ``accum_dtype`` (zeros first, then each microbatch's gradient cast to
    it and added, in order), divided by ``accum_steps`` and cast to f32;
    the loss is the mean of the microbatch losses.

    ``grad_compress_bits``: quantize each gradient (each microbatch's) to
    int8 codes with a per-tensor scale before it is used — the paper's
    bandwidth saving applied to the gradient channel.

    ``mesh``: a rank's mesh (``launch.mesh``); ``params`` and ``opt_state``
    then hold this rank's slices (``param_specs`` and the optimizer's
    ``state_specs`` through ``shard_tree``) and ``batch`` is the global
    batch, the same on every rank.  Microbatch i is the global rows
    [i B/a, (i+1) B/a), of which the rank takes its slice over the row
    axes; each rank's loss is its rows' NLL mean (plus the MoE's aux, over
    the global slot map), and the accumulated gradients and the loss are
    averaged over the row axes in one f32 bucket a step, so ``loss`` and
    ``grad_norm`` are the global batch's.  With ``grad_compress_bits`` the
    reduction comes first, as the reference compresses the global gradient
    (with ``accum_steps`` > 1, one bucket a microbatch).

    ``fsdp`` (over a mesh): the params' specs take the FSDP rule
    (``param_specs(fsdp=True)``: the expert weights' K over 'data', as the
    reference's dry run trains kimi-k2, internvl2 and jamba); each such
    weight is gathered where its layer uses it and again in its backward
    (``models.layers``), and its gradient, summed over 'data' by that
    backward, skips the bucket's 'data' sum.

    ``global_batch`` (over a mesh): ``batch`` holds only this rank's rows,
    its slice of each microbatch in microbatch order (what the reference's
    ``micro_shardings`` put on a device), of a step of ``global_batch``
    rows; the step is the same."""
    ms = None if mesh is None else _MeshStep(model, mesh, fsdp)

    def grads_of(params, batch, shard=None):
        leaves = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        kw = {} if shard is None else {"shard": shard}
        loss = model.loss(leaves, batch, **kw)
        wrt = [p for p in tree_leaves(leaves) if p.requires_grad]
        got = dict(zip(map(id, wrt), torch.autograd.grad(
            loss, wrt, allow_unused=True)))

        def grad(p):           # a leaf the loss does not reach gets zeros
            g = got.get(id(p))
            return torch.zeros_like(p) if g is None else g
        return loss.detach(), tree_map(grad, leaves)

    def compress(grads):
        if not grad_compress_bits:
            return grads
        if ms is None:
            return tree_map(lambda g: _compress(g, grad_compress_bits), grads)
        return tree_map(lambda g, spec: _compress(g, grad_compress_bits,
                                                  ms.cut(spec)),
                        grads, ms.specs)

    def micro_grads(params, batch):
        """(loss, grads) of one microbatch (the global rows), reduced over
        the rows and compressed when each microbatch is."""
        if ms is None:
            loss, g = grads_of(params, batch)
            return loss, compress(g)
        if global_batch is None:
            shard, rows = ms.shard(next(iter(batch.values())).shape[0])
            batch = _local_rows(batch, rows)
        else:
            shard, rows = ms.shard(global_batch // accum_steps)
        loss, g = grads_of(params, batch, shard)
        if grad_compress_bits and accum_steps > 1:
            g, loss = bucket(g, loss, rows)
            g = compress(g)
        return loss, g

    def bucket(grads, loss, rows):
        if ms.fsdp is None or rows is None:
            return _bucket_mean(grads, loss, rows)
        rest = tuple(a for a in rows.names if a not in ms.fsdp.names)
        return _bucket_mean(grads, loss, rows, ms.data_cut,
                            mesh.axis(rest) if rest else None)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = micro_grads(params, batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                 device=p.device), params)
            losses = []
            for i in range(accum_steps):
                loss_mb, g = micro_grads(params,
                                         {k: v[i] for k, v in micro.items()})
                acc = tree_map(lambda a, gi: a + gi.to(a.dtype), acc, g)
                losses.append(loss_mb)
            grads = tree_map(lambda g: (g / accum_steps).to(torch.float32),
                             acc)
            loss = torch.stack(losses).mean()
        kw = {}
        if ms is not None:
            if not (grad_compress_bits and accum_steps > 1):
                b = next(iter(batch.values())).shape[0] if global_batch is \
                    None else global_batch
                grads, loss = bucket(grads, loss,
                                     ms.shard(b // accum_steps)[1])
                grads = compress(grads)
            kw = {"specs": ms.specs, "mesh": mesh}
        new_params, new_opt_state, gnorm = opt.update(grads, opt_state,
                                                      params, **kw)
        return new_params, new_opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_fn(model: Model, s_max: int, shard=None):
    """``prefill(params, batch)``; ``shard``: the rank's StepSharding over
    a mesh (its params and rows), None on one device."""
    kw = {} if shard is None else {"shard": shard}

    def prefill_fn(params, batch):
        return model.prefill(params, batch, s_max, **kw)
    return prefill_fn


def make_decode_fn(model: Model, shard=None):
    """``decode(params, token, cache, pos)``; ``shard``: the rank's
    StepSharding over a mesh (:func:`step_sharding`), None on one
    device."""
    kw = {} if shard is None else {"shard": shard}

    def decode_fn(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, **kw)
    return decode_fn


def step_sharding(cfg, mesh, b: int, cache_specs=None) -> StepSharding:
    """The StepSharding of a serving step of ``b`` global rows over
    ``mesh``: the model axis where tensor parallelism applies, the row
    axes (``_batch_axes``), and for a decode step whose cache is cut by
    ``cache_specs`` the axes its sequence is cut over (``cache_specs`` cuts
    it over the data axes when the rows do not divide them, or over
    'model' under ``kv_seq_shard``), one mechanism for both."""
    axes = shd._batch_axes(cfg, mesh, b)
    seq = None if cache_specs is None else shd.seq_axes(cache_specs, mesh)
    return StepSharding(
        mesh, tp=None if shd.pure_dp(cfg, mesh) else mesh.axis("model"),
        rows=mesh.axis(axes) if axes else None,
        seq=mesh.axis(seq) if seq else None)

"""Step functions — ``repro.launch.steps``'s, for the port's ``Model``:

  make_train_step(model, opt, mesh=None) -> train_step(params, opt_state,
                                                       batch)
  make_prefill_fn(model, s_max) -> prefill(params, batch)      (serving)
  make_decode_fn(model)        -> decode(params, token, cache, pos)

The reference's functions are pure and ``jax.jit`` lowers them, over a mesh
with ``in_shardings``; here they run eagerly: a train step takes its
gradients with autograd (one backward pass per microbatch) and returns new
tensors, leaving its inputs as they were.  Over a mesh (one process a rank,
``launch.mesh``) the step holds this rank's slices of the params and the
optimizer state and takes this rank's rows of each microbatch, as the
reference's ``micro_shardings`` keep them; the collectives in the model
carry the gradients (``parallel.comm``), and one f32 bucket a step
all-reduces the gradients over the data axes.
"""
from __future__ import annotations

import torch

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
    s = torch.clamp_min(amax, 1e-12) / qmax
    q = torch.clamp(torch.round(g / s), -qmax, qmax).to(torch.int8)
    return q.to(torch.float32) * s


class _MeshStep:
    """What a train step over ``mesh`` needs: the params' specs (from
    their global shapes, ``model.init`` on the meta device), the model axis
    when tensor parallelism applies, and the row axes of a microbatch of
    ``b`` global rows (``parallel.sharding._batch_axes``)."""

    def __init__(self, model: Model, mesh):
        self.mesh = mesh
        self.cfg = model.cfg
        self.specs = shd.param_specs(
            model.init(torch.Generator(), "meta"), model.cfg, mesh)
        self.tp = None if shd.pure_dp(model.cfg, mesh) \
            else mesh.axis("model")

    def shard(self, b: int):
        """(StepSharding of a microbatch of ``b`` global rows, its row
        axis or None)."""
        axes = shd._batch_axes(self.cfg, self.mesh, b)
        rows = self.mesh.axis(axes) if axes else None
        return StepSharding(self.mesh, tp=self.tp, rows=rows,
                            global_rows=True), rows

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


def _bucket_mean(grads, loss, rows):
    """The gradients and the loss averaged over the row axes in one
    all-reduce of a flat f32 bucket (leaves in tree order, the loss last);
    returned in the gradients' dtypes."""
    if rows is None:
        return grads, loss
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in leaves]
                     + [loss.reshape(1).to(torch.float32)])
    flat = rows.all_reduce_sum(flat) / rows.size
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return tree_unflatten(grads, out), flat[at]


def make_train_step(model: Model, opt, grad_compress_bits: int = 0,
                    accum_steps: int = 1, accum_dtype=torch.float32,
                    mesh=None):
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
    (with ``accum_steps`` > 1, one bucket a microbatch)."""
    ms = None if mesh is None else _MeshStep(model, mesh)

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
        shard, rows = ms.shard(next(iter(batch.values())).shape[0])
        loss, g = grads_of(params, _local_rows(batch, rows), shard)
        if grad_compress_bits and accum_steps > 1:
            g, loss = _bucket_mean(g, loss, rows)
            g = compress(g)
        return loss, g

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
                b = next(iter(batch.values())).shape[0] // accum_steps
                grads, loss = _bucket_mean(grads, loss, ms.shard(b)[1])
                grads = compress(grads)
            kw = {"specs": ms.specs, "mesh": mesh}
        new_params, new_opt_state, gnorm = opt.update(grads, opt_state,
                                                      params, **kw)
        return new_params, new_opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_fn(model: Model, s_max: int):
    def prefill_fn(params, batch):
        return model.prefill(params, batch, s_max)
    return prefill_fn


def make_decode_fn(model: Model):
    def decode_fn(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos)
    return decode_fn

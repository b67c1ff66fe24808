"""Optimizers — ``repro.optim``'s, in the same functional form over the
port's parameter trees (nested dicts / lists / tuples of tensors):

  adamw     — baseline.
  adafactor — factored second moment (rank-1 outer product): O(n+m) state per
              (n, m) matrix.
  adam8bit  — Adam with int8-quantized moments + per-tensor scales: the
              paper's low-bit storage trick applied to optimizer state.

Each optimizer exposes ``init(params) -> state``,
``update(grads, state, params, specs=None, mesh=None) -> (new_params,
new_state, grad_norm)``, which runs under ``torch.no_grad()`` and returns
new tensors (nothing is updated in place), and ``state_specs(param_specs)``,
the reference's: the state's specs, congruent with the params'
(``parallel.sharding.param_specs``), so ``shard_tree`` cuts a state as it
cuts the params.  The update formulas are the reference's, written out op
for op in the same order (``torch.optim.AdamW`` orders its update
otherwise); the step ``count`` is int32 and the bias corrections are taken
in float32 (``b ** float32(count)``), as the reference takes them.

Over a mesh (``specs``, the params' specs, and ``mesh``, the rank's mesh)
the params, gradients and state hold this rank's slices, and whatever the
reference reduces over a whole leaf is reduced over the ranks the leaf is
cut over: the gradient norm (each cut leaf's sum of squares summed over
its axes, a replicated leaf counted once), adam8bit's per-tensor absmax
(a max), adafactor's factored means and its update-clipping RMS (sums).
The gradients given are the global batch's (``launch.steps`` all-reduces
them first), so ranks that hold the same slice compute the same update.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch.core.quantize import true_div
from repro_torch.parallel.sharding import cut_axes
from repro_torch.tree import tree_leaves, tree_leaves_along, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state, gnorm)
    state_specs: Callable     # param specs -> state specs


def _map_specs(fn, specs):
    """``fn`` over the spec tuples of a tree of specs (nested dicts)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _cut(spec, mesh):
    """The mesh axis (``Axis``, flattened) a leaf of ``spec`` is cut over,
    else None."""
    axes = cut_axes(spec, mesh)
    return mesh.axis(axes) if axes else None


def _dim_axis(spec, dim: int, mesh):
    """The mesh axis (``Axis``) dim ``dim`` of a leaf is cut over, else
    None."""
    return None if spec is None else _cut((spec[dim],), mesh)


def _mean(t, dim: int, axis, full: int):
    """``t.mean(dim)``; with ``axis`` (``dim`` cut over it) the sum over
    the axis of each rank's sum, over the whole dim's ``full`` entries."""
    if axis is None:
        return t.mean(dim=dim)
    return axis.all_reduce_sum(t.sum(dim=dim)) / full


def _with_specs(tree, specs):
    """[(leaf, spec)] in tree order (spec None without ``specs``)."""
    leaves = tree_leaves(tree)
    if specs is None:
        return [(x, None) for x in leaves]
    return list(zip(leaves, tree_leaves_along(tree, specs)))


def _unzip(out, params, n: int):
    """``out``, a tree of per-leaf n-tuples along ``params``'s structure
    (what ``tree_map`` of an update returns) -> n trees."""
    return tuple(tree_map(lambda _, o, i=i: o[i], params, out)
                 for i in range(n))


def _global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in tree order, of each leaf's f32 sum
    of squares.  Over a mesh the leaves cut over the same axes are summed
    apart, and each such sum over its axes (one all-reduce an axis set),
    after the replicated leaves."""
    total, cut = 0, {}
    for x, spec in _with_specs(tree, specs):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        axes = cut_axes(spec, mesh)
        if axes:
            cut[axes] = cut.get(axes, 0) + sq
        else:
            total = total + sq
    for axes, sq in cut.items():
        total = total + mesh.axis(axes).all_reduce_sum(sq)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    norm = _global_norm(grads, specs, mesh)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    c = count.to(torch.float32)
    return 1 - b1 ** c, 1 - b2 ** c


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, specs=None, mesh=None):
        grads, gnorm = _clip_by_global_norm(grads, grad_clip, specs, mesh)
        count = state["count"] + 1
        c1, c2 = _bias_corrections(count, b1, b2)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            step = step + lr * weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - step).to(p.dtype), m, v

        out = tree_map(upd, grads, state["m"], state["v"], params)
        new_params, new_m, new_v = _unzip(out, params, 3)
        return new_params, {"m": new_m, "v": new_v, "count": count}, gnorm

    def state_specs(pspecs, params=None):
        return {"m": pspecs, "v": pspecs, "count": ()}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------
def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              grad_clip: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def vstate(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": tree_map(vstate, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, specs=None, mesh=None):
        grads, gnorm = _clip_by_global_norm(grads, grad_clip, specs, mesh)
        count = state["count"] + 1
        beta = 1.0 - count.to(torch.float32) ** -decay

        def upd(g, vs, p, spec=None):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p):
                n_ax = _dim_axis(spec, -1, mesh)        # N's axis, K's
                k_ax = _dim_axis(spec, -2, mesh)
                n = g.shape[-1] * (1 if n_ax is None else n_ax.size)
                k = g.shape[-2] * (1 if k_ax is None else k_ax.size)
                vr = beta * vs["vr"] + (1 - beta) * _mean(g2, -1, n_ax, n)
                vc = beta * vs["vc"] + (1 - beta) * _mean(g2, -2, k_ax, k)
                vr_mean = vr.mean(dim=-1, keepdim=True) if k_ax is None \
                    else k_ax.all_reduce_sum(vr.sum(dim=-1, keepdim=True)) / k
                rms = (vr[..., None] * vc[..., None, :]) / vr_mean[..., None]
                step = g * torch.rsqrt(rms + eps)
                new_vs = {"vr": vr, "vc": vc}
            else:
                v = beta * vs["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(v + eps)
                new_vs = {"v": v}
            # update clipping (Adafactor RMS rule)
            cut = _cut(spec, mesh)
            if cut is None:
                ms = torch.mean(step * step)
            else:
                ms = cut.all_reduce_sum(torch.sum(step * step)) / \
                    (step.numel() * cut.size)
            d = torch.clamp_min(torch.sqrt(ms), 1.0)
            step = lr * step / d
            if weight_decay:
                step = step + lr * weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - step).to(p.dtype), new_vs

        rest = () if specs is None else (specs,)
        new_params, new_v = _unzip(tree_map(upd, grads, state["v"], params,
                                            *rest), params, 2)
        return new_params, {"v": new_v, "count": count}, gnorm

    def state_specs(pspecs, params=None):
        def vspec(spec):
            if len(spec) >= 2:
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"v": _map_specs(vspec, pspecs), "count": ()}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# 8-bit Adam — int8 moments with per-tensor scales (paper-thematic)
# ---------------------------------------------------------------------------
def adam8bit(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
             eps: float = 1e-8, grad_clip: float = 1.0,
             weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def q(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.ones((), dtype=torch.float32,
                                    device=p.device) * 1e-8}
        return {"m": tree_map(q, params), "v": tree_map(q, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    def _deq(qs):
        return qs["q"].to(torch.float32) * qs["s"]

    def _q(x, cut=None):
        amax = x.abs().max()
        if cut is not None:
            amax = cut.all_reduce_max(amax)
        s = true_div(torch.clamp_min(amax, 1e-8), 127.0)
        # round half to even, as jnp.round; the int8 cast of an in-range
        # integral float is exact in both packages
        return {"q": torch.clamp(torch.round(x / s), -127, 127
                                 ).to(torch.int8), "s": s}

    @torch.no_grad()
    def update(grads, state, params, specs=None, mesh=None):
        grads, gnorm = _clip_by_global_norm(grads, grad_clip, specs, mesh)
        count = state["count"] + 1
        c1, c2 = _bias_corrections(count, b1, b2)

        def upd(g, mq, vq, p, spec=None):
            g = g.to(torch.float32)
            m = b1 * _deq(mq) + (1 - b1) * g
            v = b2 * _deq(vq) + (1 - b2) * g * g
            step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.to(torch.float32)
            cut = _cut(spec, mesh)
            return ((p.to(torch.float32) - step).to(p.dtype), _q(m, cut),
                    _q(v, cut))

        rest = () if specs is None else (specs,)
        out = tree_map(upd, grads, state["m"], state["v"], params, *rest)
        new_params, new_m, new_v = _unzip(out, params, 3)
        return new_params, {"m": new_m, "v": new_v, "count": count}, gnorm

    def state_specs(pspecs, params=None):
        def qspec(spec):
            return {"q": spec, "s": ()}
        return {"m": _map_specs(qspec, pspecs), "v": _map_specs(qspec, pspecs),
                "count": ()}

    return Optimizer(init, update, state_specs)


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "adam8bit": adam8bit}


def make_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)

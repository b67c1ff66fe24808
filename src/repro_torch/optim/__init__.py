"""Optimizers — ``repro.optim``'s, in the same functional form over the
port's parameter trees (nested dicts / lists / tuples of tensors):

  adamw     — baseline.
  adafactor — factored second moment (rank-1 outer product): O(n+m) state per
              (n, m) matrix.
  adam8bit  — Adam with int8-quantized moments + per-tensor scales: the
              paper's low-bit storage trick applied to optimizer state.

Each optimizer exposes ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state, grad_norm)``,
which runs under ``torch.no_grad()`` and returns new tensors (nothing is
updated in place).  The update formulas are the reference's, written out
op for op in the same order (``torch.optim.AdamW`` orders its update
otherwise); the step ``count`` is int32 and the bias corrections are taken
in float32 (``b ** float32(count)``), as the reference takes them.  The
reference's ``state_specs`` (the optimizer state's shardings over a mesh)
is not ported: the port trains on one device (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state, gnorm)


def _unzip(out, params, n: int):
    """``out``, a tree of per-leaf n-tuples along ``params``'s structure
    (what ``tree_map`` of an update returns) -> n trees."""
    return tuple(tree_map(lambda _, o, i=i: o[i], params, out)
                 for i in range(n))


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in tree order, of each leaf's f32 sum
    of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(grads)
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
    def update(grads, state, params):
        grads, gnorm = _clip_by_global_norm(grads, grad_clip)
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

    return Optimizer(init, update)


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
    def update(grads, state, params):
        grads, gnorm = _clip_by_global_norm(grads, grad_clip)
        count = state["count"] + 1
        beta = 1.0 - count.to(torch.float32) ** -decay

        def upd(g, vs, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p):
                vr = beta * vs["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * vs["vc"] + (1 - beta) * g2.mean(dim=-2)
                rms = (vr[..., None] * vc[..., None, :]) / \
                    vr.mean(dim=-1, keepdim=True)[..., None]
                step = g * torch.rsqrt(rms + eps)
                new_vs = {"vr": vr, "vc": vc}
            else:
                v = beta * vs["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(v + eps)
                new_vs = {"v": v}
            # update clipping (Adafactor RMS rule)
            d = torch.clamp_min(torch.sqrt(torch.mean(step * step)), 1.0)
            step = lr * step / d
            if weight_decay:
                step = step + lr * weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - step).to(p.dtype), new_vs

        new_params, new_v = _unzip(tree_map(upd, grads, state["v"], params),
                                   params, 2)
        return new_params, {"v": new_v, "count": count}, gnorm

    return Optimizer(init, update)


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

    def _q(x):
        s = torch.clamp_min(x.abs().max(), 1e-8) / 127.0
        # round half to even, as jnp.round; the int8 cast of an in-range
        # integral float is exact in both packages
        return {"q": torch.clamp(torch.round(x / s), -127, 127
                                 ).to(torch.int8), "s": s}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = _clip_by_global_norm(grads, grad_clip)
        count = state["count"] + 1
        c1, c2 = _bias_corrections(count, b1, b2)

        def upd(g, mq, vq, p):
            g = g.to(torch.float32)
            m = b1 * _deq(mq) + (1 - b1) * g
            v = b2 * _deq(vq) + (1 - b2) * g * g
            step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - step).to(p.dtype), _q(m), _q(v))

        out = tree_map(upd, grads, state["m"], state["v"], params)
        new_params, new_m, new_v = _unzip(out, params, 3)
        return new_params, {"m": new_m, "v": new_v, "count": count}, gnorm

    return Optimizer(init, update)


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "adam8bit": adam8bit}


def make_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)

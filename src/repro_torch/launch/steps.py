"""Step functions — ``repro.launch.steps``'s, for the port's ``Model``:

  make_train_step(model, opt)  -> train_step(params, opt_state, batch)
  make_prefill_fn(model, s_max) -> prefill(params, batch)      (serving)
  make_decode_fn(model)        -> decode(params, token, cache, pos)

The reference's functions are pure and ``jax.jit`` lowers them; here they
run eagerly: a train step takes its gradients with autograd (one backward
pass per microbatch) and returns new tensors, leaving its inputs as they
were.  The reference's ``micro_shardings`` (the microbatches' sharding over
a mesh) is not ported: the port trains on one device (ROADMAP Queue A
item 9).
"""
from __future__ import annotations

import torch

from repro_torch.models import Model
from repro_torch.tree import tree_leaves, tree_map


def _compress(g: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor symmetric int quantization of a gradient, dequantized:
    what the reference's int8 gradient channel carries."""
    qmax = (1 << (bits - 1)) - 1
    s = torch.clamp_min(g.abs().max(), 1e-12) / qmax
    q = torch.clamp(torch.round(g / s), -qmax, qmax).to(torch.int8)
    return q.to(torch.float32) * s


def make_train_step(model: Model, opt, grad_compress_bits: int = 0,
                    accum_steps: int = 1, accum_dtype=torch.float32):
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
    bandwidth saving applied to the gradient channel."""

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        loss = model.loss(leaves, batch)
        wrt = [p for p in tree_leaves(leaves) if p.requires_grad]
        got = dict(zip(map(id, wrt), torch.autograd.grad(
            loss, wrt, allow_unused=True)))

        def grad(p):           # a leaf the loss does not reach gets zeros
            g = got.get(id(p))
            g = torch.zeros_like(p) if g is None else g
            return _compress(g, grad_compress_bits) if grad_compress_bits \
                else g
        return loss.detach(), tree_map(grad, leaves)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                 device=p.device), params)
            losses = []
            for i in range(accum_steps):
                loss_mb, g = grads_of(params,
                                      {k: v[i] for k, v in micro.items()})
                acc = tree_map(lambda a, gi: a + gi.to(a.dtype), acc, g)
                losses.append(loss_mb)
            grads = tree_map(lambda g: (g / accum_steps).to(torch.float32),
                             acc)
            loss = torch.stack(losses).mean()
        new_params, new_opt_state, gnorm = opt.update(grads, opt_state,
                                                      params)
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

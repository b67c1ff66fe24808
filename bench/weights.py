"""Float weights and BNS parameters drawn on the card from the run's seed.

A configuration lists its leaves as ``(key, group, shape, std)``.  Each
group is drawn in one call on a generator of the run's device, seeded from
``--seed``, and split into views: the quantized layers' weights (standard
normal times their std), the f32 head, and the BNS gamma and beta
(uniform in the configuration's ranges).  Drawing again with the same seed
gives the same tensors bit for bit, so the reference is handed what the
program was handed without keeping a copy on the card during the window.
"""
from __future__ import annotations

import torch

GROUPS = ("weight", "head", "gamma", "beta")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream (0 weights, 1 inputs) of a
    seed; any whole number is taken modulo 2**64."""
    mixed = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % 2**64
    return torch.Generator(device=device).manual_seed(mixed)


def draw(leaves, cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{key: tensor}`` for ``leaves`` [(key, group, shape, std)], f32."""
    gen = generator(seed, 0, device)
    out = {}
    for group in GROUPS:
        mine = [lf for lf in leaves if lf[1] == group]
        sizes = [_numel(lf[2]) for lf in mine]
        total = sum(sizes)
        if total == 0:
            continue
        if group in ("weight", "head"):
            flat = torch.randn(total, generator=gen, device=device,
                               dtype=torch.float32)
        else:
            lo, hi = cfg["bns_" + group]
            flat = torch.rand(total, generator=gen, device=device,
                              dtype=torch.float32) * (hi - lo) + lo
        for (key, _, shape, std), part in zip(mine, flat.split(sizes)):
            t = part.view(shape)
            if std is not None:
                t.mul_(std)
            out[key] = t
    return out


def checksum(tensors: dict[str, torch.Tensor]) -> float:
    """One float64 sum over every tensor, to hold a second draw to the
    first."""
    return float(sum(t.double().sum() for t in tensors.values()))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def unflatten(flat: dict[str, torch.Tensor]) -> dict:
    """Dotted keys to the port's param tree: ``"conv.0.qw"`` becomes
    ``tree["conv"][0]["qw"]`` (a numeric part indexes a list)."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part, nxt in zip(parts, parts[1:]):
            child = [] if nxt.isdigit() else {}
            if part.isdigit():
                i = int(part)
                while len(node) <= i:
                    node.append(None)
                if node[i] is None:
                    node[i] = child
                node = node[i]
            else:
                node = node.setdefault(part, child)
        node[parts[-1]] = value
    return root


def layer_leaves(keyed_layers):
    """(key, group, shape, std) of every float leaf of ``[(key, layer)]``
    (``costs.Layer``): a quantized layer's (K, N) weight, He normal, and
    its BNS gamma and beta; the f32 head's weight, std K ** -0.5."""
    out = []
    for key, layer in keyed_layers:
        if not layer.quantized:
            out.append((f"{key}.qw", "head", (layer.k, layer.n),
                        layer.k ** -0.5))
            continue
        out.append((f"{key}.qw", "weight", (layer.k, layer.n),
                    (2.0 / layer.k) ** 0.5))
        out.append((f"{key}.bns_gamma", "gamma", (layer.n,), None))
        out.append((f"{key}.bns_beta", "beta", (layer.n,), None))
    return out

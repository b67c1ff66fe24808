"""The one traffic generator: every mix is a data file
``traffic/<mix>.json`` that this reads.

A mix today is a closed loop: one client sends a batch, waits for its
logits on the host, and sends the next, cycling a pool of input batches
that are drawn on the card from the run's seed (standard normal values,
the normalised pixels of NHWC float32 images).  Keys:

- ``loop`` ("closed") and ``clients`` (1): the only loop this drives;
- ``batch``: images a batch;
- ``pool_batches``: distinct input batches, cycled in order;
- ``warmup_s``: seconds of batches run in set-up, before the window;
- ``trace_batches``: batches in the traced slice of a ``--trace 1`` run;
- ``sample_batches``: batches of the window whose logits are compared
  with the reference, drawn from the seed (a reservoir sample);
- ``why``: one line on what the mix stands for.
"""
from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path

import weights

KEYS = {"loop", "clients", "batch", "pool_batches", "images", "warmup_s",
        "trace_batches", "sample_batches", "why"}


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    batch: int
    pool_batches: int
    warmup_s: float
    trace_batches: int
    sample_batches: int


def load(path: Path) -> Mix:
    d = json.loads(Path(path).read_text(encoding="utf-8"))
    if set(d) != KEYS:
        raise ValueError(f"{path}: keys {sorted(d)}, not {sorted(KEYS)}")
    if d["loop"] != "closed" or d["clients"] != 1 or \
            d["images"] != "standard_normal":
        raise ValueError(f"{path}: this generator drives one client in a "
                         "closed loop on standard normal images")
    return Mix(Path(path).stem, int(d["batch"]), int(d["pool_batches"]),
               float(d["warmup_s"]), int(d["trace_batches"]),
               int(d["sample_batches"]))


def make_pool(mix: Mix, input_shape, seed: int, device) -> list:
    """``pool_batches`` input batches (batch, H, W, C), drawn in one call."""
    import torch
    gen = weights.generator(seed, 1, device)
    flat = torch.randn((mix.pool_batches * mix.batch, *input_shape),
                       generator=gen, device=device, dtype=torch.float32)
    return list(flat.split(mix.batch))


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a seed;
    the offers need not be counted in advance."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n = k, random.Random(seed), 0
        self.items: dict[int, object] = {}

    def offer(self, index: int, item) -> None:
        if len(self.items) < self.k:
            self.items[index] = item
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                del self.items[sorted(self.items)[j]]
                self.items[index] = item
        self.n += 1

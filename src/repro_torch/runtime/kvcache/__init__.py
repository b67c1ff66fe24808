"""Paged, quantized KV cache with radix-prefix sharing
(``repro.runtime.kvcache``).

  * :mod:`pool` — a refcounted pool of fixed-size physical blocks with a
    free list; block 0 is the reserved null block.
  * :mod:`radix` — a radix tree over block-granular token prefixes:
    requests sharing a prompt prefix reference the same physical blocks
    (only full, immutable blocks are shared) and skip that part of
    prefill; unreferenced cached blocks are evicted LRU under pressure.
  * :mod:`batcher` — :class:`PagedBatcher`, the continuous batcher whose KV
    state is the pool + per-slot page tables, with lazy block allocation,
    preemption by recompute, kv_bits 16/8/4 block storage, and
    self-speculative decoding (a low-bit draft, a windowed float verify).

The attention through the page table lives in
:mod:`repro_torch.kernels.paged_attention` and
:mod:`repro_torch.kernels.decode_fused`, dispatched through
:mod:`repro_torch.kernels.engine`.
"""
from .batcher import (PagedBatcher, paged_block_bytes,  # noqa: F401
                      paged_capacity_blocks)
from .pool import BlockPool  # noqa: F401
from .radix import RadixPrefixCache  # noqa: F401

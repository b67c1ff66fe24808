"""Radix prefix cache over block-granular token sequences
(``repro.runtime.kvcache.radix``, ported as it is: host-side numpy).

A tree whose edges are ``block_size``-token runs: a node at depth d caches
the physical block holding positions [(d-1)*bs, d*bs) of every sequence that
shares the token prefix spelled by the path to it.  Admission walks the tree
with the new prompt (``match``) and reuses the matched blocks instead of
re-prefilling them; completed prefills register their full blocks
(``insert``) so later requests can hit them.

Nodes carry a **kind**: ``suffix=False`` for blocks whose tokens come from a
request's prompt (prefill-computed), ``suffix=True`` for blocks past the
prompt — KV the request *generated* and registered at release or preemption
(``insert(..., suffix_from=...)``).  The split feeds the serving metrics
(prompt-prefix hits vs generated-suffix hits) and lets agent-style
multi-turn prompts (old prompt + old generation + new turn) and
preemption-recompute prefills reuse decode-written KV.  Inserting a
generated extension under an existing leaf is just a deeper insert: the
shared prompt path already exists, only the suffix nodes are new.

Sharing discipline (the copy-on-write rule made trivial): only FULL blocks
are ever registered, and full blocks are immutable — a request appends only
into blocks past its matched prefix, which it owns exclusively.  So there is
never a write to a shared block, and "copy" on write is simply "the
remainder is prefilled into fresh blocks".

The tree holds one pool reference per registered block.  Under pool
pressure, ``evict`` walks leaves in LRU order (``last_used`` is a logical
clock bumped on every match) and drops their references — blocks still
referenced by an active request survive the node removal; truly cold blocks
return to the free list.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from .pool import BlockPool


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used", "suffix")

    def __init__(self, key: bytes | None, block: int,
                 parent: "_Node" | None, suffix: bool = False):
        self.key = key                     # bytes of this edge's bs tokens
        self.block = block                 # physical block id (-1 for root)
        self.children: dict[bytes, _Node] = {}
        self.parent = parent
        self.last_used = 0
        self.suffix = suffix               # generated-suffix (vs prompt) KV


class RadixPrefixCache:
    def __init__(self, pool: BlockPool, block_size: int):
        self.pool = pool
        self.block_size = block_size
        self.root = _Node(None, -1, None)
        self._clock = 0
        self._n_nodes = 0

    def __len__(self) -> int:
        """Registered (cached) blocks."""
        return self._n_nodes

    def blocks(self) -> Iterator[int]:
        """Every physical block id the tree currently holds a reference to
        (one per node) — the radix side of ``BlockPool.check``."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n.block
            stack.extend(n.children.values())

    def _keys(self, tokens: np.ndarray) -> list[bytes]:
        bs = self.block_size
        t = np.asarray(tokens, np.int32).reshape(-1)
        return [t[i:i + bs].tobytes() for i in range(0, len(t) // bs * bs, bs)]

    # ------------------------------------------------------------------ match
    def match(self, tokens: np.ndarray) -> list[int]:
        """Physical block ids of the longest cached block-aligned prefix of
        ``tokens``.  Bumps the matched path's LRU clock.  The caller must
        ``pool.acquire`` each returned block before anything else can evict
        it."""
        return [bid for bid, _ in self.match_with_kinds(tokens)]

    def match_with_kinds(self, tokens: np.ndarray) -> list[tuple[int, bool]]:
        """Like :meth:`match` but each block id comes with its node's
        ``suffix`` flag, so the caller can split prompt-prefix hits from
        generated-suffix hits in the metrics."""
        self._clock += 1
        node, out = self.root, []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            out.append((child.block, child.suffix))
            node = child
        return out

    # ----------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, block_ids: list[int],
               suffix_from: int | None = None) -> int:
        """Register ``block_ids`` as the cache of ``tokens``' full blocks
        (``len(block_ids)`` leading blocks).  Existing nodes win on conflict
        (two requests prefilled the same prompt concurrently — the duplicate
        blocks simply stay owned by their request and free on its release),
        and an existing node keeps its kind.  Blocks at index >=
        ``suffix_from`` are marked generated-suffix (decode-written KV);
        ``None`` marks everything as prompt.  Returns the number of NEW
        nodes (pool references taken)."""
        self._clock += 1
        node, added = self.root, 0
        for depth, (key, bid) in enumerate(zip(self._keys(tokens), block_ids)):
            child = node.children.get(key)
            if child is None:
                self.pool.acquire(bid)
                child = _Node(key, bid, node,
                              suffix=(suffix_from is not None
                                      and depth >= suffix_from))
                node.children[key] = child
                self._n_nodes += 1
                added += 1
            child.last_used = self._clock
            node = child
        return added

    # ------------------------------------------------------------------ evict
    def _leaves(self) -> list[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evict(self, n_blocks: int, freeable_only: bool = False) -> int:
        """Drop up to ``n_blocks`` cache references, coldest leaves first
        (evicting a leaf may expose its parent as the next candidate).
        Returns how many references were dropped; the pool frees each block
        whose last reference this was.

        ``freeable_only`` (pool-pressure allocation) skips leaves whose
        block an active request still holds: dropping those frees nothing,
        and a held child block implies a held parent block (the holder's
        page table spans its whole prefix chain), so skipping them never
        hides a freeable ancestor — while the cold-but-shared subtree
        survives for the holders' future re-admissions."""
        dropped = 0
        while dropped < n_blocks:
            leaves = self._leaves()
            if freeable_only:
                leaves = [l for l in leaves
                          if self.pool.refcount(l.block) == 1]
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.last_used)
            for leaf in leaves:
                if dropped >= n_blocks:
                    break
                del leaf.parent.children[leaf.key]
                self.pool.release(leaf.block)
                self._n_nodes -= 1
                dropped += 1
        return dropped

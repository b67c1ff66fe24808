"""B2 / B4 on the CPU: the work split and merge order of the paged
flash-decode core (``csrc/paged_common.cuh``, ``paged_attention.cu``,
``decode_fused.cu``) replayed in numpy.

(i) The kernels' decode of 16-byte K/V vectors: kv4 nibbles from uint32
words (element j of a word = its nibble j, sign-extended by shifts) and
int8 codes from words, bit for bit against ``packing.unpack_nibbles`` and
the bytes themselves, over every byte value.

(ii) B2's split: positions cut into spans of whole pool blocks (at most 8,
16 or 32 positions, ``pa_span``; the launch plan ``pa_plan`` picks the
cluster size and span); worker w (warp w % 8 of cluster rank w // 8) takes
spans w, w + W, ... with its own online softmax (K's scale multiplies the
code dot product); the warps' partials merge in ascending warp order, the
ranks' in ascending rank order.  At the automatic plan and at cluster sizes
1 and 2.

(iii) B4's split: a cluster of 8 ranks per live slot, rank r computing KV
head r % KV over its part r // KV of the positions (KV > 8: heads r, r + 8,
...); each head's parts merge in ascending order; rank r projects its
contiguous eighth of the K = KV*G*Dh rows of ``wo`` onto every column (its
rows cut into contiguous chunks over its 8 warps, each summed in ascending
row order, the warps' sums in order), and the ranks' sums of a column are
added in ascending rank order.

Held against the port's ``paged_attention_ref`` / ``fused_decode_ref`` and
the JAX Pallas ``paged_attention`` / ``fused_decode`` in interpret mode and
their jnp oracles.  Tolerance: atol 1e-5 + rtol 1e-5 in f32 — the same
products summed in another order.  Cases: kv 16/8/4 x bs 5/8/16; pos 0, pos
at n_blocks*bs - 1, pos past n_blocks*bs; spans wholly past pos (most
workers of a cluster have none); a live block id >= NB and a dead one < 0
(the kernels read the null block 0 for both: the references get a table
with those ids set to 0); a repeated slot, whose rows are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core.packing import pack_nibbles  # noqa: E402
from repro.kernels import decode_fused as jfused  # noqa: E402
from repro.kernels import paged_attention as jpaged  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import decode_fused as tfused  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = np.float32
U32 = np.uint32
NW = 8                 # warps (workers) a block: PA_NW
SPAN = 16              # PA_SPAN
FD_CLUSTER = 8         # B4's cluster size
B, KV, G, DH = 4, 2, 2, 32


# ---------------------------------------------------------------------------
# (i) the 16-byte vector decode
def decode_words(words: np.ndarray, kv_bits: int) -> np.ndarray:
    """``pa_decode``: uint32 words -> int32 codes, 8 nibbles (kv4) or 4
    bytes (kv8) a word, low bits first, sign-extended by a left shift to
    the top of an int32 and an arithmetic right shift."""
    per, width = (8, 4) if kv_bits == 4 else (4, 8)
    out = []
    for j in range(per):
        top = (words << U32(32 - width - width * j)).astype(np.int32)
        out.append(top >> np.int32(32 - width))
    return np.stack(out, axis=-1).reshape(*words.shape[:-1], -1)


def test_kv4_word_decode_matches_unpack_nibbles():
    """Every byte value, as 16-byte vectors of four words."""
    raw = np.arange(256, dtype=np.uint8)
    raw = np.concatenate([raw, raw[::-1]]).reshape(-1, 16)     # 32 vectors
    want = packing.unpack_nibbles(torch.from_numpy(raw.view(np.int8))).numpy()
    got = decode_words(raw.view("<u4"), 4)
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_int8_word_decode_matches_bytes():
    raw = np.arange(256, dtype=np.uint8).reshape(-1, 16)
    got = decode_words(raw.view("<u4"), 8)
    np.testing.assert_array_equal(got, raw.view(np.int8).astype(np.int32))


# ---------------------------------------------------------------------------
# (ii) the paged core
def pa_span(bs: int, span_max: int = SPAN) -> int:
    return (span_max // bs) * bs if bs <= span_max else span_max


def pa_auto_span(bs: int, n_ctx: int, workers: int) -> int:
    """The shortest span (limit 8, 16, 32) giving no worker two spans, else
    the longest."""
    for limit in (8, 16):
        if -(-n_ctx // pa_span(bs, limit)) <= workers:
            return pa_span(bs, limit)
    return pa_span(bs, 32)


def pa_plan(b: int, kv: int, n_ctx: int, bs: int) -> tuple[int, int]:
    """B2's (cluster size, span): one block of 16-position spans while no
    warp gets two, else 8 blocks (fewer past two blocks an SM).  The
    kernels' shared-memory cap on the span does not bind at these shapes."""
    if -(-n_ctx // pa_span(bs, SPAN)) <= NW:
        return 1, pa_span(bs, SPAN)
    c = 8
    while c > 1 and b * kv * c > 2 * 132:
        c //= 2
    return c, pa_auto_span(bs, n_ctx, NW * c)


def _codes(pool_row: np.ndarray, kv_bits: int) -> np.ndarray:
    """Stored row -> f32 codes (or raw values) as the kernel loads it."""
    if kv_bits == 16:
        return pool_row.astype(F32)
    if pool_row.nbytes % 16 == 0:                  # the 16-byte vector path
        return decode_words(np.ascontiguousarray(pool_row).view("<u4")[None],
                            kv_bits)[0].astype(F32)
    if kv_bits == 4:                               # the scalar path
        b = pool_row.astype(np.int32)
        lo, hi = (b << 28) >> 28, b >> 4
        return np.stack([lo, hi], -1).reshape(-1).astype(F32)
    return pool_row.astype(F32)


class Pool:
    """Row access of one KV head's pool as the kernel resolves it."""

    def __init__(self, k, ks, v, vs, pt_row, kh, kv_bits):
        self.k, self.ks, self.v, self.vs = k, ks, v, vs
        self.pt_row, self.kh, self.kv_bits = pt_row, kh, kv_bits
        self.nb, self.bs = k.shape[0], k.shape[1]

    def rows(self, s0: int, n: int):
        """(K codes, K scales, V values dequantized) of positions s0..s0+n."""
        kc, ksc, vv = [], [], []
        for s in range(s0, s0 + n):
            blk = int(self.pt_row[s // self.bs])
            blk = blk if 0 <= blk < self.nb else 0
            o = s % self.bs
            kc.append(_codes(self.k[blk, o, self.kh], self.kv_bits))
            vrow = _codes(self.v[blk, o, self.kh], self.kv_bits)
            if self.ks is None:
                ksc.append(F32(1))
                vv.append(vrow)
            else:
                ksc.append(F32(self.ks[blk, o, self.kh, 0]))
                vv.append(vrow * F32(self.vs[blk, o, self.kh, 0]))
        return np.stack(kc), np.array(ksc, F32), np.stack(vv)


def worker_partial(q, pool, n_valid, span, worker, n_workers):
    """``pa_warp_attend``: one warp's (m, l, acc) over its spans."""
    g, dh = q.shape
    m, l = np.full(g, -1e30, F32), np.zeros(g, F32)
    acc = np.zeros((g, dh), F32)
    div = F32(np.sqrt(F32(dh)))
    j = worker
    while j * span < n_valid:
        s0 = j * span
        n = min(span, n_valid - s0)
        kc, ksc, vv = pool.rows(s0, n)
        sc = ((q @ kc.T) * ksc) / div                       # (G, n)
        m_new = np.maximum(m, sc.max(axis=1))
        p = np.exp(sc - m_new[:, None]).astype(F32)
        corr = np.exp(m - m_new).astype(F32)
        l = l * corr + p.sum(axis=1, dtype=F32)
        acc = acc * corr[:, None] + p @ vv
        m = m_new
        j += n_workers
    return m, l, acc


def merge(parts):
    """Ascending-order merge of (m, l, acc) partials (``pa_cta_merge`` /
    ``pa_merge_ranks``); a partial with m = -1e30, l = 0 adds nothing."""
    M = np.max([p[0] for p in parts], axis=0)
    L = np.zeros_like(parts[0][1])
    A = np.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = np.exp(m - M).astype(F32)
        A = A + acc * f[:, None]
        L = L + l * f
    return M, L, A


def cluster_attend(q, pool, n_valid, span, ranks):
    """Unnormalised (m, l, acc) of one (sequence, head) over a cluster of
    ``ranks`` blocks of NW warps: warps merged per rank, then ranks."""
    n_workers = ranks * NW
    per_rank = [merge([worker_partial(q, pool, n_valid, span, r * NW + w,
                                      n_workers) for w in range(NW)])
                for r in range(ranks)]
    return merge(per_rank)


def n_valid_of(pos: int, n_blocks: int, bs: int) -> int:
    return max(0, min(pos + 1, n_blocks * bs))


def replay_paged_attention(q, k, ks, v, vs, pt, pos, kv_bits, cluster, span):
    b, kv, g, dh = q.shape
    out = np.zeros((b, kv, g, dh), F32)
    for bi in range(b):
        nv = n_valid_of(int(pos[bi]), pt.shape[1], k.shape[1])
        for h in range(kv):
            pool = Pool(k, ks, v, vs, pt[bi], h, kv_bits)
            _, L, A = cluster_attend(q[bi, h], pool, nv, span, cluster)
            out[bi, h] = A / np.maximum(L, F32(1e-30))[:, None]
    return out


# ---------------------------------------------------------------------------
# (iii) B4
def replay_fused_decode(q, k, ks, v, vs, pt, pos, slot_map, wo, kv_bits):
    b, kv, g, dh = q.shape
    gd, d = g * dh, wo.shape[1]
    kk = kv * gd
    n_parts_min = (FD_CLUSTER - 1 - (kv - 1)) // kv + 1 if kv <= FD_CLUSTER \
        else 1
    span = pa_auto_span(k.shape[1], pt.shape[1] * k.shape[1], NW * n_parts_min)
    out = np.zeros((len(slot_map), d), F32)
    nrg, kr = NW, -(-kk // FD_CLUSTER)
    for li, slot in enumerate(slot_map):
        nv = n_valid_of(int(pos[slot]), pt.shape[1], k.shape[1])
        x = np.zeros(kk, F32)
        for h in range(kv):
            pool = Pool(k, ks, v, vs, pt[slot], h, kv_bits)
            if kv <= FD_CLUSTER:                   # parts: ranks h + p*KV
                n_parts = (FD_CLUSTER - 1 - h) // kv + 1
                ranks = [merge([worker_partial(q[slot, h], pool, nv, span,
                                               p * NW + wi, n_parts * NW)
                                for wi in range(NW)]) for p in range(n_parts)]
            else:                                  # one rank, all its warps
                ranks = [merge([worker_partial(q[slot, h], pool, nv, span,
                                               wi, NW) for wi in range(NW)])]
            _, L, A = merge(ranks)
            x[h * gd:(h + 1) * gd] = (A / np.maximum(L, F32(1e-30))[:, None]
                                      ).reshape(-1)
        # rank r projects rows [r*kr, (r+1)*kr) onto every column: its
        # warps' contiguous chunks, each summed in ascending row order, then
        # the warps in order; the ranks' sums in ascending rank order
        total = np.zeros(d, F32)
        for r in range(FD_CLUSTER):
            r0, r1 = min(kk, r * kr), min(kk, (r + 1) * kr)
            cs = -(-(r1 - r0) // nrg)
            rank_sum = np.zeros(d, F32)
            for rg in range(nrg):
                acc = np.zeros(d, F32)
                for row in range(r0 + min(r1 - r0, rg * cs),
                                 r0 + min(r1 - r0, (rg + 1) * cs)):
                    acc = acc + x[row] * wo[row]
                rank_sum = rank_sum + acc
            total = total + rank_sum
        out[li] = total
    return out


# ---------------------------------------------------------------------------
def _inputs(kv_bits, bs, kv=KV, seed=0, n_ctx=80):
    """(q, k, ks, v, vs, page_table, pos) as numpy, with about ``n_ctx``
    positions a sequence.  pos: n_blocks*bs - 1, 0, one in block 1, and past
    n_blocks*bs.  Sequence 2's live block 1 has id NB + 3 (read as the null
    block); sequence 1's dead block 2 has id -1; sequences 0 and 3 share
    their first block."""
    rng = np.random.default_rng(seed)
    n_blocks = -(-n_ctx // bs)
    nb_pool = 2 + B * n_blocks
    q = rng.normal(size=(B, kv, G, DH)).astype(F32)
    n_ctx = n_blocks * bs
    pos = np.array([n_ctx - 1, 0, bs + 3, n_ctx + 5], np.int32)
    pt = (rng.permutation(nb_pool - 1)[:B * n_blocks] + 1).reshape(
        B, n_blocks).astype(np.int32)
    pt[3, 0] = pt[0, 0]
    pt[1, 1:] = 0
    pt[2, 2:] = 0
    pt[2, 1] = nb_pool + 3
    pt[1, 2] = -1
    shape = (nb_pool, bs, kv, DH)
    if kv_bits == 16:
        mk = lambda: rng.normal(size=shape).astype(F32)
        return q, mk(), None, mk(), None, pt, pos
    qmax = (1 << (kv_bits - 1)) - 1

    def codes():
        c = rng.integers(-qmax, qmax + 1, shape).astype(np.int8)
        return np.array(pack_nibbles(jnp.asarray(c))) if kv_bits == 4 else c
    scale = lambda: rng.uniform(1e-3, 1e-1, (nb_pool, bs, kv, 1)).astype(F32)
    return q, codes(), scale(), codes(), scale(), pt, pos


def _safe(args):
    """The references' operands: out-of-range block ids set to 0, the block
    the kernels read for them."""
    q, k, ks, v, vs, pt, pos = args
    pt = np.where((pt >= 0) & (pt < k.shape[0]), pt, 0).astype(np.int32)
    return q, k, ks, v, vs, pt, pos


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [(kv, bs) for kv in (16, 8, 4) for bs in (5, 8, 16)]
IDS = [f"kv{kv}-bs{bs}" for kv, bs in CASES]


@pytest.mark.parametrize("kv_bits,bs", CASES, ids=IDS)
def test_paged_split_matches_references(kv_bits, bs):
    """About 144 positions.  The automatic plan (8 blocks, span 8), and
    explicit plans: one block with spans of 16 (9-10 spans: worker 0, and at
    bs 5 worker 1, take two; the online softmax across spans) or 32, two
    blocks with the automatic span."""
    args = _inputs(kv_bits, bs, n_ctx=144)
    n_ctx = args[5].shape[1] * bs
    plans = {pa_plan(B, KV, n_ctx, bs), (1, pa_span(bs, 16)),
             (1, pa_span(bs, 32)), (2, pa_auto_span(bs, n_ctx, 2 * NW))}
    safe = _safe(args)
    want_ref = tpaged.paged_attention_ref(*map(_t, safe), kv_bits=kv_bits,
                                          out_dtype=torch.float32).numpy()
    want_pallas = np.asarray(jpaged.paged_attention(
        *map(_j, safe), kv_bits=kv_bits, interpret=True))
    want_oracle = np.asarray(jpaged.paged_attention_ref(
        *map(_j, safe), kv_bits=kv_bits, out_dtype=jnp.float32))
    assert pa_plan(B, KV, n_ctx, bs)[0] == 8
    for cluster, span in sorted(plans):
        got = replay_paged_attention(*args, kv_bits, cluster, span)
        np.testing.assert_allclose(got, want_ref, **TOL)
        np.testing.assert_allclose(got, want_pallas, **TOL)
        np.testing.assert_allclose(got, want_oracle, **TOL)


def test_paged_split_leaves_idle_workers_out():
    """At pos 0 one worker holds the only span; the 63 others of an 8-rank
    cluster keep m = -1e30, l = 0 and change nothing: the merge equals that
    one worker's normalised partial exactly."""
    q, k, ks, v, vs, pt, pos = _inputs(8, 16)
    pool = Pool(k, ks, v, vs, pt[1], 0, 8)
    m, l, acc = worker_partial(q[1, 0], pool, 1, 8, 0, 64)
    _, L, A = cluster_attend(q[1, 0], pool, 1, 8, 8)
    np.testing.assert_array_equal(A, acc)
    np.testing.assert_array_equal(L, l)
    idle = worker_partial(q[1, 0], pool, 1, 8, 5, 64)
    assert (idle[0] == F32(-1e30)).all() and not idle[1].any() \
        and not idle[2].any()


@pytest.mark.parametrize("kv_bits,bs", CASES, ids=IDS)
def test_fused_split_matches_references(kv_bits, bs):
    """slot_map (2, 0, 2, 3): slot 1 absent, slot 2 repeated."""
    args = _inputs(kv_bits, bs, seed=1)
    safe = _safe(args)
    rng = np.random.default_rng(2)
    d = 48
    wo = (rng.normal(size=(KV * G * DH, d)) / 8).astype(F32)
    sm = np.array([2, 0, 2, 3], np.int32)
    got = replay_fused_decode(*args, sm, wo, kv_bits)
    np.testing.assert_array_equal(got[0], got[2])
    want_ref = tfused.fused_decode_ref(*map(_t, safe), _t(sm), _t(wo),
                                       kv_bits=kv_bits).numpy()
    want_pallas = np.asarray(jfused.fused_decode(
        *map(_j, safe), _j(sm), _j(wo), kv_bits=kv_bits, interpret=True))
    want_oracle = np.asarray(jfused.fused_decode_ref(
        *map(_j, safe), _j(sm), _j(wo), kv_bits=kv_bits))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)


@pytest.mark.parametrize("kv,d", [(1, 576), (10, 50)], ids=["kv1-d576",
                                                             "kv10-d50"])
def test_fused_split_head_layouts(kv, d):
    """One head on all eight ranks (KV = 1, columns a multiple of 4), and
    more heads than ranks (KV = 10: rank r computes heads r and r + 8, each
    with its 8 warps over 9 spans; D = 50 takes scalar columns)."""
    args = _inputs(8, 16, kv=kv, seed=3, n_ctx=144)
    safe = _safe(args)
    rng = np.random.default_rng(4)
    wo = (rng.normal(size=(kv * G * DH, d)) / 8).astype(F32)
    sm = np.array([0, 3, 3], np.int32)
    got = replay_fused_decode(*args, sm, wo, 8)
    np.testing.assert_array_equal(got[1], got[2])
    want = tfused.fused_decode_ref(*map(_t, safe), _t(sm), _t(wo),
                                   kv_bits=8).numpy()
    np.testing.assert_allclose(got, want, **TOL)

"""B6 on the CPU: the work split of both kernels of ``csrc/binary_matmul.cu``
replayed in numpy and held against the plain version.

(i) ``xnor_rows_kernel`` (small M): the chunk width chosen from the row's
word count, a column's chunks over a power-of-two group of lanes, batches
of JB chunks, RT rows a block with the rows past M reading row m0, the
butterfly of ``__shfl_xor_sync`` sums and the store by the group's first
lane.

(ii) ``xnor_tc_kernel`` (the 1-bit tensor cores): the cp.async stage copy
with zero fill, the ``ldmatrix`` addresses of the A and W^T fragments,
``mma.sync m16n8k256 .b1 .and.popc`` with the PTX ISA's fragment layout
(lane (g, t) holds words t and t + 4 of a k256 chunk of rows g and g + 8,
and D rows g, g + 8 at columns 2t, 2t + 1), the all-ones operand for the
row and column popcounts, ``popc(a) + popc(w) - 2 popc(a AND w)`` and the
epilogue's index arithmetic.

Each emulation writes every output exactly once and gives the plain
version's float32 output bit for bit (``engine.resolve_entry("binary", 1,
1, "torch")``), over ragged M, N and word counts (16-, 8- and 4-byte
chunks).  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

from repro_torch.kernels import engine  # noqa: E402

popc = np.bitwise_count


def _vec(kw: int) -> int:
    """Words a load: the widest that the row's bytes allow (the pointers
    of a fresh tensor are aligned)."""
    return 4 if kw % 4 == 0 else 2 if kw % 2 == 0 else 1


def _epilogue(k: int, x, alpha, bias, n):
    """``__fmul_rn(float(K - 2 x), alpha[n])`` then ``__fadd_rn(bias[n])``."""
    o = np.float32(k - 2 * int(x)) * alpha[n]
    return o if bias is None else np.float32(o + bias[n])


def emulate_rows(a, w, alpha, bias, m_small_rows=8, threads=128, jb=4):
    """xnor_rows_kernel over the whole grid: returns (out, writes)."""
    m, kw = a.shape
    n = w.shape[0]
    vec = _vec(kw)
    chunks = kw // vec
    lg = 0
    while (1 << lg) < chunks and lg < 5:
        lg += 1
    g = 1 << lg
    bx = ((n << lg) + threads - 1) // threads
    by = (m + m_small_rows - 1) // m_small_rows
    out = np.zeros((m, n), np.float32)
    writes = np.zeros((m, n), np.int64)
    gt = np.arange(bx * threads)                     # global thread index
    col = gt >> lg
    lane_g = gt & (g - 1)
    live = col < n
    wrow = np.where(live, col, 0)
    nb = (chunks + g * jb - 1) // (g * jb)
    for y in range(by):
        m0 = y * m_small_rows
        rows = min(m_small_rows, m - m0)
        acc = np.zeros((gt.size, m_small_rows), np.int64)
        for b in range(nb):
            for j in range(jb):
                c = lane_g + (b * jb + j) * g
                ok = live & (c < chunks)
                cc = np.where(ok, c, 0)
                for i in range(m_small_rows):
                    r = m0 + (i if i < rows else 0)
                    for t in range(vec):
                        wd = w[wrow, cc * vec + t]
                        ad = a[r, cc * vec + t]
                        acc[:, i] += np.where(ok, popc(ad ^ wd), 0)
        # butterfly over each group of g lanes (groups never cross a warp)
        acc = acc.reshape(-1, g, m_small_rows)
        off = g >> 1
        while off:
            acc = acc + acc[:, np.arange(g) ^ off]
            off >>= 1
        acc = acc.reshape(-1, m_small_rows)
        for tid in np.flatnonzero(live & (lane_g == 0)):
            for i in range(rows):
                out[m0 + i, col[tid]] = _epilogue(kw * 32, acc[tid, i], alpha,
                                                  bias, col[tid])
                writes[m0 + i, col[tid]] += 1
    return out, writes


BM = BN = 64
BKW, LD, WARPS = 16, 20, 4


def _ldsm_x4(smem, rows, words):
    """ldmatrix .x4 .b16: lane l supplies the address of row l % 8 of
    matrix l // 8; register j of lane i is the 4-byte word i % 4 of row
    i // 4 of matrix j.  Returns (32, 4) uint32."""
    i = np.arange(32)
    src = 8 * np.arange(4)[None, :] + (i // 4)[:, None]      # (32, 4) lanes
    return smem[rows[src], words[src] + (i % 4)[:, None]]


def _mma_and(d, af, b0, b1):
    """d (32, 4) += m16n8k256 .b1 .and.popc of lane registers af (32, 4)
    and b0, b1 (32,), in the PTX ISA's fragment layout."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    a16 = np.zeros((16, 8), np.uint32)
    a16[g, t], a16[g + 8, t] = af[:, 0], af[:, 1]
    a16[g, t + 4], a16[g + 8, t + 4] = af[:, 2], af[:, 3]
    b8 = np.zeros((8, 8), np.uint32)
    b8[g, t], b8[g, t + 4] = b0, b1
    dd = popc(a16[:, None, :] & b8[None, :, :]).astype(np.int64).sum(-1)
    d[:, 0] += dd[g, 2 * t]
    d[:, 1] += dd[g, 2 * t + 1]
    d[:, 2] += dd[g + 8, 2 * t]
    d[:, 3] += dd[g + 8, 2 * t + 1]


def emulate_tc(a, w, alpha, bias):
    """xnor_tc_kernel over the whole grid: returns (out, writes)."""
    m, kw = a.shape
    n = w.shape[0]
    vec = _vec(kw)
    k = kw * 32
    out = np.zeros((m, n), np.float32)
    writes = np.zeros((m, n), np.int64)
    lane = np.arange(32)
    ones = np.full(32, 0xFFFFFFFF, np.uint32)
    for bx in range((m + BM - 1) // BM):
        for by in range((n + BN - 1) // BN):
            m_blk, n_blk = bx * BM, by * BN
            acc = np.zeros((WARPS, 2, 4, 32, 4), np.int64)
            pa = np.zeros((WARPS, 2, 32, 4), np.int64)
            pw = np.zeros((WARPS, 4, 32, 4), np.int64)
            for t in range((kw + BKW - 1) // BKW):
                # load_stage: pieces i -> (r, kw); A rows then W^T rows
                as_ = np.full((BM, LD), 0xDEADBEEF, np.uint32)
                ws_ = np.full((BN, LD), 0xDEADBEEF, np.uint32)
                kw0, p = t * BKW, BKW // vec
                i = np.arange((BM + BN) * p)
                r, kk_ = i // p, kw0 + (i % p) * vec
                is_a = r < BM
                row = np.where(is_a, m_blk + r, n_blk + r - BM)
                ok = (row < np.where(is_a, m, n)) & (kk_ < kw)
                for v in range(vec):
                    src = np.where(is_a, a[np.minimum(row, m - 1),
                                           np.minimum(kk_ + v, kw - 1)],
                                   w[np.minimum(row, n - 1),
                                     np.minimum(kk_ + v, kw - 1)])
                    val = np.where(ok, src, 0).astype(np.uint32)
                    as_[r[is_a], kk_[is_a] - kw0 + v] = val[is_a]
                    ws_[r[~is_a] - BM, kk_[~is_a] - kw0 + v] = val[~is_a]
                for kk in range(0, BKW, 8):
                    for wp in range(WARPS):
                        wm, wn = (wp >> 1) * 32, (wp & 1) * 32
                        af = [_ldsm_x4(as_, wm + mi * 16 + (lane & 7)
                                       + ((lane >> 3) & 1) * 8,
                                       kk + (lane >> 4) * 4) for mi in range(2)]
                        bf = []
                        for nj in range(2):
                            rr = _ldsm_x4(ws_, wn + nj * 16 + (lane & 7)
                                          + (lane >> 4) * 8,
                                          kk + ((lane >> 3) & 1) * 4)
                            bf += [(rr[:, 0], rr[:, 1]), (rr[:, 2], rr[:, 3])]
                        for mi in range(2):
                            _mma_and(pa[wp, mi], af[mi], ones, ones)
                            for ni in range(4):
                                _mma_and(acc[wp, mi, ni], af[mi], *bf[ni])
                        for ni in range(4):
                            _mma_and(pw[wp, ni], np.tile(ones[:, None], 4),
                                     *bf[ni])
            for wp in range(WARPS):
                wm, wn = (wp >> 1) * 32, (wp & 1) * 32
                for mi in range(2):
                    for ni in range(4):
                        for h in range(2):
                            for ln in range(32):
                                mm = m_blk + wm + mi * 16 + (ln >> 2) + h * 8
                                nn = n_blk + wn + ni * 8 + (ln & 3) * 2
                                if mm >= m:
                                    continue
                                for e in range(2):
                                    if nn + e >= n:
                                        continue
                                    x = (pa[wp, mi, ln, 2 * h] + pw[wp, ni, ln, e]
                                         - 2 * acc[wp, mi, ni, ln, 2 * h + e])
                                    out[mm, nn + e] = _epilogue(k, x, alpha,
                                                                bias, nn + e)
                                    writes[mm, nn + e] += 1
    return out, writes


def _operands(m, n, kw, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (m, kw), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, 2 ** 32, (n, kw), dtype=np.uint64).astype(np.uint32)
    alpha = (rng.random(n) + 0.5).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    return a, w, alpha, bias


def _plain(a, w, alpha, bias):
    fn, key = engine.resolve_entry("binary", 1, 1, "torch")
    assert key[3] == "torch"
    kw = a.shape[1]
    at, wt = (torch.from_numpy(v.view(np.int32).copy()) for v in (a, w))
    al = torch.from_numpy(alpha)
    pw = engine.PackedWeight(wt, al, 1, "binary", kw * 32)
    b = None if bias is None else torch.from_numpy(bias)
    return fn(at, pw, al, b, out_dtype=torch.float32).numpy()


# (M, N, K words): one word (4-byte chunks), the 1x1 LM's K = 576 (18
# words: 8-byte chunks) and 1536 (48: 16-byte chunks), an odd word count,
# and 520 words (two batches of JB chunks a lane at G = 32)
ROWS_CASES = [(1, 37, 1), (4, 192, 18), (4, 64, 48), (9, 200, 37),
              (32, 40, 18), (3, 5, 520)]


@pytest.mark.parametrize("m,n,kw", ROWS_CASES, ids=lambda v: str(v))
def test_rows_kernel_split_equals_plain(m, n, kw):
    a, w, alpha, bias = _operands(m, n, kw, m * 1000 + kw)
    for b in (None, bias):
        got, writes = emulate_rows(a, w, alpha, b)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, _plain(a, w, alpha, b))


# ragged M and N around the 64 x 64 block and 32 x 32 warp tiles; K words
# of one stage, a partial last stage, and each chunk width
TC_CASES = [(1, 8, 1), (70, 72, 18), (65, 129, 37), (33, 64, 48),
            (130, 40, 72)]


@pytest.mark.parametrize("m,n,kw", TC_CASES, ids=lambda v: str(v))
def test_tensor_core_kernel_tiles_equal_plain(m, n, kw):
    a, w, alpha, bias = _operands(m, n, kw, m * 7 + kw)
    for b in (None, bias):
        got, writes = emulate_tc(a, w, alpha, b)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, _plain(a, w, alpha, b))


def test_and_popc_identity_is_exact():
    """popc(a XOR w) == popc(a) + popc(w) - 2 popc(a AND w) on every
    pair of bytes (so on every word, bytewise)."""
    v = np.arange(256, dtype=np.uint32)
    a, w = np.meshgrid(v, v)
    np.testing.assert_array_equal(popc(a ^ w),
                                  popc(a) + popc(w) - 2 * popc(a & w))

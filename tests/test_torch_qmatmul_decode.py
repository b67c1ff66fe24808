"""B1 / B3 on the CPU: the field decode of ``csrc/qmatmul.cu`` and the
plain versions against the Pallas kernels.

(i) ``decode_quads`` (shift and mask, sign extension by one multiply, a
``__byte_perm`` transpose into int8 quads in K order) replayed bit for bit
on uint32 in numpy, against ``packing.unpack`` over every value of every
byte of a word, at 2, 4 and 8 bits.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``).

(ii) The port's ``ref.ternary_matmul_ref`` / ``ref.packed_matmul_ref``
against the JAX ``ternary_matmul`` / ``packed_matmul`` Pallas kernels in
interpret mode (through the reference engine's ``pallas`` entries),
on int8 codes, with weights whose fields span the whole signed range (the
most negative one included): exact (with a bias, see the test).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels import engine as jengine  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

U32 = np.uint32


def byte_perm(x, y, s: int):
    """CUDA ``__byte_perm(x, y, s)`` for selectors of nibbles 0..7: byte i
    of the result is byte ``s >> 4i & 7`` of the 8 bytes of (x, y)."""
    src = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    src += [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << U32(8 * i)
    return out


def decode_quads(wd: np.ndarray, bits: int) -> np.ndarray:
    """The kernel's ``decode_quads<bits>``: (R, bits/2) uint32 words, 16
    codes' worth -> (R, 4) uint32 quads, quad j = codes 4j..4j+3."""
    if bits == 2:
        s = []
        for i in range(4):
            f = (wd[:, 0] >> U32(2 * i)) & U32(0x03030303)
            s.append(f | ((f & U32(0x02020202)) * U32(0x7E)))
        a, b = byte_perm(s[0], s[1], 0x5140), byte_perm(s[0], s[1], 0x7362)
        c, d = byte_perm(s[2], s[3], 0x5140), byte_perm(s[2], s[3], 0x7362)
        q = [byte_perm(a, c, 0x5410), byte_perm(a, c, 0x7632),
             byte_perm(b, d, 0x5410), byte_perm(b, d, 0x7632)]
    elif bits == 4:
        q = []
        for i in range(2):
            e = wd[:, i] & U32(0x0F0F0F0F)
            o = (wd[:, i] >> U32(4)) & U32(0x0F0F0F0F)
            e |= (e & U32(0x08080808)) * U32(0x1E)
            o |= (o & U32(0x08080808)) * U32(0x1E)
            q += [byte_perm(e, o, 0x5140), byte_perm(e, o, 0x7362)]
    else:
        q = [wd[:, i] for i in range(4)]
    return np.stack(q, axis=-1)


def _every_byte_words(bits: int, rng) -> np.ndarray:
    """(R, bits/2) uint32: for each word, byte position and byte value, a
    row of random words with that byte set, so every field value sits in
    every field position."""
    wpd = bits // 2
    rows = []
    for u in range(wpd):
        for p in range(4):
            block = rng.integers(0, 2 ** 32, (256, wpd), dtype=np.uint64)
            block[:, u] &= ~np.uint64(0xFF << (8 * p))
            block[:, u] |= np.arange(256, dtype=np.uint64) << np.uint64(8 * p)
            rows.append(block)
    return np.concatenate(rows).astype(U32)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_decode_quads_matches_unpack(bits):
    """Every field value at every position: the kernel's quads, read as
    little-endian int8, are ``packing.unpack``'s codes in K order."""
    wd = _every_byte_words(bits, np.random.default_rng(bits))
    got = decode_quads(wd, bits).astype("<u4").view(np.int8).reshape(len(wd), 16)
    words = torch.from_numpy(wd.view(np.int32).copy())
    want = packing.unpack(words, bits, signed=True).numpy()
    np.testing.assert_array_equal(got, want)
    lo = -(1 << (bits - 1))
    assert got.min() == lo and got.max() == -lo - 1


# (M, N, K, bm, bn, bk): a single tile, and K split over 2-3 grid steps
JAX_SHAPES = [(8, 16, 64, 8, 16, 64), (16, 32, 192, 8, 16, 64),
              (24, 48, 256, 8, 16, 128)]


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "m%dn%dk%d" % s[:3])
@pytest.mark.parametrize("kind,bits", [("ternary", 2), ("int", 2), ("int", 4),
                                       ("int", 8)],
                         ids=["ternary", "int2", "int4", "int8"])
def test_plain_matmul_equals_pallas(kind, bits, shape):
    """int8 codes over all of int8 and weight fields over their whole
    signed range: the port's plain version equals the Pallas kernel in
    interpret mode.  With a bias the port (and the CUDA kernel) rounds
    twice, ``acc * scale`` then ``+ bias``, so it equals the Pallas
    output without a bias plus the bias in float32; the Pallas kernel's
    own biased output is within 1 ulp of that (XLA on the CPU contracts
    its epilogue into one FMA)."""
    m, n, k, bm, bn, bk = shape
    rng = np.random.default_rng(100 * bits + m)
    lo = -(1 << (bits - 1))
    codes = rng.integers(lo, -lo, (n, k)).astype(np.int8)
    codes[:, 0] = lo
    words = packing.pack(torch.from_numpy(codes), bits)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    scale = (rng.random(n) + 0.5).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)

    def port(b):
        tb = None if b is None else torch.from_numpy(b)
        args = (torch.from_numpy(x), words, torch.from_numpy(scale))
        if kind == "ternary":
            return ref.ternary_matmul_ref(*args, bias=tb).numpy()
        return ref.packed_matmul_ref(*args, bits, bias=tb).numpy()

    # the Pallas kernel through the reference engine's registered entry
    entry, key = jengine.resolve_entry(kind, 8, bits, "pallas")
    assert key[3] == "pallas"
    jpw = jengine.PackedWeight(jnp.asarray(words.numpy()), jnp.asarray(scale),
                               bits, kind, k)

    def pallas(b):
        return np.asarray(entry(
            jnp.asarray(x), jpw, jnp.asarray(scale),
            None if b is None else jnp.asarray(b), block=(bm, bn, bk),
            out_dtype=jnp.float32, interpret=True))

    want = pallas(None)
    np.testing.assert_array_equal(port(None), want)
    np.testing.assert_array_equal(port(bias), want + bias[None, :])
    np.testing.assert_array_max_ulp(pallas(bias), want + bias[None, :], maxulp=1)

"""The row form of B7c on the CPU: the engine's per-row quantizer with its
scale computed in the same pass (``kernels.act_quant.act_quant_signed_rows``,
whose plain version is ``ref.act_quant_signed_rows_ref``).

(i) The plain row form against the engine's former two-step expression
(``x.abs().amax(1).clamp_min(1e-8) / qmax``, then the grouped quantizer):
``torch.equal`` for the codes and the scales, in f32 and bf16, at 2, 4 and
8 bits, on drawn rows, all-zero rows (the ``clamp_min`` path), rows whose
quotients land on .5 ties, single-column rows and F = 9216 (AlexNet's fc).

(ii) The same rows against the JAX reference's engine quantizer
(``repro.kernels.engine._prep_activations``): codes and scales equal.

(iii) A numpy emulation of the CUDA kernel's arithmetic (an exact max,
``max(amax, 1e-8)`` rounded to x's dtype, ``__fdiv_rn`` by qmax then
rounded to x's dtype, ``__fdiv_rn(x, s)`` rounded to bf16 on its bits,
clamped, then rounded half to even) against PyTorch's expression on the
same dtype; the bit-level bf16 rounding against PyTorch's conversion, and
the rounding by an add of 1.5 * 2^23 against ``np.rint``.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``).
"""
import importlib
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels import engine as jengine  # noqa: E402
taq = importlib.import_module("repro_torch.kernels.act_quant")
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BITS = [2, 4, 8]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _two_step(x: torch.Tensor, bits: int):
    """The engine's per-row quantizer as it was written before the row
    form: the scale by four PyTorch operations, then the codes."""
    qmax = (1 << (bits - 1)) - 1
    s = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax
    return ref.act_quant_signed_grouped_ref(x, bits, s,
                                            compute_dtype=x.dtype), s


def _bf16_round(v: np.ndarray) -> np.ndarray:
    """float32 -> nearest bf16 (ties to even), as float32: CUDA's
    ``__float2bfloat16_rn`` on finite values."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _emulate_kernel(x: np.ndarray, bits: int, bf16: bool):
    """The row kernel's arithmetic on float32 values of x (already in x's
    dtype): returns (codes int8, scale float32)."""
    rnd = _bf16_round if bf16 else (lambda v: np.asarray(v, np.float32))
    qmax = np.float32((1 << (bits - 1)) - 1)
    amax = np.abs(x).max(axis=1, keepdims=True)                # exact
    s = rnd(rnd(np.maximum(amax, np.float32(1e-8))) / qmax)     # __fdiv_rn
    q = rnd(x / s)                                              # __fdiv_rn
    codes = np.rint(np.clip(q, -qmax, qmax))       # clamp, then round by an add
    return codes.astype(np.int8), s.astype(np.float32)


def _rows(rng, m: int, f: int, dtype) -> torch.Tensor:
    x = rng.normal(size=(m, f)) * np.exp2(rng.integers(-30, 30, size=(m, 1)))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _tie_rows(bits: int, f: int, dtype) -> torch.Tensor:
    """Rows whose amax is qmax * 2^-2 (a power-of-two scale: every
    quotient exact) and whose other values are odd multiples of 2^-3 (every
    quotient a .5 tie)."""
    qmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    odd = 2 * rng.integers(-qmax, qmax, size=(6, f)) + 1
    x = np.clip(odd * 0.125, -qmax * 0.25, qmax * 0.25)
    x[:, 0] = qmax * 0.25
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _check(x: torch.Tensor, bits: int):
    """Row form == two-step expression == numpy emulation of the kernel,
    on the CPU; returns the row form's (codes, scale)."""
    got_q, got_s = ref.act_quant_signed_rows_ref(x, bits)
    want_q, want_s = _two_step(x, bits)
    assert got_s.dtype == x.dtype and got_s.shape == (x.shape[0], 1)
    assert torch.equal(got_s, want_s) and torch.equal(got_q, want_q)
    wq, wsc = taq.act_quant_signed_rows(x, bits=bits)     # the CPU wrapper
    assert torch.equal(wq, got_q) and torch.equal(wsc, got_s)
    eq, es = _emulate_kernel(x.float().numpy(), bits, x.dtype == torch.bfloat16)
    np.testing.assert_array_equal(got_s.float().numpy(), es)
    np.testing.assert_array_equal(got_q.numpy(), eq)
    return got_q, got_s


@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 9), f=st.integers(1, 300), seed=st.integers(0, 2 ** 31),
       bits=st.sampled_from(BITS), dtype=st.sampled_from(sorted(DTYPES)))
def test_rows_equal_two_step_drawn(m, f, seed, bits, dtype):
    """Drawn rows, row magnitudes 2^-30 .. 2^30, ragged F."""
    _check(_rows(np.random.default_rng(seed), m, f, DTYPES[dtype]), bits)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", BITS)
def test_rows_edge_cases(bits, dtype):
    """All-zero rows (codes 0) and rows below 1e-8 (the clamp_min path:
    scale 1e-8 / qmax in x's dtype), single-column rows, .5 ties, and
    F = 9216 rows beside short ones."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(bits)
    zeros = torch.zeros((3, 40), dtype=dt)
    tiny = torch.full((2, 40), 3e-9).to(dt)
    q, s = _check(torch.cat([zeros, tiny, _rows(rng, 2, 40, dt)]), bits)
    assert (q[:3] == 0).all()
    clamp = torch.tensor(1e-8).to(dt) / torch.tensor(float((1 << (bits - 1)) - 1)).to(dt)
    assert (s[:5] == clamp).all()
    _check(_rows(rng, 7, 1, dt), bits)                      # single column
    ties = _tie_rows(bits, 64, dt)
    qt, st_ = _check(ties, bits)
    quot = ties.float() / st_.float()
    assert bool(((quot - quot.floor()) == 0.5).any()), "no .5 tie in the rows"
    _check(_rows(rng, 3, 9216, dt), bits)                   # AlexNet's fc K


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", BITS)
def test_rows_match_reference_engine(bits, dtype):
    """The same numpy rows through the JAX reference's engine quantizer
    and the port's (``backend="torch"``): scales and codes equal, with
    zero rows, ties, a single column and F = 9216 among them."""
    rng = np.random.default_rng(100 + bits)
    cases = [_rows(rng, 37, 576, torch.float32), _rows(rng, 4, 1536, torch.float32),
             torch.zeros((2, 64)), _tie_rows(bits, 64, torch.float32),
             _rows(rng, 5, 1, torch.float32), _rows(rng, 2, 9216, torch.float32)]
    for x32 in cases:
        x = x32.to(DTYPES[dtype])
        xj = jnp.asarray(x.float().numpy()).astype(dtype)
        k = x.shape[1]
        jpw = jengine.PackedWeight(jnp.zeros((1, 1), jnp.int32), None, 2,
                                   "ternary", k)
        jq, js = jengine._prep_activations(xj, jpw, bits)
        pw = engine.PackedWeight(torch.zeros((1, 1), dtype=torch.int32), None,
                                 2, "ternary", k)
        tq, ts = engine._prep_activations(x, pw, bits, "torch")
        assert ts.dtype == x.dtype
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js.astype(jnp.float32)))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        rq, rs = ref.act_quant_signed_rows_ref(x, bits)
        assert torch.equal(rq, tq) and torch.equal(rs, ts)


@settings(max_examples=200, deadline=None)
@given(amax_bits=st.integers(0, 0x7F7F), bits=st.sampled_from(BITS))
def test_bf16_scale_rounding_emulated(amax_bits, bits):
    """The kernel's bf16 scale (``max(amax, 1e-8)`` rounded to bf16, then
    ``__fdiv_rn`` by qmax, then ``__float2bfloat16_rn``) against
    PyTorch's bf16 expression, for drawn positive bf16 amax values (every
    exponent, subnormals included)."""
    amax = np.array([[amax_bits << 16]], dtype=np.uint32).view(np.float32)
    x = torch.from_numpy(amax.copy()).to(torch.bfloat16)
    qmax = (1 << (bits - 1)) - 1
    want = (x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax).float()
    _, es = _emulate_kernel(x.float().numpy(), bits, True)
    np.testing.assert_array_equal(want.numpy(), es)


def test_bf16_rounding_on_the_bits():
    """The kernel's bf16 rounding of a quotient (add 0x7FFF plus the kept
    lowest bit, clear the low half) is PyTorch's float32 -> bf16 conversion
    on finite values: random bit patterns, exact ties (low half 0x8000)
    with either kept lowest bit, and values next to the largest finite."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    ties = (u & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    top = np.arange(0x7F7F0000, 0x7F800000, 97, dtype=np.uint32)
    for bits in (u, ties, top, top | np.uint32(0x80000000)):
        v = bits.view(np.float32)
        v = v[np.isfinite(v)]
        want = torch.from_numpy(v.copy()).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(_bf16_round(v).view(np.uint32),
                                      want.view(np.uint32))


def test_rint_by_the_adder():
    """The kernel's rounding of a clamped quotient v (|v| <= 127): the low
    bits of 1.5 * 2^23 + v in float32 are rint(v), half to even, for every
    float32 of [-127, 127] near an integer or a half-integer and random
    ones between."""
    k = np.arange(-127, 128, 0.5, dtype=np.float32)
    near = np.concatenate([np.nextafter(k, np.float32(-200)), k,
                           np.nextafter(k, np.float32(200))])
    rand = np.random.default_rng(5).uniform(-127, 127, 1 << 16)
    for v in (near, rand.astype(np.float32)):
        v = np.clip(v, np.float32(-127), np.float32(127))
        t = (v + np.float32(12582912.0)).astype(np.float32)
        np.testing.assert_array_equal(t.view(np.int32) - 0x4B400000,
                                      np.rint(v).astype(np.int32))


def test_rows_wrapper_refuses():
    """The row form needs qmax >= 1 (2 bits or more) on the card; on the
    CPU it runs the plain version and launches nothing."""
    engine.reset_launch_counts()
    q, s = taq.act_quant_signed_rows(torch.randn(4, 8), bits=2)
    assert q.dtype == torch.int8 and s.shape == (4, 1)
    assert sum(engine.launch_counts().values()) == 0

"""Port parity: the activation quantizers of ``repro_torch`` (the plain
versions in ``kernels/ref.py``, the CPU path of ``kernels/act_quant.py``,
``core.quantize.act_quant_codes_*`` and the engine's per-row quantizer)
against ``repro.kernels.act_quant`` (Pallas in interpret mode),
``repro.kernels.ref`` and ``repro.core`` on the same numpy inputs.

Every comparison is exact (int8 codes, ``np.testing.assert_array_equal``):
one rounding step decides each code and both packages take it the same way
(half up for the unsigned eq. (4) codes, half to even for the signed ones,
a true quotient, saturation at 127).  The inputs hold exact ties: every
bf16 value of [0, 1] (x * levels is exact in f32, so k + 0.5 occurs) and of
[-2, 2] under a power-of-two scale (x / s = k + 0.5 occurs); each test
checks that its ties are there.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core.precision import get_precision, signed  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
taq = importlib.import_module("repro_torch.kernels.act_quant")
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# the module (``repro.kernels`` re-exports its functions under the same name)
jaq = importlib.import_module("repro.kernels.act_quant")
BITS = [2, 3, 4, 8]
F = 64
RNG = np.random.default_rng(11)


def _bf16_grid(lo: float, hi: float) -> np.ndarray:
    """Every bf16 value in [lo, hi], as float32."""
    u = np.arange(0, 1 << 16, dtype=np.uint32) << 16
    v = u.view(np.float32)
    return np.sort(v[np.isfinite(v) & (v >= lo) & (v <= hi)])


def _rows(values: np.ndarray, m: int) -> np.ndarray:
    """``values`` (a random subset when they do not fit) then random fill,
    shaped (m, F) and shuffled."""
    if values.size > m * F:
        values = RNG.choice(values, m * F, replace=False)
    out = RNG.normal(size=m * F).astype(np.float32)
    out[:values.size] = values
    return RNG.permutation(out).reshape(m, F)


UNSIGNED_X = _rows(_bf16_grid(0.0, 1.0), 300)        # ragged M: 300 rows
SIGNED_X = _rows(_bf16_grid(-2.0, 2.0), 300)


def _codes(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def _ties_unsigned(x, bits):
    v = x.astype(np.float32) * np.float32((1 << bits) - 1)
    return int(np.sum((v - np.floor(v) == 0.5) & (x >= 0) & (x <= 1)))


@pytest.mark.parametrize("bits", BITS)
def test_act_quant_unsigned_matches_pallas_and_ref(bits):
    """f32: the port's plain version == the Pallas kernel in interpret mode
    == the JAX oracle, 300 ragged rows holding every bf16 value of [0, 1]
    (exact half ties under f32 arithmetic) and random values outside."""
    assert _ties_unsigned(UNSIGNED_X, bits) > 0
    want = _codes(jaq.act_quant(jnp.asarray(UNSIGNED_X), bits=bits,
                                interpret=True))
    np.testing.assert_array_equal(
        want, _codes(jref.act_quant_ref(jnp.asarray(UNSIGNED_X), bits)))
    x = torch.from_numpy(UNSIGNED_X)
    np.testing.assert_array_equal(_codes(ref.act_quant_ref(x, bits)), want)
    np.testing.assert_array_equal(_codes(taq.act_quant(x, bits=bits)), want)
    if bits == 8:
        assert want.max() == 127          # the reference's int8 saturation


@pytest.mark.parametrize("bits", BITS)
def test_act_quant_signed_matches_pallas_and_ref(bits):
    """One scalar scale: a power of two (every x / s exact, with ties) and
    an arbitrary one; f32, 300 ragged rows."""
    for s in (0.25, 0.37):
        ties = np.sum(np.abs(SIGNED_X / np.float32(s)) % 1 == 0.5)
        assert s != 0.25 or ties > 0
        scale = np.float32(s)
        want = _codes(jaq.act_quant_signed(jnp.asarray(SIGNED_X),
                                           jnp.asarray(scale), bits=bits,
                                           interpret=True))
        np.testing.assert_array_equal(want, _codes(jref.act_quant_signed_ref(
            jnp.asarray(SIGNED_X), bits, jnp.asarray(scale))))
        x, ts = torch.from_numpy(SIGNED_X), torch.tensor(s)
        np.testing.assert_array_equal(
            _codes(ref.act_quant_signed_ref(x, bits, ts)), want)
        np.testing.assert_array_equal(
            _codes(taq.act_quant_signed(x, ts, bits=bits)), want)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("bits", BITS)
def test_act_quant_signed_grouped_matches_pallas_and_ref(bits, g):
    """Scales (M, G): the first half of the rows power-of-two scales (exact
    quotients with ties), the rest arbitrary; f32, 300 ragged rows."""
    rng = np.random.default_rng(bits * 10 + g)
    scale = rng.uniform(0.05, 0.6, size=(300, g)).astype(np.float32)
    scale[:150] = 2.0 ** rng.integers(-4, 0, size=(150, g))
    want = _codes(jaq.act_quant_signed_grouped(
        jnp.asarray(SIGNED_X), jnp.asarray(scale), bits=bits, interpret=True))
    np.testing.assert_array_equal(want, _codes(
        jref.act_quant_signed_grouped_ref(jnp.asarray(SIGNED_X), bits,
                                          jnp.asarray(scale))))
    x, ts = torch.from_numpy(SIGNED_X), torch.from_numpy(scale)
    np.testing.assert_array_equal(
        _codes(ref.act_quant_signed_grouped_ref(x, bits, ts)), want)
    np.testing.assert_array_equal(
        _codes(taq.act_quant_signed_grouped(x, ts, bits=bits)), want)


@pytest.mark.parametrize("bits", BITS)
def test_engine_row_quantizer_bf16_matches_reference(bits):
    """bf16 rows, as the engine quantizes them: the reference engine's
    ``_prep_activations`` (bf16 absmax scale per row, bf16 quotient) gives
    the codes and scale of the port's ``_prep_activations`` and of the
    grouped quantizer's plain version with ``compute_dtype=bf16`` (G = 1);
    f32 arithmetic on the same rows gives other codes at 3 bits and up."""
    x = (np.random.default_rng(bits).normal(size=(37, 576)) * 3
         ).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jpw = jengine.PackedWeight(jnp.zeros((1, 1), jnp.int32), None, 2,
                               "ternary", 576)
    jq, js = jengine._prep_activations(xj, jpw, bits)
    xt = _bf16(x)
    pw = engine.PackedWeight(torch.zeros((1, 1), dtype=torch.int32), None, 2,
                             "ternary", 576)
    tq, ts = engine._prep_activations(xt, pw, bits, "torch")
    assert ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    np.testing.assert_array_equal(_codes(tq), _codes(jq))
    got = taq.act_quant_signed_grouped(xt, ts, bits=bits,
                                       compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(_codes(got), _codes(jq))
    if bits >= 3:
        f32 = ref.act_quant_signed_grouped_ref(xt, bits, ts)
        assert not torch.equal(f32, got)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_code_quantizers_match_reference(bits, dtype):
    """``core.act_quant_codes_unsigned`` / ``_signed`` of the port against
    the reference's on 3-D f32 and bf16 inputs: the codes exactly, the
    signed scale exactly; bf16 inputs compute in bf16 on both sides, and
    the unsigned ones include every bf16 value of [0, 1]."""
    for x in (UNSIGNED_X.reshape(20, 15, F), SIGNED_X.reshape(30, 10, F)):
        xj = jnp.asarray(x).astype(dtype)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        np.testing.assert_array_equal(
            _codes(tcore.act_quant_codes_unsigned(xt, bits)),
            _codes(jcore.act_quant_codes_unsigned(xj, bits)))
        jc, js = jcore.act_quant_codes_signed(xj, bits)
        tc, ts = tcore.act_quant_codes_signed(xt, bits)
        assert ts.dtype == torch.float32 and ts.shape == ()
        assert float(ts) == float(js)
        np.testing.assert_array_equal(_codes(tc), _codes(jc))
    if dtype == "bfloat16":
        # the bf16 sum x * levels + 0.5 rounds: ties land elsewhere than f32's
        xt = _bf16(UNSIGNED_X)
        f32 = ref.act_quant_ref(xt, bits)
        bf = ref.act_quant_ref(xt, bits, compute_dtype=torch.bfloat16)
        assert bits < 4 or not torch.equal(f32, bf)


def test_quantizer_arguments():
    """Scales that do not group x are refused; the CPU path launches
    nothing; an engine dispatch on the host records no quantizer launch."""
    x = torch.randn(4, 8)
    with pytest.raises(ValueError):
        taq.act_quant_signed_grouped(x, torch.ones(4, 3), bits=2)
    engine.reset_launch_counts()
    pcfg = signed(get_precision("2xT"))
    pw = engine.pack_weight(torch.randn(8 * 16, 24), pcfg)
    with engine.dispatch_trace() as ev:
        engine.qmatmul(torch.randn(4, 8 * 16), pw, pcfg)
    assert [e.op for e in ev] == ["qmatmul"]
    assert engine.launch_counts() == {k: 0 for k in engine.KERNELS}

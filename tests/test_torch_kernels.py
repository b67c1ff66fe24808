"""Port parity: ``repro_torch.kernels.engine`` against ``repro.kernels.engine``
on the same numpy inputs — the quantized matmul for every packed and codes
config at ragged M (JAX ``xla`` backend and Pallas in interpret mode), and
the dense decode attention at kv 8 and 4.

Kernels are reached through the engines (and the port's ``ref`` /
``decode_attention`` modules), never through the raw matmul kernel modules.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.precision import get_precision, signed  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro_torch.kernels import decode_attention as tattn  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402

RNG = np.random.default_rng(3)
CONFIGS = ["2xT", "8xT", "4x4", "2x2", "8x8", "3x3", "8xB"]
SHAPES = [(5, 96, 128), (13, 160, 256), (31, 64, 96)]      # (M, N, K), ragged M


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _packed_pair(name, k, n):
    """The same float weight packed by both packages; the port also gets a
    copy of the JAX-packed weight (so scales match bit for bit)."""
    pcfg = signed(get_precision(name))
    w = RNG.normal(size=(k, n)).astype(np.float32)
    jpw = jengine.pack_weight(jnp.asarray(w), pcfg)
    tpw = engine.pack_weight(torch.from_numpy(w), pcfg)
    same = engine.PackedWeight(torch.from_numpy(np.array(jpw.wt_packed)),
                               torch.from_numpy(np.array(jpw.scale)),
                               jpw.bits, jpw.mode, jpw.k)
    return pcfg, jpw, tpw, same


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "m%dn%dk%d" % s)
@pytest.mark.parametrize("name", CONFIGS)
def test_pack_weight_matches(name, shape):
    _, n, k = shape
    _, jpw, tpw, _ = _packed_pair(name, k, n)
    assert engine.storage_kind(tpw) == jengine.storage_kind(jpw)
    np.testing.assert_array_equal(tpw.wt_packed.numpy(), np.asarray(jpw.wt_packed))
    # ternary/binary scales are f32 means (reduction order): rtol 1e-6
    np.testing.assert_allclose(tpw.scale.numpy(), np.asarray(jpw.scale), rtol=1e-6)
    assert engine.hbm_bytes(tpw) == jengine.hbm_bytes(jpw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "m%dn%dk%d" % s)
@pytest.mark.parametrize("name", CONFIGS)
def test_qmatmul_int_codes_exact(name, shape):
    """Integer activation codes: exact accumulators, so the port's output is
    bit-equal to the reference's xla and Pallas (interpret) outputs."""
    m, n, k = shape
    pcfg, jpw, _, same = _packed_pair(name, k, n)
    qmax = (1 << (pcfg.a_bits - 1)) - 1
    x = RNG.integers(-qmax, qmax + 1, (m, k)).astype(np.int8)
    got = engine.qmatmul(torch.from_numpy(x), same, pcfg, backend="torch").numpy()
    for backend in ("xla", "pallas"):
        want = np.asarray(jengine.qmatmul(jnp.asarray(x), jpw, pcfg,
                                          backend=backend, interpret=True))
        np.testing.assert_array_equal(got, want, err_msg=backend)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "m%dn%dk%d" % s)
@pytest.mark.parametrize("name", CONFIGS)
def test_qmatmul_float_acts(name, shape):
    """Float activations: identical per-row quantization (elementwise ops),
    exact accumulation, then the f32 epilogue acc * w_scale * a_scale + bias:
    within rtol 1e-6 of the reference, and the port's own weights too."""
    m, n, k = shape
    pcfg, jpw, tpw, same = _packed_pair(name, k, n)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    bias = RNG.normal(size=(n,)).astype(np.float32)
    want = np.asarray(jengine.qmatmul(jnp.asarray(x), jpw, pcfg,
                                      bias=jnp.asarray(bias), backend="xla"))
    for pw in (same, tpw):
        got = engine.qmatmul(torch.from_numpy(x), pw, pcfg,
                             bias=torch.from_numpy(bias)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(jengine.qmatmul(jnp.asarray(x), jpw, pcfg,
                                        bias=jnp.asarray(bias),
                                        backend="pallas", interpret=True))
    np.testing.assert_allclose(
        engine.qmatmul(torch.from_numpy(x), same, pcfg,
                       bias=torch.from_numpy(bias)).numpy(),
        pallas, rtol=1e-6, atol=1e-6)


def test_engine_resolution_and_trace():
    """CPU tensors go to the plain versions; kinds with no CUDA kernel
    resolve to the torch registration even when "cuda" is asked for;
    "cuda" with a host tensor is refused, so no dispatch is recorded as
    "cuda" without a card; the CPU path launches nothing."""
    _, _, tpw, _ = _packed_pair("2xT", 128, 64)
    _, _, cpw, _ = _packed_pair("3x3", 128, 64)
    x = torch.randn(4, 128)
    engine.reset_launch_counts()
    with engine.dispatch_trace() as ev:
        engine.qmatmul(x, tpw, signed(get_precision("2xT")))
        engine.qmatmul(x, cpw, signed(get_precision("3x3")))
        for pw, name in ((tpw, "2xT"), (cpw, "3x3")):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                engine.qmatmul(x, pw, signed(get_precision(name)),
                               backend="cuda")
    assert [(e.kind, e.requested_backend, e.impl_backend) for e in ev] == [
        ("ternary", "torch", "torch"), ("codes", "torch", "torch")]
    assert engine.resolve_entry("codes", 3, 3, "cuda")[1] == (
        "codes", 3, 3, "torch")
    assert ev[0].a_scale_shape == (4, 1)
    assert engine.launch_counts() == {k: 0 for k in engine.KERNELS}
    with pytest.raises(ValueError):
        engine.qmatmul(x, tpw, signed(get_precision("2xT")), backend="xla")
    with pytest.raises(NotImplementedError):
        engine.qmatmul(x, tpw, signed(get_precision("1x1")))


def _attn_inputs(kv_bits, b=3, kv=2, g=2, dh=32, s=64):
    qmax = (1 << (kv_bits - 1)) - 1
    q = RNG.normal(size=(b, kv, g, dh)).astype(np.float32)
    dh_store = dh // 2 if kv_bits == 4 else dh
    codes = lambda: RNG.integers(-qmax, qmax + 1, (b, s, kv, dh)).astype(np.int8)
    kc, vc = codes(), codes()
    if kv_bits == 4:
        from repro.core.packing import pack_nibbles
        kc, vc = (np.array(pack_nibbles(jnp.asarray(c))) for c in (kc, vc))
        assert kc.shape[-1] == dh_store
    scales = lambda: RNG.uniform(1e-3, 1e-1, (b, s, kv, 1)).astype(np.float32)
    pos = np.array([s - 1, 17, 3][:b], np.int32)           # ragged slots
    return q, kc, scales(), vc, scales(), pos


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_decode_attention_matches(kv_bits):
    """The port's CPU decode attention (its plain serving version) against
    the reference engine on the xla backend and Pallas in interpret mode
    (kv 4 has no Pallas kernel and resolves to xla there too), atol 1e-5 in
    f32 (summation order)."""
    args = _attn_inputs(kv_bits)
    got = engine.decode_attention(*(torch.from_numpy(a) for a in args),
                                  kv_bits=kv_bits).numpy()
    for backend in ("xla", "pallas"):
        want = np.asarray(jengine.decode_attention(
            *(jnp.asarray(a) for a in args), kv_bits=kv_bits,
            backend=backend, interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=backend)


def test_decode_attention_kernel_plain_version_matches_pallas():
    """The CUDA kernel's plain version (f32 dequant, the Pallas kernel's
    semantics) against the Pallas kernel in interpret mode, atol 1e-5."""
    args = _attn_inputs(8)
    got = tattn.decode_attention(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jengine.decode_attention(
        *(jnp.asarray(a) for a in args), kv_bits=8, backend="pallas",
        interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)

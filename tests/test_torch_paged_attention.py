"""Port parity: the paged decode attention and the fused decode of
``repro_torch.kernels`` against ``repro.kernels`` on the same numpy inputs.

The plain versions (the kernels' semantics: f32 dequant) are held to the
reference's Pallas kernels in interpret mode and to its jnp oracles; the
engine entries on the ``torch`` backend to the reference engine's ``xla``
backend.  Page tables share a block between sequences and point every block
past ``pos`` at the null block 0; one slot map repeats a slot.

Tolerance: atol 1e-5 + rtol 1e-5 in f32 — the same products summed in
another order (online vs one-shot softmax, another matmul order).
"""
import importlib
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core.packing import pack_nibbles  # noqa: E402
from repro.core.precision import get_precision, signed  # noqa: E402
from repro.kernels import decode_fused as jfused  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.kernels import paged_attention as jpaged  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_serving_ref as jserving_ref  # noqa: E402
tdattn = importlib.import_module("repro_torch.kernels.decode_attention")
from repro_torch.kernels import decode_fused as tfused  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, KV, G, DH, NB_POOL, N_BLOCKS = 3, 2, 2, 32, 9, 4


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _inputs(kv_bits, bs, seed=0):
    """(q, k_pool, k_scale, v_pool, v_scale, page_table, pos) as numpy.
    Sequences 0 and 1 share physical block 3 as their first block; entries
    past each sequence's last live block are the null block 0; pos holds 0,
    a position in the last logical block and one in between."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, DH)).astype(np.float32)
    pos = np.array([bs * N_BLOCKS - 2, 0, bs + 3], np.int32)
    pt = np.array([[3, 5, 7, 2],
                   [3, 0, 0, 0],
                   [8, 1, 0, 0]], np.int32)
    shape = (NB_POOL, bs, KV, DH)
    if kv_bits == 16:
        mk = lambda: rng.normal(size=shape).astype(np.float32)
        return q, mk(), None, mk(), None, pt, pos
    qmax = (1 << (kv_bits - 1)) - 1

    def codes():
        c = rng.integers(-qmax, qmax + 1, shape).astype(np.int8)
        return np.array(pack_nibbles(jnp.asarray(c))) if kv_bits == 4 else c
    scale = lambda: rng.uniform(1e-3, 1e-1, (NB_POOL, bs, KV, 1)).astype(
        np.float32)
    return q, codes(), scale(), codes(), scale(), pt, pos


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [(kv, bs) for kv in (16, 8, 4) for bs in (8, 16)]
IDS = [f"kv{kv}-bs{bs}" for kv, bs in CASES]


@pytest.mark.parametrize("kv_bits,bs", CASES, ids=IDS)
def test_paged_attention_matches_pallas_and_oracle(kv_bits, bs):
    args = _inputs(kv_bits, bs)
    got_ref = tpaged.paged_attention_ref(*map(_t, args), kv_bits=kv_bits,
                                         out_dtype=torch.float32).numpy()
    got_wrap = tpaged.paged_attention(*map(_t, args), kv_bits=kv_bits).numpy()
    np.testing.assert_array_equal(got_wrap, got_ref)   # CPU wrapper = plain
    want_pallas = np.asarray(jpaged.paged_attention(
        *map(_j, args), kv_bits=kv_bits, interpret=True))
    want_ref = np.asarray(jpaged.paged_attention_ref(
        *map(_j, args), kv_bits=kv_bits, out_dtype=jnp.float32))
    np.testing.assert_allclose(got_ref, want_pallas, **TOL)
    np.testing.assert_allclose(got_ref, want_ref, **TOL)


@pytest.mark.parametrize("slot_map", [[0, 1, 2], [2, 0, 2, 2]],
                         ids=["all", "repeated"])
@pytest.mark.parametrize("kv_bits,bs", CASES, ids=IDS)
def test_fused_decode_matches_pallas_and_oracle(kv_bits, bs, slot_map):
    """Every slot once, or (2, 0, 2, 2): slot 1 absent, slot 2 repeated."""
    args = _inputs(kv_bits, bs, seed=1)
    rng = np.random.default_rng(2)
    d = 48
    wo = (rng.normal(size=(KV * G * DH, d)) / 8).astype(np.float32)
    sm = np.asarray(slot_map, np.int32)
    got_ref = tfused.fused_decode_ref(*map(_t, args), _t(sm), _t(wo),
                                      kv_bits=kv_bits).numpy()
    got_wrap = tfused.fused_decode(*map(_t, args), _t(sm), _t(wo),
                                   kv_bits=kv_bits).numpy()
    np.testing.assert_array_equal(got_wrap, got_ref)
    assert got_ref.shape == (len(slot_map), d)
    want_pallas = np.asarray(jfused.fused_decode(
        *map(_j, args), _j(sm), _j(wo), kv_bits=kv_bits, interpret=True))
    want_ref = np.asarray(jfused.fused_decode_ref(
        *map(_j, args), _j(sm), _j(wo), kv_bits=kv_bits))
    np.testing.assert_allclose(got_ref, want_pallas, **TOL)
    np.testing.assert_allclose(got_ref, want_ref, **TOL)
    # duplicate rows of one slot are identical
    rows = [i for i, s in enumerate(slot_map) if s == slot_map[0]]
    for i in rows[1:]:
        np.testing.assert_array_equal(got_ref[i], got_ref[rows[0]])


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_engine_paged_attention_matches_xla(kv_bits):
    """``engine.paged_attention`` on the ``torch`` backend (model-dtype
    dequant) against the reference engine's ``xla`` backend, f32."""
    args = _inputs(kv_bits, 8, seed=3)
    got = engine.paged_attention(*map(_t, args), kv_bits=kv_bits,
                                 backend="torch").numpy()
    want = np.asarray(jengine.paged_attention(*map(_j, args), kv_bits=kv_bits,
                                              backend="xla"))
    np.testing.assert_allclose(got, want, **TOL)


def _wo_pair(precision, rng, d=KV * G * DH):
    """The same wo for both packages: float ``qw``, or the reference's
    packed serving form."""
    w = (rng.normal(size=(KV * G * DH, d)) / 8).astype(np.float32)
    pcfg = signed(get_precision(precision))
    if precision == "fp32":
        return pcfg, {"qw": jnp.asarray(w)}, {"qw": torch.from_numpy(w)}
    jpw = jengine.pack_weight(jnp.asarray(w), pcfg)
    jwo = {"wt_packed": jpw.wt_packed, "scale": jpw.scale}
    return pcfg, jwo, {k: torch.from_numpy(np.array(v)) for k, v in jwo.items()}


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_engine_fused_paged_decode_matches_xla(kv_bits, precision):
    """``engine.fused_paged_decode`` (``torch`` backend) against the
    reference's ``xla`` composition: the padded (B, 1, D) output with zero
    rows outside the repeated slot map, atol 1e-5 + rtol 1e-5 in f32 (2xT:
    the projection's per-row activation codes see the same f32 inputs up
    to summation order, and a flipped code would show far above this)."""
    args = _inputs(kv_bits, 8, seed=4)
    pcfg, jwo, two = _wo_pair(precision, np.random.default_rng(5))
    sm = np.array([2, 0, 2], np.int32)
    got = engine.fused_paged_decode(*map(_t, args), _t(sm), two, pcfg,
                                    kv_bits=kv_bits, backend="torch").numpy()
    want = np.asarray(jengine.fused_paged_decode(
        *map(_j, args), _j(sm), jwo, pcfg, kv_bits=kv_bits, backend="xla"))
    assert got.shape == (B, 1, KV * G * DH)
    assert not got[1].any()
    np.testing.assert_allclose(got, want, **TOL)


def test_engine_paged_registry_and_backend_checks():
    """The paged and fused kinds are registered for kv 16/8/4 on both
    backends; ``backend="cuda"`` with CPU tensors raises; the CPU path
    records ``torch`` dispatches and launches nothing."""
    for kind in (engine.ATTN_PAGED, engine.ATTN_FUSED):
        for kv_bits in (16, 8, 4):
            for backend in engine.BACKENDS:
                assert engine.resolve_attention_entry(
                    kind, kv_bits, backend)[1] == (kind, kv_bits, backend)
    assert {"paged_attention", "fused_decode"} <= set(engine.KERNELS)
    args = [_t(a) for a in _inputs(8, 8)]
    pcfg, _, two = _wo_pair("fp32", np.random.default_rng(6))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.paged_attention(*args, kv_bits=8, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.fused_paged_decode(*args, None, two, pcfg, kv_bits=8,
                                  backend="cuda")
    engine.reset_launch_counts()
    with engine.dispatch_trace() as ev:
        engine.paged_attention(*args, kv_bits=8)
        engine.fused_paged_decode(*args, None, two, pcfg, kv_bits=8)
    assert [(e.op, e.impl_backend, e.m_rows) for e in ev] == [
        ("paged_attention", "torch", B), ("fused_paged_decode", "torch", B)]
    assert engine.launch_counts() == {k: 0 for k in engine.KERNELS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_ref_takes_none_scales_for_kv16(dtype):
    """``decode_attention_serving_ref`` with raw (kv16) K/V and no scales,
    against the reference: f32 at atol 1e-5; bf16 storage at the model
    dtype's output rounding (one bf16 ulp of |out| < 4, 2^-6)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, KV, G, DH)).astype(np.float32)
    k, v = (rng.normal(size=(B, 24, KV, DH)).astype(np.float32)
            for _ in range(2))
    pos = np.array([23, 0, 9], np.int32)
    tdt = getattr(torch, dtype)
    got = tdattn.decode_attention_serving_ref(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), None,
        torch.from_numpy(v).to(tdt), None, torch.from_numpy(pos),
        kv_bits=16, dtype=tdt).to(torch.float32).numpy()
    jdt = getattr(jnp, dtype)
    want = np.asarray(jserving_ref(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt), None,
        jnp.asarray(v).astype(jdt), None, jnp.asarray(pos), kv_bits=16,
        dtype=jdt).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32"
                               else 2 ** -6)

"""Port parity: the 1x1 XNOR-popcount path of ``repro_torch`` against
``repro`` — the binary matmul's plain version against the Pallas kernel (in
interpret mode, through the reference engine's ``pallas`` entry) and the
reference's oracle, the engine's 1x1 ``qmatmul``
(float, int8 +/-1, pre-packed int32 and unaligned-K inputs, ragged M)
against the reference engine's ``xla`` and ``pallas`` backends, the reduced
smollm at 1x1 (float32) and its greedy streams through the dense and paged
batchers, and the launcher.

Tolerances: integer accumulators are exact, so integer inputs give
bit-equal outputs.  Float inputs take a 1-bit row scale mean|x|, an f32 mean
that XLA and torch sum in another order: float epilogues within rtol/atol
1e-6.  Logits: atol 1e-4 in float32, as ``tests/test_torch_model.py``; a
bf16 row scale can move by one bf16 ulp, so 1x1 LMs are held in float32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core.precision import get_precision, signed  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine, ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

RNG = np.random.default_rng(17)
PCFG = signed(get_precision("1x1"))
SHAPES = [(5, 96, 128), (13, 160, 256), (31, 64, 80), (4, 192, 576)]  # (M, N, K)


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _bits(m, k):
    """(M, K/32) int32 words of random +/-1 values, via the reference."""
    pm1 = np.where(RNG.random((m, k)) < 0.5, -1, 1).astype(np.int8)
    return np.array(jpack.pack_binary_pm1(jnp.asarray(pm1)))


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
def _xnor_entry(pkg, backend):
    """The engine's (binary, 1 act bit, 1 weight bit) implementation: the
    kernel modules themselves stay private to the engines."""
    return pkg.resolve_entry("binary", 1, 1, backend)[0]


@pytest.mark.parametrize("m,n,k,bkw", [(8, 128, 256, 2), (16, 64, 96, 1),
                                       (8, 256, 1536, 16)])
def test_binary_matmul_ref_matches_pallas(m, n, k, bkw):
    """K - 2 * popcount(a XOR w) times alpha (and a row scale): exact on
    the integer accumulator, so bit-equal to the Pallas kernel (interpret
    mode) and the reference's oracle."""
    a, w = _bits(m, k), _bits(n, k)
    alpha = RNG.uniform(0.5, 1.5, n).astype(np.float32)
    rs = RNG.uniform(0.5, 1.5, (m, 1)).astype(np.float32)
    ta, tw, tal = (torch.from_numpy(v) for v in (a, w, alpha))
    raw = ref.binary_matmul_ref(ta, tw, k).numpy()
    np.testing.assert_array_equal(
        raw, np.asarray(jref.binary_matmul_ref(jnp.asarray(a), jnp.asarray(w), k)))
    assert np.abs(raw).max() <= k and (raw % 2 == k % 2).all()
    jpw = jengine.PackedWeight(jnp.asarray(w), jnp.asarray(alpha), 1, "binary", k)
    pallas = np.asarray(_xnor_entry(jengine, "pallas")(
        jnp.asarray(a), jpw, jnp.asarray(alpha), None, block=(8, 64, 32 * bkw),
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(ref.binary_matmul_ref(ta, tw, k, alpha=tal).numpy(),
                                  pallas)
    np.testing.assert_array_equal(
        ref.binary_matmul_ref(ta, tw, k, alpha=tal,
                              row_scale=torch.from_numpy(rs)).numpy(),
        np.asarray(jref.binary_matmul_ref(jnp.asarray(a), jnp.asarray(w), k,
                                          alpha=jnp.asarray(alpha),
                                          row_scale=jnp.asarray(rs))))


def test_binary_wrapper_cpu_path_and_checks():
    """The engine's ``cuda`` entry calls the wrapper, which on a host tensor
    is the plain version (+ bias) and launches nothing; a K that is not 32
    per word is refused."""
    a, w = torch.from_numpy(_bits(6, 64)), torch.from_numpy(_bits(40, 64))
    alpha, bias = torch.rand(40) + 0.5, torch.randn(40)
    kernel = _xnor_entry(engine, "cuda")
    engine.reset_launch_counts()
    got = kernel(a, engine.PackedWeight(w, alpha, 1, "binary", 64), alpha, bias,
                 out_dtype=torch.float32)
    assert torch.equal(got, ref.binary_matmul_ref(a, w, 64, alpha=alpha)
                       + bias[None, :])
    assert engine.launch_counts()["binary_matmul"] == 0
    with pytest.raises(ValueError, match="K mismatch"):
        kernel(a, engine.PackedWeight(w, alpha, 1, "binary", 96), alpha, None,
               out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the engine at 1x1
# ---------------------------------------------------------------------------
def _packed_pair(k, n):
    """The reference's packed weight, and the same words and scales for the
    port (scales are f32 means: a port-packed copy would differ by ulps)."""
    w = RNG.normal(size=(k, n)).astype(np.float32)
    jpw = jengine.pack_weight(jnp.asarray(w), PCFG)
    tpw = engine.pack_weight(torch.from_numpy(w), PCFG)
    np.testing.assert_array_equal(tpw.wt_packed.numpy(), np.asarray(jpw.wt_packed))
    np.testing.assert_allclose(tpw.scale.numpy(), np.asarray(jpw.scale), rtol=1e-6)
    same = engine.PackedWeight(torch.from_numpy(np.array(jpw.wt_packed)),
                               torch.from_numpy(np.array(jpw.scale)),
                               jpw.bits, jpw.mode, jpw.k)
    return jpw, same


def _both(x, jpw, tpw, bias=None, backends=("xla", "pallas")):
    got = engine.qmatmul(torch.from_numpy(x), tpw, PCFG,
                         bias=None if bias is None else torch.from_numpy(bias))
    wants = [np.asarray(jengine.qmatmul(
        jnp.asarray(x), jpw, PCFG, bias=None if bias is None else jnp.asarray(bias),
        backend=b, interpret=True)) for b in backends]
    return got.numpy(), wants


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "m%dn%dk%d" % s)
def test_qmatmul_1x1_float(shape):
    """Float activations: signs (x >= 0 -> +1) and the row scale mean|x|,
    then the exact XNOR accumulator and the f32 epilogue, with and without
    a bias (the unaligned K=80 weight stays int8 codes: the plain dot)."""
    m, n, k = shape
    jpw, tpw = _packed_pair(k, n)
    assert engine.storage_kind(tpw) == ("binary" if k % 32 == 0 else "codes")
    x = RNG.normal(size=(m, k)).astype(np.float32)
    for bias in (None, RNG.normal(size=n).astype(np.float32)):
        got, wants = _both(x, jpw, tpw, bias)
        for want in wants:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "m%dn%dk%d" % s)
def test_qmatmul_1x1_int8_codes_exact(shape):
    """int8 +/-1 codes (packed by the engine for the XNOR path): bit-equal
    to both reference backends."""
    m, n, k = shape
    jpw, tpw = _packed_pair(k, n)
    x = np.where(RNG.random((m, k)) < 0.5, -1, 1).astype(np.int8)
    got, wants = _both(x, jpw, tpw)
    for want in wants:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 32 == 0],
                         ids=lambda s: "m%dn%dk%d" % s)
def test_qmatmul_1x1_prepacked_exact(shape):
    """Pre-packed int32 +/-1 words pass straight to the XNOR path, at 1x1
    and (the reference's int32 branch) under 8xB: bit-equal."""
    m, n, k = shape
    jpw, tpw = _packed_pair(k, n)
    x = _bits(m, k)
    got, wants = _both(x, jpw, tpw)
    for want in wants:
        np.testing.assert_array_equal(got, want)
    cfg8 = get_precision("8xB")
    np.testing.assert_array_equal(
        engine.qmatmul(torch.from_numpy(x), tpw, cfg8).numpy(),
        np.asarray(jengine.qmatmul(jnp.asarray(x), jpw, cfg8, backend="xla")))


def test_qmatmul_1x1_dispatch():
    """1x1 resolves to the binary kernel's key; the CPU path runs its plain
    version and launches nothing; the row scale is (M, 1)."""
    _, tpw = _packed_pair(128, 64)
    engine.reset_launch_counts()
    with engine.dispatch_trace() as ev:
        engine.qmatmul(torch.randn(3, 2, 128), tpw, PCFG)
    assert [(e.kind, e.impl_backend, e.a_bits, e.m_rows, e.a_scale_shape)
            for e in ev] == [("binary", "torch", 1, 6, (6, 1))]
    assert engine.resolve_entry("binary", 1, 1, "cuda")[1] == ("binary", 1, 1, "cuda")
    assert engine.launch_counts()["binary_matmul"] == 0


# ---------------------------------------------------------------------------
# the reduced smollm at 1x1
# ---------------------------------------------------------------------------
S_MAX, CHUNK, BS = 32, 8, 8
_MODELS = {}


def _pair(kv_bits):
    """(jax model, jax serving params, port model, port serving params) of
    the reduced smollm at 1x1 in float32.  The reference's default tp=16
    layout keeps ``wo`` and ``w_down`` as int8 +/-1 codes (K/16 does not
    fill a 32-bit word) and packs the rest."""
    if kv_bits not in _MODELS:
        jcfg = dataclasses.replace(reduce_for_smoke(jget_config(
            "smollm-135m", precision="1x1", kv_bits=kv_bits)), dtype="float32")
        tcfg = dataclasses.replace(treduce(get_config(
            "smollm-135m", precision="1x1", kv_bits=kv_bits)), dtype="float32")
        jm = jbuild(jcfg)
        jsv = reference_jit(lambda key: jto_serving(jm.init(key), jcfg))(
            jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.array, jsv), "cpu")
        _MODELS[kv_bits] = (jm, jsv, build_model(tcfg), tp)
    return _MODELS[kv_bits]


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("kv_bits", [8, 0])
def test_1x1_chunk_and_decode_logits(kv_bits):
    """Two prefill chunks, then one decode step at ragged per-slot
    positions: logits within atol 1e-4; both binary storages ran."""
    jm, jsv, tm, tp = _pair(kv_bits)
    layer = {**tp["blocks"]["layer_0"]["attn"], **tp["blocks"]["layer_0"]["ffn"]}
    words, codes = torch.int32, torch.int8
    assert {name: p["wt_packed"].dtype for name, p in layer.items()
            if "wt_packed" in p} == {"wq": words, "wk": words, "wv": words,
                                     "wo": codes, "w_gate": words,
                                     "w_up": words, "w_down": codes}
    toks = _tokens(1, 16, tm.cfg.vocab, seed=1)
    cj = jtfm.make_cache(jm.cfg, 1, S_MAX)
    ct = tfm.make_cache(tm.cfg, 1, S_MAX, "cpu")
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        lj, cj = jm.prefill_chunk(jsv, jnp.asarray(chunk), cj, start)
        lt, ct = tm.prefill_chunk(tp, torch.from_numpy(chunk).long(), ct, start)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    toks = _tokens(3, 10, tm.cfg.vocab, seed=2)
    _, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    _, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, S_MAX)
    pos = np.array([10, 7, 4], np.int32)
    with engine.dispatch_trace() as ev:
        lt, _ = tm.decode_step(tp, torch.from_numpy(toks[:, -1:]).long(), ct,
                               torch.from_numpy(pos))
    lj, _ = jm.decode_step(jsv, jnp.asarray(toks[:, -1:]), cj, jnp.asarray(pos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    per_layer = [e.kind for e in ev if e.op == "qmatmul"]
    assert per_layer.count("binary") == 5 * tm.cfg.n_layers
    assert per_layer.count("codes") == 2 * tm.cfg.n_layers


PROMPTS = [5, 11, 3, 16, 9]
MAX_NEW = [4, 6, 3, 5, 4]


def test_1x1_dense_batcher_streams_match_reference():
    """Five ragged requests over two slots (chunks of 8), int8 KV cache:
    identical greedy streams and step counts."""
    jm, jsv, tm, tp = _pair(8)
    prompts = [np.random.default_rng(5).integers(0, tm.cfg.vocab, (1, n))
               .astype(np.int32) for n in PROMPTS]
    outs = []
    for pkg, model, params in ((jserving, jm, jsv), (tserving, tm, tp)):
        b = pkg.ContinuousBatcher(model, params, pkg.ServingConfig(
            n_slots=2, s_max=24, chunk_size=CHUNK))
        for rid, (p, n) in enumerate(zip(prompts, MAX_NEW)):
            b.submit(pkg.Request(rid, p.astype(np.int64), options=pkg.RequestOptions(
                max_new=n)))
        done = b.run()
        outs.append(({r.rid: list(r.output) for r in done},
                     (b.metrics.decode_steps, b.metrics.prefill_chunks)))
    assert outs[0] == outs[1]
    assert [len(outs[1][0][i]) for i in range(len(PROMPTS))] == MAX_NEW


def test_1x1_paged_batcher_lockstep():
    """Six requests, four sharing a 16-token prefix, over three slots and a
    7-block kv8 pool, the reference's paged batcher and the port's stepped
    together: page tables equal after every step, ``check_pool()`` after
    every step on both, identical greedy streams and prefix counters."""
    jm, jsv, tm, tp = _pair(0)
    rng = np.random.default_rng(11)
    base = rng.integers(0, 500, 16)
    prompts = [np.concatenate([base if i < 4 else rng.integers(0, 500, 8),
                               rng.integers(0, 500, 2 + 3 * i)])[None].astype(np.int32)
               for i in range(6)]
    max_new = [6, 5, 7, 4, 6, 5]
    kw = dict(n_slots=3, s_max=S_MAX, chunk_size=CHUNK, block_size=BS,
              kv_bits=8, num_blocks=7)
    jb = jkv.PagedBatcher(jm, jsv, jserving.ServingConfig(**kw))
    tb = tkv.PagedBatcher(tm, tp, tserving.ServingConfig(**kw))
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        jb.submit(jserving.Request(rid, p, options=jserving.RequestOptions(max_new=n)))
        tb.submit(tserving.Request(rid, p.astype(np.int64),
                                   options=tserving.RequestOptions(max_new=n)))
    jdone, tdone = [], []
    for _ in range(300):
        jdone += jb.step()
        tdone += tb.step()
        jb.check_pool()
        tb.check_pool()
        np.testing.assert_array_equal(tb._pt, np.asarray(jb._pt))
        if jb.idle and tb.idle:
            break
    assert jb.idle and tb.idle
    streams = lambda done: {r.rid: list(r.output) for r in done}
    assert streams(tdone) == streams(jdone)
    assert [len(streams(tdone)[i]) for i in range(6)] == max_new
    for name in ("decode_steps", "prefill_chunks", "prefix_hit_tokens",
                 "preemptions", "kv_blocks_peak"):
        assert getattr(tb.metrics, name) == getattr(jb.metrics, name), name
    assert tb.metrics.prefix_hit_tokens > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_launcher_1x1_cpu(capsys, paged):
    args = ["--reduced", "--device", "cpu", "--precision", "1x1",
            "--requests", "3", "--slots", "2", "--prompt-len", "10", "--gen", "3"]
    done = tserve.main(args + (["--paged"] if paged else []))
    assert sorted(len(r.output) for r in done) == [3, 3, 3]
    out = capsys.readouterr().out
    assert "1x1 serving form" in out and "binary_matmul=0" in out
    assert ("paged KV cache:" in out) == paged

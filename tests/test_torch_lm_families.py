"""Port parity for the last decoder-only LM families: the reduced
gemma2-27b (local / global attention, softcaps, post-norms, the embedding
scale; also with its window cut to 8 so that reduced prompts reach it),
glm4-9b (16 query heads a KV head at full size), starcoder2-15b (non-gated
gelu FFN), internvl2-76b (the embeds frontend) and kimi-k2-1t-a32b (MoE)
through ``repro_torch.models`` against ``repro.models``: prefill,
prefill_chunk, decode_step, forward logits and loss, greedy streams, the
paged steps of the pageable stacks, the dense and paged batchers in
lockstep with the reference's, and the launcher.  Also the gelu fault C3:
the port's ``_act(x, "gelu")`` against ``jax.nn.gelu``.

Params are the reference's own, through ``interop``.  Logit tolerance atol
1e-4 (f32 summation order, as tests/test_torch_model.py); greedy streams
identical.  MoE capacity depends on the rows of a call, so every
comparison runs the same batch through both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import reduce_for_smoke  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

ATOL = 1e-4
S_MAX = 32
# "gemma2-w8": gemma2-27b with window 8 on both sides (reduce_for_smoke
# keeps 4096, which no reduced prompt reaches)
ARCHS = ["gemma2-27b", "gemma2-w8", "glm4-9b", "starcoder2-15b",
         "internvl2-76b", "kimi-k2-1t-a32b"]
PAGEABLE = [a for a in ARCHS if a != "internvl2-76b"]
CASES = [("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)]
GRID = [(a, p, k) for a in ARCHS for p, k in CASES]
GRID_IDS = [f"{a.split('-')[0]}{'-w8' if 'w8' in a else ''}-{p}-kv{k}"
            for a, p, k in GRID]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side is many small ops: one intra-op thread keeps them
    from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def test_gelu_matches_jax():
    """Fault C3: ``jax.nn.gelu`` defaults to the tanh approximation; the
    erf form (``F.gelu(x)``) parts from it by up to 4.7e-4 on [-6, 6]."""
    x = np.linspace(-6.0, 6.0, 20001, dtype=np.float32)
    got = L._act(torch.from_numpy(x), "gelu").numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6


def _cfgs(arch, precision, kv_bits):
    base = "gemma2-27b" if arch == "gemma2-w8" else arch
    jcfg = jreduce(jget_config(base, precision=precision, kv_bits=kv_bits))
    tcfg = reduce_for_smoke(get_config(base, precision=precision,
                                       kv_bits=kv_bits))
    if arch == "gemma2-w8":
        jcfg = dataclasses.replace(jcfg, window=8)
        tcfg = dataclasses.replace(tcfg, window=8)
    return jcfg, tcfg


_MODELS = {}
_PARAMS = {}


def _pair(arch, precision, kv_bits):
    """(jax model, jax serving params, port model, port serving params),
    the reference's prefill, decode step, forward (and so its loss) and
    prefill chunk jitted (an eager scan compiles its body on every call).
    The serving params do not depend on the KV cache's bits: one draw and
    packing serves every kv_bits of a precision."""
    key = (arch, precision, kv_bits)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, precision, kv_bits)
        jm = jbuild(jcfg)
        if (arch, precision) not in _PARAMS:
            jsv = jax.jit(lambda k: jto_serving(jm.init(k), jcfg))(
                jax.random.PRNGKey(0))
            _PARAMS[arch, precision] = (jsv, params_from_numpy(
                jax.tree_util.tree_map(np.array, jsv), "cpu"))
        jsv, tp = _PARAMS[arch, precision]
        jm = dataclasses.replace(
            jm, prefill=jax.jit(jm.prefill, static_argnums=2),
            decode_step=jax.jit(jm.decode_step), forward=jax.jit(jm.forward),
            prefill_chunk=jm.prefill_chunk and jax.jit(jm.prefill_chunk))
        _MODELS[key] = (jm, jsv, build_model(tcfg), tp)
    return _MODELS[key]


def _inputs(cfg, b, s, seed):
    """Token ids (int32), or the embeds frontend's (B, S, D) f32 embeddings,
    as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embeds":
        return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _t(a):
    t = torch.from_numpy(np.asarray(a))
    return t if t.is_floating_point() else t.long()


def _batch(cfg, x):
    return {"embeds" if cfg.frontend == "embeds" else "tokens": x}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_registry_and_post_norm_keys():
    """All ten reference arch ids build; the post-norms and the embedding
    scale follow the config's fields, never its name."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        cfg = reduce_for_smoke(get_config(arch))
        build_model(cfg)
        assert cfg.post_norms == cfg.embed_scale == (arch == "gemma2-27b")
    cfg = reduce_for_smoke(get_config("glm4-9b"))
    p = build_model(dataclasses.replace(cfg, post_norms=True)).init(
        torch.Generator().manual_seed(0), "cpu")
    assert "post_norm" in p["blocks"]["layer_0"]["attn"]
    assert "post_norm" in p["blocks"]["layer_0"]["ffn"]
    renamed = dataclasses.replace(reduce_for_smoke(get_config("gemma2-27b")),
                                  name="renamed", post_norms=False)
    p = build_model(renamed).init(torch.Generator().manual_seed(0), "cpu")
    assert "post_norm" not in p["blocks"]["layer_0"]["attn"]


def test_embed_scale_rounds_to_the_model_dtype():
    """sqrt(4608) = 67.88 is rounded to the model dtype before the multiply,
    as the reference does: 68.0 in bf16."""
    cfg = dataclasses.replace(get_config("gemma2-27b"), dtype="bfloat16")
    params = {"embed": {"w": torch.ones((4, 3), dtype=torch.bfloat16)}}
    x = tfm._embed(params, torch.tensor([[1, 2]]), cfg)
    assert x.dtype == torch.bfloat16 and bool((x == 68.0).all())
    params = {"embed": {"w": torch.ones((4, 3), dtype=torch.float32)}}
    x = tfm._embed(params, torch.tensor([[1]]),
                   dataclasses.replace(cfg, dtype="float32"))
    assert abs(float(x[0, 0, 0]) - 4608 ** 0.5) < 1e-5


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_prefill_and_decode_logits(arch, precision, kv_bits):
    """A whole prompt (B=3, 12 positions: past gemma2-w8's window), then
    one decode step at ragged per-slot positions.  The prefill's KV codes
    are held within one step of the reference's; the decode step is held
    on the same inputs, the reference's cache (a K/V value on a rounding
    boundary rounds either way under f32 summation order, and one such
    code moves the next step's logits by ~1e-4)."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    x = _inputs(tm.cfg, 3, 12, seed=2)
    lj, cj = jm.prefill(jsv, _batch(tm.cfg, jnp.asarray(x)), S_MAX)
    lt, ct = tm.prefill(tp, _batch(tm.cfg, _t(x)), S_MAX)
    _close(lt, lj)
    for name, leaf in ct.items():
        for k, v in leaf.items():
            if v.dtype == torch.int8:
                diff = np.abs(v.numpy().astype(np.int16)
                              - np.asarray(cj[name][k]).astype(np.int16))
                assert diff.max() <= 1, f"{name}/{k}"
    pos = np.array([12, 9, 4], np.int32)
    step = _inputs(tm.cfg, 3, 1, seed=9)
    lj, _ = jm.decode_step(jsv, jnp.asarray(step), cj, jnp.asarray(pos))
    ct = params_from_numpy(jax.tree_util.tree_map(np.array, cj), "cpu")
    lt, _ = tm.decode_step(tp, _t(step), ct, torch.from_numpy(pos))
    _close(lt, lj)


def _step_input(cfg, tok_np):
    """The next decode step's input: the greedy token, or (embeds) the
    zero embedding the reference's launcher feeds."""
    if cfg.frontend == "embeds":
        return np.zeros((tok_np.shape[0], 1, cfg.d_model), np.float32)
    return tok_np[:, None].astype(np.int32)


@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_greedy_streams_identical(arch, precision, kv_bits):
    """Prefill then 9 decode steps, greedy, B=2: identical tokens (gemma2-w8
    decodes past its window)."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    x = _inputs(tm.cfg, 2, 9, seed=3)
    lj, cj = jm.prefill(jsv, _batch(tm.cfg, jnp.asarray(x)), S_MAX)
    lt, ct = tm.prefill(tp, _batch(tm.cfg, _t(x)), S_MAX)
    tj, tt = np.asarray(jnp.argmax(lj[:, -1], -1)), lt[:, -1].argmax(-1)
    out_j, out_t = [tj], [tt.numpy()]
    for i in range(9):
        step_j, step_t = _step_input(tm.cfg, tj), _step_input(tm.cfg,
                                                              tt.numpy())
        lj, cj = jm.decode_step(jsv, jnp.asarray(step_j), cj, 9 + i)
        lt, ct = tm.decode_step(tp, _t(step_t), ct, 9 + i)
        tj, tt = np.asarray(jnp.argmax(lj[:, 0], -1)), lt[:, 0].argmax(-1)
        out_j.append(tj)
        out_t.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_forward_logits_and_loss(arch, precision):
    """``Model.forward`` (S 20: past gemma2-w8's window) and ``Model.loss``
    against the reference's; the MoE aux within 1e-5."""
    jm, jsv, tm, tp = _pair(arch, precision, 0)
    x = _inputs(tm.cfg, 2, 20, seed=5)
    lj, aj = jm.forward(jsv, _batch(tm.cfg, jnp.asarray(x)))
    lt, at = tm.forward(tp, _batch(tm.cfg, _t(x)))
    _close(lt, lj)
    assert abs(float(at) - float(aj)) <= 1e-5
    labels = np.random.default_rng(6).integers(0, tm.cfg.vocab, (2, 20))
    jb = dict(_batch(tm.cfg, jnp.asarray(x)), labels=jnp.asarray(labels))
    tb = dict(_batch(tm.cfg, _t(x)), labels=_t(labels))
    assert abs(float(tm.loss(tp, tb)) - float(jm.loss(jsv, jb))) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 0)])
def test_prefill_chunk_logits(arch, precision, kv_bits):
    """Two chunks of 8 against a batch-1 cache (embeds chunks for
    internvl2), each held to the reference's chunk path."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    x = _inputs(tm.cfg, 1, 16, seed=1)
    cj = jtfm.make_cache(jm.cfg, 1, S_MAX)
    ct = tfm.make_cache(tm.cfg, 1, S_MAX, "cpu")
    for start in (0, 8):
        chunk = x[:, start:start + 8]
        lj, cj = jm.prefill_chunk(jsv, jnp.asarray(chunk), cj, start)
        lt, ct = tm.prefill_chunk(tp, _t(chunk), ct, start)
        _close(lt, lj)


def test_pageable_stacks():
    """The embeds frontend has no paged entry points, in both packages."""
    for arch in ARCHS:
        jm, _, tm, _ = _pair(arch, "2xT", 0)
        for name in ("prefill_chunk_paged", "decode_step_paged",
                     "decode_window_paged"):
            assert (getattr(tm, name) is None) == (getattr(jm, name) is None)
            assert (getattr(tm, name) is None) == (arch not in PAGEABLE)


@pytest.mark.parametrize("arch", PAGEABLE)
@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 16)])
def test_paged_steps(arch, precision, kv_bits):
    """Two paged prefill chunks, then one decode step over three slots
    (fused and unfused; gemma2's softcap takes the gathered path): logits
    within 1e-4 of the reference's."""
    jm, jsv, tm, tp = _pair(arch, precision, 0)
    bs, nb = 8, S_MAX // 8
    jpool = jtfm.make_pool(jm.cfg, 10, bs, kv_bits)
    tpool = tfm.make_pool(tm.cfg, 10, bs, kv_bits, "cpu")
    toks = _inputs(tm.cfg, 1, 16, seed=8)
    row = np.array([[4, 7, 0, 0]], np.int32)
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        lj, jpool = jm.prefill_chunk_paged(jsv, jnp.asarray(chunk), jpool,
                                           jnp.asarray(row), start, kv_bits)
        lt, tpool = tm.prefill_chunk_paged(tp, _t(chunk), tpool,
                                           torch.from_numpy(row), start,
                                           kv_bits)
        _close(lt, lj)
    pt = np.array([[4, 7, 5, 0], [4, 2, 0, 0], [4, 0, 0, 0]], np.int32)
    assert pt.shape[1] == nb
    pos = np.array([16, 9, 3], np.int32)
    step = np.repeat(toks[:, -1:], 3, axis=0)
    for fused in (True, False):
        jp = jax.tree_util.tree_map(jnp.copy, jpool)
        tq = {k: {n: t.clone() for n, t in v.items()}
              for k, v in tpool.items()}
        lj, _ = jm.decode_step_paged(jsv, jnp.asarray(step), jp,
                                     jnp.asarray(pt), jnp.asarray(pos),
                                     kv_bits, fused=fused)
        lt, _ = tm.decode_step_paged(tp, _t(step), tq, torch.from_numpy(pt),
                                     torch.from_numpy(pos), kv_bits,
                                     fused=fused)
        _close(lt, lj)


# ---------------------------------------------------------------------------
# the batchers
# ---------------------------------------------------------------------------
PROMPTS = [5, 11, 3, 16, 9]
MAX_NEW = [4, 6, 3, 5, 4]


def _serve(pkg, model, params, chunk_size, paged=False):
    sc = pkg.ServingConfig(n_slots=2, s_max=24, chunk_size=chunk_size,
                           kv_bits=8, block_size=8)
    if paged:
        cls = jkv.PagedBatcher if pkg is jserving else tkv.PagedBatcher
    else:
        cls = pkg.ContinuousBatcher
    batcher = cls(model, params, sc)
    cast = np.int32 if pkg is jserving else np.int64
    rng = np.random.default_rng(5)
    for rid, (n, new) in enumerate(zip(PROMPTS, MAX_NEW)):
        toks = rng.integers(0, model.cfg.vocab, (1, n))
        batcher.submit(pkg.Request(rid, toks.astype(cast),
                                   options=pkg.RequestOptions(max_new=new)))
    done = batcher.run()
    assert len(done) == len(PROMPTS)
    return {r.rid: list(r.output) for r in done}, batcher


@pytest.mark.parametrize("arch,kv_bits,chunk,paged", [
    ("gemma2-w8", 8, 8, False), ("gemma2-w8", 0, 8, True),
    ("glm4-9b", 8, 8, False), ("glm4-9b", 0, 8, True),
    ("starcoder2-15b", 8, 0, False), ("kimi-k2-1t-a32b", 8, 8, False)],
    ids=["gemma2-w8-chunked", "gemma2-w8-paged", "glm4-chunked",
         "glm4-paged", "starcoder2-whole", "kimi-chunked"])
def test_batcher_streams_match_reference(arch, kv_bits, chunk, paged):
    """Five ragged requests over two slots through the port's batcher and
    the reference's at 2xT: identical greedy streams and scheduler
    counters."""
    jm, jsv, tm, tp = _pair(arch, "2xT", kv_bits)
    want, jb = _serve(jserving, jm, jsv, chunk, paged)
    got, tb = _serve(tserving, tm, tp, chunk, paged)
    assert got == want
    assert (tb.metrics.decode_steps, tb.metrics.prefill_chunks,
            tb.metrics.prefill_full) == (jb.metrics.decode_steps,
                                         jb.metrics.prefill_chunks,
                                         jb.metrics.prefill_full)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
CLI = ["--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
       "--prompt-len", "8", "--gen", "3"]


@pytest.mark.parametrize("arch", ["gemma2-27b", "glm4-9b", "starcoder2-15b",
                                  "kimi-k2-1t-a32b"])
def test_launcher_token_lms(arch, capsys):
    """The decoder-only token LMs through the batcher: chunked admission,
    with the whole-prompt line under ``--chunk-size 0``."""
    done = tserve.main(["--arch", arch] + CLI)
    assert sorted(len(r.output) for r in done) == [3, 3, 3]
    assert "chunked prefill: chunk=" in capsys.readouterr().out
    tserve.main(["--arch", arch, "--chunk-size", "0"] + CLI)
    out = capsys.readouterr().out
    assert "whole-prompt admission (--chunk-size 0)" in out
    assert "full prefills 3" in out


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_launcher_legacy_loop(arch, capsys):
    """The enc-dec and embeds stacks through the legacy loop, whose lines
    are the reference launcher's: the prefill / decode line and the sample
    generations, (requests, gen) tokens."""
    toks = tserve.main(["--arch", arch] + CLI)
    assert toks.shape == (3, 3)
    out = capsys.readouterr().out
    assert "prefill: 3 reqs x 8 tok in " in out and " tok/s (" in out
    assert "sample generations (first 8 tokens/request):" in out
    assert "kernel launches per decode step (2 steps): " in out

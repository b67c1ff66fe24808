"""Port parity for the MoE, Mamba and hybrid stacks as a whole: the reduced
granite-moe-1b-a400m (attention + MoE), falcon-mamba-7b (Mamba only) and
jamba-v0.1-52b (Mamba + attention, dense + MoE FFNs) through
``repro_torch.models`` against ``repro.models`` — prefill, prefill_chunk,
decode_step and forward logits, greedy streams, granite's paged steps —
and through the batchers: the refusal of chunked and paged admission for
the stacks with Mamba layers, their whole-prompt streams, granite through
both batchers in lockstep with the reference's at the same slot count, and
the launcher.  Params are the reference's own, through ``interop``.

Logit tolerance atol 1e-4 (f32 summation order, as
tests/test_torch_model.py); greedy streams identical.  MoE capacity
depends on the rows of a call, so every comparison runs the same batch
through both packages (never a solo run against a batched one).
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

ATOL = 1e-4
S_MAX = 32
ARCHS = ["granite-moe-1b-a400m", "falcon-mamba-7b", "jamba-v0.1-52b"]
CASES = [("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)]
GRID = [(a, p, k) for a in ARCHS for p, k in CASES]
GRID_IDS = [f"{a.split('-')[0]}-{p}-kv{k}" for a, p, k in GRID]


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


_MODELS = {}
_PARAMS = {}


def _pair(arch, precision, kv_bits):
    """(jax model, jax serving params, port model, port serving params).
    The reference model's prefill, decode step, forward (and so its loss)
    and prefill chunk are jitted (eager, the reduced jamba takes seconds a
    call, and an eager scan compiles its body on every call).  The serving
    params do not depend on the KV cache's bits: one draw and packing
    serves every kv_bits of a precision."""
    key = (arch, precision, kv_bits)
    if key not in _MODELS:
        jcfg = jreduce(jget_config(arch, precision=precision, kv_bits=kv_bits))
        tcfg = reduce_for_smoke(get_config(arch, precision=precision,
                                           kv_bits=kv_bits))
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


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_prefill_and_decode_logits(arch, precision, kv_bits):
    """A whole-prompt prefill (B=3), then one decode step at ragged
    per-slot positions; the cache the decode step reads is held too: Mamba
    states within atol 1e-4, KV codes within one step (a value on a
    rounding boundary may round either way under f32 summation order)."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    toks = _tokens(3, 10, tm.cfg.vocab, seed=2)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, S_MAX)
    _close(lt, lj)
    for name, leaf in ct.items():
        for k, v in leaf.items():
            if v.dtype == torch.int8:
                diff = np.abs(v.numpy().astype(np.int16)
                              - np.asarray(cj[name][k]).astype(np.int16))
                assert diff.max() <= 1, f"{name}/{k}"
            elif k in ("conv", "ssm"):
                np.testing.assert_allclose(v.numpy(), np.asarray(cj[name][k]),
                                           atol=ATOL, err_msg=f"{name}/{k}")
    pos = np.array([10, 7, 4], np.int32)
    step = toks[:, -1:]
    lj, _ = jm.decode_step(jsv, jnp.asarray(step), cj, jnp.asarray(pos))
    lt, _ = tm.decode_step(tp, _t(step), ct, torch.from_numpy(pos))
    _close(lt, lj)


@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_greedy_streams_identical(arch, precision, kv_bits):
    """Prefill then 7 decode steps, greedy, B=2: identical tokens.  (Each
    step's logits are not bounded here: through an int8 KV cache a value
    on a code's rounding boundary may round either way under f32 summation
    order, and one such code moves later logits by about 1e-3.  The single
    steps above are bounded.)"""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    toks = _tokens(2, 9, tm.cfg.vocab, seed=3)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, S_MAX)
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    out_j, out_t = [np.asarray(tj)], [tt.numpy()]
    for i in range(7):
        lj, cj = jm.decode_step(jsv, tj[:, None].astype(jnp.int32), cj, 9 + i)
        lt, ct = tm.decode_step(tp, tt[:, None], ct, 9 + i)
        tj, tt = jnp.argmax(lj[:, 0], -1), lt[:, 0].argmax(-1)
        out_j.append(np.asarray(tj))
        out_t.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_forward_logits_and_aux(arch, precision):
    """``Model.forward`` and ``Model.loss`` (which adds 0.01 * aux): logits
    within 1e-4, aux within 1e-5 (a sum of per-layer terms, each within
    1e-6)."""
    jm, jsv, tm, tp = _pair(arch, precision, 0)
    toks = _tokens(2, 20, tm.cfg.vocab, seed=5)
    lj, aj = jm.forward(jsv, {"tokens": jnp.asarray(toks)})
    lt, at = tm.forward(tp, {"tokens": _t(toks)})
    _close(lt, lj)
    assert abs(float(at) - float(aj)) <= 1e-5
    assert (float(at) > 0) == ("falcon" not in arch)
    batch = {"tokens": toks, "labels": _tokens(2, 20, tm.cfg.vocab, seed=6)}
    want = float(jm.loss(jsv, jax.tree_util.tree_map(jnp.asarray, batch)))
    got = float(tm.loss(tp, {k: _t(v) for k, v in batch.items()}))
    assert abs(got - want) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 0)])
def test_prefill_chunk_logits(arch, precision, kv_bits):
    """Two chunks against a batch-1 cache, each held to the reference's
    chunk path: KV appends for attention, the conv / SSM state carried from
    chunk to chunk for Mamba."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    toks = _tokens(1, 16, tm.cfg.vocab, seed=1)
    cj = jtfm.make_cache(jm.cfg, 1, S_MAX)
    ct = tfm.make_cache(tm.cfg, 1, S_MAX, "cpu")
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        lj, cj = jm.prefill_chunk(jsv, jnp.asarray(chunk), cj, start)
        lt, ct = tm.prefill_chunk(tp, _t(chunk), ct, start)
        _close(lt, lj)


def test_one_position_prompt_matches_reference():
    """A one-token prompt: the Mamba layers return no state, so the cache
    holds None there and the next decode step starts from a zero state, in
    both packages."""
    jm, jsv, tm, tp = _pair("falcon-mamba-7b", "fp32", 0)
    toks = _tokens(2, 1, tm.cfg.vocab, seed=7)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, S_MAX)
    _close(lt, lj)
    assert cj["layer_0"] is None and ct["layer_0"] is None
    lj, _ = jm.decode_step(jsv, jnp.asarray(toks), cj, 1)
    lt, _ = tm.decode_step(tp, _t(toks), ct, 1)
    _close(lt, lj)


def test_pageable_only_attention_stacks():
    for arch in ARCHS:
        tm = _pair(arch, "2xT", 0)[2]
        jm = _pair(arch, "2xT", 0)[0]
        for name in ("prefill_chunk_paged", "decode_step_paged",
                     "decode_window_paged"):
            assert (getattr(tm, name) is None) == (getattr(jm, name) is None)
            assert (getattr(tm, name) is None) == ("granite" not in arch)
        if "granite" not in arch:
            with pytest.raises(ValueError, match="attention-only"):
                tfm.make_pool(tm.cfg, 4, 8, 8, "cpu")


@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 16)])
def test_granite_paged_steps(precision, kv_bits):
    """Two paged prefill chunks, then one decode step over three slots
    (fused and unfused): logits within 1e-4 of the reference's."""
    jm, jsv, tm, tp = _pair("granite-moe-1b-a400m", precision, 0)
    bs, nb = 8, S_MAX // 8
    jpool = jtfm.make_pool(jm.cfg, 10, bs, kv_bits)
    tpool = tfm.make_pool(tm.cfg, 10, bs, kv_bits, "cpu")
    toks = _tokens(1, 16, tm.cfg.vocab, seed=8)
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


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, (1, n)).astype(np.int32) for n in PROMPTS]


def _serve(pkg, model, params, chunk_size, paged=False):
    sc = pkg.ServingConfig(n_slots=2, s_max=24, chunk_size=chunk_size,
                           kv_bits=8, block_size=8)
    if paged:
        cls = jkv.PagedBatcher if pkg is jserving else tkv.PagedBatcher
    else:
        cls = pkg.ContinuousBatcher
    batcher = cls(model, params, sc)
    cast = np.int32 if pkg is jserving else np.int64
    for rid, (toks, n) in enumerate(zip(_prompts(model.cfg.vocab), MAX_NEW)):
        batcher.submit(pkg.Request(rid, toks.astype(cast),
                                   options=pkg.RequestOptions(max_new=n)))
    done = batcher.run()
    assert len(done) == len(PROMPTS)
    return {r.rid: list(r.output) for r in done}, batcher


@pytest.mark.parametrize("arch,kv_bits,chunk,paged", [
    ("granite-moe-1b-a400m", 8, 8, False),
    ("granite-moe-1b-a400m", 8, 0, False),
    ("granite-moe-1b-a400m", 0, 8, True),
    ("falcon-mamba-7b", 8, None, False),
    ("jamba-v0.1-52b", 8, None, False)],
    ids=["granite-chunked", "granite-whole", "granite-paged",
         "falcon-whole", "jamba-whole"])
def test_batcher_streams_match_reference(arch, kv_bits, chunk, paged):
    """Five ragged requests over two slots through the port's batcher and
    the reference's: identical greedy streams and scheduler counters.  The
    stacks with Mamba layers take the default chunk size, which is 0
    (whole-prompt admission) for them in both packages."""
    jm, jsv, tm, tp = _pair(arch, "2xT", kv_bits)
    want, jb = _serve(jserving, jm, jsv, chunk, paged)
    got, tb = _serve(tserving, tm, tp, chunk, paged)
    assert got == want
    assert tb.chunk_size == jb.chunk_size
    assert (tb.metrics.decode_steps, tb.metrics.prefill_chunks,
            tb.metrics.prefill_full) == (jb.metrics.decode_steps,
                                         jb.metrics.prefill_chunks,
                                         jb.metrics.prefill_full)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_chunked_and_paged_admission_refused(arch):
    """An explicit chunk size and the paged batcher are refused for a stack
    with Mamba layers, with the reference's messages."""
    jm, jsv, tm, tp = _pair(arch, "2xT", 0)
    for make in (
            lambda pkg, m, p: pkg.ContinuousBatcher(
                m, p, pkg.ServingConfig(n_slots=2, s_max=24, chunk_size=8)),
            lambda pkg, m, p: (jkv if pkg is jserving else tkv).PagedBatcher(
                m, p, pkg.ServingConfig(n_slots=2, s_max=24, kv_bits=8))):
        msgs = []
        for pkg, m, p in ((jserving, jm, jsv), (tserving, tm, tp)):
            with pytest.raises(ValueError) as ei:
                make(pkg, m, p)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_write_slot_copies_states_whole():
    """``write_slot`` copies a Mamba layer's conv / SSM leaves (no sequence
    axis) whole into one slot, and refuses an admission cache with no
    state (a one-position prompt; the reference's tree-mapped write refuses
    it too)."""
    tm = _pair("jamba-v0.1-52b", "fp32", 8)[2]
    slots = tfm.make_cache(tm.cfg, 3, 16, "cpu")
    one = tfm.make_cache(tm.cfg, 1, 24, "cpu")
    for leaves in one.values():
        for leaf in leaves.values():
            leaf.fill_(5)
    tserving.write_slot(slots, one, 1)
    for name in ("layer_0", "layer_3"):
        for leaf in slots[name].values():
            assert bool((leaf[:, 1] == 5).all()), name
            assert not bool((leaf[:, 0] == 5).any()), name
    one["layer_0"] = None
    with pytest.raises(ValueError, match="no recurrent state"):
        tserving.write_slot(slots, one, 1)


FALCON_CLI = ["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu",
              "--requests", "3", "--slots", "2", "--prompt-len", "10",
              "--gen", "3"]


def test_launcher_whole_prompt(capsys):
    """``--arch falcon-mamba-7b --reduced --device cpu`` serves with
    whole-prompt admission."""
    done = tserve.main(FALCON_CLI)
    assert sorted(len(r.output) for r in done) == [3, 3, 3]
    out = capsys.readouterr().out
    assert "whole-prompt admission (chunked prefill unsupported" in out
    assert "full prefills 3" in out


@pytest.mark.parametrize("flags,reason", [
    (["--paged"], "paged KV cache needs an attention-only token LM"),
    (["--precision", "fp32", "--brownout"],
     "paged KV cache needs an attention-only token LM"),
    (["--precision", "fp32", "--speculative"],
     "paged KV cache needs an attention-only token LM"),
    (["--chunk-size", "32"], "chunked prefill needs an attention-only token "
     "LM")], ids=["paged", "brownout", "speculative", "chunk"])
def test_launcher_refusals(flags, reason):
    """The paged paths (``--paged``, and the adaptive server's and the
    speculative batcher's paged lanes) and a chunk size are refused for a
    Mamba stack with the reference launcher's reasons."""
    with pytest.raises(ValueError, match=reason):
        tserve.main(FALCON_CLI + flags)

"""Port parity for the MoE, Mamba and hybrid stacks
(``tests/torch_hybrid_common.py``) through serving: granite's paged steps,
the refusal of chunked and paged admission for the stacks with Mamba
layers, their whole-prompt streams, granite through both batchers in
lockstep with the reference's at the same slot count, and the
launcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from torch_hybrid_common import (  # noqa: E402,F401
    ARCHS, S_MAX, _close, _pair, _t, _tokens, _tuning_cache)


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

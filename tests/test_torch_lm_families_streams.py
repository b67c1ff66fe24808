"""Port parity for the last decoder-only LM families
(``tests/torch_lm_families_common.py``): greedy streams of the model entry
points, the dense and paged batchers in lockstep with the reference's, and
the launcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from torch_lm_families_common import (  # noqa: E402,F401
    GRID, GRID_IDS, S_MAX, _batch, _inputs, _pair, _t, _tuning_cache)


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

"""Port parity: sampling in ``repro_torch.runtime.serving`` against
``repro.runtime.serving``.

* The deterministic core (:func:`sample_core`), fed the reference's own
  ``jax.random.gumbel`` noise, gives the reference's ``_sample_rows`` and
  ``ContinuousBatcher._sample`` tokens bit for bit over the reference's
  corner grid (T <= 0, negative T, top-k 1, k >= V), with ties in the
  logits.
* With the port's noise source patched to the reference's noise, the
  port's dense and paged batchers serve the reference batcher's sampled
  streams.
* With the port's own noise (seeded by (seed, rid, n_out) only), sampled
  streams do not depend on the slot count, occupancy or dense against
  paged serving, and repeat from run to run; greedy rows of a mixed batch
  equal the all-greedy run; the draw follows softmax(z / T).

Reduced smollm in f32, params from the reference's init through
``interop``; exact token equality throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

S_MAX, CHUNK, BS = 24, 4, 4
SAMPLED = dict(temperature=0.8, top_k=7, seed=11)
# the reference's corner grid (tests/test_serving_ragged.py) plus k >= V
GRID = [(0.0, 0), (0.7, 0), (1.0, 5), (0.3, 1), (2.5, 17), (-1.0, 3),
        (0.9, 64), (1.3, 1000)]
SEEDS = [7, 0, 1, 2, 3, 9, 4, 5]
RIDS = [0, 1, 2, 3, 4, 5, 6, 7]
NOUTS = [0, 1, 2, 0, 13, 4, 2, 31]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _jax_gumbel(seed, rid, n_out, vocab):
    """The reference's draw for token ``n_out`` of request ``rid``:
    ``categorical(key, z)`` is ``argmax(z + gumbel(key, z.shape))``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                rid), n_out)
    return np.array(jax.random.gumbel(key, (vocab,), jnp.float32))


def _logits(v, ties, salt=3):
    rng = np.random.default_rng(salt + v)
    lg = rng.normal(size=(len(GRID), v)).astype(np.float32)
    if ties:                       # coarse values: equal maxima and k-th
        lg = np.round(lg * 2.0) / 2.0
    return lg


# ---------------------------------------------------------------------------
# (a) the core against the reference, on the reference's noise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("v", [64, 500])
def test_core_matches_reference_sample_rows(v, ties):
    lg = _logits(v, ties)
    temps = np.array([t for t, _ in GRID], np.float32)
    topks = np.array([k for _, k in GRID], np.int32)
    greedy = lg.argmax(-1).astype(np.int32)
    want = np.asarray(jax.jit(jserving._sample_rows)(
        jnp.asarray(lg), jnp.asarray(greedy), jnp.asarray(temps),
        jnp.asarray(topks), jnp.asarray(SEEDS, jnp.int32),
        jnp.asarray(RIDS, jnp.int32), jnp.asarray(NOUTS, jnp.int32)))
    noise = np.stack([_jax_gumbel(s, r, n, v)
                      for s, r, n in zip(SEEDS, RIDS, NOUTS)])
    got = tserving.sample_core(
        torch.from_numpy(lg), torch.from_numpy(greedy).long(),
        torch.from_numpy(temps), torch.from_numpy(topks).long(),
        torch.from_numpy(noise)).numpy()
    assert got.tolist() == want.tolist()
    # and the reference's per-slot _sample (lax.top_k, categorical)
    for i, (t, k) in enumerate(GRID):
        req = jserving.Request(rid=RIDS[i], tokens=np.zeros((1, 1), np.int32),
                               options=jserving.RequestOptions(
                                   temperature=t, top_k=k, seed=SEEDS[i]))
        req.output = [0] * NOUTS[i]
        assert got[i] == jserving.ContinuousBatcher._sample(
            None, req, jnp.asarray(lg[i])), (i, t, k)


def _patch_reference_noise(monkeypatch):
    monkeypatch.setattr(
        tserving, "gumbel_noise",
        lambda seed, rid, n_out, vocab, device: torch.from_numpy(
            _jax_gumbel(seed, rid, n_out, vocab)).to(device))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_select_tokens_and_sample_match_reference(monkeypatch, ties):
    """The port's selection paths (batched rows with dead rows among them,
    and the per-slot ``_sample`` of the first token) on the reference's
    noise give the reference's tokens."""
    _patch_reference_noise(monkeypatch)
    v = 64
    lg = _logits(v, ties, salt=9)
    reqs, jreqs = [], []
    for i, (t, k) in enumerate(GRID):
        opts = dict(temperature=t, top_k=k, seed=SEEDS[i])
        treq = tserving.Request(RIDS[i], np.zeros((1, 1), np.int64),
                                options=tserving.RequestOptions(**opts))
        jreq = jserving.Request(rid=RIDS[i], tokens=np.zeros((1, 1), np.int32),
                                options=jserving.RequestOptions(**opts))
        treq.output = [0] * NOUTS[i]
        jreq.output = [0] * NOUTS[i]
        reqs.append(treq)
        jreqs.append(jreq)
    want = [int(jserving.ContinuousBatcher._sample(None, r, jnp.asarray(row)))
            for r, row in zip(jreqs, lg)]
    t_lg = torch.from_numpy(lg)
    rows = reqs[:3] + [None] + reqs[3:]          # a dead row among them
    t_rows = torch.cat([t_lg[:3], torch.zeros((1, v)), t_lg[3:]])
    got = tserving.select_tokens(t_rows, t_rows.argmax(-1), rows).tolist()
    assert got[:3] + got[4:] == want
    assert got[3] == 0                           # dead row: the greedy argmax
    for r, row, w in zip(reqs, t_lg, want):
        assert tserving.ContinuousBatcher._sample(None, r, row) == w


# ---------------------------------------------------------------------------
# batchers
# ---------------------------------------------------------------------------
_MODELS = {}


def _pair(precision, kv_bits):
    """(jax model, jax params, port model, port params): the reduced smollm
    in f32 with the dense cache at ``kv_bits``; serving-form params for a
    quantized precision.  Both packages get the same params."""
    key = (precision, kv_bits)
    if key not in _MODELS:
        jcfg = dataclasses.replace(reduce_for_smoke(jget_config(
            "smollm-135m", precision=precision, kv_bits=kv_bits)),
            dtype="float32")
        tcfg = dataclasses.replace(treduce(get_config(
            "smollm-135m", precision=precision, kv_bits=kv_bits)),
            dtype="float32")
        jm = jbuild(jcfg)
        if precision == "fp32":
            jp = reference_jit(jm.init)(jax.random.PRNGKey(0))
        else:
            jp = reference_jit(lambda k: jto_serving(jm.init(k), jcfg))(
                jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
        _MODELS[key] = (jm, jp, build_model(tcfg), tp)
    return _MODELS[key]


def _prompt(length, salt, vocab):
    rng = np.random.default_rng(1009 * length + salt)
    return rng.integers(0, vocab, (1, length))


def _reqs(pkg, vocab, n, max_new=5, sampled_rids=None, **opts):
    """``n`` requests with prompts of 4-8 tokens; ``opts`` apply to the
    rids in ``sampled_rids`` (every rid when None), the rest are greedy."""
    dtype = np.int64 if pkg is tserving else np.int32
    out = []
    for i in range(n):
        o = opts if sampled_rids is None or i in sampled_rids else {}
        out.append(pkg.Request(i, _prompt(4 + (i % 5), i, vocab).astype(dtype),
                               options=pkg.RequestOptions(max_new=max_new,
                                                          **o)))
    return out


def _run(batcher, reqs):
    for r in reqs:
        batcher.submit(r)
    done = batcher.run()
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    return {r.rid: list(r.output) for r in done}


def _dense(pkg, model, params, n_slots):
    return pkg.ContinuousBatcher(model, params, pkg.ServingConfig(
        n_slots=n_slots, s_max=S_MAX, chunk_size=CHUNK))


def _paged(pkg, model, params, n_slots, kv_bits):
    cfg = dataclasses.replace(model.cfg, kv_bits=0)
    paged_model = (jbuild if pkg is jserving else build_model)(cfg)
    kv = jkv if pkg is jserving else tkv
    return kv.PagedBatcher(paged_model, params, pkg.ServingConfig(
        n_slots=n_slots, s_max=S_MAX, chunk_size=CHUNK, block_size=BS,
        kv_bits=kv_bits or 16))


# (precision, dense kv_bits): float weights with a raw cache (paged kv16)
# and the paper's 2xT point with int8 KV (paged kv8)
CONFIGS = [("fp32", 0), ("2xT", 8)]


@pytest.mark.parametrize("precision,kv_bits", CONFIGS)
def test_batchers_on_reference_noise_match_reference(monkeypatch, precision,
                                                     kv_bits):
    """With the port's noise replaced by the reference's draw, the port's
    dense and paged batchers serve the reference's sampled streams (four
    sampled requests over two slots, one greedy)."""
    _patch_reference_noise(monkeypatch)
    jm, jp, tm, tp = _pair(precision, kv_bits)
    v = tm.cfg.vocab
    sampled = {0, 1, 3, 4}
    want = _run(_dense(jserving, jm, jp, 2),
                _reqs(jserving, v, 5, sampled_rids=sampled, **SAMPLED))
    assert _run(_dense(tserving, tm, tp, 2),
                _reqs(tserving, v, 5, sampled_rids=sampled, **SAMPLED)) == want
    assert _run(_paged(tserving, tm, tp, 2, kv_bits),
                _reqs(tserving, v, 5, sampled_rids=sampled, **SAMPLED)) == want


@pytest.mark.parametrize("precision,kv_bits", CONFIGS)
def test_sampled_streams_match_solo_and_repeat(precision, kv_bits):
    """The port's own noise: each request served alone by a 1-slot batcher
    gives the stream it gets among four slots and through the paged
    batcher, and a second run repeats every stream."""
    _, _, tm, tp = _pair(precision, kv_bits)
    v = tm.cfg.vocab
    solo = {}
    for r in _reqs(tserving, v, 4, **SAMPLED):
        solo.update(_run(_dense(tserving, tm, tp, 1), [r]))
    dense = _run(_dense(tserving, tm, tp, 4), _reqs(tserving, v, 4, **SAMPLED))
    assert dense == solo
    assert _run(_dense(tserving, tm, tp, 4),
                _reqs(tserving, v, 4, **SAMPLED)) == dense
    paged = _run(_paged(tserving, tm, tp, 4, kv_bits),
                 _reqs(tserving, v, 4, **SAMPLED))
    assert paged == solo
    greedy = _run(_dense(tserving, tm, tp, 4), _reqs(tserving, v, 4))
    assert dense != greedy                       # sampling did sample


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_rows_of_mixed_batch_equal_all_greedy(paged):
    _, _, tm, tp = _pair("2xT", 8)
    v = tm.cfg.vocab

    def batcher():
        return _paged(tserving, tm, tp, 3, 8) if paged else \
            _dense(tserving, tm, tp, 3)
    greedy = _run(batcher(), _reqs(tserving, v, 6, max_new=6))
    mixed = _run(batcher(), _reqs(tserving, v, 6, max_new=6,
                                  sampled_rids={1, 3, 5}, **SAMPLED))
    assert {r: mixed[r] for r in (0, 2, 4)} == \
        {r: greedy[r] for r in (0, 2, 4)}
    assert any(mixed[r] != greedy[r] for r in (1, 3, 5))


# ---------------------------------------------------------------------------
# the port's noise source
# ---------------------------------------------------------------------------
def test_noise_seed_is_a_fixed_function():
    assert tserving.noise_seed(11, 3, 0) == tserving.noise_seed(11, 3, 0)
    seeds = {tserving.noise_seed(s, r, n) for s in range(3) for r in range(3)
             for n in range(3)}
    assert len(seeds) == 27 and all(0 <= x < 2 ** 64 for x in seeds)
    a = tserving.gumbel_noise(11, 3, 2, 50, torch.device("cpu"))
    assert a.shape == (50,) and a.dtype == torch.float32
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, tserving.gumbel_noise(11, 3, 2, 50,
                                                torch.device("cpu")))
    assert not torch.equal(a, tserving.gumbel_noise(11, 3, 3, 50,
                                                    torch.device("cpu")))


@pytest.mark.parametrize("temp,top_k", [(1.0, 0), (0.5, 0), (1.0, 3)])
def test_draws_follow_the_tempered_softmax(temp, top_k):
    """4000 draws (token indices 0..3999 of one request) of one logits row
    against softmax(z / T) over the top-k: every frequency within 4.5
    standard errors of its probability, nothing outside the top-k."""
    lg = torch.tensor([[1.0, 0.5, 0.0, -0.5, -1.0, 2.0, 0.2, -2.0]])
    n, v = 4000, lg.shape[1]
    cpu = torch.device("cpu")
    counts = np.zeros(v)
    for i in range(n):
        g = tserving.gumbel_noise(5, 9, i, v, cpu)[None]
        tok = tserving.sample_core(lg, lg.argmax(-1), torch.tensor([temp]),
                                   torch.tensor([top_k]), g)
        counts[int(tok)] += 1
    z = lg[0] / temp
    if top_k:
        z = torch.where(z < torch.topk(z, top_k).values[-1], -torch.inf, z)
    p = torch.softmax(z, -1).double().numpy()
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(counts / n - p) <= 4.5 * se + 1e-12), (counts / n, p)

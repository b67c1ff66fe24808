"""Port parity for the enc-dec backbone (whisper-base, reduced) and the
stub frontends: ``repro_torch.models.encdec`` against
``repro.models.encdec`` — the encoder, ``forward`` and ``loss``,
``prefill`` and ``decode_step`` at fp32 / 2xT x kv 0 / 8, greedy streams,
the cross-attention's chunked branch (S_enc 2048: ``_attend_flash``), the
packed serving tree and the init tree against the reference's, and the
facade (``make_batch``, the frontends, ``build_model``'s entry points).

Params are the reference's own, through ``interop``.  Logit tolerance atol
1e-4 (f32 summation order); greedy streams identical.  At 2xT the
classifier is the fake-quant forward with one activation scale over the
whole (B, S, D) tensor, so logits depend on the other rows of the call:
both packages always run the same batch.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import frontends as jfrontends  # noqa: E402
from repro.models import make_batch as jmake_batch  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import ShapeConfig, build_model, encdec  # noqa: E402
from repro_torch.models import frontends, make_batch  # noqa: E402
from repro_torch.models import reduce_for_smoke, to_serving  # noqa: E402

ATOL = 1e-4
S_MAX = 24
S_ENC = 40
CASES = [("fp32", 0), ("fp32", 8), ("2xT", 0), ("2xT", 8)]
CASE_IDS = [f"{p}-kv{k}" for p, k in CASES]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _cfgs(precision, kv_bits):
    return (jreduce(jget_config("whisper-base", precision=precision,
                                kv_bits=kv_bits)),
            reduce_for_smoke(get_config("whisper-base", precision=precision,
                                        kv_bits=kv_bits)))


_MODELS = {}


def _pair(precision, kv_bits):
    """(jax model, jax serving params, port model, port serving params),
    the reference's encoder, prefill and decode step jitted."""
    key = (precision, kv_bits)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(precision, kv_bits)
        jm = jbuild(jcfg)
        jsv = reference_jit(lambda k: jto_serving(jm.init(k), jcfg))(
            jax.random.PRNGKey(0))
        jm = dataclasses.replace(
            jm, prefill=reference_jit(jm.prefill, static_argnums=2),
            decode_step=reference_jit(jm.decode_step))
        tp = params_from_numpy(jax.tree_util.tree_map(np.array, jsv), "cpu")
        _MODELS[key] = (jm, jsv, build_model(tcfg), tp)
    return _MODELS[key]


def _batch(cfg, b, s, s_enc, seed):
    """The same numpy (tokens, frames) for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = rng.normal(size=(b, s_enc, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks).long(),
             "frames": torch.from_numpy(frames)})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_encode(precision):
    """The encoder's states (bidirectional attention, RoPE, enc_norm)."""
    jm, jsv, tm, tp = _pair(precision, 0)
    jb, tb = _batch(tm.cfg, 2, 6, S_ENC, seed=1)
    want = reference_jit(lambda p, f: jencdec.encode(p, f, jm.cfg))(
        jsv, jb["frames"])
    got = encdec.encode(tp, tb["frames"], tm.cfg)
    _close(got, want)


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_forward_logits_and_loss(precision):
    """``Model.forward`` (zero aux) and ``Model.loss``."""
    jm, jsv, tm, tp = _pair(precision, 0)
    jb, tb = _batch(tm.cfg, 2, 10, S_ENC, seed=2)
    lj, aj = jm.forward(jsv, jb)
    lt, at = tm.forward(tp, tb)
    _close(lt, lj)
    assert float(at) == float(aj) == 0.0
    labels = np.random.default_rng(3).integers(0, tm.cfg.vocab, (2, 10))
    want = float(jm.loss(jsv, dict(jb, labels=jnp.asarray(labels))))
    got = float(tm.loss(tp, dict(tb, labels=torch.from_numpy(labels))))
    assert abs(got - want) <= 1e-4


@pytest.mark.parametrize("precision,kv_bits", CASES, ids=CASE_IDS)
def test_prefill_and_decode_logits(precision, kv_bits):
    """A prefill (B=3, 8 prompt tokens), its cache (self codes within one
    step, scales and cross K/V within 1e-4), then one decode step at ragged
    per-slot positions on the reference's cache (a K/V value on a rounding
    boundary rounds either way under f32 summation order)."""
    jm, jsv, tm, tp = _pair(precision, kv_bits)
    jb, tb = _batch(tm.cfg, 3, 8, S_ENC, seed=4)
    lj, cj = jm.prefill(jsv, jb, S_MAX)
    lt, ct = tm.prefill(tp, tb, S_MAX)
    _close(lt, lj)
    assert sorted(ct) == sorted(cj) == ["cross_k", "cross_v", "self"]
    for path, leaf in _leaves(ct):
        want = np.asarray(_get(cj, path))
        assert leaf.shape == want.shape, path
        if leaf.dtype == torch.int8:
            diff = np.abs(leaf.numpy().astype(np.int16) - want.astype(np.int16))
            assert diff.max() <= 1, path
        else:
            np.testing.assert_allclose(leaf.numpy(), want, atol=ATOL,
                                       err_msg=str(path))
    pos = np.array([8, 5, 2], np.int32)
    step = np.random.default_rng(5).integers(0, tm.cfg.vocab, (3, 1))
    lj, _ = jm.decode_step(jsv, jnp.asarray(step, jnp.int32), cj,
                           jnp.asarray(pos))
    ct = params_from_numpy(jax.tree_util.tree_map(np.array, cj), "cpu")
    lt, _ = tm.decode_step(tp, torch.from_numpy(step), ct,
                           torch.from_numpy(pos))
    _close(lt, lj)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("precision,kv_bits", CASES, ids=CASE_IDS)
def test_greedy_streams_identical(precision, kv_bits):
    """Prefill then 8 decode steps, greedy, B=2: identical tokens."""
    jm, jsv, tm, tp = _pair(precision, kv_bits)
    jb, tb = _batch(tm.cfg, 2, 7, S_ENC, seed=6)
    lj, cj = jm.prefill(jsv, jb, S_MAX)
    lt, ct = tm.prefill(tp, tb, S_MAX)
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    out_j, out_t = [np.asarray(tj)], [tt.numpy()]
    for i in range(8):
        lj, cj = jm.decode_step(jsv, tj[:, None].astype(jnp.int32), cj, 7 + i)
        lt, ct = tm.decode_step(tp, tt[:, None], ct, 7 + i)
        tj, tt = jnp.argmax(lj[:, 0], -1), lt[:, 0].argmax(-1)
        out_j.append(np.asarray(tj))
        out_t.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_cross_attention_chunked_branch(precision):
    """S_enc 2048, a whole number of ATTN_KV_CHUNK above it: the encoder's
    and the cross-attention's ``_attend_flash`` branch, at prefill and at
    a decode step."""
    jm, jsv, tm, tp = _pair(precision, 8)
    jb, tb = _batch(tm.cfg, 1, 4, 2048, seed=7)
    lj, cj = jm.prefill(jsv, jb, 8)
    lt, ct = tm.prefill(tp, tb, 8)
    _close(lt, lj)
    step = np.array([[3]], np.int32)
    lj, _ = jm.decode_step(jsv, jnp.asarray(step), cj, 4)
    ct = params_from_numpy(jax.tree_util.tree_map(np.array, cj), "cpu")
    lt, _ = tm.decode_step(tp, torch.from_numpy(step).long(), ct, 4)
    _close(lt, lj)


def test_packed_tree_matches_reference():
    """``to_serving`` of the reference's float params, through both
    packages (tp 16, the reference's default): the same leaves, leaf for
    leaf — the encoder's and the decoder's self / cross projections and
    FFNs packed (``cross_attn.wo`` K-sharded by name, so int8 codes where
    its K/16 does not pack), ``lm_head`` left float."""
    jcfg, tcfg = _cfgs("2xT", 8)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(np.array, jto_serving(jparams, jcfg))
    got = to_serving(params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), "cpu"), tcfg)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, leaf in got_leaves.items():
        w = want_leaves[path]
        assert tuple(leaf.shape) == w.shape, path
        if leaf.dtype in (torch.int32, torch.int8):
            np.testing.assert_array_equal(leaf.numpy(), w, err_msg=str(path))
        else:
            np.testing.assert_allclose(leaf.to(torch.float32).numpy(),
                                       w.astype(np.float32), rtol=1e-6,
                                       err_msg=str(path))
    for part in ("self_attn", "cross_attn"):
        for name in ("wq", "wk", "wv", "wo"):
            assert ("decoder", part, name, "wt_packed") in got_leaves
    assert ("encoder", "attn", "wo", "wt_packed") in got_leaves
    assert ("lm_head", "qw") in got_leaves


def test_init_tree_matches_reference_structure():
    """The port's seeded init has the reference's tree: the same paths,
    shapes and dtypes (values differ: different generators)."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(_cfgs("fp32", 0)[0], dtype=dtype)
        tcfg = dataclasses.replace(_cfgs("fp32", 0)[1], dtype=dtype)
        want = dict(_leaves(jax.eval_shape(jbuild(jcfg).init,
                                           jax.random.PRNGKey(0))))
        got = dict(_leaves(build_model(tcfg).init(
            torch.Generator().manual_seed(0), "cpu")))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            assert tuple(leaf.shape) == want[path].shape, path
            assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path


def test_facade_entry_points_and_batches():
    """The enc-dec ``Model`` has no chunk or paged entry points (as the
    reference's); ``make_batch`` gives the reference's keys, shapes and
    dtypes for every kind of input; the stubs are unit-variance f32 on
    the generator's device."""
    jm, _, tm, _ = _pair("2xT", 8)
    for name in ("prefill_chunk", "prefill_chunk_paged", "decode_step_paged",
                 "decode_window_paged"):
        assert getattr(tm, name) is None and getattr(jm, name) is None
    for arch in ("whisper-base", "internvl2-76b", "glm4-9b"):
        jcfg = jreduce(jget_config(arch))
        tcfg = reduce_for_smoke(get_config(arch))
        for mode in ("prefill", "train"):
            want = jmake_batch(jcfg, JShape("s", 16, 3, mode))
            got = make_batch(tcfg, ShapeConfig("s", 16, 3, mode),
                             torch.Generator().manual_seed(1))
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                assert tuple(v.shape) == want[k].shape, (arch, k)
                assert v.is_floating_point() == jnp.issubdtype(
                    want[k].dtype, jnp.floating), (arch, k)
    assert sorted(frontends.STUBS) == sorted(jfrontends.STUBS)
    x = frontends.audio_frames_stub(torch.Generator().manual_seed(0), 4, 500,
                                    64)
    assert x.dtype == torch.float32 and x.shape == (4, 500, 64)
    assert abs(float(x.std()) - 1.0) < 0.02 and abs(float(x.mean())) < 0.02

"""The port's tuning cache (``repro_torch.kernels.tuning``) and its users.

* Against the reference: M buckets, shape classes and cache keys (the
  backend swapped), ``model_matmul_shapes`` and ``serving_tune_plan``, and
  ``preferred_kv_block_size`` from the same entries.
* Cache semantics, after the reference's ``tests/test_engine.py``: round
  trip, corrupt or torn files, merge-on-write by two writers, ``prime``, no
  re-sweep, an unwritable file, and one hit or miss per distinct
  resolution (not per call); a reference entry and a port entry in one
  ``REPRO_TUNING_CACHE`` file each survive the other package's write.
* Serving on the CPU: ``--kv-block-size 0`` (cold and primed caches),
  ``--autotune`` (tokens unchanged, sweeps on the first run only), the
  ``tuning_cache`` counter in a traced run, the paged occupancy buckets.
* The card's cases (each tuned matmul tile through ``engine.qmatmul``
  ``torch.equal`` to the automatic choice; B5's ``decode_attention_config``
  at every cluster size and span limit within B5's bound) are in
  ``tests/test_torch_cuda.py``, which imports no JAX and so runs on the
  card's machine.
"""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402,F401  (the reference's modules below import it)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.precision import get_precision as jget_precision  # noqa: E402
from repro.core.precision import signed as jsigned  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.kernels import engine, tuning  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402
from repro_torch.runtime import (ContinuousBatcher, PagedBatcher,  # noqa: E402
                                 Request, RequestOptions, ServingConfig,
                                 TraceConfig)

KINDS = (("ternary", 2, 2), ("int", 4, 4), ("binary", 1, 1))
PRECISIONS = ("2xT", "4x4", "1x1", "8x8", "fp32", "8xB")


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(path))
    tuning.reset()
    jtuning.reset()
    yield path
    tuning.reset()
    jtuning.reset()
    engine.set_dispatch_listener(None)


def _cfgs(reduced: bool):
    j = jget_config("smollm-135m", precision="2xT")
    t = get_config("smollm-135m", precision="2xT")
    return (jreduce(j), reduce_for_smoke(t)) if reduced else (j, t)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [0, 1, 7, 8, 9, 31, 32, 33, 100, 128, 1000,
                               1024, 5000])
def test_shape_class_and_key_match_reference(m):
    assert tuning._pow2_bucket(m) == jtuning._pow2_bucket(m)
    for n, k in ((576, 576), (192, 576), (1536, 576), (576, 1536), (7, 33)):
        assert tuning.shape_class(m, n, k) == jtuning.shape_class(m, n, k)
        for kind, a, w in KINDS + (("attn_paged", 8, 8),):
            want = jtuning.cache_key(kind, a, w, "pallas", m, n, k)
            for backend in ("cuda", "torch"):
                assert tuning.cache_key(kind, a, w, backend, m, n, k) == \
                    want.replace("pallas|", f"{backend}|", 1)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("tp", [1, 2, 3])
def test_model_matmul_shapes_match_reference(tp, reduced):
    jcfg, tcfg = _cfgs(reduced)
    assert engine.model_matmul_shapes(tcfg, tp=tp) == \
        jengine.model_matmul_shapes(jcfg, tp=tp)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("extra_m", [(), (1, 2, 4), (3, 12)])
def test_serving_tune_plan_matches_reference(extra_m, reduced):
    jcfg, tcfg = _cfgs(reduced)
    for name in PRECISIONS:
        for n_slots, chunk in ((4, 32), (8, 16), (1, 0)):
            want = jengine.serving_tune_plan(
                jcfg, jsigned(jget_precision(name)), n_slots=n_slots,
                chunk_size=chunk, extra_m=extra_m)
            got = engine.serving_tune_plan(
                tcfg, signed(get_precision(name)), n_slots=n_slots,
                chunk_size=chunk, extra_m=extra_m)
            assert got == want, (name, n_slots, chunk)


def test_serving_tune_plan_refuses_a_mesh():
    """A mesh is no longer refused: the plan adds each rank's shapes (the
    pure-DP decode rows n_slots / dp), equal to the reference's plan on a
    jax mesh of the same shape; tune_serving_shapes sweeps that plan (the
    plain versions on the CPU).  tests/test_torch_sharding.py holds the
    plan on more meshes and configs."""
    from jax.sharding import Mesh as JMesh

    from repro_torch.launch.mesh import Mesh
    jcfg, tcfg = _cfgs(True)
    pj, pt = jsigned(jget_precision("2xT")), signed(get_precision("2xT"))
    jmesh = JMesh(np.array(jax.devices() * 2)[:2].reshape(2, 1),
                  ("data", "model"))
    tmesh = Mesh({"data": 2, "model": 1})
    want = jengine.serving_tune_plan(jcfg, pj, n_slots=4, chunk_size=32,
                                     mesh=jmesh)
    got = engine.serving_tune_plan(tcfg, pt, n_slots=4, chunk_size=32,
                                   mesh=tmesh)
    assert got == [tuple(x) for x in want]
    assert {m for m, _, _ in got} == {2, 4, 32}
    entries = engine.tune_serving_shapes(tcfg, pt, n_slots=4, chunk_size=32,
                                         mesh=tmesh, device="cpu",
                                         candidates=None, iters=1)
    assert len(entries) == len(got)


@pytest.mark.parametrize("bs,s_max", [(None, 128), (32, 128), (128, 128),
                                      (48, 128), (16, 80), (32, 80)],
                         ids=["cold", "32", "128", "48-nondiv", "16-80",
                              "32-80-nondiv"])
def test_preferred_kv_block_size_matches_reference(bs, s_max):
    shape = dict(b=4, kv=3, g=3, dh=64, s_max=s_max, kv_bits=8)
    if bs is not None:
        jtuning.prime(12, 64, s_max, kind="attn_paged", a_bits=8, w_bits=8,
                      backend="pallas", block=(1, 64, bs))
        tuning.prime(12, 64, s_max, kind=tuning.ATTN_PAGED, a_bits=8,
                     w_bits=8, backend="cuda", block=(1, 64, bs))
    want = jengine.preferred_kv_block_size(**shape)
    assert engine.preferred_kv_block_size(**shape) == want
    assert want == (bs if bs is not None and s_max % bs == 0 else 16)
    # the CPU's key space is its own: nothing there
    assert engine.preferred_kv_block_size(device="cpu", **shape) == 16


# ---------------------------------------------------------------------------
# blocks: the compiled kernels and the C files' automatic rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,bits", [("ternary", 2), ("int", 2),
                                       ("int", 4), ("int", 8), ("binary", 1)])
def test_fallback_is_the_automatic_rule(kind, bits):
    tc = tuning.XNOR_TC_TILE if kind == "binary" else tuning.QMM_MMA_TILE
    for m, n, rows in ((1, 576, True), (4, 1536, True), (64, 1536, True),
                       (64, 1537, False), (65, 192, False), (32, 3072, True),
                       (33, 3072, False), (1568, 256, False)):
        k = 576
        fb = tuning.fallback_block(m, n, k, kind, bits)
        assert fb == ((8, 1, k) if rows else tc), (m, n)
        cands = tuning.candidate_blocks(m, n, k, kind, bits)
        assert cands[0] == fb and set(cands) == {(8, 1, k), tc}
        for b in cands:
            assert tuning._valid_block(m, n, k, kind, bits, b)
        assert tuning.matmul_variant(kind, k, (8, 1, k)) == tuning.VARIANT_ROWS
        assert tuning.matmul_variant(kind, k, tc) == tuning.VARIANT_TC
    for bad in ((128, 128, 512), (8, 1, 288), (64, 64, 256)):
        assert not tuning._valid_block(4, 576, 576, kind, bits, bad)
        with pytest.raises(ValueError):
            tuning.matmul_variant(kind, 576, bad)
    # weight widths without a kernel take no block
    assert not tuning._valid_block(4, 576, 576, "int", 1, (8, 1, 576))


def test_attention_blocks():
    assert tuning.fallback_block(12, 64, 80, tuning.ATTN_DECODE, 8) == \
        (1, 64, 16)
    assert tuning._valid_block(12, 64, 2048, tuning.ATTN_DECODE, 8, (8, 64, 32))
    for bad in ((3, 64, 16), (1, 32, 16), (1, 64, 33), (16, 64, 8)):
        assert not tuning._valid_block(12, 64, 80, tuning.ATTN_DECODE, 8, bad)
    for kind in (tuning.ATTN_PAGED, tuning.ATTN_FUSED):
        assert tuning.fallback_block(12, 64, 128, kind, 8) == (1, 64, 16)
        assert tuning.fallback_block(12, 64, 40, kind, 8) == (1, 64, 40)
        assert tuning._valid_block(12, 64, 128, kind, 8, (1, 64, 64))
        assert not tuning._valid_block(12, 64, 128, kind, 8, (1, 64, 48))
    with pytest.raises(ValueError, match="unknown tuning kind"):
        tuning.fallback_block(1, 1, 1, "flash", 8)


# ---------------------------------------------------------------------------
# cache semantics
# ---------------------------------------------------------------------------
ROWS, TC = (8, 1, 256), tuning.QMM_MMA_TILE


def _fake(calls, fast):
    def measure(block):
        calls.append(tuple(block))
        return 0.5 if tuple(block) == fast else 1.0
    return measure


def test_tuning_cache_roundtrip(tmp_cache):
    calls = []
    entry = tuning.autotune(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                            backend="cuda", measure=_fake(calls, TC))
    assert tuple(entry["block"]) == TC and entry["default_us"] == 1e6
    assert tmp_cache.exists() and sorted(calls) == sorted([ROWS, TC])
    n_swept = len(calls)

    # reload from disk: the lookup hits, and a repeat autotune does not sweep
    tuning.reset()
    blk = tuning.get_block_sizes(8, 128, 256, kind="ternary", a_bits=2,
                                 w_bits=2, backend="cuda")
    assert blk == TC
    assert tuning.stats() == {"hits": 1, "misses": 0, "sweeps": 0}
    tuning.autotune(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                    backend="cuda", measure=_fake(calls, TC))
    assert len(calls) == n_swept, "second autotune re-swept despite cache"
    assert tuning.stats()["sweeps"] == 0

    data = json.loads(tmp_cache.read_text())
    assert data["version"] == 1 and list(data["entries"]) == [
        "cuda|ternary|a2w2|m8n128k256"]


@pytest.mark.parametrize("content", [
    "{not json", '{"version": 1, "entries": {"cuda|ternary|a2w2|m8n128k256"',
    '[1, 2, 3]', '{"entries": [1]}',
    '{"entries": {"cuda|ternary|a2w2|m8n128k256": {"block": [0, 1, 256]}}}',
    '{"entries": {"cuda|ternary|a2w2|m8n128k256": {"block": "rows"}}}',
    '{"entries": {"cuda|ternary|a2w2|m8n128k256": {"block": [64, 64]}}}',
], ids=["garbage", "torn", "list", "entries-list", "zero", "str", "short"])
def test_corrupt_or_torn_file_is_a_miss(tmp_cache, content):
    tmp_cache.write_text(content)
    assert tuning.get_block_sizes(8, 128, 256, kind="ternary", a_bits=2,
                                  w_bits=2) == ROWS
    assert tuning.stats() == {"hits": 0, "misses": 1, "sweeps": 0}
    assert tuning.lookup(8, 128, 256, kind="ternary", a_bits=2,
                         w_bits=2) is None


def test_entry_naming_no_kernel_is_a_miss_and_evicted(tmp_cache):
    tuning.prime(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                 block=(16, 128, 128))               # a Pallas tile
    tuning.reset()
    assert tuning.get_block_sizes(8, 128, 256, kind="ternary", a_bits=2,
                                  w_bits=2) == ROWS
    assert tuning.stats()["misses"] == 1
    assert "cuda|ternary|a2w2|m8n128k256" not in tuning._load()
    # an explicit autotune can now sweep the class
    tuning.autotune(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                    backend="cuda", measure=_fake([], ROWS))
    assert tuning.stats()["sweeps"] == 1


def test_merge_on_write_by_two_writers(tmp_cache):
    key = "cuda|ternary|a2w2|m8n128k{}"
    tuning.autotune(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                    backend="cuda", measure=_fake([], TC))
    # another writer persists a second class and re-tunes the first
    data = json.loads(tmp_cache.read_text())
    other = {"block": list(ROWS), "us": 0.1, "default_us": 0.1, "swept": []}
    data["entries"][key.format(512)] = other
    data["entries"][key.format(256)] = other
    tmp_cache.write_text(json.dumps(data))
    tuning.reset(clear_stats=False)
    tuning._load()                                  # loaded, not measured
    tuning.autotune(8, 128, 1024, kind="ternary", a_bits=2, w_bits=2,
                    backend="cuda", measure=_fake([], TC))
    entries = json.loads(tmp_cache.read_text())["entries"]
    assert set(entries) == {key.format(k) for k in (256, 512, 1024)}
    # the class this process only loaded keeps the other writer's entry
    assert entries[key.format(256)]["block"] == list(ROWS)


def test_prime_inserts_the_default_without_measuring(tmp_cache):
    e = tuning.prime(4, 1536, 576, kind="ternary", a_bits=2, w_bits=2)
    assert e == {"block": [8, 1, 576], "us": 0.0, "default_us": 0.0,
                 "swept": []}
    assert tuning.prime(4, 1536, 576, kind="ternary", a_bits=2, w_bits=2,
                        block=TC) == e                 # left alone
    assert tuning.stats()["sweeps"] == 0
    tuning.reset()
    assert tuning.get_block_sizes(5, 1536, 576, kind="ternary", a_bits=2,
                                  w_bits=2) == (8, 1, 576)
    assert tuning.stats() == {"hits": 1, "misses": 0, "sweeps": 0}


def test_unwritable_cache_warns_and_serves_from_memory(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(blocker / "tuning.json"))
    tuning.reset()
    with pytest.warns(RuntimeWarning, match="not persisted"):
        tuning.autotune(8, 256, 256, kind="ternary", a_bits=2, w_bits=2,
                        backend="cuda", measure=_fake([], TC))
    assert tuning.get_block_sizes(8, 256, 256, kind="ternary", a_bits=2,
                                  w_bits=2) == TC


def test_stats_count_once_per_distinct_resolution(tmp_cache):
    kw = dict(kind="ternary", a_bits=2, w_bits=2, backend="cuda")
    for _ in range(3):
        for m in range(1, 9):                        # one bucket: 8
            assert tuning.get_block_sizes(m, 576, 576, **kw) == (8, 1, 576)
    assert tuning.stats() == {"hits": 0, "misses": 1, "sweeps": 0}
    for m in (9, 16, 12, 100):                       # buckets 16, 128
        tuning.get_block_sizes(m, 576, 576, **kw)
    assert tuning.stats()["misses"] == 3
    # the miss's default follows the actual M (the C rule), not its bucket
    assert tuning.get_block_sizes(100, 576, 576, **kw) == TC
    assert tuning.get_block_sizes(64, 1536, 576, **kw) == (8, 1, 576)
    assert tuning.get_block_sizes(64, 1537, 576, **kw) == TC
    # a new entry clears the memo: the class resolves again, once, as a hit
    tuning.prime(4, 576, 576, block=TC, **kw)
    for m in range(1, 9):
        assert tuning.get_block_sizes(m, 576, 576, **kw) == TC
    s = tuning.stats()
    assert s["hits"] == 1
    # another cache file is another resolution
    tuning.autotune(8, 192, 576, measure=_fake([], TC), **kw)
    assert tuning.get_block_sizes(4, 192, 576, **kw) == TC
    os.environ["REPRO_TUNING_CACHE"] = str(tmp_cache) + ".other"
    assert tuning.get_block_sizes(4, 192, 576, **kw) == (8, 1, 576)
    os.environ["REPRO_TUNING_CACHE"] = str(tmp_cache)
    assert tuning.get_block_sizes(4, 192, 576, **kw) == TC


@pytest.mark.parametrize("first", ["reference", "port"])
def test_both_packages_share_one_cache_file(tmp_cache, first):
    def ref_write():
        jtuning.autotune(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                         backend="pallas",
                         measure=lambda b: 0.5 if b == (8, 128, 128) else 1.0,
                         candidates=[(8, 128, 128)])

    def port_write():
        tuning.autotune(8, 128, 256, kind="ternary", a_bits=2, w_bits=2,
                        backend="cuda", measure=_fake([], TC))

    writers = [ref_write, port_write]
    for w in (writers if first == "reference" else writers[::-1]):
        w()
    entries = json.loads(tmp_cache.read_text())["entries"]
    assert set(entries) == {"pallas|ternary|a2w2|m8n128k256",
                            "cuda|ternary|a2w2|m8n128k256"}
    tuning.reset()
    jtuning.reset()
    assert tuning.get_block_sizes(8, 128, 256, kind="ternary", a_bits=2,
                                  w_bits=2) == TC
    assert jtuning.get_block_sizes(8, 128, 256, kind="ternary", a_bits=2,
                                   w_bits=2, backend="pallas") == (8, 128, 128)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_tunable_classes():
    assert engine._tunable_k(signed(get_precision("2xT")), 576)
    assert engine._tunable_k(signed(get_precision("4x4")), 1536)
    assert engine._tunable_k(signed(get_precision("1x1")), 576)
    assert not engine._tunable_k(signed(get_precision("1x1")), 48)
    for name in ("fp32", "8x8", "8xB"):    # float, int8 codes, no b1 kernel
        assert not engine._tunable_k(signed(get_precision(name)), 576)


def test_cpu_dispatch_looks_nothing_up():
    pcfg = signed(get_precision("2xT"))
    pw = engine.pack_weight(torch.randn(128, 64), pcfg)
    with engine.dispatch_trace() as ev:
        engine.qmatmul(torch.randn(4, 128), pw, pcfg)
    assert [e.block for e in ev if e.op == "qmatmul"] == [None]
    assert tuning.stats() == {"hits": 0, "misses": 0, "sweeps": 0}


@pytest.mark.parametrize("name", ["2xT", "4x4", "1x1"])
def test_autotune_matmul_cpu(tmp_cache, name):
    """A CPU sweep times the plain version (entries keyed ``torch|``); every
    block runs the same plain arithmetic."""
    pcfg = signed(get_precision(name))
    m, n, k = 8, 64, 128
    e = engine.autotune_matmul(pcfg, m, n, k, device="cpu", iters=1)
    bits = engine.weight_bits(pcfg)
    cands = tuning.candidate_blocks(m, n, k, pcfg.w_mode, bits)
    assert tuple(e["block"]) in cands and len(e["swept"]) == 2
    assert e["us"] <= e["default_us"]
    assert list(json.loads(tmp_cache.read_text())["entries"])[0].startswith(
        f"torch|{pcfg.w_mode}|")
    pw = engine.pack_weight(torch.randn(k, n), pcfg)
    x = torch.randn(m, k)
    outs = [engine.qmatmul(x, pw, pcfg, block=b) for b in cands + [None]]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("name", ["fp32", "8x8"])
def test_autotune_matmul_refuses_single_kernel_configs(name):
    with pytest.raises(ValueError):
        engine.autotune_matmul(signed(get_precision(name)), 8, 64, 128,
                               device="cpu")


def test_attention_sweeps_cpu(tmp_cache):
    e = engine.autotune_decode_attention(b=2, s=24, kv=2, g=2, dh=16,
                                         device="cpu", iters=1)
    assert len(e["swept"]) == 12 and e["block"][1] == 16
    with pytest.raises(ValueError):
        engine.autotune_decode_attention(b=2, s=24, kv=2, g=2, dh=16,
                                         kv_bits=4, device="cpu")
    picks = {}
    for kv_bits in (16, 8, 4):
        p = engine.autotune_kv_block_size(b=2, kv=2, g=2, dh=16, s_max=64,
                                          kv_bits=kv_bits, device="cpu",
                                          iters=1)
        f = engine.autotune_fused_block_size(b=2, kv=2, g=2, dh=16, d=32,
                                             s_max=64, kv_bits=kv_bits,
                                             device="cpu", iters=1)
        for entry in (p, f):
            assert [s["block"][2] for s in entry["swept"]] == [16, 32, 64]
        picks[kv_bits] = p["block"][2]
    for kv_bits, bs in picks.items():
        assert engine.preferred_kv_block_size(
            b=2, kv=2, g=2, dh=16, s_max=64, kv_bits=kv_bits,
            device="cpu") == bs
    keys = set(json.loads(tmp_cache.read_text())["entries"])
    assert "torch|attn_decode|a8w8|m8n16k24" in keys
    assert "torch|attn_fused_decode|a4w8|m8n16k64" in keys
    assert tuning.stats()["sweeps"] == 7


def test_prime_serving_shapes_then_every_class_hits():
    tcfg = _cfgs(True)[1]
    pcfg = signed(get_precision("2xT"))
    n = engine.prime_serving_shapes(tcfg, pcfg, n_slots=4, chunk_size=32)
    plan = engine.serving_tune_plan(tcfg, pcfg, n_slots=4, chunk_size=32)
    assert n == len(plan) == 8
    tuning.reset(clear_stats=False)    # prime(persist=False): memory only
    assert engine.prime_serving_shapes(tcfg, pcfg, n_slots=4,
                                       chunk_size=32) == n
    for m, nn, k in plan:
        assert tuning.get_block_sizes(m, nn, k, kind="ternary", a_bits=2,
                                      w_bits=2) == \
            tuning.fallback_block(m, nn, k, "ternary", 2)
    assert tuning.stats() == {"hits": 8, "misses": 0, "sweeps": 0}


# ---------------------------------------------------------------------------
# serving on the CPU
# ---------------------------------------------------------------------------
CLI = ["--device", "cpu", "--reduced", "--requests", "3", "--slots", "2",
       "--prompt-len", "12", "--gen", "4"]


def _cli(capsys, *extra):
    done = tserve.main(CLI + list(extra))
    out = capsys.readouterr().out
    return {r.rid: list(r.output) for r in done}, out


def test_cli_kv_block_size_0_cold_then_primed(capsys):
    _, out = _cli(capsys, "--paged", "--kv-bits", "8", "--kv-block-size", "0")
    assert "--kv-block-size 0 -> 16 (tuning-cache pick)" in out
    assert "not ported" not in out
    cfg = reduce_for_smoke(get_config("smollm-135m", precision="2xT"))
    g = cfg.n_heads // cfg.n_kv_heads
    tuning.prime(2 * g, cfg.dh, 16, kind=tuning.ATTN_PAGED, a_bits=8,
                 w_bits=8, backend="torch", block=(1, cfg.dh, 8))
    _, out = _cli(capsys, "--paged", "--kv-bits", "8", "--kv-block-size", "0")
    assert "--kv-block-size 0 -> 8 (tuning-cache pick)" in out
    assert "8 positions at kv_bits=8" in out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cli_autotune_same_tokens_sweeps_once(capsys, paged):
    extra = ["--paged", "--kv-bits", "8"] if paged else []
    base, out = _cli(capsys, *extra)
    assert "autotune" not in out
    first, out1 = _cli(capsys, *extra, "--autotune")
    again, out2 = _cli(capsys, *extra, "--autotune")
    assert first == base == again
    sweeps = [int(o.split("sweeps this run: ")[1].split(")")[0])
              for o in (out1, out2)]
    assert sweeps[0] > 0 and sweeps[1] == 0


def test_cli_autotune_kv_block_size_0_prints_the_sweeps(capsys):
    _, out = _cli(capsys, "--paged", "--kv-bits", "8", "--kv-block-size",
                  "0", "--autotune", "--prompt-len", "28")
    assert out.count("block size sweep: 16: ") == 2      # B2, B4
    assert "(tuned pick)" in out


def _model():
    cfg = dataclasses.replace(reduce_for_smoke(get_config(
        "smollm-135m", precision="2xT", kv_bits=0)), dtype="float32")
    model = build_model(cfg)
    from repro_torch.models import to_serving
    params = to_serving(model.init(torch.Generator().manual_seed(0), "cpu"),
                        cfg, tp=1)
    return model, params


def _serve(b, n=3):
    rng = np.random.default_rng(3)
    for i in range(n):
        b.submit(Request(i, rng.integers(0, b.model.cfg.vocab, (1, 6)),
                         options=RequestOptions(max_new=3)))
    return {r.rid: list(r.output) for r in b.run()}


def test_traced_autotuned_run_records_the_tuning_counter():
    model, params = _model()
    b = ContinuousBatcher(model, params, ServingConfig(
        n_slots=2, s_max=16, chunk_size=4, autotune=True,
        trace=TraceConfig()))
    assert len(b.tuned) == len(engine.serving_tune_plan(
        model.cfg, signed(get_precision("2xT")), n_slots=2, chunk_size=4))
    _serve(b)
    b.tracer.detach_engine()
    doc = b.tracer.to_perfetto()
    counters = [e for e in doc["traceEvents"] if e.get("name") ==
                "tuning_cache"]
    assert counters and counters[0]["ph"] == "C"
    assert counters[0]["cat"] == "engine"
    assert counters[0]["args"]["sweeps"] == tuning.stats()["sweeps"] > 0


def test_paged_autotune_tunes_the_occupancy_buckets():
    model, params = _model()
    for ragged in (True, False):
        tuning.reset()
        b = PagedBatcher(model, params, ServingConfig(
            n_slots=3, s_max=16, chunk_size=4, kv_bits=8, block_size=4,
            autotune=True, ragged_decode=ragged))
        assert b._occupancy_buckets() == (1, 2, 3)
        extra = (1, 2, 3) if ragged else ()
        assert len(b.tuned) == len(engine.serving_tune_plan(
            model.cfg, signed(get_precision("2xT")), n_slots=3,
            chunk_size=4, extra_m=extra))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert len(_serve(b)) == 3

"""Port parity: the sharding rules of ``repro_torch.parallel.sharding``
against ``repro.parallel.sharding``, the mesh helpers of
``repro_torch.launch.mesh`` and ``engine.serving_tune_plan(mesh=)``.

The spec functions are pure: the reference's run on jax ``Mesh``es of one
CPU device repeated (as tests/test_hlo_cost_and_sharding.py builds them),
the port's on meshes of the shape alone, over the same trees (the
reference test's ``FakeLeaf`` trees and the shapes of real serving trees).
Specs are compared after normalising a one-axis tuple to the axis name
(jax 0.9's ``PartitionSpec`` does so; the port keeps the tuple the rules
build).  Equality throughout."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.precision import get_precision as jget_precision  # noqa: E402
from repro.core.precision import signed as jsigned  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model, to_serving  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# tests/test_serving_spmd.py's tensor-parallel config, and an MoE one
TP_GOLDEN = dict(name="tp-golden", n_layers=2, d_model=1024, n_heads=8,
                 n_kv_heads=8, head_dim=128, d_ff=2048, vocab=512,
                 dtype="float32", layer_pattern=("attn",),
                 ffn_pattern=("dense",), precision="2xT")
MOE_GOLDEN = dict(TP_GOLDEN, name="moe-golden", n_kv_heads=2, n_experts=4,
                  top_k=2, moe_d_ff=64, ffn_pattern=("moe",))


def _meshes(key):
    shape, names = MESHES[key]
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * n)[:n].reshape(shape)
    return JMesh(devs, names), tmesh.Mesh(dict(zip(names, shape)))


def _norm(spec):
    if spec is None:
        return None
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): _norm(s) for path, s in leaves}


def _same(jspecs, tspecs):
    want = _jflat(jspecs)
    got = {k: _norm(v) for k, v in _flat(tspecs).items()}
    assert got == want


class FakeLeaf:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _pair_cfg(**kw):
    return JModelConfig(**kw), ModelConfig(**kw)


def _small(d_model, n_heads, n_kv, d_ff, vocab, experts=0):
    return _pair_cfg(name="t", n_layers=2, d_model=d_model, n_heads=n_heads,
                     n_kv_heads=n_kv, d_ff=d_ff, vocab=vocab,
                     n_experts=experts, top_k=2 if experts else 0,
                     moe_d_ff=64 if experts else 0,
                     ffn_pattern=("moe",) if experts else ("dense",))


def _fake_params(cfg, dh=32):
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "embed": {"w": FakeLeaf((cfg.padded_vocab, cfg.d_model))},
        "blocks": {"layer_0": {
            "attn": {"wq": {"qw": FakeLeaf((2, cfg.d_model, h * dh))},
                     "wk": {"qw": FakeLeaf((2, cfg.d_model, kv * dh))},
                     "wo": {"wt_packed": FakeLeaf((2, cfg.d_model, h * dh // 16)),
                            "scale": FakeLeaf((2, cfg.d_model))}},
            "ffn": {"w_up": {"wt_packed": FakeLeaf((2, cfg.d_ff, cfg.d_model // 16)),
                             "scale": FakeLeaf((2, cfg.d_ff))},
                    "w_down": {"qw": FakeLeaf((2, cfg.d_ff, cfg.d_model))}},
        }},
        "lm_head": {"qw": FakeLeaf((cfg.d_model, cfg.padded_vocab))},
    }


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("dims", [(2048, 8, 4, 128), (2048, 9, 3, 96),
                                  (2048, 16, 2, 1536), (576, 9, 3, 1536),
                                  (1024, 6, 6, 64)])
def test_fake_leaf_trees(mesh_key, dims):
    """param / cache / pool specs, pure-DP and the shard factors on the
    reference test's hand-built trees."""
    jm, tm = _meshes(mesh_key)
    jcfg, tcfg = _small(*dims, 4096)
    params = _fake_params(tcfg)
    _same(jsh.param_specs(params, jcfg, jm), tsh.param_specs(params, tcfg, tm))
    assert tsh.pure_dp(tcfg, tm) == jsh.pure_dp(jcfg, jm)
    for b in (1, 2, 3, 8):
        cache = {"layer_0": {"k": FakeLeaf((2, b, 64, tcfg.n_kv_heads, 32)),
                             "ks": FakeLeaf((2, b, 64, tcfg.n_kv_heads, 1))}}
        for allow_sp in (True, False):
            for seq in (False, True):
                _same(jsh.cache_specs(cache, jcfg, jm, b, kv_seq_shard=seq,
                                      allow_sp=allow_sp),
                      tsh.cache_specs(cache, tcfg, tm, b, kv_seq_shard=seq,
                                      allow_sp=allow_sp))
        assert tsh.serving_shard_factors(tcfg, tm, b) == \
            jsh.serving_shard_factors(jcfg, jm, b)
        assert _norm(tsh.logits_spec(tcfg, tm, b)) == \
            _norm(jsh.logits_spec(jcfg, jm, b))
        assert _norm(tsh.act_scale_specs(tcfg, tm, b)) == \
            _norm(jsh.act_scale_specs(jcfg, jm, b))
    pool = {"layer_0": {n: FakeLeaf((2, 10, 16, tcfg.n_kv_heads, d))
                        for n, d in (("k", 32), ("v", 32), ("ks", 1),
                                     ("vs", 1))}}
    _same(jsh.pool_specs(pool, jcfg, jm), tsh.pool_specs(pool, tcfg, tm))


@given(n_heads=st.sampled_from([4, 6, 8, 9, 12, 16]),
       n_kv=st.sampled_from([1, 2, 3, 4, 8]),
       d_ff=st.sampled_from([64, 96, 128, 1536]),
       d_model=st.sampled_from([576, 1024, 2048]),
       mesh_key=st.sampled_from(sorted(MESHES)))
@settings(max_examples=20, deadline=None)
def test_param_specs_property(n_heads, n_kv, d_ff, d_model, mesh_key):
    """The reference test's property sweep, port against reference: the
    same specs for any heads / KV heads / hidden / width, and every split
    dim divides its axes."""
    jm, tm = _meshes(mesh_key)
    jcfg, tcfg = _small(d_model, n_heads, min(n_kv, n_heads), d_ff, 4096)
    params = _fake_params(tcfg)
    specs = tsh.param_specs(params, tcfg, tm)
    _same(jsh.param_specs(params, jcfg, jm), specs)
    flat_p, flat_s = _flat(params), _flat(specs)
    for k, leaf in flat_p.items():
        tsh.local_shape(leaf.shape, flat_s[k], tm)     # raises if not


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_batch_axes_and_batch_specs(mesh_key):
    jm, tm = _meshes(mesh_key)
    for dims in ((2048, 8, 4, 128), (576, 9, 3, 1536)):
        jcfg, tcfg = _small(*dims, 4096)
        for b in (1, 2, 3, 4, 6, 8, 16, 32, 128, 256):
            assert _norm((tsh._batch_axes(tcfg, tm, b),)) == \
                _norm((jsh._batch_axes(jcfg, jm, b),))
        batch = {"tokens": FakeLeaf((8, 16)), "labels": FakeLeaf((8, 16)),
                 "frames": FakeLeaf((2, 30, 64))}
        _same(jsh.batch_specs(batch, jcfg, jm),
              tsh.batch_specs(batch, tcfg, tm))


def _ref_shapes(arch_or_kw, precision, tp):
    """The reference's serving param tree (shapes only) and both configs."""
    if isinstance(arch_or_kw, str):
        jcfg = jget_config(arch_or_kw, precision=precision)
        tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(jcfg)})
    else:
        jcfg, tcfg = _pair_cfg(**dict(arch_or_kw, precision=precision))
    jm = jbuild(jcfg)
    shapes = jax.eval_shape(lambda k: jto_serving(jm.init(k), jcfg, tp=tp),
                            jax.random.PRNGKey(0))
    return jcfg, tcfg, shapes


REAL = [("smollm-135m", "2xT"), ("glm4-9b", "2xT"), ("glm4-9b", "fp32"),
        ("granite-moe-1b-a400m", "2xT"), ("falcon-mamba-7b", "2xT"),
        (TP_GOLDEN, "2xT"), (MOE_GOLDEN, "4x4")]


@pytest.mark.parametrize("arch,precision", REAL,
                         ids=lambda a: a if isinstance(a, str) else a["name"])
def test_real_serving_trees(arch, precision):
    """param_specs (fsdp on and off), cache_specs and pool_specs on the
    shapes of real serving trees (the reference's init + to_serving), every
    mesh."""
    for mesh_key in sorted(MESHES):
        jm, tm = _meshes(mesh_key)
        tp = tm.shape["model"]
        jcfg, tcfg, shapes = _ref_shapes(arch, precision, tp)
        for fsdp in (False, True):
            _same(jsh.param_specs(shapes, jcfg, jm, fsdp=fsdp),
                  tsh.param_specs(shapes, tcfg, tm, fsdp=fsdp))
        for b in (1, 4):
            cache = jax.eval_shape(lambda: jtfm.make_cache(jcfg, b, 32))
            _same(jsh.cache_specs(cache, jcfg, jm, b, allow_sp=False),
                  tsh.cache_specs(cache, tcfg, tm, b, allow_sp=False))
        if all(m.startswith("attn") for m in jcfg.layer_pattern):
            pool = jax.eval_shape(lambda: jtfm.make_pool(jcfg, 9, 16, 8))
            _same(jsh.pool_specs(pool, jcfg, jm), tsh.pool_specs(pool, tcfg, tm))


@pytest.mark.parametrize("kw", [TP_GOLDEN, MOE_GOLDEN],
                         ids=lambda kw: kw["name"])
def test_port_trees_map_leaf_for_leaf(kw):
    """The port's own serving trees (init + to_serving on the CPU) take the
    reference's specs on the reference's trees, leaf for leaf; shard_tree's
    shapes are local_shape's."""
    for mesh_key in ("2x4", "1x8"):
        jm, tm = _meshes(mesh_key)
        tp = tm.shape["model"]
        jcfg, tcfg, shapes = _ref_shapes(kw, kw["precision"], tp)
        model = build_model(tcfg)
        params = to_serving(model.init(torch.Generator().manual_seed(0),
                                       "cpu"), tcfg, tp=tp)
        tspecs = tsh.param_specs(params, tcfg, tm)
        _same(jsh.param_specs(shapes, jcfg, jm), tspecs)
        flat_p, flat_s = _flat(params), _flat(tspecs)
        assert {k: tuple(v.shape) for k, v in flat_p.items()} == \
            {k: tuple(v.shape) for k, v in _flat(shapes).items()}
        for k, t in flat_p.items():
            loc = tsh.local_shape(t.shape, flat_s[k], tm)
            assert all(d > 0 for d in loc)


def test_shard_leaf_slices_tile_the_tensor():
    """The ranks' slices of a leaf under a spec tile it in row-major rank
    order (shape-only meshes with the rank set: slicing needs only the
    coordinates); a spec that splits nothing returns the tensor itself."""
    t = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = (("data",), None, "model")
    parts = {}
    for r in range(4):
        m = tmesh.Mesh({"data": 2, "model": 2}, rank=r)
        part = tsh.shard_leaf(t, spec, m)
        assert tuple(part.shape) == tsh.local_shape(t.shape, spec, m) \
            == (2, 6, 4)
        parts[(m.coords["data"], m.coords["model"])] = part
    rebuilt = torch.cat([torch.cat([parts[(d, j)] for j in range(2)], dim=2)
                         for d in range(2)], dim=0)
    assert torch.equal(rebuilt, t)
    m = tmesh.Mesh({"pod": 2, "data": 2, "model": 2}, rank=6)   # (1, 1, 0)
    two = tsh.shard_leaf(t, (("pod", "data"), None, None), m)
    assert torch.equal(two, t[3:4])
    one = tmesh.Mesh({"data": 1, "model": 1})
    assert tsh.shard_leaf(t, spec, one) is t
    tree = {"a": t, "b": {"c": t[0]}}
    got = tsh.shard_tree(tree, {"a": spec, "b": {"c": (None, "model")}},
                         tmesh.Mesh({"data": 2, "model": 2}, rank=1))
    assert torch.equal(got["a"], t[:2, :, 4:])
    assert torch.equal(got["b"]["c"], t[0][:, 4:])


CONFIGS_TUNE = ["smollm-135m", "glm4-9b", "granite-moe-1b-a400m"]


@pytest.mark.parametrize("arch", CONFIGS_TUNE + ["tp-golden"])
@pytest.mark.parametrize("precision", ["2xT", "4x4", "1x1"])
def test_serving_tune_plan_with_mesh(arch, precision):
    """engine.serving_tune_plan(mesh=) — the global shapes plus each rank's
    (local decode rows, local N or K under TP) — equals the reference's."""
    if arch == "tp-golden":
        jcfg, tcfg = _pair_cfg(**dict(TP_GOLDEN, precision=precision))
    else:
        jcfg = jget_config(arch, precision=precision)
        tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(jcfg)})
    jp, tp = jsigned(jget_precision(precision)), signed(get_precision(precision))
    for mesh_key in sorted(MESHES):
        jm, tm = _meshes(mesh_key)
        for n_slots, chunk, extra in ((8, 32, ()), (3, 16, (1, 2, 4)),
                                      (16, 64, (32,))):
            want = jengine.serving_tune_plan(jcfg, jp, n_slots=n_slots,
                                             chunk_size=chunk, mesh=jm,
                                             extra_m=extra)
            got = engine.serving_tune_plan(tcfg, tp, n_slots=n_slots,
                                           chunk_size=chunk, mesh=tm,
                                           extra_m=extra)
            assert got == [tuple(p) for p in want], (mesh_key, n_slots)
    assert engine.serving_tune_plan(tcfg, tp, n_slots=4, chunk_size=32) == \
        [tuple(p) for p in jengine.serving_tune_plan(jcfg, jp, n_slots=4,
                                                     chunk_size=32)]


def test_parse_mesh_and_shape_only_meshes():
    """parse_mesh's spellings and refusals (the reference's messages,
    worded for ranks); a shape-only mesh's coordinates and axes; data_axes;
    make_mesh outside a process group."""
    assert tmesh.parse_mesh(None) is None and tmesh.parse_mesh("") is None
    assert tmesh.parse_mesh("none") is None
    m = tmesh.parse_mesh("2,4")
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert m.axis_names == ("data", "model") and m.groups is None
    with pytest.raises(ValueError, match="expects 'dp,mp'"):
        tmesh.parse_mesh("2x4")
    with pytest.raises(ValueError, match="must be >= 1"):
        tmesh.parse_mesh("0,2")
    with pytest.raises(ValueError, match="needs 8 ranks but only 4"):
        tmesh.parse_mesh("2,4", max_ranks=4)
    with pytest.raises(ValueError, match="shape alone"):
        m.axis("model")
    one = tmesh.Mesh({"data": 1, "model": 1})
    ax = one.axis(("data", "model"))
    assert (ax.size, ax.index, ax.group) == (1, 0, None)
    t = torch.ones(3)
    assert ax.all_reduce_sum(t) is t and ax.all_gather(t) is t
    r5 = tmesh.Mesh({"pod": 2, "data": 2, "model": 2}, rank=5)
    assert r5.coords == {"pod": 1, "data": 0, "model": 1}
    assert tmesh.data_axes(r5) == ("pod", "data")
    assert tmesh.data_axes(m) == ("data",)
    made = tmesh.make_mesh(2, 2, 2)
    assert made.shape == {"pod": 2, "data": 2, "model": 2}
    assert made.groups is None

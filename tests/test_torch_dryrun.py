"""The dry run at production scale (``repro_torch.launch.dryrun``) against
the reference's cell grid, production mesh and model counts, on the CPU.

A dry run traces one rank's step on meta tensors over a dry mesh
(``launch.mesh.make_production_mesh``): nothing is allocated, built or
sent, so a full-size cell costs only its trace.  Checked here: the
(arch x shape) grid and its skips equal ``repro.configs.iter_cells``'; the
production mesh has the reference's axes and sizes; a mesh of the shape
alone that is not marked dry still refuses; ``n_params``,
``n_active_params`` and the model FLOPs equal the reference's; a full-size
smollm-135m decode cell at 2xT kv8 runs with no kernel library built or
loaded, every dispatch of a kind with a kernel on the card's route, its
argument bytes the sum of ``shard_tree``'s meta leaves; the FSDP train
cells (internvl2-76b and kimi-k2 at full width, depth cut) trace, kimi's
expert weights cut over data too; the configurations the card once
refused trace (``attn_probs_bf16`` at a 32k prefill, B8 with bf16
probabilities; the expert-parallel MoE in a train step); a real host tensor
still refuses ``backend="cuda"``.  (The dry run against a real run of the same step, op
for op, is in tests/test_torch_spmd.py's spawn.)"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import iter_cells as jiter_cells  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, iter_cells  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.kernels import _build, engine  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hillclimb  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model, to_serving  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_iter_cells_match_reference():
    """The same 40 (arch, shape) cells in the same order, the same shapes
    and the same skips: the 7 pure-attention archs at long_500k, 33 run."""
    want = [(a, dataclasses.astuple(s), k) for a, s, k in jiter_cells()]
    got = [(a, dataclasses.astuple(s), k) for a, s, k in iter_cells()]
    assert got == want
    assert len(got) == 40 and sum(k is None for *_, k in got) == 33


def test_production_mesh_is_the_reference_s(monkeypatch):
    """``make_production_mesh`` has the reference's shapes and axis names
    (its ``jax.make_mesh`` call read here without 256 devices), one rank of
    it, dry: its axes count and send nothing."""
    import repro.launch.mesh as jmesh
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (shape,
                                                                      axes))
    for multi_pod in (False, True):
        shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
        m = tmesh.make_production_mesh(multi_pod=multi_pod, rank=37)
        assert m.axis_names == tuple(axes)
        assert tuple(m.shape.values()) == tuple(shape)
        assert m.dry and m.size == (512 if multi_pod else 256)
        assert m.coords == ({"pod": 0} if multi_pod else {}) | {
            "data": 2, "model": 5}
        assert m.axis("data").dry and m.axis("model").index == 5


def test_shape_only_mesh_still_refuses():
    """A mesh of several ranks built from a shape alone and not marked dry
    gives no axis (the message names the dry mesh), nor does an axis with
    no group; a dry one does."""
    with pytest.raises(ValueError, match="shape alone.*dry mesh"):
        tmesh.Mesh({"data": 2, "model": 1}).axis("data")
    with pytest.raises(ValueError, match="make_production_mesh"):
        comm.Axis(("data",), 2, 0, None, None)
    assert tmesh.Mesh({"data": 2, "model": 1}, dry=True).axis("data").size \
        == 2


def test_dry_axis_collectives():
    """A dry axis returns the real result's shape and dtype, carries the
    real collectives' gradients, and counts each collective and its wire
    bytes as a real one does."""
    axis = tmesh.Mesh({"data": 4, "model": 2}, rank=5, dry=True).axis(
        ("data", "model"))
    assert (axis.size, axis.index) == (8, 5)
    x = torch.randn(3, 4, requires_grad=True)
    comm.reset_collective_counts()
    s = axis.all_reduce_sum(x)
    g = axis.all_gather(x, dim=1, reduce_grad=True)
    m = axis.all_reduce_max(x.detach().to(torch.bfloat16))
    assert s.shape == (3, 4) and g.shape == (3, 32) and m.dtype == \
        torch.bfloat16
    (s.sum() + g.sum()).backward()
    assert x.grad.shape == (3, 4)
    assert comm.collective_counts() == {"all_reduce_sum": 2,
                                        "all_reduce_max": 1, "all_gather": 1,
                                        "broadcast": 0}
    assert comm.backward_counts()["all_reduce_sum"] == 1
    # ring counts: all-reduce 2 (n-1)/n of the bytes (x's 48 forward, the
    # gathered cotangent's 384 backward), all-gather (n-1) times the part
    assert comm.collective_bytes() == {
        "all_reduce_sum": 2 * 7 * 48 // 8 + 2 * 7 * 384 // 8,
        "all_reduce_max": 2 * 7 * 24 // 8, "all_gather": 7 * 48,
        "broadcast": 0}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_counts_match_reference(arch):
    """``n_params``, ``n_active_params`` and each shape's model FLOPs (the
    reference's 6 N D, 2 N D and 2 N B) equal the reference's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.n_params == jcfg.n_params
    assert cfg.n_active_params == jcfg.n_active_params
    na = jcfg.n_active_params
    for shape in SHAPES.values():
        tokens = shape.seq_len * shape.global_batch
        want = {"train": 6.0 * na * tokens, "prefill": 2.0 * na * tokens,
                "decode": 2.0 * na * shape.global_batch}[shape.mode]
        assert dryrun.model_flops(cfg, shape) == want


def test_hillclimb_battery_is_the_reference_s():
    """The battery's cells and variants, read from the reference's source
    (importing it would set XLA_FLAGS for this process)."""
    tree = ast.parse((REPO / "src/repro/launch/hillclimb.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "BATTERY")
    assert ast.literal_eval(node.value) == hillclimb.BATTERY


def _no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the dry run asked for library {name!r}")
    monkeypatch.setattr(_build, "library", refuse)


def _has_kernel(ev) -> bool:
    if ev.op == "qmatmul":
        return engine.resolve_entry(ev.kind, ev.a_bits, ev.w_bits,
                                    "cuda")[1][3] == "cuda"
    if ev.op in ("decode_attention", "paged_attention", "fused_paged_decode",
                 "flash_attention"):
        return engine.resolve_attention_entry(ev.kind, ev.a_bits,
                                              "cuda")[1][2] == "cuda"
    return ev.op == "act_quant_signed_grouped"


def test_smollm_decode_full_size(monkeypatch, tmp_path):
    """smollm-135m decode_32k at 2xT kv8 on rank 0 of 16x16, full size:
    ``status`` ok with no library built or loaded; every dispatch of a kind
    that has a kernel takes the card's route and stands in for its launch
    (7 projections and one B5 a layer: 210 B7c, 180 B1 and 30 B5; wo's K of
    36 a rank does not pack, as in the reference's serving form at tp 16,
    and runs the int8-codes plain version); the argument bytes equal the
    sum of ``shard_tree``'s meta leaves (params, cache, 8 rows of tokens,
    the position)."""
    _no_library(monkeypatch)
    events = []
    engine.set_dispatch_listener(events.append)
    try:
        rec = dryrun.run_cell("smollm-135m", "decode_32k", precision="2xT",
                              kv_bits=8, out_dir=str(tmp_path),
                              verbose=False)
    finally:
        engine.set_dispatch_listener(None)
    assert rec["status"] == "ok", rec.get("traceback")
    assert _build._LIBS == {}
    assert events and all(ev.impl_backend == "cuda" for ev in events
                          if _has_kernel(ev))
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == {
        "act_quant_signed_grouped": 210, "ternary_matmul": 180,
        "decode_attention": 30}
    assert rec["dispatch"]["qmatmul"] == {"cuda": 180, "torch": 30}
    cfg = get_config("smollm-135m", precision="2xT", kv_bits=8)
    mesh = tmesh.make_production_mesh()
    shapes = to_serving(build_model(cfg).init(torch.Generator(), "meta"),
                        cfg, tp=16)
    cache = tfm.make_cache(cfg, 128, 32768, "meta")
    want = (_bytes(shd.shard_tree(shapes, shd.param_specs(shapes, cfg, mesh),
                                  mesh))
            + _bytes(shd.shard_tree(cache, shd.cache_specs(cache, cfg, mesh,
                                                           128), mesh))
            + 8 * 8 + 8)
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == want
    # the cache is updated in place: it is the step's aliased output
    assert ma["alias_size_in_bytes"] == _bytes(shd.shard_tree(
        cache, shd.cache_specs(cache, cfg, mesh, 128), mesh))
    assert rec["fits"] is True and rec["collectives"]["total_bytes"] == 0


@pytest.mark.parametrize("arch,n_layers", [("internvl2-76b", 2),
                                           ("kimi-k2-1t-a32b", 1)])
def test_fsdp_train_cell(monkeypatch, tmp_path, arch, n_layers):
    """An FSDP train cell (adafactor, ``param_specs(fsdp=True)``, bf16
    accumulation) at full width, depth cut, on rank 0 of 2x16x16 (8
    microbatches): ``status`` ok; the argument bytes are the sum of the cut
    params and optimizer state and the rank's 8 rows of the batch; kimi's
    expert weights are cut over model and data (1/256 of them a rank), each
    gathered where used and again in the backward; internvl2 has no expert
    leaf, so the reference's FSDP rule cuts none of its weights."""
    _no_library(monkeypatch)
    rec = dryrun.run_cell(arch, "train_4k", multi_pod=True,
                          out_dir=str(tmp_path), verbose=False,
                          n_layers=n_layers)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    mesh = tmesh.make_production_mesh(multi_pod=True)
    shapes = build_model(cfg).init(torch.Generator(), "meta")
    pspecs = shd.param_specs(shapes, cfg, mesh, fsdp=True)
    opt = make_optimizer("adafactor")
    params = shd.shard_tree(shapes, pspecs, mesh)
    state = shd.shard_tree(opt.init(shapes), opt.state_specs(pspecs), mesh)
    batch = dryrun.input_specs(cfg, SHAPES["train_4k"])
    want = _bytes(params) + _bytes(state) + _bytes(batch) // 32
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    counts = rec["collectives"]["counts"]
    moe = params["blocks"]["layer_0"].get("moe")
    if moe is None:
        assert not any("data" in str(s) for s in tree_leaves(pspecs))
        return
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].numel() * 256 == \
            shapes["blocks"]["layer_0"]["moe"][name].numel()
    # a microbatch: the rows' gather, three expert gathers and their three
    # re-gathers in the backward
    assert counts["all_gather"] == 8 * 7


def _traced_cell(monkeypatch, tmp_path, arch, shape, **kw):
    """``run_cell`` at one layer on rank 0 of 16x16, its dispatches
    collected; (record, dispatch events)."""
    _no_library(monkeypatch)
    events = []
    engine.set_dispatch_listener(events.append)
    try:
        rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path),
                              verbose=False, n_layers=1, **kw)
    finally:
        engine.set_dispatch_listener(None)
    assert rec["status"] == "ok", rec.get("traceback")
    return rec, events


@pytest.mark.parametrize("case", ["attn_probs_bf16", "moe_shard_map_train"])
def test_once_refused_configurations_trace(monkeypatch, tmp_path, case):
    """``attn_probs_bf16``: smollm-135m's prefill_32k (32768 positions, past
    the reference's 1024-position chunk) launches B8 with ``probs_bf16``
    (dispatch kind ``flash_probs_bf16`` on the card's route), counted by
    ``kernels.costs.flash_attention`` as the flag-off cell (the same q.k
    and p.v products, one term each).  ``moe_impl="shard_map"`` in
    granite-moe's train_4k: each rank routes its own rows, so the rows are
    never gathered (the slot map's cell gathers them once a microbatch);
    per microbatch the layer makes the slot map's all-reduce of the partial
    output over model, two of the load-balance means over the rows forward
    and one backward (the rows-objective sum), where the slot map's gather
    made one backward: two all-reduce sums more a microbatch."""
    if case == "attn_probs_bf16":
        rec, events = _traced_cell(monkeypatch, tmp_path, "smollm-135m",
                                   "prefill_32k", attn_probs_bf16=True)
        off, off_events = _traced_cell(monkeypatch, tmp_path, "smollm-135m",
                                       "prefill_32k")
        kinds = [(e.kind, e.impl_backend) for e in events
                 if e.op == "flash_attention"]
        assert kinds == [(engine.ATTN_FLASH_PROBS_BF16, "cuda")]
        assert [e.kind for e in off_events if e.op == "flash_attention"] \
            == [engine.ATTN_FLASH]
        assert rec["kernels"]["flash_attention"]["launches"] == 1
        assert rec["kernels"] == off["kernels"]
        return
    arch, shape = "granite-moe-1b-a400m", "train_4k"
    rec, _ = _traced_cell(monkeypatch, tmp_path, arch, shape,
                          moe_impl="shard_map")
    slot, _ = _traced_cell(monkeypatch, tmp_path, arch, shape)
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    n_micro = dryrun._accum_steps(cfg, tmesh.make_production_mesh(),
                                  SHAPES[shape])
    ep, sm = rec["collectives"]["counts"], slot["collectives"]["counts"]
    assert ep["all_gather"] == 0 and sm["all_gather"] == n_micro
    assert ep["all_reduce_sum"] - sm["all_reduce_sum"] == 2 * n_micro


def test_real_host_tensor_refuses_cuda():
    """``backend="cuda"`` with a real CPU tensor still raises, inside
    ``trace_as_card`` too (only meta tensors stand in for the card's)."""
    pcfg = signed(get_precision("2xT"))
    pw = engine.pack_weight(torch.randn(64, 32), pcfg)
    x = torch.randn(2, 64)
    for ctx in (dryrun.contextlib.nullcontext(), engine.trace_as_card()):
        with ctx, pytest.raises(ValueError, match="needs CUDA tensors"):
            engine.qmatmul(x, pw, pcfg, backend="cuda")


def test_quantized_lm_head_matches_reference():
    """``quantize_lm_head`` at 2xT (the hillclimb battery's last glm4
    variant, whose dry run found the port's classifier taking only a float
    ``lm_head``): the classifier runs as a projection, packed by
    ``to_serving`` and served through the engine, as the reference's.  A
    prefill's and a decode step's logits of the reduced glm4, from the
    reference's draw, within 1e-4 of max|logit| of the reference's."""
    precision = "2xT"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import build_model as jbuild
    from repro.models import reduce_for_smoke as jreduce
    from repro.models import to_serving as jto_serving
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import reduce_for_smoke
    over = {"quantize_lm_head": True}
    jcfg = dataclasses.replace(jreduce(jget_config(
        "glm4-9b", precision=precision, kv_bits=8)), **over)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(
        "glm4-9b", precision=precision, kv_bits=8)), **over)
    jp = reference_jit(
        lambda k: jto_serving(jbuild(jcfg).init(k), jcfg, tp=1))(
        jax.random.PRNGKey(3))
    assert "wt_packed" in jp["lm_head"]
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jl, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                16)
    jd, _ = jmodel.decode_step(jp, jnp.asarray(tokens[:, -1:], jnp.int32),
                               jcache, jnp.int32(6))
    with torch.no_grad():
        tl, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                  16)
        td, _ = model.decode_step(params, torch.from_numpy(tokens[:, -1:]),
                                  cache, torch.tensor(6))
    for got, want in ((tl, jl), (td, jd)):
        want = np.asarray(want)
        gap = float(np.abs(got.numpy() - want).max())
        assert gap <= 1e-4 * float(np.abs(want).max()), gap

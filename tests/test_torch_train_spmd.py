"""Training over a mesh of ranks (``launch.steps.make_train_step(mesh=)``,
the optimizers' ``state_specs``, checkpoints saved and restored across
meshes, ``runtime.ElasticTrainer``'s re-shard, ``launch.train.train(mesh=)``
and ``parallel.pipeline``) against the reference, on 4 CPU ranks over gloo.

One spawn of 4 ranks (a module fixture: process start-up is the cost) runs
every multi-rank check of tests/torch_train_spmd_ranks.py; the reference's
side runs here meanwhile.  Sharding the work does not change the function
a step computes, so the oracle of a mesh step is the reference's
one-device ``make_train_step`` on the same global batch, from the same
params (the port's draw, through ``interop``): the reference's own
multi-device tests (tests/test_spmd_integration.py,
tests/test_pipeline.py) do not run under this jax.

Bounds (reduce_for_smoke shapes, or the serving tests' ``tp-golden``
and a falcon-mamba stack ``mamba-tp``, d_model 1024: tensor parallel; f32, lr 1e-3, global batch 8 x 16, two
steps): every rank's loss and grad norm within 1e-5 relative of the
reference's at each step (FSDP too: moe-tp with its expert weights' K cut
over data, adamw and adafactor on 2,2 and 4,1; and the expert-parallel
shard_map MoE, moe-tp with ``moe_impl="shard_map"`` on 2,2 at a capacity
where nothing drops, so its per-shard routing is the one-device step's);
every param leaf assembled from the ranks'
slices within 1e-4 of the reference's, but for at most one entry in
10^4 of a leaf, within 2.2 lr a step.  An Adam step moves an entry by
~lr g / (|g| + eps), near +-lr whatever the summation order, except where
g is itself at the ulps' level (a leaf's rarely reached entries) or a
code of the int8 gradient channel rounds the other way: there the step
follows the ulps, up to a flipped sign.  The port's own one-device step
on tests/test_torch_spmd.py's ``moe-golden`` is 1.6e-4 from the
reference's after two steps; every job's largest gap and count of such
entries are printed.  adam8bit's params are held after its first step:
from the second on, an entry whose int8 second-moment code rounds to 0 in
one package and 1 in the other takes a step of m / eps in one of them
(both packages' one-device steps are ~1 apart there).  The MoE configs'
rarely routed experts make such entries (moe-tp: nine, within 1.44e-3).
On every rank and after every step, the leaves
(params and optimizer state) that several ranks hold the same slice of
are bit-equal across those ranks.  The sharded optimizers alone, fed the
reference's gradients: params and float moments within 1e-6 of their
largest magnitude, adam8bit's codes equal (tests/test_torch_optim.py's
bounds).  The pipeline within 1e-5 of the reference's sequential stack, and
its gradients (blocks and x) within 1e-5 of each leaf's largest magnitude
of ``jax.grad`` of that stack, the same bits on every rank; checkpoints
bit-equal.  The expert-parallel MoE layer (reduced granite, 8 experts top-2
at capacity factor 1.0, so tokens drop; 2 data x 2 model ranks) against
the reference's own body, ``_local_moe``, under ``jax.vmap`` with the axis
names 'model' inside 'data': the output, aux, and the gradients of the
rows' objective and of the aux term (averaged over the data ranks, as a
train step's bucket averages them) within 1e-5 of each leaf's largest
magnitude."""
import concurrent.futures
import dataclasses
import multiprocessing
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import (  # noqa: E402,F401
    one_thread, ranks_one_thread, reference_jit)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import _apply_period as j_apply_period  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.parallel.moe_shard_map import _local_moe as j_local_moe  # noqa: E402
from repro.parallel.pipeline import bubble_fraction as jbubble  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import OPTIMIZERS, make_optimizer  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.parallel.pipeline import bubble_fraction  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_along  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_spmd_ranks as ranks  # noqa: E402

LR = ranks.LR
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-4
FLIP_FRACTION, FLIP_LR_PER_STEP = 1e-4, 2.2
B, S, N_STEPS = 8, 16, 2
TP_GOLDEN = dict(name="tp-golden", n_layers=2, d_model=1024, n_heads=8,
                 n_kv_heads=8, head_dim=128, d_ff=2048, vocab=512,
                 dtype="float32", layer_pattern=("attn",),
                 ffn_pattern=("dense",), precision="fp32")
# tensor-parallel MoE: 2 of 4 experts and 1 of 2 KV heads a rank on 2,2
# (tests/test_torch_spmd.py's moe-golden with heads of 32)
MOE_TP = dict(TP_GOLDEN, name="moe-tp", head_dim=32, n_kv_heads=2,
              n_experts=4, top_k=2, moe_d_ff=64, ffn_pattern=("moe",))
# a Mamba stack on a model axis: d_inner 2048 cut over it (the reduced
# falcon-mamba at d_model 1024, as tests/test_torch_spmd.py serves it)
MAMBA_TP = dict(name="mamba-tp", n_layers=2, d_model=1024, d_ff=0,
                vocab=512, n_heads=0, n_kv_heads=0, head_dim=0,
                layer_pattern=("mamba",), ffn_pattern=("none",), ssm_state=16,
                ssm_conv=4, ssm_expand=2, dt_rank=8, ssm_chunk=16,
                dtype="float32")
# name: (arch or config dict, precision, optimizer, accum, bits, meshes)
JOBS = {
    "smollm fp32": ("smollm-135m", "fp32", "adamw", 1, 0,
                    ("2,1", "4,1", "2,2")),
    "smollm 2xT": ("smollm-135m", "2xT", "adamw", 1, 0,
                   ("2,1", "4,1", "2,2")),
    "smollm fp32 accum 2 adam8bit": ("smollm-135m", "fp32", "adam8bit", 2,
                                     0, ("4,1", "2,2")),
    "smollm 2xT int8 grads adafactor": ("smollm-135m", "2xT", "adafactor", 1,
                                        8, ("2,2",)),
    "smollm fp32 accum 2 int8 grads": ("smollm-135m", "fp32", "adamw", 2, 8,
                                       ("4,1",)),
    "tp-golden fp32": (TP_GOLDEN, "fp32", "adamw", 1, 0, ("1,2", "2,2")),
    "tp-golden 2xT": (TP_GOLDEN, "2xT", "adamw", 1, 0, ("1,2", "2,2")),
    "granite": ("granite-moe-1b-a400m", "fp32", "adamw", 1, 0, ("1,2",)),
    "moe-tp": (MOE_TP, "fp32", "adamw", 1, 0, ("2,2",)),
    "mamba-tp": (MAMBA_TP, "fp32", "adamw", 1, 0, ("1,2",)),
    "moe-tp fsdp adamw": (MOE_TP, "fp32", "adamw", 1, 0, ("2,2", "4,1")),
    "moe-tp fsdp adafactor": (MOE_TP, "fp32", "adafactor", 1, 0,
                              ("2,2", "4,1")),
    # the expert-parallel MoE in a train step: capacity T (factor E / k),
    # so no token drops and the per-shard routing is the global one's
    "moe-tp ep": (dict(MOE_TP, moe_impl="shard_map", capacity_factor=2.0),
                  "fp32", "adamw", 1, 0, ("2,2",)),
}
# jobs whose params take the FSDP rule (``param_specs(fsdp=True)``: the
# expert weights' K over data, gathered where used)
FSDP_JOBS = {"moe-tp fsdp adamw", "moe-tp fsdp adafactor"}
# the sharded optimizers alone: leaves cut over N, over K, over E (an
# expert stack), over both axes, and one replicated; gradients small
# enough that the clip scales by exactly 1 (adam8bit's codes compare equal)
OPT_SHAPES = {"a": ((8, 12), (None, "model")), "b": ((12, 8), ("model", None)),
              "c": ((3, 8, 6), (None, ("data", "model"), None)),
              "e": ((4, 6, 10), ("model", None, None)), "g": ((6,), (None,))}
OPT_KW = {"adamw": dict(lr=1e-2, weight_decay=0.1),
          "adafactor": dict(lr=1e-2),
          "adam8bit": dict(lr=1e-2, weight_decay=0.05)}
MESH_SHAPES = {"2,2": {"data": 2, "model": 2}, "4,1": {"data": 4, "model": 1},
               "2,1": {"data": 2, "model": 1}, "1,2": {"data": 1, "model": 2}}
ELASTIC = ["--reduced", "--device", "cpu", "--precision", "fp32", "--steps",
           "6", "--batch", "8", "--seq", "16", "--lr", str(LR),
           "--save-every", "100"]


def _configs(what, precision):
    if isinstance(what, dict):
        d = dict(what, precision=precision)
        return JModelConfig(**d), ModelConfig(**d)
    return (jreduce(jget_config(what, precision=precision)),
            reduce_for_smoke(get_config(what, precision=precision)))


def _job(i, name):
    what, precision, opt, accum, bits, meshes = JOBS[name]
    jcfg, tcfg = _configs(what, precision)
    rng = np.random.default_rng(100 + i)
    batches = [{k: rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(N_STEPS)]
    # adam8bit's params are held after its first step (the docstring)
    held = 1 if opt == "adam8bit" else N_STEPS
    return jcfg, {"cfg": tcfg, "opt": opt, "accum": accum, "bits": bits,
                  "meshes": meshes, "seed": i, "batches": batches,
                  "held": held, "fsdp": name in FSDP_JOBS}


def _reference(jcfg, job):
    """The reference's one-device steps: per step (loss, grad norm), and
    the params' leaves after step ``job["held"]``."""
    jm = jbuild(jcfg)
    jo = jmake_optimizer(job["opt"], lr=LR)
    step = reference_jit(jmake_train_step(
        jm, jo, grad_compress_bits=job["bits"], accum_steps=job["accum"]))
    p = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(ranks.draw(job)))
    s, metrics = jo.init(p), []
    for i, b in enumerate(job["batches"]):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i + 1 == job["held"]:
            held = [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]
    return metrics, held


def _optim_payload():
    rng = np.random.default_rng(60)

    def tree(scale):
        return {k: (rng.standard_normal(shape) * scale).astype(np.float32)
                for k, (shape, _) in OPT_SHAPES.items()}
    return {"params": tree(1.0), "grads": [tree(0.03) for _ in range(3)],
            "specs": {k: spec for k, (_, spec) in OPT_SHAPES.items()},
            "optimizers": OPT_KW}


def _optim_reference(optim):
    out = {}
    for name, kw in optim["optimizers"].items():
        jo = jmake_optimizer(name, **kw)
        update = reference_jit(jo.update)
        p = jax.tree_util.tree_map(jnp.asarray, optim["params"])
        s, norms = jo.init(p), []
        for g in optim["grads"]:
            p, s, n = update(jax.tree_util.tree_map(jnp.asarray, g), s, p)
            norms.append(float(n))
        out[name] = (norms, [np.asarray(x) for x in
                             jax.tree_util.tree_leaves({"params": p,
                                                        "opt": s})])
    return out


def _pipeline_payload():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("glm4-9b")),
                              n_layers=4, dtype="float32")
    jcfg = dataclasses.replace(jreduce(jget_config("glm4-9b")), n_layers=4,
                               dtype="float32")
    blocks = params_to_numpy(build_model(cfg).init(
        torch.Generator().manual_seed(50), "cpu"))["blocks"]
    rng = np.random.default_rng(51)
    x, cot = (rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
              for _ in range(2))
    return jcfg, {"cfg": cfg, "blocks": blocks, "x": x, "cot": cot,
                  "n_micro": 4}


def _sequential(jcfg, blocks, x, cot):
    """The reference test's sequential stack, ``_apply_period`` scanned
    over the periods, and ``jax.grad`` of ``sum(y * cot)`` through it:
    (y, the blocks' gradient leaves, x's gradient)."""
    positions = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32)[None],
                                 x.shape[:2])

    def run(bl, h):
        def body(h, pp):
            y, _, _ = j_apply_period(pp, h, jcfg, positions)
            return y, None
        return jax.lax.scan(body, h, bl)[0]

    def value_and_grads(bl, h, c):
        y, vjp = jax.vjp(run, bl, h)
        return y, vjp(c)
    bl = jax.tree_util.tree_map(jnp.asarray, blocks)
    y, (gb, gx) = reference_jit(value_and_grads)(bl, jnp.asarray(x),
                                                 jnp.asarray(cot))
    return np.asarray(y), [np.asarray(g) for g in
                           jax.tree_util.tree_leaves(gb)], np.asarray(gx)


# the expert-parallel MoE layer: reduced granite, 8 experts top-2, capacity
# factor 1.0 (tokens drop), 2 data x 2 model ranks
MOE_EP_MESH = {"data": 2, "model": 2}


def _moe_ep_payload():
    over = dict(n_experts=8, top_k=2, capacity_factor=1.0, dtype="float32",
                moe_impl="shard_map")
    cfg = dataclasses.replace(reduce_for_smoke(get_config(
        "granite-moe-1b-a400m")), **over)
    jcfg = dataclasses.replace(jreduce(jget_config("granite-moe-1b-a400m")),
                               **over)
    from repro_torch.models import layers as L
    p = params_to_numpy(L.moe_init(torch.Generator().manual_seed(70), cfg,
                                   "cpu"))
    p["norm"] = p["norm"]["g"]
    rng = np.random.default_rng(71)
    x, cot = (rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
              for _ in range(2))
    return jcfg, {"cfg": cfg, "params": p, "x": x, "cot": cot}


def _moe_ep_oracle(jcfg, job):
    """``_local_moe`` over the mesh by named vmap ('model' inside 'data'):
    out (B, S, D), aux, and ``jax.grad`` of ``sum(out * cot)`` and of aux
    with respect to the params (whole) and x."""
    nd, nm = MOE_EP_MESH["data"], MOE_EP_MESH["model"]
    experts = ("w_gate", "w_up", "w_down")

    def run(p, x):
        ex = {k: p[k].reshape(nm, -1, *p[k].shape[1:]) for k in experts}
        shared = {"norm": {"g": p["norm"]}, "w_router": p["w_router"]}

        def body(ex, x_loc):
            return j_local_moe(dict(shared, **ex), x_loc, jcfg,
                               data_axis="data", model_axis="model")
        f = jax.vmap(jax.vmap(body, in_axes=(0, None), axis_name="model"),
                     in_axes=(None, 0), axis_name="data")
        out, aux = f(ex, x.reshape(nd, -1, *x.shape[1:]))
        return out[:, 0].reshape(x.shape), aux[0, 0]

    def both(p, x, cot):
        (out, aux), vjp = jax.vjp(run, p, x)
        g_out = vjp((cot, jnp.zeros_like(aux)))
        g_aux = vjp((jnp.zeros_like(out), jnp.ones_like(aux)))
        return out, aux, g_out, g_aux
    p = jax.tree_util.tree_map(jnp.asarray, job["params"])
    out, aux, g_out, g_aux = reference_jit(both)(
        p, jnp.asarray(job["x"]), jnp.asarray(job["cot"]))
    grads = {}
    for what, (gp, gx) in (("out", g_out), ("aux", g_aux)):
        grads[what] = {k: np.asarray(v) for k, v in gp.items()}
        grads[what]["x"] = np.asarray(gx)
    return np.asarray(out), float(aux), grads


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_spmd")
    saved = os.environ.get("REPRO_TUNING_CACHE")
    os.environ["REPRO_TUNING_CACHE"] = str(tmp / "tuning.json")
    try:
        yield _run(tmp)
    finally:
        if saved is None:
            os.environ.pop("REPRO_TUNING_CACHE", None)
        else:
            os.environ["REPRO_TUNING_CACHE"] = saved


def _run(tmp):
    jcfgs, jobs = {}, {}
    for i, name in enumerate(JOBS):
        jcfgs[name], jobs[name] = _job(i, name)
    jpipe, pipe = _pipeline_payload()
    jmoe, moe_ep = _moe_ep_payload()
    optim = _optim_payload()
    payload = {"jobs": jobs, "pipeline": pipe, "optim": optim,
               "moe_ep": moe_ep,
               "checkpoint": {"job": "tp-golden fp32",
                              "dir": str(tmp / "ckpt")},
               "fsdp_checkpoint": {"job": "moe-tp fsdp adafactor",
                                   "dir": str(tmp / "fsdp_ckpt")},
               "elastic": ELASTIC + ["--ckpt-dir", str(tmp / "elastic")],
               "preempt_dir": str(tmp / "preempt")}
    names = list(JOBS)
    spawn_ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(1) as pool, \
            concurrent.futures.ProcessPoolExecutor(2, spawn_ctx) as workers:
        # the reference's steps in three processes: compiling them is most
        # of this side's time (its two workers start here, outside the
        # ranks' one-thread environment)
        far = {n: workers.submit(_reference, jcfgs[n], jobs[n])
               for n in names[1::3] + names[2::3]}
        with ranks_one_thread():
            fut = pool.submit(tmesh.spawn, ranks.run_checks,
                              tmesh.Mesh({"data": 2, "model": 2}), payload,
                              device="cpu")
            ref = {n: _reference(jcfgs[n], jobs[n]) for n in names[::3]}
            seq = _sequential(jpipe, pipe["blocks"], pipe["x"], pipe["cot"])
            moe_ref = _moe_ep_oracle(jmoe, moe_ep)
            optim_ref = _optim_reference(optim)
            one = tlaunch.train(tlaunch.parse_args(
                ELASTIC + ["--ckpt-dir", str(tmp / "one")]))
            ref.update({n: f.result() for n, f in far.items()})
            results = fut.result()
    return {"ref": ref, "jobs": jobs, "ranks": results, "seq": seq,
            "moe_ref": moe_ref, "optim": optim, "optim_ref": optim_ref,
            "one": one, "tmp": tmp}


def _param_gap(got, want, steps: int, what) -> tuple[float, int]:
    """(largest |got - want|, entries beyond PARAM_ATOL), asserting the
    module docstring's bound."""
    d = np.abs(got - want)
    n_out = int((d > PARAM_ATOL).sum())
    assert n_out <= max(1, int(d.size * FLIP_FRACTION)), (what, n_out)
    assert float(d.max()) <= FLIP_LR_PER_STEP * LR * steps, (what, d.max())
    return float(d.max()), n_out


def _assembled(spmd, name, label):
    """The job's params on ``label`` after step ``held``, assembled from
    the ranks' slices (numpy leaves in tree order)."""
    job = spmd["jobs"][name]
    mesh = tmesh.Mesh(MESH_SHAPES[label])
    shapes = build_model(job["cfg"]).init(torch.Generator(), "meta")
    specs = tree_leaves_along(shapes, tsh.param_specs(
        shapes, job["cfg"], mesh, fsdp=job["fsdp"]))
    got = [res["jobs"][(name, label)] for res in spmd["ranks"]]
    # a pair mesh (2,1 / 1,2) runs on ranks 0-1 and again on ranks 2-3
    groups = [got[:2], got[2:]] if label in ("2,1", "1,2") else [got]
    out = []
    for g in groups:
        out.append(ranks.assemble(
            [tree_leaves(x["params"]) for x in g], specs,
            [tuple(t.shape) for t in tree_leaves(shapes)],
            MESH_SHAPES[label], [x["coords"] for x in g]))
    return out


@pytest.mark.parametrize("name", list(JOBS))
def test_mesh_step_matches_the_reference_one_device_step(spmd, name):
    """Every rank's loss and grad norm at each step within 1e-5 relative
    of the reference's one-device step on the same global batch; the
    params, assembled from the ranks' slices, within the module
    docstring's bound (gaps printed)."""
    ref_metrics, ref_params = spmd["ref"][name]
    for label in JOBS[name][5]:
        worst = [0.0, 0.0]
        for res in spmd["ranks"]:
            got = res["jobs"][(name, label)]["metrics"]
            for i, ((lt, gt), (lw, gw)) in enumerate(zip(got, ref_metrics)):
                for k, (a, w) in enumerate(((lt, lw), (gt, gw))):
                    rel = abs(a - w) / abs(w)
                    worst[k] = max(worst[k], rel)
                    assert rel <= METRIC_RTOL, (label, res["rank"], i, k, a,
                                                w)
        gap, n_out = 0.0, 0
        for params in _assembled(spmd, name, label):
            for j, (a, w) in enumerate(zip(params, ref_params)):
                err, n = _param_gap(a, w, spmd["jobs"][name]["held"],
                                    (label, j))
                gap, n_out = max(gap, err), n_out + n
        print(f"{name} on {label}: loss rel gap {worst[0]:.2e}, grad norm "
              f"{worst[1]:.2e}, params {gap:.2e} ({n_out} entries beyond "
              f"{PARAM_ATOL})")


def test_replicated_leaves_bit_equal_after_every_step(spmd):
    """After every step of every job, the ranks that hold the same slice
    of a leaf (params and optimizer state) hold the same bits."""
    for name, job in spmd["jobs"].items():
        shapes = build_model(job["cfg"]).init(torch.Generator(), "meta")
        for label in job["meshes"]:
            mesh = tmesh.Mesh(MESH_SHAPES[label])
            pspecs = tsh.param_specs(shapes, job["cfg"], mesh,
                                     fsdp=job["fsdp"])
            like = {"params": shapes,
                    "opt": make_optimizer(job["opt"]).init(shapes)}
            specs = tree_leaves_along(like, {
                "params": pspecs,
                "opt": make_optimizer(job["opt"]).state_specs(pspecs)})
            got = [r["jobs"][(name, label)] for r in spmd["ranks"]]
            n_shared = 0
            for step in range(N_STEPS):
                held = {}
                for g in got:
                    for leaf, (spec, dig) in enumerate(
                            zip(specs, g["digests"][step])):
                        key = (leaf, tuple(sorted(
                            (a, g["coords"][a]) for a in mesh.axis_names
                            if any(a == e or (isinstance(e, tuple) and a in e)
                                   for e in spec))))
                        held.setdefault(key, set()).add(dig)
                n_shared += sum(len(v) == 1 for v in held.values())
                bad = [k for k, v in held.items() if len(v) > 1]
                assert not bad, (name, label, step, bad[:3])
            assert n_shared > 0


@pytest.mark.parametrize("what", ["embedding", "moe"])
def test_token_gathers_backward_bit_equal_run_to_run(what):
    """The gathers whose backward adds repeated rows (the embedding lookup,
    the MoE's slot-map gather of token rows) give the same gradient bits
    in every run on several CPU threads: the replicas of
    test_replicated_leaves_bit_equal_after_every_step depend on it (an
    indexing's backward adds repeated rows with atomics in any order)."""
    import hashlib
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    cfg = ModelConfig(**dict(MOE_TP, d_model=256, vocab=64))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 4, (16, 64), generator=gen)   # many repeats
    emb = torch.randn(64, 256, generator=gen)
    moe = L.moe_init(gen, dataclasses.replace(cfg, top_k=4), "cpu")
    x = torch.randn(16, 64, 256, generator=gen)
    cot = torch.randn(16, 64, 256, generator=gen)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        digests = set()
        for _ in range(12):
            if what == "embedding":
                leaf = emb.clone().requires_grad_()
                out = tfm._embed({"embed": {"w": leaf}}, tokens, cfg)
            else:
                leaf = x.clone().requires_grad_()
                c = dataclasses.replace(cfg, top_k=4, capacity_factor=2.0)
                out = L.moe_partial(moe, leaf, c)[0].reshape(cot.shape)
            (out * cot).sum().backward()
            digests.add(hashlib.sha1(leaf.grad.numpy().tobytes()).hexdigest())
    finally:
        torch.set_num_threads(threads)
    assert len(digests) == 1


def test_tensor_parallel_step_collectives(spmd):
    """tp-golden fp32, one step: forward, an all-reduce sum for the
    embedding, around wo and w_down a layer and one for the loss's sums
    (and the loss's max); backward, one a layer where the normed x enters
    the attention and the FFN and one for the logits; the global norm's
    sum over the model axis; on 2,2 the gradient bucket over data."""
    n_layers = TP_GOLDEN["n_layers"]
    for label in ("1,2", "2,2"):
        for res in spmd["ranks"]:
            counts, backward = res["jobs"][("tp-golden fp32", label)][
                "counts"][0]
            bwd = 2 * n_layers + 1
            want = 1 + 2 * n_layers + 1 + bwd + 1 + (label == "2,2")
            assert backward == {"all_reduce_sum": bwd, "all_reduce_max": 0,
                                "all_gather": 0, "broadcast": 0}
            assert counts == {"all_reduce_sum": want, "all_reduce_max": 1,
                              "all_gather": 0, "broadcast": 0}, (label,
                                                                 counts)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_state_specs_match_reference(opt):
    """``state_specs`` of the three optimizers over tp-golden's and
    smollm's param specs equal the reference's, on meshes of one device
    repeated."""
    from test_torch_sharding import _meshes, _same
    for mesh_key in ("2x4", "1x8", "pod2x2x2"):
        jm, tm = _meshes(mesh_key)
        for what in (TP_GOLDEN, "smollm-135m"):
            jcfg, tcfg = _configs(what, "fp32")
            shapes = build_model(tcfg).init(torch.Generator(), "meta")
            jspecs = jsh.param_specs(shapes, jcfg, jm)
            got = make_optimizer(opt).state_specs(
                tsh.param_specs(shapes, tcfg, tm))
            want = jmake_optimizer(opt).state_specs(jspecs, shapes)
            _same(want, got)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sharded_optimizer_matches_reference(spmd, opt):
    """Three updates on 2,2 of leaves cut over N, K, E, both axes and
    none, from the reference's gradients: the grad norm within 1e-6
    relative, params and float state within 1e-6 of their largest
    magnitude, adam8bit's int8 codes equal (the global absmax an
    all-reduce max, the norm's squares summed over the cut axes)."""
    optim = spmd["optim"]
    want_norms, want = spmd["optim_ref"][opt]
    pspecs = optim["specs"]
    shapes = {k: torch.empty(shape, device="meta")
              for k, (shape, _) in OPT_SHAPES.items()}
    like = {"params": shapes, "opt": make_optimizer(opt).init(shapes)}
    specs = tree_leaves_along(like, {
        "params": pspecs, "opt": make_optimizer(opt).state_specs(pspecs)})
    got = [r["optim"][opt] for r in spmd["ranks"]]
    for norms, _ in got:
        for a, w in zip(norms, want_norms):
            assert abs(a - w) <= 1e-6 * abs(w)
    leaves = ranks.assemble([tree_leaves(g[1]) for g in got], specs,
                            [tuple(t.shape) for t in tree_leaves(like)],
                            MESH_SHAPES["2,2"],
                            [r["rank_coords"] for r in spmd["ranks"]])
    assert len(leaves) == len(want)
    for i, (a, w) in enumerate(zip(leaves, want)):
        if w.dtype == np.int8:
            assert np.array_equal(a, w), (opt, i)
        else:
            tol = 1e-6 * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(a - w).max()) <= tol, (opt, i)


def test_checkpoint_saved_on_a_mesh_restores_anywhere(spmd):
    """tp-golden's state after two steps on 2,2, saved by the four ranks
    (each its slices): restored on 4,1 and on 1,2 each rank's slices are
    the whole restore's cut; restored whole by the port and by the
    reference, the params equal the ranks' slices assembled, bit for
    bit."""
    for res in spmd["ranks"]:
        assert res["restores"] == {"4,1": True, "1,2": True}
    path = str(spmd["tmp"] / "ckpt")
    hosts = sorted(os.listdir(os.path.join(path, "step_2")))
    assert hosts == ["COMPLETE"] + [f"host_{r}" for r in range(4)]
    job = spmd["jobs"]["tp-golden fp32"]
    params = ranks.draw(job)
    like = {"params": params, "opt": make_optimizer("adamw").init(params)}
    whole = Checkpointer(path).restore(2, like)
    want = _assembled(spmd, "tp-golden fp32", "2,2")[0]
    got = tree_leaves(whole["params"])
    assert all(np.array_equal(a.numpy(), w) for a, w in zip(got, want))
    assert int(whole["opt"]["count"]) == 2
    jlike = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(like))
    jgot = JCheckpointer(path).restore(2, jlike)
    for a, b in zip(jax.tree_util.tree_leaves(jgot), tree_leaves(whole)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_elastic_resume_on_a_smaller_mesh(spmd):
    """``launch.train.train(args, mesh=)`` with ``--device cpu``: reduced
    smollm fp32 on 4,1, rank 0 preempted during step 3 (every rank stops
    there and checkpoints), resumed on 2,1 to step 6 from the step-3
    checkpoint and data position; the six steps' metrics within 1e-5 and
    the final params within the module docstring's bound of an
    uninterrupted one-rank run's."""
    one = spmd["one"]
    want_p = [t.numpy() for t in tree_leaves(one.state["params"])]
    for res in spmd["ranks"]:
        status, first = res["elastic"]["first"]
        assert status == "preempted" and len(first) == 3
        if res["rank"] >= 2:
            continue
        status, second, data, params = res["elastic"]["second"]
        assert status == "done" and len(second) == 3 and data == {"step": 6}
        for got, want in zip(first + second, one.metrics):
            for k in ("loss", "grad_norm"):
                assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k])
        gaps = [_param_gap(a, w, 6, j) for j, (a, w) in
                enumerate(zip(tree_leaves(params), want_p))]
        print(f"elastic 4,1 -> 2,1 against one rank: params gap "
              f"{max(g for g, _ in gaps):.2e} "
              f"({sum(n for _, n in gaps)} entries beyond {PARAM_ATOL})")
    assert Checkpointer(str(spmd["tmp"] / "elastic")).all_steps() == [3, 6]


def test_fsdp_step_collectives(spmd):
    """moe-tp with the FSDP rule, one step: per MoE layer the rows'
    gather, each expert weight gathered where it is used and gathered
    again in the backward (its activations are not kept), and in the
    backward the gathers' reduce-scatters (all-reduce, this rank's slice)
    of the rows and the three expert weights; the FSDP leaves skip the
    gradient bucket's data sum, so one bucket all-reduce a step (plus the
    global norm's sums over the cut axes)."""
    n_layers = MOE_TP["n_layers"]
    for name in sorted(FSDP_JOBS):
        for label in JOBS[name][5]:
            for res in spmd["ranks"]:
                counts, backward = res["jobs"][(name, label)]["counts"][0]
                assert counts["all_gather"] == 7 * n_layers, (name, label)
                assert backward["all_reduce_sum"] >= 4 * n_layers
                assert backward["all_gather"] == 0


def test_fsdp_checkpoint_restores_on_one_rank(spmd):
    """An FSDP state (moe-tp, adafactor, two steps on 2,2: expert weights
    cut over data and model) saved by the four ranks restores on a one-rank
    mesh equal to the whole restore."""
    for res in spmd["ranks"]:
        assert res["fsdp_restores"] == {"1,1": True}


def test_preemption_is_agreed_across_ranks(spmd):
    """SIGTERM on one rank of four during step 1: all four stop after
    step 2 with a joint checkpoint at 2."""
    for res in spmd["ranks"]:
        assert res["preempt"] == ("preempted", 2, 2, [2])


def test_pipeline_matches_sequential_stack(spmd):
    """``pipeline_blocks`` on 2 stages (4 periods of reduced glm4 in f32,
    n_micro 4, each model-axis pair of ranks its own pipeline) within 1e-5
    of the reference's sequential period scan; each stage's sends and
    receives are its microbatches; one broadcast of the result.
    ``bubble_fraction`` equals the reference's."""
    for res in spmd["ranks"]:
        y, p2p, bcast = res["pipeline"]
        np.testing.assert_allclose(y, spmd["seq"][0], rtol=1e-5, atol=1e-5)
        stage = res["rank"] // 2
        assert p2p == ({"send": 4, "recv": 0} if stage == 0
                       else {"send": 0, "recv": 4}) and bcast == 1
    for s_, m in ((1, 8), (4, 4), (2, 16), (2, 4)):
        assert bubble_fraction(s_, m) == jbubble(s_, m)


def _leaf_close(got, want, what):
    """``got`` within 1e-5 of ``want``'s largest magnitude; the ratio."""
    tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert got.shape == want.shape and gap <= tol, (what, gap, tol)
    return gap / tol


def test_pipeline_gradients_match_jax_grad(spmd):
    """``pipeline_blocks`` under autograd (2 stages, n_micro 4, the payload
    of test_pipeline_matches_sequential_stack): the gradient of
    sum(y * cot) w.r.t. every block leaf and x within 1e-5 of each leaf's
    largest magnitude of ``jax.grad`` of the reference's sequential scan;
    the same bits on every rank; per stage, the backward's p2p (stage 1
    sends and stage 0 receives each microbatch's cotangent) on top of the
    forward's, and one bucket all-reduce."""
    _, want_blocks, want_x = spmd["seq"]
    worst = 0.0
    first = spmd["ranks"][0]["pipeline_grads"]
    for res in spmd["ranks"]:
        blocks, gx, p2p, p2p_bwd, bwd = res["pipeline_grads"]
        assert len(blocks) == len(want_blocks)
        for i, (a, w) in enumerate(zip(blocks, want_blocks)):
            worst = max(worst, _leaf_close(a, w, ("block", i)))
        worst = max(worst, _leaf_close(gx, want_x, "x"))
        assert all(np.array_equal(a, b) for a, b in
                   zip(blocks + [gx], first[0] + [first[1]]))
        stage = res["rank"] // 2
        assert p2p_bwd == ({"send": 0, "recv": 4} if stage == 0
                           else {"send": 4, "recv": 0})
        assert p2p == {"send": 4, "recv": 4}
        assert bwd == {"all_reduce_sum": 1, "all_reduce_max": 0,
                       "all_gather": 0, "broadcast": 0}
    print(f"pipeline gradients: worst leaf {worst:.3f} of its bound")


def test_expert_parallel_moe_layer_matches_named_vmap_oracle(spmd):
    """The expert-parallel MoE layer in a train step's sharding (2 data x 2
    model ranks, tokens dropped at capacity factor 1.0) against the
    reference's ``_local_moe`` under named vmap: each rank's output rows
    and the aux value; the gradients of the rows' objective and of the aux
    term averaged over the data ranks (the params: the router and norm
    whole, each model rank's experts; x: each rank's rows, divided by the
    row count) within 1e-5 of each leaf's largest magnitude.  With the
    load-balance all-reduce's backward the identity, the aux term's
    gradient would come out half the oracle's."""
    out, aux, grads = spmd["moe_ref"]
    ranks_ = [r["moe_ep"] for r in spmd["ranks"]]
    nd = MOE_EP_MESH["data"]
    assert any(r["held"] != ranks_[0]["held"] for r in ranks_)
    worst = 0.0
    for r in ranks_:
        rows = slice(*r["mine"])
        worst = max(worst, _leaf_close(r["y"], out[rows], "out"))
        assert abs(r["aux_value"] - aux) <= 1e-5 * abs(aux)
    for what in ("out", "aux"):
        for k, want in grads[what].items():
            got = np.zeros_like(want)
            for r in ranks_:
                g = r[what][k]
                if k == "x":
                    got[slice(*r["mine"])] = g / nd
                elif k in ("w_gate", "w_up", "w_down"):
                    got[slice(*r["held"])] += g / nd
                elif r["held"][0] == 0:        # replicated over model
                    got += g / nd
            worst = max(worst, _leaf_close(got, want, (what, k)))
    print(f"expert-parallel MoE layer: worst leaf {worst:.3f} of its bound")


def test_refusals():
    """A shape-only mesh of several ranks trains nowhere (the pipeline's
    gradients and the expert-parallel MoE in a train step, refused before,
    are test_pipeline_gradients_match_jax_grad and
    test_expert_parallel_moe_layer_matches_named_vmap_oracle)."""
    with pytest.raises(ValueError, match="shape alone"):
        tlaunch.train(tlaunch.parse_args(ELASTIC + ["--ckpt-dir", "x"]),
                      mesh=tmesh.Mesh({"data": 2, "model": 1}))

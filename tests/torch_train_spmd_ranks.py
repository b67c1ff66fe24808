"""Rank-side checks of tests/test_torch_train_spmd.py: run on every rank of
one spawn of 4 CPU ranks over gloo (``launch.mesh.spawn``).  This module
imports the port only (the ranks start without JAX); the test module holds
the reference's side and every assertion.

:func:`run_checks` returns, per rank, plain data: each train job's
metrics, a digest of every local leaf after every step, its final local
params and the collectives of its steps; the elastic run's metrics and
state; the checkpoint restores' equalities; the pipeline's output and, under autograd, its
gradients; the expert-parallel MoE layer's output, aux and gradients."""
from __future__ import annotations

import hashlib
import signal

import numpy as np
import torch

import repro_torch.launch.train as tlaunch
from repro_torch.checkpoint import Checkpointer
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.comm import StepSharding
from repro_torch.parallel.moe_shard_map import moe_apply_shard_map
from repro_torch.parallel.pipeline import pipeline_blocks
from repro_torch.runtime import ElasticTrainer
from repro_torch.tree import tree_leaves, tree_map

LR = 1e-3


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def state_specs(job, mesh):
    """{"params", "opt"} specs of ``job``'s state on ``mesh`` (with the
    FSDP rule for an FSDP job)."""
    cfg = job["cfg"]
    shapes = build_model(cfg).init(torch.Generator(), "meta")
    pspecs = shd.param_specs(shapes, cfg, mesh, fsdp=job.get("fsdp", False))
    opt = make_optimizer(job["opt"], lr=LR)
    return {"params": pspecs, "opt": opt.state_specs(pspecs)}


def draw(job) -> dict:
    """``job``'s initial params, whole: the port's draw from its seed (the
    reference starts from the same, through ``interop``)."""
    return build_model(job["cfg"]).init(
        torch.Generator().manual_seed(job["seed"]), "cpu")


def train_job(job, mesh) -> dict:
    """``job``'s steps over ``mesh`` from its params (drawn whole, cut
    here); the params kept after step ``job["held"]``."""
    cfg = job["cfg"]
    model, opt = build_model(cfg), make_optimizer(job["opt"], lr=LR)
    params = draw(job)
    fsdp = job.get("fsdp", False)
    params = shd.shard_tree(params, shd.param_specs(params, cfg, mesh,
                                                    fsdp=fsdp), mesh)
    state = opt.init(params)
    step = make_train_step(model, opt, grad_compress_bits=job["bits"],
                           accum_steps=job["accum"], mesh=mesh, fsdp=fsdp)
    out = {"metrics": [], "digests": [], "counts": []}
    for i, batch in enumerate(job["batches"]):
        batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        comm.reset_collective_counts()
        params, state, m = step(params, state, batch)
        out["counts"].append((comm.collective_counts(),
                              comm.backward_counts()))
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        out["digests"].append([digest(t) for t in
                               tree_leaves({"params": params, "opt": state})])
        if i + 1 == job["held"]:
            out["params"] = params_to_numpy(params)
    out["state"] = {"params": params, "opt": state}
    return out


def _restores(job, state, world, meshes, ckpt_dir) -> dict:
    """Save ``state`` (``job`` on ``world``) at step 2; restore it whole
    (no shardings) and onto each of ``meshes``: each rank's slices
    ``torch.equal`` to the whole restore's cut."""
    ck = Checkpointer(ckpt_dir)
    ck.save(2, state, shardings=shd.TreeSharding(state_specs(job, world),
                                                 world))
    whole_like = {"params": draw(job)}
    whole_like["opt"] = make_optimizer(job["opt"]).init(whole_like["params"])
    whole = ck.restore(2, whole_like)
    out = {}
    for label, mesh in meshes.items():
        if mesh is None:
            continue
        specs = state_specs(job, mesh)
        like = shd.shard_tree(whole_like, specs, mesh)
        got = ck.restore(2, like, shd.TreeSharding(specs, mesh))
        want = shd.shard_tree(whole, specs, mesh)
        out[label] = all(a.shape == b.shape and torch.equal(a, b) for a, b in
                         zip(tree_leaves(got), tree_leaves(want)))
    return out


def optimizer_updates(optim, mesh) -> dict:
    """Each optimizer's three updates over ``mesh`` on the slices of
    ``optim``'s whole params and gradients (cut by its specs): the grad
    norms and the final local params and state."""
    out = {}
    specs = optim["specs"]
    for name, kw in optim["optimizers"].items():
        opt = make_optimizer(name, **kw)
        params = shd.shard_tree(params_from_numpy(optim["params"], "cpu"),
                                specs, mesh)
        state, norms = opt.init(params), []
        for g in optim["grads"]:
            g = shd.shard_tree(params_from_numpy(g, "cpu"), specs, mesh)
            params, state, n = opt.update(g, state, params, specs=specs,
                                          mesh=mesh)
            norms.append(float(n))
        out[name] = (norms, params_to_numpy({"params": params,
                                             "opt": state}))
    return out


def _preempting(rank_to_signal: int, at_call: int):
    """launch.train's make_train_step, whose step raises SIGTERM on one
    rank during its ``at_call``-th call (a preemption on one host)."""
    make = make_train_step

    def factory(*args, mesh=None, **kw):
        step = make(*args, mesh=mesh, **kw)
        calls = [0]

        def wrapped(*a):
            calls[0] += 1
            if calls[0] == at_call and mesh.rank == rank_to_signal:
                signal.raise_signal(signal.SIGTERM)
            return step(*a)
        return wrapped
    return factory


def _elastic(m41, pair, argv) -> dict:
    """3 steps on 4,1 (rank 0 preempted during the third), then a resume
    on the 2,1 mesh of ranks 0-1 to step 6."""
    args = tlaunch.parse_args(argv)
    tlaunch.make_train_step = _preempting(0, 3)
    try:
        first = tlaunch.train(args, mesh=m41)
    finally:
        tlaunch.make_train_step = make_train_step
    out = {"first": (first.status, first.metrics)}
    if m41.rank < 2:
        second = tlaunch.train(args, mesh=pair)
        out["second"] = (second.status, second.metrics,
                         second.data.state_dict(),
                         params_to_numpy(second.state["params"]))
    m41.barrier()
    return out


def _agreed_preemption(world, path) -> tuple:
    """ElasticTrainer over the 2,2 world, SIGTERM on rank 3 only during
    step 1: every rank stops after step 2, "preempted", and the step-2
    checkpoint is the ranks' joint save in ``path``."""
    def build(n_data, n_model):
        def step_fn(state, batch):
            if int(state["n"]) == 1 and world.rank == 3:
                signal.raise_signal(signal.SIGTERM)
            return {"n": state["n"] + 1}, {"loss": 0.0}
        return world, {"n": torch.zeros((), dtype=torch.int64)}, \
            shd.TreeSharding({"n": ()}, world), step_fn

    class Data:
        def __next__(self):
            return None
    ck = Checkpointer(path)
    state, metrics, status = ElasticTrainer(ck, build).run(5, 2, 2, Data())
    return status, len(metrics), int(state["n"]), ck.all_steps()


def pipeline_grads(world, pipe) -> tuple:
    """``pipe``'s blocks and x through ``pipeline_blocks`` under autograd
    (2 stages over 'data'), the objective sum(y * cot): the gradients of the
    blocks (numpy leaves) and of x, the p2p counts forward and backward and
    the backward's collectives."""
    blocks = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(pipe["blocks"], "cpu"))
    x = torch.from_numpy(pipe["x"]).requires_grad_()
    comm.reset_collective_counts()
    y = pipeline_blocks(blocks, x, pipe["cfg"], world, axis="data",
                        n_micro=pipe["n_micro"])
    (y * torch.from_numpy(pipe["cot"])).sum().backward()
    return ([t.grad.numpy() for t in tree_leaves(blocks)], x.grad.numpy(),
            comm.p2p_counts(), comm.p2p_counts(backward=True),
            comm.backward_counts())


def moe_ep(world, job) -> dict:
    """The expert-parallel MoE layer on this rank of the 2x2 world (its
    data shard's rows, its model shard's experts) in a train step's
    sharding: the output and aux, and the gradients of two objectives, the
    rows' ``R sum(out * cot)`` and the aux term (R the row ranks: each rank
    holds its rows' objective, as a train step's rank its loss; the
    gradients are averaged over the rows after)."""
    cfg, p = job["cfg"], job["params"]
    tp, rows = world.axis("model"), world.axis("data")
    e_loc = cfg.n_experts // tp.size
    held = slice(tp.index * e_loc, (tp.index + 1) * e_loc)
    n = job["x"].shape[0] // rows.size
    mine = slice(rows.index * n, (rows.index + 1) * n)
    shard = StepSharding(world, tp=tp, rows=rows, global_rows=True)
    out = {}
    for what in ("out", "aux"):
        lp = {k: torch.from_numpy(v[held] if k.startswith("w_") and
                                  k != "w_router" else v).requires_grad_()
              for k, v in p.items() if k != "norm"}
        lp["norm"] = {"g": torch.from_numpy(p["norm"]).requires_grad_()}
        x = torch.from_numpy(job["x"][mine]).requires_grad_()
        y, aux = moe_apply_shard_map(lp, x, cfg, shard)
        obj = rows.size * (y * torch.from_numpy(job["cot"][mine])).sum() \
            if what == "out" else aux
        obj.backward()
        leaves = dict(lp, norm=lp["norm"]["g"], x=x)
        out[what] = {k: (torch.zeros_like(v) if v.grad is None else v.grad
                         ).numpy() for k, v in leaves.items()}
        out["y"], out["aux_value"] = y.detach().numpy(), float(aux.detach())
    out["held"], out["mine"] = (held.start, held.stop), (mine.start,
                                                         mine.stop)
    return out


def run_checks(world, payload):
    """Every rank of a 2x2 world: the train jobs on their meshes (2,1 and
    1,2 as two pairs of ranks side by side), the checkpoint restores (an
    FSDP state's on a one-rank mesh too), the elastic run, the agreed
    preemption and the pipeline."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    r = world.rank

    # every make_mesh over several ranks is collective: all ranks call each
    m41 = make_mesh(4, 1)
    pair21 = [make_mesh(2, 1, ranks=[0, 1]), make_mesh(2, 1, ranks=[2, 3])]
    pair12 = [make_mesh(1, 2, ranks=[0, 1]), make_mesh(1, 2, ranks=[2, 3])]
    meshes = {"2,2": world, "4,1": m41, "2,1": pair21[r // 2],
              "1,2": pair12[r // 2]}
    res = {"rank": r, "jobs": {}, "rank_coords": world.coords}
    states = {}
    for name, job in payload["jobs"].items():
        for label in job["meshes"]:
            got = train_job(job, meshes[label])
            got["coords"] = meshes[label].coords
            states[(name, label)] = got.pop("state")
            res["jobs"][(name, label)] = got
    res["optim"] = optimizer_updates(payload["optim"], world)
    ck = payload["checkpoint"]
    res["restores"] = _restores(payload["jobs"][ck["job"]],
                                states[(ck["job"], "2,2")], world,
                                {"4,1": m41, "1,2": meshes["1,2"]},
                                ck["dir"])
    ck = payload["fsdp_checkpoint"]
    res["fsdp_restores"] = _restores(payload["jobs"][ck["job"]],
                                     states[(ck["job"], "2,2")], world,
                                     {"1,1": make_mesh(1, 1, ranks=[r])},
                                     ck["dir"])
    res["elastic"] = _elastic(m41, meshes["2,1"], payload["elastic"])
    res["preempt"] = _agreed_preemption(world, payload["preempt_dir"])

    pipe = payload["pipeline"]
    blocks = params_from_numpy(pipe["blocks"], "cpu")
    comm.reset_collective_counts()
    with torch.no_grad():
        y = pipeline_blocks(blocks, torch.from_numpy(pipe["x"]), pipe["cfg"],
                            world, axis="data", n_micro=pipe["n_micro"])
    res["pipeline"] = (y.numpy(), comm.p2p_counts(),
                       comm.collective_counts()["broadcast"])
    res["pipeline_grads"] = pipeline_grads(world, pipe)
    res["moe_ep"] = moe_ep(world, payload["moe_ep"])
    return res


def local_slices(shape, spec, mesh_shape, coords) -> tuple:
    """The index (a tuple of slices) of the rank at ``coords``'s slice of a
    leaf of global ``shape`` under ``spec``."""
    from repro_torch.launch.mesh import Mesh
    m = Mesh(mesh_shape)
    m.coords = dict(coords)
    return tuple(slice(a, b) for a, b in shd.slice_index(shape, spec, m))


def assemble(leaves_by_rank, specs_leaves, shapes, mesh_shape, coords_by_rank):
    """Whole leaves from the ranks' local slices (numpy)."""
    out = []
    for i, (spec, shape) in enumerate(zip(specs_leaves, shapes)):
        a = np.zeros(shape, leaves_by_rank[0][i].dtype)
        for leaves, coords in zip(leaves_by_rank, coords_by_rank):
            a[local_slices(shape, spec, mesh_shape, coords)] = leaves[i]
        out.append(a)
    return out

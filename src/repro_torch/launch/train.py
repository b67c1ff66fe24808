"""Training launcher — ``repro.launch.train``'s loop: a ``(n_dev, 1)`` mesh
of the visible devices, ElasticTrainer + checkpoints + straggler monitor +
the synthetic data pipeline, QAT at any of the paper's precisions.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 --batch 8 --seq 128 --precision 2xT --reduced

``--reduced`` swaps in the smoke-scale config.  Runs on the cards
(``--device cuda``, the default) and refuses to start when no card is
visible: with several cards visible it spawns one rank a card
(``launch.mesh.spawn``, NCCL) and trains data-parallel on a ``(n_dev, 1)``
mesh, as the reference's launcher trains on ``jax.make_mesh((n_dev, 1))``;
with one it is the one-rank loop.  ``--device cpu`` trains on the host
(one device).  :func:`train` takes a rank's mesh from a caller (a rank of
``launch.mesh.spawn``): the params are drawn whole, from the same seed on
every rank, and cut to the rank's slices.  Training runs no
hand-written kernel, as the reference's runs no Pallas kernel: the
quantized projections are the fake-quant (straight-through) forms and
attention under autograd is the reference's plain training attention.
The trained float params serve through the kernels once packed
(``models.to_serving``).

A run resumes from the newest checkpoint in ``--ckpt-dir`` (the params,
the optimizer state and the data position), on whatever mesh it runs:
point it at an empty directory for a fresh run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model, ModelConfig, build_model, reduce_for_smoke
from repro_torch.optim import make_optimizer
from repro_torch.parallel.sharding import TreeSharding, param_specs, shard_tree
from repro_torch.runtime import ElasticTrainer, StragglerMonitor
from repro_torch.tree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "adam8bit"])
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refuses to start without a card) "
                         "or cpu")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` returns: the trained state ({"params", "opt"};
    over a mesh this rank's slices, from rank 0 of a spawned run), each
    step's metrics, the trainer's status ("done" | "preempted"), the
    loop's wall seconds, each step's own wall ms (batch to the device, the
    train step, its metrics read back) and the data iterator (its
    ``state_dict()`` is the data position)."""
    cfg: ModelConfig
    model: Model
    state: dict
    metrics: list
    status: str
    wall_s: float
    step_ms: list
    stragglers: int
    data: SyntheticLM


def train(args: argparse.Namespace, cfg: ModelConfig | None = None,
          mesh: Mesh | None = None) -> TrainRun:
    """The launcher's run of ``args``; ``cfg`` (a caller's depth cut of the
    config) replaces the one ``--arch`` / ``--precision`` / ``--reduced``
    name.  ``mesh``: a rank's mesh (inside ``launch.mesh.spawn``; every
    rank calls ``train``), on whose device the rank trains its slices;
    without one, several visible cards train a ``(n_dev, 1)`` mesh of
    spawned ranks, one card or the host the one-rank loop."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, precision=args.precision)
        if args.reduced:
            cfg = reduce_for_smoke(cfg)
    if mesh is None and device.type == "cuda" and \
            torch.cuda.device_count() > 1:
        return _train_spawned(args, cfg, torch.cuda.device_count())
    if mesh is not None:
        if mesh.size > 1 and mesh.groups is None:
            raise ValueError(f"{mesh!r} was built from a shape alone: train "
                             "on a rank's mesh (launch.mesh.spawn)")
        device = mesh.device or device
    model = build_model(cfg)
    opt = make_optimizer(args.optimizer, lr=args.lr)
    step = make_train_step(model, opt, accum_steps=args.accum_steps,
                           mesh=mesh)
    step_ms = []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device, torch.int64)
                 for k, v in batch.items()}
        p, o, metrics = step(state["params"], state["opt"], batch)
        out = {k: float(v) for k, v in metrics.items()}
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"params": p, "opt": o}, out

    def build(n_data, n_model):
        params = model.init(torch.Generator().manual_seed(0), device)
        if mesh is None:
            return None, {"params": params, "opt": opt.init(params)}, None, \
                step_fn
        pspecs = param_specs(params, cfg, mesh)
        params = shard_tree(params, pspecs, mesh)
        specs = {"params": pspecs, "opt": opt.state_specs(pspecs)}
        return mesh, {"params": params, "opt": opt.init(params)}, \
            TreeSharding(specs, mesh), step_fn

    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
    monitor = StragglerMonitor()
    trainer = ElasticTrainer(Checkpointer(args.ckpt_dir), build,
                             save_every=args.save_every)
    t0 = time.time()
    n_data, n_model = (1, 1) if mesh is None else \
        (mesh.shape["data"], mesh.shape["model"])
    state, metrics, status = trainer.run(args.steps, n_data, n_model, data,
                                         monitor=monitor)
    return TrainRun(cfg, model, state, metrics, status, time.time() - t0,
                    step_ms, len(monitor.events), data)


def _rank_train(mesh, args, cfg) -> dict | None:
    """One spawned rank's :func:`train`; rank 0 returns its run's fields
    (the state on the host; not the model, which does not pickle)."""
    run = train(args, cfg, mesh)
    if mesh.rank != 0:
        return None
    out = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)
           if f.name != "model"}
    out["state"] = tree_map(lambda t: t.cpu(), run.state)
    return out


def _train_spawned(args, cfg, n_dev: int) -> TrainRun:
    """``args`` trained on a ``(n_dev, 1)`` mesh, one spawned rank a card:
    rank 0's run."""
    out = spawn(_rank_train, Mesh({"data": n_dev, "model": 1}), args, cfg,
                device="cuda")[0]
    return TrainRun(model=build_model(out["cfg"]), **out)


def main(argv=None):
    run = train(parse_args(argv))
    losses = [m["loss"] for m in run.metrics]
    if losses:
        print(f"status={run.status} steps={len(losses)} "
              f"wall={run.wall_s:.1f}s first_loss={losses[0]:.4f} "
              f"last_loss={losses[-1]:.4f} stragglers={run.stragglers}")
    return losses


if __name__ == "__main__":
    main()

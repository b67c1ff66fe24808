"""Training over a mesh on the cards, one rank a card over NCCL, against
one card's train step (tests/test_torch_train_spmd.py's bounds, which
hold the same step to the reference on the CPU): reduced smollm fp32 on
4,1 (pure DP) and glm4-9b at full width with 2 layers in f32 on 2,2
(tensor parallel: 16 heads, 1 KV head, d_ff 6848 a rank), adamw lr 1e-3,
two steps.  Every rank's loss and grad norm within 1e-5 relative of one
card's; the params, assembled from the ranks' slices, within 1e-4 of one
card's but for at most one entry in 10^4 of a leaf (within 2.2 lr a
step); the ranks that hold the same slice of a leaf hold the same bits
after every step.  Marked ``cuda``; skips without four cards.  Imports no
JAX, so it runs on the cards' machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_spmd_cuda.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_along  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_spmd_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.cuda

LR = ranks.LR
METRIC_RTOL, PARAM_ATOL = 1e-5, 1e-4
FLIP_FRACTION, FLIP_LR_PER_STEP = 1e-4, 2.2


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return torch.device("cuda", 0)


def _batches(cfg, b, s, seed=3):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
             for k in ("tokens", "labels")} for _ in range(2)]


def _run(cfg, device, mesh=None, b=8, s=64):
    """Two adamw steps from seed 0's params (drawn on the card): metrics,
    a digest of every local leaf after each step, the final local params
    on the host."""
    model, opt = build_model(cfg), make_optimizer("adamw", lr=LR)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    if mesh is not None:
        params = shd.shard_tree(params, shd.param_specs(params, cfg, mesh),
                                mesh)
    state = opt.init(params)
    step = make_train_step(model, opt, mesh=mesh)
    out = {"metrics": [], "digests": []}
    for batch in _batches(cfg, b, s):
        batch = {k: v.to(device) for k, v in batch.items()}
        params, state, m = step(params, state, batch)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        out["digests"].append([ranks.digest(t.cpu()) for t in
                               tree_leaves({"params": params, "opt": state})])
    out["params"] = [t.cpu().numpy() for t in tree_leaves(params)]
    return out


def _rank(mesh, cfg, b, s):
    out = _run(cfg, mesh.device, mesh, b, s)
    out["coords"] = mesh.coords
    return out


def _check(cfg, mesh_shape, b, s, device):
    from repro_torch.parallel.comm import choose_backend
    assert choose_backend("cuda", 4) == "nccl"
    one = _run(cfg, device, None, b, s)
    torch.cuda.empty_cache()        # the ranks share card 0 with this run
    got = spawn(_rank, Mesh(mesh_shape), cfg, b, s, device="cuda")
    for res in got:
        for (lt, gt), (lw, gw) in zip(res["metrics"], one["metrics"]):
            assert abs(lt - lw) <= METRIC_RTOL * abs(lw), (lt, lw)
            assert abs(gt - gw) <= METRIC_RTOL * abs(gw), (gt, gw)
    shapes = build_model(cfg).init(torch.Generator(), "meta")
    mesh = Mesh(mesh_shape)
    pspecs = shd.param_specs(shapes, cfg, mesh)
    specs = tree_leaves_along(shapes, pspecs)
    params = ranks.assemble([r["params"] for r in got], specs,
                            [tuple(t.shape) for t in tree_leaves(shapes)],
                            mesh_shape, [r["coords"] for r in got])
    gap = 0.0
    for j, (a, w) in enumerate(zip(params, one["params"])):
        d = np.abs(a - w)
        assert int((d > PARAM_ATOL).sum()) <= max(1, int(d.size *
                                                      FLIP_FRACTION)), j
        assert float(d.max()) <= FLIP_LR_PER_STEP * LR * 2, (j, d.max())
        gap = max(gap, float(d.max()))
    like = {"params": shapes, "opt": make_optimizer("adamw").init(shapes)}
    all_specs = tree_leaves_along(like, {
        "params": pspecs, "opt": make_optimizer("adamw").state_specs(pspecs)})
    shapes_all = [tuple(t.shape) for t in tree_leaves(like)]
    for step in range(2):
        held = {}
        for r in got:
            at = _at(mesh_shape, r["coords"])
            for leaf, (spec, dig) in enumerate(zip(all_specs,
                                                   r["digests"][step])):
                idx = shd.slice_index(shapes_all[leaf], spec, at)
                held.setdefault((leaf, str(idx)), set()).add(dig)
        assert all(len(v) == 1 for v in held.values()), step
    print(f"{cfg.name} on {mesh_shape}: params within {gap:.2e} of one "
          "card's")


def _at(mesh_shape, coords):
    m = Mesh(mesh_shape)
    m.coords = dict(coords)
    return m


def test_pure_dp_smollm_on_four_cards(cards):
    cfg = reduce_for_smoke(get_config("smollm-135m", precision="fp32"))
    _check(cfg, {"data": 4, "model": 1}, 8, 64, cards)


def test_tensor_parallel_glm4_on_four_cards(cards):
    cfg = dataclasses.replace(get_config("glm4-9b", precision="fp32"),
                              n_layers=2, dtype="float32")
    _check(cfg, {"data": 2, "model": 2}, 2, 64, cards)


def test_launcher_trains_on_every_card(cards, tmp_path, capsys):
    """``python -m repro_torch.launch.train`` with four cards visible
    trains on a (4, 1) mesh, one spawned rank a card over NCCL, as the
    reference's launcher trains on ``jax.make_mesh((n_dev, 1))``."""
    from repro_torch.launch import train as tlaunch
    losses = tlaunch.main(["--reduced", "--steps", "3", "--batch", "8",
                           "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert capsys.readouterr().out.startswith("status=done steps=3 ")
    assert sorted(os.listdir(tmp_path / "step_3")) == \
        ["COMPLETE"] + [f"host_{r}" for r in range(4)]

"""Rank side of tests/test_torch_analysis.py: one spawn of 2 CPU ranks over
gloo audits ``tp-d1024`` on a 1,2 mesh and ``smollm-dp`` on a 2,1 mesh of
the same ranks, and runs a pure-DP step seeded with an all-reduce.  This
module imports the port only; the test module holds the assertions."""
from __future__ import annotations

import torch

from repro_torch.analysis import rules as R
from repro_torch.analysis.report import StepSpec
from repro_torch.analysis.steps import build_cell_steps, cell_by_name
from repro_torch.launch.mesh import make_mesh


def run_checks(world, payload):
    torch.set_num_threads(1)
    m12 = make_mesh(1, 2)
    m21 = make_mesh(2, 1)
    out = {"rank": world.rank}
    for name, mesh in (("tp-d1024", m12), ("smollm-dp", m21)):
        got = []
        for spec in build_cell_steps(cell_by_name(name), mesh):
            findings, rules = R.audit_step(spec)
            got.append((spec.name, [str(f) for f in findings], rules))
        out[name] = got
    data = m21.axis("data")
    seeded = StepSpec(name="psum-step",
                      fn=lambda x: data.all_reduce_sum(x),
                      args=(torch.ones(4),), pure_dp=True)
    findings, _ = R.audit_step(seeded, rules=tuple(R.RULES))
    out["seeded"] = [(f.rule, f.message) for f in findings]
    return out

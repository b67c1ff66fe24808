"""Tensor-parallel serving on the card: the ``tp-golden`` model (d 1024, 8
heads, tests/test_serving_spmd.py's) at 2xT kv8, packed with
``to_serving(tp=2)``, served by the dense and the paged batcher over a 1,2
mesh of two ranks (sharing one card over gloo, or a card each over NCCL),
against the same batchers on one card: identical greedy streams, and per
model call each rank launches B1 / B7c once a projection and its
attention kernel once a layer and decode step.  With four cards, over
NCCL: tp-golden on 2,2 and a GQA model whose 8 query heads split over 4
ranks while its 2 KV heads do not (1,4).  Every test is marked ``cuda``
and skips without the cards it needs.  Imports no JAX, so it runs on the
card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spmd_cuda.py
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import parse_mesh, spawn  # noqa: E402
from repro_torch.models import build_model, to_serving  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spmd_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.cuda

TP_GOLDEN = dict(name="tp-golden", n_layers=2, d_model=1024, n_heads=8,
                 n_kv_heads=8, head_dim=128, d_ff=2048, vocab=512,
                 dtype="bfloat16", layer_pattern=("attn",),
                 ffn_pattern=("dense",), precision="2xT", kv_bits=8)


@pytest.fixture
def gpu(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    _build.build_all()              # once, before the ranks load them
    return torch.device("cuda", 0)


def _rank(mesh, cfg, params):
    from repro_torch.kernels import engine
    out = {}
    for kind in ("dense", "paged"):
        engine.reset_launch_counts()
        out[kind] = ranks.serve(cfg, params, mesh, kind, n_reqs=3,
                                n_slots=2, s_max=16)
        out[kind + "_launches"] = engine.launch_counts()
    return out


def test_tp_golden_on_a_1x2_mesh_matches_one_card(gpu):
    cfg = ModelConfig(**TP_GOLDEN)
    params = to_serving(build_model(cfg).init(
        torch.Generator(device=gpu).manual_seed(1), gpu), cfg, tp=2)
    one = {kind: ranks.serve(cfg, params, None, kind, n_reqs=3, n_slots=2,
                             s_max=16) for kind in ("dense", "paged")}
    got = spawn(_rank, parse_mesh("1,2"), cfg, params, device="cuda")
    n_layers = cfg.n_layers
    for res in got:
        for kind in ("dense", "paged"):
            streams, counts, calls = res[kind]
            assert streams == one[kind][0], kind
            n = calls["decode"] + calls["chunks"]
            assert counts["all_reduce_max"] == 2 * n_layers * n
            assert counts["all_reduce_sum"] == (2 * n_layers + 1) * n
            launches = res[kind + "_launches"]
            assert launches["ternary_matmul"] == 7 * n_layers * n
            assert launches["act_quant_signed_grouped"] == 7 * n_layers * n
            attn = "decode_attention" if kind == "dense" else \
                "paged_attention"
            assert launches[attn] == n_layers * calls["decode"]


def test_four_cards_over_nccl(gpu):
    """tp-golden 2xT on a 2,2 mesh and the split-heads GQA model on 1,4,
    one rank a card over NCCL: streams equal to one card's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch.parallel.comm import choose_backend
    assert choose_backend("cuda", 4) == "nccl"
    for kw, tp, spec in ((TP_GOLDEN, 2, "2,2"),
                         (dict(TP_GOLDEN, n_kv_heads=2), 4, "1,4")):
        cfg = ModelConfig(**kw)
        params = to_serving(build_model(cfg).init(
            torch.Generator(device=gpu).manual_seed(1), gpu), cfg, tp=tp)
        one = {kind: ranks.serve(cfg, params, None, kind, n_reqs=3,
                                 n_slots=2, s_max=16)
               for kind in ("dense", "paged")}
        for res in spawn(_rank, parse_mesh(spec), cfg, params,
                         device="cuda"):
            for kind in ("dense", "paged"):
                assert res[kind][0] == one[kind][0], (spec, kind)
                assert res[kind][1]["all_reduce_max"] > 0

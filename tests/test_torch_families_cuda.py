"""The MoE and Mamba layers on the card against the same calls on the
host, at ``reduce_for_smoke`` shapes from the port's own seeded params.
The expert product, the routing and the selective scan are plain PyTorch
on every device (as in the reference), so this holds the port's own
numerics across devices: the same routing (no token's expert set
differs), two card runs equal bit for bit (the MoE combine takes no
atomics), f32 outputs within 1e-5 of max|out|.  Every test is marked
``cuda`` and skips without a card.  Imports no JAX, so it runs on the
card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import to_serving  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _layer(arch, precision, name):
    """Period 0, layer ``name`` params of the reduced ``arch`` in serving
    form on the host (seed 0), and its config."""
    cfg = reduce_for_smoke(get_config(arch, precision=precision))
    model = build_model(cfg)
    params = to_serving(model.init(torch.Generator().manual_seed(0), "cpu"),
                        cfg)

    def period0(t):
        return {k: period0(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return cfg, period0(params["blocks"]["layer_0"][name])


def _to(tree, device):
    return {k: _to(v, device) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.to(device)


def _close(got, want, rel=1e-5):
    err = (got.cpu() - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


def _expert_sets(p, x, cfg):
    xin = L.rmsnorm(p["norm"], x, cfg.norm_eps).reshape(-1, x.shape[-1])
    probs = torch.softmax(xin.to(torch.float32) @ p["w_router"], -1)
    return torch.topk(probs, cfg.top_k, -1).indices.sort(-1).values.cpu()


@pytest.mark.parametrize("precision", ["2xT", "4x4", "1x1"])
def test_qmatmul_experts_card_equals_host(gpu, precision):
    """Integer-valued rows: every f32 sum exact, so the card's expert
    product equals the host's bit for bit."""
    cfg, p = _layer("granite-moe-1b-a400m", precision, "moe")
    x = torch.randint(-3, 4, (cfg.n_experts, 5, cfg.d_model),
                      generator=torch.Generator().manual_seed(1)).float()
    pcfg = signed(get_precision(precision))
    host = engine.qmatmul_experts(x, p["w_gate"], pcfg)
    card = engine.qmatmul_experts(x.to(gpu), _to(p["w_gate"], gpu), pcfg)
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), host)


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
@pytest.mark.parametrize("b,s", [(3, 1), (2, 12)])
def test_moe_apply_card_matches_host(gpu, precision, b, s):
    cfg, p = _layer("granite-moe-1b-a400m", precision, "moe")
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(b + s))
    pd, xd = _to(p, gpu), x.to(gpu)
    host, aux_h = L.moe_apply(p, x, cfg)
    one, aux_1 = L.moe_apply(pd, xd, cfg)
    two, aux_2 = L.moe_apply(pd, xd, cfg)
    torch.cuda.synchronize()
    assert torch.equal(one, two) and torch.equal(aux_1, aux_2)
    assert torch.equal(_expert_sets(pd, xd, cfg), _expert_sets(p, x, cfg))
    _close(one, host)
    assert abs(aux_1.item() - aux_h.item()) <= 1e-6


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
@pytest.mark.parametrize("mode,s", [("prefill", 12), ("prefill", 32),
                                    ("chunk", 8), ("decode", 1)])
def test_mamba_apply_card_matches_host(gpu, precision, mode, s):
    cfg, p = _layer("falcon-mamba-7b", precision, "mamba")
    g = torch.Generator().manual_seed(s)
    x = torch.randn((2, s, cfg.d_model), generator=g)
    state = None if mode == "prefill" else {
        "conv": torch.randn((2, cfg.ssm_conv - 1, cfg.d_inner), generator=g),
        "ssm": torch.randn((2, cfg.d_inner, cfg.ssm_state), generator=g)}
    host, st_h = L.mamba_apply(p, x, cfg, state=state)
    card, st_c = L.mamba_apply(_to(p, gpu), x.to(gpu), cfg,
                               state=None if state is None else
                               _to(state, gpu))
    torch.cuda.synchronize()
    _close(card, host)
    _close(st_c["ssm"], st_h["ssm"])
    _close(st_c["conv"], st_h["conv"])

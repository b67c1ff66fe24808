"""Port parity: the Mamba-1 mixer of ``repro_torch`` against ``repro`` —
``_causal_conv`` in its three branches, ``_ssm_scan_chunked`` (including
the lengths the reference refuses), ``mamba_apply`` (prefill, chunk
continuation, one-step decode, and the one-position prompt that returns no
state) and ``make_ssm_state``, at the reduced falcon-mamba-7b's shapes
(d 128, d_inner 256, dt_rank 8, state 16, conv 4, scan chunk 16), from the
reference's own params through ``interop``.

Tolerances (f32): the convolution within 1e-6 of max|out| (the same
products and adds; XLA may contract them into fused multiply-adds); the
scan within 1e-5 of max|y| and of max|h| (the port's doubling scan
associates the products of decays differently from ``associative_scan``);
``mamba_apply``'s output within 1e-5 of max|out| and its state within
1e-5 of max|h| (the above, through three projections).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import reduce_for_smoke  # noqa: E402

ARCH = "falcon-mamba-7b"
B, DI, N = 2, 256, 16


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


_MODELS = {}


def _layer(precision):
    """(jax cfg, port cfg, reference mamba params of layer 0 period 0 in
    serving form (numpy), the same through interop)."""
    if precision not in _MODELS:
        jcfg = jreduce(jget_config(ARCH, precision=precision))
        tcfg = reduce_for_smoke(get_config(ARCH, precision=precision))
        jm = jbuild(jcfg)
        jsv = reference_jit(lambda key: jto_serving(jm.init(key), jcfg))(
            jax.random.PRNGKey(0))
        lp = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                    jsv["blocks"]["layer_0"]["mamba"])
        _MODELS[precision] = (jcfg, tcfg, lp, params_from_numpy(lp, "cpu"))
    return _MODELS[precision]


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("branch,s", [("whole", 9), ("chunk", 6),
                                      ("decode", 1)])
def test_causal_conv_matches_reference(branch, s):
    rng = _rng(s)
    x = rng.standard_normal((B, s, DI)).astype(np.float32)
    w = rng.standard_normal((4, DI)).astype(np.float32) * 0.2
    b = rng.standard_normal(DI).astype(np.float32)
    state = None if branch == "whole" else \
        rng.standard_normal((B, 3, DI)).astype(np.float32)
    oj, sj = JL._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if state is None else jnp.asarray(state))
    ot, st = TL._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if state is None else torch.from_numpy(state))
    _close(ot, oj, 1e-6, "out")
    assert torch.equal(st, torch.from_numpy(np.asarray(sj)))


def _scan_inputs(s, seed=0):
    rng = _rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, DI)) - 2)).astype(
        np.float32)                                   # softplus: dt > 0
    xs = rng.standard_normal((B, s, DI)).astype(np.float32)
    bm = rng.standard_normal((B, s, N)).astype(np.float32)
    cm = rng.standard_normal((B, s, N)).astype(np.float32)
    a = -np.tile(np.arange(1, N + 1, dtype=np.float32), (DI, 1))
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32)
    return dt, xs, bm, cm, a, h0


# chunk 16: one piece below 2 * chunk (5, 16, 20, 31), whole pieces at and
# past it (32, 48)
@pytest.mark.parametrize("s", [5, 16, 20, 31, 32, 48])
def test_ssm_scan_matches_reference(s):
    args = _scan_inputs(s, seed=s)
    yj, hj = JL._ssm_scan_chunked(*map(jnp.asarray, args), chunk=16)
    yt, ht = TL._ssm_scan_chunked(*map(torch.from_numpy, args), chunk=16)
    _close(yt, yj, 1e-5, "y")
    _close(ht, hj, 1e-5, "h_last")


@pytest.mark.parametrize("s", [33, 47, 50])
def test_ssm_scan_refuses_what_the_reference_refuses(s):
    """S >= 2 * chunk that S // (S // chunk) does not divide: the
    reference's reshape raises, and so does the port, saying why."""
    args = _scan_inputs(s)
    with pytest.raises((TypeError, ValueError)):
        JL._ssm_scan_chunked(*map(jnp.asarray, args), chunk=16)
    with pytest.raises(ValueError, match="does not split"):
        TL._ssm_scan_chunked(*map(torch.from_numpy, args), chunk=16)


def _state(tcfg, seed):
    rng = _rng(seed)
    return {"conv": rng.standard_normal((B, tcfg.ssm_conv - 1, tcfg.d_inner)
                                        ).astype(np.float32),
            "ssm": rng.standard_normal((B, tcfg.d_inner, tcfg.ssm_state)
                                       ).astype(np.float32)}


@pytest.mark.parametrize("precision", ["fp32", "2xT"])
@pytest.mark.parametrize("mode,s", [("prefill", 12), ("prefill", 40),
                                    ("chunk", 8), ("decode", 1)])
def test_mamba_apply_matches_reference(precision, mode, s):
    jcfg, tcfg, jp, tp = _layer(precision)
    x = _rng(s).standard_normal((B, s, tcfg.d_model)).astype(np.float32)
    state = None if mode == "prefill" else _state(tcfg, s + 1)
    oj, sj = JL.mamba_apply(
        jp, jnp.asarray(x), jcfg,
        state=None if state is None else jax.tree_util.tree_map(
            jnp.asarray, state))
    ot, st = TL.mamba_apply(
        tp, torch.from_numpy(x), tcfg,
        state=None if state is None else params_from_numpy(state, "cpu"))
    _close(ot, oj, 1e-5, "out")
    _close(st["ssm"], sj["ssm"], 1e-5, "ssm")
    _close(st["conv"], sj["conv"], 1e-5, "conv")
    assert st["conv"].dtype == torch.float32 == st["ssm"].dtype


def test_one_position_prompt_returns_no_state():
    """The reference's rule: a forward of one position with no state
    returns none (``mamba_apply``'s ``state is not None or S > 1``)."""
    jcfg, tcfg, jp, tp = _layer("fp32")
    x = _rng(4).standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    oj, sj = JL.mamba_apply(jp, jnp.asarray(x), jcfg)
    ot, st = TL.mamba_apply(tp, torch.from_numpy(x), tcfg)
    assert sj is None and st is None
    _close(ot, oj, 1e-5)


def test_make_ssm_state_matches_reference():
    jcfg, tcfg, _, _ = _layer("fp32")
    want = JL.make_ssm_state(jcfg, 3, stacked=2)
    got = TL.make_ssm_state(tcfg, 3, "cpu", stacked=2)
    for name in ("conv", "ssm"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not bool(got[name].any())


@pytest.mark.parametrize("mode,s", [("prefill", 12), ("decode", 1)])
def test_dispatch_trace_names_the_plain_scan(mode, s):
    """The scan is plain on every device by the reference's design, and
    the dispatch trace says so: one ``ssm_scan`` event (``impl_backend``
    "torch", chunked for a sequence, a step for one-step decode) among
    the layer's four quantized projections."""
    from repro_torch.kernels import engine
    _, tcfg, _, tp = _layer("2xT")
    x = torch.from_numpy(_rng(s).standard_normal(
        (B, s, tcfg.d_model)).astype(np.float32))
    state = None if mode == "prefill" else params_from_numpy(
        _state(tcfg, 3), "cpu")
    with engine.dispatch_trace() as ev:
        TL.mamba_apply(tp, x, tcfg, state=state)
    assert [e.op for e in ev].count("qmatmul") == 4
    (scan,) = [e for e in ev if e.op == "ssm_scan"]
    assert (scan.kind, scan.impl_backend, scan.requested_backend,
            scan.m_rows) == ("chunked" if mode == "prefill" else "step",
                             "torch", "torch", B * s)

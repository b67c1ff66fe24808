"""Port parity: ``Model.forward`` and ``Model.loss`` of the reduced smollm
(``repro_torch.models``) against ``repro.models`` — logits (B, S, V), the
auxiliary loss and the next-token NLL — from the reference's own serving
params through ``repro_torch.interop``, at fp32, 8x8 and 2xT in float32.

Tolerances: logits max |diff| <= 1e-4 * max|logit| and the loss within
1e-5 relative.  Both packages run the same elementwise ops in the same
order and integer accumulators are exact; float matmul, einsum and softmax
sums differ in order (a few ulps).  On the CPU the port's full-sequence
attention is the reference's choice: ``_attend`` up to 1024 positions,
the blockwise ``_attend_flash`` at S = 2048.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5


def _models(precision):
    jcfg = jreduce(jget_config("smollm-135m", precision=precision))
    tcfg = reduce_for_smoke(get_config("smollm-135m", precision=precision))
    assert jcfg.dtype == tcfg.dtype == "float32"
    jm = jbuild(jcfg)
    jsv = jto_serving(jm.init(jax.random.PRNGKey(0)), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jsv), "cpu")
    return jm, jsv, build_model(tcfg), tp


def _batch(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _check(jm, jsv, tm, tp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    lj, aux_j = jm.forward(jsv, jb)
    with engine.dispatch_trace() as ev:
        lt, aux_t = tm.forward(tp, tb)
    lj = np.asarray(lj)
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=LOGIT_TOL * np.abs(lj).max())
    assert float(aux_t) == float(aux_j) == 0.0
    want = float(jm.loss(jsv, jb))
    got = float(tm.loss(tp, tb))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    return ev


@pytest.mark.parametrize("precision", ["fp32", "8x8", "2xT"])
def test_forward_and_loss_match_reference(precision):
    """B=2, S=24: full-sequence attention through ``_attend``; at 8x8 and
    2xT every projection quantizes its rows per row and dispatches once."""
    jm, jsv, tm, tp = _models(precision)
    ev = _check(jm, jsv, tm, tp, _batch(2, 24, tm.cfg.vocab, seed=1))
    ops = [e.op for e in ev]
    assert ops.count("flash_attention") == 0        # the host path
    if precision != "fp32":
        assert ops.count("qmatmul") == 7 * tm.cfg.n_layers


def test_forward_long_sequence_blockwise_attention():
    """S = 2048 (> 1024, whole chunks): both packages attend through their
    blockwise ``_attend_flash``; fp32, B=1."""
    jm, jsv, tm, tp = _models("fp32")
    _check(jm, jsv, tm, tp, _batch(1, 2048, tm.cfg.vocab, seed=2))


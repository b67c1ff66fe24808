"""Port parity for the last decoder-only LM families
(``tests/torch_lm_families_common.py``): ``Model.forward`` and
``Model.loss``, and the chunked prefill, against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_lm_families_common import (  # noqa: E402,F401
    ARCHS, S_MAX, _batch, _close, _inputs, _pair, _t, _tuning_cache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision", ["fp32", "2xT"])
def test_forward_logits_and_loss(arch, precision):
    """``Model.forward`` (S 20: past gemma2-w8's window) and ``Model.loss``
    against the reference's; the MoE aux within 1e-5."""
    jm, jsv, tm, tp = _pair(arch, precision, 0)
    x = _inputs(tm.cfg, 2, 20, seed=5)
    lj, aj = jm.forward(jsv, _batch(tm.cfg, jnp.asarray(x)))
    lt, at = tm.forward(tp, _batch(tm.cfg, _t(x)))
    _close(lt, lj)
    assert abs(float(at) - float(aj)) <= 1e-5
    labels = np.random.default_rng(6).integers(0, tm.cfg.vocab, (2, 20))
    jb = dict(_batch(tm.cfg, jnp.asarray(x)), labels=jnp.asarray(labels))
    tb = dict(_batch(tm.cfg, _t(x)), labels=_t(labels))
    assert abs(float(tm.loss(tp, tb)) - float(jm.loss(jsv, jb))) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 0)])
def test_prefill_chunk_logits(arch, precision, kv_bits):
    """Two chunks of 8 against a batch-1 cache (embeds chunks for
    internvl2), each held to the reference's chunk path."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    x = _inputs(tm.cfg, 1, 16, seed=1)
    cj = jtfm.make_cache(jm.cfg, 1, S_MAX)
    ct = tfm.make_cache(tm.cfg, 1, S_MAX, "cpu")
    for start in (0, 8):
        chunk = x[:, start:start + 8]
        lj, cj = jm.prefill_chunk(jsv, jnp.asarray(chunk), cj, start)
        lt, ct = tm.prefill_chunk(tp, _t(chunk), ct, start)
        _close(lt, lj)

"""Port parity for the last decoder-only LM families
(``tests/torch_lm_families_common.py``): the paged entry points of the
pageable stacks against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_lm_families_common import (  # noqa: E402,F401
    ARCHS, PAGEABLE, S_MAX, _close, _inputs, _pair, _t, _tuning_cache)


def test_pageable_stacks():
    """The embeds frontend has no paged entry points, in both packages."""
    for arch in ARCHS:
        jm, _, tm, _ = _pair(arch, "2xT", 0)
        for name in ("prefill_chunk_paged", "decode_step_paged",
                     "decode_window_paged"):
            assert (getattr(tm, name) is None) == (getattr(jm, name) is None)
            assert (getattr(tm, name) is None) == (arch not in PAGEABLE)


@pytest.mark.parametrize("arch", PAGEABLE)
@pytest.mark.parametrize("precision,kv_bits", [("2xT", 8), ("fp32", 16)])
def test_paged_steps(arch, precision, kv_bits):
    """Two paged prefill chunks, then one decode step over three slots
    (fused and unfused; gemma2's softcap takes the gathered path): logits
    within 1e-4 of the reference's."""
    jm, jsv, tm, tp = _pair(arch, precision, 0)
    bs, nb = 8, S_MAX // 8
    jpool = jtfm.make_pool(jm.cfg, 10, bs, kv_bits)
    tpool = tfm.make_pool(tm.cfg, 10, bs, kv_bits, "cpu")
    toks = _inputs(tm.cfg, 1, 16, seed=8)
    row = np.array([[4, 7, 0, 0]], np.int32)
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        lj, jpool = jm.prefill_chunk_paged(jsv, jnp.asarray(chunk), jpool,
                                           jnp.asarray(row), start, kv_bits)
        lt, tpool = tm.prefill_chunk_paged(tp, _t(chunk), tpool,
                                           torch.from_numpy(row), start,
                                           kv_bits)
        _close(lt, lj)
    pt = np.array([[4, 7, 5, 0], [4, 2, 0, 0], [4, 0, 0, 0]], np.int32)
    assert pt.shape[1] == nb
    pos = np.array([16, 9, 3], np.int32)
    step = np.repeat(toks[:, -1:], 3, axis=0)
    for fused in (True, False):
        jp = jax.tree_util.tree_map(jnp.copy, jpool)
        tq = {k: {n: t.clone() for n, t in v.items()}
              for k, v in tpool.items()}
        lj, _ = jm.decode_step_paged(jsv, jnp.asarray(step), jp,
                                     jnp.asarray(pt), jnp.asarray(pos),
                                     kv_bits, fused=fused)
        lt, _ = tm.decode_step_paged(tp, _t(step), tq, torch.from_numpy(pt),
                                     torch.from_numpy(pos), kv_bits,
                                     fused=fused)
        _close(lt, lj)

"""Port parity for the MoE, Mamba and hybrid stacks
(``tests/torch_hybrid_common.py``): greedy streams through prefill and
decode_step against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from torch_hybrid_common import (  # noqa: E402,F401
    GRID, GRID_IDS, S_MAX, _pair, _t, _tokens, _tuning_cache)


@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_greedy_streams_identical(arch, precision, kv_bits):
    """Prefill then 7 decode steps, greedy, B=2: identical tokens.  (Each
    step's logits are not bounded here: through an int8 KV cache a value
    on a code's rounding boundary may round either way under f32 summation
    order, and one such code moves later logits by about 1e-3.  The single
    steps above are bounded.)"""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    toks = _tokens(2, 9, tm.cfg.vocab, seed=3)
    lj, cj = jm.prefill(jsv, {"tokens": jnp.asarray(toks)}, S_MAX)
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, S_MAX)
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    out_j, out_t = [np.asarray(tj)], [tt.numpy()]
    for i in range(7):
        lj, cj = jm.decode_step(jsv, tj[:, None].astype(jnp.int32), cj, 9 + i)
        lt, ct = tm.decode_step(tp, tt[:, None], ct, 9 + i)
        tj, tt = jnp.argmax(lj[:, 0], -1), lt[:, 0].argmax(-1)
        out_j.append(np.asarray(tj))
        out_t.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))

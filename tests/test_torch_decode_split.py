"""B5 on the CPU: the dense decode attention (``csrc/decode_attention.cu``)
runs the paged flash-decode core over the dense cache viewed as a pool of
NB = B blocks of bs = S positions with the identity page table (sequence
b's one block is block b).  Its work split and merge order are replayed in
numpy with the paged core's replay (``test_torch_paged_split``) at the
plan ``pa_plan`` gives: one block of spans of 16 while S <= 128, an 8-block
cluster above that.

Held against the JAX Pallas ``decode_attention`` in interpret mode, against
``repro.kernels.decode_attention.decode_attention_ref`` and against the
port's ``decode_attention_ref``.  The core multiplies K's scale onto the
code dot product, folds V's scale into the probability and divides by
sqrt(Dh), where the plain versions dequantize each code and multiply by
Dh^-0.5: rounding only.  Tolerance: atol 1e-5 + rtol 1e-5 in f32.  Cases: S in {16, 80, 300} (300 takes the cluster plan),
Dh in {64, 32}, G in {3, 4}; pos 0, pos S - 1 and ragged positions.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

tattn = importlib.import_module("repro_torch.kernels.decode_attention")
from test_torch_paged_split import pa_plan, replay_paged_attention  # noqa: E402

# the module (``repro.kernels`` re-exports its function under the same name)
jattn = importlib.import_module("repro.kernels.decode_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = np.float32
B, KV = 4, 2


def _inputs(s: int, dh: int, g: int, seed: int):
    """(q, k codes, k scales, v codes, v scales, pos) of one dense decode
    step: pos S - 1, 0 and two ragged positions."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, g, dh)).astype(F32)
    codes = lambda: rng.integers(-127, 128, (B, s, KV, dh)).astype(np.int8)
    scale = lambda: rng.uniform(1e-3, 1e-1, (B, s, KV, 1)).astype(F32)
    pos = np.array([s - 1, 0, s // 2 + 1, (7 * s) // 9], np.int32)
    return q, codes(), scale(), codes(), scale(), pos


def replay_decode_attention(q, kc, ks, vc, vs, pos):
    """B5 as the kernel runs it: the dense cache as a pool (NB = B, bs = S)
    read through the identity table, at the launch plan of B2 and B5."""
    b, s = kc.shape[:2]
    cluster, span = pa_plan(b, q.shape[1], s, s)
    identity = np.arange(b, dtype=np.int32)[:, None]
    return replay_paged_attention(q, kc, ks, vc, vs, identity, pos, 8, cluster,
                                  span), cluster


CASES = [(s, dh, g) for s in (16, 80, 300) for dh in (64, 32) for g in (3, 4)]


@pytest.mark.parametrize("s,dh,g", CASES,
                         ids=[f"s{s}-dh{dh}-g{g}" for s, dh, g in CASES])
def test_decode_split_matches_references(s, dh, g):
    args = _inputs(s, dh, g, seed=s + dh + g)
    got, cluster = replay_decode_attention(*args)
    assert cluster == (8 if s > 128 else 1)
    want_ref = tattn.decode_attention_ref(*map(torch.from_numpy, args)).numpy()
    want_pallas = np.asarray(jattn.decode_attention(*map(jnp.asarray, args),
                                                    interpret=True))
    want_oracle = np.asarray(jattn.decode_attention_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)
    np.testing.assert_allclose(want_ref, want_pallas, **TOL)


def test_host_path_is_the_plain_version():
    """On the CPU the wrapper is the plain version and launches nothing."""
    from repro_torch.kernels import _build
    args = tuple(map(torch.from_numpy, _inputs(80, 64, 3, seed=0)))
    before = _build.LAUNCHES["decode_attention"]
    out = tattn.decode_attention(*args)
    assert _build.LAUNCHES["decode_attention"] == before
    assert torch.equal(out, tattn.decode_attention_ref(*args))

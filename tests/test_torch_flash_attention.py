"""Port parity: full-sequence flash attention — the port's plain version
(``kernels/ref.flash_attention_ref``, the CPU path of
``kernels/flash_attention.py`` and of ``engine.flash_attention``) against
``repro.kernels.flash_attention`` (Pallas in interpret mode) and its
``flash_attention_ref``; and the port's blockwise ``layers._attend_flash``
against the reference's, on the same numpy inputs.

Tolerance: max |diff| <= 1e-5 * max|out| (f32 softmax and sums in another
order: one-shot against online softmax, einsum against blockwise dots).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import reduce_for_smoke  # noqa: E402

# the module (``repro.kernels`` re-exports its function under the same name)
jflash = importlib.import_module("repro.kernels.flash_attention")
RTOL = 1e-5
MASKS = [(True, 0, 0.0), (True, 24, 0.0), (True, 0, 5.0), (True, 24, 5.0),
         (False, 0, 0.0)]
MASK_IDS = ["causal", "window", "softcap", "window-softcap", "full"]


def _qkv(b, s, kv, g, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, kv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    return q, k, v


def _close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("causal,window,softcap", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("g", [1, 3])
def test_plain_version_matches_pallas_and_ref(g, causal, window, softcap):
    """B=1, S=64, KV=2, Dh=32, the Pallas kernel at 16 x 16 blocks."""
    q, k, v = _qkv(1, 64, 2, g, 32, seed=g)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=16, bk=16,
        interpret=True, **kw))
    _close(np.asarray(jflash.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)), want)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(ref.flash_attention_ref(tq, tk, tv, **kw).numpy(), want)
    _close(tflash.flash_attention(tq, tk, tv, **kw).numpy(), want)
    with engine.dispatch_trace() as ev:
        got = engine.flash_attention(tq, tk, tv, **kw)
    _close(got.numpy(), want)
    assert [(e.op, e.impl_backend) for e in ev] == [("flash_attention",
                                                      "torch")]


def test_bf16_inputs():
    """bf16 q/k/v, read as f32 on both sides: f32 output within the
    tolerance of the Pallas kernel's (G = 3, causal + window)."""
    q, k, v = _qkv(1, 32, 2, 3, 64, seed=7)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash.flash_attention(qb, kb, vb, window=12, bq=16,
                                             bk=16, interpret=True))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, window=12)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("s", [37, 50])
def test_ragged_length_matches_reference_oracle(s):
    """A prompt length no block divides (the Pallas kernel asserts
    divisibility, so the oracle alone): causal with softcap, and window."""
    q, k, v = _qkv(2, s, 3, 3, 32, seed=s)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for kw in (dict(softcap=5.0), dict(window=9)):
        want = np.asarray(jflash.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        _close(ref.flash_attention_ref(tq, tk, tv, **kw).numpy(), want)


@pytest.mark.parametrize("local,softcap,probs_bf16", [
    (False, 0.0, False), (True, 0.0, False), (False, 5.0, False),
    (True, 0.0, True)], ids=["global", "local", "softcap", "probs-bf16"])
def test_attend_flash_matches_reference(local, softcap, probs_bf16):
    """The blockwise plain attention of ``layers``: S = 64 in chunks of
    16, GQA 6 heads over 2 KV heads, window 24, against the reference's
    ``_attend_flash`` (and, with f32 probabilities, the one-shot
    ``_attend``); ``attn_probs_bf16`` takes P.V in bf16 on both sides."""
    b, s, h, kv, dh = 2, 64, 6, 2, 32
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    over = dict(window=24, attn_softcap=softcap, attn_probs_bf16=probs_bf16)
    jcfg = dataclasses.replace(jreduce(jget_config("smollm-135m")), **over)
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("smollm-135m")),
                               **over)
    want = np.asarray(jlayers._attend_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), jcfg, causal=True, local=local, kv_chunk=16))
    tq, tk, tv, tp = (torch.from_numpy(np.array(a)) for a in (q, k, v, pos))
    got = layers._attend_flash(tq, tk, tv, tp, tp, tcfg, causal=True,
                               local=local, kv_chunk=16)
    _close(got.numpy(), want)
    if probs_bf16:
        return
    mask = tp[:, None, :] <= tp[:, :, None]
    if local:
        mask &= tp[:, None, :] > tp[:, :, None] - tcfg.window
    _close(layers._attend(tq, tk, tv, mask[:, None], tcfg).numpy(), want)


def test_host_path_is_the_plain_version():
    """On the CPU the wrapper is the plain version (no launch, gradients
    allowed); ``backend="cuda"`` with host tensors is refused."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 1, 2, 32, seed=3))
    q.requires_grad_(True)
    engine.reset_launch_counts()
    out = tflash.flash_attention(q, k, v)
    out.sum().backward()
    assert q.grad is not None
    assert engine.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.flash_attention(q, k, v, backend="cuda")

"""Port parity: full-sequence flash attention — the port's plain version
(``kernels/ref.flash_attention_ref``, the CPU path of
``kernels/flash_attention.py`` and of ``engine.flash_attention``) against
``repro.kernels.flash_attention`` (Pallas in interpret mode) and its
``flash_attention_ref``; and the port's blockwise ``layers._attend_flash``
against the reference's, on the same numpy inputs.

Tolerance: max |diff| <= 1e-5 * max|out| (f32 softmax and sums in another
order: one-shot against online softmax, einsum against blockwise dots).

The card's bf16 kernel computes P.V on bf16 tensor cores with P split into
two bf16 terms; a plain emulation of that arithmetic, held here against the
plain version, pins why the split is there (a single bf16 P misses the
bound).  Its f32 kernel runs Q.K^T and P.V on TF32 tensor cores in three
products (every operand split into two TF32 terms, hi.hi + hi.lo + lo.hi);
an emulation of that arithmetic is held to the same bound, and one product
(hi.hi) shown to miss it.
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


# the first five of test_torch_cuda.FLASH_CASES (B, S, KV, G, Dh, causal,
# window, softcap), and the forward's G = 3 at S = 1024
SPLIT_CASES = [(1, 64, 3, 3, 64, True, 0, 0.0), (2, 100, 3, 3, 64, True, 0, 0.0),
               (1, 300, 2, 2, 128, True, 64, 50.0), (2, 77, 1, 4, 96, True, 16, 5.0),
               (1, 45, 2, 1, 32, False, 0, 0.0), (1, 1024, 3, 3, 64, True, 0, 0.0)]


def _tensor_core_emulation(q, k, v, *, causal, window, softcap, split,
                           bk=64):
    """The arithmetic of the bf16 tensor-core kernel of
    ``csrc/flash_attention.cu``: bf16 q, k, v; Q.K^T summed in f32 from
    exact bf16 products; online softmax over tiles of ``bk`` keys in f32;
    P.V from bf16 P, as ``p_hi + p_lo`` (two bf16 terms) when ``split``,
    into an f32 acc (bf16 x bf16 products are exact in f32)."""
    dh, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    qf, kf, vf = (t.to(torch.bfloat16).to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * dh ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (dh,))
    for k0 in range(0, sk, bk):
        st, mt, vt = s[..., k0:k0 + bk], mask[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        m_new = torch.maximum(m, torch.where(mt, st, -1e30).amax(-1))
        p = torch.where(mt, torch.exp(st - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        p_hi = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p_hi, vt)
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).to(torch.float32)
            acc = acc + torch.einsum("bkgqs,bskd->bkgqd", p_lo, vt)
        m = m_new
    return (acc / torch.clamp_min(l[..., None], 1e-30)).permute(0, 3, 1, 2, 4)


def _bf16_qkv(case, seed):
    b, s, kv, g, dh = case[:5]
    return (torch.from_numpy(a).to(torch.bfloat16)
            for a in _qkv(b, s, kv, g, dh, seed))


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_split_p_tensor_core_arithmetic_holds_the_bound(case):
    """The kernel's arithmetic with P as two bf16 terms is within 1e-5 *
    max|out| of the f32 plain version on the same bf16 inputs."""
    causal, window, softcap = case[5:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _bf16_qkv(case, seed=case[1])
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = _tensor_core_emulation(q, k, v, split=True, **kw)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("s", [64, 1024])
def test_single_bf16_p_misses_the_bound(s):
    """Why P is split: with one bf16 term the same arithmetic misses the
    bound by far (the rounding of P, 2^-9 relative, survives the sum),
    while two terms hold it."""
    case = (1, s, 3, 3, 64, True, 0, 0.0)
    kw = dict(causal=True, window=0, softcap=0.0)
    q, k, v = _bf16_qkv(case, seed=s)
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = RTOL * want.abs().max()
    one = (_tensor_core_emulation(q, k, v, split=False, **kw) - want).abs().max()
    two = (_tensor_core_emulation(q, k, v, split=True, **kw) - want).abs().max()
    assert one > 10 * tol
    assert two <= tol


def _tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round half away from
    zero (add half of the dropped 13 bits' unit to the magnitude, then
    clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_dot(eq, a, b, terms):
    """sum a.b through the TF32 tensor cores: products of TF32 terms (exact
    in f32) summed in f32; three terms a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
    or one, a_hi.b_hi."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


def _tf32_split_emulation(q, k, v, *, causal, window, softcap, terms=3,
                          bk=32):
    """The arithmetic of the f32 kernel of ``csrc/flash_attention.cu``:
    S = Q.K^T and P.V each as ``terms`` TF32 products summed in f32, the
    online softmax over tiles of ``bk`` keys in f32, P split after it."""
    dh, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    s = _tf32_dot("bqkgd,bskd->bkgqs", q, k, terms) * dh ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (dh,))
    for k0 in range(0, sk, bk):
        st, mt, vt = s[..., k0:k0 + bk], mask[:, k0:k0 + bk], v[:, k0:k0 + bk]
        m_new = torch.maximum(m, torch.where(mt, st, -1e30).amax(-1))
        p = torch.where(mt, torch.exp(st - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _tf32_dot("bkgqs,bskd->bkgqd", p, vt,
                                                terms)
        m = m_new
    return (acc / torch.clamp_min(l[..., None], 1e-30)).permute(0, 3, 1, 2, 4)


def test_tf32_rounding_is_round_half_away():
    """The emulated ``cvt.rna``: ties (half of the 13 dropped bits' unit)
    round away from zero in both signs; below a tie, toward the kept bits."""
    one_ulp = 2.0 ** -10                         # tf32 spacing at 1.0
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + one_ulp / 2 - 2.0 ** -23, 3.0, 0.0])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tf32_split_arithmetic_holds_the_bound(case):
    """The f32 kernel's arithmetic (three TF32 products for Q.K^T and P.V)
    is within 1e-5 * max|out| of the f32 plain version on f32 inputs."""
    b, s, kv, g, dh, causal, window, softcap = case
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, kv, g, dh, seed=s))
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = _tf32_split_emulation(q, k, v, **kw)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("s", [64, 1024])
def test_single_tf32_misses_the_bound(s):
    """Why three products: with one (hi.hi) the same arithmetic misses the
    bound by far (TF32 keeps 10 mantissa bits: 2^-11 relative a rounding),
    while three hold it."""
    kw = dict(causal=True, window=0, softcap=0.0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, s, 3, 3, 64, seed=s))
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = RTOL * want.abs().max()
    one = (_tf32_split_emulation(q, k, v, terms=1, **kw) - want).abs().max()
    three = (_tf32_split_emulation(q, k, v, terms=3, **kw) - want).abs().max()
    assert one > 10 * tol
    assert three <= tol


@pytest.mark.parametrize("sq", [32, 1])
def test_kernel_arithmetic_without_mask_holds_the_bound(sq):
    """whisper-base's cross-attention (B 4, KV 8, G 1, Dh 64) over 1500
    encoder frames, Sq 32 (a prefill) and 1 (a decode step), no mask: both
    kernels' arithmetic (each tile's P.V summed from zero and added to the
    running acc in f32) within 1e-5 * max|out| of the plain version.  Long
    unmasked rows average ~1500 values, so max|out| is small and the bound
    tight."""
    gen = torch.Generator().manual_seed(sq)
    q = torch.randn((4, sq, 8, 1, 64), generator=gen)
    k, v = (torch.randn((4, 1500, 8, 64), generator=gen) for _ in range(2))
    kw = dict(causal=False, window=0, softcap=0.0)
    want = ref.flash_attention_ref(q, k, v, **kw)
    _close(_tf32_split_emulation(q, k, v, **kw).numpy(), want.numpy())
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want = ref.flash_attention_ref(qb, kb, vb, **kw)
    _close(_tensor_core_emulation(qb, kb, vb, split=True, **kw).numpy(),
           want.numpy())

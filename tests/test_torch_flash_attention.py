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

``probs_bf16`` (the reference's ``attn_probs_bf16``, which its
``_attend_flash`` applies past ATTN_KV_CHUNK = 1024 positions) rounds P and
V to bf16 for P.V.  The kernels keep their own key tiles for the running
max (64 keys bf16, 32 f32) where the reference's chunks are 1024 keys, so
the roundings differ and the two agree to bf16's unit roundoff u = 2^-8,
not bit for bit.  The bound: a term that passes r roundings of u is within
(r u + O(u^2)) p |v| of the exact one, and the terms' weights p / l sum to
1, so each side is within r u max|v| of the exact f32 attention.  The
kernel rounds P (and V from f32 inputs): r = 1 (2); the reference rounds P,
V and each chunk's bf16 P.V sum: r = 2 (3).  So
``|out - reference| <= (1 + 2 + 0.1) u max|v|`` from bf16 inputs and
``(2 + 3 + 0.1) u max|v|`` from f32 ones (0.1 for the u^2 terms and the f32
sums).  Below 1024 positions the reference keeps f32 P (``_attend``), and so
does the model path.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
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
                          bk=32, probs_bf16=False):
    """The arithmetic of the f32 kernel of ``csrc/flash_attention.cu``:
    S = Q.K^T and P.V each as ``terms`` TF32 products summed in f32, the
    online softmax over tiles of ``bk`` keys in f32, P split after it; with
    ``probs_bf16`` P.V is one product of P and V rounded to bf16 (exact
    TF32 values)."""
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
        if probs_bf16:
            pv = torch.einsum("bkgqs,bskd->bkgqd", _bf16(p), _bf16(vt))
        else:
            pv = _tf32_dot("bkgqs,bskd->bkgqd", p, vt, terms)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp_min(l[..., None], 1e-30)).permute(0, 3, 1, 2, 4)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


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


# probs_bf16 at Sq 2048 (the reference's _attend_flash over two chunks of
# 1024): B 1, GQA 4 heads over 2 KV heads, Dh 32, causal
U = 2.0 ** -8
PB_SHAPE = (1, 2048, 1, 2, 32)
PB_ROUNDINGS = {"bfloat16": 1 + 2, "float32": 2 + 3}   # kernel + reference


@functools.lru_cache(maxsize=None)
def _probs_bf16_case(dtype: str):
    """(q, k, v) torch tensors in ``dtype`` and the reference's
    ``_attend_flash`` with ``attn_probs_bf16`` on them (B, Sq, KV, G, Dh)."""
    b, s, kv, g, dh = PB_SHAPE
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _qkv(b, s, kv, g, dh, seed=11))
    jcfg = dataclasses.replace(jreduce(jget_config("smollm-135m")),
                               attn_probs_bf16=True)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    jq, jk, jv = (jnp.asarray(t.to(torch.float32).numpy()).astype(
        getattr(jnp, dtype)) for t in (q, k, v))
    want = jlayers._attend_flash(jq.reshape(b, s, kv * g, dh), jk, jv, pos,
                                 pos, jcfg, causal=True, local=False)
    want = np.asarray(want.astype(jnp.float32)).reshape(b, s, kv, g, dh)
    return q, k, v, want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("what", ["kernel-emulation", "plain-version"])
def test_probs_bf16_within_the_bound_of_the_reference(what, dtype):
    """B8's ``probs_bf16`` at Sq 2048 against the reference's
    ``_attend_flash`` with ``attn_probs_bf16``, within the module
    docstring's bound ``r u max|v|``: the kernel's one-term-P arithmetic
    (bf16: one bf16 P per MMA over tiles of 64 keys; f32: Q.K^T in three
    TF32 products, P.V one product of bf16 P and V over tiles of 32) and
    the plain version (``engine.flash_attention`` on the CPU, the kernel's
    tiling)."""
    q, k, v, want = _probs_bf16_case(dtype)
    kw = dict(causal=True, window=0, softcap=0.0)
    if what == "plain-version":
        with engine.dispatch_trace() as ev:
            got = engine.flash_attention(q, k, v, probs_bf16=True, **kw)
        assert [(e.kind, e.impl_backend) for e in ev] == [
            (engine.ATTN_FLASH_PROBS_BF16, "torch")]
    elif dtype == "bfloat16":
        got = _tensor_core_emulation(q, k, v, split=False, **kw)
    else:
        got = _tf32_split_emulation(q, k, v, probs_bf16=True, **kw)
    tol = (PB_ROUNDINGS[dtype] + 0.1) * U * float(v.float().abs().max())
    gap = float(np.abs(got.numpy() - want).max())
    print(f"{what} {dtype}: max |diff| {gap:.3e} = {gap / tol:.4f} of the "
          f"bound {tol:.3e}")
    assert gap <= tol
    if what == "plain-version":      # the kernel's arithmetic, tile for tile
        emul = _tensor_core_emulation(q, k, v, split=False, **kw) \
            if dtype == "bfloat16" else \
            _tf32_split_emulation(q, k, v, probs_bf16=True, **kw)
        _close_flips(got, emul, v, engine.flash_attention(q, k, v, **kw))


# mean |kernel - plain version| of probs_bf16 as a share of the flag's own
# effect (chip_smoke.PB_KERNEL_SHARE)
PB_SHARE = 0.25


def _close_flips(got, want, v, off):
    """Two computations of the same tiles' bf16 P, whose f32 scores differ
    in the last bits: a p near a rounding boundary can round to the
    neighbouring bf16 value, one ulp (at most 2u p) apart, so ``|got -
    want| <= 2 u max|v|`` on top of the f32 bound 1e-5 max|out|.  Such
    flips are rare, so mean |got - want| is within PB_SHARE of the flag's
    own effect (mean |got - off|, ``off`` the plain version without the
    flag), which ``off`` itself misses (the checks ``chip_smoke.py`` holds
    the kernel to against the plain version)."""
    gap = (got - want).abs()
    tol = 2 * U * float(v.float().abs().max()) + RTOL * float(want.abs().max())
    n_f32 = int((gap > RTOL * want.abs().max()).sum())
    effect = float((got - off).abs().mean())
    share = float(gap.mean()) / effect
    control = float((off - want).abs().mean()) / effect
    print(f"  beside the kernel's arithmetic: max |diff| {float(gap.max()):.3e}"
          f" ({n_f32} of {gap.numel()} beyond 1e-5 of max|out|), bound "
          f"{tol:.3e}; mean |diff| {share:.5f} of the flag's effect (the "
          f"flag off: {control:.5f})")
    assert float(gap.max()) <= tol
    assert share <= PB_SHARE < control


@pytest.mark.parametrize("s", [512, 1024, 2048])
def test_model_path_rounds_probs_where_the_reference_does(s):
    """``attn_probs_bf16`` in ``layers._attend_full``: traced on the card's
    route (meta tensors), the kernel takes ``probs_bf16`` only past 1024
    positions in whole chunks, where the reference takes ``_attend_flash``;
    below, P stays f32, and the plain version equals the reference's
    ``_attend`` (f32 P) within 1e-5 of max|out|."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("smollm-135m")),
                              attn_probs_bf16=True)
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    meta = [torch.empty((1, s, n, dh), device="meta") for n in (h, kvh, kvh)]
    pos = torch.arange(s)[None]
    with engine.trace_as_card(), engine.dispatch_trace() as ev:
        layers._attend_full(*meta, pos.to("meta"), cfg, False, None)
    pb = s > 1024
    assert [(e.kind, e.impl_backend) for e in ev] == [
        (engine.ATTN_FLASH_PROBS_BF16 if pb else engine.ATTN_FLASH, "cuda")]
    if pb or s > 512:
        return
    q, k, v = _qkv(1, s, kvh, h // kvh, dh, seed=s)
    got = engine.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 probs_bf16=layers._probs_bf16(cfg, s))
    jcfg = dataclasses.replace(jreduce(jget_config("smollm-135m")),
                               attn_probs_bf16=True)
    mask = jnp.tril(jnp.ones((s, s), bool))[None, None]
    want = jlayers._attend(jnp.asarray(q).reshape(1, s, h, dh),
                           jnp.asarray(k), jnp.asarray(v), mask, jcfg)
    _close(got.numpy(), np.asarray(want).reshape(got.shape))

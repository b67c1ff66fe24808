"""Port parity for QAT: the straight-through gradients of the port's
fake-quant functions and of whole-model losses against ``jax.grad`` of the
reference's (fault C4), and the fake-quant form of ``wo`` in the fused
paged decode step.

Function level: the gradient of ``sum(f(x) * arange)`` on a ramp and on a
random matrix must equal the reference's within 1e-6 of its largest
entry: the STE's identity through ``weight_fake_quant`` (2xT, 4x4, 8x8,
8xB, 1x1), the unsigned and signed ``act_fake_quant`` (half the gradient
on an entry at a clip bound, as ``jnp.clip`` gives), and the signed 1-bit
activation's zero gradient in both packages (the reference's semantics).

Whole model: ``loss.backward()`` against ``jax.grad(model.loss)`` from the
same params (through ``interop``) and batch, reduced smollm at fp32, 2xT,
4x4 and 8x8 and reduced granite-moe and falcon-mamba at 2xT, all in
float32.  The two packages sum in different orders (a few f32 ulps), and
where a projection's input lies that close to a rounding boundary of its
activation quantizer, its code rounds one way in one package and the other
way in the other (fault C1's mechanism; at 4 and 8 bits a few codes of a
few thousand).  So the port runs with each activation quantizer's codes
taken from the reference's forward where they differ, and the test holds:

  * every differing code one step from the reference's, and its
    pre-quantization value within 1e-3 steps of the boundary between them;
  * the loss within 1e-5 relative;
  * every gradient leaf within 1e-4 of the reference leaf's max |g|.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.core.precision import get_precision as jget_precision  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
import repro_torch.models.layers as tlayers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FN_TOL = 1e-6
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
FLIP_DIST = 1e-3

RAMP = np.linspace(-1.3, 1.7, 12, dtype=np.float32).reshape(3, 4)
RAND = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)


def _fn_grads(jf, tf, x):
    w = np.arange(x.size, dtype=np.float32).reshape(x.shape)
    gj = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) * w))(jnp.asarray(x)))
    t = torch.from_numpy(x.copy()).requires_grad_()
    (tf(t) * torch.from_numpy(w)).sum().backward()
    return t.grad.numpy(), gj


@pytest.mark.parametrize("x", [RAMP, RAND], ids=["ramp", "random"])
@pytest.mark.parametrize("precision", ["2xT", "4x4", "8x8", "8xB", "1x1"])
def test_weight_fake_quant_ste_gradient(precision, x):
    """The identity (``w + stop_gradient(wq - w)``), along both axes."""
    for axis in (0, 1):
        got, want = _fn_grads(
            lambda a: jq.weight_fake_quant(a, jget_precision(precision), axis),
            lambda a: tq.weight_fake_quant(a, get_precision(precision), axis),
            x)
        np.testing.assert_allclose(want, np.arange(x.size).reshape(x.shape))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FN_TOL * np.abs(want).max())


@pytest.mark.parametrize("x", [RAMP, RAND], ids=["ramp", "random"])
@pytest.mark.parametrize("precision,use_signed", [
    ("2xT", False), ("8x8", False),   # unsigned eq. (4): 2 and 8 bits
    ("2xT", True), ("8x8", True)])    # signed, per-tensor absmax scale
def test_act_fake_quant_ste_gradient(precision, use_signed, x):
    """Identity inside the clip range, zero outside, half on an entry at a
    bound (the signed 2-bit absmax entry sits exactly at qmax); no
    gradient through the absmax scale."""
    jp, tp = jget_precision(precision), get_precision(precision)
    if use_signed:
        from repro.core.precision import signed as jsigned
        jp, tp = jsigned(jp), signed(tp)
    got, want = _fn_grads(lambda a: jq.act_fake_quant(a, jp),
                          lambda a: tq.act_fake_quant(a, tp), x)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FN_TOL * np.abs(want).max())


def test_signed_one_bit_activation_has_zero_gradient_in_both():
    """The reference's ``sign(x) + stop_gradient(0 x)``: zero, which the
    port keeps (its semantics, not a fault)."""
    from repro.core.precision import signed as jsigned
    got, want = _fn_grads(
        lambda a: jq.act_fake_quant(a, jsigned(jget_precision("1x1"))),
        lambda a: tq.act_fake_quant(a, signed(get_precision("1x1"))), RAND)
    assert not np.any(want) and not np.any(got)


# ---------------------------------------------------------------------------
# whole-model gradients
# ---------------------------------------------------------------------------
def _qmax(cfg) -> int | None:
    pc = signed(get_precision(cfg.precision))
    return None if pc.a_mode == "float" else (1 << (pc.a_bits - 1)) - 1


def _clip_factor(u, qmax: int):
    """The clip's gradient factor, as ``jnp.clip`` gives it op by op: 1
    inside, 0 outside, 1/2 on a bound."""
    a = abs(u)
    return np.where(a < qmax, 1.0, np.where(a == qmax, 0.5, 0.0)
                    ).astype(np.float32)


def _reference(jm, jp, batch):
    """(loss, grads, each activation quantizer's ``u = x / scale`` in the
    forward): ``jax.value_and_grad`` under ``jax.jit`` with the signed
    activation quantizer written out so that its clip gradient is the
    op-by-op one (compiled, XLA may take an entry exactly on the clip
    bound, the absmax entry at 4 and 8 bits, as inside or outside); the
    same forward values.  ``u`` is taken by ordered debug callbacks: the
    primal forward's calls come first, the backward's rematerialized
    forward calls them again."""
    seen = []
    orig = jlayers.act_fake_quant
    sg = jax.lax.stop_gradient

    def quantizer(x, cfg):
        if cfg.a_mode != "signed" or cfg.a_bits == 1:
            return orig(x, cfg)
        qmax = (1 << (cfg.a_bits - 1)) - 1
        scale = sg(jnp.maximum(jnp.max(jnp.abs(x)), 1e-8)) / qmax
        u = x / scale
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), u,
                           ordered=True)
        a = jnp.abs(u)
        factor = jnp.where(a < qmax, 1.0, jnp.where(a == qmax, 0.5, 0.0))
        xc = sg(jnp.clip(u, -qmax, qmax)) + sg(factor) * (u - sg(u))
        return jq._round_ste(xc) * scale

    jlayers.act_fake_quant = quantizer
    try:
        loss, grads = reference_jit(jax.value_and_grad(jm.loss))(jp, batch)
        jax.block_until_ready(grads)
        jax.effects_barrier()
    finally:
        jlayers.act_fake_quant = orig
    return float(loss), grads, seen


@contextlib.contextmanager
def _reference_codes(ref_u, qmax: int):
    """Patch the port's activation quantizer: call i keeps its own values
    and gradient, except that where its code differs from the reference's
    call i it takes the reference's code, and where its clip gradient
    factor differs (an entry on the bound in one package, a few ulps past
    it in the other) the reference's factor.  Yields the list of such
    entries, (kind, steps apart, distance of the port's ``u`` from the
    boundary, in steps)."""
    flips, done = [], []
    orig = tlayers.act_fake_quant

    def swapped(x, cfg):
        y = orig(x, cfg)
        ur = ref_u[len(done)]
        done.append(x.shape)
        assert ur.shape == tuple(x.shape), (ur.shape, x.shape)
        xs = x.detach().numpy()
        s = np.maximum(np.abs(xs).max(), np.float32(1e-8)) / np.float32(qmax)
        u = xs / s
        own = np.round(np.clip(u, -qmax, qmax))
        want = np.round(np.clip(ur, -qmax, qmax))
        for i in np.flatnonzero(want != own):
            flips.append(("code", float(abs(want.flat[i] - own.flat[i])),
                          float(abs(u.flat[i] - (want.flat[i] + own.flat[i])
                                    / 2))))
        f_own, f_ref = _clip_factor(u, qmax), _clip_factor(ur, qmax)
        for i in np.flatnonzero(f_own != f_ref):
            flips.append(("clip", 0.0, float(abs(abs(u.flat[i]) - qmax))))
        return y + (torch.from_numpy((want - own).astype(np.float32))
                    * float(s)).to(y.dtype) \
            + torch.from_numpy(f_ref - f_own) * (x - x.detach())

    tlayers.act_fake_quant = swapped
    try:
        yield flips
    finally:
        tlayers.act_fake_quant = orig
    # the reference recorded the forward's calls once, or twice with the
    # rematerialized forward
    assert len(ref_u) in (len(done), 2 * len(done)), (len(ref_u), len(done))


def _batch(vocab, b=2, s=16):
    rng = np.random.default_rng(1)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch,precision", [
    ("smollm-135m", "fp32"), ("smollm-135m", "2xT"),
    ("smollm-135m", "4x4"), ("smollm-135m", "8x8"),
    ("granite-moe-1b-a400m", "2xT"), ("falcon-mamba-7b", "2xT")])
def test_model_gradients_match_jax_grad(arch, precision):
    jcfg = jreduce(jget_config(arch, precision=precision))
    tcfg = reduce_for_smoke(get_config(arch, precision=precision))
    assert jcfg.dtype == tcfg.dtype == "float32"
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
    batch = _batch(tcfg.vocab)
    want_loss, jgrads, ref_u = _reference(
        jm, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    qmax = _qmax(tcfg)
    assert (qmax is None) == (not ref_u)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    ctx = contextlib.nullcontext([]) if qmax is None else \
        _reference_codes(ref_u, qmax)
    with ctx as flips:
        loss = tm.loss(tp, {k: torch.from_numpy(v).long()
                            for k, v in batch.items()})
        loss.backward()
    print(f"{arch} {precision}: activation codes / clip factors taken from "
          f"the reference: {flips}")
    for kind, step, dist in flips:
        assert kind == "clip" or step == 1, flips
        assert dist <= FLIP_DIST, flips
    got_loss = float(loss.detach())
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    gj = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    gt = [p.grad for p in tree_leaves(tp)]
    assert len(gj) == len(gt)
    for i, (a, b) in enumerate(zip(gt, gj)):
        scale = np.abs(b).max()
        assert scale > 0 and a is not None, f"leaf {i}: no gradient"
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * scale, \
            f"leaf {i} {b.shape}: max|dg| {err} > {GRAD_TOL} x {scale}"


# ---------------------------------------------------------------------------
# the fused paged decode step on float (QAT) params
# ---------------------------------------------------------------------------
def test_fused_paged_decode_fake_quant_wo_matches_reference():
    """A float 2xT checkpoint (before ``to_serving``) decodes through the
    fused paged step: ``wo`` in ``engine._project_wo``'s fake-quant form,
    as the reference's.  One prefill chunk through a page table, then one
    fused kv8 decode step over two live slots and a dead one: logits
    within 1e-4 of max|logit|; one fused dispatch a layer."""
    precision, kv_bits, bs = "2xT", 8, 8
    jcfg = jreduce(jget_config("smollm-135m", precision=precision))
    tcfg = reduce_for_smoke(get_config("smollm-135m", precision=precision))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = reference_jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
    jpool = jtfm.make_pool(jcfg, 8, bs, kv_bits)
    tpool = tfm.make_pool(tcfg, 8, bs, kv_bits, "cpu")
    toks = np.random.default_rng(2).integers(0, 500, (1, 8)).astype(np.int32)
    row = np.array([[3, 0, 0, 0]], np.int32)
    _, jpool = jm.prefill_chunk_paged(jp, jnp.asarray(toks), jpool,
                                      jnp.asarray(row), 0, kv_bits)
    _, tpool = tm.prefill_chunk_paged(tp, torch.from_numpy(toks).long(),
                                      tpool, torch.from_numpy(row), 0,
                                      kv_bits)
    pt = np.array([[3, 5, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([8, 5, 2], np.int32)
    step = np.array([[7], [9], [11]], np.int32)
    lj, _ = jm.decode_step_paged(jp, jnp.asarray(step), jpool, jnp.asarray(pt),
                                 jnp.asarray(pos), kv_bits, fused=True)
    with engine.dispatch_trace() as ev:
        lt, _ = tm.decode_step_paged(tp, torch.from_numpy(step).long(), tpool,
                                     torch.from_numpy(pt),
                                     torch.from_numpy(pos), kv_bits,
                                     fused=True)
    lj = np.asarray(lj)
    assert [e.op for e in ev].count("fused_paged_decode") == tcfg.n_layers
    np.testing.assert_allclose(lt.numpy()[:2], lj[:2], rtol=0,
                               atol=1e-4 * np.abs(lj[:2]).max())

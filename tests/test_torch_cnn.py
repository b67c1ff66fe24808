"""Port parity: the paper's CNNs (``repro_torch.models.cnn``) and the modules
under them — im2col and max pooling, BNS fusion, WRPN widening, the
fake-quant forwards and the list-walking interop — against ``repro`` on the
same numpy inputs, and the CNN logits from the reference's own params.

Tolerances: data movement (im2col, pooling, serving-form words) is exact.
Elementwise quantizers are exact; f32 means (binary/ternary alphas, 1-bit
activation scales) sum in another order in XLA and torch, so they agree to
rtol 1e-6.  Logits: within 1e-5 of max|logit| with top-1 identical — the
integer accumulators are exact and every other op is the same elementwise
op, so what is left is the f32 summation order of the float head (and, at
fp32, of the float convs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bns as jbns  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.core import widening as jwiden  # noqa: E402
from repro.core.precision import get_precision, signed  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.config import ModelConfig  # noqa: E402
from repro_torch.core import bns as tbns  # noqa: E402
from repro_torch.core import quantize as tquant  # noqa: E402
from repro_torch.core import widening as twiden  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

RNG = np.random.default_rng(13)
LOGIT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,stride,pad", [(3, 1, 1), (11, 4, 2), (7, 2, 3),
                                          (1, 2, 0), (5, 1, 2)])
def test_im2col_matches(r, stride, pad):
    """Patches in (R, S, C) order with zero padding: exact."""
    x = RNG.normal(size=(2, 17, 19, 3)).astype(np.float32)
    want = np.asarray(jcnn._im2col(jnp.asarray(x), r, r, stride, pad))
    got = tcnn._im2col(torch.from_numpy(x), r, r, stride, pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,stride", [(3, 2), (2, 2)])
def test_maxpool_matches(k, stride):
    x = RNG.normal(size=(2, 15, 13, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tcnn._maxpool(torch.from_numpy(x), k, stride).numpy(),
        np.asarray(jcnn._maxpool(jnp.asarray(x), k, stride)))


def test_bns_matches():
    """The fold (eqs. 1/2), its application, the unfused graph and the two
    scale folds: the same f32 elementwise ops, within rtol 1e-6 (XLA may
    reassociate a product chain); the fold equals the unfused graph."""
    c = 24
    mean, var, scale, shift, alpha = (RNG.normal(size=c).astype(np.float32)
                                      for _ in range(5))
    var = np.abs(var) + 0.1
    acc = RNG.normal(size=(5, c)).astype(np.float32)
    j = [jnp.asarray(a) for a in (mean, var)]
    t = [torch.from_numpy(a) for a in (mean, var)]
    for al in (None, alpha):
        jp = jbns.fuse_bns(*j, 1e-5, jnp.asarray(scale), jnp.asarray(shift),
                           None if al is None else jnp.asarray(al))
        tp = tbns.fuse_bns(*t, 1e-5, torch.from_numpy(scale),
                           torch.from_numpy(shift),
                           None if al is None else torch.from_numpy(al))
        pairs = [(tp.gamma, jp.gamma), (tp.beta, jp.beta),
                 (tbns.apply_bns(torch.from_numpy(acc), tp),
                  jbns.apply_bns(jnp.asarray(acc), jp)),
                 (tbns.reference_bn_scale(
                     torch.from_numpy(acc), *t, 1e-5, torch.from_numpy(scale),
                     torch.from_numpy(shift),
                     None if al is None else torch.from_numpy(al)),
                  jbns.reference_bn_scale(
                     jnp.asarray(acc), *j, 1e-5, jnp.asarray(scale),
                     jnp.asarray(shift), None if al is None else jnp.asarray(al))),
                 (tbns.fold_dequant_into_gamma(tp, 0.5, torch.from_numpy(alpha)).gamma,
                  jbns.fold_dequant_into_gamma(jp, 0.5, jnp.asarray(alpha)).gamma),
                 (tbns.fuse_act_quant_levels(tp, 2).gamma,
                  jbns.fuse_act_quant_levels(jp, 2).gamma)]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tbns.apply_bns(torch.from_numpy(acc), tp).numpy(),
            tbns.reference_bn_scale(torch.from_numpy(acc), *t, 1e-5,
                                    torch.from_numpy(scale),
                                    torch.from_numpy(shift),
                                    None if al is None else torch.from_numpy(al)
                                    ).numpy(), rtol=1e-5, atol=1e-5)


def test_widening_matches():
    chans = [3, 64, 192, 384, 256, 256, 1000]
    for mult in (0.25, 1.0, 2.0, 3.0):
        for kf, kl in ((True, True), (False, True), (True, False)):
            assert twiden.widen_cnn_channels(chans, mult, kf, kl) == \
                jwiden.widen_cnn_channels(chans, mult, kf, kl)
        assert twiden.eq_ops_factor(mult) == jwiden.eq_ops_factor(mult)
    cfg = ModelConfig(name="m", d_ff=1536, moe_d_ff=64)
    assert twiden.widen_config(cfg, 2.0) == jwiden.widen_config(cfg, 2.0)
    assert twiden.widen_config(cfg, 1) is cfg


ACT_CASES = ["fp32", "2xT", "1x1", "8x8", "s2xT", "s1x1", "s4x4"]


@pytest.mark.parametrize("name", ACT_CASES)
def test_act_fake_quant_matches(name):
    """Unsigned eq. (4) levels, signed k-bit (per-tensor absmax scale) and
    1-bit sign: elementwise, so exact."""
    pcfg = get_precision(name.lstrip("s"))
    if name.startswith("s"):
        pcfg = signed(pcfg)
    x = (RNG.normal(size=(6, 40)) * 0.8).astype(np.float32)
    x[0, :4] = [0.0, 0.5, 1.0, 1 / 6]          # ties and boundaries
    np.testing.assert_array_equal(
        tquant.act_fake_quant(torch.from_numpy(x), pcfg).numpy(),
        np.asarray(jquant.act_fake_quant(jnp.asarray(x), pcfg)))


@pytest.mark.parametrize("name", ["fp32", "2xT", "1x1", "4x4", "8x8"])
def test_weight_fake_quant_and_dot_match(name):
    """``w + (wq - w)`` as the reference's STE forward; the alphas are f32
    means (rtol 1e-6), so the dequantized weights and the dot agree to
    rtol 1e-6 / 1e-5."""
    pcfg = get_precision(name)
    w = RNG.normal(size=(72, 24)).astype(np.float32)
    x = RNG.normal(size=(5, 72)).astype(np.float32)
    np.testing.assert_allclose(
        tquant.weight_fake_quant(torch.from_numpy(w), pcfg).numpy(),
        np.asarray(jquant.weight_fake_quant(jnp.asarray(w), pcfg)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        engine.fake_quant_dot(torch.from_numpy(x), torch.from_numpy(w),
                              pcfg).numpy(),
        np.asarray(jengine.fake_quant_dot(jnp.asarray(x), jnp.asarray(w),
                                          pcfg)), rtol=1e-5, atol=1e-5)


def test_interop_walks_lists():
    tree = {"conv": [{"w": np.ones((2, 3), np.float32)},
                     {"w": np.zeros(4, np.int32)}],
            "stages": [[{"b": np.arange(3, dtype=np.int8)}]],
            "pair": (np.float32(1.5), np.arange(2))}
    t = params_from_numpy(tree, "cpu")
    assert isinstance(t["conv"], list) and isinstance(t["pair"], tuple)
    assert t["stages"][0][0]["b"].dtype == torch.int8
    back = params_to_numpy(t)
    for (pw, want), (pg, got) in zip(_leaves(tree), _leaves(back)):
        assert pw == pg
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# whole networks, from the reference's params
# ---------------------------------------------------------------------------
_NETS = {}


def _net(name):
    """The reference's float params of a small net (jitted init: eager
    takes seconds); cached per module."""
    if name not in _NETS:
        key = jax.random.PRNGKey(0)
        init = {"tinynet": lambda k: jcnn.tinynet_init(k),
                "resnet34": lambda k: jcnn.resnet_init(k, depth=34,
                                                       n_classes=10),
                "alexnet": lambda k: jcnn.alexnet_init(k, width_mult=0.25,
                                                       n_classes=10)}[name]
        _NETS[name] = reference_jit(init)(key)
    return _NETS[name]


def _serving(name, precision):
    key = (name, precision)
    if key not in _NETS:
        _NETS[key] = reference_jit(
            lambda p: jcnn.cnn_to_serving(p, precision))(
            _net(name))
    return _NETS[key]


@pytest.mark.parametrize("precision", ["2xT", "1x1"])
def test_cnn_to_serving_matches(precision):
    """The port's cnn_to_serving of the interop'd float params, leaf for
    leaf: int32 words and int8 codes equal to the reference's, scales
    within rtol 1e-6 (f32 means); the same leaves are packed."""
    want = dict(_leaves(_np_tree(_serving("resnet34", precision))))
    got = dict(_leaves(tcnn.cnn_to_serving(
        params_from_numpy(_np_tree(_net("resnet34")), "cpu"), precision)))
    assert got.keys() == want.keys()
    n_words = 0
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype, path
        if w.dtype in (np.int32, np.int8):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            n_words += w.dtype == np.int32
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(path))
    assert n_words == 35                       # every block conv + projection


def _check_logits(got, want):
    scale = np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _run_both(name, precision, x, jfn, tfn, serving=True):
    jp = _serving(name, precision) if serving else _net(name)
    want = np.asarray(reference_jit(jfn)(jp, jnp.asarray(x)))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    with engine.dispatch_trace() as ev:
        got = tfn(tp, torch.from_numpy(x)).numpy()
    _check_logits(got, want)
    return ev


@pytest.mark.parametrize("precision,serving", [
    ("fp32", True), ("2xT", True), ("1x1", True), ("2xT", False)],
    ids=["fp32", "2xT", "1x1", "2xT-qat"])
def test_tinynet_logits(precision, serving):
    """Serving form through the engine, and the QAT ``{"qw"}`` form through
    fake_quant_dot."""
    x = RNG.normal(size=(4, 28, 28, 1)).astype(np.float32)
    _run_both("tinynet", precision, x,
              lambda p, x: jcnn.tinynet_apply(p, x, precision),
              lambda p, x: tcnn.tinynet_apply(p, x, precision), serving)


@pytest.mark.parametrize("precision", ["2xT", "1x1"])
def test_resnet34_logits(precision):
    """The reference's own test size (64x64, 10 classes, batch 1): logits
    and top-1, and the packed dispatches of one forward (35: every block
    conv and projection; the 7x7x3 stem stays int8 codes)."""
    x = RNG.normal(size=(1, 64, 64, 3)).astype(np.float32)
    ev = _run_both("resnet34", precision, x,
                   lambda p, x: jcnn.resnet_apply(p, x, 34, precision),
                   lambda p, x: tcnn.resnet_apply(p, x, 34, precision))
    kinds = [e.kind for e in ev]
    packed = "binary" if precision == "1x1" else "ternary"
    assert kinds.count(packed) == 35 and kinds.count("codes") == 1
    assert all(e.impl_backend == "torch" for e in ev)


def test_alexnet_narrow_logits():
    """width_mult 0.25, 10 classes, 224x224x3, batch 1, at 2xT."""
    x = RNG.normal(size=(1, 224, 224, 3)).astype(np.float32)
    _run_both("alexnet", "2xT", x,
              lambda p, x: jcnn.alexnet_apply(p, x, "2xT"),
              lambda p, x: tcnn.alexnet_apply(p, x, "2xT"))


def test_full_width_packing_and_resnet50():
    """At full width the port packs 6 of AlexNet's 7 BNS layers and 35 of
    ResNet-34's 36 (the unaligned first layers stay int8 codes), at 2xT
    and 1x1 alike; ResNet-50 runs through the same functions."""
    gen = torch.Generator().manual_seed(0)
    alex = tcnn.alexnet_init(gen, "cpu")
    res = tcnn.resnet_init(gen, "cpu", depth=34)
    for precision in ("2xT", "1x1"):
        for params, want in ((alex, 6), (res, 35)):
            sv = tcnn.cnn_to_serving(params, precision)
            words = [p for p, v in _leaves(sv)
                     if p[-1] == "wt_packed" and v.dtype == torch.int32]
            codes = [p for p, v in _leaves(sv)
                     if p[-1] == "wt_packed" and v.dtype == torch.int8]
            assert (len(words), len(codes)) == (want, 1), precision
    r50 = tcnn.cnn_to_serving(tcnn.resnet_init(gen, "cpu", depth=50,
                                               width_mult=0.25, n_classes=7),
                              "1x1")
    out = tcnn.resnet_apply(r50, torch.randn(2, 32, 32, 3, generator=gen),
                            depth=50, precision="1x1")
    assert out.shape == (2, 7) and bool(torch.isfinite(out).all())

"""Port parity: the MoE FFN of ``repro_torch`` against ``repro`` — the
expert product (``engine.qmatmul_experts``), ``to_serving``'s per-expert
words, and ``moe_apply`` (slot-map dispatch, capacity, aux loss) at the
reduced granite-moe-1b-a400m's shapes (4 experts, top-2, d 128, expert
d_ff 64), from the reference's own params through ``interop``.

Tolerances: words and codes equal; the expert product equal bit for bit
on integer-valued rows (every f32 sum exact, whatever the order) and within
rtol 1e-6 on normal rows; ``moe_apply``'s output within 1e-5 of max|out|
(f32 summation order of the router, the expert einsums and the norm), its
aux loss within 1e-6.  The same calls on the card (no JAX there) are in
tests/test_torch_families_cuda.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.precision import get_precision as jget_precision  # noqa: E402
from repro.core.precision import signed as jsigned  # noqa: E402
from repro.kernels import engine as jengine  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import convert as jconvert  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import reduce_for_smoke  # noqa: E402

ARCH = "granite-moe-1b-a400m"
E, K, N = 4, 128, 64                  # the reduced w_gate / w_up (E, K, N)


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


_MODELS = {}


def _moe_layer(precision):
    """(jax cfg, port cfg, reference moe params of layer 0 period 0 in
    serving form (numpy), the same through interop)."""
    if precision not in _MODELS:
        jcfg = jreduce(jget_config(ARCH, precision=precision))
        tcfg = reduce_for_smoke(get_config(ARCH, precision=precision))
        jm = jbuild(jcfg)
        jsv = reference_jit(lambda key: jto_serving(jm.init(key), jcfg))(
            jax.random.PRNGKey(0))
        lp = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                    jsv["blocks"]["layer_0"]["moe"])
        _MODELS[precision] = (jcfg, tcfg, lp, params_from_numpy(lp, "cpu"))
    return _MODELS[precision]


def _expert_weights(seed=0, shape=(E, K, N)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * K ** -0.5


PACKINGS = ["2xT", "4x4", "2x2", "1x1", "8x8", "3x3"]


@pytest.mark.parametrize("precision", PACKINGS)
def test_expert_words_equal(precision):
    """``to_serving``'s expert branch: (E, K, N) -> {"wt_packed": (E, N,
    KW) int32 words (int8 codes at 8x8 / 3x3), "scale": (E, N)}, equal to
    the reference's; stacked over periods as well."""
    w = _expert_weights()
    jp = jget_precision(precision)
    bits = jconvert._bits_of(jp)
    want = jconvert._convert_expert(jnp.asarray(w), jp, bits, 16)
    params = {"moe": {"w_gate": torch.from_numpy(np.stack([w, 2 * w]))}}
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              precision=precision)
    got = convert.to_serving(params, cfg)["moe"]["w_gate"]
    assert got["wt_packed"].dtype == (torch.int32 if jp.pack_weights
                                      else torch.int8)
    assert torch.equal(got["wt_packed"][0],
                       torch.from_numpy(np.asarray(want["wt_packed"])))
    np.testing.assert_allclose(got["scale"][0].numpy(),
                               np.asarray(want["scale"]), rtol=1e-6)
    want2 = jconvert._convert_expert(jnp.asarray(2 * w), jp, bits, 16)
    assert torch.equal(got["wt_packed"][1],
                       torch.from_numpy(np.asarray(want2["wt_packed"])))


@pytest.mark.parametrize("precision", PACKINGS)
def test_qmatmul_experts_matches_reference(precision):
    """The expert product on the reference's own packed words: bit-equal
    on integer-valued rows, rtol 1e-6 on normal rows; recorded as a plain
    dispatch."""
    jp = jget_precision(precision)
    pw = jconvert._convert_expert(jnp.asarray(_expert_weights(1)), jp,
                                  jconvert._bits_of(jp), 16)
    tp = params_from_numpy(pw, "cpu")
    rng = np.random.default_rng(2)
    for x in (rng.integers(-3, 4, (E, 5, K)).astype(np.float32),
              rng.standard_normal((E, 5, K)).astype(np.float32)):
        want = np.asarray(jengine.qmatmul_experts(jnp.asarray(x), pw,
                                                  jsigned(jp)))
        with engine.dispatch_trace() as ev:
            got = engine.qmatmul_experts(torch.from_numpy(x), tp,
                                         signed(get_precision(precision)))
        if np.all(x == np.round(x)):
            assert torch.equal(got, torch.from_numpy(want))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
        (e,) = ev
        assert (e.op, e.impl_backend, e.requested_backend, e.m_rows) == \
            ("qmatmul_experts", "torch", "torch", E * 5)


# T tokens -> cap = int(T * 2 / 4 * 1.25) or 1: 1, 1 (6 entries over 4
# experts: some dropped), 2, 15
@pytest.mark.parametrize("precision", ["fp32", "2xT"])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 1), (4, 1), (2, 12)],
                         ids=["T1-cap1", "T3-cap1", "T4-cap2", "T24-cap15"])
def test_moe_apply_matches_reference(precision, b, s):
    jcfg, tcfg, jp, tp = _moe_layer(precision)
    x = np.random.default_rng(b * 100 + s).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    oj, aj = JL.moe_apply(jp, jnp.asarray(x), jcfg)
    ot, at = TL.moe_apply(tp, torch.from_numpy(x), tcfg)
    oj = np.asarray(oj)
    assert ot.shape == oj.shape and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), oj,
                               atol=1e-5 * np.abs(oj).max())
    assert abs(float(at) - float(aj)) <= 1e-6
    assert at.dtype == torch.float32 and at.ndim == 0


def test_capacity_drops_never_land_in_slot_zero():
    """Three identical tokens (the same two experts each) at cap 1: the
    first keeps both slots, the other two are dropped (their rows get no
    expert output), as in the reference; a dropped entry must not overwrite
    slot 0."""
    jcfg, tcfg, jp, tp = _moe_layer("fp32")
    x = np.random.default_rng(9).standard_normal((1, 1, tcfg.d_model)
                                                 ).astype(np.float32)
    x = np.repeat(x, 3, axis=0)                 # identical rows: same experts
    oj, _ = JL.moe_apply(jp, jnp.asarray(x), jcfg)
    ot, _ = TL.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj),
                               atol=1e-5 * np.abs(np.asarray(oj)).max())
    assert bool((ot[0] != 0).any())
    assert bool((ot[1:] == 0).all())


def test_mesh_features_refused():
    """The mesh features are no longer refused off a mesh: with no mesh
    ``moe_impl="shard_map"`` falls through to the slot map (as the
    reference does with no mesh context), and ``moe_ep_constraints`` are
    layout hints that change no value; both equal the plain call.  Over a
    mesh they are tests/test_torch_spmd.py's."""
    _, tcfg, _, tp = _moe_layer("fp32")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    want, aux_want = TL.moe_apply(tp, x, tcfg)
    for over in ({"moe_impl": "shard_map"}, {"moe_ep_constraints": "ep"},
                 {"moe_ep_constraints": "ep_fsdp"}):
        got, aux = TL.moe_apply(tp, x, dataclasses.replace(tcfg, **over))
        assert torch.equal(got, want) and torch.equal(aux, aux_want), over

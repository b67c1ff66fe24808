"""Port parity: ``repro_torch.optim`` against ``repro.optim`` — adamw,
adafactor and adam8bit over three ``update`` calls on the same params and
grads (a matrix, a stacked 3-d leaf, a vector and a bf16 matrix, nested
as the model's trees are), ``_clip_by_global_norm`` and
``make_optimizer``.

Both packages run the same elementwise formulas in the same order; what
differs is the order of the sums (the global norm, adafactor's row and
column means) and the ``b ** count`` power, each a few f32 ulps.  Bounds:
params and float moments within 1e-6 of their largest magnitude, the
gradient norm within 1e-6 relative.  adam8bit's int8 moment codes are
held ``torch.equal`` with grads whose global norm lies under the clip
threshold: the clip then scales by exactly 1, and each moment is the
same f32 arithmetic on the same values in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REL = 1e-6


def _tree(rng, scale=1.0):
    return {"blocks": {"w": rng.standard_normal((3, 8, 6)).astype(np.float32)
                       * scale,
                       "g": rng.standard_normal((6,)).astype(np.float32)
                       * scale},
            "embed": {"w": rng.standard_normal((10, 6)).astype(np.float32)
                      * scale},
            "head": rng.standard_normal((6, 4)).astype(np.float32) * scale}


def _with_bf16(tree):
    """The reference's view of a tree whose ``head`` is bfloat16."""
    out = dict(tree)
    out["head"] = jnp.asarray(tree["head"], jnp.bfloat16)
    return out


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = REL * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _jleaves(tree):
    return [np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16
            else np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _run(name, grad_scale, **kw):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(3)]
    jo, to = joptim.make_optimizer(name, **kw), toptim.make_optimizer(name, **kw)
    jp = _with_bf16(jax.tree_util.tree_map(jnp.asarray, p0))
    tp = params_from_numpy(p0, "cpu")
    tp["head"] = tp["head"].to(torch.bfloat16)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jn = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts, tn = to.update(params_from_numpy(g, "cpu"), ts, tp)
        _close(tn, jn, f"{name} grad norm")
    assert tp["head"].dtype == torch.bfloat16
    for i, (a, b) in enumerate(zip(tree_leaves(params_to_numpy(tp)),
                                   _jleaves(jp))):
        _close(a, b, f"{name} param leaf {i}")
    return js, ts


def test_adamw_three_updates_match_reference():
    """Grads of global norm ~10: the clip scales them every step."""
    js, ts = _run("adamw", 1.0, lr=1e-2, weight_decay=0.1)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    for k in ("m", "v"):
        for i, (a, b) in enumerate(zip(tree_leaves(params_to_numpy(ts[k])),
                                       _jleaves(js[k]))):
            _close(a, b, f"adamw {k} leaf {i}")


def test_adafactor_three_updates_match_reference():
    """Factored second moments (vr, vc) on the 2-d and 3-d leaves, a full
    one on the vector; eps 1e-30 under the rsqrt."""
    js, ts = _run("adafactor", 1.0, lr=1e-2)
    assert int(ts["count"]) == 3
    got = tree_leaves(params_to_numpy(ts["v"]))
    want = _jleaves(js["v"])
    assert len(got) == len(want) == 7          # 3 factored x 2 + 1 full
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"adafactor v leaf {i}")


def test_adam8bit_int8_moments_bit_equal():
    """Grads of global norm under 1: the clip leaves them as they are, so
    the int8 moment codes are equal and their f32 scales within 1e-6."""
    js, ts = _run("adam8bit", 0.03, lr=1e-2, weight_decay=0.05)
    for k in ("m", "v"):
        jq = [x for x in jax.tree_util.tree_leaves(js[k])
              if x.dtype == jnp.int8]
        tq = [x for x in tree_leaves(ts[k]) if x.dtype == torch.int8]
        assert len(jq) == len(tq) == 4
        for i, (a, b) in enumerate(zip(tq, jq)):
            assert torch.equal(a, torch.from_numpy(np.array(b))), \
                f"adam8bit {k} codes of leaf {i}"
        js_s = [x for x in jax.tree_util.tree_leaves(js[k])
                if x.dtype == jnp.float32]
        ts_s = [x for x in tree_leaves(ts[k]) if x.dtype == torch.float32]
        for i, (a, b) in enumerate(zip(ts_s, js_s)):
            _close(a.numpy(), np.asarray(b), f"adam8bit {k} scale {i}")


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    """Below the threshold the grads pass unchanged (scale exactly 1);
    above it every leaf is scaled by max_norm / (norm + 1e-9)."""
    g = _tree(np.random.default_rng(3), scale)
    jg, jn = joptim._clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    tg, tn = toptim._clip_by_global_norm(params_from_numpy(g, "cpu"), 1.0)
    _close(tn, jn, "norm")
    for i, (a, b) in enumerate(zip(tree_leaves(params_to_numpy(tg)),
                                   _jleaves(jg))):
        _close(a, b, f"clipped leaf {i}")
    if scale < 1:
        for a, b in zip(tree_leaves(tg), tree_leaves(g)):
            assert torch.equal(a, torch.from_numpy(b))


def test_make_optimizer_names_and_defaults():
    assert set(toptim.OPTIMIZERS) == set(joptim.OPTIMIZERS)
    for name in toptim.OPTIMIZERS:
        opt = toptim.make_optimizer(name, lr=0.5)
        assert isinstance(opt, toptim.Optimizer)
        state = opt.init({"w": torch.ones(2, 3)})
        assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
    with pytest.raises(KeyError):
        toptim.make_optimizer("sgd")

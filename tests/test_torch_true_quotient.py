"""Quantizer scales are true quotients on every device.

PyTorch's CUDA division of a tensor by a Python number multiplies by the
number's rounded reciprocal; the CPU divides.  ``amax * f32(1/qmax)``
differs from ``amax / qmax`` in one ulp for some 5% (qmax 127) to 55%
(qmax 7) of values, and a code flips where its quotient lies that close to
a rounding boundary.  So every quantizer scale ``amax / qmax`` of the port
divides by a tensor on the operand's device (``core.quantize.true_div``),
and the same scale comes out on both devices.  The card itself is checked
in ``tests/test_torch_cuda.py``; here:

(i) each quantizer site, run under a ``TorchFunctionMode`` that records
every division whose divisor is a Python number, at ``reduce_for_smoke``
sizes: none divides by a Python number, and its CPU values are the former
expression's (``/ qmax``) bit for bit;

(ii) the tensor form of B7b (``act_quant_signed_tensor``: the scale from
all of x and the codes, one launch on the card), plain version and CPU
wrapper, against the reference's ``core.act_quant_codes_signed`` called
eagerly (an eager ``jnp`` division divides; inside ``jax.jit`` XLA turns a
division by a constant into a product with its reciprocal): codes and
scale equal at bits 2-8 in f32 and bf16, with ties and an all-zero tensor.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch_testing import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import reduce_for_smoke  # noqa: E402
from repro_torch.parallel.comm import Axis  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
taq = importlib.import_module("repro_torch.kernels.act_quant")

CFG = reduce_for_smoke(get_config("smollm-135m"))
DIVISIONS = {"div", "div_", "divide", "true_divide", "true_divide_",
             "__truediv__", "__itruediv__"}


class PythonDivisions(TorchFunctionMode):
    """Records (name, divisor) of every ``t / n`` with ``n`` a Python
    number (``n / t`` divides by a tensor and is not recorded)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in DIVISIONS and len(args) >= 2 \
                and isinstance(args[1], (int, float)) \
                and not isinstance(args[1], bool):
            self.calls.append((name, args[1]))
        return func(*args, **(kwargs or {}))


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


# each site: (run, former): ``run()`` calls the port's quantizer and returns
# the tensors it decides (scales, or values dequantized under them);
# ``former()`` computes them with the former ``/ qmax`` (None: not kept)
def _kv(bits):
    """``_kv_quantize`` on one prefill chunk's K/V at the smoke config."""
    k, v = (_rand(2, 16, CFG.n_kv_heads, CFG.head_dim, seed=s) for s in (1, 2))
    qmax = (1 << (bits - 1)) - 1

    def run():
        kq, ks, vq, vs = layers._kv_quantize(k, v, bits)
        return ks, vs

    def former():
        return tuple(t.abs().amax(dim=3, keepdim=True).clamp_min(1e-6) / qmax
                     for t in (k, v))
    return run, former


def _codes_signed():
    x = _rand(4, CFG.d_model, seed=3)
    return (lambda: tcore.act_quant_codes_signed(x, 8)[1:],
            lambda: (x.abs().amax().clamp_min(1e-8) / 127,))


def _fake_quant():
    x = _rand(4, 16, CFG.d_model, seed=4)

    def former():
        s = x.abs().amax().clamp_min(1e-8) / 7
        xc = torch.clamp(x / s, -7, 7)
        return ((xc + (torch.round(xc) - xc)) * s,)
    return (lambda: (tq.act_fake_quant(x, signed(get_precision("4x4"))),),
            former)


def _int_quant():
    w = _rand(CFG.d_model, CFG.d_ff, seed=5)
    return (lambda: tq.int_quant(w, 4)[1:],
            lambda: (w.abs().amax(0, keepdim=True).clamp_min(1e-8) / 7,))


def _split_quant():
    w = _rand(CFG.d_model, CFG.d_ff, seed=6)
    one_rank = Axis(("model",), 1, 0, None, None)
    return (lambda: tq._split_quant(w, signed(get_precision("8x8")), 0,
                                    one_rank)[1:],
            lambda: (w.abs().amax(0, keepdim=True).clamp_min(1e-8) / 127,))


def _grad_compress():
    g = _rand(CFG.d_model, CFG.d_ff, seed=7) * 1e-3

    def former():
        s = torch.clamp_min(g.abs().max(), 1e-12) / 127
        return (torch.clamp(torch.round(g / s), -127, 127) * s,)
    return lambda: (steps._compress(g, 8),), former


def _adam8bit():
    p = {"w": _rand(CFG.d_model, 8, seed=8)}
    g = {"w": _rand(CFG.d_model, 8, seed=9)}

    def run():
        opt = optim.adam8bit(lr=1e-2)
        _, state, _ = opt.update(g, opt.init(p), p)
        return state["m"]["w"]["s"], state["v"]["w"]["s"]
    return run, None


SITES = {"kv8": lambda: _kv(8), "kv4": lambda: _kv(4),
         "act_quant_codes_signed": _codes_signed,
         "act_fake_quant_signed": _fake_quant, "int_quant": _int_quant,
         "split_quant_one_rank": _split_quant,
         "grad_compress_int8": _grad_compress, "adam8bit_moments": _adam8bit}


@pytest.mark.parametrize("site", sorted(SITES))
def test_no_scale_divides_by_a_python_number(site):
    run, former = SITES[site]()
    with PythonDivisions() as mode:
        got = run()
    assert mode.calls == [], f"{site} divides by a Python number: {mode.calls}"
    if former is not None:                      # the CPU values as before
        want = former()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), site


def _tensor_inputs(bits, seed):
    """(name, x): random rows, rows with ties (max |x| = qmax * 2^-3, so
    the scale is 2^-3 exactly and x / s lands on k + 0.5), an all-zero
    tensor (the 1e-8 floor) and one ragged row."""
    rng = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    ties = ((np.arange(-qmax, qmax) + 0.5) / 8).astype(np.float32)
    tied = rng.normal(size=(6, 64)).astype(np.float32) * qmax / 40
    tied.flat[:ties.size] = ties
    tied.flat[-1] = qmax / 8
    return [("random", rng.normal(size=(37, 100)).astype(np.float32) * 3),
            ("ties", np.clip(tied, -qmax / 8, qmax / 8)),
            ("zeros", np.zeros((4, 64), np.float32)),
            ("ragged row", rng.normal(size=(1, 9)).astype(np.float32))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_tensor_form_matches_reference(bits, dtype):
    """act_quant_signed_tensor_ref, the CPU wrapper and
    ``core.act_quant_codes_signed`` against the reference's (eager):
    codes and scale equal."""
    tdt = getattr(torch, dtype)
    for name, x in _tensor_inputs(bits, seed=bits):
        jc, js = jcore.act_quant_codes_signed(jnp.asarray(x, getattr(
            jnp, dtype)), bits)
        jc, js = np.asarray(jc), np.asarray(js)
        xt = torch.from_numpy(x).to(tdt)
        for label, (codes, scale) in (
                ("plain", ref.act_quant_signed_tensor_ref(xt, bits)),
                ("wrapper", taq.act_quant_signed_tensor(xt, bits=bits)),
                ("core", tcore.act_quant_codes_signed(xt, bits))):
            assert scale.dtype == torch.float32 and scale.dim() == 0
            np.testing.assert_array_equal(codes.numpy(), jc,
                                          err_msg=f"{label} {name}")
            np.testing.assert_array_equal(scale.numpy(), js,
                                          err_msg=f"{label} {name}")
        if name == "ties":
            q = x.astype(np.float32) / np.float32(js)
            assert np.any(q - np.floor(q) == 0.5)



@pytest.mark.parametrize("bits", [8, 4])
def test_eager_reference_is_the_oracle(bits):
    """The port's KV scales equal the reference's ``_kv_quantize`` run
    eagerly (true quotients) bit for bit; the same function inside
    ``jax.jit`` multiplies by the reciprocal (XLA rewrites a division by a
    constant), so some of its scales may differ by an ulp: counted and
    printed (with -s), not asserted, as that depends on XLA's rewrite."""
    import jax
    from repro.models import layers as jlayers
    k, v = (_rand(2, 16, CFG.n_kv_heads, CFG.head_dim, seed=s).numpy()
            for s in (1, 2))
    _, ks, _, vs = layers._kv_quantize(torch.from_numpy(k),
                                       torch.from_numpy(v), bits)
    eager = jlayers._kv_quantize(jnp.asarray(k), jnp.asarray(v), bits)
    jitted = jax.jit(lambda a, b: jlayers._kv_quantize(a, b, bits))(
        jnp.asarray(k), jnp.asarray(v))
    off = []
    for got, e, j in ((ks, eager[1], jitted[1]), (vs, eager[3], jitted[3])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(e))
        off.append(int((got.numpy() != np.asarray(j)).sum()))
    print(f"kv{bits}: K / V scales off the jitted reference's: {off} of "
          f"{ks.numel()} each")

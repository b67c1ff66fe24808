"""Port parity: ``repro_torch.core`` packing and weight quantizers against
``repro.core`` on the same numpy inputs, plus the param-tree interop."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.core.precision import get_precision  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import quantize as tquant  # noqa: E402

RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


def _codes(bits, shape):
    lo, hi = (0, 1) if bits == 1 else (-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    return RNG.integers(lo, hi + 1, shape).astype(np.int8)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_words_identical(bits):
    codes = _codes(bits, (3, 5, 64))              # negative codes included
    want = np.array(jpack.pack(jnp.asarray(codes), bits))
    got = tpack.pack(torch.from_numpy(codes), bits).numpy()
    np.testing.assert_array_equal(got, want)
    for signed in (True, False):
        np.testing.assert_array_equal(
            tpack.unpack(torch.from_numpy(want), bits, signed=signed).numpy(),
            np.asarray(jpack.unpack(jnp.asarray(want), bits, signed=signed)))


def test_binary_pm1_identical():
    pm1 = np.where(RNG.random((4, 96)) < 0.5, -1, 1).astype(np.int8)
    want = np.asarray(jpack.pack_binary_pm1(jnp.asarray(pm1)))
    got = tpack.pack_binary_pm1(torch.from_numpy(pm1))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpack.unpack_binary_pm1(got).numpy(), pm1)


def test_nibbles_identical():
    codes = RNG.integers(-7, 8, (2, 6, 32)).astype(np.int8)
    want = np.asarray(jpack.pack_nibbles(jnp.asarray(codes)))
    got = tpack.pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpack.unpack_nibbles(got).numpy(), codes)


@pytest.mark.parametrize("name", ["2xT", "8xT", "8x8", "4x4", "2x2", "3x3", "8xB"])
def test_weight_quant_matches(name):
    """Codes identical; int scales identical (elementwise max / qmax).  The
    ternary/binary scales are f32 means, summed in another order by XLA and
    torch, so they agree to rtol 1e-6 (one or two ulps)."""
    w = RNG.normal(size=(2, 96, 40)).astype(np.float32)
    pcfg = get_precision(name)
    cj, sj = jquant.weight_quant(jnp.asarray(w), pcfg, axis=-2)
    ct, st = tquant.weight_quant(torch.from_numpy(w), pcfg, axis=-2)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if pcfg.w_mode == "int":
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    else:
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)


def test_interop_roundtrip_bf16():
    """A JAX bf16 leaf crosses as its bit pattern (no ml_dtypes needed)."""
    x = jnp.asarray(RNG.normal(size=(3, 4)).astype(np.float32)).astype(jnp.bfloat16)
    tree = {"a": {"w": np.asarray(x)}, "b": np.arange(5, dtype=np.int32)}
    t = interop.params_from_numpy(tree, "cpu")
    assert t["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["a"]["w"].to(torch.float32).numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    with pytest.raises(TypeError):                   # no default device
        interop.params_from_numpy(tree)
    if not torch.cuda.is_available():                # the card, asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            interop.params_from_numpy(tree, "cuda")
    back = interop.params_to_numpy(t)
    np.testing.assert_array_equal(back["b"], tree["b"])
    np.testing.assert_array_equal(back["a"]["w"],
                                  np.asarray(x.astype(jnp.float32)))


def test_build_dir_checkout_or_cache(tmp_path, monkeypatch):
    """Kernels build into the checkout's build/ for a source tree, and into
    the user cache for an installed package (no directory beside
    site-packages)."""
    from pathlib import Path

    from repro_torch.kernels import _build
    root = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "repro_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    installed = tmp_path / "lib" / "site-packages" / "repro_torch"
    assert _build.build_dir(installed) == tmp_path / "cache" / "repro_torch"

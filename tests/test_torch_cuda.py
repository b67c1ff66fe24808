"""The hand-written CUDA kernels against their plain PyTorch versions, at
the serving path's shapes.  Needs an NVIDIA GPU and nvcc: every test here
is marked ``cuda`` and skips without a card.  Imports no JAX, so it also
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import packing  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
from repro_torch.kernels import decode_attention as tattn  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(576, 576), (192, 576), (1536, 576), (576, 1536), (96, 128)]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _weight(gen, n, k, bits, mode, device):
    lo, hi = (-1, 1) if bits == 2 else (-(1 << (bits - 1)) + 1, (1 << (bits - 1)) - 1)
    codes = torch.randint(lo, hi + 1, (n, k), generator=gen, dtype=torch.int8)
    scale = torch.rand(n, generator=gen) + 0.5
    return engine.PackedWeight(packing.pack(codes, bits).to(device),
                               scale.to(device), bits, mode, k)


@pytest.mark.parametrize("m", [1, 4, 17, 32, 33])
@pytest.mark.parametrize("name", ["2xT", "8xT", "4x4", "2x2"])
def test_qmatmul_kernel_equals_plain(gpu, name, m):
    """Int path: bit-equal to the plain version (float activations are
    quantized per row first, so this covers the int kernel + epilogue)."""
    pcfg = signed(get_precision(name))
    gen = torch.Generator().manual_seed(m)
    for n, k in SHAPES:
        pw = _weight(gen, n, k, engine.weight_bits(pcfg), pcfg.w_mode, gpu)
        x = torch.randn((m, k), generator=gen).to(gpu, torch.bfloat16)
        bias = torch.randn(n, generator=gen).to(gpu)
        for b in (None, bias):
            engine.reset_launch_counts()
            got = engine.qmatmul(x, pw, pcfg, bias=b, backend="cuda")
            assert sum(engine.launch_counts().values()) == 1
            want = engine.qmatmul(x, pw, pcfg, bias=b, backend="torch")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, m, n, k)


def test_qmatmul_float_path(gpu):
    """Float activations straight into the kernel (no quantization):
    f32 sums in another order, within 1e-4 of max|out|."""
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)
    pw = _weight(gen, 576, 1536, 2, "ternary", gpu)
    x = torch.randn((5, 1536), generator=gen).to(gpu)
    fn, _ = engine.resolve_entry("ternary", 0, 2, "cuda")
    got = fn(x, pw, pw.scale, None, out_dtype=torch.float32)
    want = ref.ternary_matmul_ref(x, pw.wt_packed, pw.scale)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel(gpu, q_dtype):
    """Against the f32 plain version: rounding only (online vs one-shot
    softmax), atol 1e-5 + 1e-4 of max|out|."""
    gen = torch.Generator().manual_seed(1)
    b, kv, g, dh, s = 4, 3, 3, 64, 80
    q = torch.randn((b, kv, g, dh), generator=gen).to(gpu, q_dtype)
    codes = lambda: torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                                  dtype=torch.int8).to(gpu)
    scales = lambda: (torch.rand((b, s, kv, 1), generator=gen) * 0.02
                      + 1e-3).to(gpu)
    args = (q, codes(), scales(), codes(), scales(),
            torch.tensor([79, 40, 0, 33], dtype=torch.int32, device=gpu))
    got = tattn.decode_attention(*args)
    want = tattn.decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()

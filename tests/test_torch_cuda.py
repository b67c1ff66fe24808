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
from repro_torch.kernels import decode_fused as tfused  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402

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


BINARY_SHAPES = SHAPES + [(200, 320), (256, 2304)]


@pytest.mark.parametrize("m", [1, 4, 17, 32, 33, 1568])
def test_binary_matmul_kernel_equals_plain(gpu, m):
    """XNOR + popcount on random bits: bit-equal to the plain version, with
    and without a bias, at the LM's decode shapes, a ragged N and a CNN
    shape; one launch counted per call."""
    kernel, _ = engine.resolve_entry("binary", 1, 1, "cuda")
    plain, _ = engine.resolve_entry("binary", 1, 1, "torch")
    gen = torch.Generator().manual_seed(m)
    for n, k in BINARY_SHAPES:
        a, w = (torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                              dtype=torch.int64).to(torch.int32).to(gpu)
                for shape in ((m, k // 32), (n, k // 32)))
        alpha = (torch.rand(n, generator=gen) + 0.5).to(gpu)
        bias = torch.randn(n, generator=gen).to(gpu)
        pw = engine.PackedWeight(w, alpha, 1, "binary", k)
        for b in (None, bias):
            engine.reset_launch_counts()
            got = kernel(a, pw, alpha, b, out_dtype=torch.float32)
            assert engine.launch_counts()["binary_matmul"] == 1
            want = plain(a, pw, alpha, b, out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, n, k)


@pytest.mark.parametrize("m", [1, 4, 33])
def test_qmatmul_1x1_kernel_equals_plain(gpu, m):
    """1x1 through the engine: bf16 activations -> signs and row scale ->
    bit-packed -> the kernel, bit-equal to the plain path."""
    pcfg = signed(get_precision("1x1"))
    gen = torch.Generator().manual_seed(m)
    for n, k in SHAPES:
        w = torch.randn((k, n), generator=gen).to(gpu)
        pw = engine.pack_weight(w, pcfg)
        x = torch.randn((m, k), generator=gen).to(gpu, torch.bfloat16)
        bias = torch.randn(n, generator=gen).to(gpu)
        for b in (None, bias):
            engine.reset_launch_counts()
            got = engine.qmatmul(x, pw, pcfg, bias=b, backend="cuda")
            assert engine.launch_counts()["binary_matmul"] == 1
            want = engine.qmatmul(x, pw, pcfg, bias=b, backend="torch")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, n, k)


def test_binary_wrapper_refuses_what_the_kernel_does_not_take(gpu):
    """int8 words, a K that is not 32 per word, or a float64 alpha raise
    before any launch."""
    kernel, _ = engine.resolve_entry("binary", 1, 1, "cuda")
    a = torch.zeros((4, 18), dtype=torch.int32, device=gpu)
    w = torch.zeros((64, 18), dtype=torch.int32, device=gpu)
    alpha = torch.ones(64, device=gpu)
    pw = engine.PackedWeight(w, alpha, 1, "binary", 576)
    engine.reset_launch_counts()
    with pytest.raises(TypeError):
        kernel(a.to(torch.int8), pw, alpha, None, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        kernel(a, pw._replace(k=560), alpha, None, out_dtype=torch.float32)
    with pytest.raises(TypeError):
        kernel(a, pw, alpha.double(), None, out_dtype=torch.float32)
    assert sum(engine.launch_counts().values()) == 0


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


def _paged_args(gpu, kv_bits, q_dtype, pool_dtype, seed=2):
    """One paged decode step at the serving shapes: B=4, KV=3, G=3, Dh=64,
    blocks of 16, 5 blocks per sequence, positions 79 (last block), 0, 40
    and 63; a random permuted page table with null entries past each
    sequence's last live block."""
    gen = torch.Generator().manual_seed(seed)
    b, kv, g, dh, bs, nb = 4, 3, 3, 64, 16, 5
    nb_pool = 1 + b * nb
    pos = [79, 0, 40, 63]
    q = torch.randn((b, kv, g, dh), generator=gen).to(gpu, q_dtype)
    shape = (nb_pool, bs, kv, dh // 2 if kv_bits == 4 else dh)
    if kv_bits == 16:
        k, v = (torch.randn(shape, generator=gen).to(gpu, pool_dtype)
                for _ in range(2))
        ks = vs = None
    else:
        k, v = (torch.randint(-128 if kv_bits == 4 else -127, 128, shape,
                              generator=gen, dtype=torch.int8).to(gpu)
                for _ in range(2))
        ks, vs = ((torch.rand((nb_pool, bs, kv, 1), generator=gen) * 0.02
                   + 1e-3).to(gpu) for _ in range(2))
    pt = (torch.randperm(nb_pool - 1, generator=gen) + 1).reshape(b, nb)
    for i, p in enumerate(pos):
        pt[i, p // bs + 1:] = 0
    return (q, k, ks, v, vs, pt.to(gpu, torch.int32),
            torch.tensor(pos, dtype=torch.int32, device=gpu))


POOLS = [(16, torch.float32), (16, torch.bfloat16), (8, torch.int8),
         (4, torch.int8)]
POOL_IDS = ["kv16-f32", "kv16-bf16", "kv8", "kv4"]


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_bits,pool_dtype", POOLS, ids=POOL_IDS)
def test_paged_attention_kernel(gpu, kv_bits, pool_dtype, q_dtype):
    """Against the f32 plain version (f32 dequant): rounding only, atol
    1e-5 + 1e-4 of max|out|; one launch counted per call."""
    args = _paged_args(gpu, kv_bits, q_dtype, pool_dtype)
    engine.reset_launch_counts()
    got = tpaged.paged_attention(*args, kv_bits=kv_bits)
    assert engine.launch_counts()["paged_attention"] == 1
    want = tpaged.paged_attention_ref(*args, kv_bits=kv_bits,
                                      out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_bits,pool_dtype", POOLS, ids=POOL_IDS)
def test_fused_decode_kernel(gpu, kv_bits, pool_dtype, q_dtype):
    """Against the f32 plain version with an f32 (576, 576) wo, slot map
    (0, 2, 3, 3): within 1e-5 + 1e-4 of max|out|; the repeated slot's rows
    are identical; one launch counted per call."""
    args = _paged_args(gpu, kv_bits, q_dtype, pool_dtype, seed=3)
    gen = torch.Generator().manual_seed(4)
    wo = (torch.randn((576, 576), generator=gen) / 24).to(gpu)
    sm = torch.tensor([0, 2, 3, 3], dtype=torch.int32, device=gpu)
    engine.reset_launch_counts()
    got = tfused.fused_decode(*args, sm, wo, kv_bits=kv_bits)
    assert engine.launch_counts()["fused_decode"] == 1
    want = tfused.fused_decode_ref(*args, sm, wo, kv_bits=kv_bits)
    torch.cuda.synchronize()
    assert got.shape == (4, 576)
    assert torch.equal(got[2], got[3])
    assert (got - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()


def test_paged_wrappers_refuse_what_the_kernels_do_not_take(gpu):
    """An int64 page table, kv8 without scales, or an int64 slot map raise
    before any launch."""
    q, k, ks, v, vs, pt, pos = _paged_args(gpu, 8, torch.bfloat16, torch.int8)
    wo = torch.zeros((576, 576), device=gpu)
    sm = torch.arange(4, dtype=torch.int32, device=gpu)
    engine.reset_launch_counts()
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, k, ks, v, vs, pt.long(), pos, kv_bits=8)
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, k, None, v, None, pt, pos, kv_bits=8)
    with pytest.raises(ValueError):
        tfused.fused_decode(q, k, ks, v, vs, pt, pos, sm.long(), wo,
                            kv_bits=8)
    assert sum(engine.launch_counts().values()) == 0

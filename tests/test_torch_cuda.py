"""The hand-written CUDA kernels against their plain PyTorch versions, at
the serving path's shapes.  Needs an NVIDIA GPU and nvcc: every test here
is marked ``cuda`` and skips without a card.  Imports no JAX, so it also
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401

from repro_torch.core import packing  # noqa: E402
from repro_torch.core.precision import get_precision, signed  # noqa: E402
tattn = importlib.import_module("repro_torch.kernels.decode_attention")
from repro_torch.kernels import decode_fused as tfused  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
taq = importlib.import_module("repro_torch.kernels.act_quant")
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402

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
            # the per-row quantizer, then the matmul
            counts = engine.launch_counts()
            assert counts["act_quant_signed_grouped"] == 1
            assert sum(counts.values()) == 2
            want = engine.qmatmul(x, pw, pcfg, bias=b, backend="torch")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, m, n, k)


# (weight kind, field bits) of every int8-codes path of B1 / B3
QMM_KINDS = [("ternary", 2), ("int", 2), ("int", 4), ("int", 8)]
# a K per width whose packed W^T rows are not a multiple of 16 bytes
# (592 * 2 / 8 = 148, 584 * 4 / 8 = 292, 588 bytes): the word-wise loads
UNALIGNED_K = {2: 592, 4: 584, 8: 588}
QMM_M = [1, 4, 17, 32, 33, 64, 65, 128, 1568]


@pytest.mark.parametrize("m", QMM_M)
@pytest.mark.parametrize("kind,bits", QMM_KINDS,
                         ids=["ternary", "int2", "int4", "int8"])
def test_qmatmul_full_field_range(gpu, kind, bits, m):
    """int8 codes straight into B1 / B3: weight fields over their whole
    signed range, the most negative one (-2, -8, -128) in every row, x
    over all of int8, at the decode and CNN shapes, an N = 2048 that moves
    M = 64 onto the tensor cores, a ragged N with an unaligned K, with and
    without a bias: bit-equal to the plain version, one launch per call."""
    fn, key = engine.resolve_entry(kind, 8, bits, "cuda")
    plain, _ = engine.resolve_entry(kind, 8, bits, "torch")
    assert key[3] == "cuda"
    name = "ternary_matmul" if kind == "ternary" else "packed_matmul"
    gen = torch.Generator().manual_seed(1000 * bits + m)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    for n, k in SHAPES[:4] + [(256, 2304), (2048, 576), (200, UNALIGNED_K[bits])]:
        codes = torch.randint(lo, hi + 1, (n, k), generator=gen,
                              dtype=torch.int8)
        codes[:, k // 2] = lo
        scale = (torch.rand(n, generator=gen) + 0.5).to(gpu)
        pw = engine.PackedWeight(packing.pack(codes, bits).to(gpu), scale,
                                 bits, kind, k)
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(gpu)
        bias = torch.randn(n, generator=gen).to(gpu)
        for b in (None, bias):
            engine.reset_launch_counts()
            got = fn(x, pw, scale, b, out_dtype=torch.float32)
            counts = engine.launch_counts()
            assert counts[name] == 1 and sum(counts.values()) == 1
            want = plain(x, pw, scale, b, out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, bits, m, n, k, b is not None)


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


def _binary_named(lib, a, w, alpha, bias, k, variant):
    """+/-1 bits through one named kernel of csrc/binary_matmul.cu (0 =
    decode rows, 1 = tensor cores), whatever M is; not a counted launch."""
    from repro_torch.kernels import _build
    out = torch.empty((a.shape[0], w.shape[0]), dtype=torch.float32,
                      device=a.device)
    _build.check(lib.binary_matmul_variant(
        a.data_ptr(), w.data_ptr(), alpha.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        a.shape[0], w.shape[0], k, variant, _build.stream_ptr(a)), "variant")
    return out


# M across the decode-rows / tensor-core switch (M_SMALL = 64 in C)
BINARY_M = [1, 4, 32, 63, 64, 65, 128, 1568]


@pytest.mark.parametrize("m", BINARY_M)
def test_binary_both_kernels_equal_plain(gpu, m):
    """Both kernels of B6 by name at every M, and the wrapper's own choice
    (one launch a call): the decode projections' (N, K), a ragged N with an
    odd word count (4-byte chunks), N = 2048 (past the M * N bound at M =
    64), a CNN and an AlexNet fc shape; with and without a bias; bit-equal
    to the plain version."""
    from repro_torch.kernels import _build
    lib = _build.library("binary_matmul")
    kernel, _ = engine.resolve_entry("binary", 1, 1, "cuda")
    plain, _ = engine.resolve_entry("binary", 1, 1, "torch")
    gen = torch.Generator().manual_seed(7000 + m)
    for n, k in [(576, 576), (192, 576), (1536, 576), (576, 1536),
                 (129, 32 * 37), (2048, 576), (256, 2304), (4096, 9216)]:
        a, w = (torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                              dtype=torch.int64).to(torch.int32).to(gpu)
                for shape in ((m, k // 32), (n, k // 32)))
        alpha = (torch.rand(n, generator=gen) + 0.5).to(gpu)
        bias = torch.randn(n, generator=gen).to(gpu)
        pw = engine.PackedWeight(w, alpha, 1, "binary", k)
        for b in (None, bias):
            want = plain(a, pw, alpha, b, out_dtype=torch.float32)
            engine.reset_launch_counts()
            got = kernel(a, pw, alpha, b, out_dtype=torch.float32)
            assert engine.launch_counts()["binary_matmul"] == 1
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, n, k, b is not None)
            for v in (0, 1):
                got = _binary_named(lib, a, w, alpha, b, k, v)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (v, m, n, k, b is not None)


# the row form's callers: decode and prefill-chunk rows, the CNNs' im2col
# rows (ResNet-34 stage 1 and 3 at batch 8), AlexNet's fc input, ragged F
AQ_ROW_SHAPES = [(4, 576), (4, 1536), (32, 576), (32, 1536), (25088, 576),
                 (1568, 2304), (8, 9216), (37, 100)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_act_quant_rows_kernel_equals_plain(gpu, bits, x_dtype):
    """B7c's row form: codes and scales torch.equal to the plain version,
    one launch each, at its callers' shapes, on all-zero rows, on a view 4
    bytes off its allocation (no vector loads), and on every bf16 value of
    [-2, 2] (ties)."""
    gen = torch.Generator().manual_seed(bits)
    xs = [torch.randn((m, f), generator=gen) * 2 for m, f in AQ_ROW_SHAPES]
    xs.append(torch.zeros((3, 576)))
    grid = _bf16_grid(-2.0, 2.0)
    xs.append(grid[:grid.numel() // 64 * 64].reshape(-1, 64))
    xs = [x.to(gpu, x_dtype) for x in xs]
    flat = torch.randn(1 + 33 * 576, generator=gen).to(gpu, x_dtype)
    xs.append(flat[1:].view(33, 576))
    for x in xs:
        engine.reset_launch_counts()
        q, s = taq.act_quant_signed_rows(x, bits=bits)
        assert engine.launch_counts()["act_quant_signed_grouped"] == 1
        assert sum(engine.launch_counts().values()) == 1
        q_ref, s_ref = ref.act_quant_signed_rows_ref(x, bits)
        torch.cuda.synchronize()
        assert s.dtype == x_dtype and s.shape == (x.shape[0], 1)
        assert torch.equal(s, s_ref), (tuple(x.shape), bits)
        assert torch.equal(q, q_ref), (tuple(x.shape), bits)


def test_projection_quantizes_in_one_launch(gpu):
    """The engine's 2xT projection on the card: one act_quant_signed_grouped
    launch (the row form) and one matmul, and no separate scale operations
    (no abs, no reduction) among the device operations torch.profiler sees
    around one ``qmatmul`` call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pcfg = signed(get_precision("2xT"))
    gen = torch.Generator().manual_seed(0)
    pw = _weight(gen, 576, 576, 2, pcfg.w_mode, gpu)
    x = torch.randn((4, 576), generator=gen).to(gpu, torch.bfloat16)
    engine.qmatmul(x, pw, pcfg, backend="cuda")
    torch.cuda.synchronize()
    engine.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.qmatmul(x, pw, pcfg, backend="cuda")
        torch.cuda.synchronize()
    counts = engine.launch_counts()
    assert counts["act_quant_signed_grouped"] == 1
    assert counts["ternary_matmul"] == 1 and sum(counts.values()) == 2
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("act_quant_rows_kernel" in n for n in names) == 1, names
    assert not any("reduce_kernel" in n or "abs" in n.lower() for n in names), names


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


def _decode_case(gpu, s, pos, *, q_dtype=torch.bfloat16, kv=3, g=3, dh=64,
                 misalign=False, seed=3):
    """B5's operands: a dense int8 cache of S positions; ``misalign`` puts
    the code caches 4 bytes off a 16-byte boundary (still contiguous)."""
    gen = torch.Generator().manual_seed(seed)
    b = len(pos)
    shape = (b, s, kv, dh)

    def codes():
        c = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        if not misalign:
            return c.to(gpu)
        flat = torch.empty(c.numel() + 16, dtype=torch.int8, device=gpu)
        view = flat[4:4 + c.numel()].view(shape)
        view.copy_(c)
        return view
    scales = lambda: (torch.rand((b, s, kv, 1), generator=gen) * 0.02
                      + 1e-3).to(gpu)
    q = torch.randn((b, kv, g, dh), generator=gen).to(gpu, q_dtype)
    return (q, codes(), scales(), codes(), scales(),
            torch.tensor(pos, dtype=torch.int32, device=gpu))


def _check_decode(args):
    """B5 against its f32 plain version, twice: the two launches equal."""
    engine.reset_launch_counts()
    got = tattn.decode_attention(*args)
    again = tattn.decode_attention(*args)
    assert engine.launch_counts()["decode_attention"] == 2
    want = tattn.decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_long_context_takes_a_cluster(gpu, q_dtype):
    """S = 2048, pos [2047, 1023, 511, 0]: an 8-block cluster per
    (sequence, KV head) with 16-byte loads."""
    args = _decode_case(gpu, 2048, [2047, 1023, 511, 0], q_dtype=q_dtype)
    plan = tattn.launch_plan(args[0], args[1], args[3])
    assert plan["vector"] and plan["cluster"] == 8
    _check_decode(args)


@pytest.mark.parametrize("s,dh,g", [(80, 64, 3), (300, 64, 3), (80, 40, 4)],
                         ids=["s80", "s300-cluster", "dh40"])
def test_decode_attention_scalar_loads(gpu, s, dh, g):
    """A cache 4 bytes off a 16-byte boundary, or rows that are not a
    whole number of 16-byte vectors (Dh 40), take the scalar-load path."""
    args = _decode_case(gpu, s, [s - 1, 0, s // 2, 17], g=g, dh=dh,
                        misalign=dh == 64)
    plan = tattn.launch_plan(args[0], args[1], args[3])
    assert not plan["vector"] and plan["cluster"] == (8 if s > 128 else 1)
    _check_decode(args)


@pytest.mark.parametrize("kv,g,dh", [(2, 16, 128), (4, 12, 128), (8, 8, 128),
                                     (2, 2, 112)],
                         ids=["glm4", "starcoder2", "internvl2", "kimi-dh112"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_model_heads(gpu, q_dtype, kv, g, dh):
    """The LM families' head layouts: glm4-9b's 16 query heads a KV head
    (the plan's shared memory grows with G), starcoder2's 12, internvl2's
    8, and kimi-k2's Dh 112 (7 int8 16-byte vectors a row) at the serving
    step's 80 positions and at 2048 (an 8-block cluster)."""
    for s, pos in ((80, [79, 40, 0, 33]), (2048, [2047, 1023, 511, 0])):
        args = _decode_case(gpu, s, pos, q_dtype=q_dtype, kv=kv, g=g, dh=dh)
        plan = tattn.launch_plan(args[0], args[1], args[3])
        assert plan["vector"] and plan["cluster"] == (1 if s <= 128 else 8)
        _check_decode(args)


@pytest.mark.parametrize("s,pos", [(16, [15, 0, 7, 3]), (5, [4, 0, 2, 9]),
                                   (128, [127, 64, 0, 100])],
                         ids=["s16", "s5-pos-past-s", "s128"])
def test_decode_attention_short_caches(gpu, s, pos):
    """Caches of one span or less, a position past S (all S positions
    attend), and the largest S of the one-block plan."""
    args = _decode_case(gpu, s, pos)
    assert tattn.launch_plan(args[0], args[1], args[3])["cluster"] == 1
    _check_decode(args)


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


def _bf16_grid(lo, hi):
    """Every bf16 value in [lo, hi], as float32 (exact ties: x * levels and
    x / 2^-j are exact in f32, so k + 0.5 occurs)."""
    u = torch.arange(0, 1 << 16, dtype=torch.int32) << 16
    v = u.view(torch.float32)
    return v[torch.isfinite(v) & (v >= lo) & (v <= hi)]


# (M, F): decode rows, a ragged F (scalar path), a CNN im2col shape
AQ_SHAPES = [(4, 576), (4, 1536), (37, 100), (3, 7), (25088, 576)]


def _aq_inputs(gen, gpu, x_dtype):
    """Random rows at AQ_SHAPES, every bf16 value of [-2, 2] as (M, 64)
    rows (ties), and a contiguous view 4 bytes off its allocation (no
    vector loads)."""
    xs = [(torch.randn((m, f), generator=gen) * 2) for m, f in AQ_SHAPES]
    grid = _bf16_grid(-2.0, 2.0)
    xs.append(grid[:grid.numel() // 64 * 64].reshape(-1, 64))
    xs = [x.to(gpu, x_dtype) for x in xs]
    flat = torch.randn(1 + 33 * 576, generator=gen).to(gpu, x_dtype)
    xs.append(flat[1:].view(33, 576))
    return xs


def _launch_once(name, fn):
    engine.reset_launch_counts()
    out = fn()
    assert engine.launch_counts()[name] == 1
    return out


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_act_quant_kernels_equal_plain(gpu, bits, x_dtype, compute):
    """All three quantizers, torch.equal to their plain versions, one
    launch each: unsigned on |x| / 2 (the bf16 grid gives every bf16 value
    of [0, 1]: ties), signed with a power-of-two scale (ties) and an absmax
    scale, and in its tensor form (codes and scale, compute in x's dtype),
    grouped with G = 1 and G = 4 (F allowing).  The rows hold a ragged F
    (37, 100), fewer values than one vector a thread (3, 7), a grid-stride
    shape (25088, 576) and a view 4 bytes off (scalar loads)."""
    gen = torch.Generator().manual_seed(bits)
    qmax = (1 << (bits - 1)) - 1
    kw = dict(bits=bits, compute_dtype=compute)
    for x in _aq_inputs(gen, gpu, x_dtype):
        xu = (x.abs() / 2).contiguous()
        got = _launch_once("act_quant", lambda: taq.act_quant(xu, **kw))
        assert torch.equal(got, ref.act_quant_ref(xu, bits,
                                                  compute_dtype=compute))
        for s in (torch.tensor([0.25], device=gpu),
                  (x.abs().amax().clamp_min(1e-8) / qmax).reshape(1)):
            got = _launch_once("act_quant_signed",
                               lambda: taq.act_quant_signed(x, s, **kw))
            assert torch.equal(got, ref.act_quant_signed_ref(
                x, bits, s, compute_dtype=compute))
        if bits >= 2 and compute == x_dtype:
            q, s = _launch_once("act_quant_signed", lambda:
                                taq.act_quant_signed_tensor(x, bits=bits))
            q_ref, s_ref = ref.act_quant_signed_tensor_ref(x, bits)
            assert torch.equal(s, s_ref) and torch.equal(q, q_ref)
        for g in (1, 4):
            if x.shape[1] % g:
                continue
            s = (x.reshape(x.shape[0], g, -1).abs().amax(-1)
                 .clamp_min(1e-8) / qmax).contiguous()
            got = _launch_once("act_quant_signed_grouped",
                               lambda: taq.act_quant_signed_grouped(x, s, **kw))
            assert torch.equal(got, ref.act_quant_signed_grouped_ref(
                x, bits, s, compute_dtype=compute))
        torch.cuda.synchronize()


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
def test_act_quant_flat_kernels_past_l2(gpu, x_dtype):
    """B7a, B7b and B7b's tensor form at ResNet-34's stem rows at batch 32,
    (401408, 64) (77 MB in bf16, past the 50 MB L2; the grid-stride loops
    and the tensor form's second read), compute in x's dtype, bits 2, 4
    and 8: torch.equal to the plain versions, one launch each."""
    gen = torch.Generator().manual_seed(401408)
    x = (torch.randn((32 * 112 * 112, 64), generator=gen) * 2).to(gpu, x_dtype)
    xu = torch.relu(x) / 4
    kw = dict(compute_dtype=x_dtype)
    for bits in (2, 4, 8):
        got = _launch_once("act_quant", lambda: taq.act_quant(xu, bits=bits, **kw))
        assert torch.equal(got, ref.act_quant_ref(xu, bits, **kw))
        q, s = _launch_once("act_quant_signed", lambda:
                            taq.act_quant_signed_tensor(x, bits=bits))
        q_ref, s_ref = ref.act_quant_signed_tensor_ref(x, bits)
        assert torch.equal(s, s_ref) and torch.equal(q, q_ref)
        got = _launch_once("act_quant_signed", lambda: taq.act_quant_signed(
            x, s_ref.to(x_dtype), bits=bits, **kw))
        assert torch.equal(got, q_ref)
        torch.cuda.synchronize()


def _tensor_state_words(device) -> int:
    """The sum of every tensor-form state word on ``device``: 0 at rest."""
    words = [t for (d, _), t in taq._STREAM_STATE.items() if d == device]
    words += [taq._GRAPH_POOL[device][0]] if device in taq._GRAPH_POOL else []
    return sum(int(t.abs().sum()) for t in words)


def test_act_quant_tensor_form_state_and_graph_replay(gpu):
    """The tensor form's state words are zero after every call, and a
    CUDA graph of three calls (a multi-block grid and a one-block one)
    replays to the eager results, twice."""
    gen = torch.Generator().manual_seed(5)
    xs = [(torch.randn(shape, generator=gen) * s).to(gpu, torch.bfloat16)
          for shape, s in (((25088, 576), 3.0), ((4, 576), 0.5),
                           ((25088, 64), 1.0))]
    want = [ref.act_quant_signed_tensor_ref(x, 4) for x in xs]
    for x, (q_ref, s_ref) in zip(xs, want):
        q, s = taq.act_quant_signed_tensor(x, bits=4)
        torch.cuda.synchronize()
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
        assert _tensor_state_words(gpu) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [taq.act_quant_signed_tensor(x, bits=4) for x in xs]
    for _ in range(2):
        for q, _s in outs:
            q.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for (q, s), (q_ref, s_ref) in zip(outs, want):
            assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
        assert _tensor_state_words(gpu) == 0


def test_act_quant_tensor_form_on_two_streams(gpu):
    """Tensor-form calls on two streams at once, eager and as two captured
    graphs replayed on two streams, each give its own tensor's codes and
    scale: no call reads another's max or arrivals."""
    gen = torch.Generator().manual_seed(6)
    xs = [(torch.randn((401408, 64), generator=gen) * s).to(gpu, torch.bfloat16)
          for s in (1.0, 40.0)]
    want = [ref.act_quant_signed_tensor_ref(x, 4) for x in xs]
    streams = [torch.cuda.Stream(gpu) for _ in xs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(gpu))
    got = [[] for _ in xs]
    for _ in range(20):
        for x, st, g in zip(xs, streams, got):
            with torch.cuda.stream(st):
                g.append(taq.act_quant_signed_tensor(x, bits=4))
    torch.cuda.synchronize()
    for g, (q_ref, s_ref) in zip(got, want):
        for q, s in g:
            assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    graphs, outs = [], []
    for x in xs:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append(taq.act_quant_signed_tensor(x, bits=4))
    for _ in range(20):
        for graph, st in zip(graphs, streams):
            st.wait_stream(torch.cuda.current_stream(gpu))
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        for (q, s), (q_ref, s_ref) in zip(outs, want):
            assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert _tensor_state_words(gpu) == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantize_scales_are_true_quotients(gpu, bits):
    """``_kv_quantize``'s scales on the card equal numpy's float32 quotient
    ``max(amax|row|, 1e-6) / qmax`` for 10^5 random (token, head) rows of
    Dh 64 (rows drawn at scales from 1e-3 to 1e3), K and V alike."""
    from repro_torch.models import layers
    rng = np.random.default_rng(bits)
    shape = (4, 12500, 2, 64)
    k, v = (rng.normal(size=shape).astype(np.float32)
            * np.exp(rng.uniform(-7, 7, size=shape[:3] + (1,))).astype(np.float32)
            for _ in range(2))
    _, ks, _, vs = layers._kv_quantize(torch.from_numpy(k).to(gpu),
                                       torch.from_numpy(v).to(gpu), bits)
    qmax = np.float32((1 << (bits - 1)) - 1)
    bad = {}
    for name, t, got in (("K", k, ks), ("V", v, vs)):
        want = np.maximum(np.abs(t).max(axis=3, keepdims=True),
                          np.float32(1e-6)) / qmax
        bad[name] = int((got.cpu().numpy() != want).sum())
    print(f"kv{bits}: scales that differ from the float32 quotient, of "
          f"{shape[0] * shape[1] * shape[2]} a tensor: {bad}")
    assert bad == {"K": 0, "V": 0}, f"kv{bits}: {bad}"


def test_act_quant_wrappers_refuse_what_the_kernel_does_not_take(gpu):
    """float16 rows or compute, 9 bits, a scale that does not group x, or a
    scale on the host raise before any launch."""
    x = torch.randn((4, 64), device=gpu)
    engine.reset_launch_counts()
    with pytest.raises(TypeError):
        taq.act_quant(x.half(), bits=2)
    with pytest.raises(ValueError):
        taq.act_quant(x, bits=2, compute_dtype=torch.float16)
    with pytest.raises(ValueError):
        taq.act_quant(x, bits=9)
    with pytest.raises(ValueError):
        taq.act_quant_signed_grouped(x, torch.ones((4, 3), device=gpu), bits=2)
    with pytest.raises(ValueError):
        taq.act_quant_signed(x, torch.ones(1), bits=2)
    with pytest.raises(ValueError):
        taq.act_quant_signed_tensor(x, bits=1)
    with pytest.raises(ValueError):
        taq.act_quant_signed_tensor(x[:0], bits=4)
    with pytest.raises(ValueError):          # computes in x's dtype
        taq.act_quant_signed_tensor(x.half(), bits=4)
    assert sum(engine.launch_counts().values()) == 0


# (B, S, KV, G, Dh, causal, window, softcap[, Sk]): prefill, ragged lengths,
# the gemma2-style window + softcap at Dh 128, Dh 96, no mask; then the bf16
# kernel's tiling (16 rows a warp, 64 a block, 64 keys a tile): Sq*G = 111
# rows (no multiple of 16 or 64), Sk = 20 < one key tile, G = 1 at Dh 128
# with a window, and the forward's S = 2048 at Dh 64.  With a ninth entry
# the keys number Sk, not S (no mask): whisper-base's cross-attention over
# 1500 encoder frames at a 32-token prefill and at a decode step (one
# query row of a 64-row tile, a ragged key tail), and its encoder (S 1500);
# kimi-k2's Dh 112, causal and with Sq != Sk
FLASH_CASES = [(1, 64, 3, 3, 64, True, 0, 0.0), (2, 100, 3, 3, 64, True, 0, 0.0),
               (1, 300, 2, 2, 128, True, 64, 50.0), (2, 77, 1, 4, 96, True, 16, 5.0),
               (1, 45, 2, 1, 32, False, 0, 0.0),
               (1, 37, 2, 3, 64, True, 0, 0.0), (2, 20, 1, 2, 32, True, 0, 0.0),
               (1, 200, 2, 1, 128, True, 100, 0.0), (1, 2048, 3, 3, 64, True, 0, 0.0),
               (4, 32, 8, 1, 64, False, 0, 0.0, 1500),
               (4, 1, 8, 1, 64, False, 0, 0.0, 1500),
               (2, 1500, 8, 1, 64, False, 0, 0.0),
               (2, 300, 2, 4, 112, True, 0, 0.0),
               (1, 77, 2, 3, 112, False, 0, 0.0, 130)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_kernel(gpu, case, dtype):
    """Against the f32 plain version: online against one-shot softmax, max
    |diff| <= 1e-5 * max|out|; one launch counted per call."""
    b, s, kv, g, dh, causal, window, softcap, *sk = case
    sk = sk[0] if sk else s
    gen = torch.Generator().manual_seed(s)
    q = torch.randn((b, s, kv, g, dh), generator=gen).to(gpu, dtype)
    k, v = (torch.randn((b, sk, kv, dh), generator=gen).to(gpu, dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _launch_once("flash_attention",
                       lambda: tflash.flash_attention(q, k, v, **kw))
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dh", tflash.HEAD_DIMS)
def test_flash_attention_f32_every_head_dim(gpu, dh):
    """The TF32 kernel at every Dh it is built for, causal with a window
    of 40 and a softcap of 30, S = 173 (no multiple of a tile), G = 3:
    within 1e-5 * max|out| of the f32 plain version, and two launches give
    equal bits."""
    gen = torch.Generator().manual_seed(dh)
    b, s, kv, g = 2, 173, 2, 3
    q = torch.randn((b, s, kv, g, dh), generator=gen).to(gpu)
    k, v = (torch.randn((b, s, kv, dh), generator=gen).to(gpu)
            for _ in range(2))
    kw = dict(causal=True, window=40, softcap=30.0)
    engine.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, **kw)
    again = tflash.flash_attention(q, k, v, **kw)
    assert engine.launch_counts()["flash_attention"] == 2
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_flash_attention_refuses_misaligned(gpu):
    """A contiguous view 2 bytes into a flat bf16 buffer (``x[1:]``,
    reshaped) is not 16-byte aligned: the wrapper raises, no launch."""
    shape = (1, 64, 1, 2, 64)
    flat = torch.randn(1 + 64 * 2 * 64, device=gpu).bfloat16()
    q = flat[1:].reshape(shape)
    k = torch.randn((1, 64, 1, 64), device=gpu).bfloat16()
    assert q.is_contiguous() and q.data_ptr() % 16
    engine.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(k[:, :, :, None].expand(shape).contiguous(),
                               flat[1:1 + k.numel()].reshape(k.shape), k)
    assert sum(engine.launch_counts().values()) == 0


def test_flash_attention_wrapper_refuses(gpu):
    """Dh 48, mixed dtypes, and inputs that require a gradient (the kernel
    has no backward) raise before any launch."""
    q = torch.randn((1, 8, 1, 2, 48), device=gpu)
    k = torch.randn((1, 8, 1, 48), device=gpu)
    engine.reset_launch_counts()
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, k)
    q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    with pytest.raises(TypeError):
        tflash.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(RuntimeError, match="no backward"):
        tflash.flash_attention(q.requires_grad_(True), k, k)
    assert sum(engine.launch_counts().values()) == 0


def test_forward_through_the_kernels(gpu):
    """The reduced smollm, float32, B=2, S=40: at 2xT ``Model.forward``
    launches one flash_attention per layer and one quantizer and one
    matmul per projection; at fp32 its logits are within 1e-4 * max|logit|
    of the plain versions' (backend="torch") and its loss within 1e-5
    relative (at 2xT one rounding of an attention output can flip a 2-bit
    code downstream, so no bound is held there)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke, to_serving
    gen = torch.Generator().manual_seed(1)
    for precision in ("2xT", "fp32"):
        cfg = reduce_for_smoke(get_config("smollm-135m", precision=precision))
        model = build_model(cfg)
        params = to_serving(model.init(torch.Generator().manual_seed(0), gpu),
                            cfg, tp=1)
        batch = {k: torch.randint(0, cfg.vocab, (2, 40), generator=gen).to(gpu)
                 for k in ("tokens", "labels")}
        engine.reset_launch_counts()
        logits, _ = model.forward(params, batch)
        counts = engine.launch_counts()
        assert counts["flash_attention"] == cfg.n_layers
        if precision == "2xT":
            assert counts["act_quant_signed_grouped"] == 7 * cfg.n_layers
            assert counts["ternary_matmul"] == 7 * cfg.n_layers
            continue
        plain, _ = model.forward(params, batch, backend="torch")
        assert (logits - plain).abs().max() <= 1e-4 * plain.abs().max()
        lk = float(model.loss(params, batch))
        lp = float(model.loss(params, batch, backend="torch"))
        assert abs(lk - lp) <= 1e-5 * abs(lp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_probs_bf16_kernel(gpu, case, dtype):
    """``probs_bf16`` against the plain version of the flag (the kernel's
    key tiles, P and V rounded to bf16): the two round the same tiles' P,
    from scores that differ in the last f32 bits, so a p next to a rounding
    boundary may take the neighbouring bf16 value (one ulp, at most 2^-7
    p): max |diff| <= 2^-7 max|v| + 1e-5 max|out|.  Such flips are rare, so
    mean |diff| is held to PB_SHARE of the flag's own effect (mean |plain
    with the flag - plain without|), and the flag-off kernel, a kernel that
    ignored the flag, must miss that share; one launch a call."""
    b, s, kv, g, dh, causal, window, softcap, *sk = case
    sk = sk[0] if sk else s
    gen = torch.Generator().manual_seed(s)
    q = torch.randn((b, s, kv, g, dh), generator=gen).to(gpu, dtype)
    k, v = (torch.randn((b, sk, kv, dh), generator=gen).to(gpu, dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _launch_once("flash_attention",
                       lambda: tflash.flash_attention(q, k, v, probs_bf16=True,
                                                      **kw))
    got_off = tflash.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, probs_bf16=True, **kw)
    effect = (want - ref.flash_attention_ref(q, k, v, **kw)).abs().mean()
    torch.cuda.synchronize()
    tol = 2.0 ** -7 * v.float().abs().max() + 1e-5 * want.abs().max()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= tol
    assert (got - want).abs().mean() <= PB_SHARE * effect
    assert (got_off - want).abs().mean() > PB_SHARE * effect


# mean |B8 probs_bf16 - its plain version| as a share of the flag's effect
# (chip_smoke.PB_KERNEL_SHARE)
PB_SHARE = 0.25


def test_bf16_probabilities_launch_b8_past_the_chunk(gpu):
    """``attn_probs_bf16`` (set by no config): a forward of the reduced
    smollm at S 2048 (past the reference's 1024-position chunk) launches B8
    with bf16 probabilities on every layer, at S 512 with f32 ones, as the
    reference rounds P only in ``_attend_flash``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke
    cfg = dataclasses.replace(reduce_for_smoke(get_config("smollm-135m")),
                              attn_probs_bf16=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), gpu)
    for s, kind in ((2048, engine.ATTN_FLASH_PROBS_BF16),
                    (512, engine.ATTN_FLASH)):
        tokens = torch.zeros((1, s), dtype=torch.int64, device=gpu)
        engine.reset_launch_counts()
        with engine.dispatch_trace() as ev:
            logits, _ = model.forward(params, {"tokens": tokens})
        assert engine.launch_counts()["flash_attention"] == cfg.n_layers
        assert [(e.kind, e.impl_backend) for e in ev
                if e.op == "flash_attention"] == [(kind, "cuda")] * \
            cfg.n_layers
        assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# The paged flash-decode core (csrc/paged_common.cuh) at the shapes its
# plan changes on: the cluster path, pool block sizes, head layouts, the
# scalar-load path; launch-to-launch equality.  Tolerances as above.
def _paged_case(gpu, kv_bits, pool_dtype, *, kv=3, g=3, dh=64, bs=16,
                pos=(79, 0, 40, 63), n_ctx=80, seed=5, misalign=False):
    """One paged decode step with len(pos) sequences of n_ctx positions
    (rounded up to whole blocks) in a permuted pool; ``misalign`` puts the
    pools 4 bytes off a 16-byte boundary (still contiguous)."""
    gen = torch.Generator().manual_seed(seed)
    b, nb = len(pos), -(-n_ctx // bs)
    nb_pool = 1 + b * nb
    q = torch.randn((b, kv, g, dh), generator=gen).to(gpu, torch.bfloat16)
    shape = (nb_pool, bs, kv, dh // 2 if kv_bits == 4 else dh)

    def pool(t):
        if not misalign:
            return t.to(gpu)
        flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=gpu)
        off = 4 // t.element_size()
        view = flat[off:off + t.numel()].view(shape)
        view.copy_(t)
        return view
    if kv_bits == 16:
        k, v = (pool(torch.randn(shape, generator=gen).to(pool_dtype))
                for _ in range(2))
        ks = vs = None
    else:
        k, v = (pool(torch.randint(-128 if kv_bits == 4 else -127, 128, shape,
                                   generator=gen, dtype=torch.int8))
                for _ in range(2))
        ks, vs = ((torch.rand((nb_pool, bs, kv, 1), generator=gen) * 0.02
                   + 1e-3).to(gpu) for _ in range(2))
    pt = (torch.randperm(nb_pool - 1, generator=gen) + 1).reshape(b, nb)
    for i, p in enumerate(pos):
        pt[i, p // bs + 1:] = 0
    return (q, k, ks, v, vs, pt.to(gpu, torch.int32),
            torch.tensor(pos, dtype=torch.int32, device=gpu))


def _plan(args, kv_bits):
    q, k, _, v, _, pt, _ = args
    kind = {16: 2 if k.dtype == torch.float32 else 3, 8: 0, 4: 1}[kv_bits]
    return tpaged.launch_plan(kind, q.shape[0], q.shape[1], q.shape[2],
                              q.shape[3], k.shape[1], pt.shape[1], k, v)


def _check_paged(args, kv_bits):
    """B2 against its f32 plain version, twice: the two launches equal."""
    engine.reset_launch_counts()
    got = tpaged.paged_attention(*args, kv_bits=kv_bits)
    again = tpaged.paged_attention(*args, kv_bits=kv_bits)
    assert engine.launch_counts()["paged_attention"] == 2
    want = tpaged.paged_attention_ref(*args, kv_bits=kv_bits,
                                      out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()


def _check_fused(args, kv_bits, slot_map, d=576, seed=6):
    """B4 against its f32 plain version, twice (equal); the rows of a
    repeated slot equal."""
    q = args[0]
    gen = torch.Generator().manual_seed(seed)
    wo = (torch.randn((q[0].numel(), d), generator=gen) / 24).to(q.device)
    sm = torch.tensor(slot_map, dtype=torch.int32, device=q.device)
    engine.reset_launch_counts()
    got = tfused.fused_decode(*args, sm, wo, kv_bits=kv_bits)
    again = tfused.fused_decode(*args, sm, wo, kv_bits=kv_bits)
    assert engine.launch_counts()["fused_decode"] == 2
    want = tfused.fused_decode_ref(*args, sm, wo, kv_bits=kv_bits)
    torch.cuda.synchronize()
    assert got.shape == (len(slot_map), d) and torch.equal(got, again)
    for i, s in enumerate(slot_map):
        assert torch.equal(got[i], got[slot_map.index(s)])
    assert (got - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()


LONG = dict(pos=(2047, 1023, 511, 0), n_ctx=2048)


def test_paged_attention_long_context_takes_a_cluster(gpu):
    args = _paged_case(gpu, 8, torch.int8, **LONG)
    assert _plan(args, 8)["cluster"] > 1
    _check_paged(args, 8)


def test_fused_decode_long_context(gpu):
    _check_fused(_paged_case(gpu, 8, torch.int8, **LONG), 8, [0, 1, 2, 3])


@pytest.mark.parametrize("bs", [5, 16])
@pytest.mark.parametrize("kv_bits,pool_dtype", POOLS, ids=POOL_IDS)
def test_paged_kernels_block_sizes(gpu, kv_bits, pool_dtype, bs):
    args = _paged_case(gpu, kv_bits, pool_dtype, bs=bs, pos=(79, 0, 40, 64))
    assert _plan(args, kv_bits)["vector"]
    _check_paged(args, kv_bits)
    _check_fused(args, kv_bits, [3, 0, 2, 3])


@pytest.mark.parametrize("kv,g", [(1, 8), (4, 1)])
@pytest.mark.parametrize("kv_bits,pool_dtype", POOLS, ids=POOL_IDS)
def test_paged_kernels_head_layouts(gpu, kv_bits, pool_dtype, kv, g):
    args = _paged_case(gpu, kv_bits, pool_dtype, kv=kv, g=g)
    _check_paged(args, kv_bits)
    _check_fused(args, kv_bits, [1, 3, 3])


@pytest.mark.parametrize("kv_bits,pool_dtype,dh,misalign", [
    (8, torch.int8, 40, False), (4, torch.int8, 40, False),
    (16, torch.bfloat16, 36, False), (8, torch.int8, 64, True),
    (16, torch.float32, 64, True)],
    ids=["kv8-dh40", "kv4-dh40", "kv16-bf16-dh36", "kv8-unaligned",
         "kv16-f32-unaligned"])
def test_paged_kernels_scalar_loads(gpu, kv_bits, pool_dtype, dh, misalign):
    """Rows that are not a whole number of 16-byte vectors, or pools off a
    16-byte boundary, take the scalar-load path of the same kernels; a wo
    width that is not a multiple of 4 takes scalar columns."""
    args = _paged_case(gpu, kv_bits, pool_dtype, dh=dh, misalign=misalign)
    assert not _plan(args, kv_bits)["vector"]
    _check_paged(args, kv_bits)
    _check_fused(args, kv_bits, [0, 2, 2], d=3 * 3 * dh + 2)


def test_paged_kernels_wide_f32_rows(gpu):
    """An f32 pool with Dh 128 at a 2048-position context: the plans
    shorten the span until a block fits in shared memory, and B4's wo rows
    (144 x 576 f32 a rank) are too many to stage, so it reads them from
    global memory."""
    args = _paged_case(gpu, 16, torch.float32, dh=128, **LONG)
    plan = _plan(args, 16)
    assert plan["cluster"] == 8 and plan["span"] < 32
    _check_paged(args, 16)
    _check_fused(args, 16, [0, 3, 3])


@pytest.mark.parametrize("kv,g,dh,d", [(2, 16, 128, 4096), (4, 12, 128, 6144),
                                       (2, 2, 112, 128)],
                         ids=["glm4", "starcoder2", "kimi-dh112"])
@pytest.mark.parametrize("kv_bits,pool_dtype", POOLS[:3], ids=POOL_IDS[:3])
def test_paged_kernels_model_widths(gpu, kv_bits, pool_dtype, kv, g, dh, d):
    """B2 and B4 at the LM families' head layouts and model widths: B4's
    projection onto glm4-9b's 4096 and starcoder2-15b's 6144 columns runs
    in passes of 2048 (the warps' partial sums of all D columns would not
    fit in shared memory), wo read from global memory; kimi-k2's Dh 112."""
    args = _paged_case(gpu, kv_bits, pool_dtype, kv=kv, g=g, dh=dh)
    _check_paged(args, kv_bits)
    _check_fused(args, kv_bits, [0, 3, 3, 1], d=d)


@pytest.mark.parametrize("slot_map", [[3], [3, 3, 0], [3, 3, 0, 3]],
                         ids=["L1", "L3", "L4"])
def test_fused_decode_repeated_slot_rows_equal(gpu, slot_map):
    _check_fused(_paged_case(gpu, 8, torch.int8), 8, slot_map)


# ---------------------------------------------------------------------------
# the tuning cache's choices (kernels/tuning.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["2xT", "4x4", "1x1"])
def test_tuned_matmul_tiles_equal_the_automatic_choice(gpu, name, tmp_path,
                                                       monkeypatch):
    """Each compiled kernel a tuned entry can name, through
    ``engine.qmatmul``, against the cold cache's automatic choice."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    tuning.reset()
    pcfg = signed(get_precision(name))
    gen = torch.Generator().manual_seed(1)
    bits = engine.weight_bits(pcfg)
    for m in (1, 4, 32, 65, 300):
        for n, k in ((576, 576), (1536, 576), (576, 1536)):
            pw = engine.pack_weight(torch.randn((k, n), generator=gen)
                                    .to(gpu), pcfg)
            x = torch.randn((m, k), generator=gen).to(gpu, torch.bfloat16)
            auto = engine.qmatmul(x, pw, pcfg)              # cold cache
            for block in tuning.candidate_blocks(m, n, k, pcfg.w_mode, bits):
                got = engine.qmatmul(x, pw, pcfg, block=block)
                torch.cuda.synchronize()
                assert torch.equal(got, auto), (name, m, n, k, block)


@pytest.mark.parametrize("s", [16, 80, 300, 2048])
def test_decode_attention_config_within_bound(gpu, s):
    """B5 at every cluster size and span limit (0: automatic) within its
    per-call bound of the plain version; (0, 0) is the automatic plan."""
    da = tattn
    gen = torch.Generator().manual_seed(s)
    b, kv, g, dh = 4, 3, 3, 64
    q = torch.randn((b, kv, g, dh), generator=gen).to(gpu, torch.bfloat16)
    kc, vc = (torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                            dtype=torch.int8).to(gpu) for _ in "kv")
    ks, vs = ((torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3)
              .to(gpu) for _ in "kv")
    pos = torch.tensor([s - 1, s // 2, 3, 0], dtype=torch.int32, device=gpu)
    ref = da.decode_attention_ref(q, kc, ks, vc, vs, pos)
    tol = 1e-5 + 1e-4 * ref.abs().max().item()
    auto = da.decode_attention(q, kc, ks, vc, vs, pos)
    assert torch.equal(auto, da.decode_attention(q, kc, ks, vc, vs, pos,
                                                 plan=(0, 0)))
    for cluster in (0, 1, 2, 4, 8):
        for span in (0, 1, 8, 16, 32):
            out = da.decode_attention(q, kc, ks, vc, vs, pos,
                                      plan=(cluster, span))
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            assert err <= tol, (s, cluster, span, err, tol)
    with pytest.raises(ValueError):
        da.decode_attention(q, kc, ks, vc, vs, pos, plan=(9, 0))


@pytest.mark.parametrize("s", [16, 300, 2048])
def test_decode_attention_lse_within_bound(gpu, s):
    """B5 with its log-sum-exp output, at every cluster size and span limit:
    the output ``torch.equal`` with the lse on and off; the lse within
    1e-5 max(1, |lse|) of the plain version's; a row with pos < 0 (no
    valid position) has lse -inf and a zero output."""
    da = tattn
    gen = torch.Generator().manual_seed(s)
    b, kv, g, dh = 4, 3, 3, 64
    q = torch.randn((b, kv, g, dh), generator=gen).to(gpu, torch.bfloat16)
    kc, vc = (torch.randint(-127, 128, (b, s, kv, dh), generator=gen,
                            dtype=torch.int8).to(gpu) for _ in "kv")
    ks, vs = ((torch.rand((b, s, kv, 1), generator=gen) * 0.02 + 1e-3)
              .to(gpu) for _ in "kv")
    pos = torch.tensor([s - 1, s // 2, 3, -7], dtype=torch.int32, device=gpu)
    _, want = da.decode_attention_ref(q.cpu(), kc.cpu(), ks.cpu(), vc.cpu(),
                                      vs.cpu(), pos.cpu(), lse=True)
    for cluster in (0, 1, 2, 8):
        for span in (0, 8, 32):
            plan = (cluster, span)
            plain = da.decode_attention(q, kc, ks, vc, vs, pos, plan=plan)
            out, lse = da.decode_attention(q, kc, ks, vc, vs, pos, plan=plan,
                                           lse=True)
            torch.cuda.synchronize()
            assert torch.equal(out, plain), (s, plan)
            got = lse.cpu()
            assert torch.isneginf(got[3]).all() and not out[3].any()
            err = (got[:3] - want[:3]).abs()
            assert (err <= 1e-5 * want[:3].abs().clamp_min(1.0)).all(), \
                (s, plan, float(err.max()))

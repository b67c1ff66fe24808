// Activation quantizers: float rows -> int8 codes in one elementwise pass.
//
// Replaces the three TPU kernels of repro/kernels/act_quant.py:
//   act_quant                 unsigned eq. (4): floor(clip(x, 0, 1) * (2^k - 1) + 0.5)
//   act_quant_signed          clip(round(x / s), +-(2^(k-1) - 1)), one scale s
//   act_quant_signed_grouped  the same with s (M, G), s[row, col / (F/G)]
//
// Exact codes: every code is decided by one rounding step, so the kernel
// repeats the plain PyTorch version's arithmetic operation for operation.
// The sources are built without --use_fast_math and the arithmetic uses
// explicit intrinsics anyway: __fdiv_rn for the quotient (never x * (1/s)),
// __fmul_rn / __fadd_rn so that no multiply-add is contracted, rintf (half
// to even, as torch.round and jnp.round) for the signed codes and
// floorf(v + 0.5) (half up) for the unsigned ones.  With bf16 compute (the
// engine's bf16 rows) x, s, the quotient, the product and the sum are each
// rounded to bf16 with __float2bfloat16_rn, where the PyTorch expression on
// bf16 tensors rounds them; with f32 compute nothing is rounded in between
// (the TPU kernel's arithmetic).  Codes saturate at [-128, 127] as the
// reference's float -> int8 conversion does (8-bit unsigned codes above 127
// come out as 127).
//
// What bounds it on an H100: bytes (read x once, write one byte a code); the
// arithmetic is a few operations a byte.  Design: one thread per 8
// consecutive codes of one row: 32 bytes of f32 (two float4 loads) or 16 of
// bf16 (one uint4) in, one 8-byte store out, when F is a multiple of 8 and
// the pointers are aligned; scalar loads with bounds checks otherwise (the
// ragged tail of a row).  No row padding: rows and columns are masked.  The
// flattened (row, group of 8) index runs along grid.x.
#include "common.cuh"

namespace {

constexpr int VEC = 8, THREADS = 256;

__device__ __forceinline__ float round_to(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(h[i]);
}

// Unsigned eq. (4) code of one value.
__device__ __forceinline__ int8_t code_unsigned(float x, float levels, bool bf16) {
  const float c = fminf(fmaxf(round_to(x, bf16), 0.f), 1.f);
  const float y = round_to(__fmul_rn(c, levels), bf16);
  const float r = floorf(round_to(__fadd_rn(y, 0.5f), bf16));
  return static_cast<int8_t>(__float2int_rn(fminf(r, 127.f)));
}

// Signed symmetric code of one value under scale s.
__device__ __forceinline__ int8_t code_signed(float x, float s, float qmax, bool bf16) {
  const float q = round_to(__fdiv_rn(round_to(x, bf16), round_to(s, bf16)), bf16);
  const float r = fminf(fmaxf(rintf(q), -qmax), qmax);
  return static_cast<int8_t>(__float2int_rn(r));
}

// SIGNED: scale[row * s_row_stride + col / rep] (s_row_stride 0 and rep F
// for one scalar scale); otherwise the unsigned code (scale unused).
template <typename XT, typename ST, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
act_quant_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                 int8_t* __restrict__ out, int M, int F, int nvec, int s_row_stride,
                 int rep, int bits, bool bf16, bool aligned) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long long>(M) * nvec) return;
  const int row = static_cast<int>(t / nvec);
  const int c0 = static_cast<int>(t % nvec) * VEC;
  const size_t base = static_cast<size_t>(row) * F + c0;
  const bool full = aligned && c0 + VEC <= F;

  float v[VEC];
  if (full) {
    load8(x + base, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = c0 + i < F ? to_float(x[base + i]) : 0.f;
  }

  int8_t q[VEC];
  if constexpr (SIGNED) {
    const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
    const ST* srow = scale + static_cast<size_t>(row) * s_row_stride;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = min(c0 + i, F - 1);
      q[i] = code_signed(v[i], to_float(srow[c / rep]), qmax, bf16);
    }
  } else {
    const float levels = static_cast<float>((1 << bits) - 1);
#pragma unroll
    for (int i = 0; i < VEC; ++i) q[i] = code_unsigned(v[i], levels, bf16);
  }

  if (full) {
    uint2 packed;
    int8_t* pb = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int i = 0; i < VEC; ++i) pb[i] = q[i];
    *reinterpret_cast<uint2*>(out + base) = packed;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (c0 + i < F) out[base + i] = q[i];
  }
}

template <typename XT, typename ST, bool SIGNED>
cudaError_t launch_typed(const void* x, const void* scale, void* out, int M, int F,
                         int s_row_stride, int rep, int bits, int bf16, int aligned,
                         cudaStream_t stream) {
  const int nvec = (F + VEC - 1) / VEC;
  const long long blocks = (static_cast<long long>(M) * nvec + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  act_quant_kernel<XT, ST, SIGNED><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale), static_cast<int8_t*>(out),
      M, F, nvec, s_row_stride, rep, bits, bf16 != 0, aligned != 0);
  return cudaGetLastError();
}

template <bool SIGNED>
cudaError_t launch(const void* x, int x_kind, const void* scale, int s_kind, void* out,
                   int M, int F, int s_row_stride, int rep, int bits, int bf16,
                   int aligned, cudaStream_t stream) {
  if (M <= 0 || F <= 0 || rep <= 0 || bits < 1 || bits > 8) return cudaErrorInvalidValue;
  if (SIGNED && scale == nullptr) return cudaErrorInvalidValue;
  const bool xf = x_kind == KIND_F32, sf = !SIGNED || s_kind == KIND_F32;
  if (!xf && x_kind != KIND_BF16) return cudaErrorInvalidValue;
  if (SIGNED && !sf && s_kind != KIND_BF16) return cudaErrorInvalidValue;
  if (xf && sf)
    return launch_typed<float, float, SIGNED>(x, scale, out, M, F, s_row_stride, rep, bits,
                                              bf16, aligned, stream);
  if (xf)
    return launch_typed<float, __nv_bfloat16, SIGNED>(x, scale, out, M, F, s_row_stride,
                                                      rep, bits, bf16, aligned, stream);
  if (sf)
    return launch_typed<__nv_bfloat16, float, SIGNED>(x, scale, out, M, F, s_row_stride,
                                                      rep, bits, bf16, aligned, stream);
  return launch_typed<__nv_bfloat16, __nv_bfloat16, SIGNED>(
      x, scale, out, M, F, s_row_stride, rep, bits, bf16, aligned, stream);
}

}  // namespace

// x: (M, F) f32 or bf16 (x_kind); out: (M, F) int8.  bf16: 1 rounds each
// intermediate to bf16.  aligned: 1 when F % 8 == 0, x is 16-byte and out
// 8-byte aligned (vector loads and stores).
extern "C" cudaError_t act_quant_unsigned(const void* x, int x_kind, void* out, int M,
                                          int F, int bits, int bf16, int aligned,
                                          cudaStream_t stream) {
  return launch<false>(x, x_kind, nullptr, KIND_F32, out, M, F, 0, F, bits, bf16, aligned,
                       stream);
}

// scale: one f32 or bf16 value (s_kind) on the device.
extern "C" cudaError_t act_quant_signed(const void* x, int x_kind, const void* scale,
                                        int s_kind, void* out, int M, int F, int bits,
                                        int bf16, int aligned, cudaStream_t stream) {
  return launch<true>(x, x_kind, scale, s_kind, out, M, F, 0, F, bits, bf16, aligned,
                      stream);
}

// scale: (M, G) f32 or bf16 (s_kind), G | F.
extern "C" cudaError_t act_quant_signed_grouped(const void* x, int x_kind, const void* scale,
                                                int s_kind, void* out, int M, int F, int G,
                                                int bits, int bf16, int aligned,
                                                cudaStream_t stream) {
  if (G <= 0 || F % G != 0) return cudaErrorInvalidValue;
  return launch<true>(x, x_kind, scale, s_kind, out, M, F, G, F / G, bits, bf16, aligned,
                      stream);
}

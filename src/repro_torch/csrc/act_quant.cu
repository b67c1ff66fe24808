// Activation quantizers: float rows -> int8 codes in one elementwise pass.
//
// Replaces the three TPU kernels of repro/kernels/act_quant.py:
//   act_quant                 unsigned eq. (4): floor(clip(x, 0, 1) * (2^k - 1) + 0.5)
//   act_quant_signed          clip(round(x / s), +-(2^(k-1) - 1)), one scale s
//   act_quant_signed_grouped  the same with s (M, G), s[row, col / (F/G)]
// and, for the last one's only caller on the card (the engine's per-row
// quantizer, one group a row), a row form that also computes the scale:
//   act_quant_signed_rows     s[row] = max(amax|x[row]|, 1e-8) / qmax, then the codes
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
// What bounds them on an H100: bytes (read x once, write one byte a code);
// the arithmetic is a few operations a byte.
//
// The elementwise kernel: one thread per 8 consecutive codes of one row: 32
// bytes of f32 (two float4 loads) or 16 of bf16 (one uint4) in, one 8-byte
// store out, when F is a multiple of 8 and the pointers are aligned; scalar
// loads with bounds checks otherwise (the ragged tail of a row).  No row
// padding: rows and columns are masked.  The flattened (row, group of 8)
// index runs along grid.x.
//
// The row form: 32 * wpr lanes a row.  A row of up to 256 vectors of 8 (F <=
// 2048: every LM row, ResNet-34's im2col rows in stages 1-2) gets one vector
// a lane, wpr = its vectors / 32 rounded up, and a block holds 256 / (32 *
// wpr) rows: a decode row (M = 4) spreads over up to 8 warps, and the CNN
// rows keep many rows in flight per SM at few registers.  A longer row
// (ResNet-34 stages 3-4, AlexNet's fc) gets 8 warps and batches of two or
// four vectors a lane.  The lanes take max |x| over their vectors, each warp
// combines its lanes' maxima with __shfl_xor_sync and the row's warps theirs
// through shared memory (a max is exact in any order; rows are finite: fmaxf
// drops a NaN where amax would keep it).  Then the scale, rounded where the
// PyTorch expression on x's dtype rounds: max(amax, 1e-8) (in bf16: rounded
// to bf16, as clamp_min on a bf16 tensor gives it), then __fdiv_rn by qmax
// (then rounded to bf16), stored in x's dtype; and the codes by the
// elementwise kernel's arithmetic (less its no-op conversions: code_row),
// from the values still in registers, or for a row longer than one batch read
// a second time from L1 or L2.  At decode that is one launch where the engine
// issued five (abs, amax, clamp_min, div, codes).  What bounds the CNN rows
// is the bytes in flight per SM (some 16 rows of one load a lane), not the
// arithmetic nor the bytes in all: f32 and bf16 rows take the same time
// (PERF.md section 6).
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

// Values c0 .. c0 + 7 of a row of F values, zeros past F: one vector load
// when aligned and in bounds, scalar loads otherwise (the ragged tail).
template <typename XT>
__device__ __forceinline__ void load_row8(const XT* __restrict__ xr, int c0, int F,
                                          bool aligned, float (&v)[VEC]) {
  if (aligned && c0 + VEC <= F) {
    load8(xr + c0, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = c0 + i < F ? to_float(xr[c0 + i]) : 0.f;
  }
}

// Codes c0 .. c0 + 7 of a row of F: one 8-byte store, or byte stores up to F.
__device__ __forceinline__ void store_row8(int8_t* __restrict__ orow, int c0, int F,
                                           bool aligned, const int8_t (&q)[VEC]) {
  if (aligned && c0 + VEC <= F) {
    uint2 packed;
    int8_t* pb = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int i = 0; i < VEC; ++i) pb[i] = q[i];
    *reinterpret_cast<uint2*>(orow + c0) = packed;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (c0 + i < F) orow[c0 + i] = q[i];
  }
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
  float v[VEC];
  load_row8(x + static_cast<size_t>(row) * F, c0, F, aligned, v);

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
  store_row8(out + static_cast<size_t>(row) * F, c0, F, aligned, q);
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

// ---------------------------------------------------------------------------
// the row form: scale and codes of a row in one launch
// ---------------------------------------------------------------------------
constexpr int RW_THREADS = 256;   // at most 8 warps a block

// The row form's signed code of x under s, both already values of x's
// dtype: code_signed's arithmetic with the conversions that change nothing
// left out.  The quotient's bf16 rounding is done on its bits (round to
// nearest even, exact for every finite value); clamping before rounding
// gives the code that rintf then clamping gives, qmax being an integer,
// and the rounding is one add (half to even): 1.5 * 2^23 + v lands in a
// binade of unit spacing.
template <bool BF16>
__device__ __forceinline__ int8_t code_row(float x, float s, float qmax) {
  float q = __fdiv_rn(x, s);
  if constexpr (BF16) {
    uint32_t u = __float_as_uint(q);
    u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
    q = __uint_as_float(u);
  }
  const float t = __fadd_rn(fminf(fmaxf(q, -qmax), qmax), 12582912.0f);
  return static_cast<int8_t>(__float_as_int(t) - 0x4B400000);
}

template <bool BF16>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ orow, int v, int F,
                                            bool aligned, const float (&val)[VEC], float s,
                                            float qmax) {
  int8_t q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) q[i] = code_row<BF16>(val[i], s, qmax);
  store_row8(orow, v * VEC, F, aligned, q);
}

__device__ __forceinline__ void store_scale(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_scale(__nv_bfloat16* p, float s) {
  *p = __float2bfloat16_rn(s);
}

// A block holds blockDim.x / (32 * wpr) rows, wpr warps a row; U vectors a
// lane a batch (the first batch stays in registers for pass 2).
template <typename XT, int U>
__global__ void __launch_bounds__(RW_THREADS)
act_quant_rows_kernel(const XT* __restrict__ x, int8_t* __restrict__ out,
                      XT* __restrict__ scale, int M, int F, int bits, int wpr,
                      bool aligned) {
  constexpr bool BF16 = sizeof(XT) == 2;
  __shared__ float red[RW_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = 32 * wpr;                                // lanes a row
  const int row = blockIdx.x * (blockDim.x / L) + warp / wpr;
  const int tl = (warp % wpr) * 32 + lane;               // lane within the row
  const bool live = row < M;
  const XT* xr = x + static_cast<size_t>(live ? row : 0) * F;
  int8_t* orow = out + static_cast<size_t>(row) * F;
  const int nvec = (F + VEC - 1) / VEC;

  // pass 1: max |x| of the row, all of a batch's loads issued first
  float val[U][VEC];
  float amax = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int v = tl + L * u;
    if (live && v < nvec) {
      load_row8(xr, v * VEC, F, aligned, val[u]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) val[u][i] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(val[u][i]));
  for (int v0 = L * U; live && v0 < nvec; v0 += L * U) {
    float t[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + tl + L * u;
      if (v < nvec) {
        load_row8(xr, v * VEC, F, aligned, t[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) t[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(t[u][i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) red[warp] = amax;
  __syncthreads();                                       // the row's warps' maxima
  const int w0 = warp - warp % wpr;
  for (int j = 0; j < wpr; ++j) amax = fmaxf(amax, red[w0 + j]);
  if (!live) return;

  // the scale, rounded as clamp_min(1e-8) and / qmax round on x's dtype
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float s = round_to(__fdiv_rn(round_to(fmaxf(amax, 1e-8f), BF16), qmax), BF16);
  if (tl == 0) store_scale(scale + row, s);

  // pass 2: the codes
  if (nvec <= L * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = tl + L * u;
      if (v < nvec) store_codes<BF16>(orow, v, F, aligned, val[u], s, qmax);
    }
  } else {
#pragma unroll 4
    for (int v = tl; v < nvec; v += L) {
      float t[VEC];
      load_row8(xr, v * VEC, F, aligned, t);
      store_codes<BF16>(orow, v, F, aligned, t, s, qmax);
    }
  }
}

// wpr and the batch U as the header says: one vector a lane up to 256 of
// them, else 8 warps and the fewest vectors a lane that hold the row.
template <typename XT>
cudaError_t launch_rows(const void* x, void* out, void* scale, int M, int F, int bits,
                        bool aligned, cudaStream_t stream) {
  const int nvec = (F + VEC - 1) / VEC;
  const int wpr = nvec > RW_THREADS ? RW_THREADS / 32 : (nvec + 31) / 32;
  const int rpb = RW_THREADS / (32 * wpr);               // rows a block
  const unsigned blocks = static_cast<unsigned>((M + rpb - 1) / rpb);
  const dim3 block(32 * wpr * rpb);
  const auto* xp = static_cast<const XT*>(x);
  auto* op = static_cast<int8_t*>(out);
  auto* sp = static_cast<XT*>(scale);
  if (nvec <= RW_THREADS)
    act_quant_rows_kernel<XT, 1><<<blocks, block, 0, stream>>>(xp, op, sp, M, F, bits, wpr,
                                                               aligned);
  else if (nvec <= 2 * RW_THREADS)
    act_quant_rows_kernel<XT, 2><<<blocks, block, 0, stream>>>(xp, op, sp, M, F, bits, wpr,
                                                               aligned);
  else
    act_quant_rows_kernel<XT, 4><<<blocks, block, 0, stream>>>(xp, op, sp, M, F, bits, wpr,
                                                               aligned);
  return cudaGetLastError();
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

// The row form: x (M, F) f32 or bf16 (x_kind) -> codes out (M, F) int8 and
// scale (M, 1) in x's dtype, computed in x's dtype.
extern "C" cudaError_t act_quant_signed_rows(const void* x, int x_kind, void* out,
                                             void* scale, int M, int F, int bits,
                                             int aligned, cudaStream_t stream) {
  if (M <= 0 || F <= 0 || bits < 2 || bits > 8 || scale == nullptr)
    return cudaErrorInvalidValue;
  if (x_kind == KIND_F32)
    return launch_rows<float>(x, out, scale, M, F, bits, aligned != 0, stream);
  if (x_kind == KIND_BF16)
    return launch_rows<__nv_bfloat16>(x, out, scale, M, F, bits, aligned != 0, stream);
  return cudaErrorInvalidValue;
}

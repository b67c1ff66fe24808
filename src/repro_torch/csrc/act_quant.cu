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
// The grouped form: one thread per 8 consecutive codes of one row: 32 bytes
// of f32 (two float4 loads) or 16 of bf16 (one uint4) in, one 8-byte store
// out, when F is a multiple of 8 and the pointers are aligned; scalar loads
// with bounds checks otherwise (the ragged tail of a row).  No row padding:
// rows and columns are masked.  The flattened (row, group of 8) index runs
// along grid.x.
//
// The flat forms (unsigned, one given scale, and the tensor form below): the
// codes do not depend on the row, so the kernel walks x as one array of
// N = M * F values in vectors of 8 (32 bytes of f32 as two float4 loads, or
// 16 of bf16 as one uint4, in; one 8-byte store out) when x is 16-byte and
// the codes 8-byte aligned, with scalar loads past the last whole vector
// (all of x when unaligned); no row or column index is computed.  Each
// thread issues FLAT_U = 4 independent vector loads, vectors T apart for a
// grid of T threads (a warp reads 512 or 1024 contiguous bytes a load),
// before its first store, in a grid-stride loop over a grid no larger than
// the blocks the card holds at once (SMs x resident blocks an SM): bytes in
// flight to cover HBM's latency, and no block launched only to retire.  A
// given scale is loaded once a thread.  The arithmetic is the header's:
// the signed code is the row form's code_row (below); f32 rows under bf16
// compute are first rounded to bf16 (bf16 rows are bf16 values already).
//
// The tensor form (act_quant_signed_tensor, the card's path of
// core.act_quant_codes_signed): s = max(amax|x|, 1e-8) / qmax over the
// whole tensor, rounded to x's dtype as the row form rounds it, and the
// codes, in ONE launch.  A cooperative launch keeps the grid co-resident
// (no more blocks than the card holds at once).  Each block takes the max
// of its vectors, keeping a thread's first FLAT_U vectors in registers,
// combines its warps' maxima, and adds it to the grid's with one atomicMax
// on the float's bits (exact: non-negative floats order as their bits).  A
// grid barrier (an arrival count) follows; each block reads the grid's max
// and computes s; pass 2 writes the codes, from registers for the kept
// vectors, re-reading the rest (from L2 where x fits there).  The three
// state words (max, arrivals, reads) are zero at rest: the last block to
// read the max puts them back to zero inside the same launch, so every
// call, and every replay of a captured graph, starts from zero without a
// memset launch.  Launches that may run at the same time need states of
// their own: the wrapper gives one to each stream and one to each call
// captured into a CUDA graph.
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
// grouped kernel's arithmetic (less its no-op conversions: code_row),
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

// Codes 0 .. 7 of q at p: one 8-byte store (p 8-byte aligned).
__device__ __forceinline__ void store8(int8_t* __restrict__ p, const int8_t (&q)[VEC]) {
  uint2 packed;
  int8_t* pb = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int i = 0; i < VEC; ++i) pb[i] = q[i];
  *reinterpret_cast<uint2*>(p) = packed;
}

// Codes c0 .. c0 + 7 of a row of F: one 8-byte store, or byte stores up to F.
__device__ __forceinline__ void store_row8(int8_t* __restrict__ orow, int c0, int F,
                                           bool aligned, const int8_t (&q)[VEC]) {
  if (aligned && c0 + VEC <= F) {
    store8(orow + c0, q);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (c0 + i < F) orow[c0 + i] = q[i];
  }
}

// Signed symmetric code of one value under scale s.
__device__ __forceinline__ int8_t code_signed(float x, float s, float qmax, bool bf16) {
  const float q = round_to(__fdiv_rn(round_to(x, bf16), round_to(s, bf16)), bf16);
  const float r = fminf(fmaxf(rintf(q), -qmax), qmax);
  return static_cast<int8_t>(__float2int_rn(r));
}

// The grouped form: scale[row * s_row_stride + col / rep].
template <typename XT, typename ST>
__global__ void __launch_bounds__(THREADS)
act_quant_grouped_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                         int8_t* __restrict__ out, int M, int F, int nvec, int s_row_stride,
                         int rep, int bits, bool bf16, bool aligned) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long long>(M) * nvec) return;
  const int row = static_cast<int>(t / nvec);
  const int c0 = static_cast<int>(t % nvec) * VEC;
  float v[VEC];
  load_row8(x + static_cast<size_t>(row) * F, c0, F, aligned, v);

  int8_t q[VEC];
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const ST* srow = scale + static_cast<size_t>(row) * s_row_stride;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = min(c0 + i, F - 1);
    q[i] = code_signed(v[i], to_float(srow[c / rep]), qmax, bf16);
  }
  store_row8(out + static_cast<size_t>(row) * F, c0, F, aligned, q);
}

template <typename XT, typename ST>
cudaError_t launch_grouped_typed(const void* x, const void* scale, void* out, int M, int F,
                                 int s_row_stride, int rep, int bits, int bf16, int aligned,
                                 cudaStream_t stream) {
  const int nvec = (F + VEC - 1) / VEC;
  const long long blocks = (static_cast<long long>(M) * nvec + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  act_quant_grouped_kernel<XT, ST><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale), static_cast<int8_t*>(out),
      M, F, nvec, s_row_stride, rep, bits, bf16 != 0, aligned != 0);
  return cudaGetLastError();
}

cudaError_t launch_grouped(const void* x, int x_kind, const void* scale, int s_kind,
                           void* out, int M, int F, int s_row_stride, int rep, int bits,
                           int bf16, int aligned, cudaStream_t stream) {
  if (M <= 0 || F <= 0 || rep <= 0 || bits < 1 || bits > 8) return cudaErrorInvalidValue;
  if (scale == nullptr) return cudaErrorInvalidValue;
  const bool xf = x_kind == KIND_F32, sf = s_kind == KIND_F32;
  if (!xf && x_kind != KIND_BF16) return cudaErrorInvalidValue;
  if (!sf && s_kind != KIND_BF16) return cudaErrorInvalidValue;
  if (xf && sf)
    return launch_grouped_typed<float, float>(x, scale, out, M, F, s_row_stride, rep, bits,
                                              bf16, aligned, stream);
  if (xf)
    return launch_grouped_typed<float, __nv_bfloat16>(x, scale, out, M, F, s_row_stride,
                                                      rep, bits, bf16, aligned, stream);
  if (sf)
    return launch_grouped_typed<__nv_bfloat16, float>(x, scale, out, M, F, s_row_stride,
                                                      rep, bits, bf16, aligned, stream);
  return launch_grouped_typed<__nv_bfloat16, __nv_bfloat16>(
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
// v rounded to bf16 (to nearest even) on its bits: __float2bfloat16_rn's
// value for every finite v, on the integer pipes (no conversion).
__device__ __forceinline__ float bf16_rne(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

template <bool BF16>
__device__ __forceinline__ int8_t code_row(float x, float s, float qmax) {
  float q = __fdiv_rn(x, s);
  if constexpr (BF16) q = bf16_rne(q);
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

// ---------------------------------------------------------------------------
// the flat forms: unsigned, one given scale, and the tensor form
// ---------------------------------------------------------------------------
constexpr int FLAT_THREADS = 256, FLAT_U = 4;

// Unsigned eq. (4) code of x, a value of the compute dtype, without the
// conversion pipe (a quarter of the FP32 rate, which bounded a first version
// of this kernel at the stem rows): the bf16 roundings on the bits, and
// floor(z) of 0 <= z < 2^22 as an add rounded down onto the integers of
// [2^23, 2^24).
template <bool BF16>
__device__ __forceinline__ int8_t code_unsigned(float x, float levels) {
  const float c = fminf(fmaxf(x, 0.f), 1.f);
  float y = __fmul_rn(c, levels);
  if constexpr (BF16) y = bf16_rne(y);
  float z = __fadd_rn(y, 0.5f);
  if constexpr (BF16) z = bf16_rne(z);
  const int r = __float_as_int(__fadd_rd(z, 12582912.0f)) - 0x4B400000;
  return static_cast<int8_t>(min(r, 127));
}

// v as a value of the compute dtype: f32 rows under bf16 compute round.
template <typename XT, bool BF16>
__device__ __forceinline__ float in_compute(float v) {
  if constexpr (BF16 && sizeof(XT) == 4) return bf16_rne(v);
  return v;
}

// SIGNED: codes under the one scale *scale; else the unsigned codes.
// n values; vectors of 8 when aligned.
template <typename XT, typename ST, bool SIGNED, bool BF16>
__global__ void __launch_bounds__(FLAT_THREADS)
act_quant_flat_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                      int8_t* __restrict__ out, long long n, int bits, bool aligned) {
  const long long T = static_cast<long long>(gridDim.x) * FLAT_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * FLAT_THREADS + threadIdx.x;
  float s = 0.f, lim;
  if constexpr (SIGNED) {
    s = round_to(to_float(*scale), BF16);
    lim = static_cast<float>((1 << (bits - 1)) - 1);
  } else {
    lim = static_cast<float>((1 << bits) - 1);
  }
  const auto code = [&](float v) -> int8_t {
    if constexpr (SIGNED) return code_row<BF16>(in_compute<XT, BF16>(v), s, lim);
    else return code_unsigned<BF16>(in_compute<XT, BF16>(v), lim);
  };
  const long long nvec = aligned ? n / VEC : 0;
  for (long long v0 = t0; v0 < nvec; v0 += FLAT_U * T) {
    float val[FLAT_U][VEC];
#pragma unroll
    for (int u = 0; u < FLAT_U; ++u)
      if (v0 + u * T < nvec) load8(x + (v0 + u * T) * VEC, val[u]);
#pragma unroll
    for (int u = 0; u < FLAT_U; ++u) {
      const long long v = v0 + u * T;
      if (v < nvec) {
        int8_t q[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] = code(val[u][i]);
        store8(out + v * VEC, q);
      }
    }
  }
  for (long long i = nvec * VEC + t0; i < n; i += T) out[i] = code(to_float(x[i]));
}

// The max of every block's m >= 0, for thread 0 of each block of a
// co-resident grid: one atomicMax on the bits, a barrier on the arrival
// count, the read; then the last block to read puts the three words back to
// zero (every block has left the barrier by then).
__device__ float grid_max(unsigned* state, float m) {
  atomicMax(state, __float_as_uint(m));
  __threadfence();
  atomicAdd(state + 1, 1u);
  while (*reinterpret_cast<volatile unsigned*>(state + 1) < gridDim.x) __nanosleep(32);
  __threadfence();
  const float g = __uint_as_float(*reinterpret_cast<volatile unsigned*>(state));
  __threadfence();
  if (atomicAdd(state + 2, 1u) == gridDim.x - 1) {
    state[0] = 0u;
    state[1] = 0u;
    state[2] = 0u;
  }
  return g;
}

// state: 3 words, zero at rest (the header's tensor form).
template <typename XT>
__global__ void __launch_bounds__(FLAT_THREADS)
act_quant_tensor_kernel(const XT* __restrict__ x, int8_t* __restrict__ out,
                        float* __restrict__ scale, unsigned* __restrict__ state,
                        long long n, int bits, bool aligned) {
  constexpr bool BF16 = sizeof(XT) == 2;
  __shared__ float red[FLAT_THREADS / 32];
  __shared__ float s_block;
  const long long T = static_cast<long long>(gridDim.x) * FLAT_THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * FLAT_THREADS + threadIdx.x;
  const long long nvec = aligned ? n / VEC : 0;

  // pass 1: max |x|; the thread's first FLAT_U vectors stay in registers
  float keep[FLAT_U][VEC];
#pragma unroll
  for (int u = 0; u < FLAT_U; ++u) {
    const long long v = t0 + u * T;
    if (v < nvec) {
      load8(x + v * VEC, keep[u]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) keep[u][i] = 0.f;
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int u = 0; u < FLAT_U; ++u)
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(keep[u][i]));
  for (long long v0 = t0 + FLAT_U * T; v0 < nvec; v0 += FLAT_U * T) {
    float t[FLAT_U][VEC];
#pragma unroll
    for (int u = 0; u < FLAT_U; ++u) {
      if (v0 + u * T < nvec) {
        load8(x + (v0 + u * T) * VEC, t[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) t[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < FLAT_U; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(t[u][i]));
  }
  for (long long i = nvec * VEC + t0; i < n; i += T) amax = fmaxf(amax, fabsf(to_float(x[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();

  // the grid's max (one block: its own), the scale
  if (threadIdx.x == 0) {
    for (int w = 1; w < FLAT_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
    if (gridDim.x > 1) amax = grid_max(state, amax);
    const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
    const float s = round_to(__fdiv_rn(round_to(fmaxf(amax, 1e-8f), BF16), qmax), BF16);
    s_block = s;
    if (blockIdx.x == 0) *scale = s;
  }
  __syncthreads();
  const float s = s_block;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);

  // pass 2: the codes, the kept vectors from registers, the rest read again
#pragma unroll
  for (int u = 0; u < FLAT_U; ++u) {
    const long long v = t0 + u * T;
    if (v < nvec) {
      int8_t q[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) q[i] = code_row<BF16>(keep[u][i], s, qmax);
      store8(out + v * VEC, q);
    }
  }
  for (long long v0 = t0 + FLAT_U * T; v0 < nvec; v0 += FLAT_U * T) {
    float t[FLAT_U][VEC];
#pragma unroll
    for (int u = 0; u < FLAT_U; ++u)
      if (v0 + u * T < nvec) load8(x + (v0 + u * T) * VEC, t[u]);
#pragma unroll
    for (int u = 0; u < FLAT_U; ++u) {
      const long long v = v0 + u * T;
      if (v < nvec) {
        int8_t q[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] = code_row<BF16>(t[u][i], s, qmax);
        store8(out + v * VEC, q);
      }
    }
  }
  for (long long i = nvec * VEC + t0; i < n; i += T)
    out[i] = code_row<BF16>(to_float(x[i]), s, qmax);
}

// Blocks of FLAT_THREADS threads that the card runs at once: SMs x the
// kernel's resident blocks an SM (by its registers), cached per device in
// `cache`, which the caller keeps for this one kernel (kernels of one
// function type differ in their registers).
template <typename K>
cudaError_t resident_blocks(K* kernel, int (&cache)[64], int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FLAT_THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// The grid over n values, at most `resident` blocks, each thread `per_thread`
// values or (unaligned) one.  The given-scale kernels take a vector a thread
// (every SM gets a share of the L2-resident shapes); the tensor form FLAT_U
// vectors a thread (the decode rows in one block, which skips the barrier).
unsigned flat_blocks(long long n, bool aligned, int per_thread, int resident) {
  const long long per_block = static_cast<long long>(FLAT_THREADS) * (aligned ? per_thread : 1);
  const long long want = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(want < resident ? (want > 0 ? want : 1) : resident);
}

template <typename XT, typename ST, bool SIGNED, bool BF16>
cudaError_t launch_flat_typed(const void* x, const void* scale, void* out, long long n,
                              int bits, bool aligned, cudaStream_t stream) {
  auto* kernel = act_quant_flat_kernel<XT, ST, SIGNED, BF16>;
  static int cache[64] = {};
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, cache, &resident);
  if (e != cudaSuccess) return e;
  kernel<<<flat_blocks(n, aligned, VEC, resident), FLAT_THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale), static_cast<int8_t*>(out),
      n, bits, aligned);
  return cudaGetLastError();
}

template <typename XT, typename ST, bool SIGNED>
cudaError_t launch_flat_xs(const void* x, const void* scale, void* out, long long n,
                           int bits, int bf16, int aligned, cudaStream_t stream) {
  if (bf16)
    return launch_flat_typed<XT, ST, SIGNED, true>(x, scale, out, n, bits, aligned != 0,
                                                   stream);
  return launch_flat_typed<XT, ST, SIGNED, false>(x, scale, out, n, bits, aligned != 0,
                                                  stream);
}

template <bool SIGNED>
cudaError_t launch_flat(const void* x, int x_kind, const void* scale, int s_kind, void* out,
                        int M, int F, int bits, int bf16, int aligned, cudaStream_t stream) {
  if (M <= 0 || F <= 0 || bits < 1 || bits > 8) return cudaErrorInvalidValue;
  if (SIGNED && scale == nullptr) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(M) * F;
  const bool xf = x_kind == KIND_F32, sf = !SIGNED || s_kind == KIND_F32;
  if (!xf && x_kind != KIND_BF16) return cudaErrorInvalidValue;
  if (SIGNED && !sf && s_kind != KIND_BF16) return cudaErrorInvalidValue;
  if (xf && sf)
    return launch_flat_xs<float, float, SIGNED>(x, scale, out, n, bits, bf16, aligned, stream);
  if (xf)
    return launch_flat_xs<float, __nv_bfloat16, SIGNED>(x, scale, out, n, bits, bf16,
                                                        aligned, stream);
  if (sf)
    return launch_flat_xs<__nv_bfloat16, float, SIGNED>(x, scale, out, n, bits, bf16,
                                                        aligned, stream);
  return launch_flat_xs<__nv_bfloat16, __nv_bfloat16, SIGNED>(x, scale, out, n, bits, bf16,
                                                              aligned, stream);
}

// The tensor form's cooperative launch: the grid no larger than the card
// holds at once, which the launch checks.
template <typename XT>
cudaError_t launch_tensor(const void* x, void* out, void* scale, void* state, long long n,
                          int bits, bool aligned, cudaStream_t stream) {
  auto* kernel = act_quant_tensor_kernel<XT>;
  static int cache[64] = {};
  int resident = 0;
  cudaError_t e = resident_blocks(kernel, cache, &resident);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(flat_blocks(n, aligned, FLAT_U * VEC, resident));
  cfg.blockDim = dim3(FLAT_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), static_cast<int8_t*>(out),
                         static_cast<float*>(scale), static_cast<unsigned*>(state), n, bits,
                         aligned);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

}  // namespace

// x: (M, F) f32 or bf16 (x_kind), contiguous; out: (M, F) int8.  bf16: 1
// rounds each intermediate to bf16.  aligned: 1 when x is 16-byte and out
// 8-byte aligned (vector loads and stores; F may be ragged).
extern "C" cudaError_t act_quant_unsigned(const void* x, int x_kind, void* out, int M,
                                          int F, int bits, int bf16, int aligned,
                                          cudaStream_t stream) {
  return launch_flat<false>(x, x_kind, nullptr, KIND_F32, out, M, F, bits, bf16, aligned,
                            stream);
}

// scale: one f32 or bf16 value (s_kind) on the device; aligned as above.
extern "C" cudaError_t act_quant_signed(const void* x, int x_kind, const void* scale,
                                        int s_kind, void* out, int M, int F, int bits,
                                        int bf16, int aligned, cudaStream_t stream) {
  return launch_flat<true>(x, x_kind, scale, s_kind, out, M, F, bits, bf16, aligned,
                           stream);
}

// The tensor form: x (M, F) f32 or bf16 (x_kind), contiguous -> codes out
// (M, F) int8 and the scale max(amax|x|, 1e-8) / qmax, a value of x's dtype,
// as one f32 at `scale`, computed in x's dtype; state: 3 unsigned words on
// the device, zero at rest (zero them once; the kernel leaves them zero);
// aligned as above.  One cooperative launch.
extern "C" cudaError_t act_quant_signed_tensor(const void* x, int x_kind, void* out,
                                               void* scale, void* state, int M, int F,
                                               int bits, int aligned, cudaStream_t stream) {
  if (M <= 0 || F <= 0 || bits < 2 || bits > 8 || scale == nullptr || state == nullptr)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(M) * F;
  if (x_kind == KIND_F32)
    return launch_tensor<float>(x, out, scale, state, n, bits, aligned != 0, stream);
  if (x_kind == KIND_BF16)
    return launch_tensor<__nv_bfloat16>(x, out, scale, state, n, bits, aligned != 0,
                                        stream);
  return cudaErrorInvalidValue;
}

// scale: (M, G) f32 or bf16 (s_kind), G | F.  aligned: 1 when F % 8 == 0,
// x is 16-byte and out 8-byte aligned.
extern "C" cudaError_t act_quant_signed_grouped(const void* x, int x_kind, const void* scale,
                                                int s_kind, void* out, int M, int F, int G,
                                                int bits, int bf16, int aligned,
                                                cudaStream_t stream) {
  if (G <= 0 || F % G != 0) return cudaErrorInvalidValue;
  return launch_grouped(x, x_kind, scale, s_kind, out, M, F, G, F / G, bits, bf16, aligned,
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

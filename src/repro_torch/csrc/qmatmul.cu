// Packed low-bit weight matmul: Y = X . W^T * alpha[n] (+ bias[n]).
//
// Replaces the TPU kernels repro/kernels/ternary_matmul.py:ternary_matmul
// (2-bit ternary fields, 16 per int32 word) and
// repro/kernels/packed_matmul.py:packed_matmul (k in {2, 4, 8}-bit signed
// fields, 32/k per word): one template over the field width, two entry
// points.
//
// X is (M, K) int8 activation codes (int32 accumulation, __dp4a on groups of
// four codes) or float/bf16 activations (f32 accumulation).  W^T is
// (N, K*BITS/32) int32 words of two's-complement fields, little-endian.
//
// What bounds it on an H100: at the serving shapes (M = 1..32 rows, N, K
// <= 1536) the work is a few MFLOP over ~0.1-0.6 MB of packed weights, so
// the bound is the bytes (weights read once, 16/BITS times fewer than bf16)
// and, in practice, the launch itself.  Design: one 256-thread block per
// (BM x BN) output tile; each K step decodes the block's W words into int8 in
// shared memory once and reuses them for all BM rows; the ragged M, N and K
// edges are masked in the kernel (no padding copies).  The epilogue uses
// __fmul_rn / __fadd_rn so that no FMA contraction changes the rounding:
// the int path's output is bit-equal to the plain PyTorch version.
// Tensor cores (wgmma) and pipelined loads are later work.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 64, THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;            // 4 row groups of threads
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;    // 8 output rows a thread
constexpr int WPAD = 4;   // W row pad: 68-byte rows keep dp4a reads conflict-free

template <int BITS>
__device__ __forceinline__ int8_t field(uint32_t word, int j) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int v = static_cast<int>((word >> (j * BITS)) & MASK);
  return static_cast<int8_t>(v >= (1 << (BITS - 1)) ? v - (1 << BITS) : v);
}

// Decode the block's W tile (BN rows x BK codes) into int8 in shared memory.
// Words past N or past the row's end decode to zero codes.
template <int BITS>
__device__ __forceinline__ void load_w_tile(int8_t (*w_s)[BK + WPAD],
                                            const int32_t* __restrict__ w,
                                            int N, int KW, int n0, int kw0) {
  constexpr int CPW = 32 / BITS;   // codes per word
  constexpr int WPR = BK / CPW;    // words per tile row
  for (int i = threadIdx.x; i < BN * WPR; i += THREADS) {
    const int r = i / WPR, c = i % WPR;
    const int n = n0 + r, kw = kw0 + c;
    const uint32_t word =
        (n < N && kw < KW) ? static_cast<uint32_t>(w[static_cast<size_t>(n) * KW + kw]) : 0u;
#pragma unroll
    for (int j = 0; j < CPW; ++j) w_s[r][c * CPW + j] = field<BITS>(word, j);
  }
}

__device__ __forceinline__ void store_out(float* __restrict__ out, int m, int n, int N,
                                          float acc, float a, const float* __restrict__ bias) {
  float o = __fmul_rn(acc, a);
  if (bias != nullptr) o = __fadd_rn(o, bias[n]);
  out[static_cast<size_t>(m) * N + n] = o;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
qmm_int8_kernel(const int8_t* __restrict__ x, const int32_t* __restrict__ w,
                const float* __restrict__ alpha, const float* __restrict__ bias,
                float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t x_s[BM][BK];
  __shared__ __align__(16) int8_t w_s[BN][BK + WPAD];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % BN, ty = threadIdx.x / BN;   // ty is warp-uniform
  const int KW = K / (32 / BITS);
  int acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      x_s[r][c] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : static_cast<int8_t>(0);
    }
    load_w_tile<BITS>(w_s, w, N, KW, n0, k0 / (32 / BITS));
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; k += 4) {
      const int w4 = *reinterpret_cast<const int*>(&w_s[tx][k]);
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int r = ty + ROW_GROUPS * i;
        if (m0 + r < M)
          acc[i] = __dp4a(*reinterpret_cast<const int*>(&x_s[r][k]), w4, acc[i]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const float a = alpha[n];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + ty + ROW_GROUPS * i;
    if (m < M) store_out(out, m, n, N, __int2float_rn(acc[i]), a, bias);
  }
}

template <int BITS, typename XT>
__global__ void __launch_bounds__(THREADS)
qmm_float_kernel(const XT* __restrict__ x, const int32_t* __restrict__ w,
                 const float* __restrict__ alpha, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float x_s[BM][BK];
  __shared__ __align__(16) int8_t w_s[BN][BK + WPAD];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % BN, ty = threadIdx.x / BN;
  const int KW = K / (32 / BITS);
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      x_s[r][c] = (m < M && k < K) ? to_float(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    load_w_tile<BITS>(w_s, w, N, KW, n0, k0 / (32 / BITS));
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float wv = static_cast<float>(w_s[tx][k]);
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int r = ty + ROW_GROUPS * i;
        if (m0 + r < M) acc[i] += x_s[r][k] * wv;
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const float a = alpha[n];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + ty + ROW_GROUPS * i;
    if (m < M) store_out(out, m, n, N, acc[i], a, bias);
  }
}

template <int BITS>
cudaError_t launch(const void* x, int x_kind, const void* w, const void* alpha,
                   const void* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % (32 / BITS) != 0) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* ap = static_cast<const float*>(alpha);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  switch (x_kind) {
    case KIND_INT8:
      qmm_int8_kernel<BITS><<<grid, THREADS, 0, stream>>>(
          static_cast<const int8_t*>(x), wp, ap, bp, op, M, N, K);
      break;
    case KIND_F32:
      qmm_float_kernel<BITS, float><<<grid, THREADS, 0, stream>>>(
          static_cast<const float*>(x), wp, ap, bp, op, M, N, K);
      break;
    case KIND_BF16:
      qmm_float_kernel<BITS, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), wp, ap, bp, op, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Ternary weights: 2-bit fields {00: 0, 01: +1, 11: -1}, alpha = TWN scale.
extern "C" cudaError_t ternary_matmul(const void* x, int x_kind, const void* w,
                                      const void* alpha, const void* bias, void* out,
                                      int M, int N, int K, cudaStream_t stream) {
  return launch<2>(x, x_kind, w, alpha, bias, out, M, N, K, stream);
}

// k-bit signed integer weights, k in {2, 4, 8}.
extern "C" cudaError_t packed_matmul(const void* x, int x_kind, const void* w,
                                     const void* scale, const void* bias, void* out,
                                     int M, int N, int K, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2>(x, x_kind, w, scale, bias, out, M, N, K, stream);
    case 4: return launch<4>(x, x_kind, w, scale, bias, out, M, N, K, stream);
    case 8: return launch<8>(x, x_kind, w, scale, bias, out, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

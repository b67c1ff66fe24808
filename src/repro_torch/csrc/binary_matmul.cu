// Binary (1x1) matmul, XNOR + popcount: the paper's Fig. 1 PE.
//
//   Y[m, n] = (K - 2 * popcount(A[m] XOR W[n])) * alpha[n] (+ bias[n])
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py:binary_matmul.
// Both operands are +/-1 vectors stored as {1, 0} bits, 32 per int32 word,
// little-endian along K (core/packing.pack_binary_pm1): A is (M, K/32), W^T
// is (N, K/32), K a multiple of 32.  sum_k a_k * w_k over +/-1 values is
// K - 2 * (number of positions where the bits differ), so one XOR and one
// POPC settle 32 products, exactly, in int32.
//
// The TPU kernel carries its mismatch count across a sequential K grid
// axis in VMEM scratch; CUDA blocks run in no order, so here the K loop
// runs inside the block and the count stays in registers.
//
// What bounds it on an H100: at the decode shapes (M = 4 rows, N, K <=
// 1536) the work is the packed weight, N*K/8 bytes (41 KB at 576 x 576:
// 0.012 us at 3.35 TB/s), and 2*M*N*K +/-1 products that the popcount does
// 32 at a time; in practice the launch and the latency of a short K loop
// bound it.  Design: one 256-thread block per (BM x BN) output tile; per K
// step the block stages BM rows of A words and BN rows of W words in shared
// memory once (W rows padded to 17 words, so the 32 lanes of a warp read
// 32 banks; A words are warp-wide broadcasts) and each thread sums
// __popc(a ^ w) for 8 rows of one column in int32 registers.  Words past
// K, and rows past M or N, load as zeros (XOR 0: no mismatch) and are not
// stored.  The epilogue rounds exactly as the plain PyTorch version
// (__fmul_rn, __fadd_rn: no FMA contraction), so the two are bit-equal.
// M tiles run along grid.x (up to 2^31 - 1 tiles: any CNN batch), N tiles
// along grid.y.  The tensor cores' 1-bit mma (m16n8k256 .xor.popc) is
// later work.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BKW = 16, THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;            // 4 row groups of threads
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;    // 8 output rows a thread
constexpr int WPAD = 1;                             // W row pad: 17 words

__global__ void __launch_bounds__(THREADS)
xnor_popc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
                 const float* __restrict__ alpha, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int KW) {
  __shared__ uint32_t a_s[BM][BKW];
  __shared__ uint32_t w_s[BN][BKW + WPAD];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % BN, ty = threadIdx.x / BN;   // ty is warp-uniform
  int acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0;

  for (int kw0 = 0; kw0 < KW; kw0 += BKW) {
    for (int i = threadIdx.x; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW, m = m0 + r, kw = kw0 + c;
      a_s[r][c] = (m < M && kw < KW) ? a[static_cast<size_t>(m) * KW + kw] : 0u;
    }
    for (int i = threadIdx.x; i < BN * BKW; i += THREADS) {
      const int r = i / BKW, c = i % BKW, n = n0 + r, kw = kw0 + c;
      w_s[r][c] = (n < N && kw < KW) ? w[static_cast<size_t>(n) * KW + kw] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BKW; ++c) {
      const uint32_t wv = w_s[tx][c];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        acc[i] += __popc(a_s[ty + ROW_GROUPS * i][c] ^ wv);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const int K = KW * 32;
  const float al = alpha[n];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + ty + ROW_GROUPS * i;
    if (m >= M) continue;
    float o = __fmul_rn(__int2float_rn(K - 2 * acc[i]), al);
    if (bias != nullptr) o = __fadd_rn(o, bias[n]);
    out[static_cast<size_t>(m) * N + n] = o;
  }
}

}  // namespace

// a: (M, K/32) int32 words, w: (N, K/32) int32 words, alpha: (N,) f32,
// bias: (N,) f32 or null, out: (M, N) f32.
extern "C" cudaError_t binary_matmul(const void* a, const void* w, const void* alpha,
                                     const void* bias, void* out, int M, int N, int K,
                                     cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || alpha == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  xnor_popc_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(alpha), static_cast<const float*>(bias),
      static_cast<float*>(out), M, N, K / 32);
  return cudaGetLastError();
}

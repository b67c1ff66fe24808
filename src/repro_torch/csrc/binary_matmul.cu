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
// runs inside the block and the counts stay in registers.  One launch per
// call, one of two kernels chosen in launch() from M and N:
//
// * M <= M_SMALL and M * N <= ROWS_MAX_MN (decode steps, 1x1 prefill
//   chunks): xnor_rows_kernel on the CUDA cores.  What bounds it is
//   latency: a layer's seven decode projections move 0.44 MB of packed
//   weights, 0.13 us at 3.35 TB/s, and 2*M*N*K products that __popc does 32
//   at a time.  Each output column belongs to a group of G lanes of one
//   warp (G = the column's W^T chunks rounded up to a power of two, at
//   most 32) and each block to RT = 8 output rows (blockIdx.y), so N = 192
//   already gives 24 blocks a row tile.  Every lane issues all its W^T
//   loads (16-, 8- or 4-byte chunks: the widest that the row's word count
//   and the pointers allow) before it uses any, reads the rows' A chunks
//   through L1 (A is 4 x 72 to 192 bytes at decode) and sums __popc(a ^ w)
//   in int32; the rows carry no branch, so their loads interleave.  The G
//   partial counts of a column are added by int32 warp shuffles, exact in
//   any order.  No serial K loop, no __syncthreads.
//
// * otherwise (the CNN convs, M = batch x output pixels; AlexNet's fc):
//   xnor_tc_kernel on the tensor cores' 1-bit product, mma.sync m16n8k256
//   .b1 with .and.popc.  The .xor.popc form is in the PTX ISA, but sm_90a
//   runs it as an emulation around the AND product (SASS shows
//   BMMA.AND.POPC; tools/probe_b1_mma.py times it at a sixth of .and.popc's
//   rate on an H100, PERF.md section 6), so the kernel counts popc(a AND w)
//   and turns it into the mismatch count as
//   popc(a) + popc(w) - 2 popc(a AND w), exact in int32: popc(a) of the
//   rows and popc(w) of the columns come from the same MMA against an
//   all-ones operand, so they need no other code path.  At these rates the
//   products are nearly free: the bound is bytes, the f32 output the
//   largest stream (1568 x 256 x 4 bytes at ResNet-34 stage 3, batch 8).
//   Blocks of 64 x 64 outputs (4 warps of 32 x 32) take K in stages of 16
//   words (two k256 steps), copied by cp.async (16, 8 or 4 bytes, as the
//   rows allow) into a 4-stage ring in shared memory, three in flight
//   while one computes; fragments come by ldmatrix (a lane (g, t) holds
//   words t and t + 4 of rows g and g + 8, exactly the b1 fragment), with
//   rows padded to 20 words so that the eight rows of a phase fall on
//   distinct banks.  float2 stores.
//
// The split is a fixed constant from both kernels timed in chip_smoke.py
// over one layer's seven decode projections (PERF.md section 6).  Both kernels
// take any M, N and K (a multiple of 32): rows and columns past M and N,
// and words past K, load as zeros (no mismatch, no AND) and are not
// stored.  The epilogue rounds exactly as the plain PyTorch version
// (__fmul_rn of the int count's float, then __fadd_rn of the bias: no FMA
// contraction), so both kernels are bit-equal to it.  M tiles run along
// grid.x (up to 2^31 - 1 tiles: any CNN batch), N tiles along grid.y.
#include "common.cuh"

namespace {

__device__ __forceinline__ void store_out(float* __restrict__ out, int m, int n, int N,
                                          int K, int acc, const float* __restrict__ alpha,
                                          const float* __restrict__ bias) {
  float o = __fmul_rn(__int2float_rn(K - 2 * acc), alpha[n]);
  if (bias != nullptr) o = __fadd_rn(o, bias[n]);
  out[static_cast<size_t>(m) * N + n] = o;
}

// ---------------------------------------------------------------------------
// M * N small: many blocks, a column's words over a group of lanes
// ---------------------------------------------------------------------------
constexpr int M_SMALL = 64;
constexpr int ROWS_MAX_MN = M_SMALL * 1536;   // the widest decode projection's M * N
constexpr int ROWS_THREADS = 128;
constexpr int RT = 8;     // output rows of a block (blockIdx.y), summed at once
constexpr int JB = 4;     // W^T chunks a lane holds in registers

// VEC words of p (VEC = 4, 2 or 1: a 16-, 8- or 4-byte load)
template <int VEC>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
xnor_rows_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
                 const float* __restrict__ alpha, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int KW, int lg) {
  const int G = 1 << lg;                         // lanes a column
  const int lane_g = threadIdx.x & (G - 1);
  const int n = (blockIdx.x * ROWS_THREADS + threadIdx.x) >> lg;
  const bool live = n < N;
  const int m0 = blockIdx.y * RT, rows = min(RT, M - m0);
  const int C = KW / VEC;                        // chunks a row
  const int nb = (C + G * JB - 1) / (G * JB);    // batches of JB chunks a lane
  const uint32_t* wrow = w + static_cast<size_t>(live ? n : 0) * KW;

  int acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0;
  for (int b = 0; b < nb; ++b) {
    uint32_t wr[JB][VEC];
#pragma unroll
    for (int j = 0; j < JB; ++j) {               // every W load before any use
      const int c = lane_g + (b * JB + j) * G;
      if (live && c < C) load_words<VEC>(wrow + c * VEC, wr[j]);
    }
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const int c = lane_g + (b * JB + j) * G;
      if (!live || c >= C) continue;
      // rows past M read row m0 and are not stored: no branch, so the
      // rows' loads and popcounts interleave
      const uint32_t* ac = a + static_cast<size_t>(m0) * KW + c * VEC;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        uint32_t av[VEC];
        load_words<VEC>(ac + static_cast<size_t>(i < rows ? i : 0) * KW, av);
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[i] += __popc(av[t] ^ wr[j][t]);
      }
    }
  }
  // the G partial counts of each row, across the column's lanes (exact)
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (!live || lane_g != 0) return;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < rows) store_out(out, m0 + i, n, N, KW * 32, acc[i], alpha, bias);
}

// ---------------------------------------------------------------------------
// the rest: 1-bit tensor cores
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64, TC_BN = 64, TC_THREADS = 128, TC_STAGES = 4;
constexpr int TC_BKW = 16;                 // K words a stage: two k256 steps
constexpr int TC_LD = TC_BKW + 4;          // smem row: 20 words (80 bytes)

// d += popc(a AND b) over a 16 x 256 (row) by 256 x 8 (col) 1-bit tile
__device__ __forceinline__ void mma_b1_and(int (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// VEC words global -> shared, zero-filled when !valid
template <int VEC>
__device__ __forceinline__ void cp_async_words(uint32_t dst, const uint32_t* src, bool valid) {
  if constexpr (VEC == 4) cp_async16(dst, src, valid);
  else if constexpr (VEC == 2) cp_async8(dst, src, valid);
  else cp_async4(dst, src, valid);
}

template <int VEC>
__global__ void __launch_bounds__(TC_THREADS)
xnor_tc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
               const float* __restrict__ alpha, const float* __restrict__ bias,
               float* __restrict__ out, int M, int N, int KW) {
  __shared__ __align__(16) uint32_t as[TC_STAGES][TC_BM][TC_LD];
  __shared__ __align__(16) uint32_t ws[TC_STAGES][TC_BN][TC_LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_blk = blockIdx.x * TC_BM, n_blk = blockIdx.y * TC_BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int T = (KW + TC_BKW - 1) / TC_BKW;

  auto load_stage = [&](int t) {
    const int s = t % TC_STAGES, kw0 = t * TC_BKW;
    constexpr int P = TC_BKW / VEC;              // pieces a row
    for (int i = tid; i < (TC_BM + TC_BN) * P; i += TC_THREADS) {
      const int r = i / P, kw = kw0 + (i % P) * VEC;
      const bool is_a = r < TC_BM;
      const int row = is_a ? m_blk + r : n_blk + r - TC_BM;
      const bool ok = row < (is_a ? M : N) && kw < KW;
      const uint32_t* base = is_a ? a : w;
      uint32_t* dst = is_a ? &as[s][r][kw - kw0] : &ws[s][r - TC_BM][kw - kw0];
      cp_async_words<VEC>(smem_addr(dst), ok ? base + static_cast<size_t>(row) * KW + kw : base,
                          ok);
    }
  };

  // acc[mi][ni]: popc(a AND w); pa[mi]: popc(a) of the rows (B = ones);
  // pw[ni]: popc(w) of the columns (A = ones).  Words past K, rows past M
  // and columns past N are zeros: they add nothing to any of the three.
  int acc[2][4][4], pa[2][4], pw[4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[i][e] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][e] = 0;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pw[j][e] = 0;
  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < T) load_stage(s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();              // stage t landed; every warp is done with t-1
    if (t + TC_STAGES - 1 < T) load_stage(t + TC_STAGES - 1);
    cp_async_commit();
    const int s = t % TC_STAGES;
#pragma unroll
    for (int kk = 0; kk < TC_BKW; kk += 8) {     // one k256 step: 8 words a row
      // lane (g, t) of a fragment holds words t and t + 4 of rows g, g + 8
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], smem_addr(&as[s][wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                       [kk + (lane >> 4) * 4]));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4(r, smem_addr(&ws[s][wn + nj * 16 + (lane & 7) + (lane >> 4) * 8]
                                   [kk + ((lane >> 3) & 1) * 4]));
        bf[2 * nj][0] = r[0]; bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2]; bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_b1_and(pa[mi], af[mi], ~0u, ~0u);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_b1_and(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_b1_and(pw[ni], ones, bf[ni][0], bf[ni][1]);
    }
  }

  // lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each tile;
  // popc(a XOR w) = popc(a) + popc(w) - 2 popc(a AND w), exact in int32
  const int K = KW * 32;
  const bool pairs = (N & 1) == 0;               // 8-byte aligned float2 stores
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m_blk + wm + mi * 16 + (lane >> 2) + h * 8;
        const int n = n_blk + wn + ni * 8 + (lane & 3) * 2;
        if (m >= M) continue;
        const int x0 = pa[mi][2 * h] + pw[ni][0] - 2 * acc[mi][ni][2 * h];
        const int x1 = pa[mi][2 * h] + pw[ni][1] - 2 * acc[mi][ni][2 * h + 1];
        if (pairs && n + 1 < N) {
          float2 o = make_float2(__fmul_rn(__int2float_rn(K - 2 * x0), alpha[n]),
                                 __fmul_rn(__int2float_rn(K - 2 * x1), alpha[n + 1]));
          if (bias != nullptr)
            o = make_float2(__fadd_rn(o.x, bias[n]), __fadd_rn(o.y, bias[n + 1]));
          *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * N + n) = o;
        } else {
          if (n < N) store_out(out, m, n, N, K, x0, alpha, bias);
          if (n + 1 < N) store_out(out, m, n + 1, N, K, x1, alpha, bias);
        }
      }
}

template <int VEC>
cudaError_t launch_tc(const uint32_t* a, const uint32_t* w, const float* alpha,
                      const float* bias, float* out, int M, int N, int KW,
                      cudaStream_t stream) {
  const int bx = (M + TC_BM - 1) / TC_BM;       // M tiles along grid.x: any CNN batch
  const int by = (N + TC_BN - 1) / TC_BN;
  if (by > 65535) return cudaErrorInvalidValue;
  xnor_tc_kernel<VEC><<<dim3(bx, by), TC_THREADS, 0, stream>>>(a, w, alpha, bias, out, M, N,
                                                                KW);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum Variant : int { VARIANT_AUTO = -1, VARIANT_ROWS = 0, VARIANT_WIDE = 1 };

template <int VEC>
cudaError_t launch_rows(const uint32_t* a, const uint32_t* w, const float* alpha,
                        const float* bias, float* out, int M, int N, int KW,
                        cudaStream_t stream) {
  const int chunks = KW / VEC;
  int lg = 0;                                    // G = 2^lg lanes a column
  while ((1 << lg) < chunks && lg < 5) ++lg;
  const long long bx = ((static_cast<long long>(N) << lg) + ROWS_THREADS - 1) / ROWS_THREADS;
  const int by = (M + RT - 1) / RT;
  if (bx > 2147483647LL || by > 65535) return cudaErrorInvalidValue;
  xnor_rows_kernel<VEC><<<dim3(static_cast<unsigned>(bx), by), ROWS_THREADS, 0, stream>>>(
      a, w, alpha, bias, out, M, N, KW, lg);
  return cudaGetLastError();
}

cudaError_t launch(const void* a_, const void* w_, const void* alpha, const void* bias,
                   void* out, int M, int N, int K, int variant, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || alpha == nullptr)
    return cudaErrorInvalidValue;
  const auto* a = static_cast<const uint32_t*>(a_);
  const auto* w = static_cast<const uint32_t*>(w_);
  const auto* al = static_cast<const float*>(alpha);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  const int KW = K / 32;
  if (variant == VARIANT_AUTO)
    variant = M <= M_SMALL && static_cast<long long>(M) * N <= ROWS_MAX_MN ? VARIANT_ROWS
                                                                          : VARIANT_WIDE;
  // the widest load that every row start allows
  const auto aligned = [&](int bytes) {
    return (KW * 4) % bytes == 0 && reinterpret_cast<uintptr_t>(a) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(w) % bytes == 0;
  };
  if (variant == VARIANT_ROWS) {
    if (aligned(16)) return launch_rows<4>(a, w, al, bi, o, M, N, KW, stream);
    if (aligned(8)) return launch_rows<2>(a, w, al, bi, o, M, N, KW, stream);
    return launch_rows<1>(a, w, al, bi, o, M, N, KW, stream);
  }
  if (variant == VARIANT_WIDE) {
    if (aligned(16)) return launch_tc<4>(a, w, al, bi, o, M, N, KW, stream);
    if (aligned(8)) return launch_tc<2>(a, w, al, bi, o, M, N, KW, stream);
    return launch_tc<1>(a, w, al, bi, o, M, N, KW, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a: (M, K/32) int32 words, w: (N, K/32) int32 words, alpha: (N,) f32,
// bias: (N,) f32 or null, out: (M, N) f32.
extern "C" cudaError_t binary_matmul(const void* a, const void* w, const void* alpha,
                                     const void* bias, void* out, int M, int N, int K,
                                     cudaStream_t stream) {
  return launch(a, w, alpha, bias, out, M, N, K, VARIANT_AUTO, stream);
}

// One named kernel, 0 = rows, 1 = wide, whatever M is: the tuning cache's
// picks (kernels/tuning.py) and chip_smoke.py.
extern "C" cudaError_t binary_matmul_variant(const void* a, const void* w, const void* alpha,
                                             const void* bias, void* out, int M, int N,
                                             int K, int variant, cudaStream_t stream) {
  if (variant != VARIANT_ROWS && variant != VARIANT_WIDE) return cudaErrorInvalidValue;
  return launch(a, w, alpha, bias, out, M, N, K, variant, stream);
}

// The largest M that the rows kernel takes in the wrapper's calls (and
// then only while M * N <= M_SMALL * 1536).
extern "C" int binary_matmul_m_small() { return M_SMALL; }

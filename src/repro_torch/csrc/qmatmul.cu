// Packed low-bit weight matmul: Y = X . W^T * alpha[n] (+ bias[n]).
//
// Replaces the TPU kernels repro/kernels/ternary_matmul.py:ternary_matmul
// (2-bit ternary fields, 16 per int32 word) and
// repro/kernels/packed_matmul.py:packed_matmul (k in {2, 4, 8}-bit signed
// fields, 32/k per word): one template over the field width, two entry
// points.  W^T is (N, K*BITS/32) int32 words of two's-complement fields,
// little-endian; every field is sign-extended (the most negative one, -2 /
// -8 / -128, included).  X is (M, K) int8 activation codes (int32 sums) or
// float/bf16 activations (f32 sums).
//
// int8 codes take one of two kernels, chosen by launch_int8() from M and N,
// one launch per call either way:
//
// * M <= M_SMALL and M * N <= ROWS_MAX_MN (decode steps, prefill chunks, a
//   short whole prompt, AlexNet's fc layers at batch 8):
//   qmm_int8_rows_kernel.  What bounds
//   it is latency, not bytes: a layer's seven decode projections move
//   ~0.6 MB of packed weights, 0.2 us at 3.35 TB/s, so a call should cost
//   one device-memory round trip, not one per K step.  Each output column
//   belongs to a group of G lanes of one warp (G = the column's W^T chunks
//   rounded up to a power of two, at most 32) and each block to RT = 8
//   output rows (blockIdx.y), so N = 192 already gives 24 blocks a row tile
//   and every row tile more.  Every lane issues all its W^T loads (16-byte
//   chunks: 64 ternary, 32 4-bit or 16 8-bit codes) before it uses any,
//   decodes the fields in registers into int8 quads in K order (shift and
//   mask, sign by one multiply, a byte_perm transpose; decode_quads), and
//   runs __dp4a against the x rows read through L1 (x is 4 x 576 bytes at
//   decode): the tile's rows carry no branch, so their loads and dp4a
//   chains interleave.  The G partial sums of a column are added by warp
//   shuffles in int32, exact in any order.  There is no serial K loop and
//   no __syncthreads; K is not split across blocks.
//
// * otherwise (whole-prompt prefill, Model.forward, the CNN convs,
//   AlexNet's fc layers at batch 64): qmm_int8_mma_kernel on the int8 tensor cores, mma.sync m16n8k32 s8 x s8
//   -> s32.  Blocks of 64 x 64 outputs (4 warps of 32 x 32), so the CNN
//   shapes give 100 (1568 x 256) to 392 (25088 x 64) blocks.  K tiles of 128
//   codes are copied by cp.async into a 4-stage ring in dynamic shared
//   memory (x rows and the raw W^T words), three tiles in flight while one
//   computes; each W^T tile is decoded once into int8 in shared memory
//   (rows padded by 16 bytes, so ldmatrix reads without bank conflicts),
//   where a W^T row along K is the .col B operand as it stands; float2
//   stores.  Bound there: the bytes at the conv shapes and Model.forward's
//   (the f32 output is the largest stream).
//
// The split, from both kernels timed in chip_smoke.py (PERF.md, PR 17):
// on the seven decode projections the rows kernel is faster up to M = 64
// at every width and the tensor cores at 128; at AlexNet's fc shapes (N =
// 4096, K = 4096 and 9216) the rows kernel is faster at M = 8 and 4x
// slower at 64.  The rows kernel's work grows with M * N over a fixed
// machine, the tensor cores' time at small M with K alone, so the bound is
// on M * N: M_SMALL rows of the widest decode projection.  Both kernels
// take any M, N and K (a multiple of 32/BITS): ragged edges are
// zero-filled or clamped and the stores masked.  16-byte loads need
// 16-byte aligned x and W^T and W^T rows of a multiple of 16 bytes;
// otherwise (e.g. 2-bit K = 592) both run word-wise (4-byte W loads and
// cp.async), which needs x aligned to the bytes of one word's codes (any
// row of a contiguous int8 tensor is).
//
// |x| <= 128, |w| <= 128 and K <= 2^16 keep the int32 sums exact, and the
// epilogue is __fmul_rn(acc, alpha) then __fadd_rn(bias), no FMA
// contraction, so the int path's output is bit-equal to the plain PyTorch
// version.
//
// Float activations (reached by no precision of the menu, only by direct
// calls) stay on the CUDA cores: qmm_float_kernel, one 256-thread block per
// 32 x 64 output tile, W decoded into shared memory per K step of 64.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// field decode
// ---------------------------------------------------------------------------
// The fields of 16 bytes' worth of K (one word at 2 bits, two at 4, four at
// 8) as int8 quads in K order: quad j holds codes 4j..4j+3, low byte first.
// tests/test_torch_qmatmul_decode.py replays this arithmetic bit for bit.
template <int BITS>
__device__ __forceinline__ void decode_quads(const uint32_t* wd, uint32_t (&q)[4]);

template <>
__device__ __forceinline__ void decode_quads<2>(const uint32_t* wd, uint32_t (&q)[4]) {
  uint32_t s[4];   // s[i] = fields i, i+4, i+8, i+12 (one a byte), sign-extended
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t f = (wd[0] >> (2 * i)) & 0x03030303u;
    s[i] = f | ((f & 0x02020202u) * 0x7Eu);        // bit 1 set: | 0xFC
  }
  const uint32_t a = __byte_perm(s[0], s[1], 0x5140);   // f0 f1 f4 f5
  const uint32_t b = __byte_perm(s[0], s[1], 0x7362);   // f8 f9 f12 f13
  const uint32_t c = __byte_perm(s[2], s[3], 0x5140);   // f2 f3 f6 f7
  const uint32_t d = __byte_perm(s[2], s[3], 0x7362);   // f10 f11 f14 f15
  q[0] = __byte_perm(a, c, 0x5410);
  q[1] = __byte_perm(a, c, 0x7632);
  q[2] = __byte_perm(b, d, 0x5410);
  q[3] = __byte_perm(b, d, 0x7632);
}

template <>
__device__ __forceinline__ void decode_quads<4>(const uint32_t* wd, uint32_t (&q)[4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t e = wd[i] & 0x0F0F0F0Fu;               // fields 0 2 4 6
    uint32_t o = (wd[i] >> 4) & 0x0F0F0F0Fu;        // fields 1 3 5 7
    e |= (e & 0x08080808u) * 0x1Eu;                 // bit 3 set: | 0xF0
    o |= (o & 0x08080808u) * 0x1Eu;
    q[2 * i] = __byte_perm(e, o, 0x5140);
    q[2 * i + 1] = __byte_perm(e, o, 0x7362);
  }
}

template <>
__device__ __forceinline__ void decode_quads<8>(const uint32_t* wd, uint32_t (&q)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = wd[i];
}

__device__ __forceinline__ void store_out(float* __restrict__ out, int m, int n, int N,
                                          float acc, float a, const float* __restrict__ bias) {
  float o = __fmul_rn(acc, a);
  if (bias != nullptr) o = __fadd_rn(o, bias[n]);
  out[static_cast<size_t>(m) * N + n] = o;
}

// ---------------------------------------------------------------------------
// int8 codes, M * N small: many blocks, loads up front, dp4a
// ---------------------------------------------------------------------------
constexpr int M_SMALL = 64;
constexpr int ROWS_MAX_MN = M_SMALL * 1536;   // the widest decode projection's M * N
constexpr int ROWS_THREADS = 128;
constexpr int RT = 8;     // output rows of a block (blockIdx.y), summed at once
constexpr int JB = 4;     // W^T chunks a lane holds in registers

// Batch b of a lane's W^T chunks (chunk c = lane_g + (b * JB + j) * G) into
// registers, every load issued before any is used.
template <int VEC>
__device__ __forceinline__ void load_w_chunks(uint32_t (&wr)[JB][VEC / 4],
                                              const uint32_t* __restrict__ wrow, int b,
                                              int lane_g, int G, int C, bool live) {
#pragma unroll
  for (int j = 0; j < JB; ++j) {
    const int c = lane_g + (b * JB + j) * G;
    if (live && c < C) {
      if constexpr (VEC == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(wrow) + c);
        wr[j][0] = v.x; wr[j][1] = v.y; wr[j][2] = v.z; wr[j][3] = v.w;
      } else {
        wr[j][0] = __ldg(wrow + c);
      }
    }
  }
}

// 4Q bytes of x as Q int32 words, through L1 (16-, 8- or 4-byte loads)
template <int Q>
__device__ __forceinline__ void load_x(const int8_t* __restrict__ p, int (&xq)[Q]) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int i = 0; i < Q / 4; ++i) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + i);
      xq[4 * i] = v.x; xq[4 * i + 1] = v.y; xq[4 * i + 2] = v.z; xq[4 * i + 3] = v.w;
    }
  } else if constexpr (Q == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    xq[0] = v.x; xq[1] = v.y;
  } else {
    xq[0] = __ldg(reinterpret_cast<const int*>(p));
  }
}

// VEC: bytes of W^T a chunk, 16 (aligned rows) or 4 (word-wise)
template <int BITS, int VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
qmm_int8_rows_kernel(const int8_t* __restrict__ x, const int32_t* __restrict__ w,
                     const float* __restrict__ alpha, const float* __restrict__ bias,
                     float* __restrict__ out, int M, int N, int K, int lg) {
  constexpr int WORDS = VEC / 4;                 // words a chunk
  constexpr int CODES = VEC * 8 / BITS;          // codes a chunk: 64/32/16 or 16/8/4
  constexpr int Q = CODES / 4;                   // int8 quads a chunk
  constexpr int WPD = BITS / 2;                  // words a decode_quads call reads
  const int G = 1 << lg;                         // lanes a column
  const int lane_g = threadIdx.x & (G - 1);
  const int n = (blockIdx.x * ROWS_THREADS + threadIdx.x) >> lg;
  const bool live = n < N;
  const int m0 = blockIdx.y * RT, rows = min(RT, M - m0);
  const int C = K / CODES;                       // chunks a W^T row
  const int nb = (C + G * JB - 1) / (G * JB);    // batches of JB chunks a lane
  const uint32_t* wrow = reinterpret_cast<const uint32_t*>(w) +
                         static_cast<size_t>(live ? n : 0) * C * WORDS;

  int acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0;
  for (int b = 0; b < nb; ++b) {
    uint32_t wr[JB][WORDS];
    load_w_chunks<VEC>(wr, wrow, b, lane_g, G, C, live);
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const int c = lane_g + (b * JB + j) * G;
      if (!live || c >= C) continue;
      uint32_t wq[Q];
      if constexpr (WORDS >= WPD) {
#pragma unroll
        for (int h = 0; h < WORDS / WPD; ++h) {
          uint32_t q4[4];
          decode_quads<BITS>(&wr[j][h * WPD], q4);
#pragma unroll
          for (int t = 0; t < 4; ++t) wq[4 * h + t] = q4[t];
        }
      } else {                                   // one word of 4- or 8-bit fields
        uint32_t q4[4];
        const uint32_t wd[4] = {wr[j][0], 0u, 0u, 0u};
        decode_quads<BITS>(wd, q4);
#pragma unroll
        for (int t = 0; t < Q; ++t) wq[t] = q4[t];
      }
      // rows past M read row m0 and are not stored: no branch, so the
      // rows' loads and dp4a chains interleave
      const int8_t* xc = x + static_cast<size_t>(m0) * K + c * CODES;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        int xq[Q];
        load_x<Q>(xc + static_cast<size_t>(i < rows ? i : 0) * K, xq);
#pragma unroll
        for (int t = 0; t < Q; ++t) acc[i] = __dp4a(xq[t], static_cast<int>(wq[t]), acc[i]);
      }
    }
  }
  // the G partial sums of each row, across the column's lanes (int32: exact)
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (!live || lane_g != 0) return;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < rows) store_out(out, m0 + i, n, N, __int2float_rn(acc[i]), alpha[n], bias);
}

// ---------------------------------------------------------------------------
// int8 codes, the rest: int8 tensor cores
// ---------------------------------------------------------------------------
constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 128, MM_THREADS = 128, MM_STAGES = 4;
constexpr int MM_LD = MM_BK + 16;   // smem row bytes: 144, conflict-free ldmatrix

template <int BITS>
struct MmaLayout {                   // dynamic shared memory, in bytes
  static constexpr int RAW = MM_BK * BITS / 8;         // W^T bytes of a row a K tile
  static constexpr int XS = MM_BM * MM_LD;             // one x tile
  static constexpr int WRAW = MM_BN * RAW;             // one raw W^T tile
  static constexpr int STAGE = XS + WRAW;
  static constexpr int BYTES = MM_STAGES * STAGE + MM_BN * MM_LD;   // + decoded W^T
};

// d += a (16x32 s8, row) . b (32x8 s8, col), s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int VEC>
__device__ __forceinline__ void cp_async_vec(uint32_t dst, const void* src, bool valid) {
  if constexpr (VEC == 16) cp_async16(dst, src, valid);
  else cp_async4(dst, src, valid);
}

__device__ __forceinline__ void store_out2(float* __restrict__ out, int m, int n, int N,
                                           int acc0, int acc1, const float* __restrict__ alpha,
                                           const float* __restrict__ bias) {
  float2 o = make_float2(__fmul_rn(__int2float_rn(acc0), alpha[n]),
                         __fmul_rn(__int2float_rn(acc1), alpha[n + 1]));
  if (bias != nullptr) o = make_float2(__fadd_rn(o.x, bias[n]), __fadd_rn(o.y, bias[n + 1]));
  *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * N + n) = o;
}

template <int BITS, int VEC>
__global__ void __launch_bounds__(MM_THREADS)
qmm_int8_mma_kernel(const int8_t* __restrict__ x, const int32_t* __restrict__ w,
                    const float* __restrict__ alpha, const float* __restrict__ bias,
                    float* __restrict__ out, int M, int N, int K) {
  using L = MmaLayout<BITS>;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* ws = smem + MM_STAGES * L::STAGE;      // the decoded W^T tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_blk = blockIdx.y * MM_BM, n_blk = blockIdx.x * MM_BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const size_t row_bytes = static_cast<size_t>(K) * BITS / 8;   // of W^T
  const int T = (K + MM_BK - 1) / MM_BK;
  const auto* wb = reinterpret_cast<const int8_t*>(w);

  auto load_tile = [&](int t) {
    int8_t* xs = smem + (t % MM_STAGES) * L::STAGE;
    int8_t* wraw = xs + L::XS;
    const int k0 = t * MM_BK;
    constexpr int XP = MM_BK / VEC;              // x pieces a row
    for (int i = tid; i < MM_BM * XP; i += MM_THREADS) {
      const int r = i / XP, p = i % XP, m = m_blk + r, k = k0 + p * VEC;
      const bool ok = m < M && k < K;
      cp_async_vec<VEC>(smem_addr(xs + r * MM_LD + p * VEC),
                        ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
    constexpr int WP = L::RAW / VEC;             // W^T pieces a row
    const size_t kb0 = static_cast<size_t>(k0) * BITS / 8;
    for (int i = tid; i < MM_BN * WP; i += MM_THREADS) {
      const int r = i / WP, p = i % WP, n = n_blk + r;
      const size_t kb = kb0 + p * VEC;
      const bool ok = n < N && kb < row_bytes;
      cp_async_vec<VEC>(smem_addr(wraw + r * L::RAW + p * VEC),
                        ok ? wb + static_cast<size_t>(n) * row_bytes + kb : wb, ok);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < T) load_tile(s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int8_t* xs = smem + (t % MM_STAGES) * L::STAGE;
    const int8_t* wraw = xs + L::XS;
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();              // tile t landed; every warp is done with tile t-1
    // decode the W^T tile into int8, 16 codes (4, 8 or 16 raw bytes) a piece
    constexpr int PB = 16 * BITS / 8;
    for (int i = tid; i < MM_BN * MM_BK / 16; i += MM_THREADS) {
      const int r = i / (MM_BK / 16), p = i % (MM_BK / 16);
      uint32_t wd[4], q[4];
      const uint32_t* src = reinterpret_cast<const uint32_t*>(wraw + r * L::RAW + p * PB);
#pragma unroll
      for (int u = 0; u < PB / 4; ++u) wd[u] = src[u];
      decode_quads<BITS>(wd, q);
      *reinterpret_cast<uint4*>(ws + r * MM_LD + p * 16) = make_uint4(q[0], q[1], q[2], q[3]);
    }
    if (t + MM_STAGES - 1 < T) load_tile(t + MM_STAGES - 1);
    cp_async_commit();
    __syncthreads();              // ws holds tile t
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], smem_addr(xs + (wm + mi * 16 + (lane & 15)) * MM_LD + kk + (lane >> 4) * 16));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4(r, smem_addr(ws + (wn + nj * 16 + (lane & 7) + (lane >> 4) * 8) * MM_LD +
                             kk + ((lane >> 3) & 1) * 16));
        b[2 * nj][0] = r[0]; b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2]; b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // lane (g, t) of a warp holds rows g and g + 8, columns 2t and 2t + 1
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
        const int a0 = acc[mi][ni][2 * h], a1 = acc[mi][ni][2 * h + 1];
        if (pairs && n + 1 < N) {
          store_out2(out, m, n, N, a0, a1, alpha, bias);
        } else {
          if (n < N) store_out(out, m, n, N, __int2float_rn(a0), alpha[n], bias);
          if (n + 1 < N) store_out(out, m, n + 1, N, __int2float_rn(a1), alpha[n + 1], bias);
        }
      }
}

// ---------------------------------------------------------------------------
// float activations: CUDA cores
// ---------------------------------------------------------------------------
constexpr int BM = 32, BN = 64, BK = 64, THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;            // 4 row groups of threads
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;    // 8 output rows a thread
constexpr int WPAD = 4;   // W row pad: 68-byte rows keep the reads conflict-free

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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum Variant : int { VARIANT_AUTO = -1, VARIANT_ROWS = 0, VARIANT_MMA = 1 };

template <int BITS, int VEC>
cudaError_t launch_rows(const int8_t* x, const int32_t* w, const float* alpha,
                        const float* bias, float* out, int M, int N, int K,
                        cudaStream_t stream) {
  const int chunks = K * BITS / 8 / VEC;
  int lg = 0;                                    // G = 2^lg lanes a column
  while ((1 << lg) < chunks && lg < 5) ++lg;
  const dim3 grid(static_cast<unsigned>(
                      ((static_cast<long long>(N) << lg) + ROWS_THREADS - 1) / ROWS_THREADS),
                  (M + RT - 1) / RT);
  qmm_int8_rows_kernel<BITS, VEC><<<grid, ROWS_THREADS, 0, stream>>>(
      x, w, alpha, bias, out, M, N, K, lg);
  return cudaGetLastError();
}

template <int BITS, int VEC>
cudaError_t launch_mma(const int8_t* x, const int32_t* w, const float* alpha,
                       const float* bias, float* out, int M, int N, int K,
                       cudaStream_t stream) {
  constexpr int smem = MmaLayout<BITS>::BYTES;   // 54-79 KB: above the default 48
  static const cudaError_t err = cudaFuncSetAttribute(
      qmm_int8_mma_kernel<BITS, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  qmm_int8_mma_kernel<BITS, VEC><<<grid, MM_THREADS, smem, stream>>>(
      x, w, alpha, bias, out, M, N, K);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_int8(const int8_t* x, const int32_t* w, const float* alpha,
                        const float* bias, float* out, int M, int N, int K,
                        int variant, cudaStream_t stream) {
  const auto xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w);
  const bool vec16 = xa % 16 == 0 && wa % 16 == 0 && (K * BITS / 8) % 16 == 0;
  if (!vec16 && xa % (32 / BITS) != 0) return cudaErrorMisalignedAddress;
  if (variant == VARIANT_AUTO)
    variant = M <= M_SMALL && static_cast<long long>(M) * N <= ROWS_MAX_MN ? VARIANT_ROWS
                                                                          : VARIANT_MMA;
  if (variant == VARIANT_ROWS)
    return vec16 ? launch_rows<BITS, 16>(x, w, alpha, bias, out, M, N, K, stream)
                 : launch_rows<BITS, 4>(x, w, alpha, bias, out, M, N, K, stream);
  if (variant == VARIANT_MMA)
    return vec16 ? launch_mma<BITS, 16>(x, w, alpha, bias, out, M, N, K, stream)
                 : launch_mma<BITS, 4>(x, w, alpha, bias, out, M, N, K, stream);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t launch(const void* x, int x_kind, const void* w, const void* alpha,
                   const void* bias, void* out, int M, int N, int K, int variant,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % (32 / BITS) != 0 || K > (1 << 16))
    return cudaErrorInvalidValue;
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* ap = static_cast<const float*>(alpha);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  switch (x_kind) {
    case KIND_INT8:
      return launch_int8<BITS>(static_cast<const int8_t*>(x), wp, ap, bp, op, M, N, K,
                               variant, stream);
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

cudaError_t launch_bits(const void* x, int x_kind, const void* w, const void* scale,
                        const void* bias, void* out, int M, int N, int K, int bits,
                        int variant, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2>(x, x_kind, w, scale, bias, out, M, N, K, variant, stream);
    case 4: return launch<4>(x, x_kind, w, scale, bias, out, M, N, K, variant, stream);
    case 8: return launch<8>(x, x_kind, w, scale, bias, out, M, N, K, variant, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Ternary weights: 2-bit fields {00: 0, 01: +1, 11: -1}, alpha = TWN scale.
extern "C" cudaError_t ternary_matmul(const void* x, int x_kind, const void* w,
                                      const void* alpha, const void* bias, void* out,
                                      int M, int N, int K, cudaStream_t stream) {
  return launch<2>(x, x_kind, w, alpha, bias, out, M, N, K, VARIANT_AUTO, stream);
}

// k-bit signed integer weights, k in {2, 4, 8}.
extern "C" cudaError_t packed_matmul(const void* x, int x_kind, const void* w,
                                     const void* scale, const void* bias, void* out,
                                     int M, int N, int K, int bits, cudaStream_t stream) {
  return launch_bits(x, x_kind, w, scale, bias, out, M, N, K, bits, VARIANT_AUTO, stream);
}

// int8 codes through one named kernel, 0 = rows, 1 = tensor cores, whatever
// M is: the tuning cache's picks (kernels/tuning.py) and chip_smoke.py.
extern "C" cudaError_t qmatmul_int8_variant(const void* x, const void* w, const void* scale,
                                            const void* bias, void* out, int M, int N,
                                            int K, int bits, int variant,
                                            cudaStream_t stream) {
  if (variant != VARIANT_ROWS && variant != VARIANT_MMA) return cudaErrorInvalidValue;
  return launch_bits(x, KIND_INT8, w, scale, bias, out, M, N, K, bits, variant, stream);
}

// The largest M that the rows kernel takes in the wrappers' calls (and
// then only while M * N <= M_SMALL * 1536).
extern "C" int qmatmul_m_small() { return M_SMALL; }

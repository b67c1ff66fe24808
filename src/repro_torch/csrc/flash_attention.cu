// Full-sequence flash attention: causal, sliding-window and tanh-softcap
// masks, online softmax in f32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention.
//
//   q     (B, Sq, KV, G, Dh)  f32 or bf16 (G query heads share a KV head)
//   k, v  (B, Sk, KV, Dh)     same type as q
//   out   (B, Sq, KV, G, Dh)  f32
//
// Positions count from 0 on both sides (a prefill or a forward, never a
// chunk at an offset); causal = 0 drops the causal mask (an encoder's
// self-attention, a cross-attention: Sq and Sk independent).  Semantics as the Pallas kernel: q, k and v are read
// as f32; s = (q . k) * Dh^-0.5, then softcap * tanh(s / softcap) when
// softcap > 0; key k_pos is seen by query q_pos iff k_pos <= q_pos (causal)
// and k_pos > q_pos - window (window > 0); online softmax with m starting at
// -1e30, p = mask ? exp(s - m_new) : 0, corr = exp(m_prev - m_new); the
// output is acc / max(l, 1e-30).  Exact expf / tanhf, no fast-math.
//
// What bounds it on an H100: the arithmetic, 4 * Dh operations per (query
// head, visible key) pair: 9.67 GFLOP at the forward shape (B=2, S=2048,
// KV=3, G=3, Dh=64, causal), 0.0098 ms at the bf16 tensor peak; in f32,
// three TF32 products a pair, 0.0586 ms at the TF32 peak (495 TFLOP/s); the
// bytes (q, k, v read once, the f32 output written once) are ~0.01 of that.
//
// Both kernels: the TPU kernel carries m/l/acc across a sequential K grid
// axis in VMEM; CUDA blocks run in no order, so a block owns BR = 64
// consecutive rows of the flattened (query position, group head) space of
// one (batch, KV head) and walks the K/V tiles itself, m, l and acc in
// registers.  K tiles wholly after the block's last query, or wholly before
// the window of its first, are skipped; ragged tails (rows past Sq * G,
// keys past Sk) are masked, so any length is taken.
//
// bf16 inputs (the 2xT model, whole-prompt serving, the timed record) run on
// the tensor cores, flash_attn_tc_kernel: 4 warps of 16 rows each, the m16
// of mma.sync.m16n8k16 bf16 -> f32, over K/V tiles of BK = 64 keys.  The Q
// tile is copied once to shared memory and held as A fragments (ldmatrix);
// K and V tiles are double-buffered in shared memory by cp.async in 16-byte
// chunks (keys past Sk zero-filled through the src-size operand), tile i+1
// loading while tile i computes; rows are padded by 16 bytes, so ldmatrix
// reads without bank conflicts.  S = Q.K^T: bf16 products are exact, summed
// in f32 (K row-major is the .col B operand, plain ldmatrix).  The softmax
// runs in f32 registers, row max and sum over the 4 lanes of a row (quad
// shuffles).  P.V: V in bf16 is exact, P is not, so P is split into two bf16
// terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two MMAs against the
// same V fragments (ldmatrix.trans) into the f32 acc: a single bf16 P misses
// the 1e-5 * max|out| bound ~100x, the split holds it at ~0.15 of it (an
// emulation of this arithmetic; tests/test_torch_flash_attention.py pins
// both).  The split costs 1.5x the MMAs of a plain bf16 flash kernel.  Each
// row's masks are one key range [k_lo, k_hi].  Blocks are issued longest
// rows first (causal).  What is left is overlap: the f32 softmax of a tile
// runs between its two MMA phases; hiding it under the next tile's MMAs
// (wgmma, TMA, warp specialisation) is later work.
//
// f32 inputs (the fp32 Model.forward and the f32 checks) run on the TF32
// tensor cores in three products, flash_attn_tf32_kernel: the same
// structure as the bf16 kernel (4 warps x 16 rows, K/V tiles of 32 keys
// double-buffered by 16-byte cp.async, each row's key range, tiles outside
// the causal or window range skipped, longest rows first, the f32 online
// softmax in registers) with mma.sync.m16n8k8 tf32 -> f32.  Every f32
// operand x is split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi),
// and each product a.b is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three MMAs into
// the f32 accumulator (the dropped a_lo.b_lo is ~2^-22 relative): for Q.K^T
// (Q split once, when its tile is staged) and for P.V (P split in registers
// after the softmax).  K and V are split once a tile, by the whole block
// after the tile lands: hi in place, lo into a plane of its own, so the
// four warps that share a tile read plain fragments.  A two-term bf16
// split of f32 q, k, v comes too close to the 1e-5 bound (0.7-0.85 of it
// in emulation) and a single TF32 product misses it by far; the three
// products hold it (tests/test_torch_flash_attention.py emulates both).
// The 32-bit fragments are read with plain shared loads (ldmatrix moves
// 16-bit elements) from rows padded by 4 floats, a stride of 4 banks mod
// 32, so the Q, K (row gid, column tig) and V (row 2 tig, column gid)
// fragment loads are free of bank conflicts.  The m16n8k8 score fragment
// holds keys (2 tig, 2 tig + 1) where P.V's A fragment wants columns
// (tig, tig + 4): the k-step's keys are taken in that order for both P
// and V, so P never leaves the registers.  Shared memory: Q hi and lo, two
// K and two V tiles, K lo and V lo, (2 * 64 + 6 * 32) x (Dh + 4) floats:
// 85 KB at Dh 64 (two blocks an SM), 165 KB at Dh 128.  On an H100 at the
// forward shape (tools/bench_attention.py), splitting K and V once a tile
// instead of in each warp's fragment loads took the kernel from 0.28 to
// 0.26 ms; with the split in the fragment loads, tiles of 32 keys had run
// 4% faster than 64 and 16 keys 32% slower.
//
// probs_bf16 (the reference's attn_probs_bf16: P and V rounded to bf16,
// P.V accumulated in f32, as its _attend_flash computes for prompts past
// 1024 positions) is a template flag of both kernels.  The bf16 kernel then
// keeps the p_hi MMAs and drops the p_lo pass: bf16(p) . V with an f32
// accumulator, a third fewer MMAs.  The f32 kernel rounds V to bf16 when it
// splits a tile (no lo plane for V) and P to bf16 after the softmax; bf16
// values are exact in TF32, so P.V is one TF32 product instead of three
// (Q.K^T keeps its three).  The running max is over the kernel's own tiles
// (64 keys bf16, 32 keys f32) where the reference's is over chunks of 1024,
// so the roundings of P differ from the reference's and the two agree to
// bf16's unit roundoff, not bit for bit; kernels/ref.flash_attention_ref
// repeats the kernel's tiling.  With the flag off every instantiation is
// the one described above.
//
// The flattened (batch, KV head, row tile) index runs along grid.x.
#include "common.cuh"

namespace {

constexpr int BR = 64;                 // rows a block: 4 warps x 16

// --------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// --------------------------------------------------------------------------
constexpr int TC_THREADS = 128;        // 4 warps x 16 rows = BR
constexpr int TC_BK = 64;              // keys a tile
constexpr int PAD = 8;                 // bf16 per smem row: 16 bytes

template <int DH>
constexpr int tc_smem_bytes() {        // Q tile + two K and two V tiles
  return static_cast<int>(sizeof(__nv_bfloat16)) * (BR + 4 * TC_BK) * (DH + PAD);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) -> bf16x2 hi = bf16(p) and lo = bf16(p - hi); p0 in the low half
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h)));
}

// TILE_SUM: acc = acc * corr + t, a tile's P.V added in f32 on the CUDA
// cores.  The tensor cores' f32 accumulation is not IEEE: the addends of an
// MMA are aligned to the largest and the bits below are cut (toward zero),
// so MMAs straight into the running acc lose ~2^-23 of |acc| each, biased.
// Over a long unmasked row (whisper's cross-attention, Sq 32 against 1500
// keys: ~560 TF32 MMAs into an acc ~40x a tile's terms, and a small
// max|out|, the average of 1500 values) the f32 kernel read 1.54 of its
// 1e-5 * max|out| bound on an H100, against 0.12 for the same arithmetic
// with IEEE sums (the emulation of tests/test_torch_flash_attention.py).
// From zero each tile, t stays the size of one tile's terms: 0.27 of the
// bound there (chip_smoke.py phase 4n).
template <int NT>
__device__ __forceinline__ void add_tile(float (&o)[NT][4], const float (&t)[NT][4],
                                         const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] = o[n][0] * corr[0] + t[n][0];
    o[n][1] = o[n][1] * corr[0] + t[n][1];
    o[n][2] = o[n][2] * corr[1] + t[n][2];
    o[n][3] = o[n][3] * corr[1] + t[n][3];
  }
}

template <int DH, bool PB>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int Sq,
                     int Sk, int KV, int G, int n_bh, int causal, int window, float softcap,
                     float sm_scale) {
  constexpr int LD = DH + PAD;          // smem row, in bf16
  constexpr int CH = DH / 8;            // 16-byte chunks a row
  constexpr int KS = DH / 16;           // k-steps of Q.K^T
  constexpr int NT = DH / 8;            // 8-column tiles of the output
  constexpr int ST = TC_BK / 8;         // 8-key tiles of the scores
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);   // BR x LD
  __nv_bfloat16* k_s = q_s + BR * LD;                               // 2 x TC_BK x LD
  __nv_bfloat16* v_s = k_s + 2 * TC_BK * LD;                        // 2 x TC_BK x LD

  const int n_tiles = gridDim.x / n_bh;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / n_bh;  // longest first
  const int bh = blockIdx.x % n_bh;
  const int b = bh / KV, kh = bh % KV;
  const int rows = Sq * G, r0 = tile * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;   // fragment row / column pair

  for (int i = threadIdx.x; i < BR * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < rows;
    const size_t off = ok ? ((static_cast<size_t>(b) * Sq + row / G) * KV + kh) * G * DH +
                                static_cast<size_t>(row % G) * DH + c * 8
                          : 0;
    cp_async16(smem_addr(q_s + r * LD + c * 8), q + off, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int k0, int buf) {
    for (int i = threadIdx.x; i < TC_BK * CH; i += TC_THREADS) {
      const int t = i / CH, c = i % CH, kp = k0 + t;
      const bool ok = kp < Sk;
      const size_t off = ok ? ((static_cast<size_t>(b) * Sk + kp) * KV + kh) * DH + c * 8 : 0;
      const int at = (buf * TC_BK + t) * LD + c * 8;
      cp_async16(smem_addr(k_s + at), k + off, ok);
      cp_async16(smem_addr(v_s + at), v + off, ok);
    }
  };

  // keys any row of the block may see; those of this warp's rows
  const int qp_lo = r0 / G, qp_hi = (min(r0 + BR, rows) - 1) / G;
  const int k_end = causal ? min(Sk, qp_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) / TC_BK * TC_BK : 0;
  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < rows;
  const int wq_lo = min(wr0, rows - 1) / G, wq_hi = (min(wr0 + 16, rows) - 1) / G;

  if (k_begin < k_end) load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's two rows: gid and gid + 8 of the warp's 16
  int k_lo[2], k_hi[2];                 // row h sees keys k_lo[h] .. k_hi[h]
  float m[2], l[2], o[NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + gid + 8 * h, qp = row / G;
    k_lo[h] = window > 0 ? qp - window + 1 : 0;
    k_hi[h] = row >= rows ? -1 : causal ? min(qp, Sk - 1) : Sk - 1;  // padding: none
    m[h] = -1e30f;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  cp_async_wait<1>();                      // the Q tile
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], smem_addr(q_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8));

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TC_BK, buf ^= 1) {
    if (k0 + TC_BK < k_end) {
      load_kv(k0 + TC_BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // a warp none of whose rows sees a key of this tile would add p = 0
    // with corr = 1: skip it (exact)
    const bool skip = !warp_live || (causal && k0 > wq_hi) ||
                      (window > 0 && k0 + TC_BK - 1 <= wq_lo - window);
    if (!skip) {
      const __nv_bfloat16* kb = k_s + buf * TC_BK * LD;
      const __nv_bfloat16* vb = v_s + buf * TC_BK * LD;

      // S = Q.K^T: s[j] holds keys k0 + 8j .. 8j + 7 (columns 2*tig, 2*tig + 1)
      float s[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t r[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int d = ks * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(r, smem_addr(kb + key * LD + d));
          mma_bf16(s[2 * np], qf[ks], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[ks], r[2], r[3]);
        }
      }

      // online softmax in f32; element e of s[j] is row gid + 8 * (e >> 1).
      // The softcap test stays outside the unrolled loops (inside, it costs
      // a branch a score).
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = softcap * tanhf(s[j][e] * sm_scale / softcap);
      } else {
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sm_scale;
      }
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kp = k0 + j * 8 + tig * 2 + (e & 1);
          if (kp < k_lo[h] || kp > k_hi[h]) s[j][e] = __int_as_float(0xff800000);  // -inf: exp gives 0
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }

      // t = (p_hi + p_lo) . V of this tile, from zero: the score fragments
      // of keys 16kk .. +15 are the A fragment of that k-step; the p_lo
      // MMAs follow all p_hi ones, so no MMA waits on the one just before
      // it.  With PB (probs_bf16) P is p_hi alone.  Then acc = acc * corr +
      // t on the CUDA cores (TILE_SUM).
      float t[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t ph[4], pl[4];
        if constexpr (PB) {
          ph[0] = bf16x2_bits(__floats2bfloat162_rn(s[2 * kk][0], s[2 * kk][1]));
          ph[1] = bf16x2_bits(__floats2bfloat162_rn(s[2 * kk][2], s[2 * kk][3]));
          ph[2] = bf16x2_bits(__floats2bfloat162_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]));
          ph[3] = bf16x2_bits(__floats2bfloat162_rn(s[2 * kk + 1][2], s[2 * kk + 1][3]));
        } else {
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        }
        uint32_t r[NT / 2][4];
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          ldsm_x4_trans(r[dp], smem_addr(vb + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                                         (lane >> 4) * 8));
          mma_bf16(t[2 * dp], ph, r[dp][0], r[dp][1]);
          mma_bf16(t[2 * dp + 1], ph, r[dp][2], r[dp][3]);
        }
        if constexpr (!PB) {
#pragma unroll
          for (int dp = 0; dp < NT / 2; ++dp) {
            mma_bf16(t[2 * dp], pl, r[dp][0], r[dp][1]);
            mma_bf16(t[2 * dp + 1], pl, r[dp][2], r[dp][3]);
          }
        }
      }
      add_tile(o, t, corr);
    }
    __syncthreads();                       // before tile i+2 overwrites buf
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + gid + 8 * h;
    if (row >= rows) continue;
    const int qp = row / G, g = row % G;
    float* op = out + ((static_cast<size_t>(b) * Sq + qp) * KV + kh) * G * DH +
                static_cast<size_t>(g) * DH + tig * 2;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

// --------------------------------------------------------------------------
// f32: TF32 tensor cores, three products (mma.sync m16n8k8 tf32, f32 acc)
// --------------------------------------------------------------------------
constexpr int TF_THREADS = 128;        // 4 warps x 16 rows = BR
constexpr int TF_BK = 32;              // keys a tile
constexpr int TF_PAD = 4;              // floats per smem row: stride = 4 banks mod 32

template <int DH>
constexpr int tf_smem_bytes() {        // Q hi and lo, two K and two V tiles, K and V lo
  return static_cast<int>(sizeof(float)) * (2 * BR + 6 * TF_BK) * (DH + TF_PAD);
}

// x -> (hi, lo) as tf32 bit patterns: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// four floats in shared memory split in place: x -> hi, lo into lo[0..3]
__device__ __forceinline__ void split_tf32x4(float* x, float* lo) {
  float4 v = *reinterpret_cast<float4*>(x), l;
  uint32_t h[4], w[4];
  split_tf32(v.x, h[0], w[0]);
  split_tf32(v.y, h[1], w[1]);
  split_tf32(v.z, h[2], w[2]);
  split_tf32(v.w, h[3], w[3]);
  v = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                  __uint_as_float(h[3]));
  l = make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]),
                  __uint_as_float(w[3]));
  *reinterpret_cast<float4*>(x) = v;
  *reinterpret_cast<float4*>(lo) = l;
}

// four floats in shared memory rounded to bf16 in place (round to nearest
// even), kept as f32: bf16 values are exact TF32 operands
__device__ __forceinline__ void round_bf16x4(float* x) {
  float4 v = *reinterpret_cast<float4*>(x);
  v = make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                  __bfloat162float(__float2bfloat16_rn(v.y)),
                  __bfloat162float(__float2bfloat16_rn(v.z)),
                  __bfloat162float(__float2bfloat16_rn(v.w)));
  *reinterpret_cast<float4*>(x) = v;
}

// d += a (16x8 tf32, row) . b (8x8 tf32, col), f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in three products, the small terms first: a_lo.b_hi, a_hi.b_lo,
// a_hi.b_hi (a_lo.b_lo, ~2^-22 relative, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int DH, bool PB>
__global__ void __launch_bounds__(TF_THREADS)
flash_attn_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                       int KV, int G, int n_bh, int causal, int window, float softcap,
                       float sm_scale) {
  constexpr int LD = DH + TF_PAD;       // smem row, in floats
  constexpr int CH = DH / 4;            // 16-byte chunks a row
  constexpr int KS = DH / 8;            // k-steps of Q.K^T
  constexpr int NT = DH / 8;            // 8-column tiles of the output
  constexpr int ST = TF_BK / 8;         // 8-key tiles of the scores (k-steps of P.V)
  extern __shared__ __align__(16) float tf_smem[];
  float* qh_s = tf_smem;                // BR x LD: Q, then its tf32 hi
  float* ql_s = qh_s + BR * LD;         // BR x LD: Q's tf32 lo
  float* k_s = ql_s + BR * LD;          // 2 x TF_BK x LD: K, then its tf32 hi
  float* v_s = k_s + 2 * TF_BK * LD;    // 2 x TF_BK x LD: V, then its tf32 hi
  float* kl_s = v_s + 2 * TF_BK * LD;   // TF_BK x LD: this tile's K lo
  float* vl_s = kl_s + TF_BK * LD;      // TF_BK x LD: this tile's V lo

  const int n_tiles = gridDim.x / n_bh;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / n_bh;  // longest first
  const int bh = blockIdx.x % n_bh;
  const int b = bh / KV, kh = bh % KV;
  const int rows = Sq * G, r0 = tile * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;   // fragment row / column

  for (int i = threadIdx.x; i < BR * CH; i += TF_THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < rows;
    const size_t off = ok ? ((static_cast<size_t>(b) * Sq + row / G) * KV + kh) * G * DH +
                                static_cast<size_t>(row % G) * DH + c * 4
                          : 0;
    cp_async16(smem_addr(qh_s + r * LD + c * 4), q + off, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int k0, int buf) {
    for (int i = threadIdx.x; i < TF_BK * CH; i += TF_THREADS) {
      const int t = i / CH, c = i % CH, kp = k0 + t;
      const bool ok = kp < Sk;
      const size_t off = ok ? ((static_cast<size_t>(b) * Sk + kp) * KV + kh) * DH + c * 4 : 0;
      const int at = (buf * TF_BK + t) * LD + c * 4;
      cp_async16(smem_addr(k_s + at), k + off, ok);
      cp_async16(smem_addr(v_s + at), v + off, ok);
    }
  };

  // keys any row of the block may see; those of this warp's rows
  const int qp_lo = r0 / G, qp_hi = (min(r0 + BR, rows) - 1) / G;
  const int k_end = causal ? min(Sk, qp_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) / TF_BK * TF_BK : 0;
  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < rows;
  const int wq_lo = min(wr0, rows - 1) / G, wq_hi = (min(wr0 + 16, rows) - 1) / G;

  if (k_begin < k_end) load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's two rows: gid and gid + 8 of the warp's 16
  int k_lo[2], k_hi[2];                 // row h sees keys k_lo[h] .. k_hi[h]
  float m[2], l[2], o[NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + gid + 8 * h, qp = row / G;
    k_lo[h] = window > 0 ? qp - window + 1 : 0;
    k_hi[h] = row >= rows ? -1 : causal ? min(qp, Sk - 1) : Sk - 1;  // padding: none
    m[h] = -1e30f;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  cp_async_wait<1>();                      // the Q tile
  __syncthreads();
  for (int i = threadIdx.x; i < BR * DH; i += TF_THREADS) {   // split Q once
    float* x = qh_s + (i / DH) * LD + i % DH;
    uint32_t hi, lo;
    split_tf32(*x, hi, lo);
    *x = __uint_as_float(hi);
    ql_s[x - qh_s] = __uint_as_float(lo);
  }

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TF_BK, buf ^= 1) {
    if (k0 + TF_BK < k_end) {
      load_kv(k0 + TF_BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // this tile (and the split Q) visible
    for (int i = threadIdx.x; i < TF_BK * CH; i += TF_THREADS) {   // split K and V once
      const int at = buf * TF_BK * LD + (i / CH) * LD + (i % CH) * 4;
      const int lat = (i / CH) * LD + (i % CH) * 4;
      split_tf32x4(k_s + at, kl_s + lat);
      if constexpr (PB)
        round_bf16x4(v_s + at);           // probs_bf16: V in bf16, no lo
      else
        split_tf32x4(v_s + at, vl_s + lat);
    }
    __syncthreads();                       // the split tile visible

    // a warp none of whose rows sees a key of this tile would add p = 0
    // with corr = 1: skip it (exact)
    const bool skip = !warp_live || (causal && k0 > wq_hi) ||
                      (window > 0 && k0 + TF_BK - 1 <= wq_lo - window);
    if (!skip) {
      const float* kb = k_s + buf * TF_BK * LD;
      const float* vb = v_s + buf * TF_BK * LD;

      // S = Q.K^T: s[j] holds keys k0 + 8j .. 8j + 7 (columns 2*tig, 2*tig + 1);
      // A = Q rows (gid, gid + 8) x dims (tig, tig + 4) of the k-step, B = K
      // row gid of the key tile x the same dims
      float s[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int qa = (warp * 16 + gid) * LD + ks * 8 + tig;
        const uint32_t ah[4] = {__float_as_uint(qh_s[qa]), __float_as_uint(qh_s[qa + 8 * LD]),
                                __float_as_uint(qh_s[qa + 4]),
                                __float_as_uint(qh_s[qa + 8 * LD + 4])};
        const uint32_t al[4] = {__float_as_uint(ql_s[qa]), __float_as_uint(ql_s[qa + 8 * LD]),
                                __float_as_uint(ql_s[qa + 4]),
                                __float_as_uint(ql_s[qa + 8 * LD + 4])};
#pragma unroll
        for (int j = 0; j < ST; ++j) {
          const int kb_at = (j * 8 + gid) * LD + ks * 8 + tig;
          mma_3xtf32(s[j], ah, al, __float_as_uint(kb[kb_at]), __float_as_uint(kb[kb_at + 4]),
                     __float_as_uint(kl_s[kb_at]), __float_as_uint(kl_s[kb_at + 4]));
        }
      }

      // online softmax in f32; element e of s[j] is row gid + 8 * (e >> 1).
      // The softcap test stays outside the unrolled loops.
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = softcap * tanhf(s[j][e] * sm_scale / softcap);
      } else {
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sm_scale;
      }
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kp = k0 + j * 8 + tig * 2 + (e & 1);
          if (kp < k_lo[h] || kp > k_hi[h]) s[j][e] = __int_as_float(0xff800000);  // -inf: exp gives 0
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }

      // t = P.V of this tile, from zero, over the k-steps of 8 keys; then
      // acc = acc * corr + t on the CUDA cores (TILE_SUM).  The A fragment's
      // columns (tig, tig + 4) take keys (2 tig, 2 tig + 1) of the step, the
      // keys the score fragment s[kk] holds, so P stays in registers; V's B
      // fragment takes the same two keys (rows 2 tig, 2 tig + 1) at column
      // gid.  With PB (probs_bf16) P and V are bf16 values and P.V is the
      // one product hi.hi.
      float t[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ST; ++kk) {
        uint32_t ph[4], pl[4];
        const int vb_at = (kk * 8 + 2 * tig) * LD + gid;
        if constexpr (PB) {
          const int order[4] = {0, 2, 1, 3};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ph[e] = __float_as_uint(__bfloat162float(__float2bfloat16_rn(s[kk][order[e]])));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int at = vb_at + n * 8;
            mma_tf32(t[n], ph, __float_as_uint(vb[at]), __float_as_uint(vb[at + LD]));
          }
        } else {
          split_tf32(s[kk][0], ph[0], pl[0]);
          split_tf32(s[kk][2], ph[1], pl[1]);
          split_tf32(s[kk][1], ph[2], pl[2]);
          split_tf32(s[kk][3], ph[3], pl[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int at = vb_at + n * 8;
            mma_3xtf32(t[n], ph, pl, __float_as_uint(vb[at]), __float_as_uint(vb[at + LD]),
                       __float_as_uint(vl_s[at]), __float_as_uint(vl_s[at + LD]));
          }
        }
      }
      add_tile(o, t, corr);
    }
    __syncthreads();                       // before tile i+2 overwrites buf
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + gid + 8 * h;
    if (row >= rows) continue;
    const int qp = row / G, g = row % G;
    float* op = out + ((static_cast<size_t>(b) * Sq + qp) * KV + kh) * G * DH +
                static_cast<size_t>(g) * DH + tig * 2;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

// above 48 KB of dynamic shared memory only after opting in, once a kernel
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int DH, bool PB>
cudaError_t launch_dh(int kind, const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int KV, int G, int causal, int window,
                      float softcap, float sm_scale, cudaStream_t stream) {
  const int n_tiles = (Sq * G + BR - 1) / BR;
  const long long blocks = static_cast<long long>(B) * KV * n_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (kind == KIND_BF16) {
    static bool smem_set = false;
    constexpr int smem = tc_smem_bytes<DH>();
    const cudaError_t e = allow_smem(flash_attn_tc_kernel<DH, PB>, smem, smem_set);
    if (e != cudaSuccess) return e;
    flash_attn_tc_kernel<DH, PB><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), Sq, Sk, KV, G,
        B * KV, causal, window, softcap, sm_scale);
  } else {
    static bool smem_set = false;
    constexpr int smem = tf_smem_bytes<DH>();
    const cudaError_t e = allow_smem(flash_attn_tf32_kernel<DH, PB>, smem, smem_set);
    if (e != cudaSuccess) return e;
    flash_attn_tf32_kernel<DH, PB><<<grid, TF_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, KV, G, B * KV, causal,
        window, softcap, sm_scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_pb(int kind, const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int KV, int G, int causal, int window,
                      int probs_bf16, float softcap, float sm_scale, cudaStream_t stream) {
  return probs_bf16 ? launch_dh<DH, true>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal,
                                          window, softcap, sm_scale, stream)
                    : launch_dh<DH, false>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal,
                                           window, softcap, sm_scale, stream);
}

}  // namespace

// q: (B, Sq, KV, G, Dh), k/v: (B, Sk, KV, Dh), all f32 or all bf16 (kind),
// 16-byte aligned (cp.async); out: (B, Sq, KV, G, Dh) f32.
// Dh in {32, 64, 96, 112, 128} (112 = 7 bf16 k-steps of 16, 14 n-tiles of
// 8, 14 / 28 16-byte chunks a bf16 / f32 row: kimi-k2's head).  causal:
// 0/1 (0: every query sees every key, Sq and Sk independent); window <= 0
// and softcap <= 0 switch those masks off; probs_bf16: 0/1 (P and V
// rounded to bf16 for P.V).
extern "C" cudaError_t flash_attention(const void* q, const void* k, const void* v,
                                       int kind, void* out, int B, int Sq, int Sk, int KV,
                                       int G, int Dh, int causal, int window,
                                       int probs_bf16, float softcap, float sm_scale,
                                       cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || G <= 0) return cudaErrorInvalidValue;
  if (kind != KIND_F32 && kind != KIND_BF16) return cudaErrorInvalidValue;
  switch (Dh) {
    case 32:
      return launch_pb<32>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window,
                           probs_bf16, softcap, sm_scale, stream);
    case 64:
      return launch_pb<64>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window,
                           probs_bf16, softcap, sm_scale, stream);
    case 96:
      return launch_pb<96>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window,
                           probs_bf16, softcap, sm_scale, stream);
    case 112:
      return launch_pb<112>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window,
                            probs_bf16, softcap, sm_scale, stream);
    case 128:
      return launch_pb<128>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window,
                            probs_bf16, softcap, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

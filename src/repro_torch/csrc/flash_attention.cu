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
// chunk at an offset).  Semantics as the Pallas kernel: q, k and v are read
// as f32; s = (q . k) * Dh^-0.5, then softcap * tanh(s / softcap) when
// softcap > 0; key k_pos is seen by query q_pos iff k_pos <= q_pos (causal)
// and k_pos > q_pos - window (window > 0); online softmax with m starting at
// -1e30, p = mask ? exp(s - m_new) : 0, corr = exp(m_prev - m_new); the
// output is acc / max(l, 1e-30).  Exact expf / tanhf, no fast-math.
//
// What bounds it on an H100: the arithmetic, 4 * Dh operations per (query
// head, visible key) pair: 9.67 GFLOP at the forward shape (B=2, S=2048,
// KV=3, G=3, Dh=64, causal), 0.0098 ms at the bf16 tensor peak; the bytes
// (q, k, v read once, the f32 output written once) are ~0.01 of that.
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
// f32 inputs (the fp32 Model.forward and the f32 checks) stay on the CUDA
// cores, flash_attn_f32_kernel: a two-term bf16 split of f32 q, k, v comes
// too close to the bound (0.7-0.85 of it in emulation), a three-term one (6
// products) or 3xTF32 is a later choice.  One 256-thread block walks K/V tiles of
// BK = 32: each warp owns 8 rows, each lane one key of the tile for the
// scores (warp-shuffle max and sum) and Dh/32 output columns for P.V; the
// block's Q rows and each K/V tile are staged in shared memory as f32 (rows
// padded by 4 floats: float4 reads without bank conflicts).
//
// The flattened (batch, KV head, row tile) index runs along grid.x.
#include "common.cuh"

namespace {

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int THREADS = 256, NWARPS = THREADS / 32, RPW = 8;  // rows per warp
constexpr int BR = NWARPS * RPW;                               // 64 rows a block
constexpr int BK = 32;                                         // keys a tile

template <int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (BR * (DH + 4) + BK * (DH + 4) + BK * DH);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int Sq,
                      int Sk, int KV, int G, int n_tiles, int causal, int window,
                      float softcap, float sm_scale) {
  constexpr int DPL = DH / 32;          // output columns per lane
  constexpr int QS = DH + 4;            // padded row of q_s / k_s
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // BR x QS
  float* k_s = q_s + BR * QS;           // BK x QS
  float* v_s = k_s + BK * QS;           // BK x DH

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / KV, kh = bh % KV;
  const int rows = Sq * G;
  const int r0 = tile * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < BR * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, row = r0 + r;
    float val = 0.f;
    if (row < rows) {
      const int qp = row / G, g = row % G;
      val = q[((static_cast<size_t>(b) * Sq + qp) * KV + kh) * G * DH +
              static_cast<size_t>(g) * DH + d];
    }
    q_s[r * QS + d] = val;
  }

  int qpos[RPW];
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    qpos[i] = row < rows ? row / G : -1;   // -1: a padding row, every key masked
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  // keys any row of the block may see
  const int qp_lo = r0 / G, qp_hi = (min(r0 + BR, rows) - 1) / G;
  const int k_end = causal ? min(Sk, qp_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) / BK * BK : 0;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = threadIdx.x; i < BK * DH; i += THREADS) {
      const int t = i / DH, d = i % DH, kp = k0 + t;
      float kv_ = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + kp) * KV + kh) * DH + d;
        kv_ = k[off];
        vv = v[off];
      }
      k_s[t * QS + d] = kv_;
      v_s[t * DH + d] = vv;
    }
    __syncthreads();

    // scores: lane = key k0 + lane, one dot per row of this warp
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&k_s[lane * QS + d]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(&q_s[(warp * RPW + i) * QS + d]);
        s[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    const int kp = k0 + lane;
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float sc = s[i] * sm_scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      bool ok = kp < Sk && qpos[i] >= 0;
      if (causal) ok = ok && kp <= qpos[i];
      if (window > 0) ok = ok && kp > qpos[i] - window;
      float mx = ok ? sc : -1e30f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      p[i] = ok ? expf(sc - m_new) : 0.f;
      float sum = p[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
    }

    // P.V: lane owns columns lane, lane + 32, ...; p of key t from lane t
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vv[j] = v_s[t * DH + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pt = __shfl_sync(0xffffffffu, p[i], t);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] += pt * vv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    if (row >= rows) continue;
    const int qp = row / G, g = row % G;
    float* o = out + ((static_cast<size_t>(b) * Sq + qp) * KV + kh) * G * DH +
               static_cast<size_t>(g) * DH;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[lane + 32 * j] = acc[i][j] / denom;
  }
}

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

template <int DH>
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
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // acc += (p_hi + p_lo) . V: the score fragments of keys 16kk .. +15
      // are the A fragment of that k-step; the p_lo MMAs follow all p_hi
      // ones, so no MMA waits on the one just before it
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        uint32_t r[NT / 2][4];
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          ldsm_x4_trans(r[dp], smem_addr(vb + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                                         (lane >> 4) * 8));
          mma_bf16(o[2 * dp], ph, r[dp][0], r[dp][1]);
          mma_bf16(o[2 * dp + 1], ph, r[dp][2], r[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          mma_bf16(o[2 * dp], pl, r[dp][0], r[dp][1]);
          mma_bf16(o[2 * dp + 1], pl, r[dp][2], r[dp][3]);
        }
      }
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

template <int DH>
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
    const cudaError_t e = allow_smem(flash_attn_tc_kernel<DH>, smem, smem_set);
    if (e != cudaSuccess) return e;
    flash_attn_tc_kernel<DH><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), Sq, Sk, KV, G,
        B * KV, causal, window, softcap, sm_scale);
  } else {
    static bool smem_set = false;
    constexpr int smem = smem_bytes<DH>();
    const cudaError_t e = allow_smem(flash_attn_f32_kernel<DH>, smem, smem_set);
    if (e != cudaSuccess) return e;
    flash_attn_f32_kernel<DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, KV, G, n_tiles,
        causal, window, softcap, sm_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, KV, G, Dh), k/v: (B, Sk, KV, Dh), all f32 or all bf16 (kind),
// bf16 pointers 16-byte aligned (cp.async); out: (B, Sq, KV, G, Dh) f32.
// Dh in {32, 64, 96, 128}.  causal: 0/1; window <= 0 and softcap <= 0
// switch those masks off.
extern "C" cudaError_t flash_attention(const void* q, const void* k, const void* v,
                                       int kind, void* out, int B, int Sq, int Sk, int KV,
                                       int G, int Dh, int causal, int window,
                                       float softcap, float sm_scale,
                                       cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || G <= 0) return cudaErrorInvalidValue;
  if (kind != KIND_F32 && kind != KIND_BF16) return cudaErrorInvalidValue;
  switch (Dh) {
    case 32:
      return launch_dh<32>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                           sm_scale, stream);
    case 64:
      return launch_dh<64>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                           sm_scale, stream);
    case 96:
      return launch_dh<96>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                           sm_scale, stream);
    case 128:
      return launch_dh<128>(kind, q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                            sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

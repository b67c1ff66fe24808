// The paged flash-decode core shared by paged_attention.cu and
// decode_fused.cu: one query token's G grouped heads of one KV head attend
// over a sequence whose positions live in pool blocks named by a page-table
// row.
//
//   pool      (NB, bs, KV, Dh')  int8 codes (kv8), nibble pairs with
//                                Dh' = Dh/2 (kv4), or raw f32/bf16 (kv16)
//   scale     (NB, bs, KV, 1)    f32 per-(position, head); null for kv16
//   pt_row    (n_blocks,)        int32 physical block of logical block j
//
// Position s lives at pool row (pt_row[s / bs], s % bs).  Only positions
// s <= pos are read, so the blocks past pos (whose entries point at the
// null block 0) are never touched, and a block id outside [0, NB) reads the
// null block instead: the kernels never index past the pool.
//
// K/V are dequantized in f32 (code * scale; kv4 unpacks the low nibble
// first and sign-extends, as core/packing.unpack_nibbles), scores are
// q.k / sqrt(Dh) as in the Pallas kernel (at Dh = 64 the divisor is exactly
// 8), masked scores never enter, and an online softmax (m from -1e30)
// accumulates over tiles of TS positions.  The caller divides acc by
// max(l, 1e-30).
#pragma once

#include "common.cuh"

// Pool storage kinds the launchers accept (the wrappers pass these).
enum KvKind : int { KV_INT8 = 0, KV_INT4 = 1, KV_F32 = 2, KV_BF16 = 3 };

constexpr int PA_TS = 32;        // positions per tile: one per lane
constexpr int PA_THREADS = 128;
constexpr int PA_NWARPS = PA_THREADS / 32;
constexpr int PA_SMEM_LIMIT = 48 * 1024;

template <int KIND> struct KvStore { using T = int8_t; };
template <> struct KvStore<KV_F32> { using T = float; };
template <> struct KvStore<KV_BF16> { using T = __nv_bfloat16; };

// Value d (of Dh) of pool row ``row`` = (block * bs + offset) * KV + head.
template <int KIND>
__device__ __forceinline__ float kv_value(const typename KvStore<KIND>::T* __restrict__ pool,
                                          const float* __restrict__ scale, size_t row, int d,
                                          int Dh) {
  if constexpr (KIND == KV_INT8) {
    return static_cast<float>(pool[row * Dh + d]) * scale[row];
  } else if constexpr (KIND == KV_INT4) {
    const int byte = static_cast<int>(pool[row * (Dh / 2) + d / 2]) & 0xFF;
    int nib = (d & 1) ? (byte >> 4) : (byte & 0xF);
    if (nib >= 8) nib -= 16;
    return static_cast<float>(nib) * scale[row];
  } else {
    return to_float(pool[row * Dh + d]);
  }
}

// Shared-memory layout of the core, in floats.
struct PaSmem {
  float* k;     // TS x (Dh + 1): padded, lanes read rows
  float* v;     // TS x Dh
  float* q;     // G x Dh
  float* acc;   // G x Dh
  float* p;     // G x TS
  float* m;     // G running max
  float* l;     // G running sum
  float* c;     // G this tile's rescale factor
  __device__ PaSmem(float* base, int G, int Dh)
      : k(base), v(k + PA_TS * (Dh + 1)), q(v + PA_TS * Dh), acc(q + G * Dh),
        p(acc + G * Dh), m(p + G * PA_TS), l(m + G), c(l + G) {}
};

__host__ __device__ inline int pa_smem_floats(int G, int Dh) {
  return PA_TS * (Dh + 1) + PA_TS * Dh + 2 * G * Dh + G * PA_TS + 3 * G;
}

// Runs with all PA_THREADS threads of the block; ends synchronised, with
// sm.acc the unnormalised (G, Dh) output and sm.l the softmax sums.
template <typename QT, int KIND>
__device__ void paged_attend(PaSmem sm, const QT* __restrict__ q_head,
                             const typename KvStore<KIND>::T* __restrict__ kp,
                             const float* __restrict__ ks,
                             const typename KvStore<KIND>::T* __restrict__ vp,
                             const float* __restrict__ vs, const int32_t* __restrict__ pt_row,
                             int pos, int NB, int bs, int n_blocks, int KV, int kh, int G,
                             int Dh) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_valid = max(0, min(pos + 1, n_blocks * bs));
  const float sm_div = sqrtf(static_cast<float>(Dh));

  for (int i = threadIdx.x; i < G * Dh; i += PA_THREADS) {
    sm.q[i] = to_float(q_head[i]);
    sm.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += PA_THREADS) {
    sm.m[g] = -1e30f;
    sm.l[g] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += PA_TS) {
    const int nt = min(PA_TS, n_valid - s0);
    for (int i = threadIdx.x; i < nt * Dh; i += PA_THREADS) {
      const int t = i / Dh, d = i % Dh;
      const int s = s0 + t;
      int blk = pt_row[s / bs];
      if (blk < 0 || blk >= NB) blk = 0;
      const size_t row = (static_cast<size_t>(blk) * bs + s % bs) * KV + kh;
      sm.k[t * (Dh + 1) + d] = kv_value<KIND>(kp, ks, row, d, Dh);
      sm.v[t * Dh + d] = kv_value<KIND>(vp, vs, row, d, Dh);
    }
    __syncthreads();

    for (int g = warp; g < G; g += PA_NWARPS) {
      float sc = -1e30f;
      if (lane < nt) {
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot += sm.q[g * Dh + d] * sm.k[lane * (Dh + 1) + d];
        sc = dot / sm_div;
      }
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < nt ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sm.p[g * PA_TS + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sm.c[g] = corr;
        sm.l[g] = sm.l[g] * corr + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * Dh; i += PA_THREADS) {
      const int g = i / Dh, d = i % Dh;
      float a = sm.acc[i] * sm.c[g];
      for (int t = 0; t < nt; ++t) a += sm.p[g * PA_TS + t] * sm.v[t * Dh + d];
      sm.acc[i] = a;
    }
    __syncthreads();
  }
}

// Shape checks shared by the launchers.
inline bool pa_shapes_ok(int kv_kind, int NB, int bs, int n_blocks, int KV, int G, int Dh) {
  if (NB <= 0 || bs <= 0 || n_blocks <= 0 || KV <= 0 || G <= 0 || Dh <= 0) return false;
  if (kv_kind == KV_INT4 && Dh % 2 != 0) return false;
  return kv_kind >= KV_INT8 && kv_kind <= KV_BF16;
}

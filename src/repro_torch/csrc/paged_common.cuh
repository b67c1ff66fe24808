// The paged flash-decode core shared by paged_attention.cu (B2),
// decode_fused.cu (B4) and decode_attention.cu (B5): the G query heads of
// one KV head of one sequence attend over positions that live in pool
// blocks named by a page-table row.  All three replace TPU kernels that walk
// a sequence's positions in order on one core:
// repro/kernels/paged_attention.py:paged_attention,
// repro/kernels/decode_fused.py:fused_decode and
// repro/kernels/decode_attention.py:decode_attention.  B5's dense cache
// (B, S, KV, Dh) is a pool of NB = B blocks of bs = S positions whose page
// table is the identity (sequence b's one block is block b): the DENSE
// instances take block b at compile time, with no table in memory and no
// dependent load.
//
//   pool      (NB, bs, KV, Dh')  int8 codes (kv8), nibble pairs with
//                                Dh' = Dh/2 (kv4), or raw f32/bf16 (kv16)
//   scale     (NB, bs, KV, 1)    f32 per-(position, head); null for kv16
//   pt_row    (n_blocks,)        int32 physical block of logical block j
//
// Semantics (the Pallas kernel's): position s lives at pool row
// (pt_row[s / bs], s % bs); only positions s <= pos, and s < n_blocks*bs,
// are read; a block id outside [0, NB) reads the null block 0 instead, so
// nothing indexes past the pool.  K/V dequantize in f32 (code * scale; kv4
// takes the low nibble first, sign-extended, as core/packing.unpack_nibbles),
// scores are q.k / sqrt(Dh) (K's scale multiplies the row's code dot
// product), and the softmax is online with m from -1e30; the caller divides
// by max(l, 1e-30).
//
// What bounds it on an H100: the K/V bytes of the positions up to pos
// (codes plus f32 scales; ~30 KB a call at the serving shapes, 10 ns of
// HBM) and ~4*G*Dh flops a position.  At those sizes the time is latency:
// the launch, the page table -> row dependency, and a warp's chain of
// dependent steps over a span (shuffles, shared-memory loads, exp),
// ~3-8k cycles a span (the trace of tools/bench_paged.py).
//
// Design:
// - Workers.  Positions [0, n_valid) are cut into spans of whole pool
//   blocks of at most 8, 16 or 32 positions (pieces of a larger block).  A
//   worker is one warp; the W workers (PA_NW warps a block, times the
//   blocks of a cluster) take spans w, w + W, ... in ascending order, each
//   with its own online softmax state (m, l and the (G, Dh) accumulator).
//   The launch plans pick the span that gives each warp about one span.
// - Loads.  Lane t resolves the page-table entry, pool row and both scales
//   of the span's position t once (the first span's entry before q is
//   staged).  The K and V rows go into the warp's shared memory by 16-byte
//   cp.async, one vector a lane (Dh 64: int8 4 lanes a row, bf16 8, f32
//   16, kv4 2), double-buffered: the next span's copies are in flight
//   while this span's softmax and P.V run.  Rows that are not a whole
//   number of 16-byte vectors, or pools off a 16-byte boundary, take the
//   same steps with scalar loads (8 lanes a row, strided elements).
// - Arithmetic.  Lane groups take q.k of four query heads at a time (four
//   independent chains, reduced over the group with __shfl_xor_sync); one
//   lane a position takes the softmax, V's scale folded into the stored
//   probability; each lane accumulates P.V for d = lane, lane + 32, ...
// - Merge.  The warps' partials merge in shared memory in ascending warp
//   order (M = max m_w; A = sum acc_w exp(m_w - M); L likewise).  Across a
//   cluster each block pushes its partial into the other blocks' shared
//   memory (distributed shared memory) before one cluster.sync(), and they
//   merge in ascending rank order.  A worker with no span keeps m = -1e30,
//   l = 0, acc = 0 and adds exactly nothing; the order is fixed, so the
//   result is the same from launch to launch.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "common.cuh"

namespace cg = cooperative_groups;

// Pool storage kinds the launchers accept (the wrappers pass these).
enum KvKind : int { KV_INT8 = 0, KV_INT4 = 1, KV_F32 = 2, KV_BF16 = 3 };

constexpr int PA_NW = 8;                  // warps (workers) a CTA
constexpr int PA_THREADS = 32 * PA_NW;
constexpr int PA_SPAN_MAX = 32;           // one lane a position in the softmax
constexpr int PA_CLUSTER_MAX = 8;         // portable cluster size
constexpr int PA_SCALAR_LPR = 8;          // lanes a row on the scalar path
// H100: 227 KB of shared memory a block, above 48 KB by opt-in
constexpr int PA_SMEM_LIMIT = 227 * 1024;

template <int KIND> struct KvStore { using T = int8_t; };
template <> struct KvStore<KV_F32> { using T = float; };
template <> struct KvStore<KV_BF16> { using T = __nv_bfloat16; };

// elements of one 16-byte vector
template <int KIND> struct KvVec { static constexpr int E = 16; };
template <> struct KvVec<KV_INT4> { static constexpr int E = 32; };
template <> struct KvVec<KV_F32> { static constexpr int E = 4; };
template <> struct KvVec<KV_BF16> { static constexpr int E = 8; };

__host__ __device__ inline int pa_round4(int n) { return (n + 3) & ~3; }

// Bytes of one stored row (Dh' elements of the pool's storage type).
__host__ __device__ inline int pa_row_bytes(int kv_kind, int Dh) {
  switch (kv_kind) {
    case KV_INT8: return Dh;
    case KV_INT4: return Dh / 2;
    case KV_F32: return 4 * Dh;
    default: return 2 * Dh;
  }
}

// The vector path takes rows of a whole number of 16-byte vectors, at most
// 32 of them (one a lane), from 16-byte aligned pools.
inline bool pa_vector_ok(int kv_kind, int Dh, const void* k, const void* v) {
  const int rb = pa_row_bytes(kv_kind, Dh);
  return rb % 16 == 0 && rb / 16 <= 32 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// Positions a span: whole pool blocks up to `span_max`, or span_max-position
// pieces of a larger block.
__host__ __device__ inline int pa_span(int bs, int span_max) {
  return bs <= span_max ? (span_max / bs) * bs : span_max;
}

// The span for `workers` warps over n_ctx positions: the shortest (limit
// 8, 16, ... up to limit_max) that gives no warp more than one span, else
// the longest (the cluster sweep of chip_smoke.py: one span a warp is
// fastest, and at two or more the longer span's fewer softmax and merge
// steps win).
inline int pa_auto_span(int bs, int n_ctx, int workers, int limit_max) {
  for (int limit = 8; limit < limit_max; limit *= 2) {
    const int span = pa_span(bs, limit);
    if ((n_ctx + span - 1) / span <= workers) return span;
  }
  return pa_span(bs, limit_max);
}

// A warp's K/V staging, in floats: on the vector path two stages of raw K
// and V rows (span x row bytes each), filled by cp.async; on the scalar path
// V's codes as f32 (span x Dh).
__host__ __device__ inline int pa_kv_floats(int kv_kind, bool vec, int Dh, int span) {
  return vec ? span * pa_row_bytes(kv_kind, Dh) : span * Dh;   // 2 stages x 2 x rb / 4
}
// Shared memory of one warp: the K/V staging, the span's scores and then
// probabilities (span x G4), the accumulator (G4 x Dh), m, l and the
// rescale factor (G4 each); G4 = G rounded up to 4.
__host__ __device__ inline int pa_warp_floats(int kv_kind, bool vec, int G, int Dh, int span) {
  const int g4 = pa_round4(G);
  return pa_round4(pa_kv_floats(kv_kind, vec, Dh, span)) + span * g4 + g4 * Dh + 3 * g4;
}
// One merged partial: acc (G x Dh), m, l (G).
__host__ __device__ inline int pa_part_floats(int G, int Dh) {
  return pa_round4(G * Dh) + pa_round4(2 * G);
}

struct PaWarp {
  float* kv;    // staging (see pa_kv_floats)
  float* p;     // span x G4
  float* acc;   // G4 x Dh
  float* m;     // G4
  float* l;     // G4
  float* c;     // G4
  __device__ PaWarp(float* base, int kv_kind, bool vec, int G, int Dh, int span)
      : kv(base), p(kv + pa_round4(pa_kv_floats(kv_kind, vec, Dh, span))),
        acc(p + span * pa_round4(G)), m(acc + pa_round4(G) * Dh), l(m + pa_round4(G)),
        c(l + pa_round4(G)) {}
};

struct PaPart {
  float* acc;   // G x Dh
  float* m;     // G
  float* l;     // G
  __device__ PaPart(float* base, int G, int Dh)
      : acc(base), m(acc + pa_round4(G * Dh)), l(m + G) {}
};

// ---------------------------------------------------------------------------
// 16-byte vector -> E floats (codes for int8/kv4, values for f32/bf16)
template <int KIND>
__device__ __forceinline__ void pa_decode(const uint4& u, float (&f)[KvVec<KIND>::E]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (KIND == KV_INT8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
    } else if constexpr (KIND == KV_INT4) {
      // nibble j of the word is element j: byte b's low nibble first
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[8 * i + j] = static_cast<float>(static_cast<int32_t>(w[i] << (28 - 4 * j)) >> 28);
    } else if constexpr (KIND == KV_BF16) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// Element d of a stored row at `row_ptr` (global memory on the scalar path,
// a staged raw row in shared memory on the vector path): the code or the
// raw value.
template <int KIND>
__device__ __forceinline__ float pa_elem(const typename KvStore<KIND>::T* row_ptr, int d) {
  if constexpr (KIND == KV_INT4) {
    const int byte = static_cast<int>(row_ptr[d / 2]);
    return static_cast<float>((d & 1) ? (byte >> 4)
                                      : (static_cast<int32_t>(static_cast<uint32_t>(byte) << 28) >> 28));
  } else {
    return to_float(row_ptr[d]);
  }
}

// ---------------------------------------------------------------------------
// Measurement only: lane 0 of a traced warp writes clock64() cycles since
// `t0` at the ends of its first span's phases into out[0..4] (operands in
// flight, rows staged, scores, softmax, P.V).  Off (out null) in use.
struct PaTrace {
  float* out = nullptr;
  long long t0 = 0;
  __device__ void stamp(int i, int j, int worker) const {
    if (out != nullptr && j == worker && threadIdx.x % 32 == 0)
      out[i] = static_cast<float>(clock64() - t0);
  }
};

// Lane t's page-table entry for position t of span `worker` (the warp's
// first), read before n_valid is known: any position below n_blocks*bs.
__device__ __forceinline__ int pa_first_block(const int32_t* __restrict__ pt_row, int n_blocks,
                                              int bs, int span, int worker) {
  const int t = threadIdx.x % 32, s = worker * span + t;
  return t < span && s < n_blocks * bs ? pt_row[s / bs] : 0;
}

// One warp's partial: spans worker, worker + n_workers, ... of [0, n_valid)
// with the online softmax, into its PaWarp.  q_s is (G4, Dh) f32 in shared
// memory, rows G..G4-1 zero; blk0 is pa_first_block's entry.  Called by
// all 32 lanes; ends __syncwarp'ed.
//
// Per span: lane t resolves position t's page-table entry, pool row and
// scales; the K/V rows go into the warp's staging by cp.async (vector path;
// the next span's copies are issued while this span's softmax and P.V run);
// lane groups take the rows' q.k for four query heads at a time (four
// independent shuffle chains); one lane a position takes the softmax, V's
// scale folded into the stored probability; each lane accumulates P.V for
// d = lane, lane + 32, ... and four heads at a time.  DENSE: every position
// lives in block blk0 (pt_row is not read).
template <int KIND, bool VEC, bool DENSE = false>
__device__ void pa_warp_attend(float* wbase, const float* __restrict__ q_s,
                               const typename KvStore<KIND>::T* __restrict__ kp,
                               const float* __restrict__ ks,
                               const typename KvStore<KIND>::T* __restrict__ vp,
                               const float* __restrict__ vs, const int32_t* __restrict__ pt_row,
                               int n_valid, int NB, int bs, int KV, int kh, int G, int Dh,
                               int span, int worker, int n_workers, int blk0,
                               PaTrace trace = PaTrace()) {
  using T = typename KvStore<KIND>::T;
  constexpr bool QUANT = KIND == KV_INT8 || KIND == KV_INT4;
  constexpr int E = KvVec<KIND>::E;
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int g4 = pa_round4(G);
  const int rb = pa_row_bytes(KIND, Dh);
  const PaWarp ws(wbase, KIND, VEC, G, Dh, span);
  const float sm_div = sqrtf(static_cast<float>(Dh));

  for (int i = lane; i < g4 * Dh; i += 32) ws.acc[i] = 0.f;
  for (int g = lane; g < g4; g += 32) {
    ws.m[g] = -1e30f;
    ws.l[g] = 0.f;
  }

  // lane groups: LPR lanes a row, RPP rows a pass
  int lpr;
  if constexpr (VEC) {
    lpr = 1;
    while (lpr < rb / 16) lpr *= 2;
  } else {
    lpr = PA_SCALAR_LPR;
  }
  const int rpp = 32 / lpr, grp = lane / lpr, li = lane % lpr;
  const int n_vec = VEC ? rb / 16 : 0;
  char* stage_base = reinterpret_cast<char*>(ws.kv);
  const int stage_bytes = 2 * span * rb;          // K rows, then V rows

  // lane t: pool row and scales of position t of span j (len positions)
  auto span_len = [&](int j) { return max(0, min(span, n_valid - j * span)); };
  auto resolve = [&](int j, int blk, int len, size_t& row, float& kst, float& vst) {
    row = 0;
    kst = vst = 1.f;
    if (lane < len) {
      const int s = j * span + lane;
      if (blk < 0 || blk >= NB) blk = 0;
      row = (static_cast<size_t>(blk) * bs + s % bs) * KV + kh;
      if constexpr (QUANT) {
        kst = __ldg(ks + row);
        vst = __ldg(vs + row);
      }
    }
  };
  auto issue = [&](int stage, size_t row_t, int len) {
    if constexpr (VEC) {
      char* kb = stage_base + stage * stage_bytes;
      char* vb = kb + span * rb;
      for (int r0 = 0; r0 < len; r0 += rpp) {
        const int r = r0 + grp;
        const size_t row = __shfl_sync(FULL, row_t, r & 31);
        const bool on = r < len && li < n_vec;
        if (on) {
          const size_t off = row * rb + 16 * li;
          cp_async16(smem_addr(kb + r * rb + 16 * li), reinterpret_cast<const char*>(kp) + off,
                     true);
          cp_async16(smem_addr(vb + r * rb + 16 * li), reinterpret_cast<const char*>(vp) + off,
                     true);
        }
      }
      cp_async_commit();
    }
  };

  int j = worker;
  int len = span_len(j);
  size_t row_t;
  float kst, vst;
  resolve(j, blk0, len, row_t, kst, vst);
  issue(0, row_t, len);
  trace.stamp(0, j, worker);
  for (int stage = 0; len > 0; stage ^= 1) {
    const int jn = j + n_workers, len_n = span_len(jn);
    int blk_n = blk0;
    if constexpr (!DENSE) blk_n = lane < len_n ? pt_row[(jn * span + lane) / bs] : 0;  // in flight
    if constexpr (VEC) cp_async_wait<0>();
    __syncwarp();                         // this span's rows are staged
    const char* kb = stage_base + stage * stage_bytes;
    const char* vb = kb + span * rb;
    trace.stamp(1, j, worker);

    // scores: q.k of four heads at a time, K's scale times the code dot
    for (int r0 = 0; r0 < len; r0 += rpp) {
      const int r = r0 + grp;
      const bool live = r < len;
      const float ksc = __shfl_sync(FULL, kst, r & 31);
      size_t row = 0;
      if constexpr (!VEC) row = __shfl_sync(FULL, row_t, r & 31);
      for (int g0 = 0; g0 < G; g0 += 4) {
        float pd[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (VEC) {
          if (live && li < n_vec) {
            float kf[E];
            pa_decode<KIND>(*reinterpret_cast<const uint4*>(kb + r * rb + 16 * li), kf);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4* qg = reinterpret_cast<const float4*>(q_s + (g0 + u) * Dh + li * E);
#pragma unroll
              for (int e = 0; e < E / 4; ++e) {
                const float4 qv = qg[e];
                pd[u] = fmaf(qv.x, kf[4 * e], pd[u]);
                pd[u] = fmaf(qv.y, kf[4 * e + 1], pd[u]);
                pd[u] = fmaf(qv.z, kf[4 * e + 2], pd[u]);
                pd[u] = fmaf(qv.w, kf[4 * e + 3], pd[u]);
              }
            }
          }
        } else {
          if (live) {
            const T* kr = kp + row * (KIND == KV_INT4 ? Dh / 2 : Dh);
            for (int d = li; d < Dh; d += lpr) {
              const float kv = pa_elem<KIND>(kr, d);
#pragma unroll
              for (int u = 0; u < 4; ++u) pd[u] = fmaf(q_s[(g0 + u) * Dh + d], kv, pd[u]);
            }
          }
        }
        for (int o = lpr / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < 4; ++u) pd[u] += __shfl_xor_sync(FULL, pd[u], o);
        }
        if (live && li == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u) ws.p[r * g4 + g0 + u] = (pd[u] * ksc) / sm_div;
        }
      }
      if constexpr (!VEC) {
        // V's codes as f32 into the staging
        if (live) {
          const T* vr = vp + row * (KIND == KV_INT4 ? Dh / 2 : Dh);
          for (int d = li; d < Dh; d += lpr) ws.kv[r * Dh + d] = pa_elem<KIND>(vr, d);
        }
      }
    }

    trace.stamp(2, j, worker);
    // the next span: rows, scales and copies into the other stage
    size_t row_n;
    float kst_n, vst_n;
    resolve(jn, blk_n, len_n, row_n, kst_n, vst_n);
    if (len_n > 0) issue(stage ^ 1, row_n, len_n);
    __syncwarp();

    // online softmax over the span, one lane a position, four heads at a time
    for (int g0 = 0; g0 < G; g0 += 4) {
      float sc[4], mx[4], sum[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sc[u] = lane < len ? ws.p[lane * g4 + g0 + u] : -1e30f;
        mx[u] = sc[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(FULL, mx[u], o));
      }
      float m_prev[4], m_new[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m_prev[u] = ws.m[g0 + u];
        m_new[u] = fmaxf(m_prev[u], mx[u]);
        sum[u] = lane < len ? expf(sc[u] - m_new[u]) : 0.f;
        sc[u] = sum[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u) sum[u] += __shfl_xor_sync(FULL, sum[u], o);
      }
      if (lane < len) {
#pragma unroll
        for (int u = 0; u < 4; ++u) ws.p[lane * g4 + g0 + u] = sc[u] * vst;
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float corr = expf(m_prev[u] - m_new[u]);
          ws.c[g0 + u] = corr;
          ws.l[g0 + u] = ws.l[g0 + u] * corr + sum[u];
          ws.m[g0 + u] = m_new[u];
        }
      }
    }
    __syncwarp();

    trace.stamp(3, j, worker);
    // P.V: lane owns d = lane, lane + 32, ...; four heads at a time
    for (int d = lane; d < Dh; d += 32) {
      for (int g0 = 0; g0 < G; g0 += 4) {
        float a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = ws.acc[(g0 + u) * Dh + d] * ws.c[g0 + u];
#pragma unroll 4
        for (int t = 0; t < len; ++t) {
          float v;
          if constexpr (VEC)
            v = pa_elem<KIND>(reinterpret_cast<const T*>(vb + t * rb), d);
          else
            v = ws.kv[t * Dh + d];
          const float4 pp = *reinterpret_cast<const float4*>(ws.p + t * g4 + g0);
          a[0] = fmaf(pp.x, v, a[0]);
          a[1] = fmaf(pp.y, v, a[1]);
          a[2] = fmaf(pp.z, v, a[2]);
          a[3] = fmaf(pp.w, v, a[3]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) ws.acc[(g0 + u) * Dh + d] = a[u];
      }
    }
    __syncwarp();                         // before the next span's scores
    trace.stamp(4, j, worker);

    j = jn;
    len = len_n;
    row_t = row_n;
    kst = kst_n;
    vst = vst_n;
  }
  if constexpr (VEC) cp_async_wait<0>();
  __syncwarp();
}

// Merge the block's PA_NW warp partials in ascending warp order into
// `out` (M = max m_w; A = sum acc_w * exp(m_w - M); L likewise).  All
// threads; the caller synchronises before and after.
__device__ inline void pa_cta_merge(float* warps, int kv_kind, bool vec, int G, int Dh, int span,
                                    PaPart out) {
  const int wf = pa_warp_floats(kv_kind, vec, G, Dh, span);
  for (int i = threadIdx.x; i < G * Dh; i += PA_THREADS) {
    const int g = i / Dh;
    float M = -1e30f;
    for (int w = 0; w < PA_NW; ++w)
      M = fmaxf(M, PaWarp(warps + w * wf, kv_kind, vec, G, Dh, span).m[g]);
    float A = 0.f, L = 0.f;
    for (int w = 0; w < PA_NW; ++w) {
      const PaWarp ws(warps + w * wf, kv_kind, vec, G, Dh, span);
      const float f = expf(ws.m[g] - M);
      A = fmaf(ws.acc[i], f, A);
      L = fmaf(ws.l[g], f, L);
    }
    out.acc[i] = A;
    if (i % Dh == 0) {
      out.m[g] = M;
      out.l[g] = L;
    }
  }
}

// The split cluster barrier: every block arrives at its start and waits
// before its first store into another block's shared memory, so that no
// store lands in a block that has not started.
__device__ __forceinline__ void pa_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void pa_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copy n floats at `src` to the same offset `dst` in the shared memory of
// the cluster's blocks r_lo..r_hi (default: all, the caller's own
// included).  The stores are visible to them after the next cluster.sync().
__device__ inline void pa_push(cg::cluster_group& cl, const float* src, float* dst, int n,
                               int r_lo = 0, int r_hi = -1) {
  if (r_hi < 0) r_hi = static_cast<int>(cl.num_blocks()) - 1;
  for (int i = threadIdx.x; i < n * (r_hi - r_lo + 1); i += PA_THREADS)
    cl.map_shared_rank(dst, r_lo + i / n)[i % n] = src[i % n];
}

// Element i (of G*Dh) of the normalised output merged from n partials
// (PaPart layout, `stride` floats apart from `parts` on) in ascending order:
// M = max m_p; A = sum acc_p exp(m_p - M); L likewise; A / max(L, 1e-30).
// With `lse` (non-null) the caller of element g*Dh also writes head g's
// log-sum-exp M + log L to lse[g]: -inf when no position was valid (L = 0;
// the output is then 0).
__device__ inline float pa_merge(const float* parts, int stride, int n, int G, int Dh, int i,
                                 float* __restrict__ lse = nullptr) {
  const int g = i / Dh;
  float M = -1e30f;
  for (int p = 0; p < n; ++p)
    M = fmaxf(M, PaPart(const_cast<float*>(parts) + p * stride, G, Dh).m[g]);
  float A = 0.f, L = 0.f;
  for (int p = 0; p < n; ++p) {
    const PaPart pp(const_cast<float*>(parts) + p * stride, G, Dh);
    const float f = expf(pp.m[g] - M);
    A = fmaf(pp.acc[i], f, A);
    L = fmaf(pp.l[g], f, L);
  }
  if (lse != nullptr && i % Dh == 0)
    lse[g] = L > 0.f ? M + logf(L) : __int_as_float(0xff800000);   // -inf
  return A / fmaxf(L, 1e-30f);
}

// Stage q (G x Dh of either float type) into shared memory as f32, rows
// G..G4-1 zero.
template <typename QT>
__device__ inline void pa_load_q(float* q_s, const QT* __restrict__ q, int G, int Dh) {
  for (int i = threadIdx.x; i < pa_round4(G) * Dh; i += PA_THREADS)
    q_s[i] = i < G * Dh ? to_float(q[i]) : 0.f;
}

// Shared memory of one block of B2 / B5 in floats: q (G4 x Dh), the warps,
// this block's merged partial, and with a cluster the inbox of every
// rank's partial (C x pa_part_floats).
__host__ __device__ inline int pa_smem_floats(int kv_kind, bool vec, int G, int Dh, int span,
                                              int C) {
  return pa_round4(G) * Dh + PA_NW * pa_warp_floats(kv_kind, vec, G, Dh, span) +
         (C > 1 ? C + 1 : 1) * pa_part_floats(G, Dh);
}

constexpr int PA_SPAN = 16;       // B2 / B5's span limit without a cluster
constexpr int PA_SM_COUNT = 132;

// B2 / B5's launch plan over n_ctx = n_blocks * bs positions: one block
// while spans of 16 give each warp at most one, else a cluster of 8 (fewer
// when B * KV * C would pass two blocks an SM) with the shortest span of 8,
// 16 or 32 that still gives each warp about one (the cluster sweep of
// chip_smoke.py); the span limit halves while the block's shared memory
// would pass PA_SMEM_LIMIT (wide f32 rows).
inline void pa_plan(int kv_kind, bool vec, int B, int KV, int G, int Dh, int n_ctx, int bs,
                    int* C, int* span) {
  *C = 1;
  int limit = PA_SPAN;
  if ((n_ctx + pa_span(bs, PA_SPAN) - 1) / pa_span(bs, PA_SPAN) > PA_NW) {
    *C = PA_CLUSTER_MAX;
    while (*C > 1 && B * KV * *C > 2 * PA_SM_COUNT) *C /= 2;
    limit = PA_SPAN_MAX;
  }
  for (;; limit /= 2) {
    *span = *C == 1 ? pa_span(bs, limit) : pa_auto_span(bs, n_ctx, PA_NW * *C, limit);
    if (limit == 1 || 4 * pa_smem_floats(kv_kind, vec, G, Dh, *span, *C) <= PA_SMEM_LIMIT) return;
  }
}

// The body of B2's and B5's kernels: one (sequence, KV head) per cluster of
// C blocks along x, blockIdx.x / C = b * KV + kh.  The warps' partials
// merge in the block; with a cluster each block pushes its merged partial
// to every rank, and rank r writes its slice of the output, merged in
// ascending rank order.  DENSE (B5): sequence b's positions are block b of
// the pool and pt is not read.  `lse` (B5's optional output, else null):
// each head's log-sum-exp, (B, KV, G) f32, written with the output element
// g*Dh of its head (pa_merge).
template <typename QT, int KIND, bool VEC, bool DENSE>
__device__ __forceinline__ void pa_attend(float* smem, const QT* __restrict__ q,
                                          const typename KvStore<KIND>::T* __restrict__ kp,
                                          const float* __restrict__ ks,
                                          const typename KvStore<KIND>::T* __restrict__ vp,
                                          const float* __restrict__ vs,
                                          const int32_t* __restrict__ pt,
                                          const int32_t* __restrict__ pos, float* __restrict__ out,
                                          int NB, int bs, int n_blocks, int KV, int G, int Dh,
                                          int span, float* __restrict__ lse = nullptr) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int unit = blockIdx.x / C;               // (sequence, KV head)
  const int b = unit / KV, kh = unit % KV;
  const int gd = G * Dh, pf = pa_part_floats(G, Dh);
  const int wf = pa_warp_floats(KIND, VEC, G, Dh, span);
  float* q_s = smem;
  float* warps = q_s + pa_round4(G) * Dh;
  float* part = warps + PA_NW * wf;
  float* inbox = part + pf;                      // C partials, by rank

  if (C > 1) pa_cluster_arrive();
  const int warp = threadIdx.x / 32, worker = rank * PA_NW + warp;
  const int32_t* pt_row = DENSE ? nullptr : pt + static_cast<size_t>(b) * n_blocks;
  const int blk0 = DENSE ? b : pa_first_block(pt_row, n_blocks, bs, span, worker);
  const size_t head = static_cast<size_t>(unit) * gd;
  pa_load_q(q_s, q + head, G, Dh);
  const int n_valid = max(0, min(pos[b] + 1, n_blocks * bs));
  __syncthreads();

  pa_warp_attend<KIND, VEC, DENSE>(warps + warp * wf, q_s, kp, ks, vp, vs, pt_row, n_valid, NB,
                                   bs, KV, kh, G, Dh, span, worker, C * PA_NW, blk0);
  __syncthreads();
  pa_cta_merge(warps, KIND, VEC, G, Dh, span, PaPart(part, G, Dh));
  __syncthreads();
  float* lse_u = lse == nullptr ? nullptr : lse + static_cast<size_t>(unit) * G;
  if (C == 1) {
    for (int i = threadIdx.x; i < gd; i += PA_THREADS)
      out[head + i] = pa_merge(part, pf, 1, G, Dh, i, lse_u);
    return;
  }
  // every rank's partial into every rank's inbox; rank r then writes
  // elements [r * ch, (r + 1) * ch) merged in ascending rank order
  pa_cluster_wait();
  pa_push(cl, part, inbox + rank * pf, pf);
  cl.sync();
  const int ch = (gd + C - 1) / C;
  const int hi = min(gd, (rank + 1) * ch);
  for (int i = rank * ch + threadIdx.x; i < hi; i += PA_THREADS)
    out[head + i] = pa_merge(inbox, pf, C, G, Dh, i, lse_u);
}

// Shape checks shared by the launchers.
inline bool pa_shapes_ok(int kv_kind, int NB, int bs, int n_blocks, int KV, int G, int Dh) {
  if (NB <= 0 || bs <= 0 || n_blocks <= 0 || KV <= 0 || G <= 0 || Dh <= 0) return false;
  if (kv_kind == KV_INT4 && Dh % 2 != 0) return false;
  return kv_kind >= KV_INT8 && kv_kind <= KV_BF16;
}

// Raise a kernel's dynamic shared memory cap to PA_SMEM_LIMIT (once per
// kernel) when a launch needs more than the default 48 KB.
template <typename K>
inline cudaError_t pa_allow_smem(K* kernel, int smem) {
  static const void* done[64];
  static int n_done = 0;
  if (smem <= 48 * 1024) return cudaSuccess;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_done; ++i)
    if (done[i] == key) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PA_SMEM_LIMIT);
  if (e == cudaSuccess && n_done < 64) done[n_done++] = key;
  return e;
}

// Launch `kernel` as clusters of C blocks along x.
template <typename... Exp, typename... Act>
inline cudaError_t pa_launch(void (*kernel)(Exp...), int n_blocks, int C, int smem,
                             cudaStream_t stream, Act&&... args) {
  const cudaError_t e = pa_allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(PA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

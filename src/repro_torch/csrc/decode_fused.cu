// Fused ragged decode (B4): paged flash-decode over the live slots named by
// slot_map, with the attention output projection (wo) folded in.
//
// Replaces the TPU kernel repro/kernels/decode_fused.py:fused_decode.
//
//   q          (B, KV, G, Dh)    f32 or bf16, the padded batch
//   k/v pool   (NB, bs, KV, Dh') int8 codes (kv8), nibble pairs (kv4) or
//                                raw f32/bf16 (kv16)
//   k/v scale  (NB, bs, KV, 1)   f32; null for kv16
//   page_table (B, n_blocks)     int32
//   pos        (B,)              int32
//   slot_map   (L,)              int32 live slot ids (may repeat a slot)
//   wo         (KV*G*Dh, D)      f32
//   out        (L, D)            f32, compact over the live slots
//
// The TPU grid runs the KV heads in order and sums each head's
// attn_kh . wo[kh*G*Dh : (kh+1)*G*Dh] into one revisited output block.
// CUDA blocks run in no order, so no block adds into another's output.
//
// What bounds it on an H100: the f32 wo (KV*G*Dh*D*4 bytes, 1.33 MB at
// smollm-135m's 576 x 576: 0.40 us of HBM) plus each live slot's K/V
// bytes; at the serving shapes the time is latency (launch, the attention
// span, two cluster barriers), the ablation and trace of
// tools/bench_paged.py (PERF.md).
//
// Design: one thread block cluster of FD_CLUSTER = 8 blocks per live slot,
// one launch.
// - Attention once per (slot, KV head): with KV <= 8, rank r computes head
//   r % KV over part r / KV of its positions (paged_common.cuh's core); with
//   KV > 8, heads r, r + 8, ....  Each merged partial is pushed into the
//   shared memory of the ranks that need that head (distributed shared
//   memory); one cluster.sync().
// - wo is split along K = KV*G*Dh: rank r owns the contiguous rows
//   [r * kr, (r + 1) * kr), kr = K / 8 (72 at 576), and copies them into
//   its shared memory with a few bulk copies (TMA, cp.async.bulk on an
//   mbarrier) at its start, hidden behind the attention; a slice too large
//   for shared memory is prefetched into L2 and read from global memory.
// - Rank r merges its rows of the attention output from the heads' parts
//   in ascending order, then projects them onto all D columns: warp w
//   takes contiguous rows in ascending order, each lane 16-byte column
//   groups (float4 loads along D); the warps' sums add in ascending warp
//   order; above FD_PASS columns (D 4096, 6144) in passes of FD_PASS
//   columns (a kernel of its own, MULTI: the pass loop costs 9% at one
//   pass), the same sums in the same order a column.  Each rank pushes
//   its column sums to the rank that writes those columns; after a second cluster.sync() rank r adds the eight ranks'
//   sums of its D/8 columns in ascending rank order.  No block adds into
//   another's output, and the arithmetic depends on the slot alone, so a
//   repeated slot gives bit-identical rows.
// A slot id outside [0, B) yields a NaN row (nothing is read).
#include <math.h>

#include "paged_common.cuh"

namespace {

constexpr int FD_CLUSTER = 8;
constexpr int FD_BATCH = 16;       // wo rows in flight a thread
constexpr int FD_CHUNK = 32768;    // bytes a bulk copy or prefetch
constexpr int FD_PASS = 2048;      // output columns a projection pass

// Columns one projection pass takes: all D up to FD_PASS (a multiple of
// the load width), so the warps' partial sums of a pass fit in the scratch
// at any model width (D 4096, 6144: glm4-9b, starcoder2-15b).
__host__ __device__ inline int fd_pass_cols(int D) { return D < FD_PASS ? D : FD_PASS; }

// wo rows (of K = KV*G*Dh) rank r projects: [r * kr, (r + 1) * kr).
__host__ __device__ inline int fd_rows(int K) { return (K + FD_CLUSTER - 1) / FD_CLUSTER; }
// Output columns rank r sums and writes: [r * dc, (r + 1) * dc), a multiple
// of the load width W.
__host__ __device__ inline int fd_cols(int D, int W) {
  const int c = (D + FD_CLUSTER - 1) / FD_CLUSTER;
  return (c + W - 1) / W * W;
}
// The parts (ranks) one head's positions split over; the span gives the
// warps of the head with the fewest parts at most one span each where it
// can (pa_auto_span).
__host__ __device__ inline int fd_parts_max(int KV) {
  return KV <= FD_CLUSTER ? (FD_CLUSTER + KV - 1) / KV : 1;
}
__host__ __device__ inline int fd_parts(int KV, int h) {
  return KV <= FD_CLUSTER ? (FD_CLUSTER - 1 - h) / KV + 1 : 1;
}
// The warps' scratch, reused by the projection's partial sums (one pass's
// columns) afterwards.
__host__ __device__ inline int fd_scratch_floats(int kv_kind, bool vec, int G, int Dh, int D,
                                                 int span) {
  const int warps = PA_NW * pa_warp_floats(kv_kind, vec, G, Dh, span);
  const int psum = pa_round4(PA_NW * fd_pass_cols(D));
  return warps > psum ? warps : psum;
}
// Shared memory without the staged wo rows, in floats: the mbarrier (4), q
// (G4 x Dh), the scratch, this rank's merged partial, the inbox of every
// (head, part) partial, this rank's rows of the attention output, and the
// inbox of every rank's partial sums of this rank's output columns.
__host__ __device__ inline int fd_base_floats(int kv_kind, bool vec, int KV, int G, int Dh, int D,
                                              int W, int span) {
  const int pf = pa_part_floats(G, Dh);
  return 4 + pa_round4(G) * Dh + fd_scratch_floats(kv_kind, vec, G, Dh, D, span) + pf +
         KV * fd_parts_max(KV) * pf + pa_round4(fd_rows(KV * G * Dh)) +
         pa_round4(FD_CLUSTER * fd_cols(D, W));
}
// The span: pa_auto_span's over the warps of the head with the fewest
// parts, its limit halved while the block without the staged wo rows would
// pass PA_SMEM_LIMIT (wide f32 rows).
inline int fd_span(int kv_kind, bool vec, int KV, int G, int Dh, int D, int W, int bs,
                   int n_ctx) {
  for (int limit = PA_SPAN_MAX;; limit /= 2) {
    const int span = pa_auto_span(bs, n_ctx, PA_NW * fd_parts(KV, KV - 1), limit);
    if (limit == 1 || 4 * fd_base_floats(kv_kind, vec, KV, G, Dh, D, W, span) <= PA_SMEM_LIMIT)
      return span;
  }
}
// The staged wo rows of one rank, in floats.
__host__ __device__ inline int fd_wo_floats(int KV, int G, int Dh, int D) {
  return fd_rows(KV * G * Dh) * D;
}

__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}
// The bulk-copy engine (TMA) fills the staged wo rows, counted on one
// mbarrier in bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_to_smem(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Wait for phase 0 of the barrier; a copy that never lands traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  for (int spin = 0; spin < (1 << 22); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
    if (done) return;
  }
  __trap();
}

template <int W> struct FdVec;
template <> struct FdVec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <> struct FdVec<1> {
  using T = float;
  static __device__ __forceinline__ float get(const float& v, int) { return v; }
};

// out[0..nc) = x[r0..r1) . rows[r0..r1)[c0..c0 + nc) (rows of D floats, as
// W-wide vectors; c0 a multiple of W), one warp: lane t takes column
// groups t, t + 32, ..., each summed over the rows in ascending order with
// FD_BATCH loads in flight.
template <int W, typename V>
__device__ __forceinline__ void fd_project(const V* __restrict__ rows, const float* __restrict__ x,
                                           int r0, int r1, int c0, int nc, int D,
                                           float* __restrict__ out) {
  const int ncw = (nc + W - 1) / W, stride = D / W;
  rows += c0 / W;
  for (int c = threadIdx.x % 32; c < ncw; c += 32) {
    float acc[W];
#pragma unroll
    for (int u = 0; u < W; ++u) acc[u] = 0.f;
    for (int k = r0; k < r1; k += FD_BATCH) {
      V wv[FD_BATCH];
#pragma unroll
      for (int u = 0; u < FD_BATCH; ++u)
        if (k + u < r1) wv[u] = rows[(k + u) * stride + c];
#pragma unroll
      for (int u = 0; u < FD_BATCH; ++u) {
        if (k + u < r1) {
          const float xv = x[k + u];
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = fmaf(xv, FdVec<W>::get(wv[u], e), acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e)
      if (c * W + e < nc) out[c * W + e] = acc[e];
  }
}

// Measurement-only variant bits (fused_decode_variant): skip the
// projection, skip the attention, read wo from global memory unstaged,
// and trace: thread 0 of each block writes clock64() cycles since its start
// at the phase ends into out[l, r * dc + i] (i = 0..10) instead of results.
enum FdVariant : int {
  FD_FULL = 0,
  FD_NO_PROJECTION = 1,
  FD_NO_ATTENTION = 2,
  FD_NO_STAGE = 4,
  FD_TRACE = 8
};

template <typename QT, int KIND, bool VEC, int W, bool MULTI>
__global__ void __launch_bounds__(PA_THREADS, 1)
fused_decode_kernel(const QT* __restrict__ q, const typename KvStore<KIND>::T* __restrict__ kp,
                    const float* __restrict__ ks,
                    const typename KvStore<KIND>::T* __restrict__ vp,
                    const float* __restrict__ vs, const int32_t* __restrict__ pt,
                    const int32_t* __restrict__ pos, const int32_t* __restrict__ slot_map,
                    const float* __restrict__ wo, float* __restrict__ out, int B, int NB, int bs,
                    int n_blocks, int KV, int G, int Dh, int D, int span, int stage_wo,
                    int variant) {
  using V = typename FdVec<W>::T;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int l = blockIdx.x / FD_CLUSTER;
  const int gd = G * Dh, K = KV * gd;
  const int kr = fd_rows(K), k0 = rank * kr, nk = max(0, min(kr, K - k0));
  const int dc = fd_cols(D, W), col0 = rank * dc, ncols = max(0, min(dc, D - col0));
  const int slot = slot_map[l];
  float* orow = out + static_cast<size_t>(l) * D + col0;
  const long long t0 = clock64();
  auto stamp = [&](int i) {
    if ((variant & FD_TRACE) && threadIdx.x == 0 && i < ncols)
      orow[i] = static_cast<float>(clock64() - t0);
  };
  if (slot < 0 || slot >= B) {                   // the whole cluster leaves here
    for (int c = threadIdx.x; c < ncols; c += PA_THREADS) orow[c] = nanf("");
    return;
  }
  pa_cluster_arrive();

  const int pf = pa_part_floats(G, Dh), pmax = fd_parts_max(KV);
  const int wf = pa_warp_floats(KIND, VEC, G, Dh, span);
  auto* bar = reinterpret_cast<uint64_t*>(smem);
  float* q_s = smem + 4;
  float* scratch = q_s + pa_round4(G) * Dh;
  float* part = scratch + fd_scratch_floats(KIND, VEC, G, Dh, D, span);
  float* inbox = part + pf;                          // (head, part) partials
  float* x = inbox + KV * pmax * pf;                 // this rank's nk rows
  float* inbox2 = x + pa_round4(kr);                 // FD_CLUSTER x dc sums
  float* wo_s = smem + fd_base_floats(KIND, VEC, KV, G, Dh, D, W, span);
  const bool staged = W == 4 && stage_wo && nk > 0;
  const float* wo_rows = wo + static_cast<size_t>(k0) * D;   // contiguous nk x D

  // this rank's wo rows: into shared memory by bulk copies while the
  // attention runs, else prefetched into L2
  if (threadIdx.x == 0 && W == 4 && nk > 0) {
    const int bytes = 4 * nk * D;
    if (staged) {
      mbar_init(bar);
      mbar_expect(bar, static_cast<uint32_t>(bytes));
    }
    for (int o = 0; o < bytes; o += FD_CHUNK) {
      const int n = min(FD_CHUNK, bytes - o);
      const char* src = reinterpret_cast<const char*>(wo_rows) + o;
      if (staged)
        bulk_to_smem(reinterpret_cast<char*>(wo_s) + o, src, n, bar);
      else
        prefetch_l2(src, n);
    }
  }
  stamp(0);

  // attention: this rank's heads (h0, h0 + 8, ... below KV: one head when
  // KV <= 8) and its part of their positions; each merged partial goes to
  // the inbox of the ranks whose rows need it
  const bool split = KV <= FD_CLUSTER;
  const int warp = threadIdx.x / 32;
  const int part_id = split ? rank / KV : 0;
  const int worker = part_id * PA_NW + warp;
  const int h0 = split ? rank % KV : rank;
  const int32_t* pt_row = pt + static_cast<size_t>(slot) * n_blocks;
  const int blk0 = pa_first_block(pt_row, n_blocks, bs, span, worker);
  const int n_valid = max(0, min(pos[slot] + 1, n_blocks * bs));
  for (int h = h0; h < KV; h += FD_CLUSTER) {
    pa_load_q(q_s, q + (static_cast<size_t>(slot) * KV + h) * gd, G, Dh);
    __syncthreads();
    stamp(1);
    PaTrace tr;
    if ((variant & FD_TRACE) && warp == 0 && ncols >= 16) tr = PaTrace{orow + 11, t0};
    pa_warp_attend<KIND, VEC>(scratch + warp * wf, q_s, kp, ks, vp, vs, pt_row,
                              (variant & FD_NO_ATTENTION) ? 0 : n_valid, NB, bs, KV, h, G, Dh,
                              span, worker, fd_parts(KV, h) * PA_NW, blk0, tr);
    __syncthreads();
    stamp(2);
    pa_cta_merge(scratch, KIND, VEC, G, Dh, span, PaPart(part, G, Dh));
    __syncthreads();
    if (h == h0) pa_cluster_wait();
    // to the ranks whose rows [r * kr, (r + 1) * kr) meet head h's
    pa_push(cl, part, inbox + (h * pmax + part_id) * pf, pf, h * gd / kr,
            min(FD_CLUSTER - 1, ((h + 1) * gd - 1) / kr));
    __syncthreads();                             // before the next head's merge
    stamp(3);
  }
  cl.sync();
  stamp(4);

  // this rank's rows of the attention output, each merged from its head's
  // parts in ascending order
  for (int i = threadIdx.x; i < nk; i += PA_THREADS) {
    const int k = k0 + i, h = k / gd;
    x[i] = pa_merge(inbox + h * pmax * pf, pf, fd_parts(KV, h), G, Dh, k % gd);
  }
  __syncthreads();
  stamp(5);

  // projection of this rank's rows onto the columns [c0, c0 + nc), pc of
  // them a pass: warp w takes the contiguous rows [w * cs, (w + 1) * cs) in
  // ascending order, lane t the column groups t, t + 32, ... of the pass
  // (16-byte loads along a row)
  const int cs = (nk + PA_NW - 1) / PA_NW;
  const int r0 = min(nk, warp * cs), r1 = min(nk, (warp + 1) * cs);
  float* psum = scratch;                         // PA_NW x pc
  if (staged) mbar_wait(bar);
  stamp(6);
  auto project = [&](int c0, int nc, int pc) {
    if (!(variant & FD_NO_PROJECTION)) {
      if (staged)
        fd_project<W>(reinterpret_cast<const V*>(wo_s), x, r0, r1, c0, nc, D, psum + warp * pc);
      else
        fd_project<W>(reinterpret_cast<const V*>(wo_rows), x, r0, r1, c0, nc, D,
                      psum + warp * pc);
    }
    __syncthreads();
    if (c0 == 0) stamp(7);
    // this rank's sums (warps in ascending order) of the pass's columns,
    // into the inbox of the rank that writes the column
    for (int n = threadIdx.x; n < nc; n += PA_THREADS) {
      float a = 0.f;
      if (!(variant & FD_NO_PROJECTION))
        for (int w = 0; w < PA_NW; ++w) a += psum[w * pc + n];
      const int col = c0 + n, owner = col / dc;
      cl.map_shared_rank(inbox2, owner)[rank * dc + col - owner * dc] = a;
    }
  };
  if (MULTI) {
    for (int c0 = 0; c0 < D; c0 += FD_PASS) {
      project(c0, min(FD_PASS, D - c0), FD_PASS);
      if (c0 + FD_PASS < D) __syncthreads();     // before the next pass's sums
    }
  } else {
    project(0, D, D);                            // D <= FD_PASS: one pass
  }
  stamp(8);
  cl.sync();
  stamp(9);
  if (variant & FD_TRACE) {
    stamp(10);
    return;
  }
  // this rank's output columns: the ranks' sums in ascending rank order
  for (int c = threadIdx.x; c < ncols; c += PA_THREADS) {
    float a = 0.f;
    for (int r = 0; r < FD_CLUSTER; ++r) a += inbox2[r * dc + c];
    orow[c] = a;
  }
}

// Arguments of one launch after the kernel's template choice.
struct FdArgs {
  const void *q, *k;
  const float* ks;
  const void* v;
  const float* vs;
  const int32_t *pt, *pos, *sm;
  const float* wo;
  float* out;
  int B, NB, bs, n_blocks, KV, G, Dh, D, span, stage_wo, variant;
};

template <typename QT, int KIND, bool VEC, int W, bool MULTI>
cudaError_t launch_kind(int grid, int smem, cudaStream_t stream, const FdArgs& a) {
  using T = typename KvStore<KIND>::T;
  return pa_launch(fused_decode_kernel<QT, KIND, VEC, W, MULTI>, grid, FD_CLUSTER, smem, stream,
                   static_cast<const QT*>(a.q), static_cast<const T*>(a.k), a.ks,
                   static_cast<const T*>(a.v), a.vs, a.pt, a.pos, a.sm, a.wo, a.out, a.B, a.NB,
                   a.bs, a.n_blocks, a.KV, a.G, a.Dh, a.D, a.span, a.stage_wo, a.variant);
}

template <typename QT, bool VEC, int W, bool MULTI>
cudaError_t launch_vec(int kv_kind, int grid, int smem, cudaStream_t stream, const FdArgs& a) {
  switch (kv_kind) {
    case KV_INT8: return launch_kind<QT, KV_INT8, VEC, W, MULTI>(grid, smem, stream, a);
    case KV_INT4: return launch_kind<QT, KV_INT4, VEC, W, MULTI>(grid, smem, stream, a);
    case KV_F32: return launch_kind<QT, KV_F32, VEC, W, MULTI>(grid, smem, stream, a);
    case KV_BF16: return launch_kind<QT, KV_BF16, VEC, W, MULTI>(grid, smem, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, bool MULTI>
cudaError_t launch_passes(bool vec, bool wvec, int kv_kind, int grid, int smem,
                          cudaStream_t stream, const FdArgs& a) {
  if (vec && wvec) return launch_vec<QT, true, 4, MULTI>(kv_kind, grid, smem, stream, a);
  if (vec) return launch_vec<QT, true, 1, MULTI>(kv_kind, grid, smem, stream, a);
  if (wvec) return launch_vec<QT, false, 4, MULTI>(kv_kind, grid, smem, stream, a);
  return launch_vec<QT, false, 1, MULTI>(kv_kind, grid, smem, stream, a);
}

template <typename QT>
cudaError_t launch(bool vec, bool wvec, int kv_kind, int grid, int smem, cudaStream_t stream,
                   const FdArgs& a) {
  if (a.D > FD_PASS) return launch_passes<QT, true>(vec, wvec, kv_kind, grid, smem, stream, a);
  return launch_passes<QT, false>(vec, wvec, kv_kind, grid, smem, stream, a);
}

bool wo_vector_ok(int D, const void* wo) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(wo) % 16 == 0;
}

// (shared-memory bytes, whether the wo slice is staged) of one block
int plan_smem(int kv_kind, bool vec, bool wvec, int KV, int G, int Dh, int D, int span,
              bool* staged) {
  const int base = fd_base_floats(kv_kind, vec, KV, G, Dh, D, wvec ? 4 : 1, span);
  const long with_wo = static_cast<long>(base) + (wvec ? fd_wo_floats(KV, G, Dh, D) : 0);
  *staged = wvec && 4 * with_wo <= PA_SMEM_LIMIT;
  return 4 * (*staged ? static_cast<int>(with_wo) : base);
}

}  // namespace

// Shared memory bytes of one block (the wrapper refuses shapes above
// PA_SMEM_LIMIT with this number).
extern "C" int fused_decode_smem_bytes(int kv_kind, int KV, int G, int Dh, int D, int bs,
                                       int n_blocks, const void* k, const void* v,
                                       const void* wo) {
  const bool vec = pa_vector_ok(kv_kind, Dh, k, v), wvec = wo_vector_ok(D, wo);
  bool staged;
  return plan_smem(kv_kind, vec, wvec, KV, G, Dh, D,
                   fd_span(kv_kind, vec, KV, G, Dh, D, wvec ? 4 : 1, bs, n_blocks * bs),
                   &staged);
}

// The kernel with measurement variant bits (FdVariant: 1 without the
// projection, 2 without the attention, 4 with wo unstaged, 8 traced) and a
// span limit (1..32; 0: the automatic one); fused_decode() is this with 0,
// 0.
extern "C" cudaError_t fused_decode_variant(const void* q, int q_kind, const void* k,
                                            const void* k_scale, const void* v,
                                            const void* v_scale, int kv_kind,
                                            const void* page_table, const void* pos,
                                            const void* slot_map, const void* wo, void* out,
                                            int B, int L, int NB, int bs, int n_blocks, int KV,
                                            int G, int Dh, int D, int variant,
                                            int span_max, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || D <= 0 || !pa_shapes_ok(kv_kind, NB, bs, n_blocks, KV, G, Dh))
    return cudaErrorInvalidValue;
  if (variant < 0 || variant > 15 || span_max < 0 || span_max > PA_SPAN_MAX)
    return cudaErrorInvalidValue;
  const bool quant = kv_kind == KV_INT8 || kv_kind == KV_INT4;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const bool vec = pa_vector_ok(kv_kind, Dh, k, v);
  const bool wvec = wo_vector_ok(D, wo);
  const int span = span_max > 0 ? pa_span(bs, span_max)
                                 : fd_span(kv_kind, vec, KV, G, Dh, D, wvec ? 4 : 1, bs,
                                           n_blocks * bs);
  bool staged;
  const int smem = plan_smem(kv_kind, vec, wvec, KV, G, Dh, D, span, &staged);
  if (smem > PA_SMEM_LIMIT) return cudaErrorInvalidValue;
  const FdArgs a{q, k, static_cast<const float*>(k_scale), v,
                 static_cast<const float*>(v_scale), static_cast<const int32_t*>(page_table),
                 static_cast<const int32_t*>(pos), static_cast<const int32_t*>(slot_map),
                 static_cast<const float*>(wo), static_cast<float*>(out), B, NB, bs, n_blocks,
                 KV, G, Dh, D, span, staged && !(variant & FD_NO_STAGE) ? 1 : 0, variant};
  const int grid = L * FD_CLUSTER;
  switch (q_kind) {
    case KIND_F32: return launch<float>(vec, wvec, kv_kind, grid, smem, stream, a);
    case KIND_BF16: return launch<__nv_bfloat16>(vec, wvec, kv_kind, grid, smem, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t fused_decode(const void* q, int q_kind, const void* k,
                                    const void* k_scale, const void* v, const void* v_scale,
                                    int kv_kind, const void* page_table, const void* pos,
                                    const void* slot_map, const void* wo, void* out, int B,
                                    int L, int NB, int bs, int n_blocks, int KV, int G, int Dh,
                                    int D, cudaStream_t stream) {
  return fused_decode_variant(q, q_kind, k, k_scale, v, v_scale, kv_kind, page_table, pos,
                              slot_map, wo, out, B, L, NB, bs, n_blocks, KV, G, Dh, D, FD_FULL, 0,
                              stream);
}

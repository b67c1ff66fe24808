// Paged flash-decode attention (B2): one query token per sequence attends
// over that sequence's KV blocks, found through its page-table row.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:paged_attention.
//
//   q          (B, KV, G, Dh)    f32 or bf16 (G query heads share a KV head)
//   k/v pool   (NB, bs, KV, Dh') int8 codes (kv8), nibble pairs (kv4,
//                                Dh' = Dh/2) or raw f32/bf16 (kv16)
//   k/v scale  (NB, bs, KV, 1)   f32; null for kv16
//   page_table (B, n_blocks)     int32 physical block ids
//   pos        (B,)              int32; position s attends iff s <= pos[b]
//   out        (B, KV, G, Dh)    f32
//
// Semantics as the Pallas kernel (see paged_common.cuh).  The Pallas kernel
// walks a sequence's blocks in order on one core, carrying m/l/acc in
// scratch; here a (sequence, KV head)'s blocks are spread over the warps of
// a block, and above a context length over the blocks of a thread block
// cluster, and the partials merge in a fixed order.
//
// What bounds it on an H100: the K/V bytes of the positions up to pos[b]
// (~27 KB at the serving shapes: B = 4, KV 3, G 3, Dh 64, kv8, 80 positions
// at most); the time is latency, not bandwidth (paged_common.cuh).
// Design: one cluster of C blocks of eight warps per (sequence, KV head),
// one launch, no atomics, no second pass.  C = 1 while spans of 16 give
// each warp at most one (n_ctx = n_blocks * bs <= 128 at bs 16), else 8
// (fewer when B * KV * C would pass two blocks an SM), with the shortest
// span of 8, 16 or 32 that still gives each warp about one: the choice of
// the cluster sweep in chip_smoke.py (PERF.md).  Each block pushes its
// merged partial to every rank; rank r writes its slice of the output,
// merged in ascending rank order.
#include "paged_common.cuh"

namespace {

// q (G4 x Dh), the warps, this block's merged partial, and with a cluster
// the inbox of every rank's partial (C x pa_part_floats).
int smem_floats(int kv_kind, bool vec, int G, int Dh, int span, int C) {
  return pa_round4(G) * Dh + PA_NW * pa_warp_floats(kv_kind, vec, G, Dh, span) +
         (C > 1 ? C + 1 : 1) * pa_part_floats(G, Dh);
}

// The launch plan over n_ctx = n_blocks * bs positions (see the note
// above); the span limit halves while the block's shared memory would pass
// PA_SMEM_LIMIT (wide f32 rows).
constexpr int PA_SPAN = 16;       // the span limit without a cluster
constexpr int PA_SM_COUNT = 132;

void plan(int kv_kind, bool vec, int B, int KV, int G, int Dh, int n_ctx, int bs, int* C,
          int* span) {
  *C = 1;
  int limit = PA_SPAN;
  if ((n_ctx + pa_span(bs, PA_SPAN) - 1) / pa_span(bs, PA_SPAN) > PA_NW) {
    *C = PA_CLUSTER_MAX;
    while (*C > 1 && B * KV * *C > 2 * PA_SM_COUNT) *C /= 2;
    limit = PA_SPAN_MAX;
  }
  for (;; limit /= 2) {
    *span = *C == 1 ? pa_span(bs, limit) : pa_auto_span(bs, n_ctx, PA_NW * *C, limit);
    if (limit == 1 || 4 * smem_floats(kv_kind, vec, G, Dh, *span, *C) <= PA_SMEM_LIMIT) return;
  }
}

template <typename QT, int KIND, bool VEC>
__global__ void __launch_bounds__(PA_THREADS, 1)
paged_attn_kernel(const QT* __restrict__ q, const typename KvStore<KIND>::T* __restrict__ kp,
                  const float* __restrict__ ks, const typename KvStore<KIND>::T* __restrict__ vp,
                  const float* __restrict__ vs, const int32_t* __restrict__ pt,
                  const int32_t* __restrict__ pos, float* __restrict__ out, int NB, int bs,
                  int n_blocks, int KV, int G, int Dh, int span) {
  extern __shared__ __align__(16) float smem[];
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
  const int32_t* pt_row = pt + static_cast<size_t>(b) * n_blocks;
  const int blk0 = pa_first_block(pt_row, n_blocks, bs, span, worker);
  const size_t head = static_cast<size_t>(unit) * gd;
  pa_load_q(q_s, q + head, G, Dh);
  const int n_valid = max(0, min(pos[b] + 1, n_blocks * bs));
  __syncthreads();

  pa_warp_attend<KIND, VEC>(warps + warp * wf, q_s, kp, ks, vp, vs, pt_row, n_valid, NB, bs, KV,
                            kh, G, Dh, span, worker, C * PA_NW, blk0);
  __syncthreads();
  pa_cta_merge(warps, KIND, VEC, G, Dh, span, PaPart(part, G, Dh));
  __syncthreads();
  if (C == 1) {
    for (int i = threadIdx.x; i < gd; i += PA_THREADS) out[head + i] = pa_merge(part, pf, 1, G, Dh, i);
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
    out[head + i] = pa_merge(inbox, pf, C, G, Dh, i);
}

template <typename QT, int KIND, bool VEC>
cudaError_t launch_kind(int grid, int C, int smem, cudaStream_t stream, const QT* q,
                        const void* k, const float* ks, const void* v, const float* vs,
                        const int32_t* pt, const int32_t* pos, float* out, int NB, int bs,
                        int n_blocks, int KV, int G, int Dh, int span) {
  using T = typename KvStore<KIND>::T;
  return pa_launch(paged_attn_kernel<QT, KIND, VEC>, grid, C, smem, stream, q,
                   static_cast<const T*>(k), ks, static_cast<const T*>(v), vs, pt, pos, out, NB,
                   bs, n_blocks, KV, G, Dh, span);
}

template <typename QT, bool VEC>
cudaError_t launch_vec(int kv_kind, int grid, int C, int smem, cudaStream_t stream, const QT* q,
                       const void* k, const float* ks, const void* v, const float* vs,
                       const int32_t* pt, const int32_t* pos, float* out, int NB, int bs,
                       int n_blocks, int KV, int G, int Dh, int span) {
  switch (kv_kind) {
    case KV_INT8:
      return launch_kind<QT, KV_INT8, VEC>(grid, C, smem, stream, q, k, ks, v, vs, pt, pos, out,
                                           NB, bs, n_blocks, KV, G, Dh, span);
    case KV_INT4:
      return launch_kind<QT, KV_INT4, VEC>(grid, C, smem, stream, q, k, ks, v, vs, pt, pos, out,
                                           NB, bs, n_blocks, KV, G, Dh, span);
    case KV_F32:
      return launch_kind<QT, KV_F32, VEC>(grid, C, smem, stream, q, k, ks, v, vs, pt, pos, out,
                                          NB, bs, n_blocks, KV, G, Dh, span);
    case KV_BF16:
      return launch_kind<QT, KV_BF16, VEC>(grid, C, smem, stream, q, k, ks, v, vs, pt, pos, out,
                                           NB, bs, n_blocks, KV, G, Dh, span);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t launch(bool vec, int kv_kind, int grid, int C, int smem, cudaStream_t stream,
                   const QT* q, const void* k, const float* ks, const void* v, const float* vs,
                   const int32_t* pt, const int32_t* pos, float* out, int NB, int bs,
                   int n_blocks, int KV, int G, int Dh, int span) {
  if (vec)
    return launch_vec<QT, true>(kv_kind, grid, C, smem, stream, q, k, ks, v, vs, pt, pos, out,
                                NB, bs, n_blocks, KV, G, Dh, span);
  return launch_vec<QT, false>(kv_kind, grid, C, smem, stream, q, k, ks, v, vs, pt, pos, out,
                               NB, bs, n_blocks, KV, G, Dh, span);
}

}  // namespace

// Shared memory bytes of one block at the automatic plan (the wrapper
// refuses shapes above PA_SMEM_LIMIT with this number).
extern "C" int paged_attention_smem_bytes(int kv_kind, int B, int KV, int G, int Dh, int bs,
                                          int n_blocks, const void* k, const void* v) {
  const bool vec = pa_vector_ok(kv_kind, Dh, k, v);
  int C, span;
  plan(kv_kind, vec, B, KV, G, Dh, n_blocks * bs, bs, &C, &span);
  return static_cast<int>(sizeof(float)) * smem_floats(kv_kind, vec, G, Dh, span, C);
}

// The launch plan the automatic choice makes: plan[0] = 1 for 16-byte
// vector loads (0: scalar loads), plan[1] = the cluster size, plan[2] = the
// span.
extern "C" int paged_attention_plan(int kv_kind, int B, int KV, int G, int Dh, int bs,
                                    int n_blocks, const void* k, const void* v, int* out) {
  const bool vec = pa_vector_ok(kv_kind, Dh, k, v);
  out[0] = vec ? 1 : 0;
  plan(kv_kind, vec, B, KV, G, Dh, n_blocks * bs, bs, &out[1], &out[2]);
  return 0;
}

// The kernel with an explicit cluster size (1..8) and span limit (1..32);
// 0 takes the automatic choice.  paged_attention() is this with 0, 0.
extern "C" cudaError_t paged_attention_config(const void* q, int q_kind, const void* k,
                                              const void* k_scale, const void* v,
                                              const void* v_scale, int kv_kind,
                                              const void* page_table, const void* pos, void* out,
                                              int B, int NB, int bs, int n_blocks, int KV, int G,
                                              int Dh, int cluster, int span_max,
                                              cudaStream_t stream) {
  if (B <= 0 || !pa_shapes_ok(kv_kind, NB, bs, n_blocks, KV, G, Dh)) return cudaErrorInvalidValue;
  if (cluster < 0 || cluster > PA_CLUSTER_MAX || span_max < 0 || span_max > PA_SPAN_MAX)
    return cudaErrorInvalidValue;
  const bool quant = kv_kind == KV_INT8 || kv_kind == KV_INT4;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const bool vec = pa_vector_ok(kv_kind, Dh, k, v);
  int C, span;
  plan(kv_kind, vec, B, KV, G, Dh, n_blocks * bs, bs, &C, &span);
  if (cluster > 0) C = cluster;
  if (span_max > 0) span = pa_span(bs, span_max);
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(kv_kind, vec, G, Dh, span, C);
  if (smem > PA_SMEM_LIMIT) return cudaErrorInvalidValue;
  const int grid = B * KV * C;
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* pp = static_cast<const int32_t*>(pos);
  auto* op = static_cast<float*>(out);
  switch (q_kind) {
    case KIND_F32:
      return launch(vec, kv_kind, grid, C, smem, stream, static_cast<const float*>(q), k, ks, v,
                    vs, pt, pp, op, NB, bs, n_blocks, KV, G, Dh, span);
    case KIND_BF16:
      return launch(vec, kv_kind, grid, C, smem, stream, static_cast<const __nv_bfloat16*>(q), k,
                    ks, v, vs, pt, pp, op, NB, bs, n_blocks, KV, G, Dh, span);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t paged_attention(const void* q, int q_kind, const void* k,
                                       const void* k_scale, const void* v, const void* v_scale,
                                       int kv_kind, const void* page_table, const void* pos,
                                       void* out, int B, int NB, int bs, int n_blocks, int KV,
                                       int G, int Dh, cudaStream_t stream) {
  return paged_attention_config(q, q_kind, k, k_scale, v, v_scale, kv_kind, page_table, pos, out,
                                B, NB, bs, n_blocks, KV, G, Dh, 0, 0, stream);
}

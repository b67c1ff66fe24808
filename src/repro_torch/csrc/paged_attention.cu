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
// merged in ascending rank order (pa_attend and pa_plan, shared with B5).
#include "paged_common.cuh"

namespace {

template <typename QT, int KIND, bool VEC>
__global__ void __launch_bounds__(PA_THREADS, 1)
paged_attn_kernel(const QT* __restrict__ q, const typename KvStore<KIND>::T* __restrict__ kp,
                  const float* __restrict__ ks, const typename KvStore<KIND>::T* __restrict__ vp,
                  const float* __restrict__ vs, const int32_t* __restrict__ pt,
                  const int32_t* __restrict__ pos, float* __restrict__ out, int NB, int bs,
                  int n_blocks, int KV, int G, int Dh, int span) {
  extern __shared__ __align__(16) float smem[];
  pa_attend<QT, KIND, VEC, false>(smem, q, kp, ks, vp, vs, pt, pos, out, NB, bs, n_blocks, KV, G,
                                  Dh, span);
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
  pa_plan(kv_kind, vec, B, KV, G, Dh, n_blocks * bs, bs, &C, &span);
  return static_cast<int>(sizeof(float)) * pa_smem_floats(kv_kind, vec, G, Dh, span, C);
}

// The launch plan the automatic choice makes: plan[0] = 1 for 16-byte
// vector loads (0: scalar loads), plan[1] = the cluster size, plan[2] = the
// span.
extern "C" int paged_attention_plan(int kv_kind, int B, int KV, int G, int Dh, int bs,
                                    int n_blocks, const void* k, const void* v, int* out) {
  const bool vec = pa_vector_ok(kv_kind, Dh, k, v);
  out[0] = vec ? 1 : 0;
  pa_plan(kv_kind, vec, B, KV, G, Dh, n_blocks * bs, bs, &out[1], &out[2]);
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
  pa_plan(kv_kind, vec, B, KV, G, Dh, n_blocks * bs, bs, &C, &span);
  if (cluster > 0) C = cluster;
  if (span_max > 0) span = pa_span(bs, span_max);
  const int smem = static_cast<int>(sizeof(float)) * pa_smem_floats(kv_kind, vec, G, Dh, span, C);
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

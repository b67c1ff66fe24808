// Flash-decode attention of one query token over a dense int8 KV cache
// (B5).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention.
//
//   q        (B, KV, G, Dh)  f32 or bf16   (G query heads share a KV head)
//   k, v     (B, S, KV, Dh)  int8 codes
//   k/v_scale(B, S, KV, 1)   f32 per-(position, head) scales
//   pos      (B,)            int32; position s attends iff s <= pos[b]
//   out      (B, KV, G, Dh)  f32
//   lse      (B, KV, G)      f32, optional (null: not written): each
//                            head's log-sum-exp m + log l of the scores,
//                            -inf (and out 0) where no position is valid
//                            (pos[b] < 0: a rank's slice of a cache cut
//                            over its sequence that ends before pos)
//
// Semantics as the Pallas kernel: K/V are dequantized in f32 (code *
// scale; K's scale multiplies the row's code dot product, V's is folded
// into the probability), scores are q.k / sqrt(Dh) (the plain version
// scales each code and multiplies by Dh^-0.5: rounding only), and an
// online softmax (m starting at -1e30, l
// floored at 1e-30 at the end) accumulates over the positions up to pos[b].
//
// What bounds it on an H100: the cache bytes of the positions up to pos[b]
// (int8 codes plus f32 scales, ~27 KB at the serving shapes: B = 4, KV 3,
// G 3, Dh 64, 80 positions at most); the arithmetic is ~4*G*Dh flops a
// position.  At those sizes the time is latency (paged_common.cuh).
//
// Design: the paged flash-decode core of B2 (paged_common.cuh) over the
// dense cache viewed as a pool of NB = B blocks of bs = S positions, with
// the identity page table taken at compile time (DENSE: sequence b reads
// block b; no table, no dependent load).  B2's launch plan (pa_plan): one
// block of eight warps per (sequence, KV head) with spans of 16 positions
// while S <= 128, an 8-block cluster with the automatic span above that;
// a plan measured per shape class (kernels/tuning.py) launches through
// decode_attention_config.  Warps take spans with 16-byte cp.async loads (a scalar-load path for
// rows that are not 16-byte vectors or caches off a 16-byte boundary), and
// the partials merge in a fixed order, so two launches give equal bits.
#include "paged_common.cuh"

namespace {

template <typename QT, bool VEC>
__global__ void __launch_bounds__(PA_THREADS, 1)
decode_attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kc,
                   const float* __restrict__ ks, const int8_t* __restrict__ vc,
                   const float* __restrict__ vs, const int32_t* __restrict__ pos,
                   float* __restrict__ out, float* __restrict__ lse, int B, int S, int KV, int G,
                   int Dh, int span) {
  extern __shared__ __align__(16) float smem[];
  pa_attend<QT, KV_INT8, VEC, true>(smem, q, kc, ks, vc, vs, nullptr, pos, out, B, S, 1, KV, G,
                                    Dh, span, lse);
}

template <typename QT, bool VEC>
cudaError_t launch(int C, int span, int smem, cudaStream_t stream, const void* q,
                   const void* k, const void* k_scale, const void* v, const void* v_scale,
                   const void* pos, void* out, void* lse, int B, int S, int KV, int G, int Dh) {
  return pa_launch(decode_attn_kernel<QT, VEC>, B * KV * C, C, smem, stream,
                   static_cast<const QT*>(q), static_cast<const int8_t*>(k),
                   static_cast<const float*>(k_scale), static_cast<const int8_t*>(v),
                   static_cast<const float*>(v_scale), static_cast<const int32_t*>(pos),
                   static_cast<float*>(out), static_cast<float*>(lse), B, S, KV, G, Dh, span);
}

}  // namespace

// The launch plan: plan[0] = 1 for 16-byte vector loads (0: scalar loads),
// plan[1] = the cluster size, plan[2] = the span, plan[3] = the shared
// memory bytes of one block.
extern "C" int decode_attention_plan(int B, int S, int KV, int G, int Dh, const void* k,
                                     const void* v, int* plan) {
  const bool vec = pa_vector_ok(KV_INT8, Dh, k, v);
  plan[0] = vec ? 1 : 0;
  pa_plan(KV_INT8, vec, B, KV, G, Dh, S, S, &plan[1], &plan[2]);
  plan[3] = static_cast<int>(sizeof(float)) *
            pa_smem_floats(KV_INT8, vec, G, Dh, plan[2], plan[1]);
  return 0;
}

// The kernel with an explicit cluster size (1..8) and span limit (1..32);
// 0 takes the automatic choice (decode_attention_plan).  The tuning cache's
// B5 plans launch through here; decode_attention_int8() is this with 0, 0
// and no lse.  `lse` may be null (not written).
extern "C" cudaError_t decode_attention_config(const void* q, int q_kind, const void* k,
                                               const void* k_scale, const void* v,
                                               const void* v_scale, const void* pos, void* out,
                                               void* lse, int B, int S, int KV, int G, int Dh,
                                               int cluster, int span_max, cudaStream_t stream) {
  // cudaErrorInvalidValue: bad shapes or plan; cudaErrorLaunchOutOfResources:
  // the plan's block needs more than PA_SMEM_LIMIT bytes of shared memory
  if (B <= 0 || !pa_shapes_ok(KV_INT8, B, S, 1, KV, G, Dh)) return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (cluster < 0 || cluster > PA_CLUSTER_MAX || span_max < 0 || span_max > PA_SPAN_MAX)
    return cudaErrorInvalidValue;
  int plan[4];
  decode_attention_plan(B, S, KV, G, Dh, k, v, plan);
  const bool vec = plan[0] != 0;
  int C = plan[1], span = plan[2], smem = plan[3];
  if (cluster > 0 || span_max > 0) {
    if (cluster > 0) C = cluster;
    if (span_max > 0) span = pa_span(S, span_max);
    smem = static_cast<int>(sizeof(float)) * pa_smem_floats(KV_INT8, vec, G, Dh, span, C);
  }
  if (smem > PA_SMEM_LIMIT) return cudaErrorLaunchOutOfResources;
  switch (q_kind) {
    case KIND_F32:
      return vec ? launch<float, true>(C, span, smem, stream, q, k, k_scale, v, v_scale, pos, out,
                                       lse, B, S, KV, G, Dh)
                 : launch<float, false>(C, span, smem, stream, q, k, k_scale, v, v_scale, pos,
                                        out, lse, B, S, KV, G, Dh);
    case KIND_BF16:
      return vec ? launch<__nv_bfloat16, true>(C, span, smem, stream, q, k, k_scale, v, v_scale,
                                               pos, out, lse, B, S, KV, G, Dh)
                 : launch<__nv_bfloat16, false>(C, span, smem, stream, q, k, k_scale, v,
                                                v_scale, pos, out, lse, B, S, KV, G, Dh);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t decode_attention_int8(const void* q, int q_kind, const void* k,
                                             const void* k_scale, const void* v,
                                             const void* v_scale, const void* pos, void* out,
                                             int B, int S, int KV, int G, int Dh,
                                             cudaStream_t stream) {
  return decode_attention_config(q, q_kind, k, k_scale, v, v_scale, pos, out, nullptr, B, S, KV,
                                 G, Dh, 0, 0, stream);
}

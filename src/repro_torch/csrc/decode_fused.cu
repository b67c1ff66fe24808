// Fused ragged decode: paged flash-decode over the live slots named by
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
// CUDA blocks run in no order, so no block sums into another's output:
// grid (L, ceil(D / 128)), each block reads slot_map[l], recomputes that
// slot's attention for every KV head in ascending order (the paged core of
// paged_common.cuh) into shared memory, then projects its own 128-column
// tile of wo: per KV head, four interleaved partial sums over its G*Dh
// inputs, the heads' sums added in ascending order.  The result is
// deterministic, and duplicate slot rows compute identical values.  A slot
// id outside [0, B) yields a NaN row (nothing is read).
//
// What bounds it on an H100: the f32 wo (KV*G*Dh*D*4 bytes, 1.33 MB at
// smollm-135m's 576 x 576) plus each live slot's KV bytes.  Recomputing the
// attention in every column tile re-reads the slot's KV from L2 (80
// positions x 3 heads at the serving shapes): cheap next to wo.
#include <math.h>

#include "paged_common.cuh"

namespace {

template <typename QT, int KIND>
__global__ void __launch_bounds__(PA_THREADS)
fused_decode_kernel(const QT* __restrict__ q, const typename KvStore<KIND>::T* __restrict__ kp,
                    const float* __restrict__ ks,
                    const typename KvStore<KIND>::T* __restrict__ vp,
                    const float* __restrict__ vs, const int32_t* __restrict__ pt,
                    const int32_t* __restrict__ pos, const int32_t* __restrict__ slot_map,
                    const float* __restrict__ wo, float* __restrict__ out, int B, int NB, int bs,
                    int n_blocks, int KV, int G, int Dh, int D) {
  extern __shared__ float smem[];
  PaSmem sm(smem, G, Dh);
  float* attn = smem + pa_smem_floats(G, Dh);   // KV * G * Dh
  const int l = blockIdx.x;
  const int n = blockIdx.y * PA_THREADS + threadIdx.x;
  const int slot = slot_map[l];
  if (slot < 0 || slot >= B) {
    if (n < D) out[static_cast<size_t>(l) * D + n] = nanf("");
    return;
  }
  const int gd = G * Dh;
  for (int kh = 0; kh < KV; ++kh) {
    paged_attend<QT, KIND>(sm, q + static_cast<size_t>(slot * KV + kh) * gd, kp, ks, vp, vs,
                           pt + static_cast<size_t>(slot) * n_blocks, pos[slot], NB, bs,
                           n_blocks, KV, kh, G, Dh);
    for (int i = threadIdx.x; i < gd; i += PA_THREADS)
      attn[kh * gd + i] = sm.acc[i] / fmaxf(sm.l[i / Dh], 1e-30f);
    __syncthreads();   // the next head overwrites acc and l
  }
  if (n < D) {
    // each head's G*Dh inputs in four interleaved partial sums (rounding
    // chains of G*Dh/4 terms, not KV*G*Dh), the heads added in ascending
    // order
    float a = 0.f;
    for (int kh = 0; kh < KV; ++kh) {
      const float* x = attn + kh * gd;
      const float* w = wo + static_cast<size_t>(kh) * gd * D + n;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      int i = 0;
      for (; i + 4 <= gd; i += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) p[u] = fmaf(x[i + u], w[static_cast<size_t>(i + u) * D], p[u]);
      }
      for (; i < gd; ++i) p[0] = fmaf(x[i], w[static_cast<size_t>(i) * D], p[0]);
      a += (p[0] + p[1]) + (p[2] + p[3]);
    }
    out[static_cast<size_t>(l) * D + n] = a;
  }
}

template <typename QT>
cudaError_t launch(int kv_kind, dim3 grid, int smem, cudaStream_t stream, const QT* q,
                   const void* k, const float* ks, const void* v, const float* vs,
                   const int32_t* pt, const int32_t* pos, const int32_t* sm, const float* wo,
                   float* out, int B, int NB, int bs, int n_blocks, int KV, int G, int Dh,
                   int D) {
  switch (kv_kind) {
    case KV_INT8:
    case KV_INT4: {
      const auto* kc = static_cast<const int8_t*>(k);
      const auto* vc = static_cast<const int8_t*>(v);
      if (kv_kind == KV_INT8)
        fused_decode_kernel<QT, KV_INT8><<<grid, PA_THREADS, smem, stream>>>(
            q, kc, ks, vc, vs, pt, pos, sm, wo, out, B, NB, bs, n_blocks, KV, G, Dh, D);
      else
        fused_decode_kernel<QT, KV_INT4><<<grid, PA_THREADS, smem, stream>>>(
            q, kc, ks, vc, vs, pt, pos, sm, wo, out, B, NB, bs, n_blocks, KV, G, Dh, D);
      break;
    }
    case KV_F32:
      fused_decode_kernel<QT, KV_F32><<<grid, PA_THREADS, smem, stream>>>(
          q, static_cast<const float*>(k), ks, static_cast<const float*>(v), vs, pt, pos, sm,
          wo, out, B, NB, bs, n_blocks, KV, G, Dh, D);
      break;
    case KV_BF16:
      fused_decode_kernel<QT, KV_BF16><<<grid, PA_THREADS, smem, stream>>>(
          q, static_cast<const __nv_bfloat16*>(k), ks, static_cast<const __nv_bfloat16*>(v),
          vs, pt, pos, sm, wo, out, B, NB, bs, n_blocks, KV, G, Dh, D);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t fused_decode(const void* q, int q_kind, const void* k,
                                    const void* k_scale, const void* v, const void* v_scale,
                                    int kv_kind, const void* page_table, const void* pos,
                                    const void* slot_map, const void* wo, void* out, int B,
                                    int L, int NB, int bs, int n_blocks, int KV, int G, int Dh,
                                    int D, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || D <= 0 || !pa_shapes_ok(kv_kind, NB, bs, n_blocks, KV, G, Dh))
    return cudaErrorInvalidValue;
  const bool quant = kv_kind == KV_INT8 || kv_kind == KV_INT4;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * (pa_smem_floats(G, Dh) + KV * G * Dh);
  if (smem > PA_SMEM_LIMIT) return cudaErrorInvalidValue;
  const dim3 grid(L, (D + PA_THREADS - 1) / PA_THREADS);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* sm = static_cast<const int32_t*>(slot_map);
  const auto* w = static_cast<const float*>(wo);
  auto* op = static_cast<float*>(out);
  switch (q_kind) {
    case KIND_F32:
      return launch(kv_kind, grid, smem, stream, static_cast<const float*>(q), k, ks, v, vs, pt,
                    pp, sm, w, op, B, NB, bs, n_blocks, KV, G, Dh, D);
    case KIND_BF16:
      return launch(kv_kind, grid, smem, stream, static_cast<const __nv_bfloat16*>(q), k, ks, v,
                    vs, pt, pp, sm, w, op, B, NB, bs, n_blocks, KV, G, Dh, D);
    default:
      return cudaErrorInvalidValue;
  }
}

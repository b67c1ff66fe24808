// Paged flash-decode attention: one query token per sequence attends over
// that sequence's KV blocks, found through its page-table row.
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
// Semantics as the Pallas kernel (see paged_common.cuh): f32 dequant,
// scores / sqrt(Dh), online softmax, blocks past pos skipped.  The Pallas
// kernel receives the page table by scalar prefetch and lets the BlockSpec
// index map route each block's DMA; here each CUDA block reads its own
// page-table row and computes the pool offsets itself.
//
// What bounds it on an H100: the KV bytes of the positions up to pos[b]
// (codes plus f32 scales), ~4*G*Dh flops per position.  Design: one
// 128-thread block per (sequence, KV head) computes all G query rows of
// that head, so each KV row is read from device memory once; each tile of
// 32 positions is gathered and dequantized into shared memory, one warp per
// query row computes the tile's scores and softmax terms with shuffles.
// bs is a runtime argument: a tile may span several pool blocks.
#include "paged_common.cuh"

namespace {

template <typename QT, int KIND>
__global__ void __launch_bounds__(PA_THREADS)
paged_attn_kernel(const QT* __restrict__ q, const typename KvStore<KIND>::T* __restrict__ kp,
                  const float* __restrict__ ks, const typename KvStore<KIND>::T* __restrict__ vp,
                  const float* __restrict__ vs, const int32_t* __restrict__ pt,
                  const int32_t* __restrict__ pos, float* __restrict__ out, int NB, int bs,
                  int n_blocks, int KV, int G, int Dh) {
  extern __shared__ float smem[];
  PaSmem sm(smem, G, Dh);
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const size_t head = static_cast<size_t>(b * KV + kh) * G * Dh;
  paged_attend<QT, KIND>(sm, q + head, kp, ks, vp, vs, pt + static_cast<size_t>(b) * n_blocks,
                         pos[b], NB, bs, n_blocks, KV, kh, G, Dh);
  for (int i = threadIdx.x; i < G * Dh; i += PA_THREADS)
    out[head + i] = sm.acc[i] / fmaxf(sm.l[i / Dh], 1e-30f);
}

template <typename QT>
cudaError_t launch(int kv_kind, dim3 grid, int smem, cudaStream_t stream, const QT* q,
                   const void* k, const float* ks, const void* v, const float* vs,
                   const int32_t* pt, const int32_t* pos, float* out, int NB, int bs,
                   int n_blocks, int KV, int G, int Dh) {
  switch (kv_kind) {
    case KV_INT8:
    case KV_INT4: {
      const auto* kc = static_cast<const int8_t*>(k);
      const auto* vc = static_cast<const int8_t*>(v);
      if (kv_kind == KV_INT8)
        paged_attn_kernel<QT, KV_INT8><<<grid, PA_THREADS, smem, stream>>>(
            q, kc, ks, vc, vs, pt, pos, out, NB, bs, n_blocks, KV, G, Dh);
      else
        paged_attn_kernel<QT, KV_INT4><<<grid, PA_THREADS, smem, stream>>>(
            q, kc, ks, vc, vs, pt, pos, out, NB, bs, n_blocks, KV, G, Dh);
      break;
    }
    case KV_F32:
      paged_attn_kernel<QT, KV_F32><<<grid, PA_THREADS, smem, stream>>>(
          q, static_cast<const float*>(k), ks, static_cast<const float*>(v), vs, pt, pos, out,
          NB, bs, n_blocks, KV, G, Dh);
      break;
    case KV_BF16:
      paged_attn_kernel<QT, KV_BF16><<<grid, PA_THREADS, smem, stream>>>(
          q, static_cast<const __nv_bfloat16*>(k), ks, static_cast<const __nv_bfloat16*>(v),
          vs, pt, pos, out, NB, bs, n_blocks, KV, G, Dh);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t paged_attention(const void* q, int q_kind, const void* k,
                                       const void* k_scale, const void* v, const void* v_scale,
                                       int kv_kind, const void* page_table, const void* pos,
                                       void* out, int B, int NB, int bs, int n_blocks, int KV,
                                       int G, int Dh, cudaStream_t stream) {
  if (B <= 0 || !pa_shapes_ok(kv_kind, NB, bs, n_blocks, KV, G, Dh)) return cudaErrorInvalidValue;
  const bool quant = kv_kind == KV_INT8 || kv_kind == KV_INT4;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * pa_smem_floats(G, Dh);
  if (smem > PA_SMEM_LIMIT) return cudaErrorInvalidValue;
  const dim3 grid(B * KV);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* pp = static_cast<const int32_t*>(pos);
  auto* op = static_cast<float*>(out);
  switch (q_kind) {
    case KIND_F32:
      return launch(kv_kind, grid, smem, stream, static_cast<const float*>(q), k, ks, v, vs, pt,
                    pp, op, NB, bs, n_blocks, KV, G, Dh);
    case KIND_BF16:
      return launch(kv_kind, grid, smem, stream, static_cast<const __nv_bfloat16*>(q), k, ks, v,
                    vs, pt, pp, op, NB, bs, n_blocks, KV, G, Dh);
    default:
      return cudaErrorInvalidValue;
  }
}

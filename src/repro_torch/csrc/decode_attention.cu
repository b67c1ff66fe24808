// Flash-decode attention of one query token over a dense int8 KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention.
//
//   q        (B, KV, G, Dh)  f32 or bf16   (G query heads share a KV head)
//   k, v     (B, S, KV, Dh)  int8 codes
//   k/v_scale(B, S, KV, 1)   f32 per-(position, head) scales
//   pos      (B,)            int32; position s attends iff s <= pos[b]
//   out      (B, KV, G, Dh)  f32
//
// Semantics as the Pallas kernel: K/V are dequantized in f32 (code * scale),
// scores are q.k * Dh^-0.5, and an online softmax (m starting at -1e30, l
// floored at 1e-30 at the end) accumulates over tiles of positions.  Tiles
// wholly past pos[b] are skipped: their contribution is exactly zero.
//
// What bounds it on an H100: the cache bytes (int8 codes plus f32 scales of
// the positions up to pos[b]); the arithmetic is ~4*G*Dh flops per position.
// Design: one 128-thread block per (b, kv head) computes all G query rows of
// that head, so each cache row is read from device memory once.  Each tile of
// 32 positions is dequantized into shared memory; one warp per query row
// computes the 32 scores (one lane per position) and the tile's max and sum
// with warp shuffles; then every thread updates its (g, d) accumulators.
// Exact expf, no fast-math.  Splitting S across blocks (split-K decode) is
// later work.
#include "common.cuh"

namespace {

constexpr int TS = 32;           // positions per tile: one per lane
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;

template <typename QT>
__global__ void __launch_bounds__(THREADS)
decode_attn_int8_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kc,
                        const float* __restrict__ ks, const int8_t* __restrict__ vc,
                        const float* __restrict__ vs, const int32_t* __restrict__ pos,
                        float* __restrict__ out, int S, int KV, int G, int Dh,
                        float sm_scale) {
  extern __shared__ float smem[];
  float* k_s = smem;                    // TS x (Dh + 1): padded, lanes read rows
  float* v_s = k_s + TS * (Dh + 1);     // TS x Dh
  float* q_s = v_s + TS * Dh;           // G x Dh
  float* acc_s = q_s + G * Dh;          // G x Dh
  float* p_s = acc_s + G * Dh;          // G x TS
  float* m_s = p_s + G * TS;            // G running max
  float* l_s = m_s + G;                 // G running sum
  float* c_s = l_s + G;                 // G this tile's rescale factor

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_valid = min(pos[b] + 1, S);
  const size_t head = static_cast<size_t>(b * KV + kh) * G * Dh;

  for (int i = threadIdx.x; i < G * Dh; i += THREADS) {
    q_s[i] = to_float(q[head + i]);
    acc_s[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += TS) {
    const int nt = min(TS, n_valid - s0);
    for (int i = threadIdx.x; i < nt * Dh; i += THREADS) {
      const int t = i / Dh, d = i % Dh;
      const size_t row = (static_cast<size_t>(b) * S + s0 + t) * KV + kh;
      k_s[t * (Dh + 1) + d] = static_cast<float>(kc[row * Dh + d]) * ks[row];
      v_s[t * Dh + d] = static_cast<float>(vc[row * Dh + d]) * vs[row];
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      float sc = -1e30f;
      if (lane < nt) {
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot += q_s[g * Dh + d] * k_s[lane * (Dh + 1) + d];
        sc = dot * sm_scale;
      }
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < nt ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * TS + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * Dh; i += THREADS) {
      const int g = i / Dh, d = i % Dh;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < nt; ++t) a += p_s[g * TS + t] * v_s[t * Dh + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G * Dh; i += THREADS)
    out[head + i] = acc_s[i] / fmaxf(l_s[i / Dh], 1e-30f);
}

// Dynamic shared memory the kernel needs, in bytes (the wrapper checks the
// same formula against the 48 KB default limit).
int smem_bytes(int G, int Dh) {
  return static_cast<int>(sizeof(float)) *
         (TS * (Dh + 1) + TS * Dh + 2 * G * Dh + G * TS + 3 * G);
}

}  // namespace

extern "C" cudaError_t decode_attention_int8(const void* q, int q_kind, const void* k,
                                             const void* k_scale, const void* v,
                                             const void* v_scale, const void* pos, void* out,
                                             int B, int S, int KV, int G, int Dh,
                                             float sm_scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || Dh <= 0) return cudaErrorInvalidValue;
  const int smem = smem_bytes(G, Dh);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(B * KV);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* pp = static_cast<const int32_t*>(pos);
  auto* op = static_cast<float*>(out);
  switch (q_kind) {
    case KIND_F32:
      decode_attn_int8_kernel<float><<<grid, THREADS, smem, stream>>>(
          static_cast<const float*>(q), kp, ksp, vp, vsp, pp, op, S, KV, G, Dh, sm_scale);
      break;
    case KIND_BF16:
      decode_attn_int8_kernel<__nv_bfloat16><<<grid, THREADS, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), kp, ksp, vp, vsp, pp, op, S, KV, G, Dh,
          sm_scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

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
// What bounds it on an H100: at the port's shapes (Dh 64, S up to 2048) the
// arithmetic, 4 * Dh operations per (query head, visible key) pair; the
// bytes are q, k, v read once and the f32 output written once.  Design: the
// TPU kernel carries m/l/acc across a sequential K grid axis in VMEM; CUDA
// blocks run in no order, so here one 256-thread block owns BR = 64
// consecutive rows of the flattened (query position, group head) space of
// one (batch, KV head) and loops over K/V tiles of BK = 32 positions itself,
// with m, l and acc in registers: each warp owns 8 rows, each lane one key of
// the tile for the scores (warp-shuffle max and sum) and Dh/32 output columns
// for P.V.  The block's Q rows, and each K/V tile, are staged in shared
// memory as f32 (rows padded by 4 floats: float4 reads without bank
// conflicts).  K tiles wholly after the block's last query, or wholly before
// the window of its first, are skipped; ragged tails (rows past Sq * G, keys
// past Sk) are masked, so any length is taken.  The flattened
// (batch, KV head, row tile) index runs along grid.x.  Tensor cores
// (mma.sync / wgmma), TMA and pipelining are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, NWARPS = THREADS / 32, RPW = 8;  // rows per warp
constexpr int BR = NWARPS * RPW;                               // 64 rows a block
constexpr int BK = 32;                                         // keys a tile

template <int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (BR * (DH + 4) + BK * (DH + 4) + BK * DH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                  int KV, int G, int n_tiles, int causal, int window, float softcap,
                  float sm_scale) {
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
      val = to_float(q[((static_cast<size_t>(b) * Sq + qp) * KV + kh) * G * DH +
                       static_cast<size_t>(g) * DH + d]);
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
        kv_ = to_float(k[off]);
        vv = to_float(v[off]);
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

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, int B,
                      int Sq, int Sk, int KV, int G, int causal, int window,
                      float softcap, float sm_scale, cudaStream_t stream) {
  const int n_tiles = (Sq * G + BR - 1) / BR;
  const long long blocks = static_cast<long long>(B) * KV * n_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<DH>();
  static bool attr_set = false;       // above 48 KB only after opting in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  flash_attn_kernel<T, DH><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), Sq, Sk, KV, G, n_tiles, causal, window, softcap, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Sk, int KV, int G, int Dh, int causal, int window, float softcap,
                   float sm_scale, cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                              sm_scale, stream);
    case 64:
      return launch_dh<T, 64>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                              sm_scale, stream);
    case 96:
      return launch_dh<T, 96>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                              sm_scale, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, softcap,
                               sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, KV, G, Dh), k/v: (B, Sk, KV, Dh), all f32 or all bf16 (kind);
// out: (B, Sq, KV, G, Dh) f32.  Dh in {32, 64, 96, 128}.  causal: 0/1;
// window <= 0 and softcap <= 0 switch those masks off.
extern "C" cudaError_t flash_attention(const void* q, const void* k, const void* v,
                                       int kind, void* out, int B, int Sq, int Sk, int KV,
                                       int G, int Dh, int causal, int window,
                                       float softcap, float sm_scale,
                                       cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || G <= 0) return cudaErrorInvalidValue;
  switch (kind) {
    case KIND_F32:
      return launch<float>(q, k, v, out, B, Sq, Sk, KV, G, Dh, causal, window, softcap,
                           sm_scale, stream);
    case KIND_BF16:
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, KV, G, Dh, causal, window,
                                   softcap, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

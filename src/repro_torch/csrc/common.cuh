// Shared helpers of the repro_torch CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Input element kinds the launchers accept (the wrappers pass these).
enum ElemKind : int { KIND_INT8 = 0, KIND_F32 = 1, KIND_BF16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

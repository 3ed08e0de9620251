// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel loads its inputs in their stored type (bf16 or fp32) and
// does all arithmetic in fp32, as the TPU kernels it replaces do. The C
// entry points take a dtype code and return cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with repro_torch/kernels/build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr float kNegInf = -1e30f;   // the TPU kernels' mask fill

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Max / sum over the `width` lanes that share a row (width a power of two
// <= 32, lanes of one group adjacent). Every lane of the warp must call.
template <int width>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rt

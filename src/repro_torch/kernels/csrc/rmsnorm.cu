// Fused RMSNorm for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm ->
// pl.pallas_call, body _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps)
// * scale, with fp32 math and the result cast back to x's dtype.
//
// Bound on the H100: it must read x and write y once, 50.3 MB for the
// prefill's [4096, 3072] bf16 (15 us at 3.35 TB/s); its few operations
// per byte never bind. At decode ([8, 3072]) it moves 98 KB and launch
// latency bounds it. The design reads each row from device memory once
// for the sum of squares and once more for the epilogue, where the second
// read hits L1/L2 (a 6 KB row), so device traffic stays one read and one
// write.
//
// Layout: one block of 256 threads per row; a warp-shuffle and shared-
// memory reduction gives the row's sum of squares.
#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  __shared__ float partial[NT / 32];
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = out + (size_t)blockIdx.x * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = rt::to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = rt::group_sum<32>(ss);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < NT / 32 ? partial[threadIdx.x] : 0.f;
    t = rt::group_sum<32>(t);
    if (threadIdx.x == 0) partial[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / (float)D + eps);

  for (int i = threadIdx.x; i < D; i += NT)
    rt::store_f(yr + i, rt::to_f(xr[i]) * r * rt::to_f(scale[i]));
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int D, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, S><<<rows, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace

// x [rows, D] contiguous, scale [D], out [rows, D] of x's dtype.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          int rows, int D, float eps, int x_dtype,
                          int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool xb = x_dtype == rt::kBFloat16, sb = scale_dtype == rt::kBFloat16;
  const bool xf = x_dtype == rt::kFloat32, sf = scale_dtype == rt::kFloat32;
  if (xb && sb) return (int)launch<bf16, bf16>(x, scale, out, rows, D, eps, s);
  if (xb && sf) return (int)launch<bf16, float>(x, scale, out, rows, D, eps, s);
  if (xf && sb) return (int)launch<float, bf16>(x, scale, out, rows, D, eps, s);
  if (xf && sf) return (int)launch<float, float>(x, scale, out, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

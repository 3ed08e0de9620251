// Fused RMSNorm for Hopper (B1).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm ->
// pl.pallas_call, body _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps)
// * scale, with fp32 math and the result cast back to x's dtype.
//
// Bound on the H100: it must read x and write y once, 50.3 MB for the
// prefill's [4096, 3072] bf16 (15 us at 3.35 TB/s); its few operations
// per byte never bind. At decode ([8, 3072]) it moves 98 KB, 0.03 us:
// launch latency bounds it.
//
// Layout: one warp per row, several rows per block (up to 8 warps, so the
// 8 rows of a decode step make one block); the plan (rmsnorm.py::plan)
// picks the route, the vector width, the 16-byte vectors a lane holds and
// the warps a block has, from the row count, the width and the dtypes.
// - rmsnorm_vec_kernel, when x and scale share a dtype, a row is whole
//   16-byte vectors (8 bf16 or 4 fp32) and fits in 16 vectors a lane
//   (4096 bf16, 2048 fp32), and the pointers are 16-byte aligned: each lane
//   loads its vectors of x with 16-byte loads, all in flight at once, and
//   keeps them in registers for the epilogue (x is read once); the row's
//   sum of squares takes five shuffles; the scale (the same for every row:
//   L1 and L2 hold it) comes in 16-byte loads too. At D = 3072 bf16 a lane
//   holds 12 vectors of x. Two variants, by row count (the plan's
//   `streaming`): for a few rows (decode) the scale is loaded with x, so the
//   epilogue waits on no second round trip; for many rows (prefill) it is
//   loaded in the epilogue, which frees the registers for two to four
//   blocks an SM, and x and y go through L2 evict-first (each is touched
//   once here).
// - rmsnorm_scalar_kernel, the rest (a bf16 x with an fp32 scale, widths
//   that are not whole vectors, wider rows): the same warp per row with
//   scalar loads and a second read of the row (from L1) in the epilogue.
//
// Backward (B1-bwd; the TPU package has no Pallas backward, its model
// differentiates rms_norm through XLA): with r = rsqrt(mean(x^2) + eps),
// x_hat = x r and g = scale * dy, dx = r (g - x_hat mean(g x_hat)) in fp32
// math, cast to x's dtype; optionally dscale = sum over rows of dy x_hat.
// Bound: it must read x and dy and write dx once, 85 MB at the training
// prefill's [4608, 3072] bf16, 25 us at 3.35 TB/s. The same plan and
// layout as the forward: one warp a row; rmsnorm_bwd_vec_kernel holds the
// row's x and dy in registers from 16-byte loads (x and dy read once, the
// scale from L1/L2), rmsnorm_bwd_scalar_kernel reads with scalar loads and
// goes over the row again in the epilogue. With dscale asked for, the
// warp also writes its row's r, and two more kernels reduce without
// atomics: rmsnorm_dscale_partial_kernel sums dy x r over a chunk of rows
// per column (one thread a column, coalesced), rmsnorm_dscale_reduce_kernel
// sums the chunks' partials per column in a fixed order.
#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 8;

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[16 / sizeof(T)]) {
  const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = rt::to_f(p[i]);
}

// Blocks an SM should hold on the streaming variant, by vectors of x a
// lane keeps (4 registers each): more rows in flight, and no spills.
constexpr int min_blocks(int NV) { return NV <= 4 ? 4 : NV <= 12 ? 2 : 1; }

template <typename T, int NV, bool STREAM>
__global__ void __launch_bounds__(32 * MAX_WARPS, STREAM ? min_blocks(NV) : 1)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int rows, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  // Few rows: the scale comes with x (no second round trip before the
  // epilogue) while both fit in registers, up to 12 vectors of bf16 (D
  // 3072) or 6 of fp32. Many rows (STREAM): the scale is read in the
  // epilogue, so more rows fit an SM, and x and y, each touched once, are
  // loaded and stored evict-first.
  constexpr bool kScaleFirst = !STREAM && NV * sizeof(T) <= 24;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = D / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4 xv[NV], sv[kScaleFirst ? NV : 1];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * 32 + lane;
    if (i < nvec) {
      xv[k] = STREAM ? __ldcs(xr + i) : xr[i];
      if constexpr (kScaleFirst) sv[k] = __ldg(sr + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (k * 32 + lane < nvec) {
      float f[V];
      unpack<T>(xv[k], f);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  const float r = rsqrtf(rt::group_sum<32>(ss) / (float)D + eps);
  uint4* yr = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * 32 + lane;
    if (i < nvec) {
      float f[V], s[V];
      unpack<T>(xv[k], f);
      if constexpr (kScaleFirst)
        unpack<T>(sv[k], s);
      else
        unpack<T>(__ldg(sr + i), s);
      uint4 u;
      T* p = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) rt::store_f(p + e, f[e] * r * s[e]);
      if constexpr (STREAM)
        __stcs(yr + i, u);
      else
        yr[i] = u;
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rmsnorm_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                      T* __restrict__ out, int rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  T* yr = out + (size_t)row * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = rt::to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(rt::group_sum<32>(ss) / (float)D + eps);
  for (int i = lane; i < D; i += 32)
    rt::store_f(yr + i, rt::to_f(xr[i]) * r * rt::to_f(scale[i]));
}

template <typename T, bool STREAM>
cudaError_t launch_vec(const void* x, const void* scale, void* out, int rows,
                       int D, float eps, int per_lane, int warps,
                       cudaStream_t stream) {
  const int blocks = (rows + warps - 1) / warps;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
#define RT_VEC(NV)                                                          \
  case NV:                                                                 \
    rmsnorm_vec_kernel<T, NV, STREAM><<<blocks, 32 * warps, 0, stream>>>(  \
        xp, sp, op, rows, D, eps);                                         \
    break;
  switch (per_lane) {
    RT_VEC(1) RT_VEC(2) RT_VEC(4) RT_VEC(8) RT_VEC(12) RT_VEC(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_VEC
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* x, const void* scale, void* out, int rows,
                       int D, float eps, int per_lane, int warps,
                       int streaming, cudaStream_t stream) {
  return streaming
      ? launch_vec<T, true>(x, scale, out, rows, D, eps, per_lane, warps, stream)
      : launch_vec<T, false>(x, scale, out, rows, D, eps, per_lane, warps, stream);
}

template <typename T, typename S>
cudaError_t launch_scalar(const void* x, const void* scale, void* out,
                          int rows, int D, float eps, int warps,
                          cudaStream_t stream) {
  const int blocks = (rows + warps - 1) / warps;
  rmsnorm_scalar_kernel<T, S><<<blocks, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, D, eps);
  return cudaGetLastError();
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ rstd, int rows, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = D / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  const uint4* gr = reinterpret_cast<const uint4*>(dy + (size_t)row * D);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4 xv[NV], gv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * 32 + lane;
    if (i < nvec) {
      xv[k] = xr[i];
      gv[k] = gr[i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (k * 32 + lane < nvec) {
      float f[V];
      unpack<T>(xv[k], f);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  const float r = rsqrtf(rt::group_sum<32>(ss) / (float)D + eps);
  float dot = 0.f;     // sum of (scale dy) x over the row
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * 32 + lane;
    if (i < nvec) {
      float f[V], g[V], sc[V];
      unpack<T>(xv[k], f);
      unpack<T>(gv[k], g);
      unpack<T>(__ldg(sr + i), sc);
#pragma unroll
      for (int e = 0; e < V; ++e) dot = fmaf(sc[e] * g[e], f[e], dot);
    }
  }
  const float c = rt::group_sum<32>(dot) * r * r / (float)D;
  uint4* dr = reinterpret_cast<uint4*>(dx + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * 32 + lane;
    if (i < nvec) {
      float f[V], g[V], sc[V];
      unpack<T>(xv[k], f);
      unpack<T>(gv[k], g);
      unpack<T>(__ldg(sr + i), sc);
      uint4 u;
      T* p = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e)
        rt::store_f(p + e, r * (sc[e] * g[e] - f[e] * c));
      dr[i] = u;
    }
  }
  if (rstd && lane == 0) rstd[row] = r;
}

template <typename T, typename S>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ rstd, int rows, int D,
                          float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  const T* gr = dy + (size_t)row * D;
  T* dr = dx + (size_t)row * D;
  float ss = 0.f, dot = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = rt::to_f(xr[i]);
    ss = fmaf(v, v, ss);
    dot = fmaf(rt::to_f(scale[i]) * rt::to_f(gr[i]), v, dot);
  }
  const float r = rsqrtf(rt::group_sum<32>(ss) / (float)D + eps);
  const float c = rt::group_sum<32>(dot) * r * r / (float)D;
  for (int i = lane; i < D; i += 32)
    rt::store_f(dr + i, r * (rt::to_f(scale[i]) * rt::to_f(gr[i]) -
                             rt::to_f(xr[i]) * c));
  if (rstd && lane == 0) rstd[row] = r;
}

// part[chunk, col] = sum over the chunk's rows of dy x r (fp32)
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ dy,
                              const float* __restrict__ rstd,
                              float* __restrict__ part, int rows, int D,
                              int chunk_rows) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  const int r0 = blockIdx.y * chunk_rows;
  const int r1 = min(rows, r0 + chunk_rows);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t off = (size_t)r * D + col;
    acc = fmaf(rt::to_f(dy[off]) * rt::to_f(x[off]), rstd[r], acc);
  }
  part[(size_t)blockIdx.y * D + col] = acc;
}

template <typename S>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_reduce_kernel(const float* __restrict__ part,
                             S* __restrict__ dscale, int chunks, int D) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[(size_t)c * D + col];
  rt::store_f(dscale + col, acc);
}

template <typename T>
cudaError_t launch_bwd_vec(const void* x, const void* scale, const void* dy,
                           void* dx, float* rstd, int rows, int D, float eps,
                           int per_lane, int warps, cudaStream_t stream) {
  const int blocks = (rows + warps - 1) / warps;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
#define RT_BWD_VEC(NV)                                                   \
  case NV:                                                              \
    rmsnorm_bwd_vec_kernel<T, NV><<<blocks, 32 * warps, 0, stream>>>(   \
        xp, sp, gp, op, rstd, rows, D, eps);                            \
    break;
  switch (per_lane) {
    RT_BWD_VEC(1) RT_BWD_VEC(2) RT_BWD_VEC(4) RT_BWD_VEC(8) RT_BWD_VEC(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_BWD_VEC
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_bwd_scalar(const void* x, const void* scale,
                              const void* dy, void* dx, float* rstd, int rows,
                              int D, float eps, int warps,
                              cudaStream_t stream) {
  const int blocks = (rows + warps - 1) / warps;
  rmsnorm_bwd_scalar_kernel<T, S><<<blocks, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), rstd, rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_dscale(const void* x, const void* dy, const float* rstd,
                          float* part, void* dscale, int rows, int D,
                          int chunk_rows, cudaStream_t stream) {
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const int cols = (D + 255) / 256;
  rmsnorm_dscale_partial_kernel<T><<<dim3(cols, chunks), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), rstd, part, rows,
      D, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_reduce_kernel<S><<<cols, 256, 0, stream>>>(
      part, static_cast<S*>(dscale), chunks, D);
  return cudaGetLastError();
}

}  // namespace

// x [rows, D] contiguous, scale [D], out [rows, D] of x's dtype. The plan:
// per_lane > 0 takes the vector kernel with that many 16-byte vectors a
// lane (x and scale of one dtype, D whole vectors, 16-byte aligned
// pointers), its streaming variant if `streaming`; per_lane 0 the scalar
// kernel; `warps` rows a block.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          int rows, int D, float eps, int x_dtype,
                          int scale_dtype, int per_lane, int warps,
                          int streaming, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || warps <= 0 || warps > MAX_WARPS || per_lane < 0)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool xb = x_dtype == rt::kBFloat16, sb = scale_dtype == rt::kBFloat16;
  const bool xf = x_dtype == rt::kFloat32, sf = scale_dtype == rt::kFloat32;
  if (per_lane > 0) {
    const int V = xb ? 8 : 4;
    const bool fits = D % V == 0 && D / V <= 32 * per_lane &&
        ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) % 16 == 0;
    if (!fits || x_dtype != scale_dtype) return (int)cudaErrorInvalidValue;
    if (xb) return (int)launch_vec<bf16>(x, scale, out, rows, D, eps, per_lane, warps, streaming, s);
    if (xf) return (int)launch_vec<float>(x, scale, out, rows, D, eps, per_lane, warps, streaming, s);
    return (int)cudaErrorInvalidValue;
  }
  if (xb && sb) return (int)launch_scalar<bf16, bf16>(x, scale, out, rows, D, eps, warps, s);
  if (xb && sf) return (int)launch_scalar<bf16, float>(x, scale, out, rows, D, eps, warps, s);
  if (xf && sb) return (int)launch_scalar<float, bf16>(x, scale, out, rows, D, eps, warps, s);
  if (xf && sf) return (int)launch_scalar<float, float>(x, scale, out, rows, D, eps, warps, s);
  return (int)cudaErrorInvalidValue;
}

// Backward: x, dy and dx [rows, D] contiguous of x's dtype, scale [D].
// The plan as the forward's (per_lane > 0: the vector kernel, up to 12
// vectors a lane, since it holds dy too: 16 spill at bf16; 0: the scalar
// kernel; `warps` rows a block). With dscale not null, rstd [rows]
// and part [ceil(rows / chunk_rows), D] are fp32 scratch and dscale [D]
// of scale's dtype receives sum over rows of dy x_hat.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* scale,
                              const void* dy, void* dx, void* dscale,
                              void* rstd_ptr, void* part_ptr, int rows, int D,
                              float eps, int x_dtype, int scale_dtype,
                              int per_lane, int warps, int chunk_rows,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || warps <= 0 || warps > MAX_WARPS || per_lane < 0 ||
      (dscale && (!rstd_ptr || !part_ptr || chunk_rows <= 0)))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  float* rstd = dscale ? static_cast<float*>(rstd_ptr) : nullptr;
  const bool xb = x_dtype == rt::kBFloat16, sb = scale_dtype == rt::kBFloat16;
  const bool xf = x_dtype == rt::kFloat32, sf = scale_dtype == rt::kFloat32;
  cudaError_t err = cudaErrorInvalidValue;
  if (per_lane > 0) {
    const int V = xb ? 8 : 4;
    const bool fits = D % V == 0 && D / V <= 32 * per_lane &&
        ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
    if (!fits || x_dtype != scale_dtype) return (int)cudaErrorInvalidValue;
    if (xb) err = launch_bwd_vec<bf16>(x, scale, dy, dx, rstd, rows, D, eps, per_lane, warps, s);
    if (xf) err = launch_bwd_vec<float>(x, scale, dy, dx, rstd, rows, D, eps, per_lane, warps, s);
  } else {
    if (xb && sb) err = launch_bwd_scalar<bf16, bf16>(x, scale, dy, dx, rstd, rows, D, eps, warps, s);
    if (xb && sf) err = launch_bwd_scalar<bf16, float>(x, scale, dy, dx, rstd, rows, D, eps, warps, s);
    if (xf && sb) err = launch_bwd_scalar<float, bf16>(x, scale, dy, dx, rstd, rows, D, eps, warps, s);
    if (xf && sf) err = launch_bwd_scalar<float, float>(x, scale, dy, dx, rstd, rows, D, eps, warps, s);
  }
  if (err != cudaSuccess || !dscale) return (int)err;
  float* part = static_cast<float*>(part_ptr);
  if (xb && sb) return (int)launch_dscale<bf16, bf16>(x, dy, rstd, part, dscale, rows, D, chunk_rows, s);
  if (xb && sf) return (int)launch_dscale<bf16, float>(x, dy, rstd, part, dscale, rows, D, chunk_rows, s);
  if (xf && sb) return (int)launch_dscale<float, bf16>(x, dy, rstd, part, dscale, rows, D, chunk_rows, s);
  if (xf && sf) return (int)launch_dscale<float, float>(x, dy, rstd, part, dscale, rows, D, chunk_rows, s);
  return (int)cudaErrorInvalidValue;
}

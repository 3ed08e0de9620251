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
// Bound: it must read x and dy and write dx (and dscale) once: 85 MB at
// the hydra PPO path's [4608, 3072] bf16, 25 us at 3.35 TB/s; 50 MB at the
// separate path's [4096, 2048], 15 us. One warp a row, x and dy each read
// once from HBM, in one pass whether or not dscale is asked for:
// - rmsnorm_bwd_vec_kernel (the forward's vector route, up to 12 vectors a
//   lane): a lane loads its 16-byte vectors of x and dy (evict-first) and
//   keeps them in registers, sums x^2 and (scale dy) x over them in one
//   loop, then writes dx; the scale comes from L1/L2.
// - rmsnorm_bwd_scalar_kernel (a bf16 x with an fp32 scale, rows not whole
//   vectors or wider than 12 a lane): scalar loads, the row read again
//   from L1 for dx.
// dx is the same arithmetic in both instances of each kernel, so it is
// bit-identical with and without dscale. Without dscale there is a block
// per `warps` rows. With dscale the grid is one block an SM, each over a
// contiguous range of rows (block_rows); a lane sums dy x r for its own
// columns over its warp's rows as it writes dx (in registers up to 64
// floats a lane, else in the warp's row of a shared-memory slab [warps,
// D]; the scalar route always in the slab), the block sums its warps in
// warp order into one fp32 partial row, and rmsnorm_dscale_sum_kernel,
// launched as the kernel's programmatic dependent so its launch overlaps
// the kernel's tail, sums the partial rows per column in a fixed order:
// no atomics, and two calls give the same bits. Tried on the H100 and
// dropped as slower: prefetching a warp's next row into registers (fewer
// warps an SM), two or more blocks an SM and blocks of 16 warps (more
// partial rows to sum). `chip_ab.py --ablate rmsnorm.cu` cuts the column
// sum, the block's sum and the sum kernel one at a time: the column sum
// inside the pass costs nothing measurable, the sum kernel most of what
// dscale adds.
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

// ---------------------------------------------------------------- backward

// Rows [r0, r1) of this block: `gridDim.x` contiguous ranges over `rows`
// that differ by at most one row (rmsnorm.py::BwdPlan.block_rows).
__device__ __forceinline__ void block_rows(int rows, int& r0, int& r1) {
  r0 = (int)((long long)blockIdx.x * rows / gridDim.x);
  r1 = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x);
}

// part[blockIdx.x, :] = the rows of slab [warps, D] summed in warp order,
// four columns a thread where D is whole float4s (every thread of the
// block calls it once, after its last row).
template <bool VEC4>
__device__ __forceinline__ void block_partial(const float* slab,
                                              float* __restrict__ part,
                                              int warps, int D) {
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * D;
  if constexpr (VEC4) {
    const int n = D / 4;
    const float4* s4 = reinterpret_cast<const float4*>(slab);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < warps; ++w) {
        const float4 t = s4[(size_t)w * n + col];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      o4[col] = s;
    }
  } else {
    for (int col = threadIdx.x; col < D; col += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s += slab[(size_t)w * D + col];
      out[col] = s;
    }
  }
}

// Let the dscale sum kernel, launched as this kernel's programmatic
// dependent, be scheduled while this one runs (it waits for this one's
// results in griddepcontrol.wait).
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pack(float a, float b, float* p) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void pack(float a, float b, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The vector route: a block takes its contiguous range of rows
// (block_rows), its warps rows r0 + w, r0 + w + warps, ...; a lane loads
// its NV 16-byte vectors of the row's x and of its dy (evict-first: each
// is read once), sums x^2 and (scale dy) x over them in one pass, then
// writes dx. With DSCALE the lane also sums dy x r for its columns over
// its rows, in registers up to 64 floats a lane (NV 8 bf16) and in the
// warp's row of the shared-memory slab [warps, D] above that (NV 12 bf16:
// 96 would spill), and the block sums its warps in order into
// part[blockIdx.x, :].
template <typename T, int NV, bool DSCALE>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kAccSmem = DSCALE && NV * V > 64;
  constexpr int NA = DSCALE && !kAccSmem ? NV * V : 1;
  extern __shared__ float4 slab4[];      // [warps, D] fp32, with DSCALE
  float* slab = reinterpret_cast<float*>(slab4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int W = blockDim.x / 32;
  const int nvec = D / V;
  float* wslab = slab + (size_t)warp * D;
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  if constexpr (kAccSmem) {
    for (int i = lane; i < nvec * V / 4; i += 32)
      reinterpret_cast<float4*>(wslab)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (DSCALE) release_dependents();
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  int r0, r1;
  block_rows(rows, r0, r1);
  for (int row = r0 + warp; row < r1; row += W) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + (size_t)row * D);
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * 32 + lane;
      if (i < nvec) {
        xv[k] = __ldcs(xr + i);
        gv[k] = __ldcs(gr + i);
      }
    }
    float ss = 0.f, dot = 0.f;     // sums of x^2 and of (scale dy) x
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * 32 + lane;
      if (i < nvec) {
        float f[V], g[V], sc[V];
        unpack<T>(xv[k], f);
        unpack<T>(gv[k], g);
        unpack<T>(__ldg(sr + i), sc);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(f[e], f[e], ss);
          dot = fmaf(sc[e] * g[e], f[e], dot);
        }
      }
    }
    const float r = rsqrtf(rt::group_sum<32>(ss) / (float)D + eps);
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
        for (int e = 0; e < V; e += 2)
          pack(r * fmaf(-f[e], c, sc[e] * g[e]),
               r * fmaf(-f[e + 1], c, sc[e + 1] * g[e + 1]), p + e);
        dr[i] = u;
        if constexpr (kAccSmem) {
          float4* a = reinterpret_cast<float4*>(wslab + i * V);
#pragma unroll
          for (int j = 0; j < V / 4; ++j) {
            float4 t = a[j];
            t.x = fmaf(g[4 * j], f[4 * j] * r, t.x);
            t.y = fmaf(g[4 * j + 1], f[4 * j + 1] * r, t.y);
            t.z = fmaf(g[4 * j + 2], f[4 * j + 2] * r, t.z);
            t.w = fmaf(g[4 * j + 3], f[4 * j + 3] * r, t.w);
            a[j] = t;
          }
        } else if constexpr (DSCALE) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[k * V + e] = fmaf(g[e], f[e] * r, acc[k * V + e]);
        }
      }
    }
  }
  if constexpr (DSCALE) {
    if constexpr (!kAccSmem) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = k * 32 + lane;
        if (i < nvec) {
          float4* a = reinterpret_cast<float4*>(wslab + i * V);
#pragma unroll
          for (int j = 0; j < V / 4; ++j)
            a[j] = make_float4(acc[k * V + 4 * j], acc[k * V + 4 * j + 1],
                               acc[k * V + 4 * j + 2], acc[k * V + 4 * j + 3]);
        }
      }
    }
    block_partial<true>(slab, part, W, D);
  }
}

// The scalar route (a bf16 x with an fp32 scale, rows that are not whole
// 16-byte vectors or wider than the vector route holds): the same rows a
// warp, scalar loads, the row read again (from L1) for dx; with DSCALE
// each lane sums dy x r for its columns lane, lane + 32, ... in the warp's
// row of the shared-memory slab, and the block sums its warps in order.
template <typename T, typename S, bool DSCALE>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, int rows, int D,
                          float eps) {
  extern __shared__ float4 slab4[];      // [warps, D] fp32, with DSCALE
  float* slab = reinterpret_cast<float*>(slab4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int W = blockDim.x / 32;
  float* wslab = slab + (size_t)warp * D;
  if constexpr (DSCALE) {
    for (int i = lane; i < D; i += 32) wslab[i] = 0.f;
    release_dependents();
  }
  int r0, r1;
  block_rows(rows, r0, r1);
  for (int row = r0 + warp; row < r1; row += W) {
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
    for (int i = lane; i < D; i += 32) {
      const float v = rt::to_f(xr[i]), g = rt::to_f(gr[i]);
      rt::store_f(dr + i, r * fmaf(-v, c, rt::to_f(scale[i]) * g));
      if constexpr (DSCALE) wslab[i] = fmaf(g, v * r, wslab[i]);
    }
  }
  if constexpr (DSCALE) block_partial<false>(slab, part, W, D);
}

// dscale[col] = the sum of part[b, col] over the parts b, in a fixed
// order: warp w sums parts [w k, (w + 1) k) of its block's 32 columns in
// order (k = ceil(parts / 32), a lane a column), then warp 0 sums the 32
// warps' sums in order. Launched as the backward kernel's programmatic
// dependent: it waits for that kernel's partial rows here.
template <typename S>
__global__ void __launch_bounds__(1024)
rmsnorm_dscale_sum_kernel(const float* __restrict__ part,
                          S* __restrict__ dscale, int parts, int D) {
  __shared__ float chunk[32 * 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int k = (parts + 31) / 32;
  const int b1 = min(parts, (warp + 1) * k);
  float s = 0.f;
  if (col < D)
#pragma unroll 4
    for (int b = warp * k; b < b1; ++b) s += part[(size_t)b * D + col];
  chunk[warp * 32 + lane] = s;
  __syncthreads();
  if (warp == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 32; ++w) t += chunk[w * 32 + lane];
    rt::store_f(dscale + col, t);
  }
}

constexpr int SMEM_MAX = 227 * 1024;     // dynamic shared memory a block

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NV>
cudaError_t launch_bwd_vec(const void* x, const void* scale, const void* dy,
                           void* dx, float* part, int rows, int D, float eps,
                           int warps, int blocks, cudaStream_t stream) {
  const size_t smem = part ? (size_t)warps * D * sizeof(float) : 0;
  auto kernel = part ? rmsnorm_bwd_vec_kernel<T, NV, true>
                     : rmsnorm_bwd_vec_kernel<T, NV, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_vec(const void* x, const void* scale, const void* dy,
                           void* dx, float* part, int rows, int D, float eps,
                           int per_lane, int warps, int blocks,
                           cudaStream_t stream) {
#define RT_BWD_VEC(NV)                                                     \
  case NV:                                                                \
    return launch_bwd_vec<T, NV>(x, scale, dy, dx, part, rows, D, eps,    \
                                 warps, blocks, stream);
  switch (per_lane) {
    RT_BWD_VEC(1) RT_BWD_VEC(2) RT_BWD_VEC(4) RT_BWD_VEC(8) RT_BWD_VEC(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_BWD_VEC
}

template <typename T, typename S>
cudaError_t launch_bwd_scalar(const void* x, const void* scale,
                              const void* dy, void* dx, float* part, int rows,
                              int D, float eps, int warps, int blocks,
                              cudaStream_t stream) {
  const size_t smem = part ? (size_t)warps * D * sizeof(float) : 0;
  auto kernel = part ? rmsnorm_bwd_scalar_kernel<T, S, true>
                     : rmsnorm_bwd_scalar_kernel<T, S, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, D, eps);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_dscale_sum(const float* part, void* dscale, int parts,
                              int D, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + 31) / 32);
  cfg.blockDim = dim3(1024);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, rmsnorm_dscale_sum_kernel<S>,
                                       part, static_cast<S*>(dscale), parts,
                                       D);
  if (err != cudaSuccess) return err;
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

// Backward: x, dy and dx [rows, D] contiguous of x's dtype, scale [D]. The
// plan (rmsnorm.py::bwd_plan): per_lane > 0 takes the vector kernel with
// that many 16-byte vectors a lane (up to 12), 0 the scalar kernel;
// `warps` warps a block and `blocks` blocks, block b taking rows
// [b rows / blocks, (b + 1) rows / blocks). With dscale not null, part
// [blocks, D] is fp32 scratch and dscale [D] of scale's dtype receives the
// sum over rows of dy x_hat.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* scale,
                              const void* dy, void* dx, void* dscale,
                              void* part_ptr, int rows, int D, float eps,
                              int x_dtype, int scale_dtype, int per_lane,
                              int warps, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || warps <= 0 || warps > MAX_WARPS ||
      blocks <= 0 || blocks > rows || per_lane < 0 || (dscale && !part_ptr))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  float* part = dscale ? static_cast<float*>(part_ptr) : nullptr;
  const bool xb = x_dtype == rt::kBFloat16, sb = scale_dtype == rt::kBFloat16;
  const bool xf = x_dtype == rt::kFloat32, sf = scale_dtype == rt::kFloat32;
  cudaError_t err = cudaErrorInvalidValue;
  if (per_lane > 0) {
    const int V = xb ? 8 : 4;
    const bool fits = D % V == 0 && D / V <= 32 * per_lane &&
        ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
    if (!fits || x_dtype != scale_dtype) return (int)cudaErrorInvalidValue;
    if (xb) err = launch_bwd_vec<bf16>(x, scale, dy, dx, part, rows, D, eps, per_lane, warps, blocks, s);
    if (xf) err = launch_bwd_vec<float>(x, scale, dy, dx, part, rows, D, eps, per_lane, warps, blocks, s);
  } else {
    if (xb && sb) err = launch_bwd_scalar<bf16, bf16>(x, scale, dy, dx, part, rows, D, eps, warps, blocks, s);
    if (xb && sf) err = launch_bwd_scalar<bf16, float>(x, scale, dy, dx, part, rows, D, eps, warps, blocks, s);
    if (xf && sb) err = launch_bwd_scalar<float, bf16>(x, scale, dy, dx, part, rows, D, eps, warps, blocks, s);
    if (xf && sf) err = launch_bwd_scalar<float, float>(x, scale, dy, dx, part, rows, D, eps, warps, blocks, s);
  }
  if (err != cudaSuccess || !dscale) return (int)err;
  if (sb) return (int)launch_dscale_sum<bf16>(part, dscale, blocks, D, s);
  if (sf) return (int)launch_dscale_sum<float>(part, dscale, blocks, D, s);
  return (int)cudaErrorInvalidValue;
}

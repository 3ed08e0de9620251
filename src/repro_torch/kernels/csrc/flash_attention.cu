// Flash-attention forward (prefill) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd -> pl.pallas_call, body _fwd_kernel): online-softmax
// GQA attention, causal / sliding-window / full, q pre-scaled by 1/sqrt(D),
// masked scores filled with -1e30, l clamped at 1e-30, and QK^T, the
// softmax and PV all in fp32 (the TPU kernel upcasts k and v before any
// product, so p enters PV in fp32 there too).
//
// Bound on the H100 at the serving shapes (q [8,512,24,128], k/v
// [8,512,8,128] bf16, causal): it must move 67 MB (q, k, v once, out once),
// 20 us at 3.35 TB/s, and do 12.9 GFLOP, 13 us at the bf16 tensor-core
// rate, so bytes bound it. This first version does its products in fp32
// on the CUDA cores (67 TFLOP/s peak, ~0.2 ms for the same work), so it is
// compute-bound in practice; moving QK^T and PV onto wgmma is later work.
// What the design does about the bytes: each block loads its q tile once
// and streams k/v tiles through shared memory, so q, k and v are each read
// from device memory about once per (q tile, kv head), and the scores
// never leave the SM. KV head h // G is read in place (no replication).
//
// Layout: one block per (64-row q tile, query head, batch); 256 threads.
// Thread (tr = tid / 16, tc = tid % 16) owns score rows 4tr..4tr+3 and
// columns tc + 16j, and the accumulator entries of the same rows at
// columns tc + 16j, so the softmax rescale stays in registers; the 16
// lanes of one row group reduce with shuffles. Ragged Sq and Sk are
// masked here, never padded on the host. With causal masking, k tiles
// wholly above the diagonal (or wholly outside the window) are skipped;
// a query row whose every key is masked gives an unspecified output, as
// in the TPU kernel.
#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // keys per shared-memory tile
constexpr int NT = 256;   // threads per block

template <int D>
constexpr size_t smem_bytes() {
  // q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1], all fp32
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int K, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * (D + 1);
  float* vs = ks + BK * (D + 1);
  float* ps = vs + BK * D;
  constexpr int DC = D / 16;   // accumulator columns per thread

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qi = q0 + r;
    float x = 0.f;
    if (qi < Sq) x = rt::to_f(q[(((size_t)b * Sq + qi) * H + h) * D + d]) * scale;
    qs[r * (D + 1) + d] = x;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kt_begin = 0;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Sq) - 1;
    kt_end = min(kt_end, last_row / BK + 1);
    if (window) {
      const int first_key = q0 - window + 1;   // earliest key row q0 may see
      if (first_key > 0) kt_begin = first_key / BK;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < Sk) {
        const size_t off = (((size_t)b * Sk + kj) * K + kh) * D + d;
        kx = rt::to_f(k[off]);
        vx = rt::to_f(v[off]);
      }
      ks[r * (D + 1) + d] = kx;
      vs[r * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(tr * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      float row_max = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + 16 * j;
        bool ok = kj < Sk;
        if (causal) {
          ok = ok && kj <= qi;
          if (window) ok = ok && kj > qi - window;
        }
        if (!ok) s[i][j] = rt::kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      row_max = rt::group_max<16>(row_max);
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(tr * 4 + i) * (BK + 1) + tc + 16 * j] = p;
        row_sum += p;
      }
      row_sum = rt::group_sum<16>(row_sum);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vx = vs[c * D + tc + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vx, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) rt::store_f(orow + tc + 16 * cc, acc[i][cc] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int K, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, K, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q [B,Sq,H,D], k/v [B,Sk,K,D], o [B,Sq,H,D], all contiguous, one dtype.
extern "C" int rt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int K, int D,
                                      int causal, int window, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kBFloat16) {
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, K, causal, window, s);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, window, s);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) return (int)launch<float, 64>(q, k, v, o, B, Sq, Sk, H, K, causal, window, s);
    if (D == 128) return (int)launch<float, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

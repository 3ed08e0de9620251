// Flash-attention backward for Hopper (B2-bwd).
//
// The TPU package has no Pallas backward: its model differentiates
// attention through the XLA custom VJP repro/models/flash.py::_bwd
// (:98-138), which recomputes the scores chunk by chunk from the saved
// log-normaliser. This kernel computes the same function: for q [B,Sq,H,D],
// k/v [B,Sk,K,D] (H % K == 0, query head h reads KV head h / G), the
// saved out [B,Sq,H,D] and lse [B,Sq,H] (fp32) and dout, it gives dq, dk
// and dv, causal (top-left aligned, key <= query) / sliding-window / full,
// with ragged Sq and Sk masked here.
//
// Bound on the H100 at the training shape (q [8,576,24,128], k/v
// [8,576,8,128] bf16, causal): it must read q, k, v, out and dout and
// write dq, dk and dv once, ~152 MB, 45 us at 3.35 TB/s; and do five
// products of 2 x 128 flop over the 31.9 M unmasked (query, key) pairs of
// the 192 heads, 41 us at the 989 TFLOP/s bf16 tensor-core rate. Bytes and
// operations are close.
//
// Design (the first, simple one: right before fast). No atomics, and the
// result does not depend on the schedule. Three kernels, all fp32 math on
// the CUDA cores for both dtypes; the tensor cores are the redesign's work:
// - flash_bwd_delta_kernel: delta = rowsum(dout * out) in fp32, one warp
//   a (batch, row, head), as flash.py:110 computes it.
// - flash_bwd_dkdv_kernel: a block per (64-key tile, KV head, batch). It
//   keeps its K and V tiles in shared memory and walks, for each of the G
//   query heads of its KV head, the 64-row q tiles that can see its keys
//   (from the causal start to the window's end), so the sum over the
//   group stays inside the block. Per q tile it recomputes S^T = K Q^T and
//   dP^T = V dO^T (thread (tr, tc) owns keys 4tr..4tr+3 and queries tc +
//   16j), P = exp(S scale - lse), dS = P (dP - delta); then dV += P^T dO
//   with P rounded to dout's dtype (flash.py:122) and dK += dS^T Q with dS
//   rounded to q's dtype (:125), each through one [64][65] shared tile.
//   dK is scaled by 1/sqrt(D) at the end (the reference's q * scale).
// - flash_bwd_dq_kernel: a block per (64-row q tile, query head, batch)
//   walks the k tiles its rows can see, recomputes S, dP, P and dS the
//   same way and sums dQ += dS K in fp32 over all of them (scaled at the
//   end).
// Scores are recomputed twice (once per kernel): seven products where the
// function needs five; each kernel keeps four fp32 tiles of [64][D+1] in
// shared memory (149 KB at D 128: one block an SM).
//
// Numerics: products in fp32 from the stored values, summed in another
// order than the reference; the roundings the reference makes (P before
// dV, dS before dQ and dK) are made at the same places, so the kernel and
// ref.flash_attention_bwd_ref agree to fp32 summation order.
#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows a tile
constexpr int BK = 64;    // keys a tile
constexpr int NT = 256;   // threads a block: (tr, tc) = (tid / 16, tid % 16)

template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
constexpr size_t smem_bytes() {
  // four [64][D+1] fp32 tiles and one [64][65] P / dS tile, plus lse and
  // delta of the 64 rows
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * 65 + 2 * 64);
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = qi < Sq && kj < Sk;
  if (causal) {
    ok = ok && kj <= qi;
    if (window) ok = ok && kj > qi - window;
  }
  return ok;
}

// rows [B*Sq*H] of D: delta = sum dout * out (fp32)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                       float* __restrict__ delta, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = dout + (size_t)row * D;
  const T* o = out + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s = fmaf(rt::to_f(a[i]), rt::to_f(o[i]), s);
  s = rt::group_sum<32>(s);
  if (lane == 0) delta[row] = s;
}

// rows r0.. of head h of a [B, S, heads, D] tensor into a [64][D+1] tile
// (zeros past S)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int S, int heads, int h) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, ri = r0 + r;
    float x = 0.f;
    if (ri < S) x = rt::to_f(src[(((size_t)b * S + ri) * heads + h) * D + d]);
    dst[r * (D + 1) + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int K,
                      int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [BK][D+1]
  float* vs = ks + BK * (D + 1);
  float* qs = vs + BK * (D + 1);    // [BQ][D+1]
  float* dos = qs + BQ * (D + 1);
  float* ps = dos + BQ * (D + 1);   // [BK][BQ+1]: P^T, then dS^T
  float* lse_s = ps + BK * (BQ + 1);
  float* del_s = lse_s + BQ;
  constexpr int DC = D / 16;

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  load_tile<T, D>(ks, k, b, k0, Sk, K, kh);
  load_tile<T, D>(vs, v, b, k0, Sk, K, kh);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // the q tiles that can see keys k0 .. k0 + 63
  const int nq = (Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nq;
  if (causal) {
    qt_begin = k0 / BQ;
    if (window) qt_end = min(nq, (k0 + BK - 1 + window - 1) / BQ + 1);
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the last tile's q, dO and ps are consumed
      load_tile<T, D>(qs, q, b, q0, Sq, H, h);
      load_tile<T, D>(dos, dout, b, q0, Sq, H, h);
      if (tid < BQ) {
        const int qi = q0 + tid;
        const size_t off = ((size_t)b * Sq + qi) * H + h;
        lse_s[tid] = qi < Sq ? lse[off] : 0.f;
        del_s[tid] = qi < Sq ? delta[off] : 0.f;
      }
      __syncthreads();

      // S^T (keys x queries) and dP^T, both over D
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kx[4], vx[4], qx[4], ox[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kx[i] = ks[(tr * 4 + i) * (D + 1) + d];
          vx[i] = vs[(tr * 4 + i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qx[j] = qs[(tc + 16 * j) * (D + 1) + d];
          ox[j] = dos[(tc + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kx[i], qx[j], s[i][j]);
            dp[i][j] = fmaf(vx[i], ox[j], dp[i][j]);
          }
      }
      // P = exp(S scale - lse) where visible, dS = P (dP - delta)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tc + 16 * j;
          const float p = visible(q0 + r, kj, Sq, Sk, causal, window)
                              ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          dp[i][j] = p * (dp[i][j] - del_s[r]);
          ps[(tr * 4 + i) * (BQ + 1) + r] = round_to<T>(p);
        }
      }
      __syncthreads();
      // dV += P^T dO
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(tr * 4 + i) * (BQ + 1) + c];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const float x = dos[c * (D + 1) + tc + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) dva[i][cc] = fmaf(pv[i], x, dva[i][cc]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps[(tr * 4 + i) * (BQ + 1) + tc + 16 * j] = round_to<T>(dp[i][j]);
      __syncthreads();
      // dK += dS^T Q
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = ps[(tr * 4 + i) * (BQ + 1) + c];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const float x = qs[c * (D + 1) + tc + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) dka[i][cc] = fmaf(sv[i], x, dka[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr * 4 + i;
    if (kj >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kj) * K + kh) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      rt::store_f(dk + off + tc + 16 * cc, dka[i][cc] * scale);
      rt::store_f(dv + off + tc + 16 * cc, dva[i][cc]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int K, int causal, int window,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][D+1]
  float* dos = qs + BQ * (D + 1);
  float* ks = dos + BQ * (D + 1);   // [BK][D+1]
  float* vs = ks + BK * (D + 1);
  float* ps = vs + BK * (D + 1);    // [BQ][BK+1]: dS
  float* lse_s = ps + BQ * (BK + 1);
  float* del_s = lse_s + BQ;
  constexpr int DC = D / 16;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  load_tile<T, D>(qs, q, b, q0, Sq, H, h);
  load_tile<T, D>(dos, dout, b, q0, Sq, H, h);
  if (tid < BQ) {     // in shared memory, not registers: no spills at D 128
    const int qi = q0 + tid;
    const size_t off = ((size_t)b * Sq + qi) * H + h;
    lse_s[tid] = qi < Sq ? lse[off] : 0.f;
    del_s[tid] = qi < Sq ? delta[off] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int kt_begin = 0;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Sq) - 1;
    kt_end = min(kt_end, last_row / BK + 1);
    if (window) {
      const int first_key = q0 - window + 1;   // earliest key q0 may see
      if (first_key > 0) kt_begin = first_key / BK;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's k, v and dS are consumed
    load_tile<T, D>(ks, k, b, k0, Sk, K, kh);
    load_tile<T, D>(vs, v, b, k0, Sk, K, kh);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qx[4], ox[4], kx[4], vx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qx[i] = qs[(tr * 4 + i) * (D + 1) + d];
        ox[i] = dos[(tr * 4 + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kx[j] = ks[(tc + 16 * j) * (D + 1) + d];
        vx[j] = vs[(tc + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qx[i], kx[j], s[i][j]);
          dp[i][j] = fmaf(ox[i], vx[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + 16 * j;
        const float p = visible(qi, kj, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_s[tr * 4 + i]) : 0.f;
        ps[(tr * 4 + i) * (BK + 1) + tc + 16 * j] =
            round_to<T>(p * (dp[i][j] - del_s[tr * 4 + i]));
      }
    }
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ps[(tr * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float x = ks[c * (D + 1) + tc + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(sv[i], x, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= Sq) continue;
    T* row = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) rt::store_f(row + tc + 16 * cc, acc[i][cc] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int K, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      dop, static_cast<const T*>(out), delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D>
      <<<dim3((Sk + BK - 1) / BK, K, B), NT, smem, stream>>>(
          qp, kp, vp, dop, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Sq, Sk, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D>
      <<<dim3((Sq + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
          qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Sq, Sk, H, K,
          causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq [B,Sq,H,D]; k, v, dk, dv [B,Sk,K,D]; lse and the
// scratch delta [B,Sq,H] fp32; all contiguous, q..dv of one dtype.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* out,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int B, int Sq, int Sk, int H,
                                      int K, int D, int causal, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  using bf16 = __nv_bfloat16;
#define RT_BWD(T, DD) \
  return (int)launch<T, DD>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, causal, window, s)
  if (dtype == rt::kBFloat16) {
    if (D == 64) RT_BWD(bf16, 64);
    if (D == 128) RT_BWD(bf16, 128);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) RT_BWD(float, 64);
    if (D == 128) RT_BWD(float, 128);
  }
#undef RT_BWD
  return (int)cudaErrorInvalidValue;
}

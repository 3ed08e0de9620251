// Flash-decode over the dense rolling KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention -> pl.pallas_call, body _decode_kernel): one query
// token per row attends over the cache [B,C,K,D]; validity comes only
// from the data, pos >= 0 & pos <= cur (& pos > cur - window), so a
// wrapped rolling cache needs no index arithmetic. q is pre-scaled by
// 1/sqrt(D), masked scores are -1e30, l is clamped at 1e-30, and QK^T,
// the softmax and PV are fp32 (the TPU kernel upcasts k and v first).
//
// Bound on the H100 at the serving shapes (q [8,24,128], caches
// [8,576,8,128] bf16): it must read 18.9 MB of K/V cache, 5.6 us at
// 3.35 TB/s; its 7 MFLOP are nothing. So bytes bound it, and the design
// reads each cache entry from device memory exactly once: the G query
// heads of a KV group are processed together by one block, so the group
// shares every K and V load. One block per (KV head, batch) gives B*K
// blocks (64 at batch 8, for 132 SMs); splitting C across blocks to fill
// the card is later work.
//
// Layout: D threads (one warp per 32 dims). The cache streams in chunks
// of 64 slots. Scores: each warp takes whole slots, a lane holds D/32
// dims of q for all G heads in registers and the warp reduces the G dot
// products with shuffles. Softmax: warp w updates heads w, w+D/32, ...
// PV: thread d owns output dim d of all G heads, reading V coalesced.
#include "common.cuh"

namespace {

constexpr int BC = 64;     // cache slots per chunk
constexpr int MAXG = 8;    // most query heads per KV head

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ pos,
              const int* __restrict__ position, T* __restrict__ o, int C,
              int H, int K, int window, float scale) {
  constexpr int NW = D / 32;   // warps
  constexpr int E = D / 32;    // dims per lane in the score phase
  __shared__ float sp[MAXG][BC];   // scores, then probabilities
  __shared__ float s_m[MAXG], s_l[MAXG], s_alpha[MAXG];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int d = threadIdx.x;
  const int cur = position[b];

  float qr[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = g < G
          ? rt::to_f(q[((size_t)b * H + kh * G + g) * D + lane * E + e]) * scale
          : 0.f;
  if (threadIdx.x < MAXG) {
    s_m[threadIdx.x] = rt::kNegInf;
    s_l[threadIdx.x] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    for (int cc = warp; cc < BC; cc += NW) {
      const int c = c0 + cc;
      bool ok = false;
      float kx[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kx[e] = 0.f;
      if (c < C) {
        const int p = pos[(size_t)b * C + c];
        ok = p >= 0 && p <= cur && (window == 0 || p > cur - window);
        const T* krow = kc + (((size_t)b * C + c) * K + kh) * D + lane * E;
#pragma unroll
        for (int e = 0; e < E; ++e) kx[e] = rt::to_f(krow[e]);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kx[e], dot);
        dot = rt::group_sum<32>(dot);
        if (lane == 0) sp[g][cc] = ok ? dot : rt::kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      const float a = sp[g][lane], bb = sp[g][lane + 32];
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, rt::group_max<32>(fmaxf(a, bb)));
      const float pa = expf(a - m_new), pb = expf(bb - m_new);
      sp[g][lane] = pa;
      sp[g][lane + 32] = pb;
      const float sum = rt::group_sum<32>(pa + pb);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= s_alpha[g];
    const int n = min(BC, C - c0);
    const T* vcol = vc + ((size_t)b * C + c0) * K * D + (size_t)kh * D + d;
#pragma unroll 4
    for (int cc = 0; cc < n; ++cc) {
      const float vx = rt::to_f(vcol[(size_t)cc * K * D]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = fmaf(sp[g][cc], vx, acc[g]);
    }
    __syncthreads();   // sp is rewritten by the next chunk
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
      rt::store_f(o + ((size_t)b * H + kh * G + g) * D + d,
                  acc[g] / fmaxf(s_l[g], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* pos, const int* position, void* o, int B,
                   int C, int H, int K, int window, cudaStream_t stream) {
  const dim3 grid(K, B);
  decode_kernel<T, D><<<grid, D, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, position, static_cast<T*>(o), C, H, K,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q [B,H,D], caches [B,C,K,D] (one dtype), pos [B,C] int32, position [B]
// int32, o [B,H,D]; all contiguous. H / K <= 8.
extern "C" int rt_decode_attention(const void* q, const void* kc,
                                   const void* vc, const void* pos,
                                   const void* position, void* o, int B,
                                   int C, int H, int K, int D, int window,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0 || K <= 0 || H % K != 0 || H / K > MAXG)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  const int* cur = static_cast<const int*>(position);
  if (dtype == rt::kBFloat16) {
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(q, kc, vc, p, cur, o, B, C, H, K, window, s);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(q, kc, vc, p, cur, o, B, C, H, K, window, s);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) return (int)launch<float, 64>(q, kc, vc, p, cur, o, B, C, H, K, window, s);
    if (D == 128) return (int)launch<float, 128>(q, kc, vc, p, cur, o, B, C, H, K, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

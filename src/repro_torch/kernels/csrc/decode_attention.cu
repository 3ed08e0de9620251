// Flash-decode over the dense rolling KV cache, split across the cache,
// for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention -> pl.pallas_call, body _decode_kernel): one query
// token per row attends over the cache [B,C,K,D]; validity comes only
// from the data, pos >= 0 & pos <= cur (& pos > cur - window), so a
// wrapped rolling cache needs no index arithmetic. q is scaled by
// 1/sqrt(D), masked scores are -1e30, l is clamped at 1e-30, and QK^T,
// the softmax and PV are fp32 (the TPU kernel upcasts k and v first).
//
// Bound on the H100 at the serving shapes (q [8,24,128], caches
// [8,576,8,128] bf16): it must read 18.9 MB of K/V cache, 5.6 us at
// 3.35 TB/s, for 7 MFLOP: 0.37 FLOP a byte against the ~295 at which the
// tensor cores would matter. So it uses none: the whole design is to
// read the cache once, from every SM at once.
//
// Design ("flash-decoding", split-C). Grid (splits, K, B): a block takes
// one span of `span` cache slots for all G query heads of one KV head, so
// the group shares every K/V load; the wrapper picks the split count
// from the shapes alone (decode_attention.py::split_plan), aiming at two
// blocks per SM. A block is 128 threads. A K or V row loads as 16 bytes
// a lane (a half-warp covers one 128-dim bf16 row); each row group of
// lanes takes R slots a step, all loads of a step issued before any use,
// so a block keeps 32 rows of K and V in flight; in bf16 the next step's
// rows load while this one computes (64 in flight). Scores for the G heads
// come from q held in registers and a reduction over the row group's
// lanes; each row group runs its own online softmax (exp2, q pre-scaled
// by log2 e) and keeps its lanes' dims of the G accumulators in
// registers. The row groups merge once, in shared memory, at the end of
// the span. The block then writes its unnormalised partial (m, l per head
// and acc [G, D], fp32) to scratch that the wrapper allocates, and
// combine_kernel (one block per (row, query head), same stream) rescales
// and sums the partials and writes the output dtype; it is launched as a
// programmatic dependent of the first kernel, so its launch overlaps the
// first kernel's last blocks and it waits (griddepcontrol.wait) for their
// partials. With one split the block normalises and writes the output
// itself, and nothing else runs.
// Two launches rather than one with a last-block-done counter: no counter
// to reset between calls, and the combine reads 0.5 MB at the main shape.
//
// Empty and masked slots. A real slot that fails the mask scores -1e30 and
// takes part in the softmax; a slot outside the span takes no part. So a
// row with no valid slot gets the uniform mean over its C real slots,
// which is what the oracle (ref.decode_attention_ref) computes.
#include "common.cuh"

namespace {

constexpr int NT = 128;        // threads per block
constexpr int STEP = 32;       // slots a block reads per step (span multiple)
constexpr int MAXG = 8;        // most query heads per KV head
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void unpack(const uint4& u, float* x, float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* x,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One block per (split, KV head, batch row); see the note above.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos,
                    const int* __restrict__ position, T* __restrict__ o,
                    float* __restrict__ part, int C, int K, int span,
                    int splits, int window, float scale) {
  constexpr int E = 16 / sizeof(T);     // dims per lane (one 16-byte load)
  constexpr int LPR = D / E;            // lanes per cache row
  constexpr int NRG = NT / LPR;         // row groups per block
  constexpr int R = STEP / NRG;         // slots per row group per step
  static_assert(LPR <= 32 && NRG * R == STEP, "bad tiling");
  __shared__ float s_acc[NRG][G][D];
  __shared__ float s_m[NRG][G], s_l[NRG][G];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int H = K * G;
  // the combine kernel may be scheduled now; it waits for our partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int rg = threadIdx.x / LPR, li = threadIdx.x % LPR;
  const int cur = position[b];
  const int c_begin = split * span;
  const int c_end = min(C, c_begin + span);

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * H + kh * G + g) * D + li * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = rt::to_f(qp[e]) * scale * kLog2e;
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)K * D;
  const T* kbase = kc + ((size_t)b * C * K + kh) * D + li * E;
  const T* vbase = vc + ((size_t)b * C * K + kh) * D + li * E;
  const int* pbase = pos + (size_t)b * C;

  // One step: R slots of this row group, all loads issued before any use.
  // In bf16 the next step's loads are issued before this step's
  // arithmetic; fp32 takes twice the registers a row (R is twice as
  // large), so it loads a step after finishing the last one.
  constexpr bool kPrefetch = sizeof(T) == 2;
  struct Rows {
    uint4 k[R], v[R];
    int p[R];
    bool in[R];          // a slot outside the span scores -inf, weighs 0
  };
  auto load = [&](int c0, Rows& x) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = c0 + r * NRG + rg;
      x.in[r] = c < c_end;
      if (x.in[r]) {
        x.k[r] = __ldg(reinterpret_cast<const uint4*>(kbase + c * row_stride));
        x.v[r] = __ldg(reinterpret_cast<const uint4*>(vbase + c * row_stride));
        x.p[r] = __ldg(pbase + c);
      } else {
        x.k[r] = x.v[r] = make_uint4(0u, 0u, 0u, 0u);
        x.p[r] = -1;
      }
    }
  };
  Rows cur_rows;
  load(c_begin, cur_rows);
  for (int c0 = c_begin; c0 < c_end; c0 += STEP) {
    Rows next;
    if constexpr (kPrefetch) load(c0 + STEP, next);
    float s[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float kx[E];
      unpack(cur_rows.k[r], kx, T());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kx[e], dot);
        s[r][g] = rt::group_sum<LPR>(dot);
      }
      const int p = cur_rows.p[r];
      const bool ok = p >= 0 && p <= cur && (window == 0 || p > cur - window);
      const float fill =
          cur_rows.in[r] ? rt::kNegInf : -__int_as_float(0x7f800000);
#pragma unroll
      for (int g = 0; g < G; ++g) s[r][g] = ok ? s[r][g] : fill;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r) mx = fmaxf(mx, s[r][g]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float vx[E];
      unpack(cur_rows.v[r], vx, T());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = exp2f(s[r][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
      }
    }
    if constexpr (kPrefetch)
      cur_rows = next;
    else
      load(c0 + STEP, cur_rows);
  }

  // merge the row groups: one pass through shared memory
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[rg][g][li * E + e] = acc[g][e];
    if (li == 0) {
      s_m[rg][g] = m[g];
      s_l[rg][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float mx = rt::kNegInf;
#pragma unroll
    for (int r = 0; r < NRG; ++r) mx = fmaxf(mx, s_m[r][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < NRG; ++r) {
      const float w = exp2f(s_m[r][g] - mx);
      lsum = fmaf(s_l[r][g], w, lsum);
      a = fmaf(s_acc[r][g][d], w, a);
    }
    const int h = kh * G + g;
    if (splits == 1) {
      rt::store_f(o + ((size_t)b * H + h) * D + d, a / fmaxf(lsum, 1e-30f));
    } else {
      // part [B, H, splits, D + 2]: acc, then m, then l
      float* pp = part + (((size_t)b * H + h) * splits + split) * (D + 2);
      pp[d] = a;
      if (d == 0) {
        pp[D] = mx;
        pp[D + 1] = lsum;
      }
    }
  }
}

// One block of D threads per (query head, batch row): rescale the splits'
// partials to their common max and sum them.
template <typename T, int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part, T* __restrict__ o,
               int splits) {
  // launched early (programmatic dependent launch): wait here until the
  // split kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, d = threadIdx.x;
  const float* pp = part + ((size_t)b * H + h) * splits * (D + 2);
  float mx = rt::kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pp[s * (D + 2) + D]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = exp2f(pp[s * (D + 2) + D] - mx);
    lsum = fmaf(pp[s * (D + 2) + D + 1], w, lsum);
    a = fmaf(pp[s * (D + 2) + d], w, a);
  }
  rt::store_f(o + ((size_t)b * H + h) * D + d, a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D, int G>
cudaError_t launch_g(const void* q, const void* kc, const void* vc,
                     const int* pos, const int* position, void* o,
                     float* part, int B, int C, int K, int span, int splits,
                     int window, cudaStream_t stream) {
  decode_split_kernel<T, D, G><<<dim3(splits, K, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, position, static_cast<T*>(o), part, C,
      K, span, splits, window, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  // the combine may launch while the split kernel's last blocks run
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * G, B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<T, D>,
                           static_cast<const float*>(part), static_cast<T*>(o),
                           splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(int G, const void* q, const void* kc, const void* vc,
                   const int* pos, const int* position, void* o, float* part,
                   int B, int C, int K, int span, int splits, int window,
                   cudaStream_t s) {
  switch (G) {
#define RT_CASE(g) \
  case g: return launch_g<T, D, g>(q, kc, vc, pos, position, o, part, B, C, K, span, splits, window, s);
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
#undef RT_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,D], caches [B,C,K,D] (one dtype), pos [B,C] int32, position [B]
// int32, o [B,H,D]; all contiguous. H / K <= 8. The cache is cut into
// `splits` spans of `span` slots, none empty; with splits > 1, `part`
// is fp32 scratch of B*H*splits*(D+2) floats.
extern "C" int rt_decode_attention(const void* q, const void* kc,
                                   const void* vc, const void* pos,
                                   const void* position, void* o, void* part,
                                   int B, int C, int H, int K, int D,
                                   int span, int splits, int window,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0 || K <= 0 || H % K != 0 || H / K > MAXG ||
      splits <= 0 || span <= 0 || (long long)span * splits < C ||
      (long long)span * (splits - 1) >= C || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  const int* cur = static_cast<const int*>(position);
  float* pt = static_cast<float*>(part);
  const int G = H / K;
  if (dtype == rt::kBFloat16) {
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(G, q, kc, vc, p, cur, o, pt, B, C, K, span, splits, window, s);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(G, q, kc, vc, p, cur, o, pt, B, C, K, span, splits, window, s);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) return (int)launch<float, 64>(G, q, kc, vc, p, cur, o, pt, B, C, K, span, splits, window, s);
    if (D == 128) return (int)launch<float, 128>(G, q, kc, vc, p, cur, o, pt, B, C, K, span, splits, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Paged flash-decode over a block-table-indexed KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel repro/paged/attention.py
// (paged_decode_attention -> pl.pallas_call, body _paged_decode_kernel):
// one query token per row attends over the row's pages of the pool
// [P,ps,K,D], found through its block table [B,nb] (-1 = unallocated).
// Logical token t lives at pool[bt[b, t / ps], t % ps]; it is valid iff
// t <= position[b] and bt[b, t / ps] >= 0. A -1 entry aliases page 0 and
// is masked. q is pre-scaled by 1/sqrt(D), masked scores are -1e30, l is
// clamped at 1e-30, and QK^T, the softmax and PV are fp32 (the TPU kernel
// upcasts k and v first). The G = H / K query heads of a KV group are
// handled together, so the group shares every K and V load.
//
// The pool is read in place, [P,ps,K,D] with a slot stride of K*D: the
// TPU wrapper transposes both pools to [P,K,ps,D] on every call, a copy
// of the whole pool, which this kernel does not make. Offsets are 64-bit.
//
// Bound on the H100 at the paged GRPO rollout's last decode step (q
// [64,24,128], pools [577,16,8,128] bf16, 8 prompts of 504 tokens forked
// 8 ways, position 566): the rows read 568 distinct pages, 35.5 MiB of
// K/V, 11 us at 3.35 TB/s; its 0.2 GFLOP are nothing. So bytes bound it.
// Forked rows name the same prompt pages, so the 64 rows' reads (144 MiB
// counted per row) mostly hit L2 after the first row of a group.
//
// Design: one block of 128 threads per (KV head, row): B*K = 512 blocks at
// those shapes. The block walks logical slots in chunks of 64 (four pages
// of 16). A slot's K row is read by LPS adjacent lanes, 16 bytes each
// (LPS = 16 for bf16 D = 128, so a warp takes two slots at once); all of
// a chunk's loads are issued before any is used. Scores reduce over the
// LPS lanes with shuffles; the online softmax is updated per chunk; PV
// uses the same slot mapping, each lane keeping partial sums of its
// dims for all G heads, reduced across lanes and warps at the end.
//
// Walk length: a row with position >= 0 and an allocated page at or
// before the one holding position stops after that page — every later
// slot is masked, and a masked score adds exp(-1e30 - m) = 0 once m is a
// real score. A row with no valid slot (position -1, or only holes up to
// it) walks all nb pages, because there the -1e30 fill makes the result
// the uniform mean of every gathered V row, as in the reference.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block
constexpr int NW = NT / 32;
constexpr int BC = 64;    // logical slots per chunk (the softmax phase
                          // takes two per lane)
__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// 16 bytes of T as fp32
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ position, T* __restrict__ o,
                    int nb, int ps, int H, int K, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LPS = D / VEC;          // lanes per slot row
  constexpr int SPW = 32 / LPS;         // slots per warp per pass
  constexpr int SPP = NW * SPW;         // slots per block per pass
  constexpr int PASSES = BC / SPP;
  static_assert(LPS <= 32 && 32 % LPS == 0 && BC % SPP == 0, "layout");

  __shared__ float sp[G][BC];           // scores, then probabilities
  __shared__ float s_m[G], s_l[G], s_alpha[G];
  __shared__ float red[NW][G][D];       // per-warp partial outputs

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane / LPS;           // slot of the warp's pass
  const int part = lane % LPS;          // which VEC dims of the row
  const int cur = position[b];
  const int* btr = bt + (size_t)b * nb;
  const size_t row = (size_t)K * D;     // pool stride between slots
  const size_t page_stride = (size_t)ps * row;
  const size_t col = (size_t)kh * D + part * VEC;

  int end = nb;                         // pages walked
  if (cur >= 0) {
    const int last = min(nb - 1, cur / ps);
    bool any = false;
    for (int j = 0; j <= last; ++j) any |= btr[j] >= 0;
    if (any) end = last + 1;
  }
  const int n_slots = end * ps;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float f[VEC];
    unpack(*reinterpret_cast<const uint4*>(
               q + ((size_t)b * H + kh * G + g) * D + part * VEC), f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] = f[e] * scale;
  }
  if (threadIdx.x < G) {
    s_m[threadIdx.x] = rt::kNegInf;
    s_l[threadIdx.x] = 0.f;
  }
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;

  for (int c0 = 0; c0 < n_slots; c0 += BC) {
    // element offset of each of this lane's slots in the chunk, or -1
    // past the walk; page -1 aliases page 0
    long long off[PASSES];
    bool ok[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int t = c0 + i * SPP + warp * SPW + sub;
      off[i] = -1;
      ok[i] = false;
      if (t < n_slots) {
        const int j = t / ps;
        const int pg = btr[j];
        ok[i] = pg >= 0 && t <= cur;
        off[i] = (long long)((size_t)max(pg, 0) * page_stride +
                             (size_t)(t - j * ps) * row + col);
      }
    }

    // scores: all K loads first, then the dot products
    uint4 raw[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i)
      raw[i] = off[i] >= 0 ? *reinterpret_cast<const uint4*>(kp + off[i])
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      float kx[VEC];
      unpack(raw[i], kx);
      const int cc = i * SPP + warp * SPW + sub;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[g][e], kx[e], dot);
        dot = rt::group_sum<LPS>(dot);
        // a slot past the walk weighs nothing even in an all-masked row
        if (part == 0)
          sp[g][cc] = ok[i] ? dot : (off[i] >= 0 ? rt::kNegInf : minus_inf());
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

    // PV with the same slot mapping
#pragma unroll
    for (int i = 0; i < PASSES; ++i)
      raw[i] = off[i] >= 0 ? *reinterpret_cast<const uint4*>(vp + off[i])
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = s_alpha[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      float vx[VEC];
      unpack(raw[i], vx);
      const int cc = i * SPP + warp * SPW + sub;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sp[g][cc];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
      }
    }
    __syncthreads();   // sp is rewritten by the next chunk
  }

  // sum the partials of the warp's SPW slot lanes, then across warps
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float v = acc[g][e];
#pragma unroll
      for (int sh = LPS; sh < 32; sh <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, sh);
      if (sub == 0) red[warp][g][part * VEC + e] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += red[w][g][d];
    rt::store_f(o + ((size_t)b * H + kh * G + g) * D + d,
                v / fmaxf(s_l[g], 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* position, void* o, int B,
                   int nb, int ps, int H, int K, cudaStream_t stream) {
  const dim3 grid(K, B);
  paged_decode_kernel<T, D, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, position, static_cast<T*>(o), nb, ps,
      H, K, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* kp, const void* vp,
                     const int* bt, const int* position, void* o, int B,
                     int nb, int ps, int H, int K, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 2: return launch<T, D, 2>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 3: return launch<T, D, 3>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 4: return launch<T, D, 4>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 5: return launch<T, D, 5>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 6: return launch<T, D, 6>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 7: return launch<T, D, 7>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
    case 8: return launch<T, D, 8>(q, kp, vp, bt, position, o, B, nb, ps, H, K, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,D], pools [P,ps,K,D] (one dtype), block table [B,nb] int32 with
// entries in [-1, P), position [B] int32, o [B,H,D]; all contiguous and
// 16-byte aligned. H / K <= 8.
extern "C" int rt_paged_decode_attention(const void* q, const void* kp,
                                         const void* vp, const void* bt,
                                         const void* position, void* o,
                                         int B, int nb, int ps, int H, int K,
                                         int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nb <= 0 || ps <= 0 || K <= 0 || H % K != 0 || H / K > 8)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int* t = static_cast<const int*>(bt);
  const int* cur = static_cast<const int*>(position);
  if (dtype == rt::kBFloat16) {
    if (D == 64) return (int)launch_g<__nv_bfloat16, 64>(G, q, kp, vp, t, cur, o, B, nb, ps, H, K, s);
    if (D == 128) return (int)launch_g<__nv_bfloat16, 128>(G, q, kp, vp, t, cur, o, B, nb, ps, H, K, s);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) return (int)launch_g<float, 64>(G, q, kp, vp, t, cur, o, B, nb, ps, H, K, s);
    if (D == 128) return (int)launch_g<float, 128>(G, q, kp, vp, t, cur, o, B, nb, ps, H, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

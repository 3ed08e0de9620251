// Mamba2 SSD chunk scan for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan ->
// pl.pallas_call, body _ssd_kernel): one program per (batch, head), the
// chunks taken in order with an fp32 [P, N] state carried across them.
// Within a chunk of l steps, with a_cum = cumsum(a):
//   L[i,j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
//   y      = ((C B^T) o L) x + (C o exp(a_cum)) state^T
//   state <- exp(a_cum[l-1]) state + ((B o exp(a_cum[l-1] - a_cum))^T x)^T
// All of it in fp32, as the TPU kernel upcasts x, a, b and c; y and the
// final state are written in x's dtype.
//
// Bound on the H100 at the serving path's shapes (x [8,2048,32,64] bf16,
// a [8,2048,32] fp32, b/c [8,2048,128] bf16, chunk 256): it must move
// 149 MB (x, a, b, c read once, y and the state written once), 44.5 us at
// 3.35 TB/s, and do 26.3 GFLOP (the causal half of C B^T once per batch
// and chunk, the causal product with x, y_off and the state update per
// head), 27 us at the bf16 tensor-core rate: the bytes bound it. This
// first version does its products in fp32 on the CUDA cores (67 TFLOP/s
// peak) and does more than that work: C B^T once per head and over whole
// 64-row tiles on the diagonal. wgmma for the three products, and C B^T
// computed once per (batch, chunk) rather than once per head, are later
// work. What the design does about the bytes: x is read in place in its
// [B,S,H,P] layout (the TPU wrapper transposes it to [B,H,nc,l,P], a
// copy), the state never leaves shared memory between chunks, and the
// score tiles never leave the SM.
//
// Layout: one block of 256 threads per (head, batch). The state lives in
// shared memory as fp32 [P][N+1]. Per chunk: a_cum by a warp scan; then
// for each 64-row query tile of C, first y_off from the state as it was
// before this chunk, then for each key tile j <= i of B and x the score
// tile C B^T (exp taken only where j <= i), then its product with x; and
// after every query tile of the chunk, the state update over the chunk's
// key tiles. Thread (tr = tid / 16, tc = tid % 16) owns rows 4tr..4tr+3
// and columns tc + 16k of each [64 x 64] output tile, so every product
// reads 8 shared values for 16 multiply-adds; the state update gives
// each thread a 4 x 8 register tile of [P x N]. P <= 64 and N <= 128;
// any chunk length (the last tile of a chunk may be partial).
#include "common.cuh"

namespace {

constexpr int NT = 256;      // threads per block
constexpr int T = 64;        // rows per query / key tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;

size_t smem_bytes(int P, int N, int chunk) {
  // state [P][N+1], C tile [T][N+1], B tile [T][N+1], x tile [T][P+1],
  // scores [T][T+1], a_cum [chunk]; all fp32
  return sizeof(float) * ((size_t)P * (N + 1) + 2 * (size_t)T * (N + 1) +
                          (size_t)T * (P + 1) + (size_t)T * (T + 1) + chunk);
}

// The first `rows` rows (`width` columns, row stride `ld`) of `src` into
// a [T][width+1] fp32 tile, row r times scale[r] when given; the tile's
// rows past `rows` are 0.
template <typename T_>
__device__ void load_tile(float* dst, const T_* src, size_t ld, int rows,
                          int width, const float* scale) {
  for (int idx = threadIdx.x; idx < T * width; idx += NT) {
    const int r = idx / width, n = idx % width;
    float v = 0.f;
    if (r < rows) {
      v = rt::to_f(src[(size_t)r * ld + n]);
      if (scale) v *= scale[r];
    }
    dst[r * (width + 1) + n] = v;
  }
}

template <typename T_, typename A_>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T_* __restrict__ x, const A_* __restrict__ a,
                const T_* __restrict__ b, const T_* __restrict__ c,
                T_* __restrict__ y, T_* __restrict__ fin, int S, int H,
                int P, int N, int chunk) {
  extern __shared__ float smem[];
  float* st = smem;                       // [P][N+1]
  float* cs = st + P * (N + 1);           // [T][N+1]
  float* bs = cs + T * (N + 1);           // [T][N+1]
  float* xs = bs + T * (N + 1);           // [T][P+1]
  float* ss = xs + T * (P + 1);           // [T][T+1]
  float* acum = ss + T * (T + 1);         // [chunk]

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int lane = tid % 32;
  const size_t xld = (size_t)H * P;       // x / y row stride
  const T_* xb = x + (size_t)bi * S * xld + (size_t)h * P;
  T_* yb = y + (size_t)bi * S * xld + (size_t)h * P;
  const A_* ab = a + (size_t)bi * S * H + h;
  const T_* bb = b + (size_t)bi * S * N;
  const T_* cb = c + (size_t)bi * S * N;

  for (int i = tid; i < P * (N + 1); i += NT) st[i] = 0.f;
  const int ntile = (chunk + T - 1) / T;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    // a_cum over the chunk: one warp, 32 steps at a time, carry across
    __syncthreads();   // the previous chunk's readers of acum are done
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < chunk; base += 32) {
        const int i = base + lane;
        float v = i < chunk ? rt::to_f(ab[(size_t)(c0 + i) * H]) : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (i < chunk) acum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float a_last = acum[chunk - 1];

    for (int qt = 0; qt < ntile; ++qt) {
      const int i0 = qt * T;
      const int qrows = min(T, chunk - i0);
      load_tile(cs, cb + (size_t)(c0 + i0) * N, N, qrows, N, nullptr);
      __syncthreads();

      // y_off = (C o exp(a_cum)) state^T, from the state before this chunk
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(tr * 4 + r) * (N + 1) + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tc + 16 * k;
          sv[k] = p < P ? st[p * (N + 1) + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + tr * 4 + r;
        const float d = i < chunk ? expf(acum[i]) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] *= d;
      }

      // y_diag over the key tiles j <= i
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * T;
        const int krows = min(T, chunk - j0);
        load_tile(bs, bb + (size_t)(c0 + j0) * N, N, krows, N, nullptr);
        load_tile(xs, xb + (size_t)(c0 + j0) * xld, xld, krows, P, nullptr);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(tr * 4 + r) * (N + 1) + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = bs[(tc + 16 * k) * (N + 1) + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[r][k] = fmaf(cv[r], bv[k], sc[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + tr * 4 + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tc + 16 * k;
            // exp only where j <= i (and both rows are in the chunk)
            const float l = (j <= i && i < chunk)
                                ? expf(acum[i] - acum[j]) : 0.f;
            ss[(tr * 4 + r) * (T + 1) + tc + 16 * k] = sc[r][k] * l;
          }
        }
        __syncthreads();
        for (int j = 0; j < krows; ++j) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = ss[(tr * 4 + r) * (T + 1) + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tc + 16 * k;
            xv[k] = p < P ? xs[j * (P + 1) + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(sv[r], xv[k], acc[r][k]);
        }
        __syncthreads();   // bs, xs and ss are reloaded next
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = tr * 4 + r;
        if (i >= qrows) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tc + 16 * k;
          if (p < P) rt::store_f(yb + (size_t)(c0 + i0 + i) * xld + p,
                                 acc[r][k]);
        }
      }
    }

    // state <- exp(a_last) state + ((B o exp(a_last - a_cum))^T x)^T, after
    // every query tile of this chunk has read the old state
    float upd[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) upd[r][k] = 0.f;
    for (int kt = 0; kt < ntile; ++kt) {
      const int j0 = kt * T;
      const int krows = min(T, chunk - j0);
      __syncthreads();   // the previous tile's readers are done
      for (int idx = tid; idx < krows; idx += NT)
        ss[idx] = expf(a_last - acum[j0 + idx]);
      __syncthreads();
      load_tile(bs, bb + (size_t)(c0 + j0) * N, N, krows, N, ss);
      load_tile(xs, xb + (size_t)(c0 + j0) * xld, xld, krows, P, nullptr);
      __syncthreads();
      for (int j = 0; j < krows; ++j) {
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = tr * 4 + r;
          xv[r] = p < P ? xs[j * (P + 1) + p] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = tc + 16 * k;
          bv[k] = n < N ? bs[j * (N + 1) + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) upd[r][k] = fmaf(xv[r], bv[k], upd[r][k]);
      }
    }
    const float dl = expf(a_last);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = tr * 4 + r;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tc + 16 * k;
        if (n < N) st[p * (N + 1) + n] = fmaf(dl, st[p * (N + 1) + n],
                                              upd[r][k]);
      }
    }
    // each thread wrote only its own entries; the next chunk's first
    // __syncthreads orders them before any reader
  }
  __syncthreads();
  T_* fb = fin + ((size_t)bi * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT)
    rt::store_f(fb + i, st[(i / N) * (N + 1) + i % N]);
}

template <typename T_, typename A_>
cudaError_t launch(const void* x, const void* a, const void* b,
                   const void* c, void* y, void* fin, int B, int S, int H,
                   int P, int N, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T_, A_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T_, A_><<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const T_*>(x), static_cast<const A_*>(a),
      static_cast<const T_*>(b), static_cast<const T_*>(c),
      static_cast<T_*>(y), static_cast<T_*>(fin), S, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P], a [B,S,H], b/c [B,S,N], all contiguous; y [B,S,H,P] and
// fin [B,H,P,N] of x's dtype. x, b, c share x_dtype; a is fp32 or x's.
extern "C" int rt_ssd_scan(const void* x, const void* a, const void* b,
                           const void* c, void* y, void* fin, int B, int S,
                           int H, int P, int N, int chunk, int x_dtype,
                           int a_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || S % chunk || P <= 0 ||
      P > MAX_P || N <= 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool xb = x_dtype == rt::kBFloat16, xf = x_dtype == rt::kFloat32;
  const bool ab = a_dtype == rt::kBFloat16, af = a_dtype == rt::kFloat32;
  if (xb && af)
    return (int)launch<bf16, float>(x, a, b, c, y, fin, B, S, H, P, N, chunk, s);
  if (xb && ab)
    return (int)launch<bf16, bf16>(x, a, b, c, y, fin, B, S, H, P, N, chunk, s);
  if (xf && af)
    return (int)launch<float, float>(x, a, b, c, y, fin, B, S, H, P, N, chunk, s);
  return (int)cudaErrorInvalidValue;
}

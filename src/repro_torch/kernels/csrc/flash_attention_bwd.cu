// Flash-attention backward for Hopper (B2-bwd).
//
// The TPU package has no Pallas backward: its model differentiates
// attention through the XLA custom VJP repro/models/flash.py::_bwd
// (:98-138), which recomputes the scores chunk by chunk from the saved
// log-normaliser. These kernels compute the same function: for q
// [B,Sq,H,D], k/v [B,Sk,K,D] (H % K == 0, query head h reads KV head
// h / G), the saved out [B,Sq,H,D] and lse [B,Sq,H] (fp32) and dout, they
// give dq, dk and dv, causal (top-left aligned, key <= query) /
// sliding-window / full, with ragged Sq and Sk.
//
// Bound on the H100 at the training shape (q [8,576,24,128], k/v
// [8,576,8,128] bf16, causal): it must read q, k, v, out and dout and
// write dq, dk and dv once, ~152 MB, 45 us at 3.35 TB/s; and do five
// products of 2 x 128 flop over the 31.9 M unmasked (query, key) pairs of
// the 192 heads, 41 us at the 989 TFLOP/s bf16 tensor-core rate. Bytes and
// operations are close, so the products belong on the tensor cores.
//
// The walk. Both routes tile queries and keys by 64 and take the launch
// plan of flash_attention_bwd.py::plan, computed on the host from the
// shapes alone: one int4 a block, (its tile, batch * heads + head, first
// and end tile of the other kind it walks), longest walk first. Only the
// (q tile, key tile) pairs with a visible (query, key) pair are walked. A
// dK/dV block per (key tile, KV head, batch) walks, for each of the G
// query heads of its KV head, the q tiles that see its keys, so the sum
// over the group stays inside the block; a dQ block per (q tile, query
// head, batch) walks the key tiles its rows see. No atomics: the result
// does not depend on the schedule. S and dP are computed by both kernels:
// seven products where the function needs five.
//
// bf16: wg::, on the tensor cores; one warpgroup a block, two blocks an
// SM (~98 KB of shared memory each at D 128).
// - flash_bwd_prep_kernel: delta = rowsum(dout * out) in fp32
//   (flash.py:110) and lse in log2 units, both as [B,H,Sq rounded up to
//   64] rows of scratch, so a tile's 64 values are one 256-byte copy; past
//   Sq delta is 0 and lse +inf, so P is 0 there.
// - flash_bwd_dkdv_wgmma_kernel: K and V once, then per step of the walk
//   the q and dO tiles of a (query head, q tile) and its lse and delta
//   rows, by TMA into a ring of two 128-byte-swizzled stages that thread 0
//   refills two steps ahead (mbarrier per stage). S^T = K Q^T and dP^T =
//   V dO^T are wgmma m64n64k16 with both operands K-major from shared
//   memory; P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T -
//   delta) run on the accumulator registers, which, rounded to bf16, are
//   the A fragments of dV += P^T dO and dK += dS^T Q (wgmma m64n(D)k16,
//   dO and Q as MN-major B operands), as B2's forward takes P V.
// - flash_bwd_dq_wgmma_kernel: q and dO once, K and V tiles through the
//   ring; S = Q K^T and dP = dO V^T (ss), P and dS on the registers, and
//   dQ += dS K with K MN-major.
// - Masks only on tiles that need them (the diagonal, the window's edge,
//   and in dQ the ragged Sk edge). Rows past Sq or Sk arrive as zeros; a
//   key row past Sk only reaches its own dK/dV row, which is not stored.
// - Epilogue: the fp32 sums, scaled, as bf16 into a tile the block no
//   longer reads (K and V; Q), then TMA stores that skip rows past Sq/Sk.
// Each step waits for its products: the other block on the SM fills the
// tensor cores meanwhile. Measured slower on the H100 at the training
// shape, and not kept: issuing the next tile's S and dP behind dQ (the
// K stage is then freed mid-step and the next loads wait on TMA), and
// delta computed inside the dQ kernel (each of its ~1700 short blocks
// waits for out before its first tile): PERF.md, Findings.
//
// fp32: simt::, the CUDA-core kernels of the first version, on the same
// plan: a delta pre-pass (one warp a row), then dK/dV and dQ kernels of
// 256 threads; thread (tr, tc) owns keys (or rows) 4tr..4tr+3 and columns
// tc + 16j; four fp32 tiles of [64][D+1] in shared memory.
//
// Numerics: the products of bf16 values are exact in fp32 and summed in
// fp32 in another order than the reference; the roundings the reference
// makes (P to dout's dtype before dV, flash.py:122; dS to q's dtype before
// dQ and dK, :125) are made at the same places, so on bf16 the tensor
// cores take exactly the operands ref.flash_attention_bwd_ref takes. The
// bf16 route's exponent is ex2.approx with log2 e folded into the scale
// (about 2 ulp); the fp32 route keeps expf.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int T = 64;   // q rows and keys a tile (flash_attention_bwd.py TILE)

// A block's entry of the plan: its tile, head and batch row, and the
// tiles [begin, end) of the other kind it walks.
struct Item {
  int tile, head, batch, begin, end;
};
__device__ __forceinline__ Item item_of(const int4* __restrict__ plan,
                                        int heads) {
  const int4 w = plan[blockIdx.x];
  return {w.x, w.y % heads, w.y / heads, w.z, w.w};
}

namespace simt {

constexpr int NT = 256;   // threads a block: (tr, tc) = (tid / 16, tid % 16)

template <int D>
constexpr size_t smem_bytes() {
  // four [64][D+1] fp32 tiles and one [64][65] P / dS tile, plus lse and
  // delta of the 64 rows
  return sizeof(float) * (4 * T * (D + 1) + T * 65 + 2 * T);
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
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ dout,
                       const float* __restrict__ out,
                       float* __restrict__ delta, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* a = dout + (size_t)row * D;
  const float* o = out + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s = fmaf(a[i], o[i], s);
  s = rt::group_sum<32>(s);
  if (lane == 0) delta[row] = s;
}

// rows r0.. of head h of a [B, S, heads, D] tensor into a [64][D+1] tile
// (zeros past S)
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int r0, int S, int heads, int h) {
  for (int i = threadIdx.x; i < T * D; i += NT) {
    const int r = i / D, d = i % D, ri = r0 + r;
    dst[r * (D + 1) + d] =
        ri < S ? src[(((size_t)b * S + ri) * heads + h) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int4* __restrict__ plan, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Sk, int H, int K,
                      int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [T][D+1]
  float* vs = ks + T * (D + 1);
  float* qs = vs + T * (D + 1);     // [T][D+1]
  float* dos = qs + T * (D + 1);
  float* ps = dos + T * (D + 1);    // [T][T+1]: P^T, then dS^T
  float* lse_s = ps + T * (T + 1);
  float* del_s = lse_s + T;
  constexpr int DC = D / 16;

  const Item it = item_of(plan, K);
  const int k0 = it.tile * T, kh = it.head, b = it.batch;
  const int G = H / K;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  load_tile<D>(ks, k, b, k0, Sk, K, kh);
  load_tile<D>(vs, v, b, k0, Sk, K, kh);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = it.begin; qt < it.end; ++qt) {
      const int q0 = qt * T;
      __syncthreads();   // the last tile's q, dO and ps are consumed
      load_tile<D>(qs, q, b, q0, Sq, H, h);
      load_tile<D>(dos, dout, b, q0, Sq, H, h);
      if (tid < T) {
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
#pragma unroll 2
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
          ps[(tr * 4 + i) * (T + 1) + r] = p;
        }
      }
      __syncthreads();
      // dV += P^T dO
#pragma unroll 4
      for (int c = 0; c < T; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(tr * 4 + i) * (T + 1) + c];
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
          ps[(tr * 4 + i) * (T + 1) + tc + 16 * j] = dp[i][j];
      __syncthreads();
      // dK += dS^T Q
#pragma unroll 4
      for (int c = 0; c < T; ++c) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = ps[(tr * 4 + i) * (T + 1) + c];
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
      dk[off + tc + 16 * cc] = dka[i][cc] * scale;
      dv[off + tc + 16 * cc] = dva[i][cc];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int4* __restrict__ plan, float* __restrict__ dq,
                    int Sq, int Sk, int H, int K, int causal, int window,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [T][D+1]
  float* dos = qs + T * (D + 1);
  float* ks = dos + T * (D + 1);    // [T][D+1]
  float* vs = ks + T * (D + 1);
  float* ps = vs + T * (D + 1);     // [T][T+1]: dS
  float* lse_s = ps + T * (T + 1);
  float* del_s = lse_s + T;
  constexpr int DC = D / 16;

  const Item it = item_of(plan, H);
  const int q0 = it.tile * T, h = it.head, b = it.batch;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  load_tile<D>(qs, q, b, q0, Sq, H, h);
  load_tile<D>(dos, dout, b, q0, Sq, H, h);
  if (tid < T) {     // in shared memory, not registers: no spills at D 128
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

  for (int kt = it.begin; kt < it.end; ++kt) {
    const int k0 = kt * T;
    __syncthreads();   // the last tile's k, v and dS are consumed
    load_tile<D>(ks, k, b, k0, Sk, K, kh);
    load_tile<D>(vs, v, b, k0, Sk, K, kh);
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
        ps[(tr * 4 + i) * (T + 1) + tc + 16 * j] =
            p * (dp[i][j] - del_s[tr * 4 + i]);
      }
    }
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ps[(tr * 4 + i) * (T + 1) + c];
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
    float* row = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) row[tc + 16 * cc] = acc[i][cc] * scale;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, const int4* plan, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int K, int causal,
                   int window, int n_dkdv, int n_dq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      dop, static_cast<const float*>(out), delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<n_dkdv, NT, smem, stream>>>(
      qp, kp, vp, dop, lse, delta, plan, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<n_dq, NT, smem, stream>>>(
      qp, kp, vp, dop, lse, delta, plan + n_dkdv, static_cast<float*>(dq), Sq,
      Sk, H, K, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace simt

namespace wg {

constexpr int NT = 128;      // one warpgroup a block
constexpr int NST = 2;       // ring stages
constexpr int CHUNK = 64;    // bf16 columns per 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Shared memory, every tile 1024-byte aligned for the 128-byte swizzle; a
// tile of D bf16 columns is D/64 regions of [64 rows][128 bytes]. dK/dV:
// K, V, then the ring's q and dO tiles and its lse and delta rows; dQ:
// q, dO, then the ring's K and V tiles.
template <int D>
struct Layout {
  static constexpr int TILE = T * D * 2;
  static constexpr size_t dkdv_bytes =
      (2 + 2 * NST) * TILE + NST * 2 * T * 4 + 1024;
  static constexpr size_t dq_bytes = (2 + 2 * NST) * TILE + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// K-major operand of 64 rows x D: the descriptor of k16 step kk (32 bytes
// within a swizzled row; a new region every 4 steps)
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * T * 128 + (kk % 4) * 32, 16, 1024);
}
// MN-major B operand, K = the tile's 64 rows: k16 step kk is 16 rows on;
// the next 64 columns are the next region
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * 128, T * 128, 1024);
}

// acc [64 x 64] = A B^T over D, A and B K-major [64][D] tiles
template <int D>
__device__ __forceinline__ void issue_abt(float* acc, const uint8_t* a,
                                          const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_m64n64<0>(acc, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// acc [64 x D] += P B over 64: P the bf16 A fragments, B a [64][D] tile
// (MN-major)
template <int D>
__device__ __forceinline__ void issue_pb(float* acc, const uint32_t (&p)[4][4],
                                         const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128)
      sm90::wgmma_rs_m64n128<1>(acc, p[kk], desc_mn(b, kk));
    else
      sm90::wgmma_rs_m64n64<1>(acc, p[kk], desc_mn(b, kk));
  }
}

// A [64 x 64] fp32 accumulator as bf16 A fragments (keys 16kk..16kk+15
// are score blocks 2kk and 2kk+1)
__device__ __forceinline__ void pack(uint32_t (&p)[4][4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = sm90::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// A [64 x D] accumulator times `mul` as bf16 into a [64][D] swizzled tile,
// the layout its TMA store reads; thread rows r_lo and r_lo + 8
template <int D>
__device__ __forceinline__ void stage_out(uint8_t* tile, const float* acc,
                                          float mul, int r_lo, int cq) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r_lo + 8 * hf;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + (j / 8) * T * 128 + r * 128 +
                                   (((j % 8) ^ (r % 8)) * 16) + cq * 2) =
          sm90::pack_bf16(acc[4 * j + 2 * hf] * mul,
                          acc[4 * j + 2 * hf + 1] * mul);
  }
}

// the pair (query qi, key kj) is masked (causal: top-left aligned)
__device__ __forceinline__ bool masked(int qi, int kj, int window) {
  return kj > qi || (window && kj <= qi - window);
}

// lse2 [B,H,Sqp] = lse log2 e (+inf past Sq) and delta [B,H,Sqp] = rowsum
// (dout * out) in fp32 (0 past Sq); D / 8 threads a row, 16 bytes each
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ dout,
                      const bf16* __restrict__ out,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int B, int Sq, int H,
                      int Sqp) {
  constexpr int TPR = D / 8;
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / TPR;
  const int sub = threadIdx.x % TPR;
  const bool row_ok = idx < B * H * Sqp;
  const int i = idx % Sqp, bh = idx / Sqp, h = bh % H, b = bh / H;
  const bool live = row_ok && i < Sq;
  const size_t src = (((size_t)b * Sq + i) * H + h);
  float s = 0.f;
  if (live) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + src * D + sub * 8);
    const uint4 o = *reinterpret_cast<const uint4*>(out + src * D + sub * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 x = __bfloat1622float2(a2[t]), y = __bfloat1622float2(o2[t]);
      s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
    }
  }
  s = rt::group_sum<TPR>(s);
  if (row_ok && sub == 0) {
    lse2[idx] = live ? lse[src] * kLog2e : __int_as_float(0x7f800000);
    delta[idx] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tdk,
                            const __grid_constant__ CUtensorMap tdv,
                            const int4* __restrict__ plan,
                            const float* __restrict__ lse2,
                            const float* __restrict__ delta, int H, int K,
                            int Sqp, int causal, int window, float scale_log2,
                            float scale) {
  using L = Layout<D>;
  constexpr int NC = D / CHUNK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ks = align1024(smem_raw);
  uint8_t* const vs = ks + L::TILE;
  uint8_t* const qs = vs + L::TILE;               // NST stages
  uint8_t* const dos = qs + NST * L::TILE;        // NST stages
  float* const vec = reinterpret_cast<float*>(dos + NST * L::TILE);
  __shared__ __align__(8) uint64_t kv_full, full[NST];

  const Item it = item_of(plan, K);
  const int G = H / K, nqt = it.end - it.begin, steps = G * nqt;
  const int k0 = it.tile * T;
  const int tid = threadIdx.x;
  // the warp index through a shuffle: warp-uniform to the compiler
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  // Thread 0 issues the loads by TMA: step n is q tile it.begin + n % nqt
  // of query head G kh + n / nqt, with its lse and delta rows ([2][T]
  // floats of the stage).
  auto load = [&](int n) {
    if (n >= steps) return;
    const int s = n % NST, h = it.head * G + n / nqt;
    const int q0 = (it.begin + n % nqt) * T;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::TILE + 2 * T * 4);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(qs + s * L::TILE + c * T * 128, &tq, &full[s],
                        c * CHUNK, h, q0, it.batch);
      sm90::tma_load_4d(dos + s * L::TILE + c * T * 128, &tdo, &full[s],
                        c * CHUNK, h, q0, it.batch);
    }
    const size_t off = ((size_t)it.batch * H + h) * Sqp + q0;
    sm90::bulk_load(vec + s * 2 * T, lse2 + off, T * 4, &full[s]);
    sm90::bulk_load(vec + s * 2 * T + T, delta + off, T * 4, &full[s]);
  };
  if (tid == 0) {
    sm90::mbar_init(&kv_full, 1);
    for (int s = 0; s < NST; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    if (steps > 0) {
      sm90::mbar_arrive_expect_tx(&kv_full, 2 * L::TILE);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(ks + c * T * 128, &tk, &kv_full, c * CHUNK,
                          it.head, k0, it.batch);
        sm90::tma_load_4d(vs + c * T * 128, &tv, &kv_full, c * CHUNK,
                          it.head, k0, it.batch);
      }
    }
    for (int n = 0; n < NST; ++n) load(n);
  }
  __syncthreads();

  // Thread (warp, lane) holds key rows kr and kr + 8 of the block's tile,
  // query columns 8j + cq and 8j + cq + 1 of each S^T tile.
  const int cq = 2 * (lane % 4);
  const int r_lo = warp * 16 + lane / 4;
  const int kr = k0 + r_lo;
  float dk[D / 2], dv[D / 2];
  float sc[32], dp[32];        // S^T then P^T; dP^T then dS^T
  uint32_t pa[4][4], pd[4][4];   // P^T and dS^T as bf16 A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (steps > 0) sm90::mbar_wait(&kv_full, 0);

  for (int n = 0; n < steps; ++n) {
    const int s = n % NST;
    const int q0 = (it.begin + n % nqt) * T;
    const uint8_t* qt = qs + s * L::TILE;
    const uint8_t* dot = dos + s * L::TILE;
    const float* lrow = vec + s * 2 * T;
    const float* drow = lrow + T;
    sm90::mbar_wait(&full[s], (n / NST) & 1);
    // S^T = K Q^T and dP^T = V dO^T
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    issue_abt<D>(sc, ks, qt);
    issue_abt<D>(dp, vs, dot);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    // P^T = exp2(S^T scale log2 e - lse2), 0 where masked; dS^T = P^T
    // (dP^T - delta). Past Sq, lse2 is +inf: P^T is 0.
    const bool need_mask = causal && (k0 + T - 1 > q0 ||
                                      (window && k0 <= q0 + T - 1 - window));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lrow + 8 * j + cq);
      const float2 d = *reinterpret_cast<const float2*>(drow + 8 * j + cq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          float p = sm90::exp2_approx(fmaf(sc[i], scale_log2, e ? -l.y : -l.x));
          if (need_mask && masked(q0 + 8 * j + cq + e, kr + 8 * hf, window))
            p = 0.f;
          sc[i] = p;
          dp[i] = p * (dp[i] - (e ? d.y : d.x));
        }
    }
    pack(pa, sc);
    pack(pd, dp);
    // dV += P^T dO and dK += dS^T Q
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
    issue_pb<D>(dv, pa, dot);
    issue_pb<D>(dk, pd, qt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    // every warp is done with the stage: refill it, two steps ahead
    sm90::named_sync(1, NT);
    if (tid == 0) load(n + NST);
  }

  // dK (scaled) and dV as bf16 into the K and V tiles (every product that
  // read them is done), then TMA stores; key rows past Sk are not written
  stage_out<D>(ks, dk, scale, r_lo, cq);
  stage_out<D>(vs, dv, 1.f, r_lo, cq);
  sm90::fence_async_smem();
  sm90::named_sync(1, NT);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sm90::tma_store_4d(&tdk, ks + c * T * 128, c * CHUNK, it.head, k0,
                         it.batch);
      sm90::tma_store_4d(&tdv, vs + c * T * 128, c * CHUNK, it.head, k0,
                         it.batch);
    }
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq,
                          const int4* __restrict__ plan,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta, int Sk, int H,
                          int K, int Sqp, int causal, int window,
                          float scale_log2, float scale) {
  using L = Layout<D>;
  constexpr int NC = D / CHUNK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const dos = qs + L::TILE;
  uint8_t* const ks = dos + L::TILE;              // NST stages
  uint8_t* const vs = ks + NST * L::TILE;         // NST stages
  __shared__ __align__(8) uint64_t q_full, full[NST];

  const Item it = item_of(plan, H);
  const int steps = it.end - it.begin, q0 = it.tile * T;
  const int kh = it.head / (H / K);
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  // Thread 0 issues the loads by TMA: step n is key tile it.begin + n.
  auto load = [&](int n) {
    if (n >= steps) return;
    const int s = n % NST, k0 = (it.begin + n) * T;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(ks + s * L::TILE + c * T * 128, &tk, &full[s],
                        c * CHUNK, kh, k0, it.batch);
      sm90::tma_load_4d(vs + s * L::TILE + c * T * 128, &tv, &full[s],
                        c * CHUNK, kh, k0, it.batch);
    }
  };
  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < NST; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    if (steps > 0) {
      sm90::mbar_arrive_expect_tx(&q_full, 2 * L::TILE);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_4d(qs + c * T * 128, &tq, &q_full, c * CHUNK, it.head,
                          q0, it.batch);
        sm90::tma_load_4d(dos + c * T * 128, &tdo, &q_full, c * CHUNK,
                          it.head, q0, it.batch);
      }
    }
    for (int n = 0; n < NST; ++n) load(n);
  }

  // Thread (warp, lane) holds rows qr and qr + 8 of the q tile, key
  // columns 8j + cq and 8j + cq + 1 of each S tile.
  const int cq = 2 * (lane % 4);
  const int r_lo = warp * 16 + lane / 4;
  const int qr = q0 + r_lo;
  const size_t off = ((size_t)it.batch * H + it.head) * Sqp + qr;
  const float lr[2] = {lse2[off], lse2[off + 8]};
  const float dr[2] = {delta[off], delta[off + 8]};
  float dq[D / 2];
  float sc[32], dp[32];        // S then P; dP then dS
  uint32_t pd[4][4];           // dS as bf16 A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  __syncthreads();
  if (steps > 0) sm90::mbar_wait(&q_full, 0);

  for (int n = 0; n < steps; ++n) {
    const int s = n % NST;
    const int k0 = (it.begin + n) * T;
    const uint8_t* kt = ks + s * L::TILE;
    const uint8_t* vt = vs + s * L::TILE;
    sm90::mbar_wait(&full[s], (n / NST) & 1);
    // S = Q K^T and dP = dO V^T
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    issue_abt<D>(sc, qs, kt);
    issue_abt<D>(dp, dos, vt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    // P = exp2(S scale log2 e - lse2), 0 where masked or past Sk; dS = P
    // (dP - delta)
    const bool need_mask =
        k0 + T > Sk || (causal && (k0 + T - 1 > q0 ||
                                   (window && k0 <= q0 + T - 1 - window)));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e, kj = k0 + 8 * j + cq + e;
          float p = sm90::exp2_approx(fmaf(sc[i], scale_log2, -lr[hf]));
          if (need_mask &&
              (kj >= Sk || (causal && masked(qr + 8 * hf, kj, window))))
            p = 0.f;
          dp[i] = p * (dp[i] - dr[hf]);
        }
    pack(pd, dp);
    // dQ += dS K
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
    issue_pb<D>(dq, pd, kt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    // every warp is done with the stage: refill it, two steps ahead
    sm90::named_sync(1, NT);
    if (tid == 0) load(n + NST);
  }

  // dQ (scaled) as bf16 into the q tile (every product that read it is
  // done), then TMA stores; rows past Sq are not written
  stage_out<D>(qs, dq, scale, r_lo, cq);
  sm90::fence_async_smem();
  sm90::named_sync(1, NT);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      sm90::tma_store_4d(&tdq, qs + c * T * 128, c * CHUNK, it.head, q0,
                         it.batch);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* scratch, const int4* plan, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int K, int causal,
                   int window, int n_dkdv, int n_dq, cudaStream_t stream) {
  using sm90::encode_bshd_map;
  using L = Layout<D>;
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  if (!encode_bshd_map(&tq, q, B, Sq, H, D, T) ||
      !encode_bshd_map(&tdo, dout, B, Sq, H, D, T) ||
      !encode_bshd_map(&tdq, dq, B, Sq, H, D, T) ||
      !encode_bshd_map(&tk, k, B, Sk, K, D, T) ||
      !encode_bshd_map(&tv, v, B, Sk, K, D, T) ||
      !encode_bshd_map(&tdk, dk, B, Sk, K, D, T) ||
      !encode_bshd_map(&tdv, dv, B, Sk, K, D, T))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::dkdv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::dq_bytes);
  if (err != cudaSuccess) return err;
  const int Sqp = (Sq + T - 1) / T * T;
  float* lse2 = scratch;
  float* delta = scratch + (size_t)B * H * Sqp;
  const float scale = 1.0f / sqrtf((float)D);
  const long threads = (long)B * H * Sqp * (D / 8);
  flash_bwd_prep_kernel<D><<<(int)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), lse,
      lse2, delta, B, Sq, H, Sqp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<n_dkdv, NT, L::dkdv_bytes, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, plan, lse2, delta, H, K, Sqp, causal,
      window, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D><<<n_dq, NT, L::dq_bytes, stream>>>(
      tq, tk, tv, tdo, tdq, plan + n_dkdv, lse2, delta, Sk, H, K, Sqp,
      causal, window, scale * kLog2e, scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q, out, dout, dq [B,Sq,H,D]; k, v, dk, dv [B,Sk,K,D]; lse [B,Sq,H] fp32;
// all contiguous, q..dv of one dtype (16-byte aligned on route 1). plan:
// the wrapper's int4 a block, the n_dkdv dK/dV blocks then the n_dq dQ
// blocks. route 1 (bf16: wg) takes scratch of 2 B H Sqp floats (Sqp = Sq
// rounded up to 64), route 0 (fp32: simt) B Sq H.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* out,
                                      const void* dout, const void* lse,
                                      void* scratch, const void* plan,
                                      void* dq, void* dk, void* dv, int B,
                                      int Sq, int Sk, int H, int K, int D,
                                      int causal, int window, int n_dkdv,
                                      int n_dq, int route, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0 || n_dkdv <= 0 ||
      n_dq <= 0)
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  const int4* pl = static_cast<const int4*>(plan);
#define RT_BWD(NS, DD) \
  return (int)NS::launch<DD>(q, k, v, out, dout, l, sc, pl, dq, dk, dv, B, Sq, Sk, H, K, causal, window, n_dkdv, n_dq, s)
  if (route == 1 && dtype == rt::kBFloat16) {
    if (D == 64) RT_BWD(wg, 64);
    if (D == 128) RT_BWD(wg, 128);
  } else if (route == 0 && dtype == rt::kFloat32) {
    if (D == 64) RT_BWD(simt, 64);
    if (D == 128) RT_BWD(simt, 128);
  }
#undef RT_BWD
  return (int)cudaErrorInvalidValue;
}

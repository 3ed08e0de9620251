// Flash-attention forward (prefill) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd -> pl.pallas_call, body _fwd_kernel): online-softmax
// GQA attention, causal (top-left aligned, key <= query) / sliding-window
// / full; query head h reads KV head h // G in place; ragged Sq and Sk are
// masked here, never padded on the host; masked scores are -1e30, l is
// clamped at 1e-30, and m, l and the accumulator are fp32.
//
// Bound on the H100 at the serving shapes (q [8,512,24,128], k/v
// [8,512,8,128] bf16, causal): it must move 67 MB (q, k, v once, out
// once), 20 us at 3.35 TB/s, and do 12.9 GFLOP on the pairs key <= query,
// 13 us at the 989 TFLOP/s bf16 tensor-core rate: bytes bound it, with the
// operations close behind. fp32 FMAs on the CUDA cores (67 TFLOP/s) would
// need ~0.2 ms for the same work, so bf16 runs on the tensor cores.
//
// bf16: wg::flash_wgmma_kernel, persistent: one block per SM walks the
// (128 query rows, query head, batch row) tiles, causal tiles with the
// most keys first and in a zig-zag over the blocks, since the triangle is
// uneven. A block is two consumer warpgroups of 64 rows each and one
// producer warp.
// - Loads. The producer's one thread copies each tile's q once, into one
//   of three q buffers, and streams the 64-key K and V tiles into a ring
//   of three stages with TMA, in 128-byte swizzled shared memory (tensor
//   maps built on the host per call; cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the build needs no -lcuda). Rows past Sq
//   or Sk arrive as zeros. mbarriers count the bytes that arrived and the
//   consumers' releases; the next tile's loads overlap this tile's work.
// - S = Q K^T: wgmma m64n64k16, bf16 in, fp32 out, Q and K both K-major
//   from shared memory. 1/sqrt(D) (with log2 e, for exp2) scales the fp32
//   scores, folded into the fma that feeds exp2.
// - Masks only where a tile needs them (the diagonal, the window's edge,
//   the ragged Sk edge), as one uniform branch; tiles wholly above the
//   diagonal or outside the window are not loaded, or, for the one
//   warpgroup they miss, not computed. The online softmax runs on the
//   accumulator registers: a row's 64 scores live in one quad of 4
//   threads, so its max takes two shuffles; l stays a per-thread partial
//   until the end; a warp skips the rescale of O when its maxima did not
//   move.
// - O += P V: wgmma m64n(D)k16 with P from registers (the fp32 score
//   fragment rounded to bf16 is the A fragment, as in FlashAttention-3)
//   and V an MN-major B operand read through the transpose bit.
// - Overlap, as in FlashAttention-3: a warpgroup issues S of tile j and PV
//   of tile j-1 together and runs tile j's softmax while PV runs; the two
//   warpgroups take turns to issue (hardware barriers 3 and 4), so one's
//   softmax overlaps the other's products. No branch may merge while a
//   wgmma accumulator is in flight, and the warp index reaches the
//   compiler through a shuffle, so ptxas keeps the wgmma pipelined (it
//   reports C7515/C7520 otherwise).
// - Output: O / l in bf16 into the warpgroup's rows of its tile's q
//   buffer, in the swizzled layout, then one TMA store per 64 columns;
//   rows past Sq are not written. The buffer is handed back to the
//   producer a tile later, when the store has read it.
// Numerics: products of bf16 values are exact in fp32, so S differs from
// the TPU kernel's only in the order of summation. P is rounded to bf16
// before PV, where the TPU kernel keeps it fp32: about 2^-9 relative per
// weight, well inside the 2e-2 bf16 tolerance.
//
// fp32: simt::flash_fwd_kernel, the CUDA-core kernel of the first port,
// unchanged: the card-vs-CPU greedy tests need fp32 products (TF32 wgmma
// would round them). One block per (64-row q tile, query head, batch),
// 256 threads; thread (tr = tid / 16, tc = tid % 16) owns score rows
// 4tr..4tr+3 and columns tc + 16j and the accumulator entries of the same
// rows, so the rescale stays in registers; k tiles wholly above the
// diagonal or outside the window are skipped.
//
// In both, a query row whose every key is masked gives an unspecified
// output, as in the TPU kernel.
#include "common.cuh"
#include "sm90.cuh"

namespace simt {


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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int K,
                 int causal, int window, float scale) {
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
    if (lse && tc == 0)
      lse[((size_t)b * Sq + qi) * H + h] = m[i] + logf(fmaxf(l[i], 1e-30f));
    T* orow = o + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) rt::store_f(orow + tc + 16 * cc, acc[i][cc] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int K,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, K,
      causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace simt

namespace wg {

constexpr int BQ = 128;       // q rows per block (two warpgroups of 64)
constexpr int BK = 64;        // keys per tile
constexpr int NQB = 3;        // q buffers (each also stages its tile's O)
constexpr int NST = 3;        // K/V ring stages (>= 3: a consumer holds one
                              // stage for its pending PV while it waits for
                              // the next)
constexpr int NT = 288;       // 2 consumer warpgroups + 1 producer warp
constexpr int CHUNK = 64;     // bf16 columns per 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int Q = BQ * D * 2;      // one q tile: [D/64][128][64] bf16
  static constexpr int KV = BK * D * 2;     // one K or V stage: [D/64][64][64]
  static constexpr size_t bytes = NQB * Q + 2 * NST * KV + 1024;  // + align
};

// The n-th work tile: (q tile, query head, batch row), causal q tiles with
// the most keys first.
struct Tile {
  int q0, h, b, kt_begin, kt_end;
  __device__ Tile(int t, int nq, int B, int Sq, int Sk, int H, int causal,
                  int window) {
    const int per = H * B;
    const int r = t / per, rem = t % per;
    q0 = (causal ? nq - 1 - r : r) * BQ;
    h = rem % H;
    b = rem / H;
    kt_begin = 0;
    kt_end = (Sk + BK - 1) / BK;
    if (causal) {
      const int last_row = min(q0 + BQ, Sq) - 1;
      kt_end = min(kt_end, last_row / BK + 1);
      if (window) {
        const int first_key = q0 - window + 1;  // earliest key q0 may see
        if (first_key > 0) kt_begin = first_key / BK;
      }
    }
  }
};

// Persistent: one block per SM walks the tiles (tile_of)
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, int B, int Sq, int Sk, int H,
                   int K, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  static_assert(NST >= 3, "the pending PV holds a stage");
  constexpr int NC = D / CHUNK;         // 64-column chunks of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                   // NQB q buffers
  uint8_t* ks = qs + NQB * L::Q;
  uint8_t* vs = ks + NST * L::KV;
  __shared__ __align__(8) uint64_t q_full[NQB], q_empty[NQB], full[NST],
      empty[NST];

  const int nq = (Sq + BQ - 1) / BQ;
  const int n_tiles = nq * H * B;
  // The block's n-th tile: rounds of gridDim.x tiles, walked forwards in
  // even rounds and backwards in odd ones, so the blocks that take a
  // heavier tile in one round take a lighter one in the next.
  auto tile_of = [&](int n) {
    return n * gridDim.x +
           ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };
  const int G = H / K;
  // the warp index through a shuffle, so the compiler knows it (and all
  // that derives from it) is warp-uniform and keeps the wgmma pipelined
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NQB; ++i) {
      sm90::mbar_init(&q_full[i], 1);
      sm90::mbar_init(&q_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < NST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one thread keeps the q buffers and the K/V ring full
    if (lane == 0) {
      sm90::prefetch_tma_map(&tq);
      sm90::prefetch_tma_map(&tk);
      sm90::prefetch_tma_map(&tv);
      sm90::prefetch_tma_map(&to);
      int it = 0;
      for (int n = 0, t = tile_of(0); t < n_tiles; t = tile_of(++n)) {
        const Tile tl(t, nq, B, Sq, Sk, H, causal, window);
        const int qb = n % NQB, kh = tl.h / G;
        sm90::mbar_wait(&q_empty[qb], ((n / NQB) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&q_full[qb], L::Q);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_4d(qs + qb * L::Q + c * BQ * 128, &tq, &q_full[qb],
                            c * CHUNK, tl.h, tl.q0, tl.b);
        for (int kt = tl.kt_begin; kt < tl.kt_end; ++kt, ++it) {
          const int s = it % NST;
          sm90::mbar_wait(&empty[s], ((it / NST) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::KV);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            sm90::tma_load_4d(ks + s * L::KV + c * BK * 128, &tk, &full[s],
                              c * CHUNK, kh, kt * BK, tl.b);
            sm90::tma_load_4d(vs + s * L::KV + c * BK * 128, &tv, &full[s],
                              c * CHUNK, kh, kt * BK, tl.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi takes rows q0 + 64 wgi .. + 63 of a tile.
  // Tile j's softmax runs while tile j-1's PV is on the tensor cores.
  const int wgi = warp / 4;
  const int cq = 2 * (lane % 4);                  // first column in an 8-block
  if (wgi == 1) sm90::named_arrive(3, 256);       // warpgroup 0 goes first
  int it = 0;
  for (int n = 0, t = tile_of(0); t < n_tiles; t = tile_of(++n)) {
    const Tile tl(t, nq, B, Sq, Sk, H, causal, window);
    const int qb = n % NQB;
    const int row0 = tl.q0 + wgi * 64;            // first row of the warpgroup
    const int r_lo = row0 + (warp % 4) * 16 + lane / 4;
    const int rows[2] = {r_lo, r_lo + 8};
    float acc[D / 2];
    float sc[32];
    uint32_t pa[4][4];          // P of the pending tile, the A fragment of PV
    int pend = -1;              // ring stage whose V the pending P needs
    float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint8_t* qwg = qs + qb * L::Q + wgi * 64 * 128;   // this warpgroup's q rows

    // O += P V over the pending tile's 64 keys (2048 bytes of V rows per
    // step of 16), committed as one wgmma group
    auto issue_pv = [&](int st) {
      const uint8_t* vst = vs + st * L::KV;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            sm90::desc_sw128(vst + kk * 16 * 128, BK * 128, 1024);
        if constexpr (D == 128)
          sm90::wgmma_rs_m64n128<1>(acc, pa[kk], db);
        else
          sm90::wgmma_rs_m64n64<1>(acc, pa[kk], db);
      }
      sm90::wgmma_commit();
    };
    auto release = [&](int st) {
      if (lane == 0) sm90::mbar_arrive(&empty[st]);   // this warp is done
    };

    // S = Q K^T over D in steps of 16 (32 bytes within a swizzled row),
    // committed as one wgmma group
    auto issue_s = [&](int st) {
      const uint8_t* kst = ks + st * L::KV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        const uint64_t da =
            sm90::desc_sw128(qwg + (kk / 4) * BQ * 128 + off, 16, 1024);
        const uint64_t db =
            sm90::desc_sw128(kst + (kk / 4) * BK * 128 + off, 16, 1024);
        sm90::wgmma_ss_m64n64<0>(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
    };
    // Scale and mask S, update m and l, and turn S into P (fp32, in
    // place); returns nothing, leaves the rescale of acc in alpha.
    float alpha[2];
    auto softmax = [&](int k0) {
      const bool need_mask = k0 + BK > Sk ||
          (causal && (k0 + BK - 1 > row0 ||
                      (window && k0 <= row0 + 63 - window)));
      // Scores enter exp2 as fma(s, mul, -m). An unmasked tile keeps s
      // raw and folds the scale into that fma (mul = scale_log2). A tile
      // that needs masks (the diagonal, the window's edge, the ragged Sk
      // edge) scales first and fills with exactly -1e30 (mul = 1), so a
      // row masked so far gets exp2(0) = 1 per slot, as the oracle's
      // uniform softmax does.
      float mul = scale_log2;
      if (need_mask) {
        mul = 1.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int qi = rows[hf];
          const int hi = causal ? min(qi, Sk - 1) : Sk - 1;   // last key seen
          const int lo = causal && window ? qi - window : -1; // keys > lo
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kj = k0 + 8 * j + cq + e, i = 4 * j + 2 * hf + e;
              sc[i] = kj > hi || kj <= lo ? rt::kNegInf : sc[i] * scale_log2;
            }
        }
      }
      float mx[2][2], ls[2][2];   // two partial chains per row
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[hf][e] = sc[2 * hf + e];
          ls[hf][e] = 0.f;
        }
#pragma unroll
      for (int j = 1; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mx[hf][e] = fmaxf(mx[hf][e], sc[4 * j + 2 * hf + e]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float row_max =
            rt::group_max<4>(fmaxf(mx[hf][0], mx[hf][1])) * mul;
        const float m_new = fmaxf(m[hf], row_max);
        alpha[hf] = sm90::exp2_approx(m[hf] - m_new);
        m[hf] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hf + e;
            sc[i] = sm90::exp2_approx(fmaf(sc[i], mul, -m[hf]));
            ls[hf][e] += sc[i];
          }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        l[hf] = l[hf] * alpha[hf] + (ls[hf][0] + ls[hf][1]);
    };
    // acc *= alpha, and P as the A fragment of PV (keys 16kk..16kk+15 are
    // score blocks 2kk and 2kk+1)
    auto rescale_pack = [&]() {
      // once the row maxima settle, alpha is 1 in the whole warp
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    // Ping-pong: the two warpgroups take turns to issue their wgmma
    // (hardware barriers 3 and 4), so one's softmax overlaps the other's
    // products. Each does exactly one turn per k tile and one at the end
    // of a q tile, computed or not, so the turns stay matched.
    auto turn_begin = [&]() { sm90::named_sync(3 + wgi, 256); };
    auto turn_end = [&]() { sm90::named_arrive(3 + (wgi ^ 1), 256); };
    auto flush = [&]() {        // the pending tile's PV, alone, in a turn
      turn_begin();
      if (pend >= 0) {          // issue and wait on one path: no branch may
        sm90::fence_regs(acc);  // merge while acc is in flight
        sm90::wgmma_fence();
        issue_pv(pend);
        turn_end();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release(pend);
        pend = -1;
      } else {
        turn_end();
      }
    };

    sm90::mbar_wait(&q_full[qb], (n / NQB) & 1);
    for (int kt = tl.kt_begin; kt < tl.kt_end; ++kt, ++it) {
      const int s = it % NST;
      const int k0 = kt * BK;
      sm90::mbar_wait(&full[s], (it / NST) & 1);
      const bool skip = row0 >= Sq ||
          (causal && (k0 > row0 + 63 ||
                      (window && k0 + BK - 1 <= row0 - window)));
      if (skip) {
        flush();                 // so the ring never waits on this warpgroup
        release(s);
      } else if (pend < 0) {     // the first tile: nothing to overlap
        turn_begin();
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
        issue_s(s);
        turn_end();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        softmax(k0);
        rescale_pack();
        pend = s;
      } else {                   // S of this tile, then PV of the last one
        turn_begin();
        sm90::fence_regs(sc);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        issue_s(s);
        issue_pv(pend);
        turn_end();
        sm90::wgmma_wait<1>();   // S is done; PV may still run
        sm90::fence_regs(sc);
        softmax(k0);
        sm90::wgmma_wait<0>();   // PV has finished with acc and pa
        sm90::fence_regs(acc);
        release(pend);
        rescale_pack();
        pend = s;
      }
    }
    flush();

    // Epilogue: O / l in bf16 into this warpgroup's rows of the q buffer
    // (its wgmma reads of q are done), in the 128-byte swizzled layout the
    // tensor map expects, then one TMA store per 64-column chunk; rows
    // past Sq are not written. With `lse`, the first lane of each quad
    // (which holds the row's m, in log2 units, and now its whole l) also
    // writes lse = m ln 2 + log l for its row, if the row is below Sq.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lsum = fmaxf(rt::group_sum<4>(l[hf]), 1e-30f);
      const float inv = 1.f / lsum;
      if (lse && lane % 4 == 0 && rows[hf] < Sq)
        lse[((size_t)tl.b * Sq + rows[hf]) * H + tl.h] =
            m[hf] * kLn2 + logf(lsum);
      const int r = (warp % 4) * 16 + lane / 4 + 8 * hf;   // row in the region
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint8_t* dst = qwg + (j / 8) * BQ * 128 + r * 128 +
                       (((j % 8) ^ (r % 8)) * 16) + cq * 2;
        *reinterpret_cast<uint32_t*>(dst) = sm90::pack_bf16(
            acc[4 * j + 2 * hf] * inv, acc[4 * j + 2 * hf + 1] * inv);
      }
    }
    // The store reads the buffer behind our back; the buffer is handed
    // back one tile later, when the store is long done.
    sm90::fence_async_smem();
    sm90::named_sync(1 + wgi, 128);
    if (threadIdx.x % 128 == 0) {
      if (row0 < Sq) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          sm90::tma_store_4d(&to, qwg + c * BQ * 128, c * CHUNK, tl.h, row0,
                             tl.b);
      }
      sm90::bulk_commit();
      sm90::bulk_wait_read<1>();         // the last tile's store has read
      if (n > 0) sm90::mbar_arrive(&q_empty[(n - 1) % NQB]);
    }
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int K,
                   int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  using sm90::encode_bshd_map;
  if (!encode_bshd_map(&tq, q, B, Sq, H, D, BQ) ||
      !encode_bshd_map(&tk, k, B, Sk, K, D, BK) ||
      !encode_bshd_map(&tv, v, B, Sk, K, D, BK) ||
      !encode_bshd_map(&to, o, B, Sq, H, D, 64))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = (Sq + BQ - 1) / BQ * H * B;
  flash_wgmma_kernel<D><<<min(sms, n_tiles), NT, smem, stream>>>(
      tq, tk, tv, to, lse, B, Sq, Sk, H, K, causal,
      window, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace wg

// q [B,Sq,H,D], k/v [B,Sk,K,D], o [B,Sq,H,D], all contiguous, one dtype:
// bf16 on the tensor cores (wg), fp32 on the CUDA cores (simt). lse, when
// not null, is [B,Sq,H] fp32: the log-normaliser of each row's softmax
// (the residual of the backward, flash.py:88).
extern "C" int rt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse_ptr,
                                      int B, int Sq, int Sk, int H, int K,
                                      int D, int causal, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kBFloat16) {
    if (D == 64) return (int)wg::launch<64>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, s);
    if (D == 128) return (int)wg::launch<128>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, s);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) return (int)simt::launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, s);
    if (D == 128) return (int)simt::launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

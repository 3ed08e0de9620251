// Mamba2 SSD chunk scan for Hopper (B5).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan ->
// pl.pallas_call, body _ssd_kernel): one program per (batch, head), the
// chunks taken in order with an fp32 [P, N] state carried across them.
// Within a chunk of l steps, with a_cum = cumsum(a):
//   L[i,j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
//   y      = ((C B^T) o L) x + diag(exp(a_cum)) C state^T
//   state <- exp(a_cum[l-1]) state + ((B o exp(a_cum[l-1] - a_cum))^T x)^T
// from a zero initial state; y and the final state are written in x's
// dtype. b and c are read in place with a row stride of their own (the
// Mamba2 block passes column slices of its xbc tensor), x in its
// [B,S,H,P] layout (the TPU wrapper transposes it to [B,H,nc,l,P], a copy).
//
// Bound on the H100 at the serving path's shapes (x [8,2048,32,64] bf16,
// a [8,2048,32] fp32, b/c [8,2048,128] bf16, chunk 256): it must move
// 149 MB (x, a, b, c read once, y and the state written once), 44.4 us at
// 3.35 TB/s, and do 26.3 GFLOP (the causal half of C B^T once per batch
// and chunk, the causal product with x, y_off and the state update per
// head), 27 us at the bf16 tensor-core rate: the bytes bound it, and the
// products on the CUDA cores (67 TFLOP/s) would take 0.4 ms at the least.
//
// bf16 with P = 64, N 64 or 128, chunk a multiple of 64 (up to 512):
// wg::ssd_wgmma_kernel, the three products on the tensor cores (wgmma).
// One block of one warpgroup (128 threads) per (head, batch); at the
// path's shape 256 blocks, two resident on each of the 132 SMs (109,568
// bytes of shared memory each at N 128), so all run in one wave. Two
// blocks of four warps put two warps on each SM sub-partition, which
// leaves a thread up to 255 registers (it uses 184 at N 128): the fp32
// state (64 a thread), y (32), a score tile (32) and its bf16 copy (16)
// are live together. (A fifth, producer warp
// would put three warps on a sub-partition and cap a thread at 168
// registers: ptxas spilled.)
// - Loads. Thread 0 feeds the C tiles and the (B, x) tile pairs, 64 rows
//   each, by TMA into two two-stage rings of 128-byte swizzled shared
//   memory, in the order the warpgroup takes them; it refills a stage two
//   loads ahead as soon as a barrier shows every warp done with it, and
//   mbarriers count the bytes that arrived. b and c are the same for all
//   heads: 31 of every 32 tile loads hit L2. a is loaded a chunk ahead into
//   registers, and a_cum (scaled by log2 e, for exp2) is one warp's scan.
// - Per chunk and 64-row query tile i: y = exp(a_cum) o (C_i state^T), a
//   wgmma m64n64 (K = N) with the state's bf16 operand copy [P][N] as the
//   K-major B (skipped for the first chunk, whose state is 0); then per key
//   tile j <= i: S = C_i B_j^T (wgmma m64n64, K = N, both K-major), o L in
//   registers (exp only of a_cum[i] - a_cum[j], 0 above the diagonal),
//   rounded to bf16 as the A fragment of y += (S o L) x_j (wgmma m64n64
//   from registers, x the MN-major B, as B2 reads V).
// - The state update rides on the chunk's last query tile, which walks
//   every key tile: the fp32 state, a wgmma m64nN accumulator held in
//   registers across all chunks, is scaled by exp(a_last) first; per key
//   tile, x_j o exp(a_last - a_cum[j]) is written to a bf16 scratch tile
//   (the decay multiplies the K index, so it cannot stay on the
//   accumulator) and state += scratch^T B_j, both operands MN-major (the
//   transpose bits). After the chunk the warpgroup writes the state's bf16
//   copy for the next chunk's y_off.
// - y leaves through the scratch tile as 16-byte rows.
// Numerics: S is exact up to the order of summation (products of bf16
// values in fp32). S o L, the state's operand copy and x o decay are
// rounded to bf16 before their products, where the TPU kernel keeps them
// fp32; the carried state never leaves fp32, so the roundings do not
// compound across chunks (ROADMAP §C).
//
// fp32, and the small widths of the smoke configs: simt::ssd_scan_kernel,
// the CUDA-core kernel of the first port. One block of 256 threads per
// (head, batch), the fp32 state in shared memory as [P][N+1]; per chunk
// a_cum by a warp scan, then for each 64-row query tile y_off from the
// state before the chunk, the score tiles C B^T (exp only where j <= i)
// and their product with x, and after every query tile the state update.
// Thread (tr = tid / 16, tc = tid % 16) owns rows 4tr..4tr+3 and columns
// tc + 16k of each [64 x 64] output tile; the state update gives each
// thread a 4 x 8 register tile of [P x N]. P <= 64 and N <= 128; any
// chunk length (the last tile of a chunk may be partial).
#include "common.cuh"
#include "sm90.cuh"

namespace {
namespace simt {

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
                int P, int N, int chunk, int ldbc) {
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
  const T_* bb = b + (size_t)bi * S * ldbc;   // b/c rows ldbc apart
  const T_* cb = c + (size_t)bi * S * ldbc;

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
      load_tile(cs, cb + (size_t)(c0 + i0) * ldbc, ldbc, qrows, N, nullptr);
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
        load_tile(bs, bb + (size_t)(c0 + j0) * ldbc, ldbc, krows, N, nullptr);
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
      load_tile(bs, bb + (size_t)(c0 + j0) * ldbc, ldbc, krows, N, ss);
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
                   int P, int N, int chunk, int ldbc, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T_, A_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T_, A_><<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const T_*>(x), static_cast<const A_*>(a),
      static_cast<const T_*>(b), static_cast<const T_*>(c),
      static_cast<T_*>(y), static_cast<T_*>(fin), S, H, P, N, chunk, ldbc);
  return cudaGetLastError();
}

}  // namespace simt

namespace wg {

constexpr int T = 64;            // rows of a query / key tile
constexpr int P = 64;            // head_dim this route takes
constexpr int NT = 128;          // one warpgroup
constexpr int MAX_CHUNK = 512;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, every tile 1024-byte aligned for the 128-byte swizzle; a
// tile of W bf16 columns is W/64 regions of [64 rows][128 bytes].
template <int N>
struct Layout {
  static constexpr int C = T * N * 2;       // one C tile
  static constexpr int BT = T * N * 2;      // one B tile
  static constexpr int X = T * P * 2;       // one x tile
  static constexpr int ST = P * N * 2;      // the state's bf16 operand copy
  static constexpr int c_off = 0;                    // 2 C stages
  static constexpr int b_off = c_off + 2 * C;        // 2 B stages
  static constexpr int x_off = b_off + 2 * BT;       // 2 x stages
  static constexpr int st_off = x_off + 2 * X;
  static constexpr int xd_off = st_off + ST;         // decay o x; stages y
  static constexpr int acum_off = xd_off + X;        // [MAX_CHUNK] fp32
  static constexpr size_t bytes = acum_off + MAX_CHUNK * 4 + 1024;
};

// The accumulator fragment of a [64 x W] fp32 tile (W/2 values a thread)
// as bf16 into a K-major [64][W] tile of 128-byte swizzled regions. The
// swizzle XORs a row's 16-byte chunk index with the row's low 3 bits, and
// rows r_lo and r_lo + 8 share those, so chunk j of either row lies at one
// address XOR 16 j: the addresses cost no registers between calls.
template <int W>
__device__ __forceinline__ void store_frag(uint8_t* dst, const float* acc,
                                           int r_lo, int cq) {
  const uint32_t p =
      sm90::smem_u32(dst) + r_lo * 128 + (r_lo % 8) * 16 + cq * 2;
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      sm90::st_shared_b32(
          (p + (j / 8) * T * 128 + hf * 8 * 128) ^ ((j % 8) * 16),
          sm90::pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]));
}

// K-major operand of 64 rows x K: the descriptor of k16 step kk (32 bytes
// within a swizzled row; a new region every 4 steps)
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * T * 128 + (kk % 4) * 32, 16, 1024);
}
// MN-major operand, K = 64 rows of the tile: k16 step kk is 16 rows on;
// the next 64 columns are the next region
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * 128, T * 128, 1024);
}

// The (B, x) tile loads, in the order the chunk takes them (for each query
// tile qt the key tiles 0..qt): the first sequence row of load m.
__device__ __forceinline__ int bx_row(int m, int nt, int chunk) {
  const int per = nt * (nt + 1) / 2;
  int r = m % per, qt = 0;
  while (r > qt) r -= ++qt;
  return m / per * chunk + r * T;
}

template <int N, typename A_>
__global__ void __launch_bounds__(NT, 2)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const A_* __restrict__ a, __nv_bfloat16* __restrict__ y,
                 __nv_bfloat16* __restrict__ fin, int S, int H, int chunk) {
  using L = Layout<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* const ac = reinterpret_cast<float*>(smem + L::acum_off);
  uint8_t* const sts = smem + L::st_off;
  uint8_t* const xd = smem + L::xd_off;
  __shared__ __align__(8) uint64_t c_full[2], bx_full[2];

  const int h = blockIdx.x, bi = blockIdx.y;
  const int nc = S / chunk, nt = chunk / T;
  const int n_cload = nc * nt, n_bxload = nc * (nt * (nt + 1) / 2);
  const int tid = threadIdx.x;
  // the warp index through a shuffle: warp-uniform to the compiler
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  // Thread 0 issues every tile load by TMA, two ahead in each ring: the C
  // tile of query tile n % nt of chunk n / nt, and the (B, x) pairs.
  auto load_c = [&](int n) {
    if (n >= n_cload) return;
    const int cs = n & 1;
    sm90::mbar_arrive_expect_tx(&c_full[cs], L::C);
#pragma unroll
    for (int r = 0; r < N / 64; ++r)
      sm90::tma_load_3d(smem + L::c_off + cs * L::C + r * T * 128, &tc,
                        &c_full[cs], r * 64, n / nt * chunk + n % nt * T, bi);
  };
  auto load_bx = [&](int m) {
    if (m >= n_bxload) return;
    const int s = m & 1, row = bx_row(m, nt, chunk);
    sm90::mbar_arrive_expect_tx(&bx_full[s], L::BT + L::X);
#pragma unroll
    for (int r = 0; r < N / 64; ++r)
      sm90::tma_load_3d(smem + L::b_off + s * L::BT + r * T * 128, &tb,
                        &bx_full[s], r * 64, row, bi);
    sm90::tma_load_4d(smem + L::x_off + s * L::X, &tx, &bx_full[s], 0, h,
                      row, bi);
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&c_full[i], 1);
      sm90::mbar_init(&bx_full[i], 1);
    }
    sm90::fence_barrier_init();
    sm90::prefetch_tma_map(&tx);
    sm90::prefetch_tma_map(&tb);
    sm90::prefetch_tma_map(&tc);
    load_c(0);
    load_c(1);
    load_bx(0);
    load_bx(1);
  }
  // a of the next chunk, loaded a chunk ahead: element k * 128 + tid
  const A_* ab = a + (size_t)bi * S * H + h;
  float an[MAX_CHUNK / NT];
  auto load_a = [&](int ci) {
#pragma unroll
    for (int k = 0; k < MAX_CHUNK / NT; ++k) {
      const int e = k * NT + tid;
      an[k] = ci < nc && e < chunk
          ? rt::to_f(ab[(size_t)(ci * chunk + e) * H]) : 0.f;
    }
  };
  load_a(0);
  __syncthreads();

  // Thread (warp, lane) holds rows r_lo and r_lo + 8 of each 64-row
  // accumulator, columns 8j + cq and 8j + cq + 1.
  const int cq = 2 * (lane % 4);
  const int r_lo = warp * 16 + lane / 4;
  const size_t yld = (size_t)H * P;              // y row stride
  __nv_bfloat16* const yb = y + (size_t)bi * S * yld + (size_t)h * P;
  float st[N / 2];    // the state [P][N], fp32, carried across chunks
  float acc[32];      // y of the query tile [64][P]
  float sc[32];       // a score tile C B^T [64][64]
  uint32_t pa[4][4];  // (C B^T) o L in bf16: the A fragment of its product
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = 0.f;
  int n_c = 0, n_bx = 0;

  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * chunk;
    // a_cum of the chunk, scaled by log2 e for exp2: a warp scan (every
    // reader of the last chunk's a_cum passed a barrier since)
#pragma unroll
    for (int k = 0; k < MAX_CHUNK / NT; ++k)
      if (k * NT + tid < chunk) ac[k * NT + tid] = an[k];
    load_a(ci + 1);
    sm90::named_sync(1, NT);
    if (warp == 0) {
      float carry = 0.f;
      for (int base = 0; base < chunk; base += 32) {
        float v = ac[base + lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        ac[base + lane] = v * kLog2e;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    sm90::named_sync(1, NT);
    const float alast = ac[chunk - 1];
    for (int qt = 0; qt < nt; ++qt, ++n_c) {
      const int cs = n_c & 1, i0 = qt * T;
      const uint8_t* ct = smem + L::c_off + cs * L::C;
      const float ai[2] = {ac[i0 + r_lo], ac[i0 + r_lo + 8]};
      sm90::mbar_wait(&c_full[cs], (n_c >> 1) & 1);
      // y_off = diag(exp(a_cum)) C state^T, from the state before this
      // chunk's update (its bf16 copy); nothing before the first chunk
      if (ci > 0) {
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          sm90::wgmma_ss_m64n64<0>(acc, desc_k(ct, kk), desc_k(sts, kk),
                                   kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        const float d0 = sm90::exp2_approx(ai[0]);
        const float d1 = sm90::exp2_approx(ai[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= ((i / 2) % 2) ? d1 : d0;
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      }
      // the last query tile of the chunk walks every key tile: the state
      // update rides on it
      const bool last = qt == nt - 1;
      for (int kt = 0; kt <= qt; ++kt, ++n_bx) {
        const int s = n_bx & 1, j0 = kt * T;
        const uint8_t* bt = smem + L::b_off + s * L::BT;
        const uint8_t* xt = smem + L::x_off + s * L::X;
        sm90::mbar_wait(&bx_full[s], (n_bx >> 1) & 1);
        // S = C B^T, K = N, both K-major
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          sm90::wgmma_ss_m64n64<0>(sc, desc_k(ct, kk), desc_k(bt, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        // o L: exp only of a_cum[i] - a_cum[j], 0 above the diagonal
        const bool diag = kt == qt;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + cq + e;
            const float aj = ac[j0 + col];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = 4 * j + 2 * hf + e;
              const float l = sm90::exp2_approx(ai[hf] - aj);
              sc[i] = diag && col > r_lo + 8 * hf ? 0.f : sc[i] * l;
            }
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r],
                                        sc[8 * kk + 2 * r + 1]);
        if (last) {
          if (kt == 0) {
            const float dl = sm90::exp2_approx(alast);
#pragma unroll
            for (int i = 0; i < N / 2; ++i) st[i] *= dl;
          }
          // xd = x o exp(a_last - a_cum[j]), row by row (16 bytes at a time;
          // the swizzle keeps rows in place)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int idx = tid + NT * q, r = idx / 8;
            const float d = sm90::exp2_approx(alast - ac[j0 + r]);
            uint4 u = *reinterpret_cast<const uint4*>(xt + idx * 16);
            __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float2 f = __bfloat1622float2(p2[t]);
              p2[t] = __floats2bfloat162_rn(f.x * d, f.y * d);
            }
            *reinterpret_cast<uint4*>(xd + idx * 16) = u;
          }
          sm90::fence_async_smem();
          sm90::named_sync(1, NT);
          // y += (S o L) x and state += xd^T B: both operands of the
          // latter MN-major
          sm90::fence_regs(acc);
          sm90::fence_regs(st);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_rs_m64n64<1>(acc, pa[kk], desc_mn(xt, kk));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (N == 128)
              sm90::wgmma_ss_m64n128<1, 1>(st, desc_mn(xd, kk),
                                           desc_mn(bt, kk), 1);
            else
              sm90::wgmma_ss_m64n64<1, 1>(st, desc_mn(xd, kk),
                                          desc_mn(bt, kk), 1);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          sm90::fence_regs(st);
        } else {
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_rs_m64n64<1>(acc, pa[kk], desc_mn(xt, kk));
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
        }
        // every warp is done with the stage: refill it, two loads ahead
        sm90::named_sync(1, NT);
        if (tid == 0) load_bx(n_bx + 2);
      }
      // y tile: bf16 through xd (its readers are done), then 16-byte rows
      store_frag<P>(xd, acc, r_lo, cq);
      sm90::named_sync(1, NT);
      if (tid == 0) load_c(n_c + 2);     // every S of this tile has read C
      {
        // rows tid / 8 + 16 q, chunk tid % 8: one swizzle for all four
        const int r = tid / 8, c16 = tid % 8;
        const uint32_t src = sm90::smem_u32(xd) + r * 128 +
                             ((c16 ^ (r % 8)) * 16);
        __nv_bfloat16* dst = yb + (size_t)(c0 + i0 + r) * yld + c16 * 8;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<uint4*>(dst + 16 * q * yld) =
              sm90::ld_shared_v4(src + q * 16 * 128);
      }
      sm90::named_sync(1, NT);   // xd and a_cum are written again after this
    }
    if (ci + 1 < nc) {
      // the bf16 operand copy of the state for the next chunk's y_off;
      // every y_off of this chunk has read the old one
      store_frag<N>(sts, st, r_lo, cq);
      sm90::fence_async_smem();
    }
  }
  __nv_bfloat16* fb = fin + ((size_t)bi * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(fb + (r_lo + 8 * hf) * N + 8 * j + cq) =
          sm90::pack_bf16(st[4 * j + 2 * hf], st[4 * j + 2 * hf + 1]);
}

template <int N, typename A_>
cudaError_t launch(const void* x, const void* a, const void* b,
                   const void* c, void* y, void* fin, int B, int S, int H,
                   int chunk, int ldbc, cudaStream_t stream) {
  // x [B,S,H,P]: boxes of 64 rows of one head; b/c [B,S,N] with rows ldbc
  // apart: boxes of 64 rows x 64 columns
  const cuuint64_t xdims[4] = {P, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                              (cuuint64_t)S * H * P * 2};
  const cuuint32_t xbox[4] = {64, 1, T, 1};
  const cuuint64_t bdims[3] = {N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t bstr[2] = {(cuuint64_t)ldbc * 2, (cuuint64_t)S * ldbc * 2};
  const cuuint32_t bbox[3] = {64, T, 1};
  CUtensorMap tx, tb, tc;
  if (!sm90::encode_bf16_map(&tx, x, 4, xdims, xstr, xbox) ||
      !sm90::encode_bf16_map(&tb, b, 3, bdims, bstr, bbox) ||
      !sm90::encode_bf16_map(&tc, c, 3, bdims, bstr, bbox))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Layout<N>::bytes;
  auto kernel = ssd_wgmma_kernel<N, A_>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)   // two blocks an SM: all of the shared memory
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), NT, smem, stream>>>(
      tx, tb, tc, static_cast<const A_*>(a),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(fin), S, H,
      chunk);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// x [B,S,H,P] and a [B,S,H] contiguous; b/c [B,S,N] with rows ldbc >= N
// elements apart (column slices of one wider tensor, read in place); y
// [B,S,H,P] and fin [B,H,P,N] of x's dtype. x, b, c share x_dtype; a is
// fp32 or x's. route 1 is the tensor-core kernel (bf16, P 64, N 64 or 128,
// chunk a multiple of 64 up to 512, 16-byte aligned rows), route 0 the
// CUDA-core kernel; the wrapper picks it (ssd_scan.py::route).
extern "C" int rt_ssd_scan(const void* x, const void* a, const void* b,
                           const void* c, void* y, void* fin, int B, int S,
                           int H, int P, int N, int chunk, int ldbc,
                           int route, int x_dtype, int a_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || S % chunk || P <= 0 ||
      P > simt::MAX_P || N <= 0 || N > simt::MAX_N || ldbc < N)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bool xb = x_dtype == rt::kBFloat16, xf = x_dtype == rt::kFloat32;
  const bool ab = a_dtype == rt::kBFloat16, af = a_dtype == rt::kFloat32;
  if (route == 1) {
    if (!xb || P != wg::P || chunk % wg::T || chunk > wg::MAX_CHUNK ||
        ldbc % 8 || !(af || ab))
      return (int)cudaErrorInvalidValue;
    if (N == 128)
      return (int)(af ? wg::launch<128, float>(x, a, b, c, y, fin, B, S, H, chunk, ldbc, s)
                      : wg::launch<128, bf16>(x, a, b, c, y, fin, B, S, H, chunk, ldbc, s));
    if (N == 64)
      return (int)(af ? wg::launch<64, float>(x, a, b, c, y, fin, B, S, H, chunk, ldbc, s)
                      : wg::launch<64, bf16>(x, a, b, c, y, fin, B, S, H, chunk, ldbc, s));
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (xb && af)
    return (int)simt::launch<bf16, float>(x, a, b, c, y, fin, B, S, H, P, N, chunk, ldbc, s);
  if (xb && ab)
    return (int)simt::launch<bf16, bf16>(x, a, b, c, y, fin, B, S, H, P, N, chunk, ldbc, s);
  if (xf && af)
    return (int)simt::launch<float, float>(x, a, b, c, y, fin, B, S, H, P, N, chunk, ldbc, s);
  return (int)cudaErrorInvalidValue;
}

// Paged flash-decode over a block-table-indexed KV pool, for Hopper: a
// block per (split of the pages, KV head, tile of 8 rows), so the rows of
// a tile that name one page (a GRPO group's shared prompt) read it once.
//
// Replaces the Pallas TPU kernel repro/paged/attention.py
// (paged_decode_attention -> pl.pallas_call, body _paged_decode_kernel):
// one query token per row attends over the row's pages of the pool
// [P,ps,K,D], found through its block table [B,nb] (-1 = unallocated).
// Logical token t lives at pool[bt[b, t / ps], t % ps]; it is valid iff
// t <= position[b] and bt[b, t / ps] >= 0. A -1 entry aliases page 0 and
// is masked. Masked scores are -1e30, l is clamped at 1e-30, and the
// softmax is fp32; the TPU kernel takes both products in fp32 after
// upcasting k and v, and here they are exact or near it (below).
// The pool is read in place, [P,ps,K,D] with a slot stride of K*D (the
// TPU wrapper transposes both pools on every call). Offsets are 64-bit.
//
// Bound on the H100 at the paged GRPO rollout's last decode step (q
// [64,24,128], pools [577,16,8,128] bf16, 8 prompts of 504 tokens forked
// 8 ways, position 566): the rows name 568 distinct pages, 36.3 MiB of
// K/V, 11.3 us at 3.35 TB/s. Counted row by row it is 144.8 MiB: a
// kernel with one row a block pays for the group's shared prompt pages
// eight times, through L2. The 0.45 GFLOP are ~0.4 FLOP a byte, far below
// the ~295 at which the tensor cores would matter for their rate; but on
// the CUDA cores the 226 M FMAs (~7 us at the fp32 rate) come with the
// bf16 unpacking, shared-memory reads and shuffles, and their issue cost,
// not the bytes, set the pace. So bf16 takes its products to the tensor
// cores for their instruction count (below).
//
// Design. Grid (splits, K, tiles): a block takes R = 8 consecutive rows
// (a GRPO group), all G query heads of one KV head, and every splits-th
// page: split s walks pages s, s + splits, s + 2 splits, ... so the pages
// a group does not share (its rows' last ones) spread over all splits.
// paged_attention.py::plan picks splits from the shapes alone. 256
// threads, one warp per row.
// - Setup, once: each row's walk end (below) and the split's [R, n_pg]
//   sub-table go to shared memory, and the queries to registers as mma
//   fragments (bf16) or to shared memory pre-scaled by log2(e)/sqrt(D)
//   (fp32). Then the copy list: at each page of the split, tile k
//   is the k-th distinct page (-1 read as page 0) among the rows still
//   walking there, and srank[jj][r] names the tile row r reads.
// - The walk is in units of up to U = 16 slots (a page of 16; larger
//   pages are cut into units). Tiles (the K and the V head tiles of one
//   unit of one page, 16 slots x D each, with a slot stride of K*D in the
//   pool) are copied in list order into a ring of NS slots (~96 KiB) by
//   cp.async, 16 bytes a thread, a 16-byte chunk c of slot s stored at
//   chunk c ^ (s & 7) so the score loop's reads are conflict-free. Every
//   thread's copies of tile t complete phase t / NS of the ring slot's
//   mbarrier (cp.async.mbarrier.arrive). So a shared page takes one ring
//   slot and the copies run up to NS tiles ahead of the arithmetic. The
//   block refills the ring, behind a barrier, only when fewer than NS / 2
//   tiles are queued ahead, so between refills its warps run apart.
// - A unit, for each row (a warp): the scores of its G heads over the 16
//   slots, the row's online softmax (exp2, in fp32), p to shared memory,
//   then p V into the accumulators. In bf16 both products run on the
//   tensor cores, mma.m16n8k16 from ldmatrix fragments: QK^T with bf16 q
//   (exact products, fp32 sums) and PV with p as bf16 hi + lo parts
//   (exact products of a p kept to 16 bits). On the CUDA cores the bf16
//   unpacking, shared-memory reads and shuffles around each unit's FMAs
//   set this kernel's pace (PERF.md). In fp32 both stay on the CUDA
//   cores: two lanes a slot for the scores, each lane D/32 dims of the G
//   accumulators for PV.
// - With more than one split, the block writes its unnormalised partials
//   (m and l per head, acc [G, D], fp32) to scratch that the wrapper
//   allocates, and paged_merge_kernel (one block per (query head, row))
//   rescales and sums them; it is launched as a programmatic dependent of
//   the split kernel, as B3's combine is. With one split the block
//   normalises and writes the output itself.
//
// Walk end: a row with position >= 0 and an allocated page at or before
// the one holding position stops after that page: every later slot is
// masked, and a masked score adds exp(-1e30 - m) = 0 once m is a real
// score. A row with no valid slot (position -1, or only holes up to it)
// walks all nb pages, because there the -1e30 fill makes the result the
// uniform mean of every gathered V row, as in the reference. A split that
// holds none of a row's pages leaves its partial at m = -inf, l = 0,
// which the merge weighs exp2(-inf) = 0; split 0 holds page 0 of every
// row, so the merge's max is finite.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int R = NT / 32;     // rows per tile, one warp each
constexpr int U = 16;          // slots per unit
constexpr int MAX_SPAN = 32;   // pages per split (plan keeps to it)
constexpr int MAXG = 8;        // most query heads per KV head
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float minus_inf() {
  return -__int_as_float(0x7f800000);
}

// N values of T at p (4, 8 or 16 bytes) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_f(const unsigned char* p, float* x) {
  constexpr int W = N * (int)sizeof(T) / 4;
  uint32_t w[W];
  if constexpr (W == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 2) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      x[i] = __uint_as_float(w[i]);
    }
  }
}

// 16 bytes from src, or 16 zero bytes (nothing read) where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// an arrival on `bar` once all of this thread's cp.async so far have
// landed (the barrier counts NT arrivals a phase)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   sm90::smem_u32(bar))
               : "memory");
}

// dynamic shared memory of the split kernel, in this order
template <typename T, int D, int G>
struct Smem {
  // a ring slot holds the K and the V head tiles of one unit of a page:
  // 96 KiB of slots, and at least R (a unit whose rows all differ)
  static constexpr size_t slot = 2 * (size_t)U * D * sizeof(T);
  static constexpr int nslots =
      96 * 1024 / slot > R ? (int)(96 * 1024 / slot) : R;
  static constexpr size_t ring = nslots * slot;
  static constexpr size_t bars = nslots * sizeof(uint64_t);
  // fp32 queries for the CUDA-core scores (bf16 keeps them in registers)
  static constexpr size_t q =
      sizeof(T) == 4 ? (size_t)R * G * D * sizeof(float) : 0;
  static constexpr size_t p = (size_t)R * G * U * sizeof(float);
  static constexpr size_t table = (size_t)R * MAX_SPAN * sizeof(int);
  static constexpr size_t pages = (size_t)R * MAX_SPAN * sizeof(int);
  static constexpr size_t first = (MAX_SPAN + 1) * sizeof(int);
  static constexpr size_t rows = 2 * R * sizeof(int);
  static constexpr size_t rank = (size_t)MAX_SPAN * R;
  static constexpr size_t total =
      ring + bars + q + p + table + pages + first + rows + rank;
  // blocks an SM: two where their shared memory fits (each block also
  // takes 1 KiB of the SM's 228 KiB) and G <= 6; else one, whose thread
  // may then hold 255 registers (at 128, G = 7 and 8 spill)
  static constexpr int min_blocks =
      2 * (total + 1024) <= 228 * 1024 && G <= 6 ? 2 : 1;
};

// CUDA cores (fp32 pools): acc[g][:] += sum over the unit's slots of
// p[g][slot] * V[slot][this lane's DPL dims] (a slot past the page has
// p = 0 and a zero-filled V row)
template <typename T, int D, int G>
__device__ __forceinline__ void add_pv(float (&acc)[G][D / 32],
                                       const float* prow,
                                       const unsigned char* vt, int lane) {
  constexpr int DPL = D / 32;
  constexpr int ROW_BYTES = D * (int)sizeof(T);
  const int byte = lane * DPL * (int)sizeof(T);
#pragma unroll
  for (int s4 = 0; s4 < U; s4 += 4) {
    float4 pp[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      pp[g] = *reinterpret_cast<const float4*>(prow + g * U + s4);
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int sl = s4 + k4;
      float vx[DPL];
      load_f<T, DPL>(
          vt + sl * ROW_BYTES + ((byte / 16) ^ (sl & 7)) * 16 + byte % 16,
          vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = k4 == 0 ? pp[g].x : k4 == 1 ? pp[g].y
                       : k4 == 2 ? pp[g].z : pp[g].w;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[g][e] = fmaf(pg, vx[e], acc[g][e]);
      }
    }
  }
}

// The scores of one unit for the G heads of a row and the row's online
// softmax, in the log2 domain: the running max m and sum l (the same in
// every lane) are updated, alpha = exp2(m_old - m_new) is returned for the
// accumulators, and p [G][U] goes to prow. Slots below nvalid are valid;
// the rest below cnt are masked (-1e30); the others are not there (-inf,
// weight 0).

// CUDA cores (fp32 pools): two lanes a slot, each half of the dims,
// against the pre-scaled fp32 q in shared memory (broadcast reads)
template <typename T, int D, int G>
__device__ __forceinline__ void softmax_simt(const unsigned char* tile,
                                             const float* qrow, float* prow,
                                             int lane, int cnt, int nvalid,
                                             float (&m)[G], float (&l)[G],
                                             float (&alpha)[G]) {
  constexpr int CPR = D * (int)sizeof(T) / 16;
  constexpr int E = 16 / (int)sizeof(T);
  const int s = lane % U, hf = lane / U;
  float dot[G];
#pragma unroll
  for (int g = 0; g < G; ++g) dot[g] = 0.f;
  const unsigned char* krow = tile + s * D * (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < CPR / 2; ++c) {
    const int ch = hf * (CPR / 2) + c;
    float kx[E];
    load_f<T, E>(krow + (ch ^ (s & 7)) * 16, kx);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4* qv =
          reinterpret_cast<const float4*>(qrow + g * D + ch * E);
#pragma unroll
      for (int e4 = 0; e4 < E / 4; ++e4) {
        const float4 qq = qv[e4];
        dot[g] = fmaf(qq.x, kx[4 * e4], dot[g]);
        dot[g] = fmaf(qq.y, kx[4 * e4 + 1], dot[g]);
        dot[g] = fmaf(qq.z, kx[4 * e4 + 2], dot[g]);
        dot[g] = fmaf(qq.w, kx[4 * e4 + 3], dot[g]);
      }
    }
  }
  float ps_[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float sc = dot[g] + __shfl_xor_sync(0xffffffffu, dot[g], U);
    sc = s < nvalid ? sc : (s < cnt ? rt::kNegInf : minus_inf());
    const float m_new = fmaxf(m[g], rt::group_max<U>(sc));
    alpha[g] = exp2f(m[g] - m_new);
    const float p = exp2f(sc - m_new);
    l[g] = fmaf(l[g], alpha[g], rt::group_sum<U>(p));
    m[g] = m_new;
    ps_[g] = p;
  }
  __syncwarp();                // the last unit's PV is done with prow
  if (hf == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) prow[g * U + s] = ps_[g];
  __syncwarp();
}

// Tensor cores (bf16 pools): S^T [16 slots, 8 heads] = K q^T by
// mma.m16n8k16 (bf16 in, fp32 sums: a product of two bf16 values is
// exact in fp32, so only the order of the sums differs from fp32 FMAs),
// K's A fragments by ldmatrix from the swizzled tile, q's B fragments in
// registers; the scale (1/sqrt(D) log2 e) applied to the sums. Lane holds
// slots lane/4 and lane/4 + 8 of heads 2 (lane % 4) and 2 (lane % 4) + 1.
template <int D, int G>
__device__ __forceinline__ void softmax_mma(const unsigned char* tile,
                                            const uint32_t (&qf)[D / 16][2],
                                            float* prow, int lane, int cnt,
                                            int nvalid, float scale,
                                            float (&m)[G], float (&l)[G],
                                            float (&alpha)[G]) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0-7 of the k-step,
  // lanes 16-31 the same rows at k 8-15 (fragments a0..a3 in mma order)
  const uint32_t row_addr = sm90::smem_u32(tile) + (lane & 15) * D * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ch = (2 * kk + (lane >> 4)) ^ (lane & 7);
    uint32_t a0, a1, a2, a3;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
        : "r"(row_addr + ch * 16));
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(qf[kk][0]),
          "r"(qf[kk][1]));
  }
  const int s0 = lane >> 2, s1 = s0 + 8, h0 = 2 * (lane & 3);
  auto masked = [&](float x, int sl) {
    return sl < nvalid ? x * scale : (sl < cnt ? rt::kNegInf : minus_inf());
  };
  // v[slot][head]: (s0, h0), (s0, h0 + 1), (s1, h0), (s1, h0 + 1)
  const float v00 = masked(c[0], s0), v01 = masked(c[1], s0);
  const float v10 = masked(c[2], s1), v11 = masked(c[3], s1);
  float mx0 = fmaxf(v00, v10), mx1 = fmaxf(v01, v11);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  // head g's unit max lives in lane g / 2; the new max in every lane
  float m_new[G], mn0 = 0.f, mn1 = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float um = __shfl_sync(0xffffffffu, (g & 1) ? mx1 : mx0, g >> 1);
    m_new[g] = fmaxf(m[g], um);
    alpha[g] = exp2f(m[g] - m_new[g]);
    if (g == h0) mn0 = m_new[g];
    if (g == h0 + 1) mn1 = m_new[g];
  }
  const float p00 = exp2f(v00 - mn0), p01 = exp2f(v01 - mn1);
  const float p10 = exp2f(v10 - mn0), p11 = exp2f(v11 - mn1);
  float sm0 = p00 + p10, sm1 = p01 + p11;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    sm0 += __shfl_xor_sync(0xffffffffu, sm0, o);
    sm1 += __shfl_xor_sync(0xffffffffu, sm1, o);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float us = __shfl_sync(0xffffffffu, (g & 1) ? sm1 : sm0, g >> 1);
    l[g] = fmaf(l[g], alpha[g], us);
    m[g] = m_new[g];
  }
  __syncwarp();                // the last unit's PV is done with prow
  if (h0 < G) {
    prow[h0 * U + s0] = p00;
    prow[h0 * U + s1] = p10;
  }
  if (h0 + 1 < G) {
    prow[(h0 + 1) * U + s0] = p01;
    prow[(h0 + 1) * U + s1] = p11;
  }
  __syncwarp();
}

// Tensor cores (bf16 pools): O^T [D, 8 heads] += V^T P^T by
// mma.m16n8k16, after scaling each head's column by alpha. V's A
// fragments by ldmatrix.trans from the swizzled V tile; P (fp32, in prow)
// enters as two bf16 operands, hi = bf16(p) and lo = bf16(p - hi), so
// the products are exact and p keeps 16 significant bits (a relative
// error near 2^-17, against the fp32 PV's 2^-24 and the bf16 output's
// 2^-9).
template <int D, int G>
__device__ __forceinline__ void pv_mma(float (&oacc)[D / 16][4],
                                       const float (&alpha)[G],
                                       const float* prow,
                                       const unsigned char* vt, int lane) {
  const int h0 = 2 * (lane & 3);
  float a0 = 1.f, a1 = 1.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g == h0) a0 = alpha[g];
    if (g == h0 + 1) a1 = alpha[g];
  }
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    oacc[i][0] *= a0;
    oacc[i][1] *= a1;
    oacc[i][2] *= a0;
    oacc[i][3] *= a1;
  }
  // B fragments: head lane/4, slots 2 (lane % 4) + {0, 1} and + 8
  const int n = lane >> 2, k0 = 2 * (lane & 3);
  float2 pa = make_float2(0.f, 0.f), pb = make_float2(0.f, 0.f);
  if (n < G) {
    pa = *reinterpret_cast<const float2*>(prow + n * U + k0);
    pb = *reinterpret_cast<const float2*>(prow + n * U + k0 + 8);
  }
  const uint32_t bh0 = sm90::pack_bf16(pa.x, pa.y);
  const uint32_t bh1 = sm90::pack_bf16(pb.x, pb.y);
  const uint32_t bl0 = sm90::pack_bf16(pa.x - __uint_as_float(bh0 << 16),
                                       pa.y - __uint_as_float(bh0 & 0xffff0000u));
  const uint32_t bl1 = sm90::pack_bf16(pb.x - __uint_as_float(bh1 << 16),
                                       pb.y - __uint_as_float(bh1 & 0xffff0000u));
  // ldmatrix.x4.trans of m-tile i: lanes 0-7 address slots 0-7 at dims
  // 16 i..+7, lanes 8-15 the same slots at dims +8..+15, lanes 16-31 slots
  // 8-15 likewise (fragments a0..a3 of V^T in mma order)
  const int slot = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t row_addr = sm90::smem_u32(vt) + slot * D * 2;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int ch = (2 * i + ((lane >> 3) & 1)) ^ (lane & 7);
    uint32_t v0, v1, v2, v3;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
        : "r"(row_addr + ch * 16));
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(oacc[i][0]), "+f"(oacc[i][1]), "+f"(oacc[i][2]),
          "+f"(oacc[i][3])
        : "r"(v0), "r"(v1), "r"(v2), "r"(v3), "r"(bh0), "r"(bh1));
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(oacc[i][0]), "+f"(oacc[i][1]), "+f"(oacc[i][2]),
          "+f"(oacc[i][3])
        : "r"(v0), "r"(v1), "r"(v2), "r"(v3), "r"(bl0), "r"(bl1));
  }
}

// One block per (split, KV head, tile of R rows); see the note above.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NT, (Smem<T, D, G>::min_blocks))
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ position, T* __restrict__ o,
                   float* __restrict__ part, int B, int nb, int ps, int H,
                   int K, int splits, float qscale) {
  using S = Smem<T, D, G>;
  constexpr int CPR = D * (int)sizeof(T) / 16;   // 16-byte chunks a slot
  constexpr int E = 16 / (int)sizeof(T);         // elements a chunk
  constexpr int DPL = D / 32;                    // PV dims a lane
  constexpr int ROW_BYTES = D * (int)sizeof(T);
  constexpr int NS = S::nslots;
  constexpr int KV = U * ROW_BYTES;              // V's offset in a slot
  static_assert(CPR >= 8 && D % 32 == 0 && E % 4 == 0, "layout");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::ring);   // [NS]
  float* sq = reinterpret_cast<float*>(smem + S::ring + S::bars);  // [R][G][D]
  float* sp = reinterpret_cast<float*>(smem + S::ring + S::bars + S::q);
  int* sbt = reinterpret_cast<int*>(sp + R * G * U);        // [R][MAX_SPAN]
  int* spage = sbt + R * MAX_SPAN;                          // [tiles]
  int* sfirst = spage + R * MAX_SPAN;                       // [n_pg + 1]
  int* spos = sfirst + MAX_SPAN + 1;                        // [R]
  int* send = spos + R;                                     // [R]
  signed char* srank = reinterpret_cast<signed char*>(send + R);  // [n_pg][R]

  // the merge kernel may be scheduled now; it waits for our partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, kh = blockIdx.y;
  const int b0 = blockIdx.z * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrows = min(R, B - b0);
  // this split's pages: j = split + jj * splits, jj < n_pg
  const int n_pg = (nb - split + splits - 1) / splits;
  const size_t row = (size_t)K * D;                  // pool slot stride

  // setup: a warp per row reads its position and its table row (the walk
  // end and the split's sub-table), the block its queries
  {
    const int r = warp;
    int end = 0, cur = -1;
    if (r < nrows) {
      const int* btr = bt + (size_t)(b0 + r) * nb;
      cur = position[b0 + r];
      for (int jj = lane; jj < n_pg; jj += 32)
        sbt[r * MAX_SPAN + jj] = btr[split + jj * splits];
      const int last = cur >= 0 ? min(nb - 1, cur / ps) : -1;
      bool any = false;
      for (int j = lane; j <= last; j += 32) any |= btr[j] >= 0;
      end = __any_sync(0xffffffffu, any) ? last + 1 : nb;
    }
    if (lane == 0) {
      spos[r] = cur;
      send[r] = end;
    }
  }
  // queries: fp32, pre-scaled, in shared memory for the CUDA-core scores;
  // in bf16, this warp's row as the B fragments of mma.m16n8k16 (lane
  // holds head lane/4, dims 16 kk + 2 (lane % 4) + {0, 1, 8, 9})
  uint32_t qf[sizeof(T) == 2 ? D / 16 : 1][2];
  if constexpr (sizeof(T) == 2) {
    const int n = lane >> 2;
    const bool have = warp < nrows && n < G;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(
        q + ((size_t)(b0 + (have ? warp : 0)) * H + kh * G + (have ? n : 0)) *
                D) + (lane & 3);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = have ? qw[8 * kk] : 0u;
      qf[kk][1] = have ? qw[8 * kk + 4] : 0u;
    }
  } else {
    constexpr int QV = G * D / E;                  // 16-byte vectors a row
    const float qs = qscale * kLog2e;
    for (int i = threadIdx.x; i < R * QV; i += NT) {
      const int r = i / QV, v = i % QV;
      float x[E];
      if (r < nrows) {
        load_f<T, E>(reinterpret_cast<const unsigned char*>(
                         q + ((size_t)(b0 + r) * H + kh * G) * D) + v * 16,
                     x);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(sq + r * G * D + v * E + e) =
            make_float4(x[e] * qs, x[e + 1] * qs, x[e + 2] * qs,
                        x[e + 3] * qs);
    }
  }
  if (threadIdx.x < NS) sm90::mbar_init(&bars[threadIdx.x], NT);
  sm90::fence_barrier_init();
  __syncthreads();

  // the copy list (warp 0): srank[jj][r] = the tile row r reads at page jj
  // of the split (-1: past its walk), sfirst[jj] = the tiles before page
  // jj, spage[tile] = its page in the pool
  int tile_end = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) tile_end = max(tile_end, send[r]);
  const int pg_end = tile_end > split
      ? min(n_pg, (tile_end - split + splits - 1) / splits) : 0;
  if (warp == 0) {
    int carry = 0;
    for (int j0 = 0; j0 < pg_end; j0 += 32) {
      const int jj = j0 + lane;
      const int j = split + jj * splits;
      int n = 0, pgs[R], rk[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pgs[r] = jj < pg_end && j < send[r] ? max(sbt[r * MAX_SPAN + jj], 0)
                                            : -1;
        rk[r] = -1;
        if (pgs[r] >= 0) {
          rk[r] = n;
#pragma unroll
          for (int r2 = 0; r2 < r; ++r2)
            if (pgs[r2] == pgs[r]) rk[r] = rk[r2];
          n += rk[r] == n;
        }
        if (jj < pg_end) srank[jj * R + r] = (signed char)rk[r];
      }
      int x = n;                                   // inclusive scan
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int first = carry + x - n;
      if (jj < pg_end) sfirst[jj] = first;
      int seen = 0;                    // ranks first appear in order
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (rk[r] == seen) spage[first + seen++] = pgs[r];
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) sfirst[pg_end] = carry;
  }
  __syncthreads();

  // Tiles are copied in list order, tile t into ring slot t % NS. Unit
  // (jj, sub) is the sub-th run of U slots of page jj; its tiles are page
  // jj's. The issuer walks tiles with its own (jj, sub, rank) counters.
  const int upp = (ps + U - 1) / U;
  const int n_tiles = upp * sfirst[pg_end];
  int t_next = 0, i_jj = 0, i_sub = 0, i_k = 0;
  auto issue_to = [&](int t_stop) {
    for (; t_next < t_stop; ++t_next) {
      const int off = i_sub * U;
      const int cnt = min(U, ps - off);
      const size_t g0 = ((size_t)spage[sfirst[i_jj] + i_k] * ps + off) * row +
                        (size_t)kh * D;
      unsigned char* dst = ring + (size_t)(t_next % NS) * S::slot;
      // a slot past the page (a unit of fewer than U) is zero-filled, so
      // the tensor-core products never meet stale shared memory
      for (int i = threadIdx.x; i < U * CPR; i += NT) {
        const int s = i / CPR, c = i % CPR;
        const int so = (s * CPR + (c ^ (s & 7))) * 16;
        const size_t go = g0 + (size_t)min(s, cnt - 1) * row + c * E;
        cp_async16(dst + so, kp + go, s < cnt);
        cp_async16(dst + KV + so, vp + go, s < cnt);
      }
      cp_async_arrive(&bars[t_next % NS]);
      if (++i_k == sfirst[i_jj + 1] - sfirst[i_jj]) {
        i_k = 0;
        if (++i_sub == upp) {
          i_sub = 0;
          ++i_jj;
        }
      }
    }
  };

  const int r = warp;
  const int cur = spos[r];
  const float* qrow = sq + r * G * D;
  float* prow = sp + r * G * U;
  // the row's running max and sum per head (the same in every lane), and
  // its accumulators: in fp32, this lane's DPL dims of the G heads; in
  // bf16, O^T [D, 8 heads] as D / 16 mma C fragments (dims 16 i + lane/4
  // and + 8, heads 2 (lane % 4) and + 1)
  float m[G], l[G];
  float acc[sizeof(T) == 4 ? G : 1][DPL];
  float oacc[sizeof(T) == 2 ? D / 16 : 1][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = minus_inf();
    l[g] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < (sizeof(T) == 4 ? G : 1); ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int i = 0; i < (sizeof(T) == 2 ? D / 16 : 1); ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[i][c] = 0.f;

  // first the tiles of two units, so they land before the rest of the
  // ring's copies queue behind them
  issue_to(min(min(n_tiles, NS), 2 * sfirst[min(1, pg_end)]));
  int t_u = 0;                             // the first tile of this unit
  for (int jj = 0; jj < pg_end; ++jj) {
    const int n = sfirst[jj + 1] - sfirst[jj];
    const int k = srank[jj * R + r];
    const bool ok_page = k >= 0 && sbt[r * MAX_SPAN + jj] >= 0;
    const int tok0 = (split + jj * splits) * ps;
    for (int sub = 0; sub < upp; ++sub, t_u += n) {
      // Refill the ring when fewer than NS / 2 tiles are queued past this
      // unit's (always, where the unit's own are not queued yet). The
      // barrier first: every warp is done with the units before this one,
      // whose slots the refill takes. Between refills the warps run apart,
      // so one warp's latency hides behind another's arithmetic.
      if (t_next < min(n_tiles, t_u + n + NS / 2)) {
        __syncthreads();
        issue_to(min(n_tiles, t_u + NS));
      }
      const int t = t_u + k;
      if (k < 0) continue;                 // this row is past its walk
      sm90::mbar_wait(&bars[t % NS], (t / NS) & 1);
      const unsigned char* tile = ring + (size_t)(t % NS) * S::slot;
      const int off = sub * U;
      const int cnt = min(U, ps - off);
      // slots below nvalid are valid; the rest below cnt are masked
      const int nvalid =
          ok_page ? max(0, min(cnt, cur - (tok0 + off) + 1)) : 0;
      float alpha[G];
      if constexpr (sizeof(T) == 2) {
        softmax_mma<D, G>(tile, qf, prow, lane, cnt, nvalid,
                          qscale * kLog2e, m, l, alpha);
        pv_mma<D, G>(oacc, alpha, prow, tile + KV, lane);
      } else {
        softmax_simt<T, D, G>(tile, qrow, prow, lane, cnt, nvalid, m, l,
                              alpha);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha[g];
        add_pv<T, D, G>(acc, prow, tile + KV, lane);
      }
    }
  }

  if (r >= nrows) return;
  const int b = b0 + r;
  // part [B, H, splits, D + 2]: acc, then m, then l
  auto partial = [&](int g) {
    return part + (((size_t)b * H + kh * G + g) * splits + split) * (D + 2);
  };
  if constexpr (sizeof(T) == 2) {
    const int h0 = 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = h0 + c;
      if (g >= G) continue;
      float mg = 0.f, lg = 0.f;
#pragma unroll
      for (int x = 0; x < G; ++x)
        if (x == g) {
          mg = m[x];
          lg = l[x];
        }
      const float inv = 1.f / fmaxf(lg, 1e-30f);
      T* op = o + ((size_t)b * H + kh * G + g) * D + (lane >> 2);
      float* pp = splits == 1 ? nullptr : partial(g);
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int d = 16 * i + 8 * hi;
          const float v = oacc[i][2 * hi + c];
          if (splits == 1)
            rt::store_f(op + d, v * inv);
          else
            pp[(lane >> 2) + d] = v;
        }
      if (splits > 1 && lane < 4) {
        pp[D] = mg;
        pp[D + 1] = lg;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (splits == 1) {
        const float inv = 1.f / fmaxf(l[g], 1e-30f);
        T* op = o + ((size_t)b * H + kh * G + g) * D + lane * DPL;
#pragma unroll
        for (int e = 0; e < DPL; ++e) rt::store_f(op + e, acc[g][e] * inv);
      } else {
        float* pp = partial(g);
#pragma unroll
        for (int e = 0; e < DPL; ++e) pp[lane * DPL + e] = acc[g][e];
        if (lane == 0) {
          pp[D] = m[g];
          pp[D + 1] = l[g];
        }
      }
    }
  }
}

// One block of D threads per (query head, row): rescale the splits'
// partials to their common max and sum them, in one pass (a running max,
// as the online softmax keeps it), so the loads of several splits are in
// flight together. Split 0 holds a real max (it has page 0 of every
// row), so no weight is exp2(-inf - -inf).
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_merge_kernel(const float* __restrict__ part, T* __restrict__ o,
                   int splits) {
  // launched early (programmatic dependent launch): wait here until the
  // split kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, d = threadIdx.x;
  const float* pp = part + ((size_t)b * H + h) * splits * (D + 2);
  float mx = pp[D], lsum = pp[D + 1], a = pp[d];
#pragma unroll 4
  for (int s = 1; s < splits; ++s) {
    const float ms = pp[s * (D + 2) + D], ls = pp[s * (D + 2) + D + 1];
    const float as = pp[s * (D + 2) + d];
    const float m_new = fmaxf(mx, ms);
    const float w_old = exp2f(mx - m_new), w = exp2f(ms - m_new);
    lsum = fmaf(lsum, w_old, ls * w);
    a = fmaf(a, w_old, as * w);
    mx = m_new;
  }
  rt::store_f(o + ((size_t)b * H + h) * D + d, a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D, int G>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const int* bt, const int* position, void* o,
                     float* part, int B, int nb, int ps, int H, int K,
                     int splits, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D, G>::total;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, K, (B + R - 1) / R);
  paged_split_kernel<T, D, G><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, position, static_cast<T*>(o), part, B,
      nb, ps, H, K, splits, 1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  // the merge may launch while the split kernel's last blocks run
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, D>,
                           static_cast<const float*>(part),
                           static_cast<T*>(o), splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(int G, const void* q, const void* kp, const void* vp,
                   const int* bt, const int* position, void* o, float* part,
                   int B, int nb, int ps, int H, int K, int splits,
                   cudaStream_t s) {
  switch (G) {
#define RT_CASE(g) \
  case g: return launch_g<T, D, g>(q, kp, vp, bt, position, o, part, B, nb, ps, H, K, splits, s);
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
#undef RT_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,D], pools [P,ps,K,D] (one dtype), block table [B,nb] int32 with
// entries in [-1, P), position [B] int32, o [B,H,D]; all contiguous and
// 16-byte aligned. H / K <= 8. Split s of `splits` <= nb walks pages s,
// s + splits, ..., at most 32 of them; with splits > 1, `part` is fp32
// scratch of B*H*splits*(D+2) floats.
extern "C" int rt_paged_decode_attention(const void* q, const void* kp,
                                         const void* vp, const void* bt,
                                         const void* position, void* o,
                                         void* part, int B, int nb, int ps,
                                         int H, int K, int D, int splits,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nb <= 0 || ps <= 0 || K <= 0 || H % K != 0 ||
      H / K > MAXG || splits <= 0 || splits > nb ||
      (nb + splits - 1) / splits > MAX_SPAN || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int* t = static_cast<const int*>(bt);
  const int* cur = static_cast<const int*>(position);
  float* pt = static_cast<float*>(part);
  if (dtype == rt::kBFloat16) {
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(G, q, kp, vp, t, cur, o, pt, B, nb, ps, H, K, splits, s);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(G, q, kp, vp, t, cur, o, pt, B, nb, ps, H, K, splits, s);
  } else if (dtype == rt::kFloat32) {
    if (D == 64) return (int)launch<float, 64>(G, q, kp, vp, t, cur, o, pt, B, nb, ps, H, K, splits, s);
    if (D == 128) return (int)launch<float, 128>(G, q, kp, vp, t, cur, o, pt, B, nb, ps, H, K, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

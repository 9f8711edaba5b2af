// The Essential Matrix Module's moments and their backward in fp32 on
// Hopper's warpgroup tensor-core products (wgmma .tf32) with tiles brought
// by the Tensor Memory Accelerator (TMA), as 3xTF32: the fp32 PairLayout
// body (one slice a block) of
//   - #2 _essential_block_pair_kernel, #3 _essential_block_x_kernel and #4
//     _essential_block_kernel (rel_pose_tpu/ops/pallas_essential_block.py,
//     core _eb_combos :87): launch_moments_wg (essential_block.cu);
//   - #6 _essential_block_bwd_kernel
//     (rel_pose_tpu/ops/pallas_essential_block_bwd.py:35): launch_bwd_wg
//     (essential_block_bwd.cu);
//   - #9 _s_kernel (scripts/bench_cross.py:88): launch_moments_wg with
//     kGroup, each block of the moments kernel walking S slices in turn
//     with #4's arithmetic (cross_variants.cu).
// bf16 runs essential_wgmma.cuh; fp32 SliceLayout (#8) stays on the
// mma.sync body of essential_tc.cuh / essential_tc_bwd.cuh.
// The function and the notation are essential_tc.cuh's and
// essential_tc_bwd.cuh's (T is the identity in fp32).
//
// Every product is 3xTF32 (attention_wgmma_f32.cuh): each operand split
// into TF32 hi and lo, lo_a hi_b, hi_a lo_b, hi_a hi_b summed into a fresh
// accumulator of one 64- or 72-deep tile, which one IEEE fp32 operation
// puts into a running sum (the forward's P vb_n rescaled online as o = o
// alpha + pv).  TMA lands every tile raw and unswizzled -- q, k and v
// from 3-D tensor maps over each image's (B, N, 3C) qkv rows at columns
// h*64, C + h*64 and 2C + h*64, so that rows >= N load as zeros and never
// from the next image; vb_n, VB, VBDFT and VADF from maps over the (G, N,
// kW) scratch rows (kW = 72 fp32 for e = 70: 288-byte rows, on TMA's
// 16-byte grid) -- and the warpgroup splits it once a block into hi / lo
// K-major tiles in the 128-byte swizzle: as it is (split_rows_w) for a
// product over its columns, or transposed (split_cols_w) for a product of
// a score over its rows, in the order in which a score accumulator holds
// its keys as register A fragments.  An e-deep K-major tile (72 fp32) is
// three 32-float swizzle columns of which the products read nine k8 steps
// (the third column's last 24 floats are never read: no padded products);
// a transposed 72-row tile is two swizzle columns of 72 rows (9216 bytes,
// nine 8-row groups a column), read by wgmma at n = 72.
//
// What bounds it on the H100: the products, at 495 / 3 = 165 TFLOP/s for
// 3xTF32 -- executed per slice 2 N^2 64 (+ N^2 64 for the key statistics)
// and N^2 kW + N kW^2 multiply-adds forward, and in the backward 2 N^2 64
// of statistics and 2 N^2 (64 + kW) a pass over (s, dA), plus N^2 (64 +
// kW) in each gradient pass -- and the exp2 of every score.  The design:
//   forward (launch_moments_wg; kEbSingle skips 1):
//     1. ewg_stats_kernel<keys>, one warpgroup per (64-key tile, slice):
//        k split once into register A fragments, the query tiles landing
//        raw by TMA into a 2-box ring and split into a 2-pair ring (the
//        next tile's split runs during this one's product), s^T = k q^T on
//        wgmma m64n64k8; the column max and the online column sum give
//        (mc, 1/lc) per key (99 KB, two blocks an SM);
//     2. eb_vbn_kernel (essential_tc.cuh): vb_n = vb / lc in kW-wide rows;
//     3. ewg_moments_kernel, one warpgroup per (64-query tile, slice), in
//        ONE walk over the key tiles with the online row max (fp32 rounds
//        nothing between the steps, so rescaling is exact up to fp32; an
//        exact-max first walk would take a second score product): q in
//        registers, k
//        split during P vb_n, vb_n^T split during q k^T, P = er ec split
//        in registers into hi / lo A fragments, P vb_n at n = kW in two
//        fresh 32-key partials (o = o alpha + pv1 + pv2); then av
//        = o / lr and the tile's F partial va^T av on mma.sync
//        (essential_tc.cuh's mma_atb_f32: 72 x 72 x 64, 6% of the
//        products; wgmma's M is 64) (104 KB, two blocks an SM);
//     4. launch_sum_partials adds the query tiles' partials in order.
//   backward (launch_bwd_wg): ewg_stats_kernel for the queries and (dual)
//     the keys, essential_tc_bwd.cuh's prologue (VB, VBDFT, VADF rows),
//     then three passes over (own 64-row tile, walked tile) pairs, each
//     forming s = X Xw^T and d = Y Yw^T (dA or dA^T) on wgmma:
//     a. rows = queries, REDUCE: W = dA R Cm (SINGLE dA R); rho = W's row
//        sums, whole, and (dual) gamma's per-query-tile partials = W's
//        column sums over the tile's 64 queries, to scratch -- rho and
//        gamma in one pass (the mma.sync body runs two);
//     b. rows = keys, GRAD: gamma = its partials summed in query-tile order
//        (kept in the key statistics' third slot for c), ds^T and A^T;
//        dk += T(ds sigma)^T q, dvb += A^T vadf;
//     c. rows = queries, GRAD: ds and A; dq += T(ds sigma) k, dva += A
//        vbdft.
//     The own X and Y are K-major pairs in shared memory.  In b and c,
//     after the products of s and d the walked tiles are split again,
//     transposed, for the products of ds and A, whose accumulators are
//     those products' register A operands.  The pairs and the raw boxes
//     take 163-214 KB, one block an SM (in b and c the running dq and dva
//     sums, two fresh partials and the A fragments leave no registers for
//     own fragments; a reduce pass with q and vadf as register A fragments
//     at two blocks an SM, about half the time, gave the e = 64 single
//     softmax's rho wrong for a few rows of late blocks in most calls,
//     cause not found: PERF.md).
// PairLayout's outputs keep the scatter of essential_tc_bwd.cuh with b
// before c: pass b writes dvb in fp32 to scratch (with CROSS also its v
// columns to the key image's v slot), and pass c adds it to dva (dv = dva
// + dvb, the same bits as dvb + dva) into the key image's v slot, or with
// CROSS writes T(dva) to the query image's (B, 2, N, C) buffer; the
// positional columns go to dpos_part.  Rows >= N load as zeros and keys >=
// N are masked out of every max and sum.  No atomics, sums in a fixed
// order: two calls give the same bits.

#pragma once

#include "essential_tc_bwd.cuh"

namespace rp {
namespace tc {
namespace wg {

// ------------------------------------------------------------- tiles --
// A K-major fp32 tile of R rows (the product's M or N) and depth D (the sum
// index, a multiple of 8): ceil(D / 32) swizzle columns of R rows of 128
// bytes, R * 128 bytes apart; the pair's lo tile kBytes after its hi tile.
template <int R, int D>
struct KTile {
  static_assert(R % 8 == 0 && D % 8 == 0, "8-row groups, k8 steps");
  static constexpr int kColBytes = R * kRowBytes;
  static constexpr int kBytes = (D + 31) / 32 * kColBytes;
  static constexpr int kPair = 2 * kBytes;
  static constexpr int kSteps = D / 8;
};

// byte offset of 16-byte chunk j (sum index 4j .. 4j + 3) of row r in a
// K-major fp32 tile of R rows (swz_f32 for R = 64)
template <int R>
__device__ __forceinline__ uint32_t swz_rows(int r, int j) {
  return (j >> 3) * (R * kRowBytes) + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// k8 step kk of a descriptor of such a tile (tf32_step for R = 64)
template <int R>
__device__ __forceinline__ uint64_t step_rows(uint64_t d, int kk) {
  return d + (uint64_t)(((kk >> 2) * (R * kRowBytes) + (kk & 3) * kStepK) /
                        16);
}

// step_rows formed just before its product: opaque to the compiler, so
// that it is not hoisted (with every step's descriptor formed ahead, a
// gradient pass ran out of registers and spilled)
template <int R>
__device__ __forceinline__ uint64_t step_late(uint64_t d, int kk) {
  uint64_t x = step_rows<R>(d, kk);
  asm volatile("" : "+l"(x));
  return x;
}

// x split into its hi / lo pair at byte offset off of each tile, lo bytes
// after hi
__device__ __forceinline__ void put_split_lo(unsigned char* pair, int lo,
                                             uint32_t off, float4 x) {
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(pair + off) = h;
  *reinterpret_cast<uint4*>(pair + lo + off) = l;
}

// The thread index of a split; with kLate opaque to the compiler, so that
// the split's addresses are formed at each call and not hoisted out of the
// caller's loop into registers that its accumulators need (a gradient
// pass spilled; the kernels that do not pay for the extra integer work)
template <bool kLate>
__device__ __forceinline__ int split_tid() {
  int tid = threadIdx.x;
  if constexpr (kLate) asm volatile("" : "+r"(tid));
  return tid;
}

// a raw box of 64 rows x W fp32 (rows of W, as TMA lands it) split into a
// pair of K-major tiles whose rows are its rows, depth W; thread tid takes
// chunks c = tid + 128 u: row c / (W / 4), 16-byte chunk c % (W / 4)
template <int W, bool kLate = false>
__device__ __forceinline__ void split_rows_w(unsigned char* pair,
                                             const float* raw) {
  constexpr int CPR = W / 4;
  static_assert(kT * CPR % kThreads == 0, "whole steps");
  const int tid = split_tid<kLate>();
#pragma unroll
  for (int u = 0; u < kT * CPR / kThreads; ++u) {
    const int c = tid + u * kThreads, r = c / CPR, j = c % CPR;
    put_split_lo(pair, KTile<kT, W>::kBytes, swz_rows<kT>(r, j),
                 *reinterpret_cast<const float4*>(raw + r * W + 4 * j));
  }
}

// a raw box of 64 rows x W fp32 split into a pair of K-major tiles of its
// transpose: W rows (the box's columns), 64 deep, the sum index over the
// box's rows in the order 0 2 4 6 1 3 5 7 within each group of 8 (slot t
// row 2t, slot t + 4 row 2t + 1), a score accumulator's key order as
// register A fragments (split_frag).  A warp reads consecutive columns of
// one row; a quarter warp writes one chunk to each of 8 consecutive rows.
template <int W, bool kLate = false>
__device__ __forceinline__ void split_cols_w(unsigned char* pair,
                                             const float* raw) {
  static_assert(W * 16 % kThreads == 0, "whole steps");
  const int tid = split_tid<kLate>();
#pragma unroll
  for (int u = 0; u < W * 16 / kThreads; ++u) {
    const int idx = tid + u * kThreads, c = idx % W, j = idx / W;
    const float* p = raw + (8 * (j >> 1) + (j & 1)) * W + c;
    put_split_lo(pair, KTile<W, kT>::kBytes, swz_rows<W>(c, j),
                 make_float4(p[0], p[2 * W], p[4 * W], p[6 * W]));
  }
}

// A fragments (hi / lo) of this warp's 16 rows of a raw 64 x 64 box: row
// 16w + g (+ 8), column 8kk + t (+ 4), wgmma's tf32 register A layout
__device__ __forceinline__ void raw_frags(unsigned (&h)[8][4],
                                          unsigned (&l)[8][4],
                                          const float* raw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* r = raw + (warp * 16 + (lane >> 2)) * kHeadDim + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(r[(e & 1) * 8 * kHeadDim + 8 * kk + 4 * (e >> 1)], h[kk][e],
                 l[kk][e]);
}

// ---------------------------------------------------------- products --
#define RP_EW4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (+)= A . B^T over one k8 step at n = 72: A register fragments, B a
// K-major tile of 72 rows; acc = 0 overwrites d
__device__ __forceinline__ void mma_rs_tf32_n72(float (&d)[9][4],
                                                const unsigned (&a)[4],
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, "
      "p, 1, 1;\n}\n"
      : RP_EW4(d, 0), RP_EW4(d, 1), RP_EW4(d, 2), RP_EW4(d, 3), RP_EW4(d, 4),
        RP_EW4(d, 5), RP_EW4(d, 6), RP_EW4(d, 7), RP_EW4(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef RP_EW4

template <int NR>
__device__ __forceinline__ void mma_rs_n(float (&d)[NR / 8][4],
                                         const unsigned (&a)[4], uint64_t b,
                                         int acc) {
  static_assert(NR == 64 || NR == 72, "n = 64 or 72");
  if constexpr (NR == 72)
    mma_rs_tf32_n72(d, a, b, acc);
  else
    mma_rs_tf32(d, a, b, acc);
}

template <int NR>
__device__ __forceinline__ void fence_acc_n(float (&d)[NR / 8][4]) {
#pragma unroll
  for (int ni = 0; ni < NR / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[ni][e])::"memory");
}

// d = P . B^T, P a score accumulator split into register fragments (h, l),
// B the pair of a transposed tile of NR rows (split_cols_w) at b, into d
// afresh (issued, not waited for)
template <int NR, int K0 = 0, int K1 = 8>
__device__ __forceinline__ void gemm3_rs_n(float (&d)[NR / 8][4],
                                           const unsigned (&h)[8][4],
                                           const unsigned (&l)[8][4],
                                           uint32_t b) {
  const uint64_t bh = desc(b), bl = desc(b + KTile<NR, kT>::kBytes);
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    mma_rs_n<NR>(d, l[kk], step_late<NR>(bh, kk), kk > K0);
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    mma_rs_n<NR>(d, h[kk], step_late<NR>(bl, kk), 1);
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    mma_rs_n<NR>(d, h[kk], step_late<NR>(bh, kk), 1);
}

// d = A . B^T over D-deep rows, A and B the pairs of K-major tiles of 64
// rows at a and b, into d afresh (issued, not waited for)
template <int D>
__device__ __forceinline__ void gemm3_ss_d(float (&d)[8][4], uint32_t a,
                                           uint32_t b) {
  using K = KTile<kT, D>;
  const uint64_t ah = desc(a), al = desc(a + K::kBytes), bh = desc(b),
                 bl = desc(b + K::kBytes);
#pragma unroll
  for (int kk = 0; kk < K::kSteps; ++kk)
    mma_ss_tf32(d, step_late<kT>(al, kk), step_late<kT>(bh, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K::kSteps; ++kk)
    mma_ss_tf32(d, step_late<kT>(ah, kk), step_late<kT>(bl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < K::kSteps; ++kk)
    mma_ss_tf32(d, step_late<kT>(ah, kk), step_late<kT>(bh, kk), 1);
}

// --------------------------------------------------------- the slices --
// PairLayout's slice g = (b * 2 + direction) * heads + h (essential_tc.cuh
// EbSlice): direction 0 takes q from image 2 and k, v from image 1
struct EwSlice {
  int b, dir, h;
  __device__ explicit EwSlice(int g, int heads) {
    h = g % heads;
    dir = (g / heads) & 1;
    b = g / (2 * heads);
  }
};

// ------------------------------------------------------------ statistics --
// Per row of the own side (keys with kKeyRows: the column statistics of s;
// queries: its row statistics), the max m of its scores over the other
// side and 1 / sum exp2(s - m), to stats[(g N + row) * 3] and [.. + 1]
// (slot 2 is the backward's).  The own 64 rows land raw and become register
// A fragments; the other side's tiles land in a ring of two raw boxes and
// are split into a ring of two work pairs, the next tile's split during
// this tile's product.  The sum is online (rescaled when the max grows).
constexpr size_t kStatsWgSmem = 2 * kF32Pair + 2 * kF32Raw + 8 * 3 + kAlign;

template <bool kKeyRows>
__global__ void __launch_bounds__(kThreads, 2)
ewg_stats_kernel(const __grid_constant__ CUtensorMap m1,
                 const __grid_constant__ CUtensorMap m2,
                 float* __restrict__ stats, int N, int C, int heads,
                 float scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  // pair j at sm + j kF32Pair, raw box j at raw(j) (offsets, not arrays of
  // pointers: those are indexed from the stack)
  const auto raw = [&](int j) {
    return reinterpret_cast<const float*>(sm + 2 * kF32Pair + j * kF32Raw);
  };
  const uint32_t Ws = smem_u32(sm), Rs = Ws + 2 * kF32Pair;
  const uint32_t obar = Rs + 2 * kF32Raw, rbar = obar + 8;  // rbar, + 8
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kT, g = blockIdx.y;
  const EwSlice sl(g, heads);
  const CUtensorMap& mq = sl.dir == 0 ? m2 : m1;
  const CUtensorMap& mk = sl.dir == 0 ? m1 : m2;
  const CUtensorMap& mo = kKeyRows ? mk : mq;
  const CUtensorMap& mw = kKeyRows ? mq : mk;
  const int co = (kKeyRows ? C : 0) + sl.h * kHeadDim;
  const int cw = (kKeyRows ? 0 : C) + sl.h * kHeadDim;
  const int nt = (N + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(obar, 1);
    mbar_init(rbar, 1);
    mbar_init(rbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(obar, kF32Raw);
    tma_load(Ws + kF32Pair, mo, obar, co, r0, sl.b);  // own rows, raw
    for (int j = 0; j < 2 && j < nt; ++j) {
      mbar_expect_tx(rbar + 8 * j, kF32Raw);
      tma_load(Rs + j * kF32Raw, mw, rbar + 8 * j, cw, j * kT, sl.b);
    }
  }
  unsigned xh[8][4], xl[8][4];
  mbar_wait(obar, 0);
  raw_frags(xh, xl, reinterpret_cast<const float*>(sm + kF32Pair));
  mbar_wait(rbar, 0);
  split_rows_w<kHeadDim>(sm, raw(0));
  proxy_fence();
  __syncthreads();  // the own raw rows are read before pair 1 is written
  if (tid == 0 && nt > 2) {
    mbar_expect_tx(rbar, kF32Raw);
    tma_load(Rs, mw, rbar, cw, 2 * kT, sl.b);
  }

  float s[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    const int c0 = t * kT, nx = (t + 1) & 1;
    wg_fence();
    gemm3_rs(s, xh, xl, Ws + (t & 1) * kF32Pair);
    wg_commit();
    if (t + 1 < nt) {  // the next tile's split, during this product
      mbar_wait(rbar + 8 * nx, ((t + 1) >> 1) & 1);
      split_rows_w<kHeadDim>(sm + nx * kF32Pair, raw(nx));
      proxy_fence();
    }
    wg_wait();
    fence_acc(s);
    fence_frags(xh, xl);
    __syncthreads();  // pair t & 1 is read; raw box nx is split
    if (tid == 0 && t + 3 < nt) {
      mbar_expect_tx(rbar + 8 * nx, kF32Raw);
      tma_load(Rs + nx * kF32Raw, mw, rbar + 8 * nx, cw, c0 + 3 * kT, sl.b);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[ni][e] = c0 + acc_col(ni, e) < N ? __fmul_rn(s[ni][e], scale)
                                             : -INFINITY;
          mt = fmaxf(mt, s[ni][e]);
        }
      if (mt > m[half]) {  // online: rescale the sum to the new max
        l[half] *= exp2f(m[half] - mt);
        m[half] = mt;
      }
      if (m[half] == -INFINITY) continue;  // no column of this thread yet
      float add = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e)
          add += exp2f(s[ni][e] - m[half]);  // masked: exp2(-inf) = 0
      l[half] += add;
    }
  }
  float* st = stats + (size_t)g * N * 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float M = quad_max(m[half]);
    const float L = quad_sum(l[half] * exp2f(m[half] - M));
    const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
    if (row < N && (lane & 3) == 0) {
      st[(size_t)row * 3] = M;
      st[(size_t)row * 3 + 1] = 1.f / L;
    }
  }
}

// ------------------------------------------------------------- moments --
// The partial F = va^T av of 64 query rows of slice g to fpart[(blockIdx.x
// G + g) E^2], in one walk over the key tiles: q split once into register
// A fragments (it lands raw in vb_n's work pair), k's pair and vb_n^T's
// pair, the raw K and vb_n boxes, the barriers; vb_n^T's split runs during
// q k^T and the next k's during P vb_n (attention_wgmma_f32.cuh's forward).
// Block row y takes slice y, or with kGroup the S slices
// PairLayout::slice(y, 0 .. S - 1) in turn (#9's s), each with the same
// arithmetic; the barriers' phases run on over the slices.
template <int E>
constexpr size_t moments_wg_smem() {
  constexpr int KW = EbW<float, E>::kW;
  return kF32Pair + KTile<KW, kT>::kPair + kF32Raw + kT * KW * 4 + 8 * 3 +
         kAlign;
}

template <int E, bool SINGLE, bool CROSS, bool kGroup>
__global__ void __launch_bounds__(kThreads, 2)
ewg_moments_kernel(const __grid_constant__ CUtensorMap m1,
                   const __grid_constant__ CUtensorMap m2,
                   const __grid_constant__ CUtensorMap mvb,
                   const float* __restrict__ img1,
                   const float* __restrict__ img2, size_t bstride,
                   const float* __restrict__ pos,
                   const float* __restrict__ kstats,
                   float* __restrict__ fpart, int N, int C, int heads, int S,
                   float scale) {
  using W = EbW<float, E>;
  constexpr int KW = W::kW;
  constexpr int kPairV = KTile<KW, kT>::kPair;
  constexpr int kRawV = kT * KW * 4;
  static_assert(kPairV >= kF32Raw, "q lands raw in vb_n's work pair");
  static_assert(2 * W::kTileElems * 4 <= kF32Pair + kPairV,
                "va and av fit the work pairs");
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  unsigned char* KP = sm;
  unsigned char* VP = sm + kF32Pair;
  const float* rk = reinterpret_cast<const float*>(VP + kPairV);
  const float* rv = rk + kT * kHeadDim;
  const uint32_t Ks = smem_u32(sm), Vs = Ks + kF32Pair;
  const uint32_t Rk = Vs + kPairV, Rv = Rk + kF32Raw;
  const uint32_t qbar = Rv + kRawV, kbar = qbar + 8, vbar = qbar + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT;
  const int nk = (N + kT - 1) / kT;
  const int per_block = kGroup ? S : 1;
  const size_t G = (size_t)gridDim.y * per_block;

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll 1
  for (int si = 0; si < per_block; ++si) {
    const int g =
        kGroup ? PairLayout::slice(blockIdx.y, si, S, heads) : blockIdx.y;
    const EwSlice sl(g, heads);
    const CUtensorMap& mq = sl.dir == 0 ? m2 : m1;
    const CUtensorMap& mk = sl.dir == 0 ? m1 : m2;
    const int qc = sl.h * kHeadDim, kc = C + sl.h * kHeadDim;
    const float* ks = kstats + (size_t)g * N * 3;
    const int t0 = si * nk;  // k and vb_n loads of the earlier slices
    if (si > 0) {  // the last slice's reads and writes of the pairs are done
      proxy_fence();
      __syncthreads();
    }
    if (tid == 0) {
      mbar_expect_tx(qbar, kF32Raw);
      tma_load(Vs, mq, qbar, qc, q0, sl.b);  // q lands raw in vb_n's pair
      mbar_expect_tx(kbar, kF32Raw);
      tma_load(Rk, mk, kbar, kc, 0, sl.b);
      mbar_expect_tx(vbar, kRawV);
      tma_load(Rv, mvb, vbar, 0, 0, g);
    }
    unsigned qh[8][4], ql[8][4];
    mbar_wait(qbar, si & 1);
    raw_frags(qh, ql, reinterpret_cast<const float*>(VP));
    mbar_wait(kbar, t0 & 1);
    split_rows_w<kHeadDim>(KP, rk);
    proxy_fence();
    __syncthreads();  // raw q is read before vb_n's split overwrites it
    if (tid == 0 && nk > 1) {
      mbar_expect_tx(kbar, kF32Raw);
      tma_load(Rk, mk, kbar, kc, kT, sl.b);
    }

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[KW / 8][4] = {}, s[8][4], pv[KW / 8][4];
    unsigned ph[8][4], pl[8][4];
    for (int t = 0; t < nk; ++t) {
      const int k0 = t * kT;
      wg_fence();
      gemm3_rs(s, qh, ql, Ks);  // s = q . k^T, q from registers
      wg_commit();
      float mc[8][2] = {};  // the key statistics' max of its columns
      if constexpr (!SINGLE) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = k0 + acc_col(ni, c);
            mc[ni][c] = j < N ? __ldg(ks + (size_t)j * 3) : 0.f;
          }
      }
      mbar_wait(vbar, (t0 + t) & 1);
      split_cols_w<KW>(VP, rv);  // vb_n^T, during the score product
      proxy_fence();
      __syncthreads();
      if (tid == 0 && t + 1 < nk) {
        mbar_expect_tx(vbar, kRawV);
        tma_load(Rv, mvb, vbar, 0, k0 + kT, g);
      }
      wg_wait();
      fence_acc(s);
      fence_frags(qh, ql);
      // the tile's row max, the running max and the rescale of l
      float mt[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[ni][e] = __fmul_rn(s[ni][e], scale);
          if (k0 + acc_col(ni, e) < N) mt[e >> 1] = fmaxf(mt[e >> 1], s[ni][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = quad_max(mt[r]);
        alpha[r] = exp2f(m[r] - mt[r]);  // 0 at the first tile
        m[r] = mt[r];
        l[r] *= alpha[r];
      }
      // P = er ec (SINGLE: er), masked keys 0
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = 0.f;
          if (k0 + acc_col(ni, e) < N) {
            const float er = exp2f(s[ni][e] - m[e >> 1]);
            l[e >> 1] += er;
            p = SINGLE ? er : er * exp2f(s[ni][e] - mc[ni][e & 1]);
          }
          s[ni][e] = p;
        }
      split_frag(ph, pl, s);
      __syncthreads();  // every warp's score products have read k's pair
      // P vb_n as two fresh partials of 32 keys each (the depth of the fp32
      // GEMMs' partials; 64-deep ones read 1.224 on the float64 bar against
      // 1.195, PERF.md), the first during the next k's split
      wg_fence();
      gemm3_rs_n<KW, 0, 4>(pv, ph, pl, Vs);
      wg_commit();
      if (t + 1 < nk) {
        mbar_wait(kbar, (t0 + t + 1) & 1);
        split_rows_w<kHeadDim>(KP, rk);  // the next k, during P vb_n
        proxy_fence();
      }
      wg_wait();
      fence_acc_n<KW>(pv);
#pragma unroll
      for (int ni = 0; ni < KW / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[ni][e] = __fmaf_rn(o[ni][e], alpha[e >> 1], pv[ni][e]);
      wg_fence();
      gemm3_rs_n<KW, 4, 8>(pv, ph, pl, Vs);
      wg_commit();
      wg_wait();
      fence_acc_n<KW>(pv);
      fence_frags(ph, pl);
#pragma unroll
      for (int ni = 0; ni < KW / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[ni][e] = __fadd_rn(o[ni][e], pv[ni][e]);
      // every warp's P vb_n products have read vb_n's pair; the next k is
      // split
      __syncthreads();
      if (tid == 0 && t + 2 < nk) {
        mbar_expect_tx(kbar, kF32Raw);
        tma_load(Rk, mk, kbar, kc, k0 + 2 * kT, sl.b);
      }
    }

    // av = o / lr to shared memory beside va's rows (over the work pairs,
    // free after the walk), then F = va^T av on mma.sync
    float* VAs = reinterpret_cast<float*>(sm);
    float* AVs = VAs + W::kTileElems;
    const EbView<float> vw = PairLayout::view<E, CROSS>(
        img1, img2, pos, bstride, N, C, heads, g);
    PairLayout::load_v<E>(VAs, vw.va, vw, q0, N);
    cp_async_commit();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float inv = 1.f / quad_sum(l[half]);
      const int r = warp * 16 + (lane >> 2) + half * 8;
      const bool ok = q0 + r < N;
#pragma unroll
      for (int ni = 0; ni < KW / 8; ++ni)
        store2(AVs + r * W::kLd + acc_col(ni, 0),
               ok ? o[ni][2 * half] * inv : 0.f,
               ok ? o[ni][2 * half + 1] * inv : 0.f);
    }
    cp_async_wait<0>();
    __syncthreads();
    float* fp = fpart + ((size_t)blockIdx.x * G + g) * E * E;
    for (int mt = warp; mt < W::kM16; mt += kThreads / 32) {
      float f[W::kNT][4];
      mma_atb_f32<W::kNT, W::kLd, W::kW>(f, VAs, mt * 16, AVs);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e1 = mt * 16 + (lane >> 2) + half * 8;
        if (e1 >= E) continue;
#pragma unroll
        for (int ni = 0; ni < W::kNT; ++ni) {
          const int e2 = acc_col(ni, 0);
          if (e2 < E)
            *reinterpret_cast<float2*>(fp + e1 * E + e2) =
                make_float2(f[ni][2 * half], f[ni][2 * half + 1]);
        }
      }
    }
  }
}

// -------------------------------------------------------------- passes --
// One pass over the (own 64-row tile, walked tile) pairs of slice g.  Own
// rows are queries with kRows (X = q, Y = vadf; walked Xw = k, Yw = vb, Zw
// = vbdft), keys without (X = k, Y = vb; walked Xw = q, Yw = Zw = vadf);
// each side's statistics (m, 1/l, reduction) per row at [(g N + row) * 3].
// Per tile: s = X Xw^T (scaled) and d = Y Yw^T from the own pairs and the
// walked rows' splits; then
//   REDUCE (pass a, kRows only): W = (dA Cm) R (SINGLE dA R); rho = W's
//     row sums into the queries' slot 2 and, dual, the tile's column sums
//     of W, gamma's partials, to gpart[(blockIdx.x G + g) N + key];
//   GRAD (passes b, c): Xw and Zw are split again, transposed, and out1 +=
//     T(ds sigma) Xw, out2 += A Zw, each tile's products into a fresh
//     accumulator.
// Shared memory: the own X and Y pairs, the work pairs W1 (Xw, then Xw^T)
// and W2 (Yw, then Zw^T), the raw Xw, Yw (and, rows = queries with GRAD,
// Zw) boxes, the walked statistics, gamma's column sums, the barriers.
template <int E, bool kRows, bool kGrad>
struct PassWg {
  static constexpr int KW = EbW<float, E>::kW;
  static constexpr bool kZ = kRows && kGrad;  // a raw Zw box of its own
  static constexpr int kPairY = KTile<kT, KW>::kPair;
  static constexpr int kPairW2 =
      kPairY > KTile<KW, kT>::kPair ? kPairY : KTile<KW, kT>::kPair;
  static constexpr int kRawY = kT * KW * 4;
  static constexpr int OX = 0, OY = OX + kF32Pair, W1 = OY + kPairY,
                       W2 = W1 + kF32Pair, RX = W2 + kPairW2,
                       RY = RX + kF32Raw, RZ = RY + kRawY,
                       WS = RZ + (kZ ? kRawY : 0), CS = WS + 3 * kT * 4,
                       BAR = CS + (kGrad ? 0 : 4 * kT * 4);
  static constexpr size_t kSmem = BAR + 8 * 4 + kAlign;
  static_assert(kF32Raw <= kF32Pair && kRawY <= kPairW2,
                "the own raw rows land in the work pairs");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

template <int E, bool kRows, bool kGrad, bool SINGLE, bool CROSS>
__global__ void __launch_bounds__(kThreads, 1)
ewg_pass_kernel(const __grid_constant__ CUtensorMap m1,
                const __grid_constant__ CUtensorMap m2,
                const __grid_constant__ CUtensorMap moy,
                const __grid_constant__ CUtensorMap mwy,
                const __grid_constant__ CUtensorMap mwz,
                const float* __restrict__ in0, const float* __restrict__ in1,
                size_t ld, float* __restrict__ qstats,
                float* __restrict__ kstats, float* __restrict__ gpart,
                float* __restrict__ DVA, float* __restrict__ dqkv,
                float* __restrict__ dva_x, float* __restrict__ dpos_part,
                int N, int C, int heads, float scale, float sigma) {
  static_assert(kRows || kGrad, "REDUCE runs over the query rows");
  using P = PassWg<E, kRows, kGrad>;
  constexpr int KW = P::KW;
  // with SINGLE only the query side has statistics
  constexpr bool kOwnStats = !SINGLE || kRows;
  constexpr bool kWalkStats = !SINGLE || !kRows;
  constexpr bool kGammaPart = !kGrad && !SINGLE;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t base = smem_u32(sm);
  const float* rx = reinterpret_cast<const float*>(sm + P::RX);
  const float* ry = reinterpret_cast<const float*>(sm + P::RY);
  const float* rz = reinterpret_cast<const float*>(sm + (P::kZ ? P::RZ
                                                               : P::RY));
  float* WSs = reinterpret_cast<float*>(sm + P::WS);
  float* CSs = reinterpret_cast<float*>(sm + P::CS);
  const uint32_t obar = base + P::BAR, xbar = obar + 8, ybar = obar + 16,
                 zbar = obar + 24;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kT, g = blockIdx.y;
  const size_t G = gridDim.y, gN = (size_t)g * N;
  const EwSlice sl(g, heads);
  const CUtensorMap& mq = sl.dir == 0 ? m2 : m1;
  const CUtensorMap& mk = sl.dir == 0 ? m1 : m2;
  const CUtensorMap& mox = kRows ? mq : mk;
  const CUtensorMap& mwx = kRows ? mk : mq;
  const int cox = (kRows ? 0 : C) + sl.h * kHeadDim;
  const int cwx = (kRows ? C : 0) + sl.h * kHeadDim;
  float* ost = (kRows ? qstats : kstats) + gN * 3;
  const float* wst = (kRows ? kstats : qstats) + gN * 3;
  const int nt = (N + kT - 1) / kT;

  // the walked tile at w0 into the raw boxes (thread 0)
  auto fetch = [&](int w0) {
    mbar_expect_tx(xbar, kF32Raw);
    tma_load(base + P::RX, mwx, xbar, cwx, w0, sl.b);
    mbar_expect_tx(ybar, P::kRawY);
    tma_load(base + P::RY, mwy, ybar, 0, w0, g);
    if (P::kZ) {
      mbar_expect_tx(zbar, P::kRawY);
      tma_load(base + P::RZ, mwz, zbar, 0, w0, g);
    }
  };
  if (tid == 0) {
    mbar_init(obar, 1);
    mbar_init(xbar, 1);
    mbar_init(ybar, 1);
    mbar_init(zbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the own rows land raw in the work pairs
    mbar_expect_tx(obar, kF32Raw + P::kRawY);
    tma_load(base + P::W1, mox, obar, cox, r0, sl.b);
    tma_load(base + P::W2, moy, obar, 0, r0, g);
    fetch(0);
  }

  // the own rows' statistics (benign values past N); keys' gamma (dual)
  // from its query-tile partials, summed in order, kept for pass c
  float om[2] = {0.f, 0.f}, ol[2] = {1.f, 1.f}, ored[2] = {0.f, 0.f};
  if (kOwnStats) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
      if (row < N) {
        om[half] = ost[(size_t)row * 3];
        ol[half] = ost[(size_t)row * 3 + 1];
        if constexpr (kGrad && kRows) {
          ored[half] = ost[(size_t)row * 3 + 2];
        } else if constexpr (kGrad) {
          float t = 0.f;
          for (int qt = 0; qt < nt; ++qt)
            t += gpart[((size_t)qt * G + g) * N + row];
          ored[half] = t;
          if ((lane & 3) == 0) ost[(size_t)row * 3 + 2] = t;
        }
      }
    }
  }
  mbar_wait(obar, 0);
  split_rows_w<kHeadDim, true>(sm + P::OX,
                               reinterpret_cast<const float*>(sm + P::W1));
  split_rows_w<KW, true>(sm + P::OY,
                         reinterpret_cast<const float*>(sm + P::W2));
  __syncthreads();  // the own raw rows are read before W1, W2 are written

  float s[8][4], d[8][4];
  float red[2] = {0.f, 0.f};
  float out1[8][4] = {}, out2[KW / 8][4] = {};
  unsigned fh[8][4], fl[8][4];
  for (int t = 0; t < nt; ++t) {
    const int w0 = t * kT;
    if (kWalkStats) {
      const int valid = 3 * min(kT, N - w0);
      for (int i = tid; i < 3 * kT; i += kThreads)
        cp_async4(WSs + i, wst + (size_t)w0 * 3 + (i < valid ? i : 0),
                  i < valid);
      cp_async_commit();
    }
    mbar_wait(xbar, t & 1);
    split_rows_w<kHeadDim, true>(sm + P::W1, rx);
    mbar_wait(ybar, t & 1);
    split_rows_w<KW, true>(sm + P::W2, ry);
    proxy_fence();
    __syncthreads();
    if (!kGrad && tid == 0 && t + 1 < nt) fetch(w0 + kT);
    wg_fence();
    gemm3_ss_d<kHeadDim>(s, base + P::OX, base + P::W1);
    gemm3_ss_d<KW>(d, base + P::OY, base + P::W2);
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(d);
    cp_async_wait<0>();
    __syncthreads();  // the products have read W1, W2; WSs has landed
    if constexpr (kGrad) {
      split_cols_w<kHeadDim, true>(sm + P::W1, rx);  // Xw^T
      if (P::kZ) mbar_wait(zbar, t & 1);
      split_cols_w<KW, true>(sm + P::W2, rz);        // Zw^T
      proxy_fence();
      __syncthreads();
      if (tid == 0 && t + 1 < nt) fetch(w0 + kT);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e), r = e >> 1;
        const float sv = __fmul_rn(s[ni][e], scale);
        const float dA = d[ni][e];
        float ds = 0.f, A = 0.f;
        if (w0 + j < N) {
          // own-side and walked-side normalized exps
          const float Po = kOwnStats ? exp2f(sv - om[r]) * ol[r] : 0.f;
          const float Pw =
              kWalkStats ? exp2f(sv - WSs[3 * j]) * WSs[3 * j + 1] : 0.f;
          const float R = kRows ? Po : Pw;
          const float Cm = kRows ? Pw : Po;
          if constexpr (!kGrad) {
            A = SINGLE ? dA * R : (dA * Cm) * R;  // W
            red[r] += A;
          } else {
            const float wred = kWalkStats ? WSs[3 * j + 2] : 0.f;
            const float rho = kRows ? ored[r] : wred;
            if (SINGLE) {
              ds = R * (dA - rho);
              A = R;
            } else {
              const float gam = kRows ? wred : ored[r];
              ds = R * (dA * Cm - rho) + Cm * (dA * R - gam);
              A = R * Cm;
            }
          }
        }
        s[ni][e] = ds * sigma;
        d[ni][e] = A;
      }
    if constexpr (kGammaPart) {
      // W's column sums over this query tile: the two rows of a thread,
      // the 8 row groups of a warp (butterfly), the 4 warps in order
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = d[ni][c] + d[ni][2 + c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) CSs[warp * kT + acc_col(ni, c)] = v;
        }
      __syncthreads();
      if (tid < kT && w0 + tid < N)
        gpart[((size_t)blockIdx.x * G + g) * N + w0 + tid] =
            ((CSs[tid] + CSs[kT + tid]) + CSs[2 * kT + tid]) +
            CSs[3 * kT + tid];
    }
    if constexpr (kGrad) {
      float p1[8][4], p2[KW / 8][4];
      split_frag(fh, fl, s);  // ds sigma
      wg_fence();
      gemm3_rs_n<kHeadDim>(p1, fh, fl, base + P::W1);
      wg_commit();
      wg_wait();
      fence_acc(p1);
      fence_frags(fh, fl);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out1[ni][e] = __fadd_rn(out1[ni][e], p1[ni][e]);
      split_frag(fh, fl, d);  // A
      wg_fence();
      gemm3_rs_n<KW>(p2, fh, fl, base + P::W2);
      wg_commit();
      wg_wait();
      fence_acc_n<KW>(p2);
      fence_frags(fh, fl);
#pragma unroll
      for (int ni = 0; ni < KW / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out2[ni][e] = __fadd_rn(out2[ni][e], p2[ni][e]);
    }
    __syncthreads();  // W1, W2, WSs and CSs are free for the next tile
  }

  if constexpr (!kGrad) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float t = quad_sum(red[half]);
      const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
      if (row < N && (lane & 3) == 0) ost[(size_t)row * 3 + 2] = t;
    }
    return;
  }
  // own rows' outputs; the slice's images in dqkv
  const EbSlice<float> es(in0, in1, ld, g, heads);
  const size_t C3 = 3 * (size_t)C;
  float* qout = dqkv + (es.qimg - in0);
  float* kout = dqkv + (es.kimg - in0);
  const int hc = sl.h * kHeadDim;
  float* dv = DVA + gN * E;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
    float* o1 = (kRows ? qout : kout) + (size_t)row * C3 + (kRows ? 0 : C) + hc;
    float* vk = kout + (size_t)row * C3 + 2 * C + hc;  // the key image's v
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put2(o1, acc_col(ni, 0), out1[ni][2 * half], out1[ni][2 * half + 1]);
#pragma unroll
    for (int ni = 0; ni < KW / 8; ++ni) {
      const int col = acc_col(ni, 0);
      if (col >= E) continue;
      float2 v = make_float2(out2[ni][2 * half], out2[ni][2 * half + 1]);
      float* dvrow = dv + (size_t)row * E + col;
      if (!kRows) {  // dvb, to scratch; with CROSS its v columns to v
        *reinterpret_cast<float2*>(dvrow) = v;
        if (CROSS && col < kHeadDim) put2(vk, col, v.x, v.y);
        continue;
      }
      // dva: with CROSS, its v columns to the query image's buffer
      if (CROSS && col < kHeadDim) {
        put2(dva_x, ((es.qimg - in0) / C3 + row) * C + hc + col, v.x, v.y);
        continue;
      }
      const float2 b = *reinterpret_cast<const float2*>(dvrow);
      v.x += b.x;  // dva + dvb, summed in fp32
      v.y += b.y;
      if (col < kHeadDim)
        put2(vk, col, v.x, v.y);
      else
        put2(dpos_part, (gN + row) * kEbPos + col - kHeadDim, v.x, v.y);
    }
  }
}

// ------------------------------------------------------------ launchers --
#define RP_TRY(call)                            \
  do {                                          \
    const cudaError_t rp_err_ = (call);         \
    if (rp_err_ != cudaSuccess) return rp_err_; \
  } while (0)

// 3-D tensor map of fp32 rows: dims (W columns, N rows, Z), rows at
// stride ld elements and the Z index at stride zs elements; W x 64 x 1
// boxes (a column offset picks a head), landing unswizzled; rows >= N read
// as zeros.  TMA needs a 16-byte aligned base and strides.
static cudaError_t map_rows_f32(CUtensorMap* map, const float* base, int W,
                                int box_w, int N, int Z, size_t ld,
                                size_t zs) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || ld % 4 || zs % 4)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)N, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(float),
                                 (cuuint64_t)zs * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)kT, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the qkv rows of one image of the B pairs: (B, N, 3C), pair b's at base
// + b bstride
static cudaError_t map_image(CUtensorMap* map, const float* base, int B,
                             int N, int C, size_t bstride) {
  return map_rows_f32(map, base, 3 * C, kHeadDim, N, B, 3 * (size_t)C,
                      bstride);
}

// G slices' (N, KW) scratch rows
static cudaError_t map_scratch(CUtensorMap* map, const float* base, int G,
                               int N, int KW) {
  return map_rows_f32(map, base, KW, KW, N, G, KW, (size_t)N * KW);
}

template <bool kKeyRows>
static cudaError_t launch_stats_wg(const CUtensorMap& m1,
                                   const CUtensorMap& m2, float* stats, int G,
                                   int N, int C, int heads,
                                   cudaStream_t st) {
  RP_TRY(smem_attr(ewg_stats_kernel<kKeyRows>, kStatsWgSmem));
  ewg_stats_kernel<kKeyRows><<<dim3((N + kT - 1) / kT, G), kThreads,
                               kStatsWgSmem, st>>>(m1, m2, stats, N, C, heads,
                                                   kEbScale);
  return cudaGetLastError();
}

// #2-#4's moments in fp32: G = 2 B heads slices of PairLayout; with kGroup
// (#9's s) each block of the moments kernel walks S slices (B % S == 0)
template <int E, bool SINGLE, bool CROSS, bool kGroup = false>
cudaError_t launch_moments_wg(const EbTcArgs<float>& a, cudaStream_t st,
                              int S = 1) {
  constexpr int KW = EbW<float, E>::kW;
  const int G = 2 * a.B * a.heads, N = a.N;
  if (G > 65535 || N <= 0 || a.ws == nullptr ||
      (kGroup && (S < 1 || a.B % S != 0)) || (!kGroup && S != 1))
    return cudaErrorInvalidValue;
  const EbFwdWs ws(a.ws, G, N, E, (int)sizeof(float));
  float* vbn = reinterpret_cast<float*>(ws.vbn);
  CUtensorMap m1, m2, mvb;
  RP_TRY(map_image(&m1, a.img1, a.B, N, a.C, a.bstride));
  RP_TRY(map_image(&m2, a.img2, a.B, N, a.C, a.bstride));
  RP_TRY(map_scratch(&mvb, vbn, G, N, KW));
  if constexpr (!SINGLE)
    RP_TRY(launch_stats_wg<true>(m1, m2, ws.kstats, G, N, a.C, a.heads, st));
  const size_t chunks = (size_t)G * N * (KW / 8);
  eb_vbn_kernel<PairLayout, E><<<(unsigned)((chunks + 255) / 256), 256, 0,
                                 st>>>(
      a.img1, a.img2, a.pos, (const float*)nullptr, a.bstride,
      SINGLE ? nullptr : ws.kstats, vbn, N, a.C, a.heads, G);
  RP_TRY(cudaGetLastError());
  constexpr size_t smem = moments_wg_smem<E>();
  auto kernel = ewg_moments_kernel<E, SINGLE, CROSS, kGroup>;
  RP_TRY(smem_attr(kernel, smem));
  const int nt = (N + kT - 1) / kT;
  kernel<<<dim3(nt, G / S), kThreads, smem, st>>>(
      m1, m2, mvb, a.img1, a.img2, a.bstride, a.pos, ws.kstats, ws.fpart, N,
      a.C, a.heads, S, kEbScale);
  RP_TRY(cudaGetLastError());
  const size_t L = (size_t)G * E * E;
  return launch_sum_partials(ws.fpart, nt, L, L, a.F, st);
}

// The backward's scratch beyond EbBwdWs: gamma's per-query-tile partials
// (ceil(N / 64) G N fp32)
static inline size_t bwd_wg_extra_bytes(int G, int N) {
  return eb_align(sizeof(float) * (size_t)((N + kT - 1) / kT) * G * N);
}

template <int E, bool kRows, bool kGrad, bool SINGLE, bool CROSS>
static cudaError_t launch_pass_wg(const CUtensorMap& m1,
                                  const CUtensorMap& m2,
                                  const CUtensorMap& mvb,
                                  const CUtensorMap& mvbdft,
                                  const CUtensorMap& mvadf,
                                  const EbbTcArgs<float>& a,
                                  const EbBwdWs& ws, float* gpart,
                                  cudaStream_t st) {
  using P = PassWg<E, kRows, kGrad>;
  auto kernel = ewg_pass_kernel<E, kRows, kGrad, SINGLE, CROSS>;
  RP_TRY(smem_attr(kernel, P::kSmem));
  const size_t img = (size_t)a.N * 3 * a.C;
  const int G = 2 * a.B * a.heads;
  kernel<<<dim3((a.N + kT - 1) / kT, G), kThreads, P::kSmem, st>>>(
      m1, m2, kRows ? mvadf : mvb, kRows ? mvb : mvadf, kRows ? mvbdft : mvadf,
      a.qkv, a.qkv + img, 2 * img, ws.qstats, ws.kstats, gpart, ws.dva,
      a.dqkv, a.dva, a.dpos_part, a.N, a.C, a.heads, kEbScale, 0.125f);
  return cudaGetLastError();
}

// #6 in fp32: G = 2 B heads slices of PairLayout, the images of pair b at
// qkv + (2 b + i) N 3C; ws holds EbBwdWs and then bwd_wg_extra_bytes
template <int E, bool SINGLE, bool CROSS>
cudaError_t launch_bwd_wg(const EbbTcArgs<float>& a, cudaStream_t st) {
  constexpr int KW = EbW<float, E>::kW;
  const int G = 2 * a.B * a.heads, N = a.N;
  if (G > 65535 || N <= 0 || a.ws == nullptr) return cudaErrorInvalidValue;
  const EbBwdWs ws(a.ws, G, N, E, true, (int)sizeof(float));
  float* gpart = reinterpret_cast<float*>(static_cast<unsigned char*>(a.ws) +
                                          ws.bytes);
  const EbBwdRows<float> r(ws);
  const size_t img = (size_t)N * 3 * a.C;
  CUtensorMap m1, m2, mvb, mvbdft, mvadf;
  RP_TRY(map_image(&m1, a.qkv, a.B, N, a.C, 2 * img));
  RP_TRY(map_image(&m2, a.qkv + img, a.B, N, a.C, 2 * img));
  RP_TRY(map_scratch(&mvb, r.vb, G, N, KW));
  RP_TRY(map_scratch(&mvbdft, r.vbdft, G, N, KW));
  RP_TRY(map_scratch(&mvadf, r.vadf, G, N, KW));
  RP_TRY(launch_stats_wg<false>(m1, m2, ws.qstats, G, N, a.C, a.heads, st));
  if constexpr (!SINGLE)
    RP_TRY(launch_stats_wg<true>(m1, m2, ws.kstats, G, N, a.C, a.heads, st));
  constexpr size_t psmem = prologue_smem_bytes<float, E>();
  auto prologue = eb_bwd_prologue_kernel<PairLayout, E, CROSS, float>;
  RP_TRY(smem_attr(prologue, psmem));
  const dim3 grid((N + kT - 1) / kT, G);
  prologue<<<grid, kThreads, psmem, st>>>(a.qkv, a.qkv + img, a.pos, nullptr,
                                          2 * img, a.dF, r.vb, r.vbdft,
                                          r.vadf, N, a.C, a.heads);
  RP_TRY(cudaGetLastError());
  // a. rho and (dual) gamma's partials; b. the key rows; c. the query rows
  RP_TRY((launch_pass_wg<E, true, false, SINGLE, CROSS>(
      m1, m2, mvb, mvbdft, mvadf, a, ws, gpart, st)));
  RP_TRY((launch_pass_wg<E, false, true, SINGLE, CROSS>(
      m1, m2, mvb, mvbdft, mvadf, a, ws, gpart, st)));
  return launch_pass_wg<E, true, true, SINGLE, CROSS>(m1, m2, mvb, mvbdft,
                                                      mvadf, a, ws, gpart,
                                                      st);
}

#undef RP_TRY

// X(E, SINGLE, CROSS) for the 4 fp32 variants of one e
#define RP_EW_VARIANTS(X, E) \
  X(E, false, false) X(E, false, true) X(E, true, false) X(E, true, true)

#define RP_EW_FWD_EXTERN(E, S, X)                                     \
  extern template cudaError_t launch_moments_wg<E, S, X>(            \
      const EbTcArgs<float>&, cudaStream_t, int);
#define RP_EW_FWD_INSTANTIATE(E, S, X)                                \
  template cudaError_t launch_moments_wg<E, S, X>(const EbTcArgs<float>&, \
                                                  cudaStream_t, int);
#define RP_EW_BWD_EXTERN(E, S, X)                                     \
  extern template cudaError_t launch_bwd_wg<E, S, X>(                \
      const EbbTcArgs<float>&, cudaStream_t);
#define RP_EW_BWD_INSTANTIATE(E, S, X)                                \
  template cudaError_t launch_bwd_wg<E, S, X>(const EbbTcArgs<float>&, \
                                              cudaStream_t);

}  // namespace wg
}  // namespace tc
}  // namespace rp

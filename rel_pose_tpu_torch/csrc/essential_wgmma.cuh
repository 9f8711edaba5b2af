// The Essential Matrix Module's moments and their backward in bf16 on
// Hopper's warpgroup tensor-core products (wgmma m64nNk16, bf16 in, fp32
// sums) with tiles brought by the Tensor Memory Accelerator (TMA): the bf16
// PairLayout body of
//   - #2 _essential_block_pair_kernel, #3 _essential_block_x_kernel and #4
//     _essential_block_kernel (rel_pose_tpu/ops/pallas_essential_block.py,
//     core _eb_combos :87): launch_moments_wb (essential_block.cu; its qkv
//     Linear on gemm_wgmma.cuh's forward, epilogue kRounded);
//   - #6 _essential_block_bwd_kernel
//     (rel_pose_tpu/ops/pallas_essential_block_bwd.py:35): launch_bwd_wb
//     (essential_block_bwd.cu);
//   - #9 _s_kernel (scripts/bench_cross.py:88): launch_moments_wb with
//     kGroup, each block of the moments kernel walking S slices in turn
//     (cross_variants.cu; fp32 s runs launch_moments_wg alike).
// #8 and #9's modes stay on the mma.sync body of essential_tc.cuh /
// essential_tc_bwd.cuh.  The function, the notation and the rounding points
// are essential_tc.cuh's and essential_tc_bwd.cuh's (T the rounding to
// bf16): P = T(er ec) with er, ec from the EXACT row and column maxima,
// vb_n = T(vb / lc), av = T((P vb_n) / lr), F = va^T av in fp32; nothing
// rounded to bf16 is rescaled online.
//
// Tiles.  q and k arrive as 64 x 64 boxes of 3-D tensor maps over each
// image's (B, N, 3C) qkv rows (columns h*64 and C + h*64; rows >= N load as
// zeros and never from the next image) in the 128-byte swizzle, read K-major
// by the score products and, as a gradient product's B, MN-major (the
// transpose bit).  The e-wide operands -- vb_n (72 columns for e = 70, 64 for
// e = 64) and the backward's VB, VBDFT, VADF (80 or 64: k16 steps over e) --
// are written by this body's own kernels into scratch in wgmma's
// unswizzled core-matrix order, one 64-row tile after another: 16-byte
// column c of row r of a tile at c * 1024 + r * 16, rows >= N zero.  One
// bulk copy (cp.async.bulk, the TMA unit's 1-D form) lands a tile, which a
// product reads K-major over e (LBO 1024 bytes between k8 columns, SBO 128
// between 8-row groups) or MN-major as an e-wide B (LBO 128 between 8-row
// groups of the sum index, SBO 1024 between 8-column groups): P vb_n at n =
// 72 reads nine columns, none padded (a 72-column row is 144 bytes, past
// the 128-byte swizzle span of one box).
//
// What bounds it on the H100: the products at 989 TFLOP/s -- per slice N^2
// 64 for the key statistics, N^2 64 + N^2 72 + N 80 72 forward; in the
// backward 2 N^2 64 of statistics, N^2 (64 + 80) for the rho / gamma pass
// and N^2 (128 + 80 + 72) in each gradient pass -- and the exp2 of every
// score (3.9 T/s): 2 a score forward (ec for lc, er and ec for P; 1 with the
// single softmax), 8 backward (2 statistics, 2 in each of three passes).
// The design:
//   forward (launch_moments_wb):
//     1. ewb_stats_kernel<keys, row maxima>, one warpgroup per (64-key tile,
//        slice), walking the query tiles through a 2-stage TMA ring, s^T = k
//        q^T: the online column statistics (mc, 1/lc) per key, and each
//        query's max over the block's 64 keys (the column max of s^T) to
//        a scratch of partials, one per (key tile, slice, query).  The
//        moments kernel merges them into the exact row max by fmaxf over
//        the key tiles: a max is exact in any order, so these are the bits
//        of a separate max walk over the same scores.  kEbSingle has no key
//        statistics: ewb_stats_kernel<queries, max only> walks the key tiles
//        and writes each query's exact max (no exp2);
//     2. ewb_vbn_kernel: vb_n = T(vb / lc) (kEbSingle: vb) into core-matrix
//        tiles;
//     3. ewb_moments_kernel, one warpgroup per (64-query tile, slice), ONE
//        walk over the key tiles through a 2-stage ring (k by TMA, vb_n by
//        bulk copy; tile t + 2 is issued once tile t's products are done,
//        so tile t + 1's loads run during tile t's softmax): s = q k^T,
//        er and ec against the final maxima, P = T(er ec) rounded in
//        registers as register A of P vb_n (m64n72k16, vb_n MN-major), lr
//        summed; then av = T(o / lr) and the tile's F partial va^T av on
//        mma.sync (essential_tc.cuh's: va's 80 rows in five m16 tiles,
//        wgmma's M is 64);
//     4. launch_sum_partials adds the query tiles' partials in order.
//   backward (launch_bwd_wb), in essential_wgmma_f32.cuh's order:
//     ewb_stats_kernel for the queries and (dual) the keys,
//     essential_tc_bwd.cuh's prologue (VB, VBDFT = T(vb T(dF)^T), VADF =
//     T(va T(dF))) writing core-matrix tiles, then ewb_pass_kernel over (own
//     64-row tile, walked tile) pairs, s = X Xw^T and d = Y Yw^T (dA or
//     dA^T, 80 deep) from shared memory:
//     a. rows = queries, REDUCE: W = (dA Cm) R (SINGLE dA R); rho = W's row
//        sums, whole, and (dual) gamma's per-query-tile partials = W's
//        column sums over the tile's 64 queries, to scratch;
//     b. rows = keys, GRAD: gamma = its partials summed in query-tile order,
//        ds^T and A^T; dk += T(ds sigma)^T q, dvb += T(A)^T vadf;
//     c. rows = queries, GRAD: ds and A; dq += T(ds sigma) k, dva += T(A)
//        vbdft.
//     The gradient products take T(ds sigma) and T(A) from registers and
//     the walked tiles MN-major: no tile is copied or split again.  6
//     launches (5 with the single softmax).
// PairLayout's outputs keep the scatter of essential_tc_bwd.cuh with b
// before c, as essential_wgmma_f32.cuh does: pass b writes dvb in fp32 to
// scratch (with CROSS also T(dvb) to the key image's v slot), pass c adds
// it to dva in fp32 (dv = T(dva + dvb), the bits of T(dvb + dva)), or with
// CROSS writes T(dva) to the query image's (B, 2, N, C) buffer; the
// positional columns go to dpos_part.  Keys >= N are masked out of every max
// and sum.  No atomics, sums in a fixed order: two calls give the same bits,
// and a slice's F does not depend on S.

#pragma once

#include "essential_wgmma_f32.cuh"

namespace rp {
namespace tc {
namespace wg {

// ------------------------------------------------------------- tiles --
constexpr int kCore = kT * 16;  // one 16-byte column of a 64-row tile

// The e-wide operands of e = 70 or 64: kN columns where e is a product's
// n (P vb_n, dva, dvb), kD where it is a depth (dA = vadf vb^T: k16 steps);
// their tiles' bytes in core-matrix order
__host__ __device__ constexpr int ewb_n(int E) {
  return E == kHeadDim ? kHeadDim : 72;
}

template <int E>
struct EwbW {
  static constexpr int kN = ewb_n(E);
  static constexpr int kD = EbW<bf16, E>::kW;  // 80 or 64
  static constexpr int kVbnTile = kN / 8 * kCore;
  static constexpr int kRowTile = kD / 8 * kCore;
};

// the descriptor of an unswizzled core-matrix operand: lbo, sbo in bytes
__device__ __forceinline__ uint64_t desc_core(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// K-major over e (the tile's rows M or N, its columns the sum index): k8
// columns kCore apart, 8-row groups 128; a k16 step is two columns
__device__ __forceinline__ uint64_t desc_e_kmajor(uint32_t addr) {
  return desc_core(addr, kCore, 128);
}
constexpr int kStepE = 2 * kCore / 16;  // in 16-byte units
// MN-major (the tile's rows the sum index, its columns N): 8-row groups 128
// bytes apart, 8-column groups kCore; a k16 step is two row groups
__device__ __forceinline__ uint64_t desc_e_mnmajor(uint32_t addr) {
  return desc_core(addr, 128, kCore);
}
constexpr int kStepMNE = 2 * 128 / 16;

// `bytes` from global src to shared dst by the TMA unit's bulk copy,
// completing on bar (16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------- products --
#define RP_EB4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d += A . B over one k16 step at n = 72: A register fragments (a rounded
// score tile), B an MN-major tile (the transpose bit)
__device__ __forceinline__ void mma_rs72(float (&d)[9][4],
                                         const unsigned (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, "
      "1, 1, 1, 1;\n"
      : RP_EB4(d, 0), RP_EB4(d, 1), RP_EB4(d, 2), RP_EB4(d, 3), RP_EB4(d, 4),
        RP_EB4(d, 5), RP_EB4(d, 6), RP_EB4(d, 7), RP_EB4(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef RP_EB4

// d += T(p) . B, p a rounded 64 x 64 score tile as register A, B the
// core-matrix tile of NN columns (64 or 72) whose rows are the sum index
// (issued, not waited for)
template <int NN>
__device__ __forceinline__ void gemm_pe(float (&d)[NN / 8][4],
                                        const unsigned (&p)[4][4],
                                        uint32_t b) {
  static_assert(NN == 64 || NN == 72, "n = 64 or 72");
  const uint64_t db = desc_e_mnmajor(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NN == 72)
      mma_rs72(d, p[kk], db + kk * kStepMNE);
    else
      mma_rs(d, p[kk], db + kk * kStepMNE);
  }
}

// d = A . B^T over the D-deep rows of two core-matrix tiles of 64 rows
// (issued, not waited for)
template <int D>
__device__ __forceinline__ void gemm_ee(float (&d)[8][4], uint32_t a,
                                        uint32_t b) {
  const uint64_t da = desc_e_kmajor(a), db = desc_e_kmajor(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss(d, da + kk * kStepE, db + kk * kStepE, kk > 0);
}

// ------------------------------------------------------------ the maps --
// 3-D tensor map of one image's bf16 qkv rows of B pairs: dims (3C columns,
// N rows, B), pair b's at base + b bstride; 64 x 64 boxes in the 128-byte
// swizzle; rows >= N read as zeros.  TMA needs a 16-byte aligned base and
// strides.
static cudaError_t map_image_bf16(CUtensorMap* map, const bf16* base, int B,
                                  int N, int C, size_t bstride) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const size_t ld = 3 * (size_t)C;
  if (reinterpret_cast<uintptr_t>(base) % 16 || ld % 8 || bstride % 8)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(bf16),
                                 (cuuint64_t)bstride * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kHeadDim, (cuuint32_t)kT, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<bf16*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------ statistics --
// Per row of the own side (keys with kKeyRows: the column statistics of s;
// queries: its row statistics), the max m of its scores over the other
// side and (kSum) 1 / sum exp2(s - m), to stats[(g N + row) * 3] and [.. +
// 1] (slot 2 is the backward's); with kRowMax (keys) also each walked
// query's max over the block's keys to rpart[(blockIdx.x G + g) N + query].
// The own 64 rows and the other side's tiles (a 2-stage ring) land by TMA;
// s = X Xw^T on wgmma from shared memory; the sum is online (rescaled when
// the max grows).
constexpr size_t kStatsWbSmem = 3 * kTileBytes + 4 * kT * 4 + 8 * 3 + kAlign;

template <bool kKeyRows, bool kRowMax, bool kSum>
__global__ void __launch_bounds__(kThreads)
ewb_stats_kernel(const __grid_constant__ CUtensorMap m1,
                 const __grid_constant__ CUtensorMap m2,
                 float* __restrict__ stats, float* __restrict__ rpart, int N,
                 int C, int heads, float scale) {
  static_assert(kKeyRows || !kRowMax, "row maxima from the key walk");
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t Xs = smem_u32(sm);
  const auto Ws = [&](int st) { return Xs + (1 + st) * kTileBytes; };
  float* CSs = reinterpret_cast<float*>(sm + 3 * kTileBytes);
  const uint32_t obar = Xs + 3 * kTileBytes + 4 * kT * 4;
  const auto full = [&](int st) { return obar + 8 * (1 + st); };
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
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(obar, kTileBytes);
    tma_load(Xs, mo, obar, co, r0, sl.b);
    for (int j = 0; j < 2 && j < nt; ++j) {
      mbar_expect_tx(full(j), kTileBytes);
      tma_load(Ws(j), mw, full(j), cw, j * kT, sl.b);
    }
  }
  // the own rows past N, masked out of the walked rows' maxima
  bool own_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    own_ok[half] = r0 + warp * 16 + (lane >> 2) + half * 8 < N;
  mbar_wait(obar, 0);

  float s[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const size_t G = gridDim.y;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1, c0 = t * kT;
    mbar_wait(full(st), (t >> 1) & 1);
    wg_fence();
    gemm_abt(s, Xs, Ws(st));
    wg_commit();
    wg_wait();
    fence_acc(s);
    __syncthreads();  // every warp's products have read stage st
    if (tid == 0 && t + 2 < nt) {
      mbar_expect_tx(full(st), kTileBytes);
      tma_load(Ws(st), mw, full(st), cw, c0 + 2 * kT, sl.b);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = c0 + acc_col(ni, e) < N ? __fmul_rn(s[ni][e], scale)
                                           : -INFINITY;
    if constexpr (kRowMax) {
      // the tile's column maxima over the own rows: the two rows of a
      // thread, the 8 row groups of a warp (butterfly), the 4 warps
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = fmaxf(own_ok[0] ? s[ni][c] : -INFINITY,
                          own_ok[1] ? s[ni][2 + c] : -INFINITY);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (lane < 4) CSs[warp * kT + acc_col(ni, c)] = v;
        }
      __syncthreads();
      if (tid < kT && c0 + tid < N)
        rpart[((size_t)blockIdx.x * G + g) * N + c0 + tid] =
            fmaxf(fmaxf(CSs[tid], CSs[kT + tid]),
                  fmaxf(CSs[2 * kT + tid], CSs[3 * kT + tid]));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) mt = fmaxf(mt, s[ni][e]);
      if (!kSum) {
        m[half] = fmaxf(m[half], mt);
        continue;
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
  float* sr = stats + (size_t)g * N * 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float M = quad_max(m[half]);
    const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
    float L = 0.f;
    if (kSum) L = quad_sum(l[half] * exp2f(m[half] - M));
    if (row < N && (lane & 3) == 0) {
      sr[(size_t)row * 3] = M;
      if (kSum) sr[(size_t)row * 3 + 1] = 1.f / L;
    }
  }
}

// -------------------------------------------------------------- vb_n --
// vb_n = T(vb (1/lc)) (kstats NULL: vb) of G slices in core-matrix tiles of
// kN columns: 16-byte column c of row r of key tile tt of slice g at
// vbn[(((g nt + tt) kN / 8 + c) 64 + r) 8]; rows >= N and columns >= e zero.
// One thread per 8 columns of a row.
template <int E>
__global__ void __launch_bounds__(256)
ewb_vbn_kernel(const bf16* __restrict__ img1, const bf16* __restrict__ img2,
               const bf16* __restrict__ pos, size_t bstride,
               const float* __restrict__ kstats, bf16* __restrict__ vbn,
               int N, int C, int heads, int G) {
  constexpr int KC = EwbW<E>::kN / 8;
  const int nt = (N + kT - 1) / kT;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)G * nt * KC * kT) return;
  const int r = (int)(i % kT);
  size_t rest = i / kT;
  const int c = (int)(rest % KC);
  rest /= KC;
  const int tt = (int)(rest % nt), g = (int)(rest / nt);
  const int n = tt * kT + r;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (n < N) {
    const EbView<bf16> vw = PairLayout::view<E, false>(img1, img2, pos,
                                                       bstride, N, C, heads,
                                                       g);
    float x[8];
    PairLayout::vb8<E>(vw, n, c, x);
    if (kstats != nullptr) {
      const float inv = kstats[((size_t)g * N + n) * 3 + 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] *= inv;
    }
    out = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
  *reinterpret_cast<uint4*>(vbn + i * 8) = out;
}

// ------------------------------------------------------------- moments --
// The partial F = va^T av of 64 query rows of slice g to fpart[(blockIdx.x
// G + g) E^2], in one walk over the key tiles.  The exact row max of query
// row i is max over p < rparts of rmax[((p G + g) N + i) rstride].  Block
// row y takes slice y, or with kGroup the S slices PairLayout::slice(y, 0
// .. S - 1) in turn (#9's s), each with the same arithmetic.  Shared
// memory: q, the k ring, the vb_n ring, va's tile (mma.sync's padded rows),
// the barriers; av goes over the k ring after the walk.
template <int E>
constexpr size_t moments_wb_smem() {
  return 3 * kTileBytes + 2 * EwbW<E>::kVbnTile +
         EbW<bf16, E>::kTileElems * sizeof(bf16) + 8 * 3 + kAlign;
}

template <int E, bool SINGLE, bool CROSS, bool kGroup>
__global__ void __launch_bounds__(kThreads)
ewb_moments_kernel(const __grid_constant__ CUtensorMap m1,
                   const __grid_constant__ CUtensorMap m2,
                   const bf16* __restrict__ img1,
                   const bf16* __restrict__ img2, size_t bstride,
                   const bf16* __restrict__ pos,
                   const bf16* __restrict__ vbn,
                   const float* __restrict__ kstats,
                   const float* __restrict__ rmax, int rparts, int rstride,
                   float* __restrict__ fpart, int N, int C, int heads, int S,
                   float scale) {
  using W = EbW<bf16, E>;
  using V = EwbW<E>;
  constexpr int NN = V::kN;
  static_assert(2 * kTileBytes >= W::kTileElems * (int)sizeof(bf16),
                "av fits the k ring");
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t Qs = smem_u32(sm);
  const auto Ks = [&](int st) { return Qs + (1 + st) * kTileBytes; };
  const auto Vs = [&](int st) {
    return Qs + 3 * kTileBytes + st * V::kVbnTile;
  };
  bf16* VAs = reinterpret_cast<bf16*>(sm + 3 * kTileBytes + 2 * V::kVbnTile);
  bf16* AVs = reinterpret_cast<bf16*>(sm + kTileBytes);
  const uint32_t qbar = smem_u32(VAs + W::kTileElems);
  const auto full = [&](int st) { return qbar + 8 * (1 + st); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT;
  const int nk = (N + kT - 1) / kT;
  const int per_block = kGroup ? S : 1;
  const size_t G = (size_t)gridDim.y * per_block;
  constexpr int kTileE = V::kVbnTile / (int)sizeof(bf16);

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int it = 0;  // key tiles walked by this block: the ring's phase
#pragma unroll 1
  for (int si = 0; si < per_block; ++si) {
    const int g =
        kGroup ? PairLayout::slice(blockIdx.y, si, S, heads) : blockIdx.y;
    const EwSlice sl(g, heads);
    const CUtensorMap& mq = sl.dir == 0 ? m2 : m1;
    const CUtensorMap& mk = sl.dir == 0 ? m1 : m2;
    const int qc = sl.h * kHeadDim, kc = C + sl.h * kHeadDim;
    const bf16* vt = vbn + (size_t)g * nk * kTileE;
    const float* ks = kstats + (size_t)g * N * 3;
    if (si > 0) {  // the last slice's reads of the rings and of va are done
      proxy_fence();
      __syncthreads();
    }
    if (tid == 0) {
      mbar_expect_tx(qbar, kTileBytes);
      tma_load(Qs, mq, qbar, qc, q0, sl.b);
      for (int j = 0; j < 2 && j < nk; ++j) {
        const int st = (it + j) & 1;
        mbar_expect_tx(full(st), kTileBytes + V::kVbnTile);
        tma_load(Ks(st), mk, full(st), kc, j * kT, sl.b);
        bulk_load(Vs(st), vt + (size_t)j * kTileE, V::kVbnTile, full(st));
      }
    }
    const EbView<bf16> vw = PairLayout::view<E, CROSS>(img1, img2, pos,
                                                       bstride, N, C, heads,
                                                       g);
    PairLayout::load_v<E>(VAs, vw.va, vw, q0, N);
    cp_async_commit();
    // the exact row maxima, merged from the statistics' partials
    float mx[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
      float v = -INFINITY;
      if (row < N)
        for (int p = 0; p < rparts; ++p)
          v = fmaxf(v, __ldg(rmax + (((size_t)p * G + g) * N + row) *
                                        rstride));
      mx[half] = row < N ? v : 0.f;
    }
    mbar_wait(qbar, si & 1);

    float o[NN / 8][4] = {}, s[8][4];
    float l[2] = {0.f, 0.f};
    for (int t = 0; t < nk; ++t, ++it) {
      const int st = it & 1, k0 = t * kT;
      mbar_wait(full(st), (it >> 1) & 1);
      wg_fence();
      gemm_abt(s, Qs, Ks(st));  // s = q . k^T
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
      wg_wait();
      fence_acc(s);
      // P = T(er ec) (SINGLE: T(er)), masked keys 0
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = 0.f;
          if (k0 + acc_col(ni, e) < N) {
            const float sv = __fmul_rn(s[ni][e], scale);
            const float er = exp2f(sv - mx[e >> 1]);
            l[e >> 1] += er;
            p = SINGLE ? er : er * exp2f(sv - mc[ni][e & 1]);
          }
          s[ni][e] = p;
        }
      unsigned pf[4][4];
      to_afrag(pf, s);
      fence_acc_n<NN>(o);
      wg_fence();
      gemm_pe<NN>(o, pf, Vs(st));  // o += P vb_n
      wg_commit();
      wg_wait();
      fence_acc_n<NN>(o);
      fence_frag(pf);
      __syncthreads();  // every warp's products have read stage st
      if (tid == 0 && t + 2 < nk) {
        mbar_expect_tx(full(st), kTileBytes + V::kVbnTile);
        tma_load(Ks(st), mk, full(st), kc, k0 + 2 * kT, sl.b);
        bulk_load(Vs(st), vt + (size_t)(t + 2) * kTileE, V::kVbnTile,
                  full(st));
      }
    }

    // av = T(o / lr) over the k ring, then F = va^T av on mma.sync (va read
    // along its rows: the M-major A operand), m16 tiles of e1 over the warps
    cp_async_wait<0>();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float inv = 1.f / quad_sum(l[half]);
      const int r = warp * 16 + (lane >> 2) + half * 8;
      const bool ok = q0 + r < N;
#pragma unroll
      for (int ni = 0; ni < NN / 8; ++ni)
        store2(AVs + r * W::kLd + acc_col(ni, 0), ok ? o[ni][2 * half] * inv
                                                     : 0.f,
               ok ? o[ni][2 * half + 1] * inv : 0.f);
    }
    __syncthreads();
    float* fp = fpart + ((size_t)blockIdx.x * G + g) * E * E;
    for (int mt = warp; mt < W::kM16; mt += kThreads / 32) {
      float f[W::kNT][4];
      unsigned af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4_t(af[kk], VAs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                                    W::kLd +
                              mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int ni = 0; ni < W::kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[ni][e] = 0.f;
      mma_ab_acc<W::kNT, 4, W::kLd>(f, af, AVs);
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
// One pass over the (own 64-row tile, walked tile) pairs of slice g, as
// essential_wgmma_f32.cuh's ewg_pass_kernel: own rows are queries with
// kRows (X = q, Y = vadf; walked Xw = k, Yw = vb, Zw = vbdft), keys without
// (X = k, Y = vb; walked Xw = q, Yw = Zw = vadf); each side's statistics
// (m, 1/l, reduction) per row at [(g N + row) * 3].  Per tile: s = X Xw^T
// (scaled) and d = Y Yw^T; then REDUCE (pass a) sums rho and gamma's
// partials, GRAD (b, c) adds T(ds sigma) Xw to out1 and T(A) Zw to out2.
// Shared memory: the own X and Y tiles, a 2-stage ring of walked (Xw, Yw
// and, rows = queries with GRAD, Zw) tiles, the walked statistics, gamma's
// column sums, the barriers.
template <int E, bool kRows, bool kGrad>
struct PassWb {
  static constexpr bool kZ = kRows && kGrad;  // a Zw tile of its own
  static constexpr int kY = EwbW<E>::kRowTile;
  static constexpr int kStage = kTileBytes + (kZ ? 2 : 1) * kY;
  static constexpr int OX = 0, OY = kTileBytes, RING = OY + kY,
                       WS = RING + 2 * kStage, CS = WS + 2 * 3 * kT * 4,
                       BAR = CS + (kGrad ? 0 : 4 * kT * 4);
  static constexpr size_t kSmem = BAR + 8 * 3 + kAlign;
  static_assert(RING % 1024 == 0 && kStage % 1024 == 0,
                "swizzled tiles on 1024-byte atoms");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

template <int E, bool kRows, bool kGrad, bool SINGLE, bool CROSS>
__global__ void __launch_bounds__(kThreads)
ewb_pass_kernel(const __grid_constant__ CUtensorMap m1,
                const __grid_constant__ CUtensorMap m2,
                const bf16* __restrict__ OY, const bf16* __restrict__ WY,
                const bf16* __restrict__ WZ, const bf16* __restrict__ in0,
                const bf16* __restrict__ in1, size_t ld,
                float* __restrict__ qstats, float* __restrict__ kstats,
                float* __restrict__ gpart, float* __restrict__ DVA,
                bf16* __restrict__ dqkv, bf16* __restrict__ dva_x,
                float* __restrict__ dpos_part, int N, int C, int heads,
                float scale, float sigma) {
  static_assert(kRows || kGrad, "REDUCE runs over the query rows");
  using P = PassWb<E, kRows, kGrad>;
  constexpr int NN = EwbW<E>::kN, KD = EwbW<E>::kD;
  constexpr int kTileE = P::kY / (int)sizeof(bf16);
  // with SINGLE only the query side has statistics
  constexpr bool kOwnStats = !SINGLE || kRows;
  constexpr bool kWalkStats = !SINGLE || !kRows;
  constexpr bool kGammaPart = !kGrad && !SINGLE;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t base = smem_u32(sm);
  const auto WX = [&](int st) { return base + P::RING + st * P::kStage; };
  const auto WYs = [&](int st) { return WX(st) + kTileBytes; };
  const auto WZs = [&](int st) { return WYs(st) + (P::kZ ? P::kY : 0); };
  float* WSs = reinterpret_cast<float*>(sm + P::WS);
  float* CSs = reinterpret_cast<float*>(sm + P::CS);
  const uint32_t obar = base + P::BAR;
  const auto full = [&](int st) { return obar + 8 * (1 + st); };
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
  const bf16* oy = OY + ((size_t)g * nt + blockIdx.x) * kTileE;
  const bf16* wy = WY + (size_t)g * nt * kTileE;
  const bf16* wz = WZ + (size_t)g * nt * kTileE;

  // walked tile w into stage st (thread 0)
  auto issue = [&](int w, int st) {
    mbar_expect_tx(full(st), P::kStage);
    tma_load(WX(st), mwx, full(st), cwx, w * kT, sl.b);
    bulk_load(WYs(st), wy + (size_t)w * kTileE, P::kY, full(st));
    if (P::kZ) bulk_load(WZs(st), wz + (size_t)w * kTileE, P::kY, full(st));
  };
  // the walked tile w's statistics into buffer b, zero past N
  auto load_stats = [&](int w, int b) {
    const int w0 = w * kT, valid = 3 * min(kT, N - w0);
    for (int i = tid; i < 3 * kT; i += kThreads)
      cp_async4(WSs + b * 3 * kT + i, wst + (size_t)w0 * 3 +
                                          (i < valid ? i : 0),
                i < valid);
    cp_async_commit();
  };
  if (tid == 0) {
    mbar_init(obar, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(obar, kTileBytes + P::kY);
    tma_load(base + P::OX, mox, obar, cox, r0, sl.b);
    bulk_load(base + P::OY, oy, P::kY, obar);
    issue(0, 0);
    if (nt > 1) issue(1, 1);
  }
  if (kWalkStats) load_stats(0, 0);

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

  float s[8][4], d[8][4];
  float red[2] = {0.f, 0.f};
  float out1[8][4] = {}, out2[NN / 8][4] = {};
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1, w0 = t * kT;
    if (kWalkStats) cp_async_wait<0>();
    __syncthreads();  // stage st ^ 1 and its statistics are free; WSs landed
    if (tid == 0 && t >= 1 && t + 1 < nt) issue(t + 1, st ^ 1);
    if (kWalkStats && t + 1 < nt) load_stats(t + 1, st ^ 1);
    const float* ws = WSs + st * 3 * kT;
    mbar_wait(full(st), (t >> 1) & 1);
    wg_fence();
    gemm_abt(s, base + P::OX, WX(st));
    gemm_ee<KD>(d, base + P::OY, WYs(st));
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(d);
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
              kWalkStats ? exp2f(sv - ws[3 * j]) * ws[3 * j + 1] : 0.f;
          const float R = kRows ? Po : Pw;
          const float Cm = kRows ? Pw : Po;
          if constexpr (!kGrad) {
            A = SINGLE ? dA * R : (dA * Cm) * R;  // W
            red[r] += A;
          } else {
            const float wred = kWalkStats ? ws[3 * j + 2] : 0.f;
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
      unsigned dsf[4][4], abf[4][4];
      to_afrag(dsf, s);  // T(ds sigma)
      to_afrag(abf, d);  // T(A)
      fence_acc(out1);
      fence_acc_n<NN>(out2);
      wg_fence();
      gemm_pb(out1, dsf, WX(st));
      gemm_pe<NN>(out2, abf, WZs(st));
      wg_commit();
      wg_wait();
      fence_acc(out1);
      fence_acc_n<NN>(out2);
      fence_frag(dsf);
      fence_frag(abf);
    }
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
  const EbSlice<bf16> es(in0, in1, ld, g, heads);
  const size_t C3 = 3 * (size_t)C;
  bf16* qout = dqkv + (es.qimg - in0);
  bf16* kout = dqkv + (es.kimg - in0);
  const int hc = sl.h * kHeadDim;
  float* dv = DVA + gN * E;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
    bf16* o1 = (kRows ? qout : kout) + (size_t)row * C3 + (kRows ? 0 : C) + hc;
    bf16* vk = kout + (size_t)row * C3 + 2 * C + hc;  // the key image's v
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      store2(o1 + acc_col(ni, 0), out1[ni][2 * half], out1[ni][2 * half + 1]);
#pragma unroll
    for (int ni = 0; ni < NN / 8; ++ni) {
      const int col = acc_col(ni, 0);
      if (col >= E) continue;
      float2 v = make_float2(out2[ni][2 * half], out2[ni][2 * half + 1]);
      float* dvrow = dv + (size_t)row * E + col;
      if (!kRows) {  // dvb, to scratch; with CROSS T(dvb) to v
        *reinterpret_cast<float2*>(dvrow) = v;
        if (CROSS && col < kHeadDim) store2(vk + col, v.x, v.y);
        continue;
      }
      // dva: with CROSS, T(dva) of its v columns to the query image's buffer
      if (CROSS && col < kHeadDim) {
        store2(dva_x + ((es.qimg - in0) / C3 + row) * C + hc + col, v.x, v.y);
        continue;
      }
      const float2 b = *reinterpret_cast<const float2*>(dvrow);
      v.x += b.x;  // dva + dvb, summed in fp32
      v.y += b.y;
      if (col < kHeadDim)
        store2(vk + col, v.x, v.y);
      else
        *reinterpret_cast<float2*>(dpos_part + (gN + row) * kEbPos + col -
                                   kHeadDim) = v;
    }
  }
}

// ---------------------------------------------------------- workspace --
// Scratch of the forward, in this order, each piece 256-byte aligned: the
// key statistics (kEbSingle: the query maxima; G N x 3 fp32), vb_n's tiles
// (G ceil(N / 64) tiles of ewb_n(E) / 8 core-matrix columns, bf16), the row
// maxima's partials (ceil(N / 64) G N fp32), the F partials (ceil(N / 64)
// G E^2 fp32).
struct EwbFwdWs {
  float* kstats;
  bf16* vbn;
  float* rpart;
  float* fpart;
  size_t bytes;
  EwbFwdWs(void* base, int G, int N, int E) {
    const size_t nt = (N + kT - 1) / kT;
    const uintptr_t p = reinterpret_cast<uintptr_t>(base);
    size_t o = 0;
    kstats = reinterpret_cast<float*>(p + o);
    o += eb_align(sizeof(float) * (size_t)G * N * 3);
    vbn = reinterpret_cast<bf16*>(p + o);
    o += eb_align((size_t)G * nt * (ewb_n(E) / 8) * kCore);
    rpart = reinterpret_cast<float*>(p + o);
    o += eb_align(sizeof(float) * nt * G * N);
    fpart = reinterpret_cast<float*>(p + o);
    o += eb_align(sizeof(float) * nt * G * E * E);
    bytes = o;
  }
};

// ------------------------------------------------------------ launchers --
#define RP_TRY(call)                            \
  do {                                          \
    const cudaError_t rp_err_ = (call);         \
    if (rp_err_ != cudaSuccess) return rp_err_; \
  } while (0)

template <bool kKeyRows, bool kRowMax, bool kSum>
static cudaError_t launch_stats_wb(const CUtensorMap& m1,
                                   const CUtensorMap& m2, float* stats,
                                   float* rpart, int G, int N, int C,
                                   int heads, cudaStream_t st) {
  auto kernel = ewb_stats_kernel<kKeyRows, kRowMax, kSum>;
  RP_TRY(smem_attr(kernel, kStatsWbSmem));
  kernel<<<dim3((N + kT - 1) / kT, G), kThreads, kStatsWbSmem, st>>>(
      m1, m2, stats, rpart, N, C, heads, kEbScale);
  return cudaGetLastError();
}

// #2-#4's moments in bf16: G = 2 B heads slices of PairLayout; with kGroup
// (#9's s) each block of the moments kernel walks S slices (B % S == 0)
template <int E, bool SINGLE, bool CROSS, bool kGroup = false>
cudaError_t launch_moments_wb(const EbTcArgs<bf16>& a, cudaStream_t st,
                              int S = 1) {
  const int G = 2 * a.B * a.heads, N = a.N;
  if (G > 65535 || N <= 0 || a.ws == nullptr ||
      (kGroup && (S < 1 || a.B % S != 0)) || (!kGroup && S != 1))
    return cudaErrorInvalidValue;
  const EwbFwdWs ws(a.ws, G, N, E);
  const int nt = (N + kT - 1) / kT;
  CUtensorMap m1, m2;
  RP_TRY(map_image_bf16(&m1, a.img1, a.B, N, a.C, a.bstride));
  RP_TRY(map_image_bf16(&m2, a.img2, a.B, N, a.C, a.bstride));
  if constexpr (SINGLE)  // the query maxima
    RP_TRY((launch_stats_wb<false, false, false>(m1, m2, ws.kstats, nullptr,
                                                 G, N, a.C, a.heads, st)));
  else  // the key statistics and the row maxima's partials
    RP_TRY((launch_stats_wb<true, true, true>(m1, m2, ws.kstats, ws.rpart, G,
                                              N, a.C, a.heads, st)));
  const size_t chunks = (size_t)G * nt * (EwbW<E>::kN / 8) * kT;
  ewb_vbn_kernel<E><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      a.img1, a.img2, a.pos, a.bstride, SINGLE ? nullptr : ws.kstats, ws.vbn,
      N, a.C, a.heads, G);
  RP_TRY(cudaGetLastError());
  constexpr size_t smem = moments_wb_smem<E>();
  auto kernel = ewb_moments_kernel<E, SINGLE, CROSS, kGroup>;
  RP_TRY(smem_attr(kernel, smem));
  kernel<<<dim3(nt, G / S), kThreads, smem, st>>>(
      m1, m2, a.img1, a.img2, a.bstride, a.pos, ws.vbn, ws.kstats,
      SINGLE ? ws.kstats : ws.rpart, SINGLE ? 1 : nt, SINGLE ? 3 : 1,
      ws.fpart, N, a.C, a.heads, S, kEbScale);
  RP_TRY(cudaGetLastError());
  const size_t L = (size_t)G * E * E;
  return launch_sum_partials(ws.fpart, nt, L, L, a.F, st);
}

// The backward's scratch: EbBwdWs with its rows in core-matrix tiles, then
// gamma's per-query-tile partials (bwd_wg_extra_bytes)
static inline size_t bwd_wb_bytes(int G, int N, int E) {
  return EbBwdWs(nullptr, G, N, E, true, 2, true).bytes +
         bwd_wg_extra_bytes(G, N);
}

template <int E, bool kRows, bool kGrad, bool SINGLE, bool CROSS>
static cudaError_t launch_pass_wb(const CUtensorMap& m1,
                                  const CUtensorMap& m2,
                                  const EbbTcArgs<bf16>& a,
                                  const EbBwdWs& ws, float* gpart,
                                  cudaStream_t st) {
  using P = PassWb<E, kRows, kGrad>;
  auto kernel = ewb_pass_kernel<E, kRows, kGrad, SINGLE, CROSS>;
  RP_TRY(smem_attr(kernel, P::kSmem));
  const EbBwdRows<bf16> r(ws);
  const size_t img = (size_t)a.N * 3 * a.C;
  const int G = 2 * a.B * a.heads;
  kernel<<<dim3((a.N + kT - 1) / kT, G), kThreads, P::kSmem, st>>>(
      m1, m2, kRows ? r.vadf : r.vb, kRows ? r.vb : r.vadf,
      kRows ? r.vbdft : r.vadf, a.qkv, a.qkv + img, 2 * img, ws.qstats,
      ws.kstats, gpart, ws.dva, a.dqkv, a.dva, a.dpos_part, a.N, a.C,
      a.heads, kEbScale, 0.125f);
  return cudaGetLastError();
}

// #6 in bf16: G = 2 B heads slices of PairLayout, the images of pair b at
// qkv + (2 b + i) N 3C; ws holds bwd_wb_bytes
template <int E, bool SINGLE, bool CROSS>
cudaError_t launch_bwd_wb(const EbbTcArgs<bf16>& a, cudaStream_t st) {
  const int G = 2 * a.B * a.heads, N = a.N;
  if (G > 65535 || N <= 0 || a.ws == nullptr) return cudaErrorInvalidValue;
  const EbBwdWs ws(a.ws, G, N, E, true, 2, true);
  float* gpart = reinterpret_cast<float*>(static_cast<unsigned char*>(a.ws) +
                                          ws.bytes);
  const EbBwdRows<bf16> r(ws);
  const size_t img = (size_t)N * 3 * a.C;
  CUtensorMap m1, m2;
  RP_TRY(map_image_bf16(&m1, a.qkv, a.B, N, a.C, 2 * img));
  RP_TRY(map_image_bf16(&m2, a.qkv + img, a.B, N, a.C, 2 * img));
  RP_TRY((launch_stats_wb<false, false, true>(m1, m2, ws.qstats, nullptr, G,
                                              N, a.C, a.heads, st)));
  if constexpr (!SINGLE)
    RP_TRY((launch_stats_wb<true, false, true>(m1, m2, ws.kstats, nullptr, G,
                                               N, a.C, a.heads, st)));
  constexpr size_t psmem = prologue_smem_bytes<bf16, E>();
  auto prologue = eb_bwd_prologue_kernel<PairLayout, E, CROSS, bf16, true>;
  RP_TRY(smem_attr(prologue, psmem));
  const dim3 grid((N + kT - 1) / kT, G);
  prologue<<<grid, kThreads, psmem, st>>>(a.qkv, a.qkv + img, a.pos, nullptr,
                                          2 * img, a.dF, r.vb, r.vbdft,
                                          r.vadf, N, a.C, a.heads);
  RP_TRY(cudaGetLastError());
  // a. rho and (dual) gamma's partials; b. the key rows; c. the query rows
  RP_TRY((launch_pass_wb<E, true, false, SINGLE, CROSS>(m1, m2, a, ws, gpart,
                                                         st)));
  RP_TRY((launch_pass_wb<E, false, true, SINGLE, CROSS>(m1, m2, a, ws, gpart,
                                                         st)));
  return launch_pass_wb<E, true, true, SINGLE, CROSS>(m1, m2, a, ws, gpart,
                                                      st);
}

#undef RP_TRY

#define RP_EWB_FWD_EXTERN(E, S, X)                                    \
  extern template cudaError_t launch_moments_wb<E, S, X>(            \
      const EbTcArgs<bf16>&, cudaStream_t, int);
#define RP_EWB_FWD_INSTANTIATE(E, S, X)                               \
  template cudaError_t launch_moments_wb<E, S, X>(const EbTcArgs<bf16>&, \
                                                  cudaStream_t, int);
#define RP_EWB_BWD_EXTERN(E, S, X)                                    \
  extern template cudaError_t launch_bwd_wb<E, S, X>(                \
      const EbbTcArgs<bf16>&, cudaStream_t);
#define RP_EWB_BWD_INSTANTIATE(E, S, X)                               \
  template cudaError_t launch_bwd_wb<E, S, X>(const EbbTcArgs<bf16>&, \
                                              cudaStream_t);

}  // namespace wg
}  // namespace tc
}  // namespace rp

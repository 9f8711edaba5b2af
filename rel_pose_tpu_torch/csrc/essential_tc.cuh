// The Essential Matrix Module's moments on the mma.sync tensor cores: one
// body behind two Pallas kernels, which differ in where a slice's rows live
// (the layout types below) and in a mode:
//   - #8 _fwd_kernel (rel_pose_tpu/ops/pallas_essential.py:72): SliceLayout,
//     separate (G, N, 64) q, k and (G, N, e) va, vb, any scale (bilinear.cu,
//     bilinear_f32.cu), bf16 and fp32;
//   - #9 _variant_kernel (scripts/bench_cross.py:35): PairLayout, the modes
//     kEbBf16Mul and kEbMxuSums, bf16 (cross_variants.cu).
// #8 stays on mma.sync because its fp32 e = 70 rows (280 bytes) are off
// TMA's 16-byte stride grid, #9's modes because they are copies of #4 timed
// against it.  #2, #3, #4 (PairLayout, the dual or the single softmax) and
// #9's s run the wgmma bodies, bf16 essential_wgmma.cuh and fp32
// essential_wgmma_f32.cuh, which take this file's layouts, vb_n packing
// (fp32), workspace and argument types.
// The kernels are templates on the element type T, which picks the product
// as attention_tc.cuh does: bf16 m16n8k16 with ldmatrix, or
// fp32 as 3xTF32 on m16n8k8 (each operand split into TF32 hi + lo in
// registers, hi.hi + hi.lo + lo.hi summed into a fresh 8-deep partial that
// one IEEE fp32 add puts into the sum: fp32 accuracy).
//
// Per slice g, with q, k (N x 64) and va, vb (N x e): PairLayout's slice is
// (pair b, direction, head), vb = v_self ++ 6 positional columns (e = 70) or
// v_self (e = 64), va = vb or, with CROSS, the query image's v ++ the same
// columns; T the rounding to the element type (bf16 rounds, fp32 keeps the
// value).  The Pallas kernels' rounding points, sums in another order:
//   s = T(q) T(k)^T scale (fp32; scale = the softmax scale times log2e, d^-1/2
//   log2e for #2-#4 and #9); mr, mc the exact row and column maxima;
//   er = exp2(s - mr), ec = exp2(s - mc), lr = sum_j er, lc = sum_i ec;
//   P = T(er ec), vb_n = T(vb (1/lc))  (kEbSingle: P = T(er), vb_n = vb);
//   av = T((P vb_n) (1/lr));  F = va^T av, fp32.
// #9's modes change P and the sums: kEbBf16Mul P = T(T(er) T(ec)), one bf16
// product (__hmul2 on packed pairs); kEbMxuSums the same P with lr =
// sum_j T(er) and lc = sum_i T(ec), summed in fp32 by mma.sync against a
// ones operand, the column sums against each key's final max.
//
// What bounds it on the H100: the products (3 N^2 d score products with
// the two statistics passes below, N^2 e for P vb_n and N e^2 for va^T av
// a slice) and the exp2 of every score, three a score with the dual
// softmax (one for lc, two for P).  bf16, mma.sync m16n8k16: at #2's eval
// shapes 1.53 G exp2, about 0.39 ms at the special-function units' rate,
// above the 0.21 ms tensor-core bound of the function's products.  fp32,
// three m16n8k8 products a product at 3xTF32's 165 TFLOP/s and the split of
// every loaded operand (two integer ops and a subtraction each): the
// products decide.  Device memory: one read of the inputs, the small
// statistics and vb_n scratch, and the F partials (E^2 fp32 per 64-query
// tile and slice).
//
// Design, in launch order (launch_moments):
//   1. eb_stats_kernel (not kEbSingle), one block per (64-key tile, slice):
//      walks every query tile on the transposed product s^T = k q^T, so a
//      key's column max and sum are row statistics of that product, kept
//      per thread and merged across the 4 lanes of a row at the end.  The
//      sum is online (rescaled when the max grows), which is allowed: lc
//      is fp32 and ends as sum_i exp2(s - mc) up to fp32 rounding.
//      kEbMxuSums rounds each ec to bf16 against the final max, so it walks
//      twice: the max, then the sums on the tensor cores.  Writes (mc, 1/lc)
//      per key.
//   2. eb_vbn_kernel: vb_n = T(vb (1/lc)) (kEbSingle: vb) into scratch of
//      the element type, rows of kW (bf16 80, fp32 72; 70 used) or 64
//      columns, zero-padded, so that every later tile load is whole 16-byte
//      rows.
//   3. eb_moments_kernel, one block of 4 warps per (64-query tile, slice),
//      16 query rows a warp: a first walk over
//      the key tiles takes the exact row max (no exp2); a second recomputes
//      s, forms er, ec, P and lr, and accumulates P vb_n in registers (16 x
//      72 fp32 a warp; fp32 P stays in the accumulator registers as the A
//      operand, attention_tc.cuh's k permutation); then av = T(. (1/lr))
//      goes to shared memory and the tile's partial F = va^T av to scratch
//      (va read along its rows: bf16 ldmatrix.trans, fp32 32-bit loads with
//      the sum index permuted as for P).  Nothing rounded to bf16 is
//      rescaled online.
//   4. launch_sum_partials adds the query tiles' partials of each slice in
//      order.
// Rows >= N load as zeros and keys >= N are masked out of every max and
// sum.  No atomics, sums in a fixed order: two calls give the same bits,
// and a slice's F does not depend on the layout.  va rows of e =
// 70 in SliceLayout are off the 16-byte grid (bf16 140 bytes, fp32 280):
// they load two values a cp.async, 4 or 8 bytes (load_rows2), where
// PairLayout's load whole 16-byte rows.
// fp32 tiles are twice bf16's bytes: the moments kernel takes 109 KB and
// runs two blocks an SM (bf16 three), the statistics kernel 52 KB, four.

#pragma once

#include <cstdint>

#include "attention_tc.cuh"

namespace rp {
namespace tc {

constexpr int kEbPos = 6;  // positional columns appended to v

// The e-wide operands: rows of kW elements (e = 70 padded to the depth of
// the products that sum over e: bf16 80, k16; fp32 72, k8; e = 64 as it
// is), in shared memory with rows of kLd elements: bf16 44 or 36 words (8
// ldmatrix rows fall in distinct banks); fp32 76 or 68 words, 4 times an
// odd number, so that the fragment loads g kLd + t and, read along the
// rows with the sum index permuted, 2t kLd + g cover the 32 banks.  kNT n8
// tiles (72 or 64 columns) of an e-wide product, kKS k16 steps (bf16) and
// kK8 k8 steps (fp32) over e, kM16 m16 tiles over e.
template <typename T>
__host__ __device__ constexpr int eb_kw(int E) {
  return E == kHeadDim ? kHeadDim : (sizeof(T) == 2 ? 80 : 72);
}

template <typename T, int E>
struct EbW {
  static_assert(E == kHeadDim || E == kHeadDim + kEbPos, "e = d or d + 6");
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kW = eb_kw<T>(E);
  static constexpr int kLd = kW + (kF32 ? 4 : 8);
  static constexpr int kNT = (E + 7) / 8;
  static constexpr int kKS = kW / 16;
  static constexpr int kK8 = kW / 8;
  static constexpr int kM16 = (kW + 15) / 16;
  static constexpr int kTileElems = kAT * kLd;
};

// a pair of adjacent values in the element type (rounded to bf16 for bf16)
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// ----------------------------------------------------------- fragments --

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// rows [row0, row0 + 64) x W columns of a matrix with row stride ld into a
// tile of row stride LD, 16 bytes a cp.async; rows >= N load as zeros
template <int W, int LD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t ld,
                                          int row0, int N) {
  constexpr int V = 16 / (int)sizeof(T), CPR = W / V;
  static_assert(kAT * CPR % kAThreads == 0, "tile loads: whole steps");
#pragma unroll
  for (int u = 0; u < kAT * CPR / kAThreads; ++u) {
    const int c = threadIdx.x + u * kAThreads, r = c / CPR,
              cc = (c % CPR) * V;
    const bool ok = row0 + r < N;
    cp_async16(dst + r * LD + cc, src + (size_t)(ok ? row0 + r : 0) * ld + cc,
               ok);
  }
}

// rows [row0, row0 + 64) of v ++ pos (columns 64 .. 69; 70 .. kW - 1 zero)
// into a tile of row stride W::kLd: v through cp.async (row stride ld),
// the positional columns by plain stores; rows >= N zero
template <int E, typename T>
__device__ __forceinline__ void load_vrows(T* dst, const T* v, size_t ld,
                                           const T* pos, int row0, int N) {
  using W = EbW<T, E>;
  load_rows<kHeadDim, W::kLd>(dst, v, ld, row0, N);
  if constexpr (W::kW > kHeadDim) {
    constexpr int X = W::kW - kHeadDim;
    for (int i = threadIdx.x; i < kAT * X; i += kAThreads) {
      const int r = i / X, c = i % X, row = row0 + r;
      dst[r * W::kLd + kHeadDim + c] =
          row < N && c < kEbPos ? pos[(size_t)row * kEbPos + c]
                                : from_f32<T>(0.f);
    }
  }
}

// A fragments of this warp's 16 rows x 16 KS columns of a tile
template <int KS, int LD>
__device__ __forceinline__ void load_afrag_k(unsigned (&f)[KS][4],
                                             const bf16* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(f[kk], tile + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8);
}

// c[16 x 8 NT] += a[16 x 16 KS] . B^T, B a tile of 8 NT rows (the columns
// of c) x 16 KS, row stride LD
template <int NT, int KS, int LD>
__device__ __forceinline__ void mma_abt_acc(float (&c)[NT][4],
                                            const unsigned (&a)[KS][4],
                                            const bf16* B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned r[4];
      ldsm_x4(r, B + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], a[kk], r[0], r[1]);
      mma_bf16(c[2 * np + 1], a[kk], r[2], r[3]);
    }
    if constexpr (NT % 2) {
      unsigned r[2];
      ldsm_x2(r, B + ((NT - 1) * 8 + (lane & 7)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(c[NT - 1], a[kk], r[0], r[1]);
    }
  }
}

// c[16 x 8 NT] += a[16 x 16 KS] . B, B a tile of 16 KS rows (the sum
// index) x 8 NT columns, row stride LD
template <int NT, int KS, int LD>
__device__ __forceinline__ void mma_ab_acc(float (&c)[NT][4],
                                           const unsigned (&a)[KS][4],
                                           const bf16* B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* row = B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned r[4];
      ldsm_x4_t(r, row + np * 16 + (lane >> 4) * 8);
      mma_bf16(c[2 * np], a[kk], r[0], r[1]);
      mma_bf16(c[2 * np + 1], a[kk], r[2], r[3]);
    }
    if constexpr (NT % 2) {
      unsigned r[2];
      ldsm_x2_t(r, row + (NT - 1) * 8);
      mma_bf16(c[NT - 1], a[kk], r[0], r[1]);
    }
  }
}

// fp32 (3xTF32) counterparts, from 32-bit shared-memory loads split in
// registers (mma_helpers.cuh's mma_3xtf32: each 8-deep step into a fresh
// partial, added to c in IEEE fp32).  Lane 4 g + t.

// c[16 x 8 NT] += A[16 x 8 K8] . B^T: A this warp's 16 rows of a tile (row
// stride LDA), B a tile of 8 NT rows (the columns of c) x 8 K8 (row stride
// LDB); both read along their rows (words g LD + t)
template <int NT, int K8, int LDA, int LDB>
__device__ __forceinline__ void mma_abt_acc_f32(float (&c)[NT][4],
                                                const float* A,
                                                const float* B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* a = A + (warp * 16 + g) * LDA + t;
  const float* b = B + g * LDB + t;
#pragma unroll
  for (int kk = 0; kk < 8 * K8; kk += 8) {
    unsigned ah[4], al[4];
    split_tf32(a[kk], ah[0], al[0]);
    split_tf32(a[8 * LDA + kk], ah[1], al[1]);
    split_tf32(a[kk + 4], ah[2], al[2]);
    split_tf32(a[8 * LDA + kk + 4], ah[3], al[3]);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      unsigned bh[2], bl[2];
      split_tf32(b[ni * 8 * LDB + kk], bh[0], bl[0]);
      split_tf32(b[ni * 8 * LDB + kk + 4], bh[1], bl[1]);
      mma_3xtf32(c[ni], ah, al, bh, bl);
    }
  }
}

// c[16 x 8 NT] += p[16 x 64] . B: p an accumulator tile whose 64 columns
// are the sum index, taken as attention_tc.cuh's fp32 mma_ab takes them
// (key 2t of each 8-wide step in slot t, 2t + 1 in slot t + 4: the
// accumulator's own registers), B a tile of 64 rows x 8 NT columns (row
// stride LD) read in the same order (words 2t LD + g)
template <int NT, int LD>
__device__ __forceinline__ void mma_pb_acc_f32(float (&c)[NT][4],
                                               const float (&p)[8][4],
                                               const float* B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* Bl = B + 2 * t * LD + g;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    unsigned ah[4], al[4];
    split_tf32(p[kk][0], ah[0], al[0]);  // (g, key 2t)
    split_tf32(p[kk][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32(p[kk][1], ah[2], al[2]);  // (g, key 2t + 1)
    split_tf32(p[kk][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      unsigned bh[2], bl[2];
      split_tf32(Bl[kk * 8 * LD + ni * 8], bh[0], bl[0]);
      split_tf32(Bl[(kk * 8 + 1) * LD + ni * 8], bh[1], bl[1]);
      mma_3xtf32(c[ni], ah, al, bh, bl);
    }
  }
}

// c[16 x 8 NT] = A[:, m0 .. m0 + 15]^T . B over the 64 rows of two tiles
// (row stride LD): the rows of c are A's columns m0 + g (+ 8), both tiles
// read along their rows with the sum index permuted as in mma_pb_acc_f32
// (row 2t of each 8-row step in slot t, 2t + 1 in slot t + 4; words 2t LD
// + g).  A's columns >= KW are taken as zero.
template <int NT, int LD, int KW>
__device__ __forceinline__ void mma_atb_f32(float (&c)[NT][4],
                                            const float* A, int m0,
                                            const float* B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool hi = m0 + 8 < KW;  // the tile's rows g + 8 exist
  const float* a = A + 2 * t * LD + m0 + g;
  const float* b = B + 2 * t * LD + g;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[ni][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kAT; kk += 8) {
    const float* ar = a + kk * LD;
    unsigned ah[4], al[4];
    split_tf32(ar[0], ah[0], al[0]);
    split_tf32(hi ? ar[8] : 0.f, ah[1], al[1]);
    split_tf32(ar[LD], ah[2], al[2]);
    split_tf32(hi ? ar[LD + 8] : 0.f, ah[3], al[3]);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      unsigned bh[2], bl[2];
      split_tf32(b[kk * LD + ni * 8], bh[0], bl[0]);
      split_tf32(b[(kk + 1) * LD + ni * 8], bh[1], bl[1]);
      mma_3xtf32(c[ni], ah, al, bh, bl);
    }
  }
}

// 8-byte cp.async (zero-filled when !ok)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// rows [row0, row0 + 64) of an (N, E) matrix whose rows are not 16-byte
// aligned (E = 70: bf16 140 bytes, fp32 280) into a tile of W columns and
// row stride LD, two values a cp.async (bf16 4 bytes, fp32 8); columns >= E
// and rows >= N zero
template <int E, int W, int LD, typename T>
__device__ __forceinline__ void load_rows2(T* dst, const T* src, int row0,
                                           int N) {
  static_assert(E % 2 == 0 && W % 2 == 0 && E <= W, "whole value pairs");
  constexpr int kSrcPairs = E / 2, kDstPairs = W / 2;
  for (int i = threadIdx.x; i < kAT * kDstPairs; i += kAThreads) {
    const int r = i / kDstPairs, w = i % kDstPairs;
    T* d = dst + r * LD + 2 * w;
    if (w < kSrcPairs) {
      const bool ok = row0 + r < N;
      const T* s = src + (size_t)(ok ? row0 + r : 0) * E + 2 * w;
      if constexpr (sizeof(T) == 2)
        cp_async4(d, s, ok);
      else
        cp_async8(d, s, ok);
    } else {
      d[0] = d[1] = from_f32<T>(0.f);
    }
  }
}

constexpr unsigned kBf16OnesX2 = 0x3F803F80u;  // two bf16 1.0

// c[16 x 8] += a[16 x 64] . ones: every column of c holds the fp32 sums of
// a's rows (c[0] row lane / 4, c[2] row lane / 4 + 8)
__device__ __forceinline__ void mma_row_sums(float (&c)[4],
                                             const unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_bf16(c, a[kk], kBf16OnesX2, kBf16OnesX2);
}

// the A fragment slot of columns (j, j + 1) of n8 tile ni, row half h
// (to_afrag's order)
__device__ __forceinline__ unsigned& afrag_at(unsigned (&f)[4][4], int ni,
                                              int h) {
  return f[ni >> 1][(ni & 1) * 2 + h];
}

// ------------------------------------------------------------- layouts --
// Where the rows of slice g live.  The kernels take their inputs as plain
// pointer parameters in0 .. in3 and a stride ld (in a struct parameter the
// base offsets were recomputed at every key step: attention_tc.cuh) and
// ask the layout once for the slice's view:
//   PairLayout (#2-#4, #9): in0, in1 the qkv rows (3C values) of image 1
//     and image 2 of pair 0, pair b's at + b ld; in2 the (B, N, 6)
//     positional table or NULL (e = 64); in3 unused.  Slice g = (b * 2 +
//     direction) * heads + h; direction 0 takes q from image 2 and k, v
//     from image 1; va = vb or, with CROSS, the query image's v.
//   SliceLayout (#8): in0, in1 the (G, N, 64) q, k; in2, in3 the (G, N, e)
//     va, vb.  va is always read from in2, also when the caller passes one
//     tensor for both (the non-cross wiring).
// Both are generic in the element type T, and the kernels instantiate both
// in bf16 and fp32.

// PairLayout's slice g = (b * 2 + direction) * heads + h of a pair's two
// images, whose qkv rows (3C values) start at img1 + b bstride and img2 +
// b bstride.  Direction 0 takes q from image 2 and k, v_self from image 1.
template <typename T>
struct EbSlice {
  const T* qimg;  // the query image's qkv rows
  const T* kimg;  // the key image's
  int b, dir, h;
  __device__ EbSlice(const T* img1, const T* img2, size_t bstride, int g,
                     int heads) {
    h = g % heads;
    dir = (g / heads) & 1;
    b = g / (2 * heads);
    qimg = (dir == 0 ? img2 : img1) + (size_t)b * bstride;
    kimg = (dir == 0 ? img1 : img2) + (size_t)b * bstride;
  }
};

template <typename T>
struct EbView {
  const T* q;    // 64-wide rows at stride ldqk
  const T* k;
  const T* va;   // PairLayout: v rows (64 columns) at stride ldqk, the
  const T* vb;   // positional columns from pos; SliceLayout: e-wide rows
  const T* pos;  // PairLayout: the pair's (N, 6) table or NULL
  size_t ldqk;
};

// 2 consecutive elements from global memory as fp32 (4 or 8 bytes,
// aligned)
__device__ __forceinline__ float2 load2_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// 8 consecutive elements from global memory as fp32 (16 or 32 bytes,
// aligned)
__device__ __forceinline__ void load8_f32(const bf16* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  unpack4_bf16(make_uint2(u.x, u.y), *reinterpret_cast<float(*)[4]>(x));
  unpack4_bf16(make_uint2(u.z, u.w), *reinterpret_cast<float(*)[4]>(x + 4));
}
__device__ __forceinline__ void load8_f32(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}

struct PairLayout {
  static constexpr bool kSlice = false;
  template <int E, bool CROSS, typename T>
  __device__ static EbView<T> view(const T* in0, const T* in1, const T* in2,
                                   size_t ld, int N, int C, int heads,
                                   int g) {
    const EbSlice<T> sl(in0, in1, ld, g, heads);
    const int off = sl.h * kHeadDim;
    return {sl.qimg + off, sl.kimg + C + off,
            (CROSS ? sl.qimg : sl.kimg) + 2 * C + off, sl.kimg + 2 * C + off,
            in2 == nullptr ? nullptr : in2 + (size_t)sl.b * N * kEbPos,
            3 * (size_t)C};
  }
  // the s-th of the S slices of block row y: one (direction, head) of S
  // consecutive pairs (#9's s, essential_wgmma*.cuh)
  __device__ static int slice(int y, int s, int S, int heads) {
    const int P = 2 * heads;
    return (y / P * S + s) * P + y % P;
  }
  // rows [row0, row0 + 64) of v (va or vb of the view) ++ pos into a tile
  template <int E, typename T>
  __device__ static void load_v(T* dst, const T* v, const EbView<T>& vw,
                                int row0, int N) {
    load_vrows<E>(dst, v, vw.ldqk, vw.pos, row0, N);
  }
  // columns 8 c8 .. 8 c8 + 7 of vb's row n (zero past e)
  template <int E, typename T>
  __device__ static void vb8(const EbView<T>& vw, int n, int c8,
                             float (&x)[8]) {
    if (c8 < kHeadDim / 8) {
      load8_f32(vw.vb + (size_t)n * vw.ldqk + c8 * 8, x);
    } else {
      const T* p = vw.pos + (size_t)n * kEbPos;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        x[c] = c8 == kHeadDim / 8 && c < kEbPos ? to_f32(p[c]) : 0.f;
    }
  }
};

struct SliceLayout {
  static constexpr bool kSlice = true;
  template <int E, bool, typename T>
  __device__ static EbView<T> view(const T* in0, const T* in1, const T* in2,
                                   const T* in3, int N, int g) {
    const size_t gN = (size_t)g * N;
    return {in0 + gN * kHeadDim, in1 + gN * kHeadDim, in2 + gN * E,
            in3 + gN * E, nullptr, kHeadDim};
  }
  template <int E, typename T>
  __device__ static void load_v(T* dst, const T* v, const EbView<T>&,
                                int row0, int N) {
    using W = EbW<T, E>;
    if constexpr (E == kHeadDim)
      load_rows<kHeadDim, W::kLd>(dst, v, kHeadDim, row0, N);
    else
      load_rows2<E, W::kW, W::kLd>(dst, v, row0, N);
  }
  // columns 8 c8 .. 8 c8 + 7 of vb's row n (zero past e), as value pairs:
  // a row of e = 70 is 4-byte (bf16) or 8-byte (fp32) aligned
  template <int E, typename T>
  __device__ static void vb8(const EbView<T>& vw, int n, int c8,
                             float (&x)[8]) {
    const T* p = vw.vb + (size_t)n * E + c8 * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = c8 * 8 + 2 * j < E ? load2_f32(p + 2 * j)
                                          : make_float2(0.f, 0.f);
      x[2 * j] = v.x;
      x[2 * j + 1] = v.y;
    }
  }
};

// the view of slice g under its layout
template <class Layout, int E, bool CROSS, typename T>
__device__ __forceinline__ EbView<T> eb_view(const T* in0, const T* in1,
                                             const T* in2, const T* in3,
                                             size_t ld, int N, int C,
                                             int heads, int g) {
  if constexpr (Layout::kSlice)
    return Layout::template view<E, CROSS>(in0, in1, in2, in3, N, g);
  else
    return Layout::template view<E, CROSS>(in0, in1, in2, ld, N, C, heads,
                                           g);
}

// the moments' modes: #2-#4 and #8 take the dual or the single softmax, #9's
// _variant_kernel the two others (see the file's head)
enum EbMode { kEbDual, kEbSingle, kEbBf16Mul, kEbMxuSums };

// ------------------------------------------------------------ statistics --
// Per row of the own side (keys with kKeyRows: the column statistics of s;
// queries: its row statistics), the max m of its scores over every column
// of the other side and 1 / sum exp2(s - m), to stats[(g N + row) * 3] and
// [.. + 1] (slot 2 is the backward's).  One block per (64-row tile, slice)
// walks the other side's tiles through a 2-stage cp.async ring (the three
// tiles in dynamic shared memory: fp32's 52 KB exceed the static 48 KB).
// With kExact (bf16) the walk runs twice, the max and then sum T(exp2(s -
// m)) on the tensor cores (kEbMxuSums).  Four blocks an SM.
template <typename T>
constexpr size_t stats_smem_bytes() {
  return 3 * tile_elems<T>() * sizeof(T);
}

template <bool kKeyRows, class Layout, bool kExact, typename T>
__global__ void __launch_bounds__(kAThreads, 4)
eb_stats_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
                size_t ld, float* __restrict__ stats, int N, int C,
                int heads, float scale) {
  static_assert(!kExact || sizeof(T) == 2, "kEbMxuSums: bf16");
  constexpr int TE = tile_elems<T>();
  extern __shared__ __align__(128) unsigned char eb_smem[];
  T* Xs = reinterpret_cast<T*>(eb_smem);
  const auto Os = [&](int st) { return Xs + (1 + st) * TE; };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kAT, g = blockIdx.y;
  const EbView<T> vw = eb_view<Layout, kHeadDim, false>(
      in0, in1, (const T*)nullptr, (const T*)nullptr, ld, N, C, heads, g);
  const T* own = kKeyRows ? vw.k : vw.q;
  const T* other = kKeyRows ? vw.q : vw.k;
  const int nt = (N + kAT - 1) / kAT;
  const int steps = kExact ? 2 * nt : nt;

  load_tile(Xs, own, vw.ldqk, r0, N);
  load_tile(Os(0), other, vw.ldqk, 0, N);
  cp_async_commit();
  typename AttnFrags<T>::A xf;
  float s[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float lsum[4] = {};  // kExact: the sums from the tensor cores
  for (int t = 0; t < steps; ++t) {
    __syncthreads();  // the stage loaded below was read at step t - 1
    if (t + 1 < steps)
      load_tile(Os((t + 1) & 1), other, vw.ldqk,
                (kExact && t + 1 >= nt ? t + 1 - nt : t + 1) * kAT, N);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) load_afrag(xf, Xs);
    const int c0 = (kExact && t >= nt ? t - nt : t) * kAT;
    mma_abt(s, xf, Os(t & 1));
    if constexpr (kExact) {
      if (t < nt) {  // the exact max
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + acc_col(ni, e) < N)
              m[e >> 1] = fmaxf(m[e >> 1], __fmul_rn(s[ni][e], scale));
        if (t == nt - 1) {
          m[0] = quad_max(m[0]);
          m[1] = quad_max(m[1]);
        }
        continue;
      }
      unsigned ef[4][4];  // T(exp2(s - m)), masked columns 0
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = c0 + acc_col(ni, 2 * h);
          const float e0 =
              j < N ? exp2f(__fmul_rn(s[ni][2 * h], scale) - m[h]) : 0.f;
          const float e1 =
              j + 1 < N ? exp2f(__fmul_rn(s[ni][2 * h + 1], scale) - m[h])
                        : 0.f;
          afrag_at(ef, ni, h) = pack_bf16(e0, e1);
        }
      mma_row_sums(lsum, ef);
      continue;
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
    float M, L;
    if constexpr (kExact) {
      M = m[half];
      L = lsum[2 * half];
    } else {
      M = quad_max(m[half]);
      L = quad_sum(l[half] * exp2f(m[half] - M));
    }
    const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
    if (row < N && (lane & 3) == 0) {
      st[(size_t)row * 3] = M;
      st[(size_t)row * 3 + 1] = 1.f / L;
    }
  }
}

// the statistics of G slices' rows (keys with kKeyRows) into stats
template <bool kKeyRows, class Layout, bool kExact = false, typename T>
static cudaError_t launch_stats(const T* in0, const T* in1, size_t ld,
                                float* stats, int G, int N, int C, int heads,
                                float scale, cudaStream_t st) {
  constexpr size_t smem = stats_smem_bytes<T>();
  auto kernel = eb_stats_kernel<kKeyRows, Layout, kExact, T>;
  cudaError_t err = smem_attr(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + kAT - 1) / kAT, G), kAThreads, smem, st>>>(
      in0, in1, ld, stats, N, C, heads, scale);
  return cudaGetLastError();
}

// -------------------------------------------------------------- vb_n --
// vbn[(g N + n) kW + c] = T(vb[n][c] (1/lc[n])) with kstats, vb[n][c]
// without (kEbSingle); columns >= e zero.  One thread per 8 columns.
template <class Layout, int E, typename T>
__global__ void __launch_bounds__(256)
eb_vbn_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
              const T* __restrict__ in2, const T* __restrict__ in3,
              size_t ld, const float* __restrict__ kstats,
              T* __restrict__ vbn, int N, int C, int heads, int G) {
  constexpr int CW = EbW<T, E>::kW / 8;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)G * N * CW) return;
  const int c8 = (int)(i % CW);
  const size_t gn = i / CW;
  const int n = (int)(gn % N), g = (int)(gn / N);
  const EbView<T> vw =
      eb_view<Layout, E, false>(in0, in1, in2, in3, ld, N, C, heads, g);
  float x[8];
  Layout::template vb8<E>(vw, n, c8, x);
  if (kstats != nullptr) {
    const float inv = kstats[gn * 3 + 1];
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] *= inv;
  }
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(vbn + i * 8) =
        make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                   pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  } else {
    float4* o = reinterpret_cast<float4*>(vbn + i * 8);
    o[0] = make_float4(x[0], x[1], x[2], x[3]);
    o[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// ------------------------------------------------------------- moments --
// The partial F = va^T av of 64 query rows of slice g = blockIdx.y to
// fpart[(blockIdx.x G + g) E^2]: the key tiles are walked twice (the row
// max, then P and P vb_n) as one sequence of 2 nk steps through a 2-stage
// cp.async ring of k (and, in the second walk, vb_n and mc) tiles.  bf16:
// three 53 KB blocks an SM; fp32 (SliceLayout only): two of 109 KB.
template <typename T, int E>
constexpr size_t moments_smem_bytes() {
  return (3 * tile_elems<T>() + 3 * EbW<T, E>::kTileElems) * sizeof(T) +
         2 * kAT * sizeof(float);
}

template <class Layout, int E, int MODE, bool CROSS, typename T>
__global__ void __launch_bounds__(kAThreads, sizeof(T) == 2 ? 3 : 2)
eb_moments_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
                  const T* __restrict__ in2, const T* __restrict__ in3,
                  size_t ld, const float* __restrict__ kstats,
                  const T* __restrict__ vbn, float* __restrict__ fpart,
                  int N, int C, int heads, float scale) {
  using W = EbW<T, E>;
  constexpr bool kF32 = W::kF32;
  static_assert(Layout::kSlice || !kF32, "fp32 PairLayout: the wgmma body");
  constexpr int TE = tile_elems<T>();
  constexpr bool SINGLE = MODE == kEbSingle;
  constexpr bool HMUL = MODE == kEbBf16Mul || MODE == kEbMxuSums;
  constexpr bool MXU = MODE == kEbMxuSums;
  static_assert(!HMUL || !kF32, "#9's modes: bf16");
  extern __shared__ __align__(128) unsigned char eb_smem[];
  T* sm = reinterpret_cast<T*>(eb_smem);
  // stage st of the rings at K(st), V(st) (offsets, not arrays of
  // pointers: those were indexed from the stack)
  T* Qs = sm;
  const auto K = [&](int st) { return sm + (1 + st) * TE; };
  const auto V = [&](int st) { return sm + 3 * TE + st * W::kTileElems; };
  T* VAs = sm + 3 * TE + 2 * W::kTileElems;
  float* MCs = reinterpret_cast<float*>(VAs + W::kTileElems);  // [2][64]
  T* AVs = K(0);  // av, after the walks, over the k ring
  static_assert(2 * TE >= W::kTileElems, "av fits the k ring");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kAT;
  const int nk = (N + kAT - 1) / kAT;
  const size_t G = gridDim.y;
  const int g = blockIdx.y;
  const EbView<T> vw =
      eb_view<Layout, E, CROSS>(in0, in1, in2, in3, ld, N, C, heads, g);
  const T* vnb = vbn + (size_t)g * N * W::kW;
  const float* ks = kstats + (size_t)g * N * 3;

  load_tile(Qs, vw.q, vw.ldqk, q0, N);
  load_tile(K(0), vw.k, vw.ldqk, 0, N);
  Layout::template load_v<E>(VAs, vw.va, vw, q0, N);
  cp_async_commit();
  typename AttnFrags<T>::A qf;
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float lsum[4] = {};  // MXU: the row sums from the tensor cores
  float o[W::kNT][4] = {};
  float s[8][4];
  for (int t = 0; t < 2 * nk; ++t) {
    __syncthreads();  // the stage loaded below was read at step t - 1
    const int tn = t + 1;
    if (tn < 2 * nk) {
      const int kn = (tn % nk) * kAT, st = tn & 1;
      load_tile(K(st), vw.k, vw.ldqk, kn, N);
      if (tn >= nk) {
        load_rows<W::kW, W::kLd>(V(st), vnb, W::kW, kn, N);
        if (!SINGLE && tid < kAT)
          cp_async4(MCs + st * kAT + tid,
                    ks + (size_t)(kn + tid < N ? kn + tid : 0) * 3,
                    kn + tid < N);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) load_afrag(qf, Qs);
    const int k0 = (t % nk) * kAT;
    mma_abt(s, qf, K(t & 1));
    if (t < nk) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + acc_col(ni, e) < N)
            mx[e >> 1] = fmaxf(mx[e >> 1], __fmul_rn(s[ni][e], scale));
      if (t == nk - 1) {
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
      }
      continue;
    }
    const float* mc = MCs + (t & 1) * kAT;
    if constexpr (HMUL) {
      // P = T(T(er) T(ec)), one bf16 product per packed pair of columns
      unsigned pf[4][4];
      unsigned ef[4][4];  // MXU: T(er), for the row sums
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = acc_col(ni, 2 * h);
          const float s0 = __fmul_rn(s[ni][2 * h], scale);
          const float s1 = __fmul_rn(s[ni][2 * h + 1], scale);
          const bool ok0 = k0 + j < N, ok1 = k0 + j + 1 < N;
          const float er0 = ok0 ? exp2f(s0 - mx[h]) : 0.f;
          const float er1 = ok1 ? exp2f(s1 - mx[h]) : 0.f;
          const float ec0 = ok0 ? exp2f(s0 - mc[j]) : 0.f;
          const float ec1 = ok1 ? exp2f(s1 - mc[j + 1]) : 0.f;
          if (!MXU) {
            l[h] += er0;
            l[h] += er1;
          }
          const unsigned erb = pack_bf16(er0, er1);
          const unsigned ecb = pack_bf16(ec0, ec1);
          const __nv_bfloat162 p =
              __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&erb),
                      *reinterpret_cast<const __nv_bfloat162*>(&ecb));
          afrag_at(pf, ni, h) = *reinterpret_cast<const unsigned*>(&p);
          if (MXU) afrag_at(ef, ni, h) = erb;
        }
      if (MXU) mma_row_sums(lsum, ef);
      mma_ab_acc<W::kNT, 4, W::kLd>(o, pf, V(t & 1));
    } else {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = acc_col(ni, e);
          const float sv = __fmul_rn(s[ni][e], scale);
          float p = 0.f;
          if (k0 + j < N) {
            const float er = exp2f(sv - mx[e >> 1]);
            l[e >> 1] += er;
            p = SINGLE ? er : er * exp2f(sv - mc[j]);
          }
          s[ni][e] = p;
        }
      if constexpr (kF32) {
        mma_pb_acc_f32<W::kNT, W::kLd>(o, s, V(t & 1));  // P, fp32
      } else {
        unsigned pf[4][4];
        to_afrag(pf, s);  // P = T(er ec)
        mma_ab_acc<W::kNT, 4, W::kLd>(o, pf, V(t & 1));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the k ring: av goes there
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float inv = 1.f / (MXU ? lsum[2 * half] : quad_sum(l[half]));
    const int r = warp * 16 + (lane >> 2) + half * 8;
    const bool ok = q0 + r < N;
#pragma unroll
    for (int ni = 0; ni < W::kNT; ++ni)
      store2(AVs + r * W::kLd + acc_col(ni, 0),
             ok ? o[ni][2 * half] * inv : 0.f,
             ok ? o[ni][2 * half + 1] * inv : 0.f);
  }
  __syncthreads();
  // F[e1][e2] = sum_i va[i][e1] av[i][e2]: va read along its rows (the
  // M-major A operand), m16 tiles of e1 shared out over the warps
  float* fp = fpart + ((size_t)blockIdx.x * G + g) * E * E;
  for (int mt = warp; mt < W::kM16; mt += kAThreads / 32) {
    float f[W::kNT][4];
    if constexpr (kF32) {
      mma_atb_f32<W::kNT, W::kLd, W::kW>(f, VAs, mt * 16, AVs);
    } else {
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
    }
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

// ---------------------------------------------------------- workspace --
// Scratch of the forward, in this order, each piece 256-byte aligned:
// (mc, 1/lc, -) per key (G N x 3 fp32), vb_n (G N kW elements of `elem`
// bytes: 2 bf16, 4 fp32), the F partials (ceil(N / 64) G E^2 fp32).
static inline size_t eb_align(size_t x) { return (x + 255) & ~(size_t)255; }

static inline int eb_kw_of(int E, int elem) {
  return elem == 2 ? eb_kw<bf16>(E) : eb_kw<float>(E);
}

struct EbFwdWs {
  float* kstats;
  void* vbn;
  float* fpart;
  size_t bytes;
  EbFwdWs(void* base, int G, int N, int E, int elem = 2) {
    const int kW = eb_kw_of(E, elem);
    const int nt = (N + kAT - 1) / kAT;
    const uintptr_t p = reinterpret_cast<uintptr_t>(base);
    size_t o = 0;
    kstats = reinterpret_cast<float*>(p + o);
    o += eb_align(sizeof(float) * (size_t)G * N * 3);
    vbn = reinterpret_cast<void*>(p + o);
    o += eb_align((size_t)elem * G * N * kW);
    fpart = reinterpret_cast<float*>(p + o);
    o += eb_align(sizeof(float) * (size_t)nt * G * E * E);
    bytes = o;
  }
};

// Host-side arguments of launch_moments: the layout's in0 .. in3 and ld
// (see the layouts), F (G, e, e) fp32, the EbFwdWs bytes, G slices and the
// scale (the softmax scale times log2 e).
template <typename T>
struct EbFwdArgsT {
  const T* in0;
  const T* in1;
  const T* in2;
  const T* in3;
  size_t ld;
  float* F;
  void* ws;
  int G, N, C, heads;
  float scale;
};

// G slices: at most 65,535 (the grid's second dimension)
template <class Layout, int E, int MODE, bool CROSS, typename T>
cudaError_t launch_moments(const EbFwdArgsT<T>& a, cudaStream_t st) {
  const int G = a.G, N = a.N;
  if (G > 65535 || N <= 0 || a.ws == nullptr) return cudaErrorInvalidValue;
  const EbFwdWs ws(a.ws, G, N, E, (int)sizeof(T));
  T* vbn = reinterpret_cast<T*>(ws.vbn);
  const int nt = (N + kAT - 1) / kAT;
  cudaError_t err;
  if constexpr (MODE != kEbSingle) {
    err = launch_stats<true, Layout, MODE == kEbMxuSums>(
        a.in0, a.in1, a.ld, ws.kstats, G, N, a.C, a.heads, a.scale, st);
    if (err != cudaSuccess) return err;
  }
  const size_t chunks = (size_t)G * N * (EbW<T, E>::kW / 8);
  eb_vbn_kernel<Layout, E><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      a.in0, a.in1, a.in2, a.in3, a.ld,
      MODE == kEbSingle ? nullptr : ws.kstats, vbn, N, a.C, a.heads, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t smem = moments_smem_bytes<T, E>();
  auto kernel = eb_moments_kernel<Layout, E, MODE, CROSS, T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nt, G), kAThreads, smem, st>>>(
      a.in0, a.in1, a.in2, a.in3, a.ld, ws.kstats, vbn, ws.fpart, N, a.C,
      a.heads, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t L = (size_t)G * E * E;
  return launch_sum_partials(ws.fpart, nt, L, L, a.F, st);
}

// #8's forward: G slices of SliceLayout, e = 64 or 70, the dual or the
// single softmax (bilinear.cu; fp32 instantiated in bilinear_f32.cu)
template <typename T>
cudaError_t launch_slice_moments(const EbFwdArgsT<T>& a, int e, int single,
                                 cudaStream_t st) {
  constexpr int kE70 = kHeadDim + kEbPos;
  if (e == kE70)
    return single
               ? launch_moments<SliceLayout, kE70, kEbSingle, false>(a, st)
               : launch_moments<SliceLayout, kE70, kEbDual, false>(a, st);
  if (e == kHeadDim)
    return single
               ? launch_moments<SliceLayout, kHeadDim, kEbSingle, false>(a,
                                                                          st)
               : launch_moments<SliceLayout, kHeadDim, kEbDual, false>(a, st);
  return cudaErrorInvalidValue;
}

// #2-#4's arguments (the wgmma bodies): qkv rows of image i of pair b at
// img_i + b bstride.
template <typename T>
struct EbTcArgs {
  const T* img1;
  const T* img2;
  size_t bstride;
  const T* pos;  // (B, N, 6), or NULL with e = 64
  float* F;      // (B, 2, heads, e, e)
  void* ws;      // the body's forward scratch
  int B, N, C, heads;
};

constexpr float kEbScale = 0.125f * 1.4426950408889634f;  // d^-1/2 log2(e)

}  // namespace tc
}  // namespace rp

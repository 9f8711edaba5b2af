// Softmax attention over 64-wide heads on the tensor cores, forward and
// backward: the ViT stack's self-attention (kernels #1 and #5) and the
// --noess cross attention (kernel #7), each in bf16 and fp32.
//
// Replaces
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel (forward, with the
//     row statistics the backward reads) and pallas_vit_bwd.py:
//     _attn_bwd_heads (dq, dk, dv), layout Interleaved: q, k, v read from
//     the qkv GEMM's (G, N, 3C) output, head h at columns h*64, C + h*64,
//     2C + h*64 (vit_stack.cu);
//   - rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel and _bwd_kernel,
//     layout Separate<E>: (G, N, 64) q, k, v, o, do, dq, dk, dv, one head
//     per sequence (mhsa.cu).
// The kernels take base pointers and row strides, and are templates on a
// layout type, which says in which dtype the cotangent arrives and the
// gradients leave, and the two rounding points in which the two Pallas
// kernels differ, and on the element type E, which picks the product as
// gemm_tc.cuh does: bf16 m16n8k16, or fp32 as 3xTF32 on m16n8k8 (each
// operand split into TF32 hi + lo in registers, hi.hi + hi.lo + lo.hi
// summed in fp32: fp32 accuracy).
//
// What bounds them on the H100: the products, 2 N^2 d multiply-adds a head
// for the forward's two (QK^T, PV), which at N = 576 and d = 64 is 64
// operations per byte of bf16 q, k, v and o -- below the 295 of the bf16
// tensor cores, so at full rate HBM would bound them -- and 32 in fp32, at
// 3xTF32's 165 TFLOP/s below its 49; here the mma.sync throughput, the
// exp2 of every score and, in fp32, the split of every operand decide.
//
// Design: one block of 4 warps per (64-query or 64-key tile, head,
// sequence); each warp owns 16 rows, and every product is mma.sync with its
// operands from padded 64 x 64 shared-memory tiles (bf16: ldmatrix, .trans
// where the product reads a tile along its rows; fp32: 32-bit loads, and
// an accumulator reused as the next product's A operand keeps its
// registers, the k index permuted so that key 2t sits in slot t and key
// 2t + 1 in slot t + 4 of each 8-key step, B read in the same order).
// Scores stay in registers and the Pallas kernels' rounding points are
// kept exactly, with no online rescaling (T is E: bf16 rounds, fp32 keeps
// the value):
//   forward: a first pass over the key tiles takes the exact row max m of
//     s = (q . k) * scale (scale = d^-1/2 log2 e, the product rounded on
//     its own); a second recomputes s, e = exp2(s - m), the fp32 row sum l,
//     P = T(e) and P . v; o = T(layout's normalize(P . v, l)).  That is
//     3 N^2 d multiply-adds instead of 2, the price of exact statistics
//     without 147 KB of score rows in shared memory.  With `stats`, (m, l)
//     per row.  Without its values (P . v) the same kernel is #7's stats
//     pass: the same (m, l) bits for a backward whose forward kept none.
//   dq (per query tile, (m, l) from stats): a first pass forms e and
//     dp = T(do) . v^T and c = sum(dp e) / l; a second recomputes them,
//     ds = T(layout's ds(e, dp, c, l)) and dq = ds . k.  fp32 takes c =
//     do . o from the forward's output instead (equal in exact
//     arithmetic) and makes the second pass alone.  c goes to stats, and
//     T(do / l) to scratch (and, for the ViT's bf16 products, T(do) of its
//     fp32 cotangent), for the dk / dv kernel.
//   dk, dv (per key tile, walking the query tiles): s^T = k . q^T and
//     dp^T = v . T(do)^T, with each query's (m, l, c) from stats;
//     dv += T(e)^T . T(do / l), dk += T(ds)^T . q.
// Rows >= N load as zeros and keys >= N are masked out of every sum.
// Tiles stream through cp.async rings (2 stages; fp32's dk / dv kernel 1,
// so that two of its 87 KB blocks share an SM): the next step's tiles load
// while this step's products run.  Every sum runs in a fixed order and
// nothing uses atomics: two calls give the same bits.

#pragma once

#include "gemm_tc.cuh"

namespace rp {
namespace tc {

constexpr float kLn2 = 0.6931471805599453f;

constexpr int kAT = 64;                   // rows of a query or key tile
constexpr int kALd = kHeadDim + 8;        // padded bf16 row of a tile
constexpr int kAThreads = 128;            // 4 warps x 16 rows
constexpr int kATileElems = kAT * kALd;

// Padded row of a tile, in elements: bf16 72 (ldmatrix's 8 rows in
// distinct banks); fp32 68 words, 4 mod 32, so that the fragment loads
// g * 68 + t and, for a k-permuted B operand, 2t * 68 + g cover the banks.
template <typename E>
__host__ __device__ constexpr int tile_ld() {
  return sizeof(E) == 2 ? kALd : kHeadDim + 4;
}
template <typename E>
__host__ __device__ constexpr int tile_elems() {
  return kAT * tile_ld<E>();
}

// rows [row0, row0 + 64) of a (rows, 64) slice with row stride ld into a
// tile; rows >= N load as zeros
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* src, size_t ld,
                                          int row0, int N) {
  constexpr int V = 16 / (int)sizeof(E), CPR = kHeadDim / V;
  constexpr int LD = tile_ld<E>();
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kAT * CPR / kAThreads; ++u) {
    const int c = tid + u * kAThreads, r = c / CPR, cc = (c % CPR) * V;
    const bool ok = row0 + r < N;
    cp_async16(dst + r * LD + cc, src + (size_t)(ok ? row0 + r : 0) * ld + cc,
               ok);
  }
}

// A fragments of this warp's 16 rows x 64 columns of a tile
__device__ __forceinline__ void load_afrag(unsigned (&f)[4][4],
                                           const bf16* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(f[kk], tile + (warp * 16 + (lane & 15)) * kALd + kk * 16 +
                       (lane >> 4) * 8);
}

// s[16 x 64] = a[16 x 64] . B^T, B a tile of 64 rows x 64 (its rows are the
// columns of s)
__device__ __forceinline__ void mma_abt(float (&s)[8][4],
                                        const unsigned (&a)[4][4],
                                        const bf16* B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      ldsm_x4(r, B + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kALd +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a[kk], r[0], r[1]);
      mma_bf16(s[2 * np + 1], a[kk], r[2], r[3]);
    }
}

// o[16 x 64] += a[16 x 64] . B, B a tile of 64 rows (the sum index) x 64
__device__ __forceinline__ void mma_ab(float (&o)[8][4],
                                       const unsigned (&a)[4][4],
                                       const bf16* B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      ldsm_x4_t(r, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kALd +
                       np * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * np], a[kk], r[0], r[1]);
      mma_bf16(o[2 * np + 1], a[kk], r[2], r[3]);
    }
}

// an accumulator tile [16 x 64] rounded to bf16 as A fragments of the next
// product (its columns become the sum index)
__device__ __forceinline__ void to_afrag(unsigned (&f)[4][4],
                                         const float (&s)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    f[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    f[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// fp32 (3xTF32) counterparts.  An A operand read from a tile stays there
// (SmemA: its fragments are loaded and split at each product, which keeps
// the registers of a 64-deep hi / lo fragment set free); an accumulator
// reused as an A operand is its fp32 values (PF32).
struct SmemA {
  const float* tile;
};
using PF32 = float[8][4];

__device__ __forceinline__ void load_afrag(SmemA& f, const float* tile) {
  f.tile = tile;
}

// s[16 x 64] = a[16 x 64] . B^T in fp32 (3xTF32), B a tile of 64 rows x 64
__device__ __forceinline__ void mma_abt(float (&s)[8][4], const SmemA& a,
                                        const float* B) {
  constexpr int LD = tile_ld<float>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* A = a.tile + (warp * 16 + g) * LD + t;
  const float* Bl = B + g * LD + t;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 8) {
    unsigned ah[4], al[4];
    split_tf32(A[kk], ah[0], al[0]);
    split_tf32(A[8 * LD + kk], ah[1], al[1]);
    split_tf32(A[kk + 4], ah[2], al[2]);
    split_tf32(A[8 * LD + kk + 4], ah[3], al[3]);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      unsigned bh[2], bl[2];
      split_tf32(Bl[ni * 8 * LD + kk], bh[0], bl[0]);
      split_tf32(Bl[ni * 8 * LD + kk + 4], bh[1], bl[1]);
      mma_3xtf32(s[ni], ah, al, bh, bl);
    }
  }
}

// o[16 x 64] += p[16 x 64] . B in fp32 (3xTF32), p an accumulator tile, B
// a tile of 64 rows (the sum index) x 64.  Each 8-wide step takes keys
// 2t and 2t + 1 (p[kk][0..1], p[kk][2..3]: the accumulator's own columns)
// in slots t and t + 4, and B's rows in the same order.
__device__ __forceinline__ void mma_ab(float (&o)[8][4], const PF32& p,
                                       const float* B) {
  constexpr int LD = tile_ld<float>();
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
    for (int ni = 0; ni < 8; ++ni) {
      unsigned bh[2], bl[2];
      split_tf32(Bl[kk * 8 * LD + ni * 8], bh[0], bl[0]);
      split_tf32(Bl[(kk * 8 + 1) * LD + ni * 8], bh[1], bl[1]);
      mma_3xtf32(o[ni], ah, al, bh, bl);
    }
  }
}

// fp32 keeps an accumulator as it is (T(x) = x)
__device__ __forceinline__ void to_afrag(PF32& f, const float (&s)[8][4]) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[ni][e] = s[ni][e];
}

// the fragment types of an element type's products
template <typename E>
struct AttnFrags;
template <>
struct AttnFrags<bf16> {
  using A = unsigned[4][4];  // a tile's fragments, ldmatrix
  using P = unsigned[4][4];  // T(accumulator), packed
  static constexpr int kDkvStages = 2;
  static constexpr int kFwdMinBlocks = 4;
};
template <>
struct AttnFrags<float> {
  using A = SmemA;
  using P = PF32;
  static constexpr int kDkvStages = 1;
  static constexpr int kFwdMinBlocks = 2;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// column of s[ni][e] within its 64-wide tile
__device__ __forceinline__ int acc_col(int ni, int e) {
  return ni * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// 4-byte cp.async (zero-filled when !ok)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// -------------------------------------------------------------- layouts --
// Both layouts address a (sequence g, head h)'s rows alike: q, k, v and
// dq, dk, dv at their base + g N ld + h 64, row stride ld; o, the cotangent
// do and the T(do / l) scratch at + g N ldo + h 64, row stride ldo.  The
// ViT stack: q, k, v = qkv, qkv + C, qkv + 2C of the qkv GEMM's (G, N, 3C)
// output (ld = 3C), o (G, N, C) (ldo = C), one block row per head.  Kernel
// #7: separate (G, N, 64) tensors (ld = ldo = 64), one head per sequence
// (gridDim.y = 1).  The layout type says the rest: the cotangent's dtype,
// whether dq, dk, dv also go out in fp32, and the two rounding points in
// which the two Pallas kernels differ.  The addresses are plain kernel
// parameters: read from a struct parameter instead, the base offsets were
// recomputed in vector registers at every key step, and the ViT forward
// ran 4% slower (H100, 700 W).

// The ViT stack: the cotangent arrives in fp32; for bf16 products the dq
// kernel rounds it into the scratch dob, the dk / dv kernel's operand
// (fp32 products read it as it is).  dq, dk, dv are written in fp32 and,
// for the bf16 qkv Linear's dW and dX products, rounded to bf16 beside
// them.
struct Interleaved {
  using Dout = float;
  static constexpr bool kF32Grads = true;
  // o = (P . v) * (1 / l)
  __device__ static float normalize(float o, float l) { return o * (1.f / l); }
  // d s for s = q.k * scale: e ((dp - c) / l) ln2 scale
  __device__ static float ds(float e, float dp, float c, float l, float scale,
                             float) {
    return e * ((dp - c) / l) * kLn2 * scale;
  }
};

// Kernel #7: the cotangent arrives in the element type and the kernels
// read it as it is; dq, dk, dv go out in it alone (bf16 rounded, fp32
// through put_grad's fp32 branch).
template <typename E>
struct Separate {
  using Dout = E;
  static constexpr bool kF32Grads = false;
  // o / l (pallas_attention.py:66)
  __device__ static float normalize(float o, float l) { return o / l; }
  // e ((dp - c) (d^-1/2 / l)) (pallas_attention.py:93)
  __device__ static float ds(float e, float dp, float c, float l, float,
                             float sm_scale) {
    return e * ((dp - c) * (sm_scale / l));
  }
};

// two adjacent columns of dq, dk or dv at element o: in fp32 to f where the
// layout keeps it (always for fp32 products), in bf16 to b for bf16 ones
template <typename L, typename E>
__device__ __forceinline__ void put_grad(float* f, E* b, size_t o, float x,
                                         float y) {
  if constexpr (sizeof(E) == 4) {
    *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
  } else {
    if constexpr (L::kF32Grads)
      *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
    *reinterpret_cast<__nv_bfloat162*>(b + o) = __floats2bfloat162_rn(x, y);
  }
}

// ------------------------------------------------------------ forward --
// o for 64 query rows of (sequence g, head h) = (blockIdx.z, blockIdx.y).
// The key tiles are walked twice (the max pass, then the P . v pass) as
// one sequence of 2 nk steps through a 2-stage cp.async ring: the next
// step's k (and, in the second pass, v) tile loads while this one's
// products run.  Without kValues only (m, l) are formed and written.
// bf16: four blocks an SM, at most 128 registers a thread; fp32: two of
// its 87 KB blocks.
template <typename E>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return 5 * tile_elems<E>() * sizeof(E);
}

template <typename L, bool kValues, typename E>
__global__ void __launch_bounds__(kAThreads, AttnFrags<E>::kFwdMinBlocks)
attn_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, E* __restrict__ out,
                float* __restrict__ stats, int N, int ld, int ldo,
                float scale) {
  constexpr int TE = tile_elems<E>();
  extern __shared__ __align__(128) unsigned char attn_smem[];
  // q, then the 2-stage rings of k and v tiles.  A stage's tile is found
  // by arithmetic: an array of tile pointers indexed by the stage went to
  // local memory, and the bf16 forward spilled and ran 6% slower (H100).
  E* Qs = reinterpret_cast<E*>(attn_smem);
  auto Ks = [&](int st) { return Qs + (1 + st) * TE; };
  auto Vs = [&](int st) { return Qs + (3 + st) * TE; };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const E* qb = q + in0;
  const E* kb = k + in0;
  const E* vb = v + in0;
  const int nk = (N + kAT - 1) / kAT;

  load_tile(Qs, qb, ld, q0, N);
  load_tile(Ks(0), kb, ld, 0, N);
  cp_async_commit();
  typename AttnFrags<E>::A qf;
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4] = {};
  float s[8][4];
  for (int t = 0; t < 2 * nk; ++t) {
    __syncthreads();  // the stage loaded below was read at step t - 1
    const int tn = t + 1;
    if (tn < 2 * nk) {
      const int kn = (tn % nk) * kAT;
      load_tile(Ks(tn & 1), kb, ld, kn, N);
      if (kValues && tn >= nk) load_tile(Vs(tn & 1), vb, ld, kn, N);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) load_afrag(qf, Qs);
    const int k0 = (t % nk) * kAT;
    mma_abt(s, qf, Ks(t & 1));
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
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev =
            k0 + acc_col(ni, e) < N
                ? exp2f(__fmul_rn(s[ni][e], scale) - mx[e >> 1])
                : 0.f;
        l[e >> 1] += ev;
        s[ni][e] = ev;
      }
    if constexpr (kValues) {
      typename AttnFrags<E>::P pf;
      to_afrag(pf, s);  // P = T(e)
      mma_ab(o, pf, Vs(t & 1));
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  E* ob = out + (size_t)g * N * ldo + h * kHeadDim;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
    if constexpr (kValues) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float x = L::normalize(o[ni][2 * half], l[half]);
        const float y = L::normalize(o[ni][2 * half + 1], l[half]);
        E* dst = ob + (size_t)row * ldo + acc_col(ni, 0);
        if constexpr (sizeof(E) == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x, y);
      }
    }
    if (stats && (lane & 3) == 0) {
      float* st = stats + (((size_t)g * gridDim.y + h) * N + row) * 3;
      st[0] = mx[half];
      st[1] = l[half];
    }
  }
}

// ------------------------------------------------------------------ dq --
// dq for 64 query rows of (g, h); reads (m, l) from stats, writes c there.
// Also writes T(do / l) of its rows to dnb (and, for bf16 products of an
// fp32 cotangent, T(do) to dob), in the layout of do, the dk / dv kernel's
// operands.  bf16: two passes over the key tiles (c = sum(dp e) / l, then
// dq) through a 2-stage ring of k and v tiles.  fp32: one pass, with c =
// do . o from the forward's output o (in the layout of do; it may alias
// dnb, each element read before it is written, by the same thread) -- the
// same value in exact arithmetic, P . v = o l, for 3 N^2 d products in
// place of 5.  dq goes to fq (fp32, where the layout keeps it or the
// products are fp32) and gq (bf16 products).
template <typename E>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return 6 * tile_elems<E>() * sizeof(E);
}

template <typename L, typename E>
__global__ void __launch_bounds__(kAThreads)
attn_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v,
               const typename L::Dout* __restrict__ dout,
               float* __restrict__ stats, E* __restrict__ dob, E* dnb,
               const E* ofwd, float* __restrict__ fq, E* __restrict__ gq,
               int N, int ld, int ldo, float scale, float sm_scale) {
  constexpr int TE = tile_elems<E>(), LD = tile_ld<E>();
  constexpr int kPasses = sizeof(E) == 4 ? 1 : 2;
  __shared__ float crow[kAT];  // fp32: c of the tile's rows
  extern __shared__ __align__(128) unsigned char attn_smem[];
  E* Qs = reinterpret_cast<E*>(attn_smem);
  E* DOs = Qs + TE;
  E* Ks[2] = {Qs + 2 * TE, Qs + 3 * TE};
  E* Vs[2] = {Qs + 4 * TE, Qs + 5 * TE};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const E* qb = q + in0;
  const E* kb = k + in0;
  const E* vb = v + in0;
  float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const size_t obase = (size_t)g * N * ldo + h * kHeadDim;
  const int nk = (N + kAT - 1) / kAT;

  load_tile(Qs, qb, ld, q0, N);
  load_tile(Ks[0], kb, ld, 0, N);
  load_tile(Vs[0], vb, ld, 0, N);
  cp_async_commit();
  // T(do) into the tile, T(do / l) to dnb
#pragma unroll
  for (int u = 0; u < kAT * kHeadDim / 4 / kAThreads; ++u) {
    const int c = tid + u * kAThreads, r = c >> 4, cc = (c & 15) * 4;
    const int row = q0 + r;
    if constexpr (sizeof(E) == 4) {
      static_assert(sizeof(typename L::Dout) == 4, "fp32 cotangent");
      // every lane reaches the shuffles: rows >= N add zeros
      const bool ok = row < N;
      const size_t at = obase + (size_t)(ok ? row : 0) * ldo + cc;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (ok) {
        x = __ldg(reinterpret_cast<const float4*>(dout + at));
        y = *reinterpret_cast<const float4*>(ofwd + at);
      }
      // c = do . o over the row's 16 threads (a half warp), in fixed order
      float cp = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        cp += __shfl_xor_sync(0xffffffffu, cp, off);
      *reinterpret_cast<float4*>(DOs + r * LD + cc) = x;
      if ((c & 15) == 0) crow[r] = cp;
      if (ok) {
        const float li = st[(size_t)row * 3 + 1];
        *reinterpret_cast<float4*>(dnb + at) =
            make_float4(x.x / li, x.y / li, x.z / li, x.w / li);
        if ((c & 15) == 0) st[(size_t)row * 3 + 2] = cp;
      }
    } else {
      if (row >= N) {
        *reinterpret_cast<uint2*>(DOs + r * LD + cc) = make_uint2(0u, 0u);
        continue;
      }
      const size_t o = obase + (size_t)row * ldo + cc;
      float4 x;
      uint2 d;
      if constexpr (L::kF32Grads) {
        x = __ldg(reinterpret_cast<const float4*>(dout + o));
        d = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
        *reinterpret_cast<uint2*>(dob + o) = d;
      } else {
        d = __ldg(reinterpret_cast<const uint2*>(dout + o));
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&d.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&d.y));
        x = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      const float li = st[(size_t)row * 3 + 1];
      *reinterpret_cast<uint2*>(DOs + r * LD + cc) = d;
      *reinterpret_cast<uint2*>(dnb + o) = make_uint2(
          pack_bf16(x.x / li, x.y / li), pack_bf16(x.z / li, x.w / li));
    }
  }
  float m[2], l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    m[half] = row < N ? st[(size_t)row * 3] : 0.f;
    l[half] = row < N ? st[(size_t)row * 3 + 1] : 1.f;
  }

  typename AttnFrags<E>::A qf, df;
  float s[8][4], dp[8][4];
  float csum[2] = {0.f, 0.f}, c[2];
  float dq[8][4] = {};
  for (int t = 0; t < kPasses * nk; ++t) {
    __syncthreads();
    if (kPasses == 1 && t == 0) {  // crow is complete
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + (lane >> 2) + half * 8;
        c[half] = q0 + r < N ? crow[r] : 0.f;
      }
    }
    const int tn = t + 1;
    if (tn < kPasses * nk) {
      const int kn = (tn % nk) * kAT;
      load_tile(Ks[tn & 1], kb, ld, kn, N);
      load_tile(Vs[tn & 1], vb, ld, kn, N);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_afrag(qf, Qs);
      load_afrag(df, DOs);
    }
    const int k0 = (t % nk) * kAT;
    mma_abt(s, qf, Ks[t & 1]);
    mma_abt(dp, df, Vs[t & 1]);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = k0 + acc_col(ni, e) < N
                       ? exp2f(__fmul_rn(s[ni][e], scale) - m[e >> 1])
                       : 0.f;
    if (kPasses == 2 && t < nk) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) csum[e >> 1] += dp[ni][e] * s[ni][e];
      if (t == nk - 1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          c[half] = quad_sum(csum[half]) / l[half];
          const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
          if (row < N && (lane & 3) == 0) st[(size_t)row * 3 + 2] = c[half];
        }
      }
      continue;
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        dp[ni][e] = L::ds(s[ni][e], dp[ni][e], c[r], l[r], scale, sm_scale);
      }
    typename AttnFrags<E>::P dsf;
    to_afrag(dsf, dp);  // T(ds)
    mma_ab(dq, dsf, Ks[t & 1]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put_grad<L>(fq, gq, in0 + (size_t)row * ld + acc_col(ni, 0),
                  dq[ni][2 * half], dq[ni][2 * half + 1]);
  }
}

// ------------------------------------------------------------- dk, dv --
// dk and dv for 64 keys of (g, h), walking every query tile through a
// cp.async ring of (q, T(do), T(do / l), (m, l, c)) tiles (2 stages for
// bf16; 1 for fp32, whose 2-stage block would take 141 KB, one an SM);
// dob is T(do) in the layout of do (the cotangent itself for kernel #7
// and fp32).  dk and dv go to fk, fv (fp32, where the layout keeps them)
// and gk, gv (bf16 products).
constexpr int kDkvStats = 3 * kAT;  // (m, l, c) of a query tile

template <typename E>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  constexpr int S = AttnFrags<E>::kDkvStages;
  return (2 + 3 * S) * tile_elems<E>() * sizeof(E) +
         S * kDkvStats * sizeof(float);
}

template <typename L, typename E>
__global__ void __launch_bounds__(kAThreads)
attn_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const E* __restrict__ dob,
                const E* __restrict__ dnb, const float* __restrict__ stats,
                float* __restrict__ fk, float* __restrict__ fv,
                E* __restrict__ gk, E* __restrict__ gv, int N, int ld,
                int ldo, float scale, float sm_scale) {
  constexpr int S = AttnFrags<E>::kDkvStages, TE = tile_elems<E>();
  extern __shared__ __align__(128) unsigned char attn_smem[];
  E* Ks = reinterpret_cast<E*>(attn_smem);
  E* Vs = Ks + TE;
  E* Qs[2] = {Ks + 2 * TE, Ks + (2 + S - 1) * TE};
  E* DOs[2] = {Ks + (2 + S) * TE, Ks + (2 + 2 * S - 1) * TE};
  E* DNs[2] = {Ks + (2 + 2 * S) * TE, Ks + (2 + 3 * S - 1) * TE};
  // [S][192]
  float* Ss = reinterpret_cast<float*>(Ks + (2 + 3 * S) * TE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const E* qb = q + in0;
  const size_t obase = (size_t)g * N * ldo + h * kHeadDim;
  const float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const int nq = (N + kAT - 1) / kAT;

  auto prefetch = [&](int q0, int stage) {
    load_tile(Qs[stage], qb, ld, q0, N);
    load_tile(DOs[stage], dob + obase, ldo, q0, N);
    load_tile(DNs[stage], dnb + obase, ldo, q0, N);
    const int valid = 3 * min(kAT, N - q0);
    for (int i = tid; i < kDkvStats; i += kAThreads)
      cp_async4(Ss + stage * kDkvStats + i,
                st + (size_t)q0 * 3 + (i < valid ? i : 0), i < valid);
  };
  load_tile(Ks, k + in0, ld, k0, N);
  load_tile(Vs, v + in0, ld, k0, N);
  if constexpr (S == 2) prefetch(0, 0);
  cp_async_commit();

  typename AttnFrags<E>::A kf, vf;
  float dk[8][4] = {}, dv[8][4] = {};
  float s[8][4], dp[8][4];
  for (int it = 0; it < nq; ++it) {
    __syncthreads();  // the stage loaded below was read at it - 1
    if constexpr (S == 2) {
      if (it + 1 < nq) prefetch((it + 1) * kAT, (it + 1) & 1);
    } else {
      prefetch(it * kAT, 0);
    }
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    if (it == 0) {
      load_afrag(kf, Ks);
      load_afrag(vf, Vs);
    }
    const int q0 = it * kAT, b = S == 2 ? it & 1 : 0;
    const float* sr = Ss + b * kDkvStats;
    mma_abt(s, kf, Qs[b]);    // s^T: rows keys, columns queries
    mma_abt(dp, vf, DOs[b]);  // dp^T
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e);
        const bool ok = q0 + j < N;
        const float mj = sr[3 * j], lj = sr[3 * j + 1], cj = sr[3 * j + 2];
        const float ev = exp2f(__fmul_rn(s[ni][e], scale) - mj);
        s[ni][e] = ok ? ev : 0.f;
        dp[ni][e] = ok ? L::ds(ev, dp[ni][e], cj, lj, scale, sm_scale) : 0.f;
      }
    typename AttnFrags<E>::P pf, dsf;
    to_afrag(pf, s);    // T(e)^T
    to_afrag(dsf, dp);  // T(ds)^T
    mma_ab(dv, pf, DNs[b]);
    mma_ab(dk, dsf, Qs[b]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const size_t o = in0 + (size_t)row * ld + acc_col(ni, 0);
      put_grad<L>(fk, gk, o, dk[ni][2 * half], dk[ni][2 * half + 1]);
      put_grad<L>(fv, gv, o, dv[ni][2 * half], dv[ni][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers --
// The grid is (query or key tiles, heads, G): G and heads at most 65,535.
// scale = d^-1/2 log2(e) multiplies the scores; sm_scale = d^-1/2 is #7's
// factor of ds.

// the kernel's dynamic shared memory, where it exceeds the default 48 KB
template <class K>
static cudaError_t smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the forward (or, without kValues, its (m, l) alone) over G sequences x
// heads; with `stats`, (m, l) per row at stats[((g * heads + h) * N + row)
// * 3]
template <typename L, bool kValues = true, typename E>
static cudaError_t attention_fwd(const E* q, const nd_t<E>* k,
                                 const nd_t<E>* v, nd_t<E>* out,
                                 float* stats, int G, int heads, int N,
                                 int ld, int ldo, float scale,
                                 cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<E>();
  cudaError_t err = smem_attr(attn_fwd_kernel<L, kValues, E>, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<L, kValues, E>
      <<<dim3((N + kAT - 1) / kAT, heads, G), kAThreads, smem, stream>>>(
          q, k, v, out, stats, N, ld, ldo, scale);
  return cudaGetLastError();
}

// dq, dk, dv (to f* in fp32 where the layout keeps them or the products
// are fp32, and g* in bf16 for bf16 ones) from the cotangent dout and the
// forward's (m, l) in stats (c is written into their third slot); dnb is
// scratch in the layout of do for T(do / l), dob (bf16 products of an fp32
// cotangent) for T(do); o, the forward's output in the layout of do, is
// read by fp32 products (it may be dnb)
template <typename L, typename E>
static cudaError_t attention_bwd(const E* q, const nd_t<E>* k,
                                 const nd_t<E>* v,
                                 const typename L::Dout* dout, float* stats,
                                 nd_t<E>* dob, nd_t<E>* dnb,
                                 const nd_t<E>* o, float* fq,
                                 float* fk, float* fv, nd_t<E>* gq,
                                 nd_t<E>* gk, nd_t<E>* gv, int G, int heads,
                                 int N, int ld, int ldo, float scale,
                                 float sm_scale, cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem_q = dq_smem_bytes<E>(), smem_kv = dkv_smem_bytes<E>();
  cudaError_t err = smem_attr(attn_dq_kernel<L, E>, smem_q);
  if (err != cudaSuccess) return err;
  err = smem_attr(attn_dkv_kernel<L, E>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kAT - 1) / kAT, heads, G);
  if (sizeof(E) == 4 && o == nullptr) return cudaErrorInvalidValue;
  attn_dq_kernel<L, E><<<grid, kAThreads, smem_q, stream>>>(
      q, k, v, dout, stats, dob, dnb, o, fq, gq, N, ld, ldo, scale,
      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const E* dkv_do;
  if constexpr (sizeof(E) == 4 || !L::kF32Grads)
    dkv_do = dout;
  else
    dkv_do = dob;
  attn_dkv_kernel<L, E><<<grid, kAThreads, smem_kv, stream>>>(
      q, k, v, dkv_do, dnb, stats, fk, fv, gk, gv, N, ld, ldo, scale,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rp

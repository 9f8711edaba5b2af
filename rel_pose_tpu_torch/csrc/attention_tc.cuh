// Softmax attention over 64-wide heads on the tensor cores, forward and
// backward: the ViT stack's self-attention (kernels #1 and #5) and the
// --noess cross attention (kernel #7).  Both dtypes run on Hopper's wgmma
// with TMA-fed tiles: bf16 on attention_wgmma.cuh, fp32 as 3xTF32 on
// attention_wgmma_f32.cuh, to which attention_fwd / attention_bwd below send
// them.  This header holds what the two bodies and the essential block
// share: the two layouts (Interleaved, Separate), which say how a (sequence,
// head)'s rows are addressed, in which dtype the cotangent arrives and the
// gradients leave, and the two rounding points in which the two Pallas
// kernels differ; and the 64-row mma.sync tile helpers of the essential
// block's body (essential_tc.cuh, essential_tc_bwd.cuh): load_tile,
// load_afrag, mma_abt, mma_ab and to_afrag in both element types (bf16
// m16n8k16 with ldmatrix; fp32 3xTF32 on m16n8k8, each operand split into
// TF32 hi + lo in registers, the A operand read from its tile (SmemA), an
// accumulator reused as the next product's A operand with key 2t in slot t
// and key 2t + 1 in slot t + 4 of each 8-key step, B read in that order),
// AttnFrags.
//
// Replaces (through the two bodies)
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel (forward, with the
//     row statistics the backward reads) and pallas_vit_bwd.py:
//     _attn_fwd_heads / _attn_bwd_heads (dq, dk, dv), layout Interleaved:
//     q, k, v read from the qkv GEMM's (G, N, 3C) output, head h at columns
//     h*64, C + h*64, 2C + h*64 (vit_stack.cu);
//   - rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel and _bwd_kernel,
//     layout Separate<E>: (G, N, 64) q, k, v, o, do, dq, dk, dv, one head
//     per sequence (mhsa.cu).

#pragma once

#include "attention_wgmma.cuh"
#include "attention_wgmma_f32.cuh"
#include "mma_helpers.cuh"

namespace rp {
namespace tc {

constexpr float kLn2 = 0.6931471805599453f;

constexpr int kAT = 64;                   // rows of a query or key tile
constexpr int kALd = kHeadDim + 8;        // padded bf16 row of a tile
constexpr int kAThreads = 128;            // 4 warps x 16 rows

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
};
template <>
struct AttnFrags<float> {
  using A = SmemA;
  using P = PF32;
};

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
// read it as it is; dq, dk, dv go out in it alone.
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

// ------------------------------------------------------------ launchers --
// The grid is (query or key tiles, heads, G): G and heads at most 65,535.
// scale = d^-1/2 log2(e) multiplies the scores; sm_scale = d^-1/2 is #7's
// factor of ds.

// the forward over G sequences x heads; with `stats`, (m, l) per row at
// stats[((g * heads + h) * N + row) * 3]
template <typename L>
static cudaError_t attention_fwd(const float* q, const float* k,
                                 const float* v, float* out, float* stats,
                                 int G, int heads, int N, int ld, int ldo,
                                 float scale, cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  return wg::attention_fwd<L>(q, k, v, out, stats, G, heads, N, ld, ldo,
                              scale, stream);
}
template <typename L>
static cudaError_t attention_fwd(const bf16* q, const bf16* k, const bf16* v,
                                 bf16* out, float* stats, int G, int heads,
                                 int N, int ld, int ldo, float scale,
                                 cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  return wg::attention_fwd<L>(q, k, v, out, stats, G, heads, N, ld, ldo,
                              scale, stream);
}

// dq, dk, dv (to f* in fp32; for bf16 also, or only, to g* as the layout
// says) from the cotangent dout, the forward's output o (in the layout of
// do; it may be dnb) and its (m, l) in stats (c is written into their
// third slot); dnb is scratch in the layout of do for T(do / l), dob
// (bf16 products of an fp32 cotangent) for T(do)
template <typename L>
static cudaError_t attention_bwd(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 float* stats, float*, float* dnb,
                                 const float* o, float* fq, float* fk,
                                 float* fv, float*, float*, float*, int G,
                                 int heads, int N, int ld, int ldo,
                                 float scale, float sm_scale,
                                 cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  return wg::attention_bwd<L>(q, k, v, dout, stats, dnb, o, fq, fk, fv, G,
                              heads, N, ld, ldo, scale, sm_scale, stream);
}
template <typename L>
static cudaError_t attention_bwd(const bf16* q, const bf16* k, const bf16* v,
                                 const typename L::Dout* dout, float* stats,
                                 bf16* dob, bf16* dnb, const bf16* o,
                                 float* fq, float* fk, float* fv, bf16* gq,
                                 bf16* gk, bf16* gv, int G, int heads, int N,
                                 int ld, int ldo, float scale, float sm_scale,
                                 cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  return wg::attention_bwd<L>(q, k, v, dout, stats, dob, dnb, o, fq, fk, fv,
                              gq, gk, gv, G, heads, N, ld, ldo, scale,
                              sm_scale, stream);
}

}  // namespace tc
}  // namespace rp

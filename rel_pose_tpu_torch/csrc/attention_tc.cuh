// Softmax attention over 64-wide heads on the tensor cores, forward and
// backward: the ViT stack's self-attention (kernels #1 and #5) and the
// --noess cross attention (kernel #7).  This header holds the two layouts
// and the fp32 body; bf16 runs the wgmma + TMA body of attention_wgmma.cuh,
// to which attention_fwd / attention_bwd below send it.  Its 64-row tile
// helpers (load_tile, load_afrag, mma_abt, mma_ab, to_afrag in both element
// types, AttnFrags; bf16's to_afrag in attention_wgmma.cuh) are also the
// essential block's (essential_tc.cuh).
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
// kernels differ.  fp32 products run as 3xTF32 on mma.sync m16n8k8 (each
// operand split into TF32 hi + lo in registers, hi.hi + hi.lo + lo.hi
// summed in fp32: fp32 accuracy).
//
// What bounds the fp32 kernels on the H100: the products, 2 N^2 d
// multiply-adds a head for the forward's two (QK^T, PV), 32 operations per
// byte of fp32 q, k, v and o at N = 576 and d = 64 -- under the 49 of
// 3xTF32's 165 TFLOP/s, so at full rate HBM would bound them; here the
// mma.sync throughput, the exp2 of every score and the split of every
// operand decide.
//
// Design: one block of 4 warps per (64-query or 64-key tile, head,
// sequence); each warp owns 16 rows, and every product is mma.sync with its
// operands from padded 64 x 64 shared-memory tiles (32-bit loads; an
// accumulator reused as the next product's A operand keeps its registers,
// the k index permuted so that key 2t sits in slot t and key 2t + 1 in slot
// t + 4 of each 8-key step, B read in the same order).  Scores stay in
// registers and the Pallas kernels' rounding points are kept exactly, with
// no online rescaling:
//   forward: a first pass over the key tiles takes the exact row max m of
//     s = (q . k) * scale (scale = d^-1/2 log2 e, the product rounded on
//     its own); a second recomputes s, e = exp2(s - m), the fp32 row sum l
//     and e . v; o = layout's normalize(e . v, l).  That is 3 N^2 d
//     multiply-adds instead of 2, the price of exact statistics without
//     147 KB of score rows in shared memory.  With `stats`, (m, l) per row.
//   dq (per query tile, (m, l) from stats): c = do . o from the forward's
//     output (equal to sum(dp e) / l in exact arithmetic), then one pass:
//     e, dp = do . v^T, ds = layout's ds(e, dp, c, l) and dq = ds . k.  c
//     goes to stats, and do / l to scratch, for the dk / dv kernel.
//   dk, dv (per key tile, walking the query tiles): s^T = k . q^T and
//     dp^T = v . do^T, with each query's (m, l, c) from stats;
//     dv += e^T . (do / l), dk += ds^T . q.
// Rows >= N load as zeros and keys >= N are masked out of every sum.
// Tiles stream through cp.async (the forward and dq kernels a 2-stage ring;
// the dk / dv kernel one stage, so that two of its 87 KB blocks share an
// SM): the next step's tiles load while this step's products run.  Every
// sum runs in a fixed order and nothing uses atomics: two calls give the
// same bits.

#pragma once

#include "attention_wgmma.cuh"
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

// the fp32 kernels' tiles
constexpr int kFLd = tile_ld<float>();
constexpr int kFTileElems = tile_elems<float>();

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

// two adjacent columns of fp32 dq, dk or dv at element o
__device__ __forceinline__ void put_grad(float* f, size_t o, float x,
                                         float y) {
  *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
}

// ------------------------------------------------------------ forward --
// o for 64 query rows of (sequence g, head h) = (blockIdx.z, blockIdx.y).
// The key tiles are walked twice (the max pass, then the P . v pass) as
// one sequence of 2 nk steps through a 2-stage cp.async ring: the next
// step's k (and, in the second pass, v) tile loads while this one's
// products run.  Two of its 87 KB blocks an SM.
constexpr size_t kFwdSmemBytes = 5 * kFTileElems * sizeof(float);

template <typename L>
__global__ void __launch_bounds__(kAThreads, 2)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ stats, int N, int ld, int ldo,
                float scale) {
  constexpr int TE = kFTileElems;
  extern __shared__ __align__(128) unsigned char attn_smem[];
  // q, then the 2-stage rings of k and v tiles.  A stage's tile is found
  // by arithmetic: an array of tile pointers indexed by the stage went to
  // local memory, and the bf16 forward spilled and ran 6% slower (H100).
  float* Qs = reinterpret_cast<float*>(attn_smem);
  auto Ks = [&](int st) { return Qs + (1 + st) * TE; };
  auto Vs = [&](int st) { return Qs + (3 + st) * TE; };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const float* qb = q + in0;
  const float* kb = k + in0;
  const float* vb = v + in0;
  const int nk = (N + kAT - 1) / kAT;

  load_tile(Qs, qb, ld, q0, N);
  load_tile(Ks(0), kb, ld, 0, N);
  cp_async_commit();
  SmemA qf;
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
      if (tn >= nk) load_tile(Vs(tn & 1), vb, ld, kn, N);
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
    mma_ab(o, s, Vs(t & 1));
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  float* ob = out + (size_t)g * N * ldo + h * kHeadDim;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float x = L::normalize(o[ni][2 * half], l[half]);
      const float y = L::normalize(o[ni][2 * half + 1], l[half]);
      *reinterpret_cast<float2*>(ob + (size_t)row * ldo + acc_col(ni, 0)) =
          make_float2(x, y);
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
// Also writes do / l of its rows to dnb, in the layout of do, the dk / dv
// kernel's operand.  One pass over the key tiles through a 2-stage ring of
// k and v tiles, with c = do . o from the forward's output o (in the
// layout of do; it may alias dnb, each element read before it is written,
// by the same thread) -- the same value in exact arithmetic as the Pallas
// kernel's sum(dp e) / l, P . v = o l, for 3 N^2 d products in place of 5.
// dq goes to fq.
constexpr size_t kDqSmemBytes = 6 * kFTileElems * sizeof(float);

template <typename L>
__global__ void __launch_bounds__(kAThreads)
attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v,
               const typename L::Dout* __restrict__ dout,
               float* __restrict__ stats, float* dnb, const float* ofwd,
               float* __restrict__ fq, int N, int ld, int ldo, float scale,
               float sm_scale) {
  constexpr int TE = kFTileElems, LD = kFLd;
  static_assert(sizeof(typename L::Dout) == 4, "fp32 cotangent");
  __shared__ float crow[kAT];  // c of the tile's rows
  extern __shared__ __align__(128) unsigned char attn_smem[];
  float* Qs = reinterpret_cast<float*>(attn_smem);
  float* DOs = Qs + TE;
  float* Ks[2] = {Qs + 2 * TE, Qs + 3 * TE};
  float* Vs[2] = {Qs + 4 * TE, Qs + 5 * TE};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const float* qb = q + in0;
  const float* kb = k + in0;
  const float* vb = v + in0;
  float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const size_t obase = (size_t)g * N * ldo + h * kHeadDim;
  const int nk = (N + kAT - 1) / kAT;

  load_tile(Qs, qb, ld, q0, N);
  load_tile(Ks[0], kb, ld, 0, N);
  load_tile(Vs[0], vb, ld, 0, N);
  cp_async_commit();
  // do into the tile, do / l to dnb
#pragma unroll
  for (int u = 0; u < kAT * kHeadDim / 4 / kAThreads; ++u) {
    const int c = tid + u * kAThreads, r = c >> 4, cc = (c & 15) * 4;
    const int row = q0 + r;
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
  }
  float m[2], l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    m[half] = row < N ? st[(size_t)row * 3] : 0.f;
    l[half] = row < N ? st[(size_t)row * 3 + 1] : 1.f;
  }

  SmemA qf, df;
  float s[8][4], dp[8][4];
  float c[2];
  float dq[8][4] = {};
  for (int t = 0; t < nk; ++t) {
    __syncthreads();
    if (t == 0) {  // crow is complete
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + (lane >> 2) + half * 8;
        c[half] = q0 + r < N ? crow[r] : 0.f;
      }
    }
    const int tn = t + 1;
    if (tn < nk) {
      const int kn = tn * kAT;
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
    const int k0 = t * kAT;
    mma_abt(s, qf, Ks[t & 1]);
    mma_abt(dp, df, Vs[t & 1]);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = k0 + acc_col(ni, e) < N
                       ? exp2f(__fmul_rn(s[ni][e], scale) - m[e >> 1])
                       : 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        dp[ni][e] = L::ds(s[ni][e], dp[ni][e], c[r], l[r], scale, sm_scale);
      }
    mma_ab(dq, dp, Ks[t & 1]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put_grad(fq, in0 + (size_t)row * ld + acc_col(ni, 0), dq[ni][2 * half],
               dq[ni][2 * half + 1]);
  }
}

// ------------------------------------------------------------- dk, dv --
// dk and dv for 64 keys of (g, h), walking every query tile through a
// one-stage cp.async buffer of (q, do, do / l, (m, l, c)) tiles (two
// stages would take 141 KB, one block an SM); do is the cotangent itself.
// dk and dv go to fk, fv.
constexpr int kDkvStats = 3 * kAT;  // (m, l, c) of a query tile
constexpr size_t kDkvSmemBytes =
    5 * kFTileElems * sizeof(float) + kDkvStats * sizeof(float);

template <typename L>
__global__ void __launch_bounds__(kAThreads)
attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dob,
                const float* __restrict__ dnb,
                const float* __restrict__ stats, float* __restrict__ fk,
                float* __restrict__ fv, int N, int ld, int ldo, float scale,
                float sm_scale) {
  constexpr int TE = kFTileElems;
  extern __shared__ __align__(128) unsigned char attn_smem[];
  float* Ks = reinterpret_cast<float*>(attn_smem);
  float* Vs = Ks + TE;
  float* Qs = Ks + 2 * TE;
  float* DOs = Ks + 3 * TE;
  float* DNs = Ks + 4 * TE;
  float* Ss = Ks + 5 * TE;  // [192]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const float* qb = q + in0;
  const size_t obase = (size_t)g * N * ldo + h * kHeadDim;
  const float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const int nq = (N + kAT - 1) / kAT;

  auto prefetch = [&](int q0) {
    load_tile(Qs, qb, ld, q0, N);
    load_tile(DOs, dob + obase, ldo, q0, N);
    load_tile(DNs, dnb + obase, ldo, q0, N);
    const int valid = 3 * min(kAT, N - q0);
    for (int i = tid; i < kDkvStats; i += kAThreads)
      cp_async4(Ss + i, st + (size_t)q0 * 3 + (i < valid ? i : 0),
                i < valid);
  };
  load_tile(Ks, k + in0, ld, k0, N);
  load_tile(Vs, v + in0, ld, k0, N);
  cp_async_commit();

  SmemA kf, vf;
  float dk[8][4] = {}, dv[8][4] = {};
  float s[8][4], dp[8][4];
  for (int it = 0; it < nq; ++it) {
    __syncthreads();  // the buffer loaded below was read at it - 1
    prefetch(it * kAT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (it == 0) {
      load_afrag(kf, Ks);
      load_afrag(vf, Vs);
    }
    const int q0 = it * kAT;
    mma_abt(s, kf, Qs);    // s^T: rows keys, columns queries
    mma_abt(dp, vf, DOs);  // dp^T
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e);
        const bool ok = q0 + j < N;
        const float mj = Ss[3 * j], lj = Ss[3 * j + 1], cj = Ss[3 * j + 2];
        const float ev = exp2f(__fmul_rn(s[ni][e], scale) - mj);
        s[ni][e] = ok ? ev : 0.f;
        dp[ni][e] = ok ? L::ds(ev, dp[ni][e], cj, lj, scale, sm_scale) : 0.f;
      }
    mma_ab(dv, s, DNs);
    mma_ab(dk, dp, Qs);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const size_t o = in0 + (size_t)row * ld + acc_col(ni, 0);
      put_grad(fk, o, dk[ni][2 * half], dk[ni][2 * half + 1]);
      put_grad(fv, o, dv[ni][2 * half], dv[ni][2 * half + 1]);
    }
  }
}

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
  cudaError_t err = smem_attr(attn_fwd_kernel<L>, kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<L><<<dim3((N + kAT - 1) / kAT, heads, G), kAThreads,
                       kFwdSmemBytes, stream>>>(q, k, v, out, stats, N, ld,
                                                ldo, scale);
  return cudaGetLastError();
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
  if (heads > 65535 || G > 65535 || o == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = smem_attr(attn_dq_kernel<L>, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  err = smem_attr(attn_dkv_kernel<L>, kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kAT - 1) / kAT, heads, G);
  attn_dq_kernel<L><<<grid, kAThreads, kDqSmemBytes, stream>>>(
      q, k, v, dout, stats, dnb, o, fq, N, ld, ldo, scale, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dkv_kernel<L><<<grid, kAThreads, kDkvSmemBytes, stream>>>(
      q, k, v, dout, dnb, stats, fk, fv, N, ld, ldo, scale, sm_scale);
  return cudaGetLastError();
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

// Softmax attention over 64-wide heads on the tensor cores, bf16, forward
// and backward: the ViT stack's self-attention (kernels #1 and #5) and the
// --noess cross attention (kernel #7).
//
// Replaces, for bf16 only, attention.cuh's SIMT kernels inside
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel (forward, with the
//     row statistics the backward reads) and pallas_vit_bwd.py:
//     _attn_bwd_heads (dq, dk, dv), layout Interleaved: q, k, v read from
//     the qkv GEMM's (G, N, 3C) output, head h at columns h*64, C + h*64,
//     2C + h*64 (vit_stack.cu);
//   - rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel and _bwd_kernel,
//     layout Separate: (G, N, 64) q, k, v, o, do, dq, dk, dv, one head per
//     sequence (mhsa.cu).
// fp32 stays on attention.cuh.  The kernels take base pointers and row
// strides, and are templates on a layout type, which says in which dtype
// the cotangent arrives and the gradients leave, and the two rounding
// points in which the two Pallas kernels differ.
//
// What bounds them on the H100: the products, 2 N^2 d multiply-adds a head
// for the forward's two (QK^T, PV), which at N = 576 and d = 64 is 64
// operations per byte of q, k, v and o -- below the 295 of the bf16 tensor
// cores, so at full rate HBM would bound them; here the mma.sync
// throughput and the exp2 of every score decide.
//
// Design: one block of 4 warps per (64-query or 64-key tile, head,
// sequence); each warp owns 16 rows, and every product is mma.sync
// m16n8k16 with its operands from padded 64 x 64 bf16 shared-memory tiles
// (ldmatrix, .trans where the product reads a tile along its rows).
// Scores stay in registers and the Pallas kernels' rounding points are
// kept exactly, with no online rescaling:
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
//     ds = T(layout's ds(e, dp, c, l)) and dq = ds . k.  c goes to stats,
//     and T(do / l) to bf16 scratch (and, for the ViT's fp32 cotangent,
//     T(do)), for the dk / dv kernel.
//   dk, dv (per key tile, walking the query tiles): s^T = k . q^T and
//     dp^T = v . T(do)^T, with each query's (m, l, c) from stats;
//     dv += T(e)^T . T(do / l), dk += T(ds)^T . q.
// Rows >= N load as zeros and keys >= N are masked out of every sum.
// Tiles stream through 2-stage cp.async rings: the next step's tiles load
// while this step's products run.
// Every sum runs in a fixed order and nothing uses atomics: two calls give
// the same bits.

#pragma once

#include "attention.cuh"
#include "gemm_tc.cuh"

namespace rp {
namespace tc {

constexpr int kAT = 64;                   // rows of a query or key tile
constexpr int kALd = kHeadDim + 8;        // padded bf16 row of a tile
constexpr int kAThreads = 128;            // 4 warps x 16 rows
constexpr int kATileElems = kAT * kALd;

// rows [row0, row0 + 64) of a (rows, 64) bf16 slice with row stride ld into
// a tile; rows >= N load as zeros
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld, int row0, int N) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kAT * kHeadDim / 8 / kAThreads; ++u) {
    const int c = tid + u * kAThreads, r = c >> 3, cc = (c & 7) * 8;
    const bool ok = row0 + r < N;
    cp_async16(dst + r * kALd + cc, src + (size_t)(ok ? row0 + r : 0) * ld + cc,
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

// The ViT stack: the cotangent arrives in fp32 and the dq kernel rounds it
// into the scratch dob, the dk / dv kernel's operand; dq, dk, dv are
// written in fp32 and, for the qkv Linear's dW and dX products, rounded to
// bf16 beside them.
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

// Kernel #7: the cotangent arrives in bf16 and the kernels read it as it
// is; dq, dk, dv go out in bf16 only.
struct Separate {
  using Dout = bf16;
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
// layout keeps it, in bf16 to b
template <typename L>
__device__ __forceinline__ void put_grad(float* f, bf16* b, size_t o,
                                         float x, float y) {
  if constexpr (L::kF32Grads)
    *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
  *reinterpret_cast<__nv_bfloat162*>(b + o) = __floats2bfloat162_rn(x, y);
}

// ------------------------------------------------------------ forward --
// o for 64 query rows of (sequence g, head h) = (blockIdx.z, blockIdx.y).
// The key tiles are walked twice (the max pass, then the P . v pass) as
// one sequence of 2 nk steps through a 2-stage cp.async ring: the next
// step's k (and, in the second pass, v) tile loads while this one's
// products run.  Without kValues only (m, l) are formed and written.
// Four blocks an SM: at most 128 registers a thread.
template <typename L, bool kValues>
__global__ void __launch_bounds__(kAThreads, 4)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ stats, int N, int ld, int ldo,
                float scale) {
  __shared__ __align__(128) bf16 Qs[kATileElems];
  __shared__ __align__(128) bf16 Ks[2][kATileElems];
  __shared__ __align__(128) bf16 Vs[2][kATileElems];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const bf16* qb = q + in0;
  const bf16* kb = k + in0;
  const bf16* vb = v + in0;
  const int nk = (N + kAT - 1) / kAT;

  load_tile(Qs, qb, ld, q0, N);
  load_tile(Ks[0], kb, ld, 0, N);
  cp_async_commit();
  unsigned qf[4][4];
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4] = {};
  float s[8][4];
  for (int t = 0; t < 2 * nk; ++t) {
    __syncthreads();  // the stage loaded below was read at step t - 1
    const int tn = t + 1;
    if (tn < 2 * nk) {
      const int kn = (tn % nk) * kAT;
      load_tile(Ks[tn & 1], kb, ld, kn, N);
      if (kValues && tn >= nk) load_tile(Vs[tn & 1], vb, ld, kn, N);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) load_afrag(qf, Qs);
    const int k0 = (t % nk) * kAT;
    mma_abt(s, qf, Ks[t & 1]);
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
      unsigned pf[4][4];
      to_afrag(pf, s);  // P = T(e)
      mma_ab(o, pf, Vs[t & 1]);
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  bf16* ob = out + (size_t)g * N * ldo + h * kHeadDim;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
    if constexpr (kValues) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * ldo +
                                           acc_col(ni, 0)) =
            __floats2bfloat162_rn(L::normalize(o[ni][2 * half], l[half]),
                                  L::normalize(o[ni][2 * half + 1], l[half]));
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
// Also writes T(do / l) of its rows to dnb (and, for an fp32 cotangent,
// T(do) to dob), in the layout of do, the dk / dv kernel's operands.  Two
// passes over the key tiles (c, then dq) through a 2-stage ring of k and v
// tiles.  dq goes to fq (fp32, where the layout keeps it) and gq.
constexpr size_t kDqSmemBytes = 6 * kATileElems * sizeof(bf16);

template <typename L>
__global__ void __launch_bounds__(kAThreads)
attn_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v,
               const typename L::Dout* __restrict__ dout,
               float* __restrict__ stats, bf16* __restrict__ dob,
               bf16* __restrict__ dnb, float* __restrict__ fq,
               bf16* __restrict__ gq, int N, int ld, int ldo, float scale,
               float sm_scale) {
  extern __shared__ __align__(128) bf16 sm[];
  bf16* Qs = sm;
  bf16* DOs = sm + kATileElems;
  bf16* Ks[2] = {sm + 2 * kATileElems, sm + 3 * kATileElems};
  bf16* Vs[2] = {sm + 4 * kATileElems, sm + 5 * kATileElems};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const bf16* qb = q + in0;
  const bf16* kb = k + in0;
  const bf16* vb = v + in0;
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
    if (row >= N) {
      *reinterpret_cast<uint2*>(DOs + r * kALd + cc) = make_uint2(0u, 0u);
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
    *reinterpret_cast<uint2*>(DOs + r * kALd + cc) = d;
    *reinterpret_cast<uint2*>(dnb + o) = make_uint2(
        pack_bf16(x.x / li, x.y / li), pack_bf16(x.z / li, x.w / li));
  }
  float m[2], l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    m[half] = row < N ? st[(size_t)row * 3] : 0.f;
    l[half] = row < N ? st[(size_t)row * 3 + 1] : 1.f;
  }

  unsigned qf[4][4], df[4][4];
  float s[8][4], dp[8][4];
  float csum[2] = {0.f, 0.f}, c[2];
  float dq[8][4] = {};
  for (int t = 0; t < 2 * nk; ++t) {
    __syncthreads();
    const int tn = t + 1;
    if (tn < 2 * nk) {
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
    if (t < nk) {
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
    unsigned dsf[4][4];
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
// 2-stage cp.async ring of (q, T(do), T(do / l), (m, l, c)) tiles; dob is
// T(do) in the layout of do (the cotangent itself for kernel #7).  dk and
// dv go to fk, fv (fp32, where the layout keeps them) and gk, gv.
constexpr int kDkvStats = 3 * kAT;  // (m, l, c) of a query tile
constexpr size_t kDkvSmemBytes =
    (8 * kATileElems) * sizeof(bf16) + 2 * kDkvStats * sizeof(float);

template <typename L>
__global__ void __launch_bounds__(kAThreads)
attn_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dob,
                const bf16* __restrict__ dnb,
                const float* __restrict__ stats, float* __restrict__ fk,
                float* __restrict__ fv, bf16* __restrict__ gk,
                bf16* __restrict__ gv, int N, int ld, int ldo, float scale,
                float sm_scale) {
  extern __shared__ __align__(128) bf16 sm[];
  bf16* Ks = sm;
  bf16* Vs = sm + kATileElems;
  bf16* Qs[2] = {sm + 2 * kATileElems, sm + 3 * kATileElems};
  bf16* DOs[2] = {sm + 4 * kATileElems, sm + 5 * kATileElems};
  bf16* DNs[2] = {sm + 6 * kATileElems, sm + 7 * kATileElems};
  float* Ss = reinterpret_cast<float*>(sm + 8 * kATileElems);  // [2][192]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kAT, h = blockIdx.y, g = blockIdx.z;
  const size_t in0 = (size_t)g * N * ld + h * kHeadDim;
  const bf16* qb = q + in0;
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
  prefetch(0, 0);
  cp_async_commit();

  unsigned kf[4][4], vf[4][4];
  float dk[8][4] = {}, dv[8][4] = {};
  float s[8][4], dp[8][4];
  for (int it = 0; it < nq; ++it) {
    __syncthreads();  // the stage loaded below was read at it - 1
    if (it + 1 < nq) prefetch((it + 1) * kAT, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_afrag(kf, Ks);
      load_afrag(vf, Vs);
    }
    const int q0 = it * kAT, b = it & 1;
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
    unsigned pf[4][4], dsf[4][4];
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

// the forward (or, without kValues, its (m, l) alone) over G sequences x
// heads; with `stats`, (m, l) per row at stats[((g * heads + h) * N + row)
// * 3]
template <typename L, bool kValues = true>
static cudaError_t attention_fwd(const bf16* q, const bf16* k, const bf16* v,
                                 bf16* out, float* stats, int G, int heads,
                                 int N, int ld, int ldo, float scale,
                                 cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  attn_fwd_kernel<L, kValues>
      <<<dim3((N + kAT - 1) / kAT, heads, G), kAThreads, 0, stream>>>(
          q, k, v, out, stats, N, ld, ldo, scale);
  return cudaGetLastError();
}

// dq, dk, dv (to f* in fp32 where the layout keeps them, and g* in bf16)
// from the cotangent dout and the forward's (m, l) in stats (c is written
// into their third slot); dob (the ViT's T(do)) and dnb (T(do / l)) are
// bf16 scratch in the layout of do
template <typename L>
static cudaError_t attention_bwd(const bf16* q, const bf16* k, const bf16* v,
                                 const typename L::Dout* dout, float* stats,
                                 bf16* dob, bf16* dnb, float* fq, float* fk,
                                 float* fv, bf16* gq, bf16* gk, bf16* gv,
                                 int G, int heads, int N, int ld, int ldo,
                                 float scale, float sm_scale,
                                 cudaStream_t stream) {
  if (heads > 65535 || G > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_dq_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_dkv_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kAT - 1) / kAT, heads, G);
  attn_dq_kernel<L><<<grid, kAThreads, kDqSmemBytes, stream>>>(
      q, k, v, dout, stats, dob, dnb, fq, gq, N, ld, ldo, scale, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16* dkv_do;
  if constexpr (L::kF32Grads)
    dkv_do = dob;
  else
    dkv_do = dout;
  attn_dkv_kernel<L><<<grid, kAThreads, kDkvSmemBytes, stream>>>(
      q, k, v, dkv_do, dnb, stats, fk, fv, gk, gv, N, ld, ldo, scale,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rp

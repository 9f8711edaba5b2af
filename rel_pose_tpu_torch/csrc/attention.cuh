// Softmax attention over 64-wide heads, forward and backward, on SIMT fp32
// FMAs: the fp32 route of mhsa.cu (the --noess cross attention, kernel #7:
// separate (G, N, 64) q, k, v).  bf16 #7 and the ViT stack's attention in
// both dtypes (kernels #1 and #5) run the tensor-core kernels of
// attention_tc.cuh.  Each kernel is templated on a layout, which says where
// one (sequence, head)'s rows are read and written, in which dtype, and the
// places where the Pallas kernel rounds.
//
// Design: the N x N fp32 score matrix of one head (1.33 MB at N = 576) does
// not fit in shared memory, so each CUDA block takes 32 query rows and
// keeps their full 32 x N score rows (74 KB at N = 576): the row max and sum
// are then exact, as in the Pallas kernels, with no online rescaling.
// Scores are s = (q . k) * scale in fp32, scale = d^-1/2 * log2(e);
// P = exp2(s - max) rounded to T; o = (P . v) / sum(exp2(s - max)), rounded
// to T.  The backward is the flash-attention-2 split: one kernel per
// (sequence, head, 32-query tile) forms dq, another per (sequence, head,
// 64-key tile) walks the query tiles for dk and dv; both recompute e with
// the forward's arithmetic, so the same bits.  Every sum runs in a fixed
// order and nothing uses atomics: two calls give the same bits.
//
// What bounds them on the H100: the products (2 N^2 d FMAs a head forward,
// 5 in the backward with the recompute), all SIMT fp32 FMAs fed from shared
// memory, not the tensor cores.  Register tiles of 4 rows x 2 columns per
// thread keep it at 0.75 shared-memory loads per FMA.

#pragma once

#include "common.cuh"

namespace rp {

constexpr int kHeadDim = 64;  // the model's head width (192 / 3 heads)
constexpr int kQT = 32;       // query rows per CUDA block
constexpr int kKT = 64;       // key rows per shared-memory tile
constexpr int kKB = 64;       // keys per dk / dv block
constexpr int kAttnThreads = 256;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kQT == 4 * (kAttnThreads / 32) && kKT == 64 && kHeadDim == 64,
              "register tiles: 8 warps x 4 rows, 32 lanes x 2 columns");
static_assert(kQT * kHeadDim % kAttnThreads == 0 &&
                  kKT * kHeadDim % kAttnThreads == 0,
              "tile loads: whole unrolled steps");

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// an input value through the read-only data cache, as fp32
template <typename T>
__device__ __forceinline__ float ldg_f32(const T* p) {
  return to_f32(__ldg(p));
}

// A layout gives, for sequence g and head h, the address of column 0 of
// row 0 of q, k, v, o, the cotangent dO of o, and dq, dk, dv, and the row
// strides: ld_in() of q, k, v, dq, dk, dv, ld_out() of o and dO.  The
// kernels add row * stride + column to these per-block bases.

// Pallas kernel #7 (pallas_attention.py:_fwd_kernel / _bwd_kernel): q, k,
// v, o, the cotangent do and dq, dk, dv are separate (G, N, 64) tensors in
// T, one head per sequence g.  The backward recomputes the row statistics
// itself (its dq kernel writes them to `stats` for the dk / dv kernel).
template <typename T>
struct SeparateQkv {
  using Elem = T;
  static constexpr bool kOwnStats = true;
  const T *qp, *kp, *vp;
  T* out;
  const T* dout;
  T *dqp, *dkp, *dvp;
  int N;
  float sm_scale;  // d^-1/2, without log2(e)

  __device__ size_t ld_in() const { return kHeadDim; }
  __device__ size_t ld_out() const { return kHeadDim; }
  __device__ size_t at(int g) const { return (size_t)g * N * kHeadDim; }
  __device__ const T* q(int g, int) const { return qp + at(g); }
  __device__ const T* k(int g, int) const { return kp + at(g); }
  __device__ const T* v(int g, int) const { return vp + at(g); }
  __device__ T* o(int g, int) const { return out + at(g); }
  __device__ const T* dO(int g, int) const { return dout + at(g); }
  __device__ T* dq(int g, int) const { return dqp + at(g); }
  __device__ T* dk(int g, int) const { return dkp + at(g); }
  __device__ T* dv(int g, int) const { return dvp + at(g); }
  // o / l
  __device__ static float normalize(float o, float l) { return o / l; }
  // e ((dp - c) (d^-1/2 / l))
  __device__ float ds(float e, float dp, float c, float l, float) const {
    return e * ((dp - c) * (sm_scale / l));
  }
};

static size_t attention_smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)kQT * N + kQT * kHeadDim + kKT * (kHeadDim + 1) + kQT);
}

// o for 32 query rows of one (sequence g, head h); with `stats` given, each
// row's (max, sum) of its exp2 row at [((g * heads + h) * N + row) * 3].
template <typename L>
__global__ void __launch_bounds__(kAttnThreads)
attention_fwd_kernel(const L lay, float* __restrict__ stats, int N,
                     float scale) {
  extern __shared__ float smem[];
  float* S = smem;                             // [kQT][N]
  float* Qs = S + (size_t)kQT * N;             // [kQT][kHeadDim]
  float* KVs = Qs + kQT * kHeadDim;            // [kKT][kHeadDim + 1]
  float* lsum = KVs + kKT * (kHeadDim + 1);    // [kQT]
  constexpr int LD = kHeadDim + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, g = blockIdx.z;
  const int rows = min(kQT, N - q0);
  const auto qb = lay.q(g, h), kb = lay.k(g, h), vb = lay.v(g, h);
  const size_t ld = lay.ld_in();

  // Tile loads run a compile-time number of unrolled steps, so a tile's
  // global loads are all in flight at once (a runtime-bounded loop waits
  // out one L2 round trip per element).
#pragma unroll
  for (int u = 0; u < kQT * kHeadDim / kAttnThreads; ++u) {
    const int idx = tid + u * kAttnThreads;
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    Qs[idx] = r < rows ? ldg_f32(qb + (q0 + r) * ld + c) : 0.f;
  }
  // Register tiles: warp w owns query rows 4w .. 4w+3 (their shared-memory
  // loads are warp broadcasts), lane l the columns l and l + 32 -- 0.75
  // shared-memory loads per FMA.  Scores: columns are the tile's keys.
  const int wr = warp * 4;
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kKT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      KVs[r * LD + c] = k0 + r < N ? ldg_f32(kb + (k0 + r) * ld + c) : 0.f;
    }
    __syncthreads();
    float acc[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float k_lo = KVs[lane * LD + c], k_hi = KVs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float q = Qs[(wr + r) * kHeadDim + c];
        acc[r][0] = fmaf(q, k_lo, acc[r][0]);
        acc[r][1] = fmaf(q, k_hi, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (k0 + lane + 32 * s < N)
          S[(size_t)(wr + r) * N + k0 + lane + 32 * s] = acc[r][s] * scale;
  }
  __syncthreads();
  // exact row softmax statistics, one warp per row; P rounded to T in place
  for (int i = warp; i < kQT; i += kAttnThreads / 32) {
    float* row = S + (size_t)i * N;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = exp2f(row[j] - m);
      l += e;
      row[j] = round_to<typename L::Elem>(e);
    }
    l = warp_sum(l);
    if (lane == 0) {
      lsum[i] = l;
      if (stats && i < rows) {
        float* st = stats + (((size_t)g * gridDim.y + h) * N + q0 + i) * 3;
        st[0] = m;
        st[1] = l;
      }
    }
  }
  // o = P . v, same register tiles: columns are head columns
  float o[4][2] = {};
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kKT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      KVs[r * LD + c] = k0 + r < N ? ldg_f32(vb + (k0 + r) * ld + c) : 0.f;
    }
    __syncthreads();
    const int kn = min(kKT, N - k0);
    for (int j = 0; j < kn; ++j) {
      const float v_lo = KVs[j * LD + lane], v_hi = KVs[j * LD + lane + 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = S[(size_t)(wr + r) * N + k0 + j];
        o[r][0] = fmaf(p, v_lo, o[r][0]);
        o[r][1] = fmaf(p, v_hi, o[r][1]);
      }
    }
  }
  const auto ob = lay.o(g, h);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = wr + r;
    if (i < rows)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        put(ob + (q0 + i) * lay.ld_out() + lane + 32 * s,
            L::normalize(o[r][s], lsum[i]));
  }
}

static size_t attn_dq_smem_bytes(int N) {
  return sizeof(float) * (2 * (size_t)kQT * N + 2 * kQT * kHeadDim +
                          kKT * (kHeadDim + 1) + 3 * kQT);
}

static size_t attn_dkv_smem_bytes() {
  return sizeof(float) * (2 * kKB * (kHeadDim + 1) + 3 * kQT * kHeadDim +
                          2 * kQT * (kKB + 1) + 3 * kQT);
}

// dq for 32 query rows of one (sequence, head): e = exp2(s - m) as the
// forward forms it (the scale product rounded, never fused into the
// subtraction), dp = T(do) . v^T, c = rowsum(dp * e) / l, ds = T(layout's
// ds), dq = ds . k.  The 32 x N rows of e and dp stay in shared memory
// (147 KB at N = 576).  Row (m, l) come from stats[.., 0:2] or, for a
// layout with kOwnStats, from the exact score rows here, written there;
// c goes to stats[.., 2] for the dk / dv kernel.
template <typename L>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_dq_kernel(const L lay, float* __restrict__ stats, int N,
                        float scale) {
  using T = typename L::Elem;
  extern __shared__ float smem[];
  constexpr int LD = kHeadDim + 1;
  float* E = smem;                            // [kQT][N]: s, then e
  float* DP = E + (size_t)kQT * N;            // [kQT][N]: dp, then T(ds)
  float* Qs = DP + (size_t)kQT * N;           // [kQT][64]
  float* DOs = Qs + kQT * kHeadDim;           // [kQT][64]: T(do)
  float* KVs = DOs + kQT * kHeadDim;          // [kKT][LD]
  float* mrow = KVs + kKT * LD;               // [kQT]
  float* lrow = mrow + kQT;                   // [kQT]
  float* crow = lrow + kQT;                   // [kQT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, g = blockIdx.z;
  const int rows = min(kQT, N - q0);
  float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const auto qb = lay.q(g, h), kb = lay.k(g, h), vb = lay.v(g, h);
  const auto dob = lay.dO(g, h);
  const size_t ld = lay.ld_in(), ldo = lay.ld_out();

#pragma unroll
  for (int u = 0; u < kQT * kHeadDim / kAttnThreads; ++u) {
    const int idx = tid + u * kAttnThreads;
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    const bool ok = r < rows;
    Qs[idx] = ok ? ldg_f32(qb + (q0 + r) * ld + c) : 0.f;
    DOs[idx] = ok ? round_to<T>(ldg_f32(dob + (q0 + r) * ldo + c)) : 0.f;
  }
  if (!L::kOwnStats && tid < kQT) {
    const bool ok = tid < rows;
    mrow[tid] = ok ? st[(size_t)(q0 + tid) * 3] : 0.f;
    lrow[tid] = ok ? st[(size_t)(q0 + tid) * 3 + 1] : 1.f;
  }
  const int wr = warp * 4;
  auto load_tile = [&](int k0, bool values) {
#pragma unroll
    for (int u = 0; u < kKT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      KVs[r * LD + c] =
          k0 + r < N ? ldg_f32((values ? vb : kb) + (k0 + r) * ld + c) : 0.f;
    }
  };
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
    load_tile(k0, false);
    __syncthreads();
    float acc[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float k_lo = KVs[lane * LD + c], k_hi = KVs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float q = Qs[(wr + r) * kHeadDim + c];
        acc[r][0] = fmaf(q, k_lo, acc[r][0]);
        acc[r][1] = fmaf(q, k_hi, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (k0 + lane + 32 * s < N) {
          const float sv = __fmul_rn(acc[r][s], scale);
          E[(size_t)(wr + r) * N + k0 + lane + 32 * s] =
              L::kOwnStats ? sv : exp2f(sv - mrow[wr + r]);
        }
    __syncthreads();
    load_tile(k0, true);
    __syncthreads();
    float dp[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float v_lo = KVs[lane * LD + c], v_hi = KVs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = DOs[(wr + r) * kHeadDim + c];
        dp[r][0] = fmaf(d, v_lo, dp[r][0]);
        dp[r][1] = fmaf(d, v_hi, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (k0 + lane + 32 * s < N)
          DP[(size_t)(wr + r) * N + k0 + lane + 32 * s] = dp[r][s];
  }
  __syncthreads();
  if (L::kOwnStats) {
    // the forward's row statistics, from the same score bits in the same
    // order; e = exp2(s - m) in place
    for (int i = warp; i < kQT; i += kAttnThreads / 32) {
      float* er = E + (size_t)i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, er[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = exp2f(er[j] - m);
        l += e;
        er[j] = e;
      }
      l = warp_sum(l);
      if (lane == 0) {
        mrow[i] = m;
        lrow[i] = l;
        if (i < rows) {
          st[(size_t)(q0 + i) * 3] = m;
          st[(size_t)(q0 + i) * 3 + 1] = l;
        }
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < kQT; i += kAttnThreads / 32) {
    const float* er = E + (size_t)i * N;
    const float* dr = DP + (size_t)i * N;
    float t = 0.f;
    for (int j = lane; j < N; j += 32) t += dr[j] * er[j];
    t = warp_sum(t);
    if (lane == 0) {
      const float c = t / lrow[i];
      crow[i] = c;
      if (i < rows) st[(size_t)(q0 + i) * 3 + 2] = c;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kQT * N; idx += kAttnThreads) {
    const int i = idx / N;
    DP[idx] = round_to<T>(lay.ds(E[idx], DP[idx], crow[i], lrow[i], scale));
  }
  float dq[4][2] = {};
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
    load_tile(k0, false);
    __syncthreads();
    const int kn = min(kKT, N - k0);
    for (int j = 0; j < kn; ++j) {
      const float k_lo = KVs[j * LD + lane], k_hi = KVs[j * LD + lane + 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = DP[(size_t)(wr + r) * N + k0 + j];
        dq[r][0] = fmaf(ds, k_lo, dq[r][0]);
        dq[r][1] = fmaf(ds, k_hi, dq[r][1]);
      }
    }
  }
  const auto dqb = lay.dq(g, h);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = wr + r;
    if (i < rows)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        put(dqb + (q0 + i) * ld + lane + 32 * s, dq[r][s]);
  }
}

// dk and dv for 64 keys of one (sequence, head): walks the query tiles,
// recomputes e and dp with the same arithmetic as the dq kernel (so the
// same bits), reads (m, l, c) from stats, and accumulates in registers
// dv += T(e)^T . T(do / l) and dk += T(ds)^T . q over all N queries.
template <typename L>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_dkv_kernel(const L lay, const float* __restrict__ stats, int N,
                         float scale) {
  using T = typename L::Elem;
  extern __shared__ float smem[];
  constexpr int LD = kHeadDim + 1, PLD = kKB + 1;
  float* Ks = smem;                   // [kKB][LD]
  float* Vs = Ks + kKB * LD;          // [kKB][LD]
  float* Qs = Vs + kKB * LD;          // [kQT][64]
  float* DOr = Qs + kQT * kHeadDim;   // [kQT][64]: T(do)
  float* DOn = DOr + kQT * kHeadDim;  // [kQT][64]: T(do / l)
  float* P = DOn + kQT * kHeadDim;    // [kQT][PLD]: T(e)
  float* DS = P + kQT * PLD;          // [kQT][PLD]: T(ds)
  float* mrow = DS + kQT * PLD;       // [kQT]
  float* lrow = mrow + kQT;           // [kQT]
  float* crow = lrow + kQT;           // [kQT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kKB, h = blockIdx.y, g = blockIdx.z;
  const int kn = min(kKB, N - k0);
  const float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const auto qb = lay.q(g, h), kb = lay.k(g, h), vb = lay.v(g, h);
  const auto dob = lay.dO(g, h);
  const size_t ld = lay.ld_in(), ldo = lay.ld_out();

#pragma unroll
  for (int u = 0; u < kKB * kHeadDim / kAttnThreads; ++u) {
    const int idx = tid + u * kAttnThreads;
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    const bool ok = r < kn;
    Ks[r * LD + c] = ok ? ldg_f32(kb + (k0 + r) * ld + c) : 0.f;
    Vs[r * LD + c] = ok ? ldg_f32(vb + (k0 + r) * ld + c) : 0.f;
  }
  const int wr = warp * 4;  // score rows (queries) of this warp
  const int wk = warp * 8;  // dk / dv rows (keys) of this warp
  float dk[8][2] = {}, dv[8][2] = {};
  for (int q0 = 0; q0 < N; q0 += kQT) {
    const int rows = min(kQT, N - q0);
    __syncthreads();
    if (tid < kQT) {
      const bool ok = tid < rows;
      const float* sr = st + (size_t)(q0 + tid) * 3;
      mrow[tid] = ok ? sr[0] : 0.f;
      lrow[tid] = ok ? sr[1] : 1.f;
      crow[tid] = ok ? sr[2] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kQT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      const bool ok = r < rows;
      Qs[idx] = ok ? ldg_f32(qb + (q0 + r) * ld + c) : 0.f;
      const float d = ok ? ldg_f32(dob + (q0 + r) * ldo + c) : 0.f;
      DOr[idx] = round_to<T>(d);
      DOn[idx] = round_to<T>(d / lrow[r]);
    }
    __syncthreads();
    float sc[4][2] = {}, dp[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float k_lo = Ks[lane * LD + c], k_hi = Ks[(lane + 32) * LD + c];
      const float v_lo = Vs[lane * LD + c], v_hi = Vs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float q = Qs[(wr + r) * kHeadDim + c];
        const float d = DOr[(wr + r) * kHeadDim + c];
        sc[r][0] = fmaf(q, k_lo, sc[r][0]);
        sc[r][1] = fmaf(q, k_hi, sc[r][1]);
        dp[r][0] = fmaf(d, v_lo, dp[r][0]);
        dp[r][1] = fmaf(d, v_hi, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = lane + 32 * s;
        const bool ok = i < rows && j < kn;
        const float e = exp2f(__fmul_rn(sc[r][s], scale) - mrow[i]);
        P[i * PLD + j] = ok ? round_to<T>(e) : 0.f;
        DS[i * PLD + j] =
            ok ? round_to<T>(lay.ds(e, dp[r][s], crow[i], lrow[i], scale))
               : 0.f;
      }
    }
    __syncthreads();
    for (int i = 0; i < kQT; ++i) {
      const float don0 = DOn[i * kHeadDim + lane];
      const float don1 = DOn[i * kHeadDim + lane + 32];
      const float qv0 = Qs[i * kHeadDim + lane];
      const float qv1 = Qs[i * kHeadDim + lane + 32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = P[i * PLD + wk + jj], ds = DS[i * PLD + wk + jj];
        dv[jj][0] = fmaf(p, don0, dv[jj][0]);
        dv[jj][1] = fmaf(p, don1, dv[jj][1]);
        dk[jj][0] = fmaf(ds, qv0, dk[jj][0]);
        dk[jj][1] = fmaf(ds, qv1, dk[jj][1]);
      }
    }
  }
  const auto dkb = lay.dk(g, h), dvb = lay.dv(g, h);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (wk + jj >= kn) continue;
    const size_t row = (k0 + wk + jj) * ld + lane;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      put(dkb + row + 32 * s, dk[jj][s]);
      put(dvb + row + 32 * s, dv[jj][s]);
    }
  }
}

// The forward over G sequences x `heads` heads; `scale` = d^-1/2 log2(e).
template <typename L>
static cudaError_t launch_attention(const L& lay, float* stats, int G,
                                    int heads, int N, float scale,
                                    cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory: two 99 KB blocks per SM
  err = cudaFuncSetAttribute(attention_fwd_kernel<L>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  attention_fwd_kernel<L>
      <<<dim3((N + kQT - 1) / kQT, heads, G), kAttnThreads, smem, stream>>>(
          lay, stats, N, scale);
  return cudaGetLastError();
}

// dq, dk, dv of every head; `stats` holds 3 fp32 per (sequence, head, row):
// the forward's (m, l) unless the layout recomputes them, and c.
template <typename L>
static cudaError_t launch_attention_bwd(const L& lay, float* stats, int G,
                                        int heads, int N, float scale,
                                        cudaStream_t stream) {
  const size_t smem_q = attn_dq_smem_bytes(N), smem_kv = attn_dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<L>
      <<<dim3((N + kQT - 1) / kQT, heads, G), kAttnThreads, smem_q, stream>>>(
          lay, stats, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<L>
      <<<dim3((N + kKB - 1) / kKB, heads, G), kAttnThreads, smem_kv, stream>>>(
          lay, stats, N, scale);
  return cudaGetLastError();
}

}  // namespace rp

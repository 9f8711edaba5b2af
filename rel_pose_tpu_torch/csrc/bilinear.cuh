// The fp32 bilinear moments F = va^T A vb of one (N, d) x (N, e) slice, as
// a device function that a kernel calls once per slice it owns: the fp32
// path of Pallas kernels #8 and #9, whose bf16 path runs the tensor-core
// body of essential_tc.cuh.
//
// It is a two-phase SIMT body with _eb_combos' arithmetic (the column
// statistics merged online over 32-row tiles of s, then P, av and F),
// behind a row source (`Rows`) that says where q, k, va and vb of the
// slice live.  Its callers:
//   * bilinear.cu, Pallas kernel #8 (pallas_essential.py:_fwd_kernel): one
//     block per slice of separate (G, N, 64) q, k and (G, N, e) va, vb
//     tensors (SliceRows), any runtime scale;
//   * cross_variants.cu, Pallas kernel #9 (scripts/bench_cross.py
//     _s_kernel): #4's pair layout, S pairs per block.
//
// Per slice, with T the inputs' dtype (fp32: no rounding) and s2 = q k^T *
// scale * log2(e) (`scale` arrives pre-multiplied by log2 e):
//   dual    P = T(exp2(s2 - mr) exp2(s2 - mc)), vb_n = T(vb / lc)
//   SINGLE  P = T(exp2(s2 - mr)), vb_n = vb
//   then av = T((P . vb_n) / lr) and F = va^T . av accumulated in fp32.
// One block of kBlThreads threads; bilinear_smem_bytes of dynamic shared
// memory (123 KB at N = 576 and e = 70: one block per SM).

#pragma once

#include "common.cuh"

namespace rp {

constexpr int kBlD = 64;         // head width d
constexpr int kBlPos = 6;
constexpr int kBlRT = 32;        // query rows per tile
constexpr int kBlKT = 64;        // key rows per staged tile
constexpr int kBlThreads = 256;
static_assert(kBlRT == 4 * (kBlThreads / 32) && kBlKT == 64,
              "register tiles: 8 warps x 4 rows, 32 lanes x 2-3 columns");

static inline size_t bilinear_smem_bytes(int N, int E) {
  return sizeof(float) * ((size_t)kBlRT * N      // S
                          + kBlRT * kBlD         // Qs
                          + kBlKT * (E + 1)      // KV
                          + 2 * (size_t)N        // mc, lc
                          + 2 * kBlRT            // mr, linv
                          + 2 * kBlRT * E);      // AV, VA
}

// slice g of separate (G, N, 64) q, k and (G, N, e) va, vb tensors
template <typename T, int E>
struct SliceRows {
  const T* q;
  const T* k;
  const T* va;
  const T* vb;
  __device__ float qv(int n, int c) const { return to_f32(q[n * kBlD + c]); }
  __device__ float kv(int n, int c) const { return to_f32(k[n * kBlD + c]); }
  __device__ float vav(int n, int e) const { return to_f32(va[n * E + e]); }
  __device__ float vbv(int n, int e) const { return to_f32(vb[n * E + e]); }
};

template <typename T, int E, bool SINGLE, typename Rows>
__device__ __forceinline__ void bilinear_moments(const Rows& L, int N,
                                                 float scale, float* smem,
                                                 float* Fout) {
  static_assert(E == kBlD || E == kBlD + kBlPos, "e = d or d + 6");
  constexpr int kKvLd = E + 1;
  constexpr int kGroups = (E + 31) / 32;                      // 2 or 3
  constexpr int kFPerThread = (E * E + kBlThreads - 1) / kBlThreads;
  float* S = smem;                          // [kBlRT][N]
  float* Qs = S + (size_t)kBlRT * N;        // [kBlRT][64]
  float* KV = Qs + kBlRT * kBlD;            // [kBlKT][kKvLd]
  float* mc = KV + kBlKT * kKvLd;           // [N]
  float* lc = mc + N;                       // [N]
  float* mr = lc + N;                       // [kBlRT]
  float* linv = mr + kBlRT;                 // [kBlRT]
  float* AV = linv + kBlRT;                 // [kBlRT][E]
  float* VA = AV + kBlRT * E;               // [kBlRT][E]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * 4;

  // s tile for query rows r0 .. r0 + rows into S (rows past N score 0)
  auto score_tile = [&](int r0, int rows) {
#pragma unroll
    for (int u = 0; u < kBlRT * kBlD / kBlThreads; ++u) {
      const int idx = tid + u * kBlThreads;
      const int r = idx / kBlD, c = idx % kBlD;
      Qs[idx] = r < rows ? L.qv(r0 + r, c) : 0.f;
    }
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kBlKT * kBlD / kBlThreads; ++u) {
        const int idx = tid + u * kBlThreads;
        const int r = idx / kBlD, c = idx % kBlD;
        KV[r * kKvLd + c] = k0 + r < N ? L.kv(k0 + r, c) : 0.f;
      }
      __syncthreads();
      float acc[4][2] = {};
#pragma unroll 8
      for (int c = 0; c < kBlD; ++c) {
        const float k_lo = KV[lane * kKvLd + c];
        const float k_hi = KV[(lane + 32) * kKvLd + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float q = Qs[(wr + r) * kBlD + c];
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
  };

  // ---- phase 1: column statistics, online max and sum (none with the
  // single softmax)
  if (!SINGLE) {
    for (int j = tid; j < N; j += kBlThreads) {
      mc[j] = -INFINITY;
      lc[j] = 0.f;
    }
    for (int r0 = 0; r0 < N; r0 += kBlRT) {
      const int rows = min(kBlRT, N - r0);
      score_tile(r0, rows);
      for (int j = tid; j < N; j += kBlThreads) {
        float m = -INFINITY;
        for (int i = 0; i < rows; ++i) m = fmaxf(m, S[(size_t)i * N + j]);
        float l = 0.f;
        for (int i = 0; i < rows; ++i) l += exp2f(S[(size_t)i * N + j] - m);
        const float mo = mc[j];
        if (m > mo) {
          lc[j] = lc[j] * exp2f(mo - m) + l;
          mc[j] = m;
        } else {
          lc[j] += l * exp2f(m - mo);
        }
      }
    }
  }

  // ---- phase 2: P, av and the F accumulation
  float f[kFPerThread] = {};
  for (int r0 = 0; r0 < N; r0 += kBlRT) {
    const int rows = min(kBlRT, N - r0);
    score_tile(r0, rows);  // ends with a barrier: mc / lc visible too
    for (int i = warp; i < kBlRT; i += kBlThreads / 32) {
      const float* row = S + (size_t)i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < N; j += 32) l += exp2f(row[j] - m);
      l = warp_sum(l);
      if (lane == 0) {
        mr[i] = m;
        linv[i] = 1.f / l;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kBlRT * N; idx += kBlThreads) {
      const int i = idx / N, j = idx % N;
      const float s = S[idx];
      S[idx] = SINGLE ? round_to<T>(exp2f(s - mr[i]))
                      : round_to<T>(exp2f(s - mr[i]) * exp2f(s - mc[j]));
    }
    // av = P . vb_n over key tiles, register tiles over (row, e); with
    // e = 70 the third column group covers e = 64 .. 69
    float av[4][kGroups] = {};
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < (kBlKT * E + kBlThreads - 1) / kBlThreads; ++u) {
        const int idx = tid + u * kBlThreads;
        const int r = idx / E, e = idx % E;
        const int n = k0 + r;
        if (idx < kBlKT * E)
          KV[r * kKvLd + e] = n >= N   ? 0.f
                              : SINGLE ? L.vbv(n, e)
                                       : round_to<T>(L.vbv(n, e) *
                                                     (1.f / lc[n]));
      }
      __syncthreads();
      const int kn = min(kBlKT, N - k0);
      for (int j = 0; j < kn; ++j) {
        const float* kv = KV + j * kKvLd;
        float v[kGroups];
#pragma unroll
        for (int t = 0; t < kGroups; ++t)
          v[t] = t < 2 || lane + 32 * t < E ? kv[lane + 32 * t] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = S[(size_t)(wr + r) * N + k0 + j];
#pragma unroll
          for (int t = 0; t < kGroups; ++t) av[r][t] = fmaf(p, v[t], av[r][t]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
#pragma unroll
      for (int s = 0; s < kGroups; ++s) {
        const int e = lane + 32 * s;
        if (e < E) {
          AV[i * E + e] = i < rows ? round_to<T>(av[r][s] * linv[i]) : 0.f;
          VA[i * E + e] = i < rows ? L.vav(r0 + i, e) : 0.f;
        }
      }
    }
    __syncthreads();
    // F[e1][e2] += sum_i VA[i][e1] * AV[i][e2]; each thread owns its entries
#pragma unroll
    for (int u = 0; u < kFPerThread; ++u) {
      const int o = tid + u * kBlThreads;
      if (o >= E * E) break;
      const int e1 = o / E, e2 = o % E;
      float acc = f[u];
      for (int i = 0; i < kBlRT; ++i)
        acc = fmaf(VA[i * E + e1], AV[i * E + e2], acc);
      f[u] = acc;
    }
  }
#pragma unroll
  for (int u = 0; u < kFPerThread; ++u) {
    const int o = tid + u * kBlThreads;
    if (o < E * E) Fout[o] = f[u];
  }
}

}  // namespace rp

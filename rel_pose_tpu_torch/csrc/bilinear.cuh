// The bilinear moments F = va^T A vb of one (N, d) x (N, e) slice, as a
// device function that a kernel calls once per slice it owns.
//
// It is the two-phase body of the moments kernel of essential_block.cuh
// (#2-#4), with the same arithmetic in the same order, behind a row source
// (`Rows`) that says where q, k, va and vb of the slice live and a softmax
// mode.  Its callers:
//   * bilinear.cu, Pallas kernel #8 (pallas_essential.py:_fwd_kernel): one
//     block per slice of separate (G, N, 64) q, k and (G, N, e) va, vb
//     tensors (SliceRows), any runtime scale;
//   * cross_variants.cu, Pallas kernel #9 (scripts/bench_cross.py
//     _s_kernel / _variant_kernel): #4's pair layout, S pairs per block or
//     the ablated modes below.
// essential_block.cuh keeps its own copy: the flagship's #2 / #4 stay the
// code they were when they were timed.
//
// Per slice, with T the inputs' dtype and s2 = q k^T * scale * log2(e) in
// fp32 (`scale` arrives pre-multiplied by log2 e):
//   kBlDual    P = T(exp2(s2 - mr) exp2(s2 - mc)), vb_n = T(vb / lc)
//   kBlSingle  P = T(exp2(s2 - mr)), vb_n = vb
//   kBlBf16Mul P = bf16(bf16(er) bf16(ec)) with __hmul, er / ec / lr / lc as
//              kBlDual (bf16 only)
//   kBlMxuSums P as kBlBf16Mul; lr = sum_j bf16(er), lc = sum_i bf16(ec) in
//              fp32, formed on the tensor cores: mma.sync m16n8k16 against a
//              ones operand (B = ones for the row sums, A = ones for the
//              column sums).  The bf16 rounding of ec is taken against the
//              final column max, so this mode spends a third score pass
//              (column max, column sums, then phase 2).
//   then av = T((P . vb_n) / lr) and F = va^T . av accumulated in fp32.
// One block of kBlThreads threads; dual_softmax_smem_bytes + 4 kBlRT floats
// of dynamic shared memory (123 KB at N = 576 and e = 70: one block per SM).

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

enum BlMode { kBlDual, kBlSingle, kBlBf16Mul, kBlMxuSums };

static inline size_t bilinear_smem_bytes(int N, int E) {
  return sizeof(float) * ((size_t)kBlRT * N      // S
                          + kBlRT * kBlD         // Qs
                          + kBlKT * (E + 1)      // KV
                          + 2 * (size_t)N        // mc, lc
                          + 2 * kBlRT            // mr, linv
                          + 2 * kBlRT * E        // AV, VA
                          + 4 * kBlRT);          // row-sum partials
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

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

constexpr unsigned kBf16OnesX2 = 0x3F803F80u;  // two bf16 1.0

// c += a . b: one 16 x 8 x 16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf16_product(float x, float y) {
  return __bfloat162float(
      __hmul(__float2bfloat16(x), __float2bfloat16(y)));
}

template <typename T, int E, int MODE, typename Rows>
__device__ __forceinline__ void bilinear_moments(const Rows& L, int N,
                                                 float scale, float* smem,
                                                 float* Fout) {
  static_assert(E == kBlD || E == kBlD + kBlPos, "e = d or d + 6");
  constexpr bool SINGLE = MODE == kBlSingle;
  constexpr bool MXU = MODE == kBlMxuSums;
  constexpr bool HMUL = MODE == kBlBf16Mul || MODE == kBlMxuSums;
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
  float* rsum = VA + kBlRT * E;             // [4][kBlRT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
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

  // ---- phase 1: column statistics (none with the single softmax)
  if (!SINGLE) {
    for (int j = tid; j < N; j += kBlThreads) {
      mc[j] = -INFINITY;
      lc[j] = 0.f;
    }
  }
  if (MODE == kBlDual || MODE == kBlBf16Mul) {  // online max and sum
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
  if (MXU) {
    // the exact column max, then lc = sum_i bf16(exp2(s - mc)) as
    // ones(16 x 16) . E(16 rows x 8 columns) products, 8-column strips
    for (int r0 = 0; r0 < N; r0 += kBlRT) {
      const int rows = min(kBlRT, N - r0);
      score_tile(r0, rows);
      for (int j = tid; j < N; j += kBlThreads) {
        float m = mc[j];
        for (int i = 0; i < rows; ++i) m = fmaxf(m, S[(size_t)i * N + j]);
        mc[j] = m;
      }
    }
    const unsigned ones[4] = {kBf16OnesX2, kBf16OnesX2, kBf16OnesX2,
                              kBf16OnesX2};
    for (int r0 = 0; r0 < N; r0 += kBlRT) {
      const int rows = min(kBlRT, N - r0);
      score_tile(r0, rows);  // ends with a barrier: mc visible too
      auto ec = [&](int i, int j) {
        return i < rows && j < N ? exp2f(S[(size_t)i * N + j] - mc[j]) : 0.f;
      };
      for (int n0 = 8 * warp; n0 < N; n0 += 8 * (kBlThreads / 32)) {
        const int j = n0 + grp;
        float c[4] = {};
#pragma unroll
        for (int k0 = 0; k0 < kBlRT; k0 += 16) {
          const int i = k0 + 2 * tig;
          const unsigned b[2] = {pack_bf16x2(ec(i, j), ec(i + 1, j)),
                                 pack_bf16x2(ec(i + 8, j), ec(i + 9, j))};
          mma_16816(c, ones, b);
        }
        // row 0 of the product holds the strip's column sums
        if (grp == 0) {
          if (n0 + 2 * tig < N) lc[n0 + 2 * tig] += c[0];
          if (n0 + 2 * tig + 1 < N) lc[n0 + 2 * tig + 1] += c[1];
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
      if (MXU) {
        if (lane == 0) mr[i] = m;
        continue;
      }
      float l = 0.f;
      for (int j = lane; j < N; j += 32) l += exp2f(row[j] - m);
      l = warp_sum(l);
      if (lane == 0) {
        mr[i] = m;
        linv[i] = 1.f / l;
      }
    }
    __syncthreads();
    if (MXU) {
      // lr = sum_j bf16(exp2(s - mr)) as E(16 rows x 16 columns) . ones(16
      // x 8): warp w takes rows 16 (w & 1) .. + 15 and every fourth
      // 16-column chunk, the four partials are summed in a fixed order
      const int m0 = 16 * (warp & 1);
      auto er = [&](int i, int j) {
        return i < rows && j < N ? exp2f(S[(size_t)i * N + j] - mr[i]) : 0.f;
      };
      const unsigned ones[2] = {kBf16OnesX2, kBf16OnesX2};
      float c[4] = {};
      for (int k0 = 16 * (warp >> 1); k0 < N; k0 += 64) {
        const int i = m0 + grp, j = k0 + 2 * tig;
        const unsigned a[4] = {pack_bf16x2(er(i, j), er(i, j + 1)),
                               pack_bf16x2(er(i + 8, j), er(i + 8, j + 1)),
                               pack_bf16x2(er(i, j + 8), er(i, j + 9)),
                               pack_bf16x2(er(i + 8, j + 8), er(i + 8, j + 9))};
        mma_16816(c, a, ones);
      }
      if (tig == 0) {
        rsum[(warp >> 1) * kBlRT + m0 + grp] = c[0];
        rsum[(warp >> 1) * kBlRT + m0 + grp + 8] = c[2];
      }
      __syncthreads();
      if (tid < kBlRT)
        linv[tid] = 1.f / (rsum[tid] + rsum[kBlRT + tid] +
                           rsum[2 * kBlRT + tid] + rsum[3 * kBlRT + tid]);
    }
    for (int idx = tid; idx < kBlRT * N; idx += kBlThreads) {
      const int i = idx / N, j = idx % N;
      const float s = S[idx];
      S[idx] = SINGLE ? round_to<T>(exp2f(s - mr[i]))
               : HMUL ? bf16_product(exp2f(s - mr[i]), exp2f(s - mc[j]))
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

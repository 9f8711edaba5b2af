// Hand kernels for the Essential Matrix Module's pair block.
//
// Replaces: rel_pose_tpu/ops/pallas_essential_block.py:
// _essential_block_pair_kernel (with its core _eb_combos).  Per pair of
// images: norm1 LayerNorm of both images' raw tokens, the shared qkv Linear
// with _linear_rounded rounding, then for 2 directions x heads
//   s = q k^T / sqrt(d),  A = softmax_row(s) * softmax_col(s)   (fp32)
//   F = va^T A vb,  va = vb = v ++ 6 positional columns (e = 70)
// Direction 0 takes q from image 2 and k, v from image 1; direction 1 the
// reverse.
//
// Kernels: row LayerNorm and the qkv GEMM from common.cuh over the
// (2B * N, C) tokens, then dual_softmax_kernel, one CUDA block per (pair,
// direction, head) -- 1,536 blocks at batch 256 for the 132 SMs.
//
// What bounds it on the H100: the two N x N x 64 score products (each s
// tile is formed twice) and the N x N x 70 P . vb product, all SIMT fp32
// FMAs in this version, with one resident block per SM (123 KB of shared
// memory at N = 576) to hide their latency; device-memory traffic is one
// read of qkv and a 70 x 70 fp32 write per block.
//
// The column softmax needs statistics over all N rows before any P entry
// exists, and the 1.33 MB fp32 score matrix does not fit in shared memory,
// so the block runs two passes over 32-row tiles of s:
//   phase 1: form each s tile and merge its column max / sum into running
//            (online) column statistics for all N columns in shared memory;
//   phase 2: form each s tile again with its exact row max / sum, build
//            P = T(exp2(s - mr) * exp2(s - mc)), av = T((P . vb_n) / lr)
//            with vb_n = T(vb / lc), and add va_tile^T . av_tile to a
//            70 x 70 fp32 accumulator held in registers.
// F is written once per block: deterministic, no atomics.

#include "common.cuh"

namespace rp {

constexpr int kEbHeadDim = 64;
constexpr int kPosCols = 6;
constexpr int kE = kEbHeadDim + kPosCols;  // 70
constexpr int kRT = 32;                    // query rows per tile
constexpr int kEbKT = 64;                  // key rows per staged tile
constexpr int kEbThreads = 256;
constexpr int kFPerThread = (kE * kE + kEbThreads - 1) / kEbThreads;  // 20
constexpr int kKvLd = kE + 1;
static_assert(kRT == 4 * (kEbThreads / 32) && kEbKT == 64 &&
                  kEbHeadDim == 64 && kE <= 96,
              "register tiles: 8 warps x 4 rows, 32 lanes x 2-3 columns");
static_assert(kRT * kEbHeadDim % kEbThreads == 0 &&
                  kEbKT * kEbHeadDim % kEbThreads == 0,
              "tile loads: whole unrolled steps");

static size_t dual_softmax_smem_bytes(int N) {
  return sizeof(float) * ((size_t)kRT * N      // S
                          + kRT * kEbHeadDim   // Qs
                          + kEbKT * kKvLd      // KV
                          + 2 * (size_t)N      // mc, lc
                          + 2 * kRT            // mr, linv
                          + 2 * kRT * kE);     // AV, VA
}

template <typename T>
__global__ void __launch_bounds__(kEbThreads)
dual_softmax_kernel(const T* __restrict__ qkv, const T* __restrict__ pos,
                    float* __restrict__ F, int N, int C, int heads,
                    float scale) {
  extern __shared__ float smem[];
  float* S = smem;                          // [kRT][N]
  float* Qs = S + (size_t)kRT * N;          // [kRT][64]
  float* KV = Qs + kRT * kEbHeadDim;        // [kEbKT][kKvLd]
  float* mc = KV + kEbKT * kKvLd;           // [N]
  float* lc = mc + N;                       // [N]
  float* mr = lc + N;                       // [kRT]
  float* linv = mr + kRT;                   // [kRT]
  float* AV = linv + kRT;                   // [kRT][kE]
  float* VA = AV + kRT * kE;                // [kRT][kE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, dir = blockIdx.y, b = blockIdx.z;
  const size_t C3 = 3 * (size_t)C;
  // direction 0: q from image 2 (index 1), k and v from image 1 (index 0)
  const T* qimg = qkv + ((size_t)b * 2 + (dir == 0 ? 1 : 0)) * N * C3;
  const T* kimg = qkv + ((size_t)b * 2 + (dir == 0 ? 0 : 1)) * N * C3;
  const T* posb = pos + (size_t)b * N * kPosCols;
  const int qoff = h * kEbHeadDim, koff = C + h * kEbHeadDim,
            voff = 2 * C + h * kEbHeadDim;

  // v_self row n, column e (positional columns appended, already in T)
  auto vself = [&](int n, int e) {
    return e < kEbHeadDim ? to_f32(kimg[n * C3 + voff + e])
                          : to_f32(posb[n * kPosCols + e - kEbHeadDim]);
  };

  // Register tiles: warp w owns tile rows 4w .. 4w+3 (their shared-memory
  // loads are warp broadcasts), lane l the columns l, l + 32 (, l + 64).
  const int wr = warp * 4;

  // s tile for query rows r0 .. r0 + rows into S (rows past N score 0)
  auto score_tile = [&](int r0, int rows) {
    // tile loads: compile-time unrolled steps, so a tile's global loads are
    // all in flight at once (a runtime-bounded loop waits out one L2 round
    // trip per element)
#pragma unroll
    for (int u = 0; u < kRT * kEbHeadDim / kEbThreads; ++u) {
      const int idx = tid + u * kEbThreads;
      const int r = idx / kEbHeadDim, c = idx % kEbHeadDim;
      Qs[idx] = r < rows ? to_f32(qimg[(r0 + r) * C3 + qoff + c]) : 0.f;
    }
    for (int k0 = 0; k0 < N; k0 += kEbKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kEbKT * kEbHeadDim / kEbThreads; ++u) {
        const int idx = tid + u * kEbThreads;
        const int r = idx / kEbHeadDim, c = idx % kEbHeadDim;
        KV[r * kKvLd + c] =
            k0 + r < N ? to_f32(kimg[(k0 + r) * C3 + koff + c]) : 0.f;
      }
      __syncthreads();
      float acc[4][2] = {};
#pragma unroll 8
      for (int c = 0; c < kEbHeadDim; ++c) {
        const float k_lo = KV[lane * kKvLd + c];
        const float k_hi = KV[(lane + 32) * kKvLd + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float q = Qs[(wr + r) * kEbHeadDim + c];
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

  // ---- phase 1: online column statistics over all row tiles
  for (int j = tid; j < N; j += kEbThreads) {
    mc[j] = -INFINITY;
    lc[j] = 0.f;
  }
  for (int r0 = 0; r0 < N; r0 += kRT) {
    const int rows = min(kRT, N - r0);
    score_tile(r0, rows);
    for (int j = tid; j < N; j += kEbThreads) {
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

  // ---- phase 2: P, av and the F accumulation
  float f[kFPerThread] = {};
  for (int r0 = 0; r0 < N; r0 += kRT) {
    const int rows = min(kRT, N - r0);
    score_tile(r0, rows);  // ends with a barrier: mc / lc visible too
    for (int i = warp; i < kRT; i += kEbThreads / 32) {
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
    for (int idx = tid; idx < kRT * N; idx += kEbThreads) {
      const int i = idx / N, j = idx % N;
      const float s = S[idx];
      S[idx] = round_to<T>(exp2f(s - mr[i]) * exp2f(s - mc[j]));
    }
    // av = P . vb_n over key tiles, register tiles over (row, e) with the
    // third column group covering e = 64 .. 69
    float av[4][3] = {};
    for (int k0 = 0; k0 < N; k0 += kEbKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < (kEbKT * kE + kEbThreads - 1) / kEbThreads; ++u) {
        const int idx = tid + u * kEbThreads;
        const int r = idx / kE, e = idx % kE;
        const int n = k0 + r;
        if (idx < kEbKT * kE)
          KV[r * kKvLd + e] =
              n < N ? round_to<T>(vself(n, e) * (1.f / lc[n])) : 0.f;
      }
      __syncthreads();
      const int kn = min(kEbKT, N - k0);
      for (int j = 0; j < kn; ++j) {
        const float* kv = KV + j * kKvLd;
        const float v0 = kv[lane], v1 = kv[lane + 32];
        const float v2 = lane + 64 < kE ? kv[lane + 64] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = S[(size_t)(wr + r) * N + k0 + j];
          av[r][0] = fmaf(p, v0, av[r][0]);
          av[r][1] = fmaf(p, v1, av[r][1]);
          av[r][2] = fmaf(p, v2, av[r][2]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int e = lane + 32 * s;
        if (e < kE) {
          AV[i * kE + e] = i < rows ? round_to<T>(av[r][s] * linv[i]) : 0.f;
          VA[i * kE + e] = i < rows ? vself(r0 + i, e) : 0.f;
        }
      }
    }
    __syncthreads();
    // F[e1][e2] += sum_i VA[i][e1] * AV[i][e2]; each thread owns its entries
#pragma unroll
    for (int u = 0; u < kFPerThread; ++u) {
      const int o = tid + u * kEbThreads;
      if (o >= kE * kE) break;
      const int e1 = o / kE, e2 = o % kE;
      float acc = f[u];
      for (int i = 0; i < kRT; ++i)
        acc = fmaf(VA[i * kE + e1], AV[i * kE + e2], acc);
      f[u] = acc;
    }
  }
  float* Fb = F + (((size_t)b * 2 + dir) * heads + h) * kE * kE;
#pragma unroll
  for (int u = 0; u < kFPerThread; ++u) {
    const int o = tid + u * kEbThreads;
    if (o < kE * kE) Fb[o] = f[u];
  }
}

template <typename T>
static cudaError_t essential_block_pair(const T* xpair, const float* lns,
                                        const float* lnb, const T* w,
                                        const float* bias, const T* pos,
                                        float* F, T* y, T* qkv, int B, int N,
                                        int C, int heads, cudaStream_t st) {
  if (C != heads * kEbHeadDim) return cudaErrorInvalidValue;
  const int M = 2 * B * N;
  cudaError_t err = launch_layernorm<T>(xpair, nullptr, nullptr, nullptr,
                                        lns, lnb, y, nullptr, M, N, C, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, kRounded>(y, w, bias, nullptr, qkv, M, 3 * C, C, st);
  if (err != cudaSuccess) return err;
  const size_t smem = dual_softmax_smem_bytes(N);
  err = cudaFuncSetAttribute(dual_softmax_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  dim3 grid(heads, 2, B);
  dual_softmax_kernel<T><<<grid, kEbThreads, smem, st>>>(qkv, pos, F, N, C,
                                                         heads, scale);
  return cudaGetLastError();
}

}  // namespace rp

extern "C" int rp_essential_block_pair(const void* xpair, const float* lns,
                                       const float* lnb, const void* w,
                                       const float* bias, const void* pos,
                                       float* F, void* y, void* qkv, int B,
                                       int N, int C, int heads, int bf16,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::essential_block_pair<T>((const T*)xpair, lns, lnb,
                                       (const T*)w, bias, (const T*)pos, F,
                                       (T*)y, (T*)qkv, B, N, C, heads, st);
  }
  return rp::essential_block_pair<float>(
      (const float*)xpair, lns, lnb, (const float*)w, bias,
      (const float*)pos, F, (float*)y, (float*)qkv, B, N, C, heads, st);
}

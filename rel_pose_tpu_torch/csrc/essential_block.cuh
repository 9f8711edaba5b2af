// The dual / single softmax moments kernel of the Essential Matrix Module,
// fp32 (bf16 runs the tensor-core kernels of essential_tc.cuh).
//
// Replaces the core _eb_combos of rel_pose_tpu/ops/pallas_essential_block.py
// shared by the Pallas kernels #2 _essential_block_pair_kernel, #3
// _essential_block_x_kernel and #4 _essential_block_kernel: per pair of
// images, for 2 directions x heads
//   s = q k^T / sqrt(d)   (fp32)
//   A = softmax_row(s) * softmax_col(s)    (dual, the flagship)
//     | softmax_row(s)                     (SINGLE: use_single_softmax)
//   F = va^T A vb,  vb = v_self ++ 6 positional columns (e = 70), or v_self
//   alone (e = 64: no positional encoding);  va = vb, or with CROSS
//   (cross_features) the v of the query image ++ the same positional columns
// Direction 0 takes q from image 2 and k, v_self from image 1; direction 1
// the reverse.  The three Pallas kernels differ only in where qkv comes
// from; here the caller hands the kernel both images' (N, 3C) qkv through
// two base pointers and a batch stride (csrc/essential_block.cu).
//
// One CUDA block per (pair, direction, head) -- 1,536 blocks at batch 256
// for the 132 SMs.
//
// What bounds it on the H100: the N x N x 64 score products (each s tile
// is formed twice with the dual softmax, once with the single) and the
// N x N x e P . vb product, all SIMT fp32 FMAs in this version, with one
// resident block per SM (123 KB of shared memory at N = 576) to hide their
// latency; device-memory traffic is one read of qkv and an e x e fp32 write
// per block.
//
// The column softmax needs statistics over all N rows before any P entry
// exists, and the 1.33 MB fp32 score matrix does not fit in shared memory,
// so the dual block runs two passes over 32-row tiles of s:
//   phase 1: form each s tile and merge its column max / sum into running
//            (online) column statistics for all N columns in shared memory;
//   phase 2: form each s tile again with its exact row max / sum, build
//            P = T(exp2(s - mr) * exp2(s - mc)), av = T((P . vb_n) / lr)
//            with vb_n = T(vb / lc), and add va_tile^T . av_tile to an
//            e x e fp32 accumulator held in registers.
// The single softmax has no column statistics: phase 1 is skipped, P =
// T(exp2(s - mr)) and vb_n = vb (_eb_combos :177-182).  The flags and e are
// template parameters, so each variant compiles to its own code and the
// flagship's is the code it was before the variants.  F is written once per
// block: deterministic, no atomics.

#pragma once

#include "common.cuh"

namespace rp {

constexpr int kEbHeadDim = 64;
constexpr int kPosCols = 6;
constexpr int kRT = 32;                    // query rows per tile
constexpr int kEbKT = 64;                  // key rows per staged tile
constexpr int kEbThreads = 256;
static_assert(kRT == 4 * (kEbThreads / 32) && kEbKT == 64,
              "register tiles: 8 warps x 4 rows, 32 lanes x 2-3 columns");
static_assert(kRT * kEbHeadDim % kEbThreads == 0 &&
                  kEbKT * kEbHeadDim % kEbThreads == 0,
              "tile loads: whole unrolled steps");

// Where a pair's two images' qkv rows start: image i of pair b at
// img[i] + b * bstride, rows of 3C values.
template <typename T>
struct EbArgs {
  const T* img1;
  const T* img2;
  size_t bstride;
  const T* pos;  // (B, N, 6) in T, or NULL with e = 64
  float* F;      // (B, 2, heads, e, e)
  int B, N, C, heads;
};

static inline size_t dual_softmax_smem_bytes(int N, int E) {
  return sizeof(float) * ((size_t)kRT * N      // S
                          + kRT * kEbHeadDim   // Qs
                          + kEbKT * (E + 1)    // KV
                          + 2 * (size_t)N      // mc, lc
                          + 2 * kRT            // mr, linv
                          + 2 * kRT * E);      // AV, VA
}

template <typename T, int E, bool SINGLE, bool CROSS>
__global__ void __launch_bounds__(kEbThreads)
dual_softmax_kernel(EbArgs<T> a, float scale) {
  static_assert(E == kEbHeadDim || E == kEbHeadDim + kPosCols,
                "e = d or d + 6");
  constexpr int kKvLd = E + 1;
  constexpr int kGroups = (E + 31) / 32;                      // 2 or 3
  constexpr int kFPerThread = (E * E + kEbThreads - 1) / kEbThreads;
  extern __shared__ float smem[];
  const int N = a.N, C = a.C;
  float* S = smem;                          // [kRT][N]
  float* Qs = S + (size_t)kRT * N;          // [kRT][64]
  float* KV = Qs + kRT * kEbHeadDim;        // [kEbKT][kKvLd]
  float* mc = KV + kEbKT * kKvLd;           // [N]
  float* lc = mc + N;                       // [N]
  float* mr = lc + N;                       // [kRT]
  float* linv = mr + kRT;                   // [kRT]
  float* AV = linv + kRT;                   // [kRT][E]
  float* VA = AV + kRT * E;                 // [kRT][E]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, dir = blockIdx.y, b = blockIdx.z;
  const size_t C3 = 3 * (size_t)C;
  // direction 0: q from image 2, k and v_self from image 1
  const T* qimg = (dir == 0 ? a.img2 : a.img1) + (size_t)b * a.bstride;
  const T* kimg = (dir == 0 ? a.img1 : a.img2) + (size_t)b * a.bstride;
  const T* posb = E > kEbHeadDim ? a.pos + (size_t)b * N * kPosCols
                                 : nullptr;
  const int qoff = h * kEbHeadDim, koff = C + h * kEbHeadDim,
            voff = 2 * C + h * kEbHeadDim;

  // row n, column e of image img's v ++ positional columns (already in T)
  auto vrow = [&](const T* img, int n, int e) {
    return E == kEbHeadDim || e < kEbHeadDim
               ? to_f32(img[n * C3 + voff + e])
               : to_f32(posb[n * kPosCols + e - kEbHeadDim]);
  };
  const T* vaimg = CROSS ? qimg : kimg;

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

  // ---- phase 1 (dual softmax only): online column statistics
  if (!SINGLE) {
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
      S[idx] = SINGLE ? round_to<T>(exp2f(s - mr[i]))
                      : round_to<T>(exp2f(s - mr[i]) * exp2f(s - mc[j]));
    }
    // av = P . vb_n over key tiles, register tiles over (row, e); with
    // e = 70 the third column group covers e = 64 .. 69
    float av[4][kGroups] = {};
    for (int k0 = 0; k0 < N; k0 += kEbKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < (kEbKT * E + kEbThreads - 1) / kEbThreads; ++u) {
        const int idx = tid + u * kEbThreads;
        const int r = idx / E, e = idx % E;
        const int n = k0 + r;
        if (idx < kEbKT * E)
          KV[r * kKvLd + e] =
              n >= N   ? 0.f
              : SINGLE ? vrow(kimg, n, e)
                       : round_to<T>(vrow(kimg, n, e) * (1.f / lc[n]));
      }
      __syncthreads();
      const int kn = min(kEbKT, N - k0);
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
          VA[i * E + e] = i < rows ? vrow(vaimg, r0 + i, e) : 0.f;
        }
      }
    }
    __syncthreads();
    // F[e1][e2] += sum_i VA[i][e1] * AV[i][e2]; each thread owns its entries
#pragma unroll
    for (int u = 0; u < kFPerThread; ++u) {
      const int o = tid + u * kEbThreads;
      if (o >= E * E) break;
      const int e1 = o / E, e2 = o % E;
      float acc = f[u];
      for (int i = 0; i < kRT; ++i)
        acc = fmaf(VA[i * E + e1], AV[i * E + e2], acc);
      f[u] = acc;
    }
  }
  float* Fb = a.F + (((size_t)b * 2 + dir) * a.heads + h) * E * E;
#pragma unroll
  for (int u = 0; u < kFPerThread; ++u) {
    const int o = tid + u * kEbThreads;
    if (o < E * E) Fb[o] = f[u];
  }
}

template <typename T, int E, bool SINGLE, bool CROSS>
cudaError_t launch_dual_softmax(const EbArgs<T>& a, cudaStream_t st) {
  const size_t smem = dual_softmax_smem_bytes(a.N, E);
  cudaError_t err = cudaFuncSetAttribute(
      dual_softmax_kernel<T, E, SINGLE, CROSS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  dual_softmax_kernel<T, E, SINGLE, CROSS>
      <<<dim3(a.heads, 2, a.B), kEbThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

// X(T, E, SINGLE, CROSS) for the 4 fp32 variants of one e: {dual, single}
// x {va = v_self, cross}.  bf16 runs the tensor-core kernels of
// essential_tc.cuh and essential_tc_bwd.cuh.
#define RP_EB_VARIANTS(X, E)                                             \
  X(float, E, false, false) X(float, E, false, true)                     \
  X(float, E, true, false) X(float, E, true, true)

#define RP_EB_FWD_EXTERN(T, E, S, X) \
  extern template cudaError_t launch_dual_softmax<T, E, S, X>(   \
      const EbArgs<T>&, cudaStream_t);
#define RP_EB_FWD_INSTANTIATE(T, E, S, X) \
  template cudaError_t launch_dual_softmax<T, E, S, X>(            \
      const EbArgs<T>&, cudaStream_t);

}  // namespace rp

// The backward of the Essential Matrix Module's moments, fp32 (bf16 runs
// the tensor-core passes of essential_tc_bwd.cuh).
//
// Replaces: rel_pose_tpu/ops/pallas_essential_block_bwd.py:
// _essential_block_bwd_kernel, with its flags has_pos (e = 70 or 64),
// use_single_softmax (SINGLE) and cross_features (CROSS) as template
// parameters.  Per (pair, direction, head), from the pair's rounded qkv,
// the positional table and dF (e x e fp32):
//   s = q k^T d^-1/2 log2e;  R, Cmat = the normalized row / column
//   softmaxes (exp2);  A = R Cmat, or R alone with SINGLE;
//   vb = v_self (++ 6 positional columns);  va = vb, or with CROSS the v of
//   the query image (++ the same columns)
//   dva = T(A) T(vb T(dF)^T);   dvb = T(A)^T T(va T(dF));
//   dA = T(va T(dF)) vb^T
//   ds = R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC Cmat)),
//        dR = dA Cmat, dC = dA R;   with SINGLE ds = R (dA - rowsum(dA R))
//   dq = T(ds d^-1/2) k;  dk = T(ds d^-1/2)^T q
// with T the compute dtype at the Pallas kernel's rounding points
// (pallas_essential_block_bwd.py:68-111).  Direction 0 takes q from image
// 2 and k, v_self from image 1.  Each q and k slot of dqkv is written by
// exactly one (direction, head).  dvb goes to v_self's slot; so does dva
// when va = vb, summed in fp32 first (dv = T(dvb + dva)).  With CROSS, dva
// belongs to the query image's v slot, whose dvb the other direction's
// block writes: to keep one writer per slot and no atomics, the block
// writes T(dva) to a separate (B, 2, N, C) buffer, and the wrapper adds it
// to dqkv in T as the Pallas kernel accumulates (:126-144).  The positional
// columns of dvb (and of dva) go to per-combo fp32 partials (B, 2, h, N, 6),
// summed in a fixed order by the wrapper.
//
// Design.  Three of the terms need all N rows before any row can finish:
// the column statistics, colsum(dC Cmat), and the column-indexed sums dvb
// and dk.  As in the forward (essential_block.cuh), one CUDA block owns one
// combo -- 360 blocks at batch 60 -- and walks 32-row tiles of s (the full
// 32 x N rows in shared memory, 74 KB) in passes:
//   0. T(vb dF^T) for all N keys into the combo's scratch;
//   1. column max / sum of exp2(s), merged online (the forward's phase 1;
//      not with SINGLE);
//   2. per row tile: exact row statistics, T(va dF) for the tile, then over
//      key tiles dA and its R / Cmat terms -- rowsum(dR R), the tile's part
//      of colsum(dC Cmat), and T(A) in place of s; then dva rows, and the
//      tile's dvb contributions;
//   3. per row tile: s and dA again, ds, dq rows, and the tile's dk
//      contributions.
// The column accumulators dvb (+ dva) (N x e) and dk (N x 64), ~300 KB per
// combo, live in a per-combo scratch in device memory that L2 holds; only
// the owning block reads and writes them, in a fixed order, so there are no
// atomics and two runs give the same bits.
//
// What bounds it on the H100: the products, SIMT fp32 FMAs -- three score
// passes (3 N^2 64; two with SINGLE), dA twice (2 N^2 e), dva, dvb
// (2 N^2 e), dq, dk (2 N^2 64) per combo, about 11 N^2 64 against the
// forward's 3 -- with one 146 KB block per SM to hide their latency.
// Device memory: one read of qkv and dF, one write of dqkv, and the
// L2-resident scratch.

#pragma once

#include "essential_block.cuh"

namespace rp {

constexpr int kEbbHeadDim = 64;
constexpr int kEbbPos = 6;
constexpr int kEbbRT = 32;                    // query rows per tile
constexpr int kEbbKT = 64;                    // key rows per staged tile
constexpr int kEbbThreads = 256;
static_assert(kEbbRT == 4 * (kEbbThreads / 32) && kEbbKT == 64 &&
                  kEbbKT == 8 * (kEbbThreads / 32),
              "register tiles: 8 warps x 4 rows or 8 keys, 32 lanes x 2-3 "
              "columns");
static_assert(kEbbRT * kEbbHeadDim % kEbbThreads == 0 &&
                  kEbbKT * kEbbHeadDim % kEbbThreads == 0,
              "tile loads: whole unrolled steps");

template <typename T>
struct EbbArgs {
  const T* qkv;       // (B, 2, N, 3C)
  const T* pos;       // (B, N, 6), or NULL with e = 64
  const float* dF;    // (B, 2, heads, e, e)
  T* dqkv;            // (B, 2, N, 3C)
  T* dva;             // (B, 2, N, C): CROSS's dva in the v slots, or NULL
  float* dpos_part;   // (B, 2, heads, N, 6), or NULL with e = 64
  float* scratch;     // B * 2 * heads * ebb_scratch_floats(N, e)
  int B, N, C, heads;
};

__host__ __device__ constexpr int ebb_kv_floats(int E) {
  return E * E > kEbbKT * (E + 1) ? E * E : kEbbKT * (E + 1);
}

static inline size_t ebb_smem_bytes(int N, int E) {
  return sizeof(float) * ((size_t)kEbbRT * N        // S
                          + kEbbRT * kEbbHeadDim    // Qs
                          + ebb_kv_floats(E)        // KV
                          + E * E                   // dfb
                          + kEbbRT * E              // VAD
                          + 6 * (size_t)N           // column / row vectors
                          + (kEbbThreads / 32) * kEbbKT);  // red
}

// per combo: T(vb dF^T) (N x e), dvb (+ dva) (N x e), dk (N x 64)
__host__ __device__ inline size_t ebb_scratch_floats(int N, int E) {
  return (size_t)N * (2 * E + kEbbHeadDim);
}

template <typename T, int E, bool SINGLE, bool CROSS>
__global__ void __launch_bounds__(kEbbThreads)
essential_block_bwd_kernel(EbbArgs<T> a, float scale) {
  static_assert(E == kEbbHeadDim || E == kEbbHeadDim + kEbbPos,
                "e = d or d + 6");
  constexpr int kLd = E + 1;
  constexpr int kGroups = (E + 31) / 32;  // lane column groups: 2 or 3
  extern __shared__ float smem[];
  const int N = a.N, C = a.C;
  float* S = smem;                                // [kEbbRT][N]
  float* Qs = S + (size_t)kEbbRT * N;             // [kEbbRT][64]
  float* KV = Qs + kEbbRT * kEbbHeadDim;          // [kEbbKT][kLd] | e x e
  float* dfb = KV + ebb_kv_floats(E);             // [e][e]: T(dF)
  float* VAD = dfb + E * E;                       // [kEbbRT][e]: T(va dF)
  float* mc = VAD + kEbbRT * E;                   // [N] column max
  float* lc = mc + N;                             // [N] column sum
  float* mrA = lc + N;                            // [N] row max
  float* lrA = mrA + N;                           // [N] row sum
  float* rowR = lrA + N;                          // [N] rowsum(dR R)
  float* colC = rowR + N;                         // [N] colsum(dC Cmat)
  float* red = colC + N;                          // [8][kEbbKT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, dir = blockIdx.y, b = blockIdx.z;
  const size_t C3 = 3 * (size_t)C;
  // direction 0: q from image 2 (index 1), k and v from image 1 (index 0)
  const int qi = dir == 0 ? 1 : 0, ki = 1 - qi;
  const T* qimg = a.qkv + ((size_t)b * 2 + qi) * N * C3;
  const T* kimg = a.qkv + ((size_t)b * 2 + ki) * N * C3;
  const T* posb = E > kEbbHeadDim ? a.pos + (size_t)b * N * kEbbPos
                                  : nullptr;
  const int qoff = h * kEbbHeadDim, koff = C + h * kEbbHeadDim,
            voff = 2 * C + h * kEbbHeadDim;
  const size_t combo = ((size_t)b * 2 + dir) * gridDim.x + h;
  float* vbdft = a.scratch + combo * ebb_scratch_floats(N, E);  // [N][e]
  float* dvacc = vbdft + (size_t)N * E;                         // [N][e]
  float* dkacc = dvacc + (size_t)N * E;                         // [N][64]
  const float dscale = 0.125f;                                  // 64^-1/2

  // row n, column e of image img's v ++ positional columns (already in T)
  auto vrow = [&](const T* img, int n, int e) {
    return E == kEbbHeadDim || e < kEbbHeadDim
               ? to_f32(img[n * C3 + voff + e])
               : to_f32(posb[n * kEbbPos + e - kEbbHeadDim]);
  };
  // KV[r][e] = row n0 + r of img's v (++ pos) for r < nrows (0 past N)
  auto load_v = [&](const T* img, int n0, int nrows) {
    for (int idx = tid; idx < nrows * E; idx += kEbbThreads) {
      const int r = idx / E, e = idx % E;
      KV[r * kLd + e] = n0 + r < N ? vrow(img, n0 + r, e) : 0.f;
    }
  };
  const int wr = warp * 4;  // tile rows of this warp
  const int wk = warp * 8;  // tile keys of this warp (column accumulators)

  // s tile for query rows r0 .. r0 + rows into S (rows past N score 0);
  // the forward's arithmetic, so the same bits
  auto score_tile = [&](int r0, int rows) {
    __syncthreads();  // the previous tile's readers of Qs and S are done
#pragma unroll
    for (int u = 0; u < kEbbRT * kEbbHeadDim / kEbbThreads; ++u) {
      const int idx = tid + u * kEbbThreads;
      const int r = idx / kEbbHeadDim, c = idx % kEbbHeadDim;
      Qs[idx] = r < rows ? to_f32(qimg[(r0 + r) * C3 + qoff + c]) : 0.f;
    }
    for (int k0 = 0; k0 < N; k0 += kEbbKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kEbbKT * kEbbHeadDim / kEbbThreads; ++u) {
        const int idx = tid + u * kEbbThreads;
        const int r = idx / kEbbHeadDim, c = idx % kEbbHeadDim;
        KV[r * kLd + c] =
            k0 + r < N ? to_f32(kimg[(k0 + r) * C3 + koff + c]) : 0.f;
      }
      __syncthreads();
      float acc[4][2] = {};
#pragma unroll 8
      for (int c = 0; c < kEbbHeadDim; ++c) {
        const float k_lo = KV[lane * kLd + c];
        const float k_hi = KV[(lane + 32) * kLd + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float q = Qs[(wr + r) * kEbbHeadDim + c];
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

  // VAD = T(va_tile . T(dF)) for the row tile r0
  auto vadf_tile = [&](int r0) {
    __syncthreads();
    load_v(CROSS ? qimg : kimg, r0, kEbbRT);  // rows past N load as 0
    __syncthreads();
    float acc[4][kGroups] = {};
    for (int e = 0; e < E; ++e) {
      const float* d = dfb + e * E;
      float dv[kGroups];
#pragma unroll
      for (int t = 0; t < kGroups; ++t)
        dv[t] = t < 2 || lane + 32 * t < E ? d[lane + 32 * t] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float va = KV[(wr + r) * kLd + e];
#pragma unroll
        for (int t = 0; t < kGroups; ++t)
          acc[r][t] = fmaf(va, dv[t], acc[r][t]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < kGroups; ++t)
        if (lane + 32 * t < E)
          VAD[(wr + r) * E + lane + 32 * t] = round_to<T>(acc[r][t]);
  };

  // dA = VAD . vb^T for the tile's rows and keys k0 + lane (+ 32), after
  // staging vb rows k0 .. k0 + 63 in KV
  auto da_tile = [&](int k0, float (&dA)[4][2]) {
    __syncthreads();
    load_v(kimg, k0, kEbbKT);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) dA[r][0] = dA[r][1] = 0.f;
    for (int f = 0; f < E; ++f) {
      const float v_lo = KV[lane * kLd + f];
      const float v_hi = KV[(lane + 32) * kLd + f];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float va = VAD[(wr + r) * E + f];
        dA[r][0] = fmaf(va, v_lo, dA[r][0]);
        dA[r][1] = fmaf(va, v_hi, dA[r][1]);
      }
    }
  };

  // ---- pass 0: T(dF), zeroed accumulators, T(vb . T(dF)^T) for all keys
  for (int idx = tid; idx < E * E; idx += kEbbThreads)
    dfb[idx] = round_to<T>(a.dF[combo * E * E + idx]);
  for (int idx = tid; idx < N * E; idx += kEbbThreads) dvacc[idx] = 0.f;
  for (int idx = tid; idx < N * kEbbHeadDim; idx += kEbbThreads)
    dkacc[idx] = 0.f;
  for (int j = tid; j < N; j += kEbbThreads) {
    mc[j] = -INFINITY;
    lc[j] = 0.f;
    colC[j] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kEbbKT) {
    __syncthreads();
    load_v(kimg, k0, kEbbKT);
    __syncthreads();
    for (int idx = tid; idx < kEbbKT * E; idx += kEbbThreads) {
      const int r = idx / E, e = idx % E;
      if (k0 + r >= N) continue;
      float acc = 0.f;
      for (int f = 0; f < E; ++f)
        acc = fmaf(KV[r * kLd + f], dfb[e * E + f], acc);
      vbdft[(size_t)(k0 + r) * E + e] = round_to<T>(acc);
    }
  }

  // ---- pass 1 (dual softmax only): online column statistics
  if (!SINGLE) {
    for (int r0 = 0; r0 < N; r0 += kEbbRT) {
      const int rows = min(kEbbRT, N - r0);
      score_tile(r0, rows);
      for (int j = tid; j < N; j += kEbbThreads) {
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

  // ---- pass 2: row terms, colsum(dC Cmat), dva and dvb
  for (int r0 = 0; r0 < N; r0 += kEbbRT) {
    const int rows = min(kEbbRT, N - r0);
    score_tile(r0, rows);  // ends with a barrier: mc / lc visible too
    for (int i = warp; i < rows; i += kEbbThreads / 32) {
      const float* row = S + (size_t)i * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < N; j += 32) l += exp2f(row[j] - m);
      l = warp_sum(l);
      if (lane == 0) {
        mrA[r0 + i] = m;
        lrA[r0 + i] = l;
      }
    }
    vadf_tile(r0);
    float rowp[4] = {};
    for (int k0 = 0; k0 < N; k0 += kEbbKT) {
      float dA[4][2];
      da_tile(k0, dA);
      float colp[2] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = wr + r;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = k0 + lane + 32 * s;
          if (i >= rows || j >= N) continue;
          float* sp = S + (size_t)i * N + j;
          const float R = exp2f(*sp - mrA[r0 + i]) / lrA[r0 + i];
          if (SINGLE) {
            rowp[r] += dA[r][s] * R;
            *sp = round_to<T>(R);  // T(A) replaces s
          } else {
            const float Cm = exp2f(*sp - mc[j]) / lc[j];
            const float dR = dA[r][s] * Cm, dC = dA[r][s] * R;
            rowp[r] += dR * R;
            colp[s] += dC * Cm;
            *sp = round_to<T>(R * Cm);  // T(A) replaces s
          }
        }
      }
      if (!SINGLE) {
        red[warp * kEbbKT + lane] = colp[0];
        red[warp * kEbbKT + lane + 32] = colp[1];
        __syncthreads();
        if (tid < kEbbKT && k0 + tid < N) {
          float t = 0.f;
          for (int w = 0; w < kEbbThreads / 32; ++w)
            t += red[w * kEbbKT + tid];
          colC[k0 + tid] += t;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float t = warp_sum(rowp[r]);
      if (lane == 0 && wr + r < rows) rowR[r0 + wr + r] = t;
    }
    // dva rows (A . T(vb dF^T)) and this tile's dvb (A^T . VAD)
    float dva[4][kGroups] = {};
    for (int k0 = 0; k0 < N; k0 += kEbbKT) {
      __syncthreads();
      for (int idx = tid; idx < kEbbKT * E; idx += kEbbThreads) {
        const int r = idx / E, e = idx % E;
        KV[r * kLd + e] = k0 + r < N ? vbdft[(size_t)(k0 + r) * E + e] : 0.f;
      }
      __syncthreads();
      const int kn = min(kEbbKT, N - k0);
      for (int j = 0; j < kn; ++j) {
        const float* kv = KV + j * kLd;
        float v[kGroups];
#pragma unroll
        for (int t = 0; t < kGroups; ++t)
          v[t] = t < 2 || lane + 32 * t < E ? kv[lane + 32 * t] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = S[(size_t)(wr + r) * N + k0 + j];
#pragma unroll
          for (int t = 0; t < kGroups; ++t)
            dva[r][t] = fmaf(p, v[t], dva[r][t]);
        }
      }
      float acc[8][kGroups] = {};
      for (int i = 0; i < rows; ++i) {
        const float* va = VAD + i * E;
        float av[kGroups];
#pragma unroll
        for (int t = 0; t < kGroups; ++t)
          av[t] = t < 2 || lane + 32 * t < E ? va[lane + 32 * t] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = k0 + wk + jj;
          const float p = n < N ? S[(size_t)i * N + n] : 0.f;
#pragma unroll
          for (int t = 0; t < kGroups; ++t)
            acc[jj][t] = fmaf(p, av[t], acc[jj][t]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = k0 + wk + jj;
        if (n >= N) continue;
#pragma unroll
        for (int t = 0; t < kGroups; ++t)
          if (lane + 32 * t < E)
            dvacc[(size_t)n * E + lane + 32 * t] += acc[jj][t];
      }
    }
    __syncthreads();  // this tile's dvb updates land before its dva rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
      if (i >= rows) continue;
#pragma unroll
      for (int t = 0; t < kGroups; ++t) {
        const int e = lane + 32 * t;
        if (e >= E) continue;
        if (CROSS && e < kEbbHeadDim)  // the query image's v slot
          a.dva[(((size_t)b * 2 + qi) * N + r0 + i) * C + qoff + e] =
              from_f32<T>(dva[r][t]);
        else
          dvacc[(size_t)(r0 + i) * E + e] += dva[r][t];
      }
    }
  }

  // ---- pass 3: ds, dq rows, dk
  T* qout = a.dqkv + ((size_t)b * 2 + qi) * N * C3;
  for (int r0 = 0; r0 < N; r0 += kEbbRT) {
    const int rows = min(kEbbRT, N - r0);
    score_tile(r0, rows);
    vadf_tile(r0);
    for (int k0 = 0; k0 < N; k0 += kEbbKT) {
      float dA[4][2];
      da_tile(k0, dA);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = wr + r;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = k0 + lane + 32 * s;
          if (i >= rows || j >= N) continue;
          float* sp = S + (size_t)i * N + j;
          const float R = exp2f(*sp - mrA[r0 + i]) / lrA[r0 + i];
          float ds;
          if (SINGLE) {
            ds = R * (dA[r][s] - rowR[r0 + i]);
          } else {
            const float Cm = exp2f(*sp - mc[j]) / lc[j];
            const float dR = dA[r][s] * Cm, dC = dA[r][s] * R;
            ds = R * (dR - rowR[r0 + i]) + Cm * (dC - colC[j]);
          }
          *sp = round_to<T>(ds * dscale);  // T(ds d^-1/2) replaces s
        }
      }
    }
    float dq[4][2] = {};
    for (int k0 = 0; k0 < N; k0 += kEbbKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kEbbKT * kEbbHeadDim / kEbbThreads; ++u) {
        const int idx = tid + u * kEbbThreads;
        const int r = idx / kEbbHeadDim, c = idx % kEbbHeadDim;
        KV[r * kLd + c] =
            k0 + r < N ? to_f32(kimg[(k0 + r) * C3 + koff + c]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kEbbKT, N - k0);
      for (int j = 0; j < kn; ++j) {
        const float k_lo = KV[j * kLd + lane];
        const float k_hi = KV[j * kLd + lane + 32];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ds = S[(size_t)(wr + r) * N + k0 + j];
          dq[r][0] = fmaf(ds, k_lo, dq[r][0]);
          dq[r][1] = fmaf(ds, k_hi, dq[r][1]);
        }
      }
      float acc[8][2] = {};
      for (int i = 0; i < rows; ++i) {
        const float q0 = Qs[i * kEbbHeadDim + lane];
        const float q1 = Qs[i * kEbbHeadDim + lane + 32];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = k0 + wk + jj;
          const float ds = n < N ? S[(size_t)i * N + n] : 0.f;
          acc[jj][0] = fmaf(ds, q0, acc[jj][0]);
          acc[jj][1] = fmaf(ds, q1, acc[jj][1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = k0 + wk + jj;
        if (n >= N) continue;
        dkacc[(size_t)n * kEbbHeadDim + lane] += acc[jj][0];
        dkacc[(size_t)n * kEbbHeadDim + lane + 32] += acc[jj][1];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
      if (i >= rows) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        qout[(size_t)(r0 + i) * C3 + qoff + lane + 32 * s] =
            from_f32<T>(dq[r][s]);
    }
  }
  __syncthreads();

  // dk, dv into the k image's slots; dv's positional columns to dpos_part
  T* kout = a.dqkv + ((size_t)b * 2 + ki) * N * C3;
  for (int idx = tid; idx < N * kEbbHeadDim; idx += kEbbThreads) {
    const int n = idx / kEbbHeadDim, d = idx % kEbbHeadDim;
    kout[(size_t)n * C3 + koff + d] = from_f32<T>(dkacc[idx]);
  }
  for (int idx = tid; idx < N * E; idx += kEbbThreads) {
    const int n = idx / E, e = idx % E;
    const float v = dvacc[idx];
    if (E == kEbbHeadDim || e < kEbbHeadDim)
      kout[(size_t)n * C3 + voff + e] = from_f32<T>(v);
    else
      a.dpos_part[(combo * N + n) * kEbbPos + e - kEbbHeadDim] = v;
  }
}

template <typename T, int E, bool SINGLE, bool CROSS>
cudaError_t launch_essential_block_bwd(const EbbArgs<T>& a,
                                       cudaStream_t st) {
  const size_t smem = ebb_smem_bytes(a.N, E);
  cudaError_t err = cudaFuncSetAttribute(
      essential_block_bwd_kernel<T, E, SINGLE, CROSS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  essential_block_bwd_kernel<T, E, SINGLE, CROSS>
      <<<dim3(a.heads, 2, a.B), kEbbThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

#define RP_EBB_EXTERN(T, E, S, X) \
  extern template cudaError_t launch_essential_block_bwd<T, E, S, X>(   \
      const EbbArgs<T>&, cudaStream_t);
#define RP_EBB_INSTANTIATE(T, E, S, X) \
  template cudaError_t launch_essential_block_bwd<T, E, S, X>(            \
      const EbbArgs<T>&, cudaStream_t);

}  // namespace rp

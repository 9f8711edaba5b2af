// Hand kernel for the backward of the Essential Matrix Module's dual-softmax
// moments.
//
// Replaces: rel_pose_tpu/ops/pallas_essential_block_bwd.py:
// _essential_block_bwd_kernel, for the slice's case (positions on, dual
// softmax, no cross features).  Per (pair, direction, head), from the pair's
// rounded qkv, the positional table and dF (70 x 70 fp32):
//   s = q k^T d^-1/2 log2e;  R, Cmat = the normalized row / column
//   softmaxes (exp2);  A = R Cmat;  va = vb = v ++ 6 positional columns
//   dva = T(A) T(vb T(dF)^T);   dvb = T(A)^T T(va T(dF));
//   dA = T(va T(dF)) vb^T;  dR = dA Cmat;  dC = dA R
//   ds = R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC Cmat))
//   dq = T(ds d^-1/2) k;  dk = T(ds d^-1/2)^T q;  dv = dvb + dva
// with T the compute dtype at the Pallas kernel's rounding points
// (pallas_essential_block_bwd.py:83-107).  Direction 0 takes q from image 2
// and k, v from image 1.  Each q, k and v slot of dqkv is written by exactly
// one (direction, head); the positional columns of dv go to per-combo
// partials (B, 2, h, N, 6), summed in a fixed order by the wrapper.
//
// Design.  Three of the terms need all N rows before any row can finish:
// the column statistics, colsum(dC Cmat), and the column-indexed sums dvb
// and dk.  As in the forward (essential_block.cu), one CUDA block owns one
// combo -- 360 blocks at batch 60 -- and walks 32-row tiles of s (the full
// 32 x N rows in shared memory, 74 KB) in passes:
//   0. T(vb dF^T) for all N keys into the combo's scratch;
//   1. column max / sum of exp2(s), merged online (the forward's phase 1);
//   2. per row tile: exact row statistics, T(va dF) for the tile, then over
//      key tiles dA and its R / Cmat terms -- rowsum(dR R), the tile's part
//      of colsum(dC Cmat), and T(A) in place of s; then dva rows, and the
//      tile's dvb contributions;
//   3. per row tile: s and dA again, ds, dq rows, and the tile's dk
//      contributions.
// The column accumulators dvb + dva (N x 70) and dk (N x 64), ~300 KB per
// combo, live in a per-combo scratch in device memory that L2 holds; only
// the owning block reads and writes them, in a fixed order, so there are no
// atomics and two runs give the same bits.
//
// What bounds it on the H100: the products, SIMT fp32 FMAs -- three score
// passes (3 N^2 64), dA twice (2 N^2 70), dva, dvb (2 N^2 70), dq, dk
// (2 N^2 64) per combo, about 11 N^2 64 against the forward's 3 -- with one
// 146 KB block per SM to hide their latency.  Device memory: one read of
// qkv and dF, one write of dqkv, and the L2-resident scratch.

#include "common.cuh"

namespace rp {

constexpr int kEbbHeadDim = 64;
constexpr int kEbbPos = 6;
constexpr int kEbbE = kEbbHeadDim + kEbbPos;  // 70
constexpr int kEbbRT = 32;                    // query rows per tile
constexpr int kEbbKT = 64;                    // key rows per staged tile
constexpr int kEbbThreads = 256;
constexpr int kEbbLd = kEbbE + 1;
constexpr int kEbbKvFloats =
    kEbbE * kEbbE > kEbbKT * kEbbLd ? kEbbE * kEbbE : kEbbKT * kEbbLd;
static_assert(kEbbRT == 4 * (kEbbThreads / 32) && kEbbKT == 64 &&
                  kEbbKT == 8 * (kEbbThreads / 32) && kEbbE <= 96,
              "register tiles: 8 warps x 4 rows or 8 keys, 32 lanes x 2-3 "
              "columns");
static_assert(kEbbRT * kEbbHeadDim % kEbbThreads == 0 &&
                  kEbbKT * kEbbHeadDim % kEbbThreads == 0,
              "tile loads: whole unrolled steps");

static size_t ebb_smem_bytes(int N) {
  return sizeof(float) * ((size_t)kEbbRT * N        // S
                          + kEbbRT * kEbbHeadDim    // Qs
                          + kEbbKvFloats            // KV
                          + kEbbE * kEbbE           // dfb
                          + kEbbRT * kEbbE          // VAD
                          + 6 * (size_t)N           // column / row vectors
                          + (kEbbThreads / 32) * kEbbKT);  // red
}

// per combo: T(vb dF^T) (N x 70), dvb + dva (N x 70), dk (N x 64)
__host__ __device__ static size_t ebb_scratch_floats(int N) {
  return (size_t)N * (2 * kEbbE + kEbbHeadDim);
}

template <typename T>
__global__ void __launch_bounds__(kEbbThreads)
essential_block_bwd_kernel(const T* __restrict__ qkv,
                           const T* __restrict__ pos,
                           const float* __restrict__ dF,
                           T* __restrict__ dqkv,
                           float* __restrict__ dpos_part,
                           float* __restrict__ scratch, int N, int C,
                           float scale) {
  extern __shared__ float smem[];
  float* S = smem;                                // [kEbbRT][N]
  float* Qs = S + (size_t)kEbbRT * N;             // [kEbbRT][64]
  float* KV = Qs + kEbbRT * kEbbHeadDim;          // [kEbbKT][kEbbLd] | 70x70
  float* dfb = KV + kEbbKvFloats;                 // [70][70]: T(dF)
  float* VAD = dfb + kEbbE * kEbbE;               // [kEbbRT][70]: T(va dF)
  float* mc = VAD + kEbbRT * kEbbE;               // [N] column max
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
  const T* qimg = qkv + ((size_t)b * 2 + qi) * N * C3;
  const T* kimg = qkv + ((size_t)b * 2 + ki) * N * C3;
  const T* posb = pos + (size_t)b * N * kEbbPos;
  const int qoff = h * kEbbHeadDim, koff = C + h * kEbbHeadDim,
            voff = 2 * C + h * kEbbHeadDim;
  const size_t combo = ((size_t)b * 2 + dir) * gridDim.x + h;
  float* vbdft = scratch + combo * ebb_scratch_floats(N);  // [N][70]
  float* dvacc = vbdft + (size_t)N * kEbbE;                // [N][70]
  float* dkacc = dvacc + (size_t)N * kEbbE;                // [N][64]
  const float dscale = 0.125f;                             // 64^-1/2

  // v_self row n, column e (positional columns appended, already in T)
  auto vself = [&](int n, int e) {
    return e < kEbbHeadDim ? to_f32(kimg[n * C3 + voff + e])
                           : to_f32(posb[n * kEbbPos + e - kEbbHeadDim]);
  };
  // KV[r][e] = v_self row n0 + r for r < nrows (0 past N)
  auto load_v = [&](int n0, int nrows) {
    for (int idx = tid; idx < nrows * kEbbE; idx += kEbbThreads) {
      const int r = idx / kEbbE, e = idx % kEbbE;
      KV[r * kEbbLd + e] = n0 + r < N ? vself(n0 + r, e) : 0.f;
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
        KV[r * kEbbLd + c] =
            k0 + r < N ? to_f32(kimg[(k0 + r) * C3 + koff + c]) : 0.f;
      }
      __syncthreads();
      float acc[4][2] = {};
#pragma unroll 8
      for (int c = 0; c < kEbbHeadDim; ++c) {
        const float k_lo = KV[lane * kEbbLd + c];
        const float k_hi = KV[(lane + 32) * kEbbLd + c];
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

  // VAD = T(va_tile . T(dF)) for the row tile r0 (va = v_self)
  auto vadf_tile = [&](int r0) {
    __syncthreads();
    load_v(r0, kEbbRT);  // rows past N load as 0
    __syncthreads();
    float acc[4][3] = {};
    for (int e = 0; e < kEbbE; ++e) {
      const float* d = dfb + e * kEbbE;
      const float d0 = d[lane], d1 = d[lane + 32];
      const float d2 = lane + 64 < kEbbE ? d[lane + 64] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = KV[(wr + r) * kEbbLd + e];
        acc[r][0] = fmaf(a, d0, acc[r][0]);
        acc[r][1] = fmaf(a, d1, acc[r][1]);
        acc[r][2] = fmaf(a, d2, acc[r][2]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (lane + 32 * t < kEbbE)
          VAD[(wr + r) * kEbbE + lane + 32 * t] = round_to<T>(acc[r][t]);
  };

  // dA = VAD . vb^T for the tile's rows and keys k0 + lane (+ 32), after
  // staging vb rows k0 .. k0 + 63 in KV
  auto da_tile = [&](int k0, float (&dA)[4][2]) {
    __syncthreads();
    load_v(k0, kEbbKT);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) dA[r][0] = dA[r][1] = 0.f;
    for (int f = 0; f < kEbbE; ++f) {
      const float v_lo = KV[lane * kEbbLd + f];
      const float v_hi = KV[(lane + 32) * kEbbLd + f];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = VAD[(wr + r) * kEbbE + f];
        dA[r][0] = fmaf(a, v_lo, dA[r][0]);
        dA[r][1] = fmaf(a, v_hi, dA[r][1]);
      }
    }
  };

  // ---- pass 0: T(dF), zeroed accumulators, T(vb . T(dF)^T) for all keys
  for (int idx = tid; idx < kEbbE * kEbbE; idx += kEbbThreads)
    dfb[idx] = round_to<T>(dF[combo * kEbbE * kEbbE + idx]);
  for (int idx = tid; idx < N * kEbbE; idx += kEbbThreads) dvacc[idx] = 0.f;
  for (int idx = tid; idx < N * kEbbHeadDim; idx += kEbbThreads)
    dkacc[idx] = 0.f;
  for (int j = tid; j < N; j += kEbbThreads) {
    mc[j] = -INFINITY;
    lc[j] = 0.f;
    colC[j] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kEbbKT) {
    __syncthreads();
    load_v(k0, kEbbKT);
    __syncthreads();
    for (int idx = tid; idx < kEbbKT * kEbbE; idx += kEbbThreads) {
      const int r = idx / kEbbE, e = idx % kEbbE;
      if (k0 + r >= N) continue;
      float acc = 0.f;
      for (int f = 0; f < kEbbE; ++f)
        acc = fmaf(KV[r * kEbbLd + f], dfb[e * kEbbE + f], acc);
      vbdft[(size_t)(k0 + r) * kEbbE + e] = round_to<T>(acc);
    }
  }

  // ---- pass 1: online column statistics over all row tiles
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
          const float Cm = exp2f(*sp - mc[j]) / lc[j];
          const float dR = dA[r][s] * Cm, dC = dA[r][s] * R;
          rowp[r] += dR * R;
          colp[s] += dC * Cm;
          *sp = round_to<T>(R * Cm);  // T(A) replaces s
        }
      }
      red[warp * kEbbKT + lane] = colp[0];
      red[warp * kEbbKT + lane + 32] = colp[1];
      __syncthreads();
      if (tid < kEbbKT && k0 + tid < N) {
        float t = 0.f;
        for (int w = 0; w < kEbbThreads / 32; ++w) t += red[w * kEbbKT + tid];
        colC[k0 + tid] += t;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float t = warp_sum(rowp[r]);
      if (lane == 0 && wr + r < rows) rowR[r0 + wr + r] = t;
    }
    // dva rows (A . T(vb dF^T)) and this tile's dvb (A^T . VAD)
    float dva[4][3] = {};
    for (int k0 = 0; k0 < N; k0 += kEbbKT) {
      __syncthreads();
      for (int idx = tid; idx < kEbbKT * kEbbE; idx += kEbbThreads) {
        const int r = idx / kEbbE, e = idx % kEbbE;
        KV[r * kEbbLd + e] =
            k0 + r < N ? vbdft[(size_t)(k0 + r) * kEbbE + e] : 0.f;
      }
      __syncthreads();
      const int kn = min(kEbbKT, N - k0);
      for (int j = 0; j < kn; ++j) {
        const float* kv = KV + j * kEbbLd;
        const float v0 = kv[lane], v1 = kv[lane + 32];
        const float v2 = lane + 64 < kEbbE ? kv[lane + 64] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = S[(size_t)(wr + r) * N + k0 + j];
          dva[r][0] = fmaf(a, v0, dva[r][0]);
          dva[r][1] = fmaf(a, v1, dva[r][1]);
          dva[r][2] = fmaf(a, v2, dva[r][2]);
        }
      }
      float acc[8][3] = {};
      for (int i = 0; i < rows; ++i) {
        const float* va = VAD + i * kEbbE;
        const float a0 = va[lane], a1 = va[lane + 32];
        const float a2 = lane + 64 < kEbbE ? va[lane + 64] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = k0 + wk + jj;
          const float p = n < N ? S[(size_t)i * N + n] : 0.f;
          acc[jj][0] = fmaf(p, a0, acc[jj][0]);
          acc[jj][1] = fmaf(p, a1, acc[jj][1]);
          acc[jj][2] = fmaf(p, a2, acc[jj][2]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = k0 + wk + jj;
        if (n >= N) continue;
#pragma unroll
        for (int t = 0; t < 3; ++t)
          if (lane + 32 * t < kEbbE)
            dvacc[(size_t)n * kEbbE + lane + 32 * t] += acc[jj][t];
      }
    }
    __syncthreads();  // this tile's dvb updates land before its dva rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
      if (i >= rows) continue;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (lane + 32 * t < kEbbE)
          dvacc[(size_t)(r0 + i) * kEbbE + lane + 32 * t] += dva[r][t];
    }
  }

  // ---- pass 3: ds, dq rows, dk
  T* qout = dqkv + ((size_t)b * 2 + qi) * N * C3;
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
          const float Cm = exp2f(*sp - mc[j]) / lc[j];
          const float dR = dA[r][s] * Cm, dC = dA[r][s] * R;
          const float ds =
              R * (dR - rowR[r0 + i]) + Cm * (dC - colC[j]);
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
        KV[r * kEbbLd + c] =
            k0 + r < N ? to_f32(kimg[(k0 + r) * C3 + koff + c]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kEbbKT, N - k0);
      for (int j = 0; j < kn; ++j) {
        const float k_lo = KV[j * kEbbLd + lane];
        const float k_hi = KV[j * kEbbLd + lane + 32];
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
  T* kout = dqkv + ((size_t)b * 2 + ki) * N * C3;
  for (int idx = tid; idx < N * kEbbHeadDim; idx += kEbbThreads) {
    const int n = idx / kEbbHeadDim, d = idx % kEbbHeadDim;
    kout[(size_t)n * C3 + koff + d] = from_f32<T>(dkacc[idx]);
  }
  for (int idx = tid; idx < N * kEbbE; idx += kEbbThreads) {
    const int n = idx / kEbbE, e = idx % kEbbE;
    const float v = dvacc[idx];
    if (e < kEbbHeadDim)
      kout[(size_t)n * C3 + voff + e] = from_f32<T>(v);
    else
      dpos_part[(combo * N + n) * kEbbPos + e - kEbbHeadDim] = v;
  }
}

template <typename T>
static cudaError_t essential_block_bwd(const T* qkv, const T* pos,
                                       const float* dF, T* dqkv,
                                       float* dpos_part, float* scratch,
                                       int B, int N, int C, int heads,
                                       cudaStream_t st) {
  if (C != heads * kEbbHeadDim) return cudaErrorInvalidValue;
  const size_t smem = ebb_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      essential_block_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  essential_block_bwd_kernel<T><<<dim3(heads, 2, B), kEbbThreads, smem, st>>>(
      qkv, pos, dF, dqkv, dpos_part, scratch, N, C, scale);
  return cudaGetLastError();
}

}  // namespace rp

extern "C" long long rp_essential_block_bwd_workspace(int B, int N,
                                                      int heads) {
  return (long long)(sizeof(float) * (size_t)B * 2 * heads *
                     rp::ebb_scratch_floats(N));
}

// qkv (B, 2, N, 3C) and pos (B, N, 6) in T, dF (B, 2, heads, 70, 70) fp32
// -> dqkv (B, 2, N, 3C) in T, dpos_part (B, 2, heads, N, 6) fp32
extern "C" int rp_essential_block_bwd(const void* qkv, const void* pos,
                                      const float* dF, void* dqkv,
                                      float* dpos_part, void* ws, int B,
                                      int N, int C, int heads, int bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::essential_block_bwd<T>((const T*)qkv, (const T*)pos, dF,
                                      (T*)dqkv, dpos_part, (float*)ws, B, N,
                                      C, heads, st);
  }
  return rp::essential_block_bwd<float>(
      (const float*)qkv, (const float*)pos, dF, (float*)dqkv, dpos_part,
      (float*)ws, B, N, C, heads, st);
}

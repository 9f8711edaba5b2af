// Backward of the per-head bilinear attention op: Pallas kernel #8's VJP.
//
// Replaces: rel_pose_tpu/ops/pallas_essential.py:_bwd_kernel.  Per slice g
// of q, k (G, N, 64), va, vb (G, N, e) and dF (G, e, e) fp32, with T the
// inputs' dtype at _bwd_kernel's rounding points:
//   s2 = q k^T scale log2e;  R, Cmat = the normalized row / column softmaxes
//   (exp2);  A = R Cmat, or R alone with SINGLE;  Ab = T(A)
//   dva = T(Ab T(vb T(dF)^T));   vadf = T(va T(dF));   dvb = T(Ab^T vadf)
//   dA = vadf vb^T (fp32)
//   ds = R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC Cmat)),
//        dR = dA Cmat, dC = dA R;   with SINGLE ds = R (dA - rowsum(dA R))
//   dq = T(T(ds scale) k);  dk = T(T(ds scale)^T q)
// It is the per-(pair, direction, head) VJP of essential_block_bwd.cuh (#6)
// on a slice of its own: no directions, no positional bookkeeping, and va,
// vb separate tensors (one tensor in the non-cross wiring; the caller's
// autograd adds dva and dvb).  Each of dq, dk, dva, dvb has one writer, the
// slice's block: no atomics, and two runs give the same bits.
//
// Design (#6's): one CUDA block per slice walks 32-row tiles of s, the
// full 32 x N rows in shared memory, in passes:
//   0. T(vb T(dF)^T) for all N keys into the slice's scratch;
//   1. column max / sum of exp2(s2), merged online (not with SINGLE);
//   2. per row tile: exact row statistics, T(va T(dF)) for the tile, then
//      over key tiles dA and its R / Cmat terms -- rowsum(dR R), the tile's
//      part of colsum(dC Cmat), and T(A) in place of s; then the dva rows
//      and the tile's dvb contributions;
//   3. per row tile: s and dA again, ds, the dq rows and the tile's dk
//      contributions.
// The column accumulators dvb (N x e) and dk (N x 64) live in the slice's
// scratch in device memory, which L2 holds.  What bounds it on the H100:
// the products as SIMT fp32 FMAs -- three score passes (two with SINGLE),
// dA twice, dva, dvb, dq, dk -- with one 146 KB block per SM; device memory
// sees one read of the inputs and dF and one write of the four outputs.

#include "bilinear.cuh"

namespace rp {

template <typename T>
struct BlbArgs {
  const T* q;          // (G, N, 64)
  const T* k;          // (G, N, 64)
  const T* va;         // (G, N, e)
  const T* vb;         // (G, N, e)
  const float* dF;     // (G, e, e)
  T* dq;               // (G, N, 64)
  T* dk;               // (G, N, 64)
  T* dva;              // (G, N, e)
  T* dvb;              // (G, N, e)
  float* scratch;      // G * blb_scratch_floats(N, e)
  int N;
};

__host__ __device__ constexpr int blb_kv_floats(int E) {
  return E * E > kBlKT * (E + 1) ? E * E : kBlKT * (E + 1);
}

static inline size_t blb_smem_bytes(int N, int E) {
  return sizeof(float) * ((size_t)kBlRT * N          // S
                          + kBlRT * kBlD             // Qs
                          + blb_kv_floats(E)         // KV
                          + E * E                    // dfb
                          + kBlRT * E                // VAD
                          + 6 * (size_t)N            // column / row vectors
                          + (kBlThreads / 32) * kBlKT);  // red
}

// per slice: T(vb dF^T) (N x e), dvb (N x e), dk (N x 64)
__host__ __device__ inline size_t blb_scratch_floats(int N, int E) {
  return (size_t)N * (2 * E + kBlD);
}

template <typename T, int E, bool SINGLE>
__global__ void __launch_bounds__(kBlThreads)
bilinear_bwd_kernel(BlbArgs<T> a, float scale2, float dscale) {
  static_assert(kBlKT == 8 * (kBlThreads / 32), "8 keys per warp");
  constexpr int kLd = E + 1;
  constexpr int kGroups = (E + 31) / 32;  // lane column groups: 2 or 3
  extern __shared__ float smem[];
  const int N = a.N;
  float* S = smem;                                // [kBlRT][N]
  float* Qs = S + (size_t)kBlRT * N;              // [kBlRT][64]
  float* KV = Qs + kBlRT * kBlD;                  // [kBlKT][kLd] | e x e
  float* dfb = KV + blb_kv_floats(E);             // [e][e]: T(dF)
  float* VAD = dfb + E * E;                       // [kBlRT][e]: T(va dF)
  float* mc = VAD + kBlRT * E;                    // [N] column max
  float* lc = mc + N;                             // [N] column sum
  float* mrA = lc + N;                            // [N] row max
  float* lrA = mrA + N;                           // [N] row sum
  float* rowR = lrA + N;                          // [N] rowsum(dR R)
  float* colC = rowR + N;                         // [N] colsum(dC Cmat)
  float* red = colC + N;                          // [8][kBlKT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  const T* q = a.q + g * N * kBlD;
  const T* k = a.k + g * N * kBlD;
  const T* va = a.va + g * N * E;
  const T* vb = a.vb + g * N * E;
  float* vbdft = a.scratch + g * blb_scratch_floats(N, E);  // [N][e]
  float* dvacc = vbdft + (size_t)N * E;                     // [N][e]: dvb
  float* dkacc = dvacc + (size_t)N * E;                     // [N][64]

  // KV[r][e] = row n0 + r of v (va or vb) for r < nrows (0 past N)
  auto load_v = [&](const T* v, int n0, int nrows) {
    for (int idx = tid; idx < nrows * E; idx += kBlThreads) {
      const int r = idx / E, e = idx % E;
      KV[r * kLd + e] = n0 + r < N ? to_f32(v[(n0 + r) * E + e]) : 0.f;
    }
  };
  const int wr = warp * 4;  // tile rows of this warp
  const int wk = warp * 8;  // tile keys of this warp (column accumulators)

  // s tile for query rows r0 .. r0 + rows into S (rows past N score 0)
  auto score_tile = [&](int r0, int rows) {
    __syncthreads();  // the previous tile's readers of Qs and S are done
#pragma unroll
    for (int u = 0; u < kBlRT * kBlD / kBlThreads; ++u) {
      const int idx = tid + u * kBlThreads;
      const int r = idx / kBlD, c = idx % kBlD;
      Qs[idx] = r < rows ? to_f32(q[(r0 + r) * kBlD + c]) : 0.f;
    }
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kBlKT * kBlD / kBlThreads; ++u) {
        const int idx = tid + u * kBlThreads;
        const int r = idx / kBlD, c = idx % kBlD;
        KV[r * kLd + c] = k0 + r < N ? to_f32(k[(k0 + r) * kBlD + c]) : 0.f;
      }
      __syncthreads();
      float acc[4][2] = {};
#pragma unroll 8
      for (int c = 0; c < kBlD; ++c) {
        const float k_lo = KV[lane * kLd + c];
        const float k_hi = KV[(lane + 32) * kLd + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float qv = Qs[(wr + r) * kBlD + c];
          acc[r][0] = fmaf(qv, k_lo, acc[r][0]);
          acc[r][1] = fmaf(qv, k_hi, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (k0 + lane + 32 * s < N)
            S[(size_t)(wr + r) * N + k0 + lane + 32 * s] = acc[r][s] * scale2;
    }
    __syncthreads();
  };

  // VAD = T(va_tile . T(dF)) for the row tile r0
  auto vadf_tile = [&](int r0) {
    __syncthreads();
    load_v(va, r0, kBlRT);  // rows past N load as 0
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
        const float x = KV[(wr + r) * kLd + e];
#pragma unroll
        for (int t = 0; t < kGroups; ++t) acc[r][t] = fmaf(x, dv[t], acc[r][t]);
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
    load_v(vb, k0, kBlKT);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) dA[r][0] = dA[r][1] = 0.f;
    for (int f = 0; f < E; ++f) {
      const float v_lo = KV[lane * kLd + f];
      const float v_hi = KV[(lane + 32) * kLd + f];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = VAD[(wr + r) * E + f];
        dA[r][0] = fmaf(x, v_lo, dA[r][0]);
        dA[r][1] = fmaf(x, v_hi, dA[r][1]);
      }
    }
  };

  // ---- pass 0: T(dF), zeroed accumulators, T(vb . T(dF)^T) for all keys
  for (int idx = tid; idx < E * E; idx += kBlThreads)
    dfb[idx] = round_to<T>(a.dF[g * E * E + idx]);
  for (int idx = tid; idx < N * E; idx += kBlThreads) dvacc[idx] = 0.f;
  for (int idx = tid; idx < N * kBlD; idx += kBlThreads) dkacc[idx] = 0.f;
  for (int j = tid; j < N; j += kBlThreads) {
    mc[j] = -INFINITY;
    lc[j] = 0.f;
    colC[j] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kBlKT) {
    __syncthreads();
    load_v(vb, k0, kBlKT);
    __syncthreads();
    for (int idx = tid; idx < kBlKT * E; idx += kBlThreads) {
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

  // ---- pass 2: row terms, colsum(dC Cmat), dva rows and dvb
  for (int r0 = 0; r0 < N; r0 += kBlRT) {
    const int rows = min(kBlRT, N - r0);
    score_tile(r0, rows);  // ends with a barrier: mc / lc visible too
    for (int i = warp; i < rows; i += kBlThreads / 32) {
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
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
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
        red[warp * kBlKT + lane] = colp[0];
        red[warp * kBlKT + lane + 32] = colp[1];
        __syncthreads();
        if (tid < kBlKT && k0 + tid < N) {
          float t = 0.f;
          for (int w = 0; w < kBlThreads / 32; ++w) t += red[w * kBlKT + tid];
          colC[k0 + tid] += t;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float t = warp_sum(rowp[r]);
      if (lane == 0 && wr + r < rows) rowR[r0 + wr + r] = t;
    }
    // dva rows (Ab . T(vb dF^T)) and this tile's dvb (Ab^T . VAD)
    float dva[4][kGroups] = {};
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
      __syncthreads();
      for (int idx = tid; idx < kBlKT * E; idx += kBlThreads) {
        const int r = idx / E, e = idx % E;
        KV[r * kLd + e] = k0 + r < N ? vbdft[(size_t)(k0 + r) * E + e] : 0.f;
      }
      __syncthreads();
      const int kn = min(kBlKT, N - k0);
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
        const float* x = VAD + i * E;
        float av[kGroups];
#pragma unroll
        for (int t = 0; t < kGroups; ++t)
          av[t] = t < 2 || lane + 32 * t < E ? x[lane + 32 * t] : 0.f;
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
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
      if (i >= rows) continue;
#pragma unroll
      for (int t = 0; t < kGroups; ++t) {
        const int e = lane + 32 * t;
        if (e < E)
          a.dva[(g * N + r0 + i) * E + e] = from_f32<T>(dva[r][t]);
      }
    }
  }

  // ---- pass 3: ds, dq rows, dk
  for (int r0 = 0; r0 < N; r0 += kBlRT) {
    const int rows = min(kBlRT, N - r0);
    score_tile(r0, rows);
    vadf_tile(r0);
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
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
          *sp = round_to<T>(ds * dscale);  // T(ds scale) replaces s
        }
      }
    }
    float dq[4][2] = {};
    for (int k0 = 0; k0 < N; k0 += kBlKT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kBlKT * kBlD / kBlThreads; ++u) {
        const int idx = tid + u * kBlThreads;
        const int r = idx / kBlD, c = idx % kBlD;
        KV[r * kLd + c] = k0 + r < N ? to_f32(k[(k0 + r) * kBlD + c]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kBlKT, N - k0);
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
        const float q0 = Qs[i * kBlD + lane];
        const float q1 = Qs[i * kBlD + lane + 32];
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
        dkacc[(size_t)n * kBlD + lane] += acc[jj][0];
        dkacc[(size_t)n * kBlD + lane + 32] += acc[jj][1];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
      if (i >= rows) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        a.dq[(g * N + r0 + i) * kBlD + lane + 32 * s] = from_f32<T>(dq[r][s]);
    }
  }
  __syncthreads();

  // dk and dvb from their column accumulators
  for (int idx = tid; idx < N * kBlD; idx += kBlThreads)
    a.dk[g * N * kBlD + idx] = from_f32<T>(dkacc[idx]);
  for (int idx = tid; idx < N * E; idx += kBlThreads)
    a.dvb[g * N * E + idx] = from_f32<T>(dvacc[idx]);
}

template <typename T, int E, bool SINGLE>
static cudaError_t launch_bwd(const BlbArgs<T>& a, int G, float scale2,
                              float dscale, cudaStream_t st) {
  const size_t smem = blb_smem_bytes(a.N, E);
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_bwd_kernel<T, E, SINGLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bilinear_bwd_kernel<T, E, SINGLE>
      <<<G, kBlThreads, smem, st>>>(a, scale2, dscale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bilinear_bwd(const BlbArgs<T>& a, int G, int e,
                                int single, float scale2, float dscale,
                                cudaStream_t st) {
  if (e == kBlD + kBlPos)
    return single
               ? launch_bwd<T, kBlD + kBlPos, true>(a, G, scale2, dscale, st)
               : launch_bwd<T, kBlD + kBlPos, false>(a, G, scale2, dscale, st);
  if (e == kBlD)
    return single ? launch_bwd<T, kBlD, true>(a, G, scale2, dscale, st)
                  : launch_bwd<T, kBlD, false>(a, G, scale2, dscale, st);
  return cudaErrorInvalidValue;
}

}  // namespace rp

extern "C" long long rp_bilinear_bwd_workspace(int G, int N, int e) {
  return (long long)(sizeof(float) * (size_t)G *
                     rp::blb_scratch_floats(N, e));
}

// q, k (G, N, 64), va, vb (G, N, e) in T, dF (G, e, e) fp32; scale2 = the
// softmax scale times log2(e), dscale = the softmax scale -> dq, dk, dva,
// dvb in T, shaped as q, k, va, vb
extern "C" int rp_bilinear_bwd(const void* q, const void* k, const void* va,
                               const void* vb, const float* dF, void* dq,
                               void* dk, void* dva, void* dvb, void* ws,
                               int G, int N, int e, int single, float scale2,
                               float dscale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::bilinear_bwd<T>(
        {(const T*)q, (const T*)k, (const T*)va, (const T*)vb, dF, (T*)dq,
         (T*)dk, (T*)dva, (T*)dvb, (float*)ws, N},
        G, e, single, scale2, dscale, st);
  }
  return rp::bilinear_bwd<float>(
      {(const float*)q, (const float*)k, (const float*)va, (const float*)vb,
       dF, (float*)dq, (float*)dk, (float*)dva, (float*)dvb, (float*)ws, N},
      G, e, single, scale2, dscale, st);
}

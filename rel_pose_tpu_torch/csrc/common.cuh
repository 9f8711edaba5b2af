// Row LayerNorm and tiled GEMM kernels shared by vit_stack.cu and
// essential_block.cu, their backward counterparts (the dX and split-K dW
// GEMMs, the LayerNorm VJP, the fixed-order partial sums), plus the fp32 <->
// compute-dtype helpers.
//
// Compute dtype T is float or __nv_bfloat16.  Every product accumulates in
// fp32 (bf16 products are exact in fp32), every statistic is fp32, and each
// value is rounded to T exactly where the Pallas kernels round it.  Vector
// parameters (LayerNorm scale/bias, Linear biases) always arrive as fp32;
// the Python wrappers pre-round them where the Pallas path cast them to T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rp {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the fp32 value of v rounded to T
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------- LayerNorm --
// One warp per row of C values.  y = T(LN(x')) with x' = x, or with `pos`
// given, x' = T(x + pos[row % N]) (the ViT stack's block-0 positional add).
// x' is also written to `xsum` and `xcopy` where given (the residual stream,
// the training stash), and the row's fp32 (mean, 1/sigma) to `stats` for the
// backward.  Two-pass fp32 statistics, eps 1e-6.  Bound by memory: it reads
// and writes each row once (the three passes re-read it from L1).

constexpr int kLnThreads = 256;

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x,
                                 const T* __restrict__ pos,
                                 T* __restrict__ xsum,
                                 T* __restrict__ xcopy,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 T* __restrict__ y,
                                 float* __restrict__ stats, int M, int N,
                                 int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warps exit together
  const T* xr = x + (size_t)row * C;
  const T* pr = pos ? pos + (size_t)(row % N) * C : nullptr;
  auto load = [&](int c) {
    float v = to_f32(xr[c]);
    return pr ? round_to<T>(v + to_f32(pr[c])) : v;
  };
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += load(c);
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = load(c) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + 1e-6f);
  if (stats && lane == 0) {
    stats[2 * (size_t)row] = mean;
    stats[2 * (size_t)row + 1] = rstd;
  }
  T* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float v = load(c);
    yr[c] = from_f32<T>((v - mean) * rstd * scale[c] + bias[c]);
    if (xsum) xsum[(size_t)row * C + c] = from_f32<T>(v);
    if (xcopy) xcopy[(size_t)row * C + c] = from_f32<T>(v);
  }
}

template <typename T>
static cudaError_t launch_layernorm(const T* x, const T* pos, T* xsum,
                                    T* xcopy, const float* scale,
                                    const float* bias, T* y, float* stats,
                                    int M, int N, int C,
                                    cudaStream_t stream) {
  const int rows_per_block = kLnThreads / 32;
  layernorm_kernel<T><<<(M + rows_per_block - 1) / rows_per_block,
                        kLnThreads, 0, stream>>>(x, pos, xsum, xcopy, scale,
                                                 bias, y, stats, M, N, C);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ GEMM --
// out[M, Nout] = epilogue(A[M, K] . W[Nout, K]^T), W in torch Linear layout.
// SIMT fp32 FMA on 64x64 output tiles, 16-deep K steps through shared
// memory, 4x4 outputs per thread.  At the ViT widths (K = 192 or 768) the
// products are compute-bound; this first version leaves the tensor cores
// unused (a wgmma / TMA pipeline is later work).

enum Epilogue {
  kBias = 0,       // T(acc + b)                        (Pallas ViT bias)
  kBiasGelu = 1,   // T(gelu(T(acc + b)))                (fc1)
  kBiasResid = 2,  // T(resid + (acc + b))               (proj, fc2)
  kRounded = 3,    // T(T(acc) + T(b))                   (_linear_rounded)
  kBiasGeluSplit = 4,  // T(gelu(acc + b)), and acc + b in fp32 to aux
                       // (the backward's fc1 recompute)
};

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

template <typename T>
__device__ __forceinline__ float gelu_policy(float h) {
  // nn/layers.gelu policy: exact erf in fp32, tanh form in bf16
  if (sizeof(T) == 2) {
    const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
    return 0.5f * h * (1.f + tanhf(u));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// d gelu / dh of the fp32 pre-activation under the same policy
// (ops/kernel_gelu.py:55 of the JAX package)
template <typename T>
__device__ __forceinline__ float gelu_grad_policy(float h) {
  if (sizeof(T) == 2) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (h + 0.044715f * h * h * h));
    const float du = c * (1.f + 3.f * 0.044715f * h * h);
    return 0.5f * (1.f + t) + h * (0.5f * (1.f - t * t)) * du;
  }
  const float phi = expf(-0.5f * h * h) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(h * 0.7071067811865476f)) + h * phi;
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
            const float* __restrict__ bias, const T* resid, T* out,
            float* __restrict__ aux, int M, int Nout, int K) {
  // resid may alias out: each element is read then written by one thread
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // tile loader: thread -> (row lr, 4 consecutive k from lk)
  const int lr = tid / 4, lk = (tid % 4) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + lk + u;
      const int am = m0 + lr, wn = n0 + lr;
      As[lk + u][lr] = (am < M && k < K) ? to_f32(A[(size_t)am * K + k]) : 0.f;
      Ws[lk + u][lr] =
          (wn < Nout && k < K) ? to_f32(W[(size_t)wn * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Nout) continue;
      const size_t o = (size_t)m * Nout + n;
      float v;
      if (EPI == kBias) {
        v = acc[i][j] + bias[n];
      } else if (EPI == kBiasGelu) {
        v = gelu_policy<T>(round_to<T>(acc[i][j] + bias[n]));
      } else if (EPI == kBiasResid) {
        v = to_f32(resid[o]) + (acc[i][j] + bias[n]);
      } else if (EPI == kBiasGeluSplit) {
        aux[o] = acc[i][j] + bias[n];
        v = gelu_policy<T>(acc[i][j] + bias[n]);
      } else {
        v = round_to<T>(acc[i][j]) + round_to<T>(bias[n]);
      }
      out[o] = from_f32<T>(v);
    }
  }
}

template <typename T, int EPI>
static cudaError_t launch_gemm(const T* A, const T* W, const float* bias,
                               const T* resid, T* out, int M, int Nout, int K,
                               cudaStream_t stream, float* aux = nullptr) {
  dim3 grid((Nout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<T, EPI><<<grid, kGemmThreads, 0, stream>>>(
      A, W, bias, resid, out, aux, M, Nout, K);
  return cudaGetLastError();
}

// =========================================================== backward ====
// Operands of the backward products follow the Pallas kernels' rounding:
// a cotangent is kept in fp32 and rounded to T where it enters a product
// (round_to<T> on load), and every product accumulates in fp32.

// ---------------------------------------------------------------- dX GEMM --
// out[M, Kout] = epilogue(sum_n T(A[m, n]) * W[n, Kout]): the input
// cotangent of a Linear, A the fp32 output cotangent (M, Nred), W the torch
// Linear weight (Nred = out features, Kout = in features) in T.  Same 64x64
// SIMT tiles as gemm_kernel; the weight is read along its rows.

enum DxEpilogue {
  kDxPlain = 0,     // acc                                  (fp32)
  kDxGeluGrad = 1,  // acc * gelu'(aux)  (aux: fp32 pre-activation, may
                    // alias out: each element is read then written by one
                    // thread)
};

template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_dx_kernel(const float* __restrict__ A, const T* __restrict__ W,
               const float* aux, float* out, int M, int Kout, int Nred) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, k0 = blockIdx.x * kBN;
  const int lr = tid / 4, lk = (tid % 4) * 4;   // A loader: row, 4 n
  const int wr = tid / 16, wc = (tid % 16) * 4; // W loader: n, 4 columns
  float acc[4][4] = {};
  for (int n0 = 0; n0 < Nred; n0 += kBK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + lk + u, am = m0 + lr;
      As[lk + u][lr] =
          (am < M && n < Nred) ? round_to<T>(A[(size_t)am * Nred + n]) : 0.f;
      const int wn = n0 + wr, kk = k0 + wc + u;
      Ws[wr][wc + u] =
          (wn < Nred && kk < Kout) ? to_f32(W[(size_t)wn * Kout + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k >= Kout) continue;
      const size_t o = (size_t)m * Kout + k;
      out[o] = EPI == kDxGeluGrad ? acc[i][j] * gelu_grad_policy<T>(aux[o])
                                  : acc[i][j];
    }
  }
}

template <typename T, int EPI>
static cudaError_t launch_gemm_dx(const float* A, const T* W,
                                  const float* aux, float* out, int M,
                                  int Kout, int Nred, cudaStream_t stream) {
  dim3 grid((Kout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_dx_kernel<T, EPI><<<grid, kGemmThreads, 0, stream>>>(A, W, aux, out,
                                                             M, Kout, Nred);
  return cudaGetLastError();
}

// ------------------------------------------------- dW GEMM, split-K -----
// dW[Nout, K] = sum_m T(dY[m, n]) * X[m, k] and db[n] = sum_m dY[m, n]
// over all M = G * N rows, dY the fp32 output cotangent, X the layer input
// in T.  The Pallas kernel sums them sequentially over its grid; here the
// rows are cut into fixed chunks of kDwChunk: block (k tile, n tile, chunk)
// writes its fp32 partial, and sum_partials adds the chunks in order.  No
// atomics, so two runs give the same bits.  The bias partials are the
// column sums of the same dY tiles, taken by the blocks of k tile 0.

constexpr int kDwChunk = 2048;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_dw_kernel(const float* __restrict__ dY, const T* __restrict__ X,
               float* __restrict__ part, float* __restrict__ bias_part, int M,
               int Nout, int K) {
  __shared__ float As[kBK][kBM + 4];  // dY rows x n
  __shared__ float Bs[kBK][kBN + 4];  // X rows x k
  __shared__ float red[kBK][kBM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kBN, n0 = blockIdx.y * kBM;
  const int s = blockIdx.z;
  const int mbeg = s * kDwChunk, mend = min(M, mbeg + kDwChunk);
  const int lr = tid / 16, lc = (tid % 16) * 4;  // loader: row, 4 columns
  const bool do_bias = bias_part != nullptr && blockIdx.x == 0;
  float bsum[4] = {};
  float acc[4][4] = {};
  for (int m = mbeg; m < mend; m += kBK) {
    const int mm = m + lr;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + lc + u, k = k0 + lc + u;
      const float v = (mm < mend && n < Nout) ? dY[(size_t)mm * Nout + n] : 0.f;
      bsum[u] += v;
      As[lr][lc + u] = round_to<T>(v);
      Bs[lr][lc + u] = (mm < mend && k < K) ? to_f32(X[(size_t)mm * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBK; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* P = part + (size_t)s * Nout * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= Nout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) P[(size_t)n * K + k] = acc[i][j];
    }
  }
  if (do_bias) {  // uniform over the block
#pragma unroll
    for (int u = 0; u < 4; ++u) red[lr][lc + u] = bsum[u];
    __syncthreads();
    if (tid < kBM && n0 + tid < Nout) {
      float t = 0.f;
      for (int r = 0; r < kBK; ++r) t += red[r][tid];
      bias_part[(size_t)s * Nout + n0 + tid] = t;
    }
  }
}

// out[j] = sum over s = 0 .. S-1, in order, of part[s * stride + j]
static __global__ void sum_partials_kernel(const float* __restrict__ part, int S,
                                    size_t stride, size_t L,
                                    float* __restrict__ out) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += part[s * stride + j];
  out[j] = t;
}

static cudaError_t launch_sum_partials(const float* part, int S,
                                       size_t stride, size_t L, float* out,
                                       cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned)((L + 255) / 256), 256, 0, stream>>>(
      part, S, stride, L, out);
  return cudaGetLastError();
}

static int dw_chunks(int M) { return (M + kDwChunk - 1) / kDwChunk; }

// dW (Nout, K) and db (Nout) of a Linear; part / bias_part hold
// dw_chunks(M) partials
template <typename T>
static cudaError_t weight_grad(const float* dY, const T* X, float* dW,
                               float* db, float* part, float* bias_part,
                               int M, int Nout, int K, cudaStream_t stream) {
  const int S = dw_chunks(M);
  dim3 grid((K + kBN - 1) / kBN, (Nout + kBM - 1) / kBM, S);
  gemm_dw_kernel<T><<<grid, kGemmThreads, 0, stream>>>(dY, X, part,
                                                       bias_part, M, Nout, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(part, S, (size_t)Nout * K, (size_t)Nout * K, dW,
                            stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials(bias_part, S, Nout, Nout, db, stream);
}

// ---------------------------------------------------- LayerNorm backward --
// pallas_vit_bwd.py:62-71 per row (one warp per row, kLnbRows rows per
// block): xhat = (x - mean) / sigma from the forward's stats,
// dxhat = dy * scale, dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// / sigma, and out = resid + dx in fp32 (resid may alias out).  Each block
// also writes its partial column sums of dy * xhat (dscale) and dy (dbias)
// to part[block][2][C]; launch_sum_partials adds them in block order.

constexpr int kLnbRowsPerWarp = 16;
constexpr int kLnbRows = kLnbRowsPerWarp * (kLnThreads / 32);  // 128
constexpr int kLnbMaxC = 256;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layernorm_bwd_kernel(const float* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ stats,
                     const float* __restrict__ scale, const float* resid,
                     float* out, float* __restrict__ part, int M, int C) {
  __shared__ float red[kLnThreads / 32][2][kLnbMaxC];
  constexpr int kMaxT = kLnbMaxC / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = C / 32;
  float ps[kMaxT] = {}, pb[kMaxT] = {};
  const int row0 = blockIdx.x * kLnbRows + warp * kLnbRowsPerWarp;
  for (int r = 0; r < kLnbRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= M) break;  // warp-uniform
    const float mean = stats[2 * (size_t)row], rstd = stats[2 * (size_t)row + 1];
    float xh[kMaxT], dxh[kMaxT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t >= nt) break;
      const int c = lane + 32 * t;
      const size_t o = (size_t)row * C + c;
      const float xhat = (to_f32(x[o]) - mean) * rstd;
      const float d = dy[o];
      ps[t] += d * xhat;
      pb[t] += d;
      xh[t] = xhat;
      dxh[t] = d * scale[c];
      s1 += dxh[t];
      s2 += dxh[t] * xhat;
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t >= nt) break;
      const size_t o = (size_t)row * C + lane + 32 * t;
      out[o] = resid[o] + rstd * (dxh[t] - m1 - xh[t] * m2);
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t >= nt) break;
    red[warp][0][lane + 32 * t] = ps[t];
    red[warp][1][lane + 32 * t] = pb[t];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kLnThreads / 32; ++w) {
      a += red[w][0][c];
      b += red[w][1][c];
    }
    part[((size_t)blockIdx.x * 2) * C + c] = a;
    part[((size_t)blockIdx.x * 2 + 1) * C + c] = b;
  }
}

static int lnb_blocks(int M) { return (M + kLnbRows - 1) / kLnbRows; }

// dx (into out, plus resid) and dscale / dbias of one LayerNorm; part holds
// lnb_blocks(M) * 2 * C floats
template <typename T>
static cudaError_t layernorm_grad(const float* dy, const T* x,
                                  const float* stats, const float* scale,
                                  const float* resid, float* out,
                                  float* dscale, float* dbias, float* part,
                                  int M, int C, cudaStream_t stream) {
  if (C % 32 != 0 || C > kLnbMaxC) return cudaErrorInvalidValue;
  const int nb = lnb_blocks(M);
  layernorm_bwd_kernel<T><<<nb, kLnThreads, 0, stream>>>(
      dy, x, stats, scale, resid, out, part, M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(part, nb, 2 * (size_t)C, C, dscale, stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials(part + C, nb, 2 * (size_t)C, C, dbias, stream);
}

// ------------------------------------------------------------ dtype casts --
template <typename T>
__global__ void to_f32_kernel(const T* __restrict__ in,
                              float* __restrict__ out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = to_f32(in[i]);
}

template <typename T>
__global__ void from_f32_kernel(const float* __restrict__ in,
                                T* __restrict__ out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = from_f32<T>(in[i]);
}

}  // namespace rp

// Row LayerNorm and tiled GEMM kernels shared by vit_stack.cu and
// essential_block.cu, plus the fp32 <-> compute-dtype helpers.
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
// given, x' = T(x + pos[row % N]) (the ViT stack's block-0 positional add)
// which is also written to `xsum`, the residual stream.  Two-pass fp32
// statistics, eps 1e-6.  Bound by memory: it reads and writes each row once
// (the three passes re-read it from L1).

constexpr int kLnThreads = 256;

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x,
                                 const T* __restrict__ pos,
                                 T* __restrict__ xsum,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 T* __restrict__ y, int M, int N, int C) {
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
  T* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float v = load(c);
    yr[c] = from_f32<T>((v - mean) * rstd * scale[c] + bias[c]);
    if (pr) xsum[(size_t)row * C + c] = from_f32<T>(v);
  }
}

template <typename T>
static cudaError_t launch_layernorm(const T* x, const T* pos, T* xsum,
                                    const float* scale, const float* bias,
                                    T* y, int M, int N, int C,
                                    cudaStream_t stream) {
  const int rows_per_block = kLnThreads / 32;
  layernorm_kernel<T><<<(M + rows_per_block - 1) / rows_per_block,
                        kLnThreads, 0, stream>>>(x, pos, xsum, scale, bias,
                                                 y, M, N, C);
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

template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
            const float* __restrict__ bias, const T* resid, T* out, int M,
            int Nout, int K) {
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
                               cudaStream_t stream) {
  dim3 grid((Nout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<T, EPI><<<grid, kGemmThreads, 0, stream>>>(A, W, bias, resid,
                                                          out, M, Nout, K);
  return cudaGetLastError();
}

}  // namespace rp

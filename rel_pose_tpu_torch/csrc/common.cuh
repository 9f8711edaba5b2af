// Row LayerNorm and its VJP, the epilogues of the tensor-core GEMMs
// (gemm_wgmma.cuh, gemm_wgmma_f32.cuh), the fixed-order partial sums, and the
// fp32 <-> compute-dtype helpers.
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

constexpr int kHeadDim = 64;  // the model's head width (192 / 3 heads)

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
// The epilogues of the forward GEMMs (gemm_wgmma.cuh for the bf16 ViT
// stack and the essential block's qkv Linear, gemm_wgmma_f32.cuh in fp32),
// out[M, Nout] = epilogue(A[M, K] . W[Nout, K]^T) with W in torch Linear
// layout.

enum Epilogue {
  kBias = 0,       // T(acc + b)                        (Pallas ViT bias)
  kBiasGelu = 1,   // T(gelu(T(acc + b)))                (fc1)
  kBiasResid = 2,  // T(resid + (acc + b))               (proj, fc2)
  kRounded = 3,    // T(T(acc) + T(b))                   (_linear_rounded)
  kBiasGeluSplit = 4,  // T(gelu(acc + b)), and acc + b in fp32 to aux
                       // (the backward's fc1 recompute)
};

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

// =========================================================== backward ====
// The dX GEMMs' epilogues (gemm_wgmma.cuh in bf16, gemm_wgmma_f32.cuh's
// gemm_dx_kernel in fp32): the input cotangent of a Linear, fp32.
enum DxEpilogue {
  kDxPlain = 0,     // acc                                  (fp32)
  kDxGeluGrad = 1,  // acc * gelu'(aux)  (aux: fp32 pre-activation, may
                    // alias out: each element is read then written by one
                    // thread)
};

// rows per split-K chunk of both dW GEMMs: short chunks keep more SMs busy
// at the training shapes (M / 1,024 partials of Nout x K fp32; shorter
// chunks than that were slower on an H100, bf16, mma.sync)
constexpr int kDwChunk = 1024;

static int dw_chunks(int M) { return (M + kDwChunk - 1) / kDwChunk; }

// out[j] = sum over s = 0 .. S-1, in order, of part[s * stride + j]: the
// split-K dW partials and the LayerNorm VJP's column partials, summed in a
// fixed order (no atomics: two runs give the same bits)
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

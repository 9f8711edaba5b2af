// The microbenchmark variants of the essential block's moments kernel:
// Pallas kernel #9.
//
// Replaces: scripts/bench_cross.py:_s_kernel (rp_essential_block_s) and
// :_variant_kernel (rp_essential_block_variant), which time restructured
// copies of #4 (pallas_essential_block.py:_essential_block_kernel) on the
// flagship's shapes: precomputed qkv1, qkv2 (B, N, 3C) of 3 heads of 64,
// the (B, N, 6) positional table appended to v (e = 70), va = vb, F (B, 2,
// heads, 70, 70) fp32.  Direction 0 takes q from image 2 and k, v from
// image 1.
//   * _s_kernel: #4's dual-softmax math, S pairs per grid step.  bf16 runs
//     #4's tensor-core moments (essential_tc.cuh, PairLayout) with grid
//     (64-query tile, G / S): one block walks the same query tile of one
//     (direction, head) of S consecutive pairs, slice after slice, each
//     with #4's arithmetic, so F has #4's bf16 bits.  fp32 runs
//     bilinear.cuh's SIMT body, one block per (head, direction, S pairs),
//     the same arithmetic per slice as #4's fp32 kernel;
//   * _variant_kernel, bf16 only: the tensor-core moments in the modes
//     kEbMxuSums (the row and column sums of T(exp2(s - max)) on the tensor
//     cores against a ones operand: the TPU's "sums on the matrix unit to
//     free the vector unit") and kEbBf16Mul (the P product as one bf16
//     multiply).
// bf16 needs the scratch rp_cross_variants_workspace sizes.  What bounds
// them on the H100 is #4's (essential_tc.cuh); mxu_sums walks the scores
// once more for its exact column maxima.

#include "bilinear.cuh"
#include "essential_tc.cuh"

namespace rp {

constexpr int kCvE = kBlD + kBlPos;  // e = 70: v ++ the positional table

// (direction, head) of one pair in #4's layout: two images' (N, 3C) rows
template <typename T>
struct PairRows {
  const T* qimg;
  const T* kimg;
  const T* pos;  // (N, 6) of the pair
  size_t C3;
  int qoff, koff, voff;
  __device__ float qv(int n, int c) const {
    return to_f32(qimg[n * C3 + qoff + c]);
  }
  __device__ float kv(int n, int c) const {
    return to_f32(kimg[n * C3 + koff + c]);
  }
  __device__ float vbv(int n, int e) const {
    return e < kBlD ? to_f32(kimg[n * C3 + voff + e])
                    : to_f32(pos[n * kBlPos + e - kBlD]);
  }
  __device__ float vav(int n, int e) const { return vbv(n, e); }
};

template <typename T>
struct CvArgs {
  const T* qkv1;  // (B, N, 3C)
  const T* qkv2;
  const T* pos;   // (B, N, 6)
  float* F;       // (B, 2, heads, 70, 70)
  int N, C, S;    // S pairs per block
};

template <typename T>
__global__ void __launch_bounds__(kBlThreads)
pair_moments_kernel(CvArgs<T> a, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, dir = blockIdx.y, heads = gridDim.x;
  const size_t C3 = 3 * (size_t)a.C, img = (size_t)a.N * C3;
  for (int s = 0; s < a.S; ++s) {
    const size_t b = (size_t)blockIdx.z * a.S + s;
    __syncthreads();  // the previous pair's readers of shared memory are done
    const T* i1 = a.qkv1 + b * img;
    const T* i2 = a.qkv2 + b * img;
    const PairRows<T> rows{dir == 0 ? i2 : i1, dir == 0 ? i1 : i2,
                           a.pos + b * a.N * kBlPos, C3, h * kBlD,
                           a.C + h * kBlD, 2 * a.C + h * kBlD};
    float* F = a.F + ((b * 2 + dir) * heads + h) * kCvE * kCvE;
    bilinear_moments<T, kCvE, false>(rows, a.N, scale, smem, F);
  }
}

// fp32 _s_kernel, the SIMT body
static cudaError_t launch_pair_moments(const CvArgs<float>& a, int B,
                                       int heads, cudaStream_t st) {
  const size_t smem = bilinear_smem_bytes(a.N, kCvE);
  cudaError_t err = cudaFuncSetAttribute(
      pair_moments_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  pair_moments_kernel<float>
      <<<dim3(heads, 2, B / a.S), kBlThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

// bf16: #4's tensor-core moments in MODE, S pairs per block with kGroup
template <int MODE, bool kGroup>
static cudaError_t launch_pair_moments_tc(const void* qkv1, const void* qkv2,
                                          const void* pos, float* F,
                                          void* ws, int B, int N, int C,
                                          int heads, int S,
                                          cudaStream_t st) {
  using T = __nv_bfloat16;
  const tc::EbFwdArgs a{(const T*)qkv1, (const T*)qkv2, (const T*)pos,
                        nullptr, (size_t)N * 3 * C, F, ws, 2 * B * heads, N,
                        C, heads, S, tc::kEbScale};
  return tc::launch_moments<tc::PairLayout, kCvE, MODE, false, kGroup>(a,
                                                                       st);
}

}  // namespace rp

// bytes of scratch rp_essential_block_s and rp_essential_block_variant need
// (bf16: the tensor-core moments' statistics, vb_n and F partials; fp32
// none)
extern "C" long long rp_cross_variants_workspace(int B, int N, int heads,
                                                 int bf16) {
  if (!bf16) return 0;
  return (long long)rp::tc::EbFwdWs(nullptr, 2 * B * heads, N, rp::kCvE)
      .bytes;
}

// qkv1, qkv2 (B, N, 3C) and pos (B, N, 6) in T; ws the workspace (bf16) ->
// F (B, 2, heads, 70, 70) fp32, S pairs per block (B % S == 0)
extern "C" int rp_essential_block_s(const void* qkv1, const void* qkv2,
                                    const void* pos, float* F, void* ws,
                                    int B, int N, int C, int heads, int S,
                                    int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || B % S != 0 || C != heads * rp::kBlD || pos == nullptr)
    return cudaErrorInvalidValue;
  if (bf16)
    return rp::launch_pair_moments_tc<rp::tc::kEbDual, true>(
        qkv1, qkv2, pos, F, ws, B, N, C, heads, S, st);
  return rp::launch_pair_moments(
      {(const float*)qkv1, (const float*)qkv2, (const float*)pos, F, N, C, S},
      B, heads, st);
}

// bf16 qkv1, qkv2 (B, N, 3C) and pos (B, N, 6); ws the workspace -> F (B,
// 2, heads, 70, 70) fp32; mode 0 = mxu_sums, 1 = bf16_mul
extern "C" int rp_essential_block_variant(const void* qkv1, const void* qkv2,
                                          const void* pos, float* F,
                                          void* ws, int B, int N, int C,
                                          int heads, int mode,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != heads * rp::kBlD || pos == nullptr) return cudaErrorInvalidValue;
  if (mode == 0)
    return rp::launch_pair_moments_tc<rp::tc::kEbMxuSums, false>(
        qkv1, qkv2, pos, F, ws, B, N, C, heads, 1, st);
  if (mode == 1)
    return rp::launch_pair_moments_tc<rp::tc::kEbBf16Mul, false>(
        qkv1, qkv2, pos, F, ws, B, N, C, heads, 1, st);
  return cudaErrorInvalidValue;
}

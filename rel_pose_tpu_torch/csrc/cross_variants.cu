// The microbenchmark variants of the essential block's moments kernel:
// Pallas kernel #9.
//
// Replaces: scripts/bench_cross.py:_s_kernel (rp_essential_block_s) and
// :_variant_kernel (rp_essential_block_variant), which time restructured
// copies of #4 (pallas_essential_block.py:_essential_block_kernel) on the
// flagship's shapes: precomputed qkv1, qkv2 (B, N, 3C) of 3 heads of 64,
// the (B, N, 6) positional table appended to v (e = 70), va = vb, F (B, 2,
// heads, 70, 70) fp32.  Direction 0 takes q from image 2 and k, v from
// image 1.  Both run bilinear.cuh's body on #4's pair layout (PairRows):
//   * _s_kernel: #4's dual-softmax math, S pairs per grid step.  Here each
//     CUDA block owns one (direction, head) of S consecutive pairs, grid
//     (heads, 2, B / S), and runs the body once per pair: the same
//     arithmetic per slice as #4, so the same bits;
//   * _variant_kernel, bf16 only: mode mxu_sums forms the row and column
//     sums of bf16(exp2(s - max)) on the tensor cores (mma.sync against a
//     ones operand; the TPU's "sums on the matrix unit to free the vector
//     unit"), mode bf16_mul the P product as a bf16 __hmul.  Grid (heads,
//     2, B).
// What bounds them on the H100: #4's -- the N x N x 64 score products
// (formed twice, three times with mxu_sums) and P . vb as SIMT fp32 FMAs,
// one 123 KB block per SM.

#include "bilinear.cuh"

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

template <typename T, int MODE>
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
    bilinear_moments<T, kCvE, MODE>(rows, a.N, scale, smem, F);
  }
}

template <typename T, int MODE>
static cudaError_t launch_pair_moments(const CvArgs<T>& a, int B, int heads,
                                       cudaStream_t st) {
  if (a.S < 1 || B % a.S != 0 || a.C != heads * kBlD)
    return cudaErrorInvalidValue;
  const size_t smem = bilinear_smem_bytes(a.N, kCvE);
  cudaError_t err = cudaFuncSetAttribute(
      pair_moments_kernel<T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  pair_moments_kernel<T, MODE>
      <<<dim3(heads, 2, B / a.S), kBlThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

}  // namespace rp

// qkv1, qkv2 (B, N, 3C) and pos (B, N, 6) in T -> F (B, 2, heads, 70, 70)
// fp32, S pairs per block (B % S == 0)
extern "C" int rp_essential_block_s(const void* qkv1, const void* qkv2,
                                    const void* pos, float* F, int B, int N,
                                    int C, int heads, int S, int bf16,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::launch_pair_moments<T, rp::kBlDual>(
        {(const T*)qkv1, (const T*)qkv2, (const T*)pos, F, N, C, S}, B,
        heads, st);
  }
  return rp::launch_pair_moments<float, rp::kBlDual>(
      {(const float*)qkv1, (const float*)qkv2, (const float*)pos, F, N, C, S},
      B, heads, st);
}

// bf16 qkv1, qkv2 (B, N, 3C) and pos (B, N, 6) -> F (B, 2, heads, 70, 70)
// fp32; mode 0 = mxu_sums, 1 = bf16_mul
extern "C" int rp_essential_block_variant(const void* qkv1, const void* qkv2,
                                          const void* pos, float* F, int B,
                                          int N, int C, int heads, int mode,
                                          void* stream) {
  using T = __nv_bfloat16;
  const rp::CvArgs<T> a{(const T*)qkv1, (const T*)qkv2, (const T*)pos, F,
                        N, C, 1};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0)
    return rp::launch_pair_moments<T, rp::kBlMxuSums>(a, B, heads, st);
  if (mode == 1)
    return rp::launch_pair_moments<T, rp::kBlBf16Mul>(a, B, heads, st);
  return cudaErrorInvalidValue;
}

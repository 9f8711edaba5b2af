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
//   * _s_kernel: #4's dual-softmax math, S pairs per grid step: #4's
//     tensor-core moments (essential_tc.cuh, PairLayout; bf16 m16n8k16,
//     fp32 3xTF32) with grid (64-query tile, G / S): one block walks the
//     same query tile of one (direction, head) of S consecutive pairs,
//     slice after slice, each with #4's arithmetic, so F has #4's bits in
//     either dtype;
//   * _variant_kernel, bf16 only: the tensor-core moments in the modes
//     kEbMxuSums (the row and column sums of T(exp2(s - max)) on the tensor
//     cores against a ones operand: the TPU's "sums on the matrix unit to
//     free the vector unit") and kEbBf16Mul (the P product as one bf16
//     multiply).
// Both need the scratch rp_cross_variants_workspace sizes.  What bounds
// them on the H100 is #4's (essential_tc.cuh); mxu_sums walks the scores
// once more for its exact column maxima.

#include "essential_tc.cuh"

namespace rp {

// e = 70: v ++ the positional table
constexpr int kCvE = kHeadDim + tc::kEbPos;

// #4's tensor-core moments in MODE and T, S pairs per block with kGroup
template <int MODE, bool kGroup, typename T>
static cudaError_t launch_pair_moments_tc(const void* qkv1, const void* qkv2,
                                          const void* pos, float* F,
                                          void* ws, int B, int N, int C,
                                          int heads, int S,
                                          cudaStream_t st) {
  const tc::EbFwdArgsT<T> a{(const T*)qkv1, (const T*)qkv2, (const T*)pos,
                            nullptr, (size_t)N * 3 * C, F, ws,
                            2 * B * heads, N, C, heads, S, tc::kEbScale};
  return tc::launch_moments<tc::PairLayout, kCvE, MODE, false, kGroup>(a,
                                                                       st);
}

}  // namespace rp

// bytes of scratch rp_essential_block_s and rp_essential_block_variant need:
// the tensor-core moments' statistics, vb_n and F partials
extern "C" long long rp_cross_variants_workspace(int B, int N, int heads,
                                                 int bf16) {
  return (long long)rp::tc::EbFwdWs(nullptr, 2 * B * heads, N, rp::kCvE,
                                    bf16 ? 2 : 4)
      .bytes;
}

// qkv1, qkv2 (B, N, 3C) and pos (B, N, 6) in T; ws the workspace -> F (B,
// 2, heads, 70, 70) fp32, S pairs per block (B % S == 0)
extern "C" int rp_essential_block_s(const void* qkv1, const void* qkv2,
                                    const void* pos, float* F, void* ws,
                                    int B, int N, int C, int heads, int S,
                                    int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || B % S != 0 || C != heads * rp::kHeadDim || pos == nullptr)
    return cudaErrorInvalidValue;
  if (bf16)
    return rp::launch_pair_moments_tc<rp::tc::kEbDual, true, __nv_bfloat16>(
        qkv1, qkv2, pos, F, ws, B, N, C, heads, S, st);
  return rp::launch_pair_moments_tc<rp::tc::kEbDual, true, float>(
      qkv1, qkv2, pos, F, ws, B, N, C, heads, S, st);
}

// bf16 qkv1, qkv2 (B, N, 3C) and pos (B, N, 6); ws the workspace -> F (B,
// 2, heads, 70, 70) fp32; mode 0 = mxu_sums, 1 = bf16_mul
extern "C" int rp_essential_block_variant(const void* qkv1, const void* qkv2,
                                          const void* pos, float* F,
                                          void* ws, int B, int N, int C,
                                          int heads, int mode,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != heads * rp::kHeadDim || pos == nullptr)
    return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  if (mode == 0)
    return rp::launch_pair_moments_tc<rp::tc::kEbMxuSums, false, T>(
        qkv1, qkv2, pos, F, ws, B, N, C, heads, 1, st);
  if (mode == 1)
    return rp::launch_pair_moments_tc<rp::tc::kEbBf16Mul, false, T>(
        qkv1, qkv2, pos, F, ws, B, N, C, heads, 1, st);
  return cudaErrorInvalidValue;
}

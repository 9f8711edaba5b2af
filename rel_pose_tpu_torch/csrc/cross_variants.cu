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
//   * _s_kernel: #4's dual-softmax math, S pairs per grid step: #4's wgmma
//     moments (bf16 essential_wgmma.cuh, fp32 3xTF32
//     essential_wgmma_f32.cuh), the moments kernel's grid (64-query tile,
//     G / S): one block walks the same query tile of one (direction,
//     head) of S consecutive pairs, slice after slice, each with #4's
//     arithmetic (the statistics and vb_n run over the G slices as #4's
//     do), so F has #4's bits in either dtype;
//   * _variant_kernel, bf16 only: the mma.sync moments of essential_tc.cuh
//     (PairLayout) in the modes kEbMxuSums (the row and column sums of
//     T(exp2(s - max)) on the tensor cores against a ones operand: the
//     TPU's "sums on the matrix unit to free the vector unit") and
//     kEbBf16Mul (the P product as one bf16 multiply).
// Both need the scratch rp_cross_variants_workspace sizes.  What bounds
// them on the H100 is #4's (essential_wgmma.cuh, essential_tc.cuh);
// mxu_sums walks the scores once more for its exact column maxima.

#include "essential_wgmma.cuh"

namespace rp {

// e = 70: v ++ the positional table
constexpr int kCvE = kHeadDim + tc::kEbPos;

namespace tc {
namespace wg {
extern template cudaError_t launch_moments_wb<kCvE, false, false, true>(
    const EbTcArgs<bf16>&, cudaStream_t, int);
extern template cudaError_t launch_moments_wg<kCvE, false, false, true>(
    const EbTcArgs<float>&, cudaStream_t, int);
}  // namespace wg
}  // namespace tc

// #4's wgmma moments in T, S pairs per block
template <typename T>
static cudaError_t launch_s(const void* qkv1, const void* qkv2,
                            const void* pos, float* F, void* ws, int B,
                            int N, int C, int heads, int S,
                            cudaStream_t st) {
  const tc::EbTcArgs<T> a{(const T*)qkv1, (const T*)qkv2, (size_t)N * 3 * C,
                          (const T*)pos, F, ws, B, N, C, heads};
  if constexpr (sizeof(T) == 2)
    return tc::wg::launch_moments_wb<kCvE, false, false, true>(a, st, S);
  else
    return tc::wg::launch_moments_wg<kCvE, false, false, true>(a, st, S);
}

// the mma.sync moments in MODE (bf16)
template <int MODE>
static cudaError_t launch_variant(const void* qkv1, const void* qkv2,
                                  const void* pos, float* F, void* ws, int B,
                                  int N, int C, int heads, cudaStream_t st) {
  using T = tc::bf16;
  const tc::EbFwdArgsT<T> a{(const T*)qkv1, (const T*)qkv2, (const T*)pos,
                            nullptr, (size_t)N * 3 * C, F, ws,
                            2 * B * heads, N, C, heads, tc::kEbScale};
  return tc::launch_moments<tc::PairLayout, kCvE, MODE, false>(a, st);
}

}  // namespace rp

// bytes of scratch rp_essential_block_s and rp_essential_block_variant need:
// the larger of the two bodies' statistics, vb_n and F partials (bf16 s
// also the row maxima's partials)
extern "C" long long rp_cross_variants_workspace(int B, int N, int heads,
                                                 int bf16) {
  const int G = 2 * B * heads;
  const size_t tc =
      rp::tc::EbFwdWs(nullptr, G, N, rp::kCvE, bf16 ? 2 : 4).bytes;
  const size_t wb = bf16 ? rp::tc::wg::EwbFwdWs(nullptr, G, N, rp::kCvE).bytes
                         : 0;
  return (long long)(tc > wb ? tc : wb);
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
    return rp::launch_s<__nv_bfloat16>(qkv1, qkv2, pos, F, ws, B, N, C,
                                       heads, S, st);
  return rp::launch_s<float>(qkv1, qkv2, pos, F, ws, B, N, C, heads, S, st);
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
  if (mode == 0)
    return rp::launch_variant<rp::tc::kEbMxuSums>(qkv1, qkv2, pos, F, ws, B,
                                                  N, C, heads, st);
  if (mode == 1)
    return rp::launch_variant<rp::tc::kEbBf16Mul>(qkv1, qkv2, pos, F, ws, B,
                                                  N, C, heads, st);
  return cudaErrorInvalidValue;
}

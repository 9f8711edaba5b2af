// Entry points of the Essential Matrix Module's forward: the Pallas kernels
// #2, #3 and #4 of rel_pose_tpu/ops/pallas_essential_block.py, each the
// moments kernel of essential_block.cuh behind its own prologue.
//
//   rp_essential_block_pair (#2 _essential_block_pair_kernel): raw pair
//     tokens xpair (B, 2, N, C) -> norm1 LayerNorm -> the shared qkv Linear
//     with _linear_rounded rounding over the (2B * N, C) tokens -> moments;
//   rp_essential_block_x (#3 _essential_block_x_kernel): pre-normed x1, x2
//     (B, N, C) -> the qkv Linear on each image -> moments (no LayerNorm);
//   rp_essential_block (#4 _essential_block_kernel): precomputed qkv1, qkv2
//     (B, N, 3C) -> moments.
// The LayerNorm and the GEMM are those of common.cuh.  Each entry point
// takes the flags of _eb_combos (has_pos, single, cross) and picks the
// kernel variant; the e = 70 variants are instantiated here, the e = 64
// ones in essential_block_e64.cu, so that nvcc builds the two halves in
// parallel.

#include "essential_block.cuh"

namespace rp {

RP_EB_VARIANTS(RP_EB_FWD_EXTERN, kEbHeadDim)

template <typename T, int E>
static cudaError_t moments_e(const EbArgs<T>& a, bool single, bool cross,
                             cudaStream_t st) {
  if (single)
    return cross ? launch_dual_softmax<T, E, true, true>(a, st)
                 : launch_dual_softmax<T, E, true, false>(a, st);
  return cross ? launch_dual_softmax<T, E, false, true>(a, st)
               : launch_dual_softmax<T, E, false, false>(a, st);
}

template <typename T>
static cudaError_t moments(const EbArgs<T>& a, int has_pos, int single,
                           int cross, cudaStream_t st) {
  if (a.C != a.heads * kEbHeadDim || (has_pos && a.pos == nullptr))
    return cudaErrorInvalidValue;
  return has_pos ? moments_e<T, kEbHeadDim + kPosCols>(a, single, cross, st)
                 : moments_e<T, kEbHeadDim>(a, single, cross, st);
}

template <typename T>
static cudaError_t essential_block_pair(const T* xpair, const float* lns,
                                        const float* lnb, const T* w,
                                        const float* bias, const T* pos,
                                        float* F, T* y, T* qkv, int B, int N,
                                        int C, int heads, int has_pos,
                                        int single, int cross,
                                        cudaStream_t st) {
  const int M = 2 * B * N;
  cudaError_t err = launch_layernorm<T>(xpair, nullptr, nullptr, nullptr,
                                        lns, lnb, y, nullptr, M, N, C, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, kRounded>(y, w, bias, nullptr, qkv, M, 3 * C, C, st);
  if (err != cudaSuccess) return err;
  // the qkv rows are interleaved as the tokens: (B, 2, N, 3C)
  const size_t img = (size_t)N * 3 * C;
  return moments<T>({qkv, qkv + img, 2 * img, pos, F, B, N, C, heads},
                    has_pos, single, cross, st);
}

template <typename T>
static cudaError_t essential_block_x(const T* x1, const T* x2, const T* w,
                                     const float* bias, const T* pos,
                                     float* F, T* qkv, int B, int N, int C,
                                     int heads, int has_pos, int single,
                                     int cross, cudaStream_t st) {
  // qkv scratch (2, B, N, 3C): image 1's rows, then image 2's
  const int M = B * N;
  const size_t half = (size_t)M * 3 * C;
  cudaError_t err =
      launch_gemm<T, kRounded>(x1, w, bias, nullptr, qkv, M, 3 * C, C, st);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, kRounded>(x2, w, bias, nullptr, qkv + half, M, 3 * C,
                                 C, st);
  if (err != cudaSuccess) return err;
  return moments<T>({qkv, qkv + half, (size_t)N * 3 * C, pos, F, B, N, C,
                     heads},
                    has_pos, single, cross, st);
}

}  // namespace rp

// xpair (B, 2, N, C), w (3C, C) and pos (B, N, 6) in T (pos NULL without
// positions); LN scale / bias and the qkv bias fp32; y (2BN, C) and qkv
// (2BN, 3C) scratch in T -> F (B, 2, heads, e, e) fp32
extern "C" int rp_essential_block_pair(
    const void* xpair, const float* lns, const float* lnb, const void* w,
    const float* bias, const void* pos, float* F, void* y, void* qkv, int B,
    int N, int C, int heads, int has_pos, int single, int cross, int bf16,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::essential_block_pair<T>(
        (const T*)xpair, lns, lnb, (const T*)w, bias, (const T*)pos, F,
        (T*)y, (T*)qkv, B, N, C, heads, has_pos, single, cross, st);
  }
  return rp::essential_block_pair<float>(
      (const float*)xpair, lns, lnb, (const float*)w, bias,
      (const float*)pos, F, (float*)y, (float*)qkv, B, N, C, heads, has_pos,
      single, cross, st);
}

// x1, x2 (B, N, C), w (3C, C), pos (B, N, 6) or NULL in T; qkv bias fp32;
// qkv (2, B, N, 3C) scratch in T -> F (B, 2, heads, e, e) fp32
extern "C" int rp_essential_block_x(const void* x1, const void* x2,
                                    const void* w, const float* bias,
                                    const void* pos, float* F, void* qkv,
                                    int B, int N, int C, int heads,
                                    int has_pos, int single, int cross,
                                    int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::essential_block_x<T>((const T*)x1, (const T*)x2, (const T*)w,
                                    bias, (const T*)pos, F, (T*)qkv, B, N, C,
                                    heads, has_pos, single, cross, st);
  }
  return rp::essential_block_x<float>(
      (const float*)x1, (const float*)x2, (const float*)w, bias,
      (const float*)pos, F, (float*)qkv, B, N, C, heads, has_pos, single,
      cross, st);
}

// qkv1, qkv2 (B, N, 3C) and pos (B, N, 6) or NULL in T -> F (B, 2, heads,
// e, e) fp32
extern "C" int rp_essential_block(const void* qkv1, const void* qkv2,
                                  const void* pos, float* F, int B, int N,
                                  int C, int heads, int has_pos, int single,
                                  int cross, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bstride = (size_t)N * 3 * C;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::moments<T>({(const T*)qkv1, (const T*)qkv2, bstride,
                           (const T*)pos, F, B, N, C, heads},
                          has_pos, single, cross, st);
  }
  return rp::moments<float>({(const float*)qkv1, (const float*)qkv2, bstride,
                             (const float*)pos, F, B, N, C, heads},
                            has_pos, single, cross, st);
}

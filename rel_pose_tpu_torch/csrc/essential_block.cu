// Entry points of the Essential Matrix Module's forward: the Pallas kernels
// #2, #3 and #4 of rel_pose_tpu/ops/pallas_essential_block.py, each the
// moments kernel behind its own prologue.
//
//   rp_essential_block_pair (#2 _essential_block_pair_kernel): raw pair
//     tokens xpair (B, 2, N, C) -> norm1 LayerNorm -> the shared qkv Linear
//     with _linear_rounded rounding over the (2B * N, C) tokens -> moments;
//   rp_essential_block_x (#3 _essential_block_x_kernel): pre-normed x1, x2
//     (B, N, C) -> the qkv Linear on each image -> moments (no LayerNorm);
//   rp_essential_block (#4 _essential_block_kernel): precomputed qkv1, qkv2
//     (B, N, 3C) -> moments.
// Which body each dtype takes:
//   bf16: the qkv Linear on wgmma (gemm_wgmma.cuh's forward, epilogue
//     kRounded: T(T(acc) + T(b))) and the wgmma moments of
//     essential_wgmma.cuh (m64nNk16, TMA-fed tiles), instantiated in
//     essential_wgmma.cu (e = 70) and essential_wgmma_e64.cu (e = 64);
//   fp32: the qkv Linear on TF32 wgmma (gemm_wgmma_f32.cuh's forward with
//     epilogue kBias, acc + b: in fp32 kRounded's roundings are the
//     identity), its weight split once a call into hi / lo scratch, and the
//     TF32 wgmma moments of essential_wgmma_f32.cuh, instantiated in
//     essential_wgmma_f32.cu (e = 70) and essential_wgmma_f32_e64.cu (e =
//     64); both 3xTF32.
// The scratch is what rp_essential_block_workspace sizes (bf16
// essential_wgmma.cuh's EwbFwdWs; fp32 EbFwdWs, then the weight's split).  The LayerNorm is
// common.cuh's.  Each entry point takes the flags of _eb_combos (has_pos,
// single, cross) and picks the kernel variant.

#include "essential_wgmma.cuh"

namespace rp {

namespace tc {
namespace wg {
RP_EW_VARIANTS(RP_EWB_FWD_EXTERN, kHeadDim + kEbPos)
RP_EW_VARIANTS(RP_EWB_FWD_EXTERN, kHeadDim)
RP_EW_VARIANTS(RP_EW_FWD_EXTERN, kHeadDim + kEbPos)
RP_EW_VARIANTS(RP_EW_FWD_EXTERN, kHeadDim)
// gemm_wgmma.cu
cudaError_t essential_qkv_bf16(const bf16* x, const bf16* w,
                               const float* bias, bf16* out, int M, int N,
                               int K, cudaStream_t st);
// gemm_wgmma_f32.cu
cudaError_t vit_split_weight_f32(const float* W, float* Ws, int count, int R,
                                 int C, bool transpose, cudaStream_t st);
cudaError_t vit_gemm_f32(int epi, const float* A, const float* Ws,
                         const float* bias, const float* resid, float* out,
                         float* aux, int M, int N, int K, cudaStream_t st);
}  // namespace wg
}  // namespace tc

template <typename T, int E>
static cudaError_t moments_e(const tc::EbTcArgs<T>& a, bool single,
                             bool cross, cudaStream_t st) {
  namespace wg = tc::wg;
  if constexpr (sizeof(T) == 4) {
    if (single)
      return cross ? wg::launch_moments_wg<E, true, true>(a, st)
                   : wg::launch_moments_wg<E, true, false>(a, st);
    return cross ? wg::launch_moments_wg<E, false, true>(a, st)
                 : wg::launch_moments_wg<E, false, false>(a, st);
  } else {
    if (single)
      return cross ? wg::launch_moments_wb<E, true, true>(a, st)
                   : wg::launch_moments_wb<E, true, false>(a, st);
    return cross ? wg::launch_moments_wb<E, false, true>(a, st)
                 : wg::launch_moments_wb<E, false, false>(a, st);
  }
}

// The moments of both images' (N, 3C) qkv rows at img1 / img2 + b bstride,
// in T; ws the scratch
template <typename T>
static cudaError_t moments(const T* img1, const T* img2, size_t bstride,
                           const T* pos, float* F, void* ws, int B, int N,
                           int C, int heads, int has_pos, int single,
                           int cross, cudaStream_t st) {
  if (C != heads * kHeadDim || (has_pos && pos == nullptr) || !ws)
    return cudaErrorInvalidValue;
  const tc::EbTcArgs<T> a{img1, img2, bstride, pos, F, ws, B, N, C, heads};
  return has_pos
             ? moments_e<T, kHeadDim + tc::kEbPos>(a, single, cross, st)
             : moments_e<T, kHeadDim>(a, single, cross, st);
}

// The bytes of the forward's scratch: the moments' pieces (bf16 EwbFwdWs,
// fp32 EbFwdWs), then in fp32 the qkv weight's hi / lo split (2 3C C fp32)
static size_t fwd_ws_bytes(int B, int N, int C, int heads, int e, int elem) {
  const int G = 2 * B * heads;
  if (elem == 2) return tc::wg::EwbFwdWs(nullptr, G, N, e).bytes;
  return tc::EbFwdWs(nullptr, G, N, e, elem).bytes +
         tc::eb_align(sizeof(float) * 6 * (size_t)C * C);
}

// the split weight's place in the scratch ws
static float* weight_split(void* ws, int B, int N, int C, int heads,
                           int has_pos) {
  const int e = kHeadDim + (has_pos ? tc::kEbPos : 0);
  return reinterpret_cast<float*>(
      static_cast<unsigned char*>(ws) +
      tc::EbFwdWs(nullptr, 2 * B * heads, N, e, 4).bytes);
}

// the qkv Linear out = T(T(x w^T) + T(b)) over M rows, in bf16; fp32 takes
// qkv_linear_f32
static cudaError_t qkv_linear(const tc::bf16* x, const tc::bf16* w,
                             const float* bias, tc::bf16* out, int M, int C,
                             cudaStream_t st) {
  return tc::wg::essential_qkv_bf16(x, w, bias, out, M, 3 * C, C, st);
}

// fp32: x w^T + b from ws_w = the weight's split (qkv_split_f32)
static cudaError_t qkv_linear_f32(const float* x, const float* ws_w,
                                  const float* bias, float* out, int M,
                                  int C, cudaStream_t st) {
  return tc::wg::vit_gemm_f32(kBias, x, ws_w, bias, nullptr, out, nullptr, M,
                              3 * C, C, st);
}

static cudaError_t qkv_split_f32(const float* w, float* ws_w, int C,
                                 cudaStream_t st) {
  return tc::wg::vit_split_weight_f32(w, ws_w, 1, 3 * C, C, false, st);
}

template <typename T>
static cudaError_t essential_block_pair(const T* xpair, const float* lns,
                                        const float* lnb, const T* w,
                                        const float* bias, const T* pos,
                                        float* F, T* y, T* qkv, void* ws,
                                        int B, int N, int C, int heads,
                                        int has_pos, int single, int cross,
                                        cudaStream_t st) {
  const int M = 2 * B * N;
  cudaError_t err = launch_layernorm<T>(xpair, nullptr, nullptr, nullptr,
                                        lns, lnb, y, nullptr, M, N, C, st);
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 4) {
    float* ws_w = weight_split(ws, B, N, C, heads, has_pos);
    if ((err = qkv_split_f32(w, ws_w, C, st)) != cudaSuccess) return err;
    err = qkv_linear_f32(y, ws_w, bias, qkv, M, C, st);
  } else {
    err = qkv_linear(y, w, bias, qkv, M, C, st);
  }
  if (err != cudaSuccess) return err;
  // the qkv rows are interleaved as the tokens: (B, 2, N, 3C)
  const size_t img = (size_t)N * 3 * C;
  return moments<T>(qkv, qkv + img, 2 * img, pos, F, ws, B, N, C, heads,
                    has_pos, single, cross, st);
}

template <typename T>
static cudaError_t essential_block_x(const T* x1, const T* x2, const T* w,
                                     const float* bias, const T* pos,
                                     float* F, T* qkv, void* ws, int B, int N,
                                     int C, int heads, int has_pos,
                                     int single, int cross, cudaStream_t st) {
  // qkv scratch (2, B, N, 3C): image 1's rows, then image 2's
  const int M = B * N;
  const size_t half = (size_t)M * 3 * C;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    float* ws_w = weight_split(ws, B, N, C, heads, has_pos);
    if ((err = qkv_split_f32(w, ws_w, C, st)) != cudaSuccess) return err;
    if ((err = qkv_linear_f32(x1, ws_w, bias, qkv, M, C, st)) != cudaSuccess)
      return err;
    err = qkv_linear_f32(x2, ws_w, bias, qkv + half, M, C, st);
  } else {
    if ((err = qkv_linear(x1, w, bias, qkv, M, C, st)) != cudaSuccess)
      return err;
    err = qkv_linear(x2, w, bias, qkv + half, M, C, st);
  }
  if (err != cudaSuccess) return err;
  return moments<T>(qkv, qkv + half, (size_t)N * 3 * C, pos, F, ws, B, N, C,
                    heads, has_pos, single, cross, st);
}

}  // namespace rp

// bytes of scratch rp_essential_block_pair / _x / rp_essential_block need:
// the moments' statistics, vb_n (in the dtype) and F partials, in bf16 the
// row maxima's partials, and in fp32 the qkv weight's split
extern "C" long long rp_essential_block_workspace(int B, int N, int heads,
                                                  int has_pos, int bf16) {
  const int e = rp::kHeadDim + (has_pos ? rp::tc::kEbPos : 0);
  return (long long)rp::fwd_ws_bytes(B, N, rp::kHeadDim * heads, heads, e,
                                     bf16 ? 2 : 4);
}

// xpair (B, 2, N, C), w (3C, C) and pos (B, N, 6) in T (pos NULL without
// positions); LN scale / bias and the qkv bias fp32; y (2BN, C) and qkv
// (2BN, 3C) scratch in T; ws the workspace -> F (B, 2, heads, e, e) fp32
extern "C" int rp_essential_block_pair(
    const void* xpair, const float* lns, const float* lnb, const void* w,
    const float* bias, const void* pos, float* F, void* y, void* qkv,
    void* ws, int B, int N, int C, int heads, int has_pos, int single,
    int cross, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::essential_block_pair<T>(
        (const T*)xpair, lns, lnb, (const T*)w, bias, (const T*)pos, F,
        (T*)y, (T*)qkv, ws, B, N, C, heads, has_pos, single, cross, st);
  }
  return rp::essential_block_pair<float>(
      (const float*)xpair, lns, lnb, (const float*)w, bias,
      (const float*)pos, F, (float*)y, (float*)qkv, ws, B, N, C, heads,
      has_pos, single, cross, st);
}

// x1, x2 (B, N, C), w (3C, C), pos (B, N, 6) or NULL in T; qkv bias fp32;
// qkv (2, B, N, 3C) scratch in T; ws the workspace -> F (B, 2, heads, e, e)
// fp32
extern "C" int rp_essential_block_x(const void* x1, const void* x2,
                                    const void* w, const float* bias,
                                    const void* pos, float* F, void* qkv,
                                    void* ws, int B, int N, int C, int heads,
                                    int has_pos, int single, int cross,
                                    int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::essential_block_x<T>((const T*)x1, (const T*)x2, (const T*)w,
                                    bias, (const T*)pos, F, (T*)qkv, ws, B,
                                    N, C, heads, has_pos, single, cross, st);
  }
  return rp::essential_block_x<float>(
      (const float*)x1, (const float*)x2, (const float*)w, bias,
      (const float*)pos, F, (float*)qkv, ws, B, N, C, heads, has_pos, single,
      cross, st);
}

// qkv1, qkv2 (B, N, 3C) and pos (B, N, 6) or NULL in T; ws the workspace
// -> F (B, 2, heads, e, e) fp32
extern "C" int rp_essential_block(const void* qkv1, const void* qkv2,
                                  const void* pos, float* F, void* ws, int B,
                                  int N, int C, int heads, int has_pos,
                                  int single, int cross, int bf16,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bstride = (size_t)N * 3 * C;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::moments<T>((const T*)qkv1, (const T*)qkv2, bstride,
                          (const T*)pos, F, ws, B, N, C, heads, has_pos,
                          single, cross, st);
  }
  return rp::moments<float>((const float*)qkv1, (const float*)qkv2, bstride,
                            (const float*)pos, F, ws, B, N, C, heads, has_pos,
                            single, cross, st);
}

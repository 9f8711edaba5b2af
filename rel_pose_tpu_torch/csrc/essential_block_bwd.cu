// Entry point of the Essential Matrix Module's backward (replaces the Pallas
// _essential_block_bwd_kernel, #6), picking the variant of the flags
// has_pos, single and cross, with the scratch that
// rp_essential_block_bwd_workspace sizes.  Which body each dtype takes
// (each: statistics, prologue, one rho / gamma pass, two gradient passes):
//   bf16: the wgmma passes of essential_wgmma.cuh (m64nNk16, TMA-fed
//     tiles), instantiated in essential_wgmma_bwd.cu (e = 70) and
//     essential_wgmma_bwd_e64.cu (e = 64), its scratch EbBwdWs with the
//     rows in core-matrix tiles and gamma's query-tile partials;
//   fp32: the TF32 wgmma passes of essential_wgmma_f32.cuh (3xTF32),
//     instantiated in essential_wgmma_f32_bwd.cu and
//     essential_wgmma_f32_bwd_e64.cu, its scratch EbBwdWs and gamma's
//     query-tile partials.

#include "essential_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {
RP_EW_VARIANTS(RP_EWB_BWD_EXTERN, kHeadDim + kEbPos)
RP_EW_VARIANTS(RP_EWB_BWD_EXTERN, kHeadDim)
RP_EW_VARIANTS(RP_EW_BWD_EXTERN, kHeadDim + kEbPos)
RP_EW_VARIANTS(RP_EW_BWD_EXTERN, kHeadDim)
}  // namespace wg

template <typename T, int E>
static cudaError_t essential_bwd_e(const EbbTcArgs<T>& a, bool single,
                                   bool cross, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (single)
      return cross ? wg::launch_bwd_wg<E, true, true>(a, st)
                   : wg::launch_bwd_wg<E, true, false>(a, st);
    return cross ? wg::launch_bwd_wg<E, false, true>(a, st)
                 : wg::launch_bwd_wg<E, false, false>(a, st);
  } else {
    if (single)
      return cross ? wg::launch_bwd_wb<E, true, true>(a, st)
                   : wg::launch_bwd_wb<E, true, false>(a, st);
    return cross ? wg::launch_bwd_wb<E, false, true>(a, st)
                 : wg::launch_bwd_wb<E, false, false>(a, st);
  }
}

template <typename T>
static cudaError_t essential_bwd(const EbbTcArgs<T>& a, int has_pos,
                                 int single, int cross, cudaStream_t st) {
  if (a.C != a.heads * kHeadDim ||
      (has_pos && (a.pos == nullptr || a.dpos_part == nullptr)) ||
      (cross && a.dva == nullptr) || a.ws == nullptr)
    return cudaErrorInvalidValue;
  return has_pos ? essential_bwd_e<T, kHeadDim + kEbPos>(a, single, cross, st)
                 : essential_bwd_e<T, kHeadDim>(a, single, cross, st);
}
}  // namespace tc
}  // namespace rp

// bytes of scratch rp_essential_block_bwd needs: the passes' statistics,
// operand rows (in the dtype; bf16 in 64-row tiles), dva and gamma's
// partials
extern "C" long long rp_essential_block_bwd_workspace(int B, int N,
                                                      int heads, int has_pos,
                                                      int bf16) {
  namespace wg = rp::tc::wg;
  const int e = rp::kHeadDim + (has_pos ? rp::tc::kEbPos : 0);
  const int G = 2 * B * heads;
  if (bf16) return (long long)wg::bwd_wb_bytes(G, N, e);
  return (long long)(rp::tc::EbBwdWs(nullptr, G, N, e, true, 4).bytes +
                     wg::bwd_wg_extra_bytes(G, N));
}

// qkv (B, 2, N, 3C) and pos (B, N, 6) (NULL without positions) in T, dF
// (B, 2, heads, e, e) fp32 -> dqkv (B, 2, N, 3C) in T, with cross the dva
// of each image's v slots (B, 2, N, C) in T, and with positions dpos_part
// (B, 2, heads, N, 6) fp32
extern "C" int rp_essential_block_bwd(const void* qkv, const void* pos,
                                      const float* dF, void* dqkv, void* dva,
                                      float* dpos_part, void* ws, int B,
                                      int N, int C, int heads, int has_pos,
                                      int single, int cross, int bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::tc::essential_bwd<T>({(const T*)qkv, (const T*)pos, dF,
                                     (T*)dqkv, (T*)dva, dpos_part, ws, B, N,
                                     C, heads},
                                    has_pos, single, cross, st);
  }
  return rp::tc::essential_bwd<float>(
      {(const float*)qkv, (const float*)pos, dF, (float*)dqkv, (float*)dva,
       dpos_part, ws, B, N, C, heads},
      has_pos, single, cross, st);
}

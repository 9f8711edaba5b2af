// Entry point of the Essential Matrix Module's backward (replaces the Pallas
// _essential_block_bwd_kernel): bf16 runs the tensor-core passes of
// essential_tc_bwd.cuh, fp32 the SIMT kernel of essential_block_bwd.cuh, as
// before; each picks the variant of the flags has_pos, single and cross.
// The e = 70 variants are instantiated here and in essential_tc_bwd.cu, the
// e = 64 ones in essential_block_bwd_e64.cu and essential_tc_bwd_e64.cu.

#include "essential_block_bwd.cuh"
#include "essential_tc_bwd.cuh"

namespace rp {

RP_EB_VARIANTS(RP_EBB_EXTERN, kEbbHeadDim)
namespace tc {
RP_EB_TC_VARIANTS(RP_EBB_TC_EXTERN, kHeadDim + kEbPos)
RP_EB_TC_VARIANTS(RP_EBB_TC_EXTERN, kHeadDim)

template <int E>
static cudaError_t essential_bwd_tc_e(const EbbTcArgs& a, bool single,
                                      bool cross, cudaStream_t st) {
  if (single)
    return cross ? launch_essential_bwd_tc<E, true, true>(a, st)
                 : launch_essential_bwd_tc<E, true, false>(a, st);
  return cross ? launch_essential_bwd_tc<E, false, true>(a, st)
               : launch_essential_bwd_tc<E, false, false>(a, st);
}
}  // namespace tc

template <int E>
static cudaError_t essential_block_bwd_e(const EbbArgs<float>& a,
                                         bool single, bool cross,
                                         cudaStream_t st) {
  using T = float;
  if (single)
    return cross ? launch_essential_block_bwd<T, E, true, true>(a, st)
                 : launch_essential_block_bwd<T, E, true, false>(a, st);
  return cross ? launch_essential_block_bwd<T, E, false, true>(a, st)
               : launch_essential_block_bwd<T, E, false, false>(a, st);
}

// fp32, the SIMT kernel
static cudaError_t essential_block_bwd(const EbbArgs<float>& a, int has_pos,
                                       int single, int cross,
                                       cudaStream_t st) {
  if (a.C != a.heads * kEbbHeadDim ||
      (has_pos && (a.pos == nullptr || a.dpos_part == nullptr)) ||
      (cross && a.dva == nullptr))
    return cudaErrorInvalidValue;
  return has_pos
             ? essential_block_bwd_e<kEbbHeadDim + kEbbPos>(a, single, cross,
                                                            st)
             : essential_block_bwd_e<kEbbHeadDim>(a, single, cross, st);
}

}  // namespace rp

// bytes of scratch rp_essential_block_bwd needs: bf16 the tensor-core
// passes' statistics and operand rows, fp32 the SIMT kernel's accumulators
extern "C" long long rp_essential_block_bwd_workspace(int B, int N,
                                                      int heads, int has_pos,
                                                      int bf16) {
  const int e = rp::kEbbHeadDim + (has_pos ? rp::kEbbPos : 0);
  if (bf16)
    return (long long)rp::tc::EbBwdWs(nullptr, 2 * B * heads, N, e, true)
        .bytes;
  return (long long)(sizeof(float) * (size_t)B * 2 * heads *
                     rp::ebb_scratch_floats(N, e));
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
    if (C != heads * rp::kEbbHeadDim ||
        (has_pos && (pos == nullptr || dpos_part == nullptr)) ||
        (cross && dva == nullptr) || ws == nullptr)
      return cudaErrorInvalidValue;
    const rp::tc::EbbTcArgs a{(const T*)qkv, (const T*)pos, dF, (T*)dqkv,
                              (T*)dva, dpos_part, ws, B, N, C, heads};
    return has_pos ? rp::tc::essential_bwd_tc_e<rp::kEbbHeadDim + rp::kEbbPos>(
                         a, single, cross, st)
                   : rp::tc::essential_bwd_tc_e<rp::kEbbHeadDim>(a, single,
                                                                 cross, st);
  }
  return rp::essential_block_bwd(
      {(const float*)qkv, (const float*)pos, dF, (float*)dqkv, (float*)dva,
       dpos_part, (float*)ws, B, N, C, heads},
      has_pos, single, cross, st);
}

// Forward of the per-head bilinear attention op: Pallas kernel #8's forward.
//
// Replaces: rel_pose_tpu/ops/pallas_essential.py:_fwd_kernel.  Over G
// independent slices of q, k (G, N, 64) and va, vb (G, N, e), e = 64 or 70,
//   s = q k^T * scale,  A = softmax_row(s) * softmax_col(s)  (dual)
//                         | softmax_row(s)                    (single)
//   F = va^T A vb  -> (G, e, e) fp32
// with _fwd_kernel's roundings.  The JAX package's caller is
// _head_stacked_impl (pallas_essential_block.py:420), which stacks the
// essential block's 2 directions x heads of B pairs into G = 2 B heads
// slices; va and vb may be one tensor.
//
// bf16 runs the essential block's tensor-core moments (essential_tc.cuh,
// SliceLayout, the scale a runtime argument): key statistics, vb_n
// packing, the moments walk and the F-partial sum, with the scratch that
// rp_bilinear_fwd_workspace sizes; at most 65,535 slices (the grid's
// second dimension).  What bounds it there is #4's: the score products and
// the exp2 of every score (essential_tc.cuh).  fp32 keeps bilinear.cuh's
// SIMT body, one block per slice: the N x N x 64 score products (formed
// twice with the dual softmax) and the N x N x e P . vb product as fp32
// FMAs, with one 123 KB block per SM.

#include "bilinear.cuh"
#include "essential_tc.cuh"

namespace rp {

struct BlArgs {
  const float* q;
  const float* k;
  const float* va;
  const float* vb;
  float* F;
  int N;
};

template <int E, bool SINGLE>
__global__ void __launch_bounds__(kBlThreads)
bilinear_fwd_kernel(BlArgs a, float scale) {
  extern __shared__ float smem[];
  const size_t g = blockIdx.x, N = a.N;
  const SliceRows<float, E> rows{a.q + g * N * kBlD, a.k + g * N * kBlD,
                                 a.va + g * N * E, a.vb + g * N * E};
  bilinear_moments<float, E, SINGLE>(rows, a.N, scale, smem,
                                     a.F + g * E * E);
}

template <int E, bool SINGLE>
static cudaError_t launch_fwd(const BlArgs& a, int G, float scale,
                              cudaStream_t st) {
  const size_t smem = bilinear_smem_bytes(a.N, E);
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_fwd_kernel<E, SINGLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bilinear_fwd_kernel<E, SINGLE><<<G, kBlThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

// fp32, the SIMT body
static cudaError_t bilinear_fwd(const BlArgs& a, int G, int e, int single,
                                float scale, cudaStream_t st) {
  if (e == kBlD + kBlPos)
    return single ? launch_fwd<kBlD + kBlPos, true>(a, G, scale, st)
                  : launch_fwd<kBlD + kBlPos, false>(a, G, scale, st);
  if (e == kBlD)
    return single ? launch_fwd<kBlD, true>(a, G, scale, st)
                  : launch_fwd<kBlD, false>(a, G, scale, st);
  return cudaErrorInvalidValue;
}

namespace tc {

template <int E>
static cudaError_t bilinear_fwd_tc_e(const EbFwdArgs& a, int single,
                                     cudaStream_t st) {
  return single ? launch_moments<SliceLayout, E, kEbSingle, false, false>(a, st)
                : launch_moments<SliceLayout, E, kEbDual, false, false>(a, st);
}

// bf16, the tensor-core moments
static cudaError_t bilinear_fwd_tc(const EbFwdArgs& a, int e, int single,
                                   cudaStream_t st) {
  if (e == kHeadDim + kEbPos)
    return bilinear_fwd_tc_e<kHeadDim + kEbPos>(a, single, st);
  if (e == kHeadDim) return bilinear_fwd_tc_e<kHeadDim>(a, single, st);
  return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rp

// bytes of scratch rp_bilinear_fwd needs: bf16 the tensor-core moments'
// statistics, vb_n and F partials; fp32 none
extern "C" long long rp_bilinear_fwd_workspace(int G, int N, int e,
                                               int bf16) {
  if (!bf16) return 0;
  return (long long)rp::tc::EbFwdWs(nullptr, G, N, e).bytes;
}

// q, k (G, N, 64), va, vb (G, N, e) in T (va == vb allowed); e = 64 or 70;
// scale = the softmax scale times log2(e); ws the workspace (bf16) -> F
// (G, e, e) fp32
extern "C" int rp_bilinear_fwd(const void* q, const void* k, const void* va,
                               const void* vb, float* F, void* ws, int G,
                               int N, int e, int single, float scale,
                               int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    const rp::tc::EbFwdArgs a{(const T*)q, (const T*)k, (const T*)va,
                              (const T*)vb, 0, F, ws, G, N, rp::kBlD, 1, 1,
                              scale};
    return rp::tc::bilinear_fwd_tc(a, e, single, st);
  }
  return rp::bilinear_fwd({(const float*)q, (const float*)k,
                           (const float*)va, (const float*)vb, F, N},
                          G, e, single, scale, st);
}

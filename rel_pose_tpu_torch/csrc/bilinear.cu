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
// Both dtypes run the essential block's tensor-core moments
// (essential_tc.cuh, SliceLayout, the scale a runtime argument): key
// statistics, vb_n packing, the moments walk and the F-partial sum, with
// the scratch that rp_bilinear_fwd_workspace sizes; at most 65,535 slices
// (the grid's second dimension).  bf16 on m16n8k16; fp32 as 3xTF32,
// instantiated in bilinear_f32.cu so that nvcc builds it beside this file.
// What bounds it is #4's: the score products and the exp2 of every score
// (essential_tc.cuh).

#include "essential_tc.cuh"

namespace rp {
namespace tc {

extern template cudaError_t launch_slice_moments<float>(
    const EbFwdArgsT<float>&, int, int, cudaStream_t);

template <typename T>
static cudaError_t bilinear_fwd(const void* q, const void* k, const void* va,
                                const void* vb, float* F, void* ws, int G,
                                int N, int e, int single, float scale,
                                cudaStream_t st) {
  const EbFwdArgsT<T> a{(const T*)q, (const T*)k, (const T*)va, (const T*)vb,
                        0, F, ws, G, N, kHeadDim, 1, scale};
  return launch_slice_moments(a, e, single, st);
}

}  // namespace tc
}  // namespace rp

// bytes of scratch rp_bilinear_fwd needs: the tensor-core moments'
// statistics, vb_n and F partials
extern "C" long long rp_bilinear_fwd_workspace(int G, int N, int e,
                                               int bf16) {
  return (long long)rp::tc::EbFwdWs(nullptr, G, N, e, bf16 ? 2 : 4).bytes;
}

// q, k (G, N, 64), va, vb (G, N, e) in T (va == vb allowed); e = 64 or 70;
// scale = the softmax scale times log2(e); ws the workspace -> F (G, e, e)
// fp32
extern "C" int rp_bilinear_fwd(const void* q, const void* k, const void* va,
                               const void* vb, float* F, void* ws, int G,
                               int N, int e, int single, float scale,
                               int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return rp::tc::bilinear_fwd<__nv_bfloat16>(q, k, va, vb, F, ws, G, N, e,
                                               single, scale, st);
  return rp::tc::bilinear_fwd<float>(q, k, va, vb, F, ws, G, N, e, single,
                                     scale, st);
}

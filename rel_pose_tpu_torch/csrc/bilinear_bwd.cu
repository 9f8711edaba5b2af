// Backward of the per-head bilinear attention op: Pallas kernel #8's VJP.
//
// Replaces: rel_pose_tpu/ops/pallas_essential.py:_bwd_kernel.  Both dtypes
// run the essential block's tensor-core passes (essential_tc_bwd.cuh,
// SliceLayout: statistics, prologue, the rho / gamma passes and the two
// gradient passes, with the scratch that rp_bilinear_bwd_workspace sizes;
// at most 65,535 slices): bf16 on m16n8k16, fp32 as 3xTF32, instantiated
// in bilinear_bwd_f32.cu so that nvcc builds it beside this file.
// Per slice g of q, k (G, N, 64), va, vb (G, N, e) and dF (G, e, e) fp32,
// with T the inputs' dtype at _bwd_kernel's rounding points (the identity
// in fp32):
//   s2 = q k^T scale log2e;  R, Cmat = the normalized row / column softmaxes
//   (exp2);  A = R Cmat, or R alone with SINGLE;  Ab = T(A)
//   dva = T(Ab T(vb T(dF)^T));   vadf = T(va T(dF));   dvb = T(Ab^T vadf)
//   dA = vadf vb^T (fp32)
//   ds = R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC Cmat)),
//        dR = dA Cmat, dC = dA R;   with SINGLE ds = R (dA - rowsum(dA R))
//   dq = T(T(ds scale) k);  dk = T(T(ds scale)^T q)
// It is the per-(pair, direction, head) VJP of #6 (essential_tc_bwd.cuh)
// on a slice of its own: no directions, no positional bookkeeping, and va,
// vb separate tensors (one tensor in the non-cross wiring; the caller's
// autograd adds dva and dvb), each written straight to its output.  Each
// output row has one writer: no atomics, and two runs give the same bits.
// What bounds it on the H100 is #6's (essential_tc_bwd.cuh): the products
// and the exp2 of every score.

#include "essential_tc_bwd.cuh"

namespace rp {
namespace tc {

extern template cudaError_t launch_slice_bwd<float>(const EbBwdArgsT<float>&,
                                                    int, int, cudaStream_t);

template <typename T>
static cudaError_t bilinear_bwd(const void* q, const void* k, const void* va,
                                const void* vb, const float* dF, void* dq,
                                void* dk, void* dva, void* dvb, void* ws,
                                int G, int N, int e, int single, float scale2,
                                float dscale, cudaStream_t st) {
  const EbBwdArgsT<T> a{(const T*)q, (const T*)k, (const T*)va, (const T*)vb,
                        0, dF, (T*)dq, (T*)dk, (T*)dva, (T*)dvb, ws,
                        G, N, kHeadDim, 1, scale2, dscale};
  return launch_slice_bwd(a, e, single, st);
}

}  // namespace tc
}  // namespace rp

// bytes of scratch rp_bilinear_bwd needs: the tensor-core passes'
// statistics and operand rows
extern "C" long long rp_bilinear_bwd_workspace(int G, int N, int e,
                                               int bf16) {
  return (long long)rp::tc::EbBwdWs(nullptr, G, N, e, false, bf16 ? 2 : 4)
      .bytes;
}

// q, k (G, N, 64), va, vb (G, N, e) in T, dF (G, e, e) fp32; scale2 = the
// softmax scale times log2(e), dscale = the softmax scale; ws the workspace
// -> dq, dk, dva, dvb in T, shaped as q, k, va, vb
extern "C" int rp_bilinear_bwd(const void* q, const void* k, const void* va,
                               const void* vb, const float* dF, void* dq,
                               void* dk, void* dva, void* dvb, void* ws,
                               int G, int N, int e, int single, float scale2,
                               float dscale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return rp::tc::bilinear_bwd<__nv_bfloat16>(q, k, va, vb, dF, dq, dk, dva,
                                               dvb, ws, G, N, e, single,
                                               scale2, dscale, st);
  return rp::tc::bilinear_bwd<float>(q, k, va, vb, dF, dq, dk, dva, dvb, ws,
                                     G, N, e, single, scale2, dscale, st);
}

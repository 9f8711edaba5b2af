// The fp32 ViT-stack GEMMs of gemm_wgmma_f32.cuh, instantiated in a
// translation unit of their own (it builds beside vit_stack.cu, which
// declares the entry functions), and a test-only C entry point that runs one
// of them alone.

#include "gemm_wgmma_f32.cuh"

namespace rp {
namespace tc {
namespace wg {

cudaError_t vit_split_weight_f32(const float* W, float* Ws, int count, int R,
                                 int C, bool transpose, cudaStream_t st) {
  return split_weight_f32(W, Ws, count, R, C, transpose, st);
}

cudaError_t vit_gemm_f32(int epi, const float* A, const float* Ws,
                         const float* bias, const float* resid, float* out,
                         float* aux, int M, int N, int K, cudaStream_t st) {
  switch (epi) {
    case kBias:
      return gemm_f32<kOpFwd, kBias>(A, Ws, bias, resid, out, aux, M, N, K,
                                     st);
    case kBiasGelu:
      return gemm_f32<kOpFwd, kBiasGelu>(A, Ws, bias, resid, out, aux, M, N,
                                         K, st);
    case kBiasResid:
      if (resid == nullptr) return cudaErrorInvalidValue;
      return gemm_f32<kOpFwd, kBiasResid>(A, Ws, bias, resid, out, aux, M, N,
                                          K, st);
    case kBiasGeluSplit:
      if (aux == nullptr) return cudaErrorInvalidValue;
      return gemm_f32<kOpFwd, kBiasGeluSplit>(A, Ws, bias, resid, out, aux,
                                              M, N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t vit_gemm_dx_f32(int epi, const float* dY, const float* WTs,
                            const float* aux, float* out, int M, int N, int K,
                            cudaStream_t st) {
  switch (epi) {
    case kDxPlain:
      return gemm_f32<kOpDx, kDxPlain>(dY, WTs, nullptr, nullptr, out,
                                       nullptr, M, N, K, st);
    case kDxGeluGrad:
      if (aux == nullptr) return cudaErrorInvalidValue;
      return gemm_f32<kOpDx, kDxGeluGrad>(dY, WTs, nullptr, nullptr, out,
                                          const_cast<float*>(aux), M, N, K,
                                          st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t vit_weight_grad_f32(const float* dY, const float* X, float* dW,
                                float* db, float* part, float* bpart, int M,
                                int Nout, int K, cudaStream_t st) {
  return gemm_dw_f32(dY, X, dW, db, part, bpart, M, Nout, K, st);
}

}  // namespace wg
}  // namespace tc
}  // namespace rp

// One GEMM of the fp32 body alone, for chip_smoke.py's per-shape checks and
// times (the model path never calls it):
//   op 0, forward: a = A (M, K), b = W (N, K), f = bias (N), r = resid
//     (M, N) or NULL, out = (M, N), aux = (M, N) (kBiasGeluSplit), ws =
//     scratch for W's hi / lo split (2 N K);
//   op 1, dX: a = dY (M, K), b = W (K, N), aux = the pre-activation (M, N)
//     (kDxGeluGrad), out = (M, N), ws = scratch for W^T's split (2 N K);
//   op 2, dW: a = dY (M, N), which also gives the bias sums, b = X (M, K),
//     out = dW (N, K), aux = db (N), part / bpart dw_chunks(M) partials;
//     f unused.
// All fp32; the weight's split runs before the GEMM, on the same stream.
extern "C" int rp_gemm_f32(int op, int epi, const float* a, const float* b,
                           const float* f, const float* r, float* out,
                           float* aux, float* ws, float* part, float* bpart,
                           int M, int N, int K, void* stream) {
  namespace wg = rp::tc::wg;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (op) {
    case 0:
      if ((err = wg::vit_split_weight_f32(b, ws, 1, N, K, false, st)) !=
          cudaSuccess)
        return err;
      return wg::vit_gemm_f32(epi, a, ws, f, r, out, aux, M, N, K, st);
    case 1:
      if ((err = wg::vit_split_weight_f32(b, ws, 1, K, N, true, st)) !=
          cudaSuccess)
        return err;
      return wg::vit_gemm_dx_f32(epi, a, ws, aux, out, M, N, K, st);
    case 2:
      return wg::vit_weight_grad_f32(a, b, out, aux, part, bpart, M, N, K,
                                     st);
    default:
      return cudaErrorInvalidValue;
  }
}

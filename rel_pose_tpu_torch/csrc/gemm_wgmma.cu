// The bf16 GEMMs of gemm_wgmma.cuh, instantiated in a translation unit of
// their own (it builds beside vit_stack.cu and essential_block.cu, which
// declare the entry functions): the ViT stack's three, the essential
// block's qkv Linear, and a test-only C entry point that runs one of the
// ViT stack's alone.

#include "gemm_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {

cudaError_t vit_gemm_bf16(int epi, const bf16* A, const bf16* W,
                          const float* bias, const bf16* resid, bf16* out,
                          float* aux, int M, int N, int K, cudaStream_t st) {
  switch (epi) {
    case kBias:
      return gemm_fwd<kBias>(A, W, bias, resid, out, aux, M, N, K, st);
    case kBiasGelu:
      return gemm_fwd<kBiasGelu>(A, W, bias, resid, out, aux, M, N, K, st);
    case kBiasResid:
      if (resid == nullptr) return cudaErrorInvalidValue;
      return gemm_fwd<kBiasResid>(A, W, bias, resid, out, aux, M, N, K, st);
    case kBiasGeluSplit:
      if (aux == nullptr) return cudaErrorInvalidValue;
      return gemm_fwd<kBiasGeluSplit>(A, W, bias, resid, out, aux, M, N, K,
                                      st);
    default:
      return cudaErrorInvalidValue;
  }
}

// the essential block's qkv Linear, out = T(T(x w^T) + T(b)) (#2, #3)
cudaError_t essential_qkv_bf16(const bf16* x, const bf16* w,
                               const float* bias, bf16* out, int M, int N,
                               int K, cudaStream_t st) {
  return gemm_fwd<kRounded>(x, w, bias, nullptr, out, nullptr, M, N, K, st);
}

cudaError_t vit_gemm_dx_bf16(int epi, const bf16* dYb, const bf16* W,
                             const float* aux, float* out, bf16* outb, int M,
                             int N, int K, cudaStream_t st) {
  switch (epi) {
    case kDxPlain:
      return gemm_dx<kDxPlain>(dYb, W, aux, out, outb, M, N, K, st);
    case kDxGeluGrad:
      if (aux == nullptr) return cudaErrorInvalidValue;
      return gemm_dx<kDxGeluGrad>(dYb, W, aux, out, outb, M, N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t vit_weight_grad_bf16(const bf16* dYb, const float* dY,
                                 const bf16* X, float* dW, float* db,
                                 float* part, float* bpart, int M, int Nout,
                                 int K, cudaStream_t st) {
  return gemm_dw(dYb, dY, X, dW, db, part, bpart, M, Nout, K, st);
}

}  // namespace wg
}  // namespace tc
}  // namespace rp

// One GEMM of the bf16 body alone, for chip_smoke.py's per-shape checks and
// times (the model path never calls it):
//   op 0, forward: a = A (M, K), b = W (N, K), f = bias (N), r = resid
//     (M, N) or NULL, out = bf16 (M, N), aux = fp32 (M, N) (kBiasGeluSplit);
//   op 1, dX: a = dY' (M, K), b = W (K, N), aux = the pre-activation (M, N)
//     (kDxGeluGrad), out = fp32 (M, N), outb = bf16 (M, N) or NULL;
//   op 2, dW: a = dY' (M, N), b = X (M, K), f = dY fp32 (M, N), out = dW
//     fp32 (N, K), aux = db fp32 (N), part / bpart dw_chunks(M) partials.
extern "C" int rp_gemm_bf16(int op, int epi, const void* a, const void* b,
                            const float* f, const void* r, void* out,
                            float* aux, void* outb, float* part, float* bpart,
                            int M, int N, int K, void* stream) {
  using rp::tc::bf16;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case 0:
      return rp::tc::wg::vit_gemm_bf16(epi, (const bf16*)a, (const bf16*)b, f,
                                       (const bf16*)r, (bf16*)out, aux, M, N,
                                       K, st);
    case 1:
      return rp::tc::wg::vit_gemm_dx_bf16(epi, (const bf16*)a, (const bf16*)b,
                                          aux, (float*)out, (bf16*)outb, M,
                                          N, K, st);
    case 2:
      return rp::tc::wg::vit_weight_grad_bf16((const bf16*)a, f,
                                              (const bf16*)b, (float*)out,
                                              aux, part, bpart, M, N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

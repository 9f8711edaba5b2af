// Forward of the per-head bilinear attention op: Pallas kernel #8's forward.
//
// Replaces: rel_pose_tpu/ops/pallas_essential.py:_fwd_kernel.  Over G
// independent slices of q, k (G, N, 64) and va, vb (G, N, e), e = 64 or 70,
//   s = q k^T * scale,  A = softmax_row(s) * softmax_col(s)  (dual)
//                         | softmax_row(s)                    (single)
//   F = va^T A vb  -> (G, e, e) fp32
// with _fwd_kernel's roundings (bilinear.cuh).  The JAX package's caller is
// _head_stacked_impl (pallas_essential_block.py:420), which stacks the
// essential block's 2 directions x heads of B pairs into G = 2 B heads
// slices; va and vb may be one tensor.
//
// One CUDA block per slice runs bilinear.cuh's two-phase body: 1,536 blocks
// at the eval shapes of batch 256.  What bounds it on the H100: the N x N x
// 64 score products (formed twice with the dual softmax) and the N x N x e
// P . vb product as SIMT fp32 FMAs, with one 123 KB block per SM; the bytes
// (q, k, va, vb read once, F written once) are a small part of that.

#include "bilinear.cuh"

namespace rp {

template <typename T>
struct BlArgs {
  const T* q;
  const T* k;
  const T* va;
  const T* vb;
  float* F;
  int N;
};

template <typename T, int E, bool SINGLE>
__global__ void __launch_bounds__(kBlThreads)
bilinear_fwd_kernel(BlArgs<T> a, float scale) {
  extern __shared__ float smem[];
  const size_t g = blockIdx.x, N = a.N;
  const SliceRows<T, E> rows{a.q + g * N * kBlD, a.k + g * N * kBlD,
                             a.va + g * N * E, a.vb + g * N * E};
  bilinear_moments<T, E, SINGLE ? kBlSingle : kBlDual>(
      rows, a.N, scale, smem, a.F + g * E * E);
}

template <typename T, int E, bool SINGLE>
static cudaError_t launch_fwd(const BlArgs<T>& a, int G, float scale,
                              cudaStream_t st) {
  const size_t smem = bilinear_smem_bytes(a.N, E);
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_fwd_kernel<T, E, SINGLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bilinear_fwd_kernel<T, E, SINGLE><<<G, kBlThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bilinear_fwd(const BlArgs<T>& a, int G, int e,
                                int single, float scale, cudaStream_t st) {
  if (e == kBlD + kBlPos)
    return single ? launch_fwd<T, kBlD + kBlPos, true>(a, G, scale, st)
                  : launch_fwd<T, kBlD + kBlPos, false>(a, G, scale, st);
  if (e == kBlD)
    return single ? launch_fwd<T, kBlD, true>(a, G, scale, st)
                  : launch_fwd<T, kBlD, false>(a, G, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace rp

// q, k (G, N, 64), va, vb (G, N, e) in T (va == vb allowed); e = 64 or 70;
// scale = the softmax scale times log2(e) -> F (G, e, e) fp32
extern "C" int rp_bilinear_fwd(const void* q, const void* k, const void* va,
                               const void* vb, float* F, int G, int N, int e,
                               int single, float scale, int bf16,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::bilinear_fwd<T>({(const T*)q, (const T*)k, (const T*)va,
                                (const T*)vb, F, N},
                               G, e, single, scale, st);
  }
  return rp::bilinear_fwd<float>({(const float*)q, (const float*)k,
                                  (const float*)va, (const float*)vb, F, N},
                                 G, e, single, scale, st);
}

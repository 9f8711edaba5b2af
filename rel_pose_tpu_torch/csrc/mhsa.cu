// Hand kernels for the plain softmax attention of the --noess cross block.
//
// Replaces: rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel (rp_mhsa_fwd)
// and _bwd_kernel (rp_mhsa_bwd), Pallas kernel #7.  The Pallas kernel takes
// one whole (N, d) head per grid step, its N x N fp32 scores resident in
// VMEM; here the kernels of attention.cuh, which keep 32 full score rows
// per CUDA block, read the separate (G, N, 64) q, k, v (SeparateQkv) and
// round as #7 does:
//   forward: s = (q . k) * scale * log2(e) in fp32, e = exp2(s - max),
//     o = (T(e) . v) / l with l the fp32 row sum of e, rounded to T;
//   backward: e and l recomputed, do_n = T(do / l), dv = T(e)^T . do_n,
//     dp = do . v^T, c = rowsum(dp * e) / l, ds = T(e ((dp - c) (scale /
//     l))), dq = ds . k, dk = ds^T . q, each rounded to T.
//
// What bounds it on the H100: the four N x N x 64 products of the forward
// and ten of the backward, as SIMT fp32 FMAs (attention.cuh); the bytes
// (q, k, v, o: 4 x G x N x 64 values) are a small fraction of that time.

#include "attention.cuh"

namespace {

constexpr double kLog2e = 1.4426950408889634;

template <typename T>
cudaError_t mhsa_fwd(const void* q, const void* k, const void* v, void* o,
                     int G, int N, float scale, cudaStream_t st) {
  // q, k, v, o, dout, dq, dk, dv, N, scale
  const rp::SeparateQkv<T> lay{(const T*)q, (const T*)k, (const T*)v, (T*)o,
                               nullptr, nullptr, nullptr, nullptr, N, scale};
  return rp::launch_attention(lay, nullptr, G, 1, N,
                              (float)(scale * kLog2e), st);
}

template <typename T>
cudaError_t mhsa_bwd(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* stats, int G, int N, float scale,
                     cudaStream_t st) {
  const rp::SeparateQkv<T> lay{(const T*)q, (const T*)k,    (const T*)v,
                               nullptr,    (const T*)dout, (T*)dq,
                               (T*)dk,     (T*)dv,         N,
                               scale};
  return rp::launch_attention_bwd(lay, stats, G, 1, N,
                                  (float)(scale * kLog2e), st);
}

}  // namespace

// o = softmax(q k^T scale) v over (G, N, d) q, k, v, o (d = 64), in fp32
// or (bf16 != 0) bf16
extern "C" int rp_mhsa_fwd(const void* q, const void* k, const void* v,
                           void* o, int G, int N, int d, float scale,
                           int bf16, void* stream) {
  if (d != rp::kHeadDim || G <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? mhsa_fwd<__nv_bfloat16>(q, k, v, o, G, N, scale, st)
              : mhsa_fwd<float>(q, k, v, o, G, N, scale, st);
}

// dq, dk, dv of rp_mhsa_fwd from q, k, v and the cotangent dout, all
// (G, N, d) in the same dtype; stats is fp32 scratch of 3 G N values
extern "C" int rp_mhsa_bwd(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           float* stats, int G, int N, int d, float scale,
                           int bf16, void* stream) {
  if (d != rp::kHeadDim || G <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? mhsa_bwd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, G,
                                        N, scale, st)
              : mhsa_bwd<float>(q, k, v, dout, dq, dk, dv, stats, G, N,
                                scale, st);
}

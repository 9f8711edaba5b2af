// Hand kernels for the plain softmax attention of the --noess cross block.
//
// Replaces: rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel (rp_mhsa_fwd)
// and _bwd_kernel (rp_mhsa_bwd), Pallas kernel #7.  The Pallas kernel
// takes one whole (N, d) head per grid step, its N x N fp32 scores
// resident in VMEM.  Here the layout Separate<T> runs, over separate
// (G, N, 64) q, k, v, on the wgmma + TMA bodies -- bf16 attention_wgmma.cuh,
// fp32 (3xTF32 on TF32 wgmma) attention_wgmma_f32.cuh -- rounding as #7
// does:
//   forward: s = (q . k) * scale * log2(e) in fp32, e = exp2(s - max),
//     o = (T(e) . v) / l with l the fp32 row sum of e, rounded to T (the
//     max is taken as the key tiles pass, one pass with online rescaling,
//     so that e is formed against the running max);
//   backward: e and l as the forward forms them, do_n = T(do / l),
//     dv = T(e)^T . do_n, dp = do . v^T, c, ds = T(e ((dp - c) (scale /
//     l))), dq = ds . k, dk = ds^T . q, each rounded to T.
// The Pallas backward recomputes the row max m and sum l and takes c =
// rowsum(dp e) / l.  Here the backward reads (m, l) from stats, written by
// its forward (kept under autograd, or by a forward run first), and takes
// c = do . o from the forward's output o (equal in exact arithmetic), so
// that its dq kernel makes one pass over the keys.
//
// What bounds it on the H100: the function's products, 4 N^2 d operations
// a head forward on 8 N d bytes (288 a byte at N = 576 in bf16: the
// forward sits at the ridge where HBM and the tensor cores bound it alike;
// fp32 on 3xTF32's 165 TFLOP/s is bound by the operations), 10 N^2 d
// backward.  The kernels execute 2 N^2 d multiply-adds forward and, in
// bf16, 7 backward (dq 3, dk / dv 4), in fp32 8 (dq 3, dk 3, dv 2: dk and
// dv are kernels of their own, each forming the scores), and one exp2 of
// every score a kernel.

#include "attention_tc.cuh"

namespace {

constexpr double kLog2e = 1.4426950408889634;
constexpr int kD = rp::kHeadDim;

using T = __nv_bfloat16;

}  // namespace

// o = softmax(q k^T scale) v over (G, N, d) q, k, v, o (d = 64), in fp32
// or (bf16 != 0) bf16; with stats (3 G N fp32), each row's (m, l) in its
// first two slots
extern "C" int rp_mhsa_fwd(const void* q, const void* k, const void* v,
                           void* o, float* stats, int G, int N, int d,
                           float scale, int bf16, void* stream) {
  if (d != kD || G <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float s2 = (float)(scale * kLog2e);
  if (bf16)
    return rp::tc::attention_fwd<rp::tc::Separate<T>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, stats, G, 1, N, kD, kD,
        s2, st);
  return rp::tc::attention_fwd<rp::tc::Separate<float>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, stats, G,
      1, N, kD, kD, s2, st);
}

// dq, dk, dv of rp_mhsa_fwd from q, k, v, the cotangent dout and the
// forward's output o, all (G, N, d) in the same dtype.  stats (3 G N
// fp32): the forward's (m, l), c written into the third slot.  dnb:
// (G, N, d) scratch in that dtype for T(do / l), never o.
extern "C" int rp_mhsa_bwd(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           float* stats, void* dnb, const void* o, int G,
                           int N, int d, float scale, int bf16,
                           void* stream) {
  if (d != kD || G <= 0 || N <= 0 || !stats || !dnb || !o || o == dnb)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float s2 = (float)(scale * kLog2e);
  if (bf16)
    return rp::tc::attention_bwd<rp::tc::Separate<T>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, nullptr,
        (T*)dnb, (const T*)o, nullptr, nullptr, nullptr, (T*)dq, (T*)dk,
        (T*)dv, G, 1, N, kD, kD, s2, scale, st);
  return rp::tc::attention_bwd<rp::tc::Separate<float>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      stats, nullptr, (float*)dnb, (const float*)o, (float*)dq, (float*)dk,
      (float*)dv, nullptr, nullptr, nullptr, G, 1, N, kD, kD, s2, scale, st);
}

// Hand kernels for the fusion transformer's self-attention block stack.
//
// Replaces: rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel (forward, with
// the training stash) and rel_pose_tpu/ops/pallas_vit_bwd.py:
// _vit_stack_bwd_kernel (backward, rp_vit_stack_bwd at the end of this
// file).  The Pallas kernel runs every block of one sequence inside one
// grid step with all weights resident in VMEM; an H100 block has 227 KB of
// shared memory, so here each block is a short chain of kernels launched
// from rp_vit_stack, per block:
//   (a) row LayerNorm (block 0 also adds pos_embed)   -> common.cuh
//   (b) qkv GEMM, bias epilogue                        -> gemm_wgmma.cuh
//       (fp32: gemm_wgmma_f32.cuh)
//   (c) attention per (sequence, head, 64-query tile)  -> attention_wgmma.cuh
//       (fp32: attention_wgmma_f32.cuh)
//   (b) proj GEMM, + residual epilogue (in place on the stream)
//   (a) LayerNorm, (b) fc1 GEMM + GELU, (b) fc2 GEMM + residual
//
// Both dtypes run the products on the tensor cores with fp32 sums and the
// Pallas kernels' rounding points, on wgmma with TMA-fed tiles.  bf16: the
// GEMMs (gemm_wgmma.cuh) and the attention (attention_wgmma.cuh).  fp32:
// 3xTF32 (operands split into TF32 hi + lo, the lo . lo term dropped: fp32
// accuracy, not the 3-digit TF32 that the port's precision policy
// forbids) on TF32 wgmma, the GEMMs (gemm_wgmma_f32.cuh, the weights split
// once a call into hi / lo copies, ws) and the attention
// (attention_wgmma_f32.cuh).  Attention reads q, k, v from the qkv GEMM's
// (G, N, 3C) output (layout Interleaved).
//
// What bounds it on the H100: in bf16, HBM -- each GEMM sits at 96-154
// operations a byte, under the tensor cores' 295 -- with activations
// making one device-memory round trip per kernel (the bf16 MLP hidden is
// 906 MB a block at G = 512, about 0.27 ms at 3.35 TB/s each way); in fp32
// the products, at the rate 3xTF32 reaches (three TF32 products and a split
// per operand for each) on TF32 wgmma.

#include <type_traits>

#include "attention_tc.cuh"

namespace rp {
namespace tc {

// gemm_wgmma.cu / gemm_wgmma_f32.cu: the GEMMs of gemm_wgmma.cuh (bf16)
// and gemm_wgmma_f32.cuh (fp32), `epi` one of common.cuh's Epilogue values
// but kRounded (forward) or DxEpilogue (dX)
namespace wg {
cudaError_t vit_gemm_bf16(int epi, const bf16* A, const bf16* W,
                          const float* bias, const bf16* resid, bf16* out,
                          float* aux, int M, int N, int K, cudaStream_t st);
cudaError_t vit_gemm_dx_bf16(int epi, const bf16* dYb, const bf16* W,
                             const float* aux, float* out, bf16* outb, int M,
                             int N, int K, cudaStream_t st);
cudaError_t vit_weight_grad_bf16(const bf16* dYb, const float* dY,
                                 const bf16* X, float* dW, float* db,
                                 float* part, float* bpart, int M, int Nout,
                                 int K, cudaStream_t st);
cudaError_t vit_split_weight_f32(const float* W, float* Ws, int count, int R,
                                 int C, bool transpose, cudaStream_t st);
cudaError_t vit_gemm_f32(int epi, const float* A, const float* Ws,
                         const float* bias, const float* resid, float* out,
                         float* aux, int M, int N, int K, cudaStream_t st);
cudaError_t vit_gemm_dx_f32(int epi, const float* dY, const float* WTs,
                            const float* aux, float* out, int M, int N, int K,
                            cudaStream_t st);
cudaError_t vit_weight_grad_f32(const float* dY, const float* X, float* dW,
                                float* db, float* part, float* bpart, int M,
                                int Nout, int K, cudaStream_t st);
}  // namespace wg

// The stack's GEMMs by dtype: bf16 on gemm_wgmma.cuh's body, fp32 on
// gemm_wgmma_f32.cuh's 3xTF32 one, which takes the weight as its TF32 hi /
// lo split (StackWeight: for dX, the split of its transpose).  outb (bf16
// only) takes T(out).
template <int EPI>
static cudaError_t stack_gemm(const bf16* A, const bf16* W, const float* bias,
                              const bf16* resid, bf16* out, int M, int N,
                              int K, cudaStream_t st, float* aux = nullptr) {
  return wg::vit_gemm_bf16(EPI, A, W, bias, resid, out, aux, M, N, K, st);
}
template <int EPI>
static cudaError_t stack_gemm(const float* A, const float* Ws,
                              const float* bias, const float* resid,
                              float* out, int M, int N, int K,
                              cudaStream_t st, float* aux = nullptr) {
  return wg::vit_gemm_f32(EPI, A, Ws, bias, resid, out, aux, M, N, K, st);
}
template <int EPI>
static cudaError_t stack_gemm_dx(const bf16* dYb, const bf16* W,
                                 const float* aux, float* out, bf16* outb,
                                 int M, int N, int K, cudaStream_t st) {
  return wg::vit_gemm_dx_bf16(EPI, dYb, W, aux, out, outb, M, N, K, st);
}
template <int EPI>
static cudaError_t stack_gemm_dx(const float* dY, const float* WTs,
                                 const float* aux, float* out, float*, int M,
                                 int N, int K, cudaStream_t st) {
  return wg::vit_gemm_dx_f32(EPI, dY, WTs, aux, out, M, N, K, st);
}
static cudaError_t stack_weight_grad(const bf16* dYb, const float* dY,
                                     const bf16* X, float* dW, float* db,
                                     float* part, float* bpart, int M,
                                     int Nout, int K, cudaStream_t st) {
  return wg::vit_weight_grad_bf16(dYb, dY, X, dW, db, part, bpart, M, Nout,
                                  K, st);
}
static cudaError_t stack_weight_grad(const float*, const float* dY,
                                     const float* X, float* dW, float* db,
                                     float* part, float* bpart, int M,
                                     int Nout, int K, cudaStream_t st) {
  return wg::vit_weight_grad_f32(dY, X, dW, db, part, bpart, M, Nout, K,
                                 st);
}

// The stacked weight (depth, R, C) of one Linear as the GEMMs take it,
// block i at [i]: bf16 the weight itself; fp32 its TF32 hi / lo split (2 R,
// C) a block -- with `transpose`, of its transpose (2 C, R), dX's operand
// -- written into ws by one launch
template <typename E>
struct StackWeight {
  const E* w;
  size_t stride;
  const E* operator[](int i) const { return w + i * stride; }
};

static cudaError_t stack_weight(const bf16* w, int depth, int R, int C, bool,
                                float*, StackWeight<bf16>* out,
                                cudaStream_t) {
  *out = {w, (size_t)R * C};
  return depth < 1 ? cudaErrorInvalidValue : cudaSuccess;
}
static cudaError_t stack_weight(const float* w, int depth, int R, int C,
                                bool transpose, float* ws,
                                StackWeight<float>* out, cudaStream_t st) {
  *out = {ws, 2 * (size_t)R * C};
  return wg::vit_split_weight_f32(w, ws, depth, R, C, transpose, st);
}

// floats of the four Linears' splits, depth blocks (fp32; bf16 takes none)
static size_t split_floats(int C, int hidden, int depth) {
  return 2 * (size_t)depth * C * (4 * (size_t)C + 2 * (size_t)hidden);
}

// the four Linears' weights (qkv, proj, fc1, fc2) as stack_weight gives
// them, their fp32 splits in ws in that order (split_floats in all)
template <typename E>
static cudaError_t stack_weights(const E* qkvw, const E* projw,
                                 const E* fc1w, const E* fc2w, int C,
                                 int hidden, int depth, bool transpose,
                                 float* ws, StackWeight<E>* wq,
                                 StackWeight<E>* wp, StackWeight<E>* w1,
                                 StackWeight<E>* w2, cudaStream_t st) {
  const size_t cc = (size_t)C * C, hc = (size_t)hidden * C;
  auto at = [&](size_t floats) { return ws ? ws + 2 * depth * floats : ws; };
  cudaError_t err = stack_weight(qkvw, depth, 3 * C, C, transpose, at(0), wq,
                                 st);
  if (err == cudaSuccess)
    err = stack_weight(projw, depth, C, C, transpose, at(3 * cc), wp, st);
  if (err == cudaSuccess)
    err = stack_weight(fc1w, depth, hidden, C, transpose, at(4 * cc), w1,
                       st);
  if (err == cudaSuccess)
    err = stack_weight(fc2w, depth, C, hidden, transpose, at(4 * cc + hc),
                       w2, st);
  return err;
}

constexpr float kVitScale = 0.125f * 1.4426950408889634f;  // 64^-1/2 log2 e

// attention_tc.cuh's forward over the heads of qkv (G, N, 3C) into out
// (G, N, C); with `stats`, (m, l) per row
template <typename E>
static cudaError_t launch_attention(const E* qkv, E* out, float* stats,
                                    int G, int N, int C, int heads,
                                    cudaStream_t stream) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  return attention_fwd<Interleaved>(qkv, qkv + C, qkv + 2 * C, out, stats, G,
                                    heads, N, 3 * C, C, kVitScale, stream);
}

// dq, dk, dv into dqkv (fp32) and, for bf16, dqkvb, both (G, N, 3C), from
// qkv, the fp32 cotangent dout (G, N, C) of the attention output and the
// forward's stats (c is written into their third slot); dnb is (G, N, C)
// scratch for T(do / l) that holds the forward's output o on entry (the dq
// kernel reads each element of o before it writes T(do / l) over it); for
// bf16 dob takes T(do)
template <typename E>
static cudaError_t launch_attention_bwd(const E* qkv, const float* dout,
                                        float* stats, float* dqkv, E* dqkvb,
                                        E* dob, E* dnb, int G, int N, int C,
                                        int heads, cudaStream_t stream) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  return attention_bwd<Interleaved>(
      qkv, qkv + C, qkv + 2 * C, dout, stats, dob, dnb, dnb, dqkv, dqkv + C,
      dqkv + 2 * C, dqkvb, dqkvb ? dqkvb + C : nullptr,
      dqkvb ? dqkvb + 2 * C : nullptr, G, heads, N, 3 * C, C, kVitScale, 0.f,
      stream);
}

// All `depth` blocks over x (G, N, C).  Stacked weights are (depth, out, in)
// in E; vectors are fp32.  `out` carries the residual stream and ends as the
// result; y (G*N, C), qkv (G*N, 3C), attn (G*N, C) and hid (G*N, hidden) are
// scratch.  With `stash` given (training), block i's input is also written
// to stash[i] (depth, G, N, C) by the LayerNorm that reads it, xs[0] after
// the positional add (pallas_vit.py:358-366); without it nothing extra is
// written.  Returns the first CUDA error, checked after every launch.
template <typename E>
static cudaError_t vit_stack(const E* x, const E* pos, E* out, E* stash,
                             const float* ln1s, const float* ln1b,
                             const E* qkvw, const float* qkvb, const E* projw,
                             const float* projb, const float* ln2s,
                             const float* ln2b, const E* fc1w,
                             const float* fc1b, const E* fc2w,
                             const float* fc2b, E* y, E* qkv, E* attn, E* hid,
                             float* ws, int G, int N, int C, int heads,
                             int hidden, int depth, cudaStream_t st) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  const int M = G * N;
  cudaError_t err;
#define RP_CHECK(call)                 \
  if ((err = (call)) != cudaSuccess) { \
    return err;                        \
  }
  StackWeight<E> wq, wp, w1, w2;
  RP_CHECK(stack_weights(qkvw, projw, fc1w, fc2w, C, hidden, depth, false, ws,
                         &wq, &wp, &w1, &w2, st));
  for (int i = 0; i < depth; ++i) {
    E* xcopy = stash ? stash + (size_t)i * M * C : nullptr;
    RP_CHECK(i == 0 ? launch_layernorm<E>(x, pos, out, xcopy, ln1s, ln1b, y,
                                          nullptr, M, N, C, st)
                    : launch_layernorm<E>(out, nullptr, nullptr, xcopy,
                                          ln1s + i * C, ln1b + i * C, y,
                                          nullptr, M, N, C, st));
    RP_CHECK(stack_gemm<kBias>(y, wq[i], qkvb + i * 3 * C, nullptr, qkv, M,
                               3 * C, C, st));
    RP_CHECK(launch_attention(qkv, attn, nullptr, G, N, C, heads, st));
    RP_CHECK(stack_gemm<kBiasResid>(attn, wp[i], projb + i * C, out, out, M,
                                    C, C, st));
    RP_CHECK(launch_layernorm<E>(out, nullptr, nullptr, nullptr, ln2s + i * C,
                                 ln2b + i * C, y, nullptr, M, N, C, st));
    RP_CHECK(stack_gemm<kBiasGelu>(y, w1[i], fc1b + (size_t)i * hidden,
                                   nullptr, hid, M, hidden, C, st));
    RP_CHECK(stack_gemm<kBiasResid>(hid, w2[i], fc2b + i * C, out, out, M, C,
                                    hidden, st));
  }
#undef RP_CHECK
  return cudaSuccess;
}

}  // namespace tc
}  // namespace rp

// ws: fp32, split_floats(C, hidden, depth) floats for the weights' splits
// (ops/vit_stack.py sizes it); bf16, unused
extern "C" int rp_vit_stack(const void* x, const void* pos, void* out,
                            void* stash, const float* ln1s, const float* ln1b,
                            const void* qkvw, const float* qkvb,
                            const void* projw, const float* projb,
                            const float* ln2s, const float* ln2b,
                            const void* fc1w, const float* fc1b,
                            const void* fc2w, const float* fc2b, void* y,
                            void* qkv, void* attn, void* hid, void* ws,
                            int G, int N, int C, int heads, int hidden,
                            int depth, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return rp::tc::vit_stack<T>(
        (const T*)x, (const T*)pos, (T*)out, (T*)stash, ln1s, ln1b,
        (const T*)qkvw, qkvb, (const T*)projw, projb, ln2s, ln2b,
        (const T*)fc1w, fc1b, (const T*)fc2w, fc2b, (T*)y, (T*)qkv,
        (T*)attn, (T*)hid, (float*)ws, G, N, C, heads, hidden, depth, st);
  };
  return bf16 ? run((__nv_bfloat16*)nullptr) : run((float*)nullptr);
}

// ================================================================ backward
// rp_vit_stack_bwd: the full VJP of the stack from the stash xs (depth, G,
// N, C) and the output cotangent g, after _vit_stack_bwd_kernel
// (pallas_vit_bwd.py:171-239).  The Pallas kernel walks the sequences in
// order on one core, with the weights and ~9.5 MB of fp32 weight-gradient
// accumulators resident in VMEM; Hopper has neither an ordered grid nor the
// room, so per block, in reverse order, a chain of kernels:
//   recompute from xs[i]: LN1 (+ mean, 1/sigma), qkv GEMM, attention (+ row
//     max and sum), proj GEMM + residual -> xa, LN2 (+ stats), fc1 GEMM
//     keeping h1 (fp32, unrounded) and T(gelu(h1));
//   backward: for fc2, fc1, proj and qkv a split-K dW GEMM (fixed row
//     chunks, partials summed in order: deterministic, no atomics) and a dX
//     GEMM (fc2's with the GELU derivative in its epilogue); the two
//     LayerNorm VJPs with their dscale / dbias partials; attention in the
//     flash-attention-2 split: one kernel per (sequence, head, 64-query
//     tile) forms dq with c = rowsum(do o) from the recomputed output o,
//     another per (sequence, head, 64-key tile) walks the query tiles for
//     dk and dv.
// The residual cotangent stays fp32 between kernels, as in VMEM.  A fp32
// cotangent enters a bf16 product as its bf16 copy: T(dxo) and T(dxa) cast
// into dyb, T(dh1) written by the fc2 dX epilogue into hg (free once fc2's
// dW has read it), T(dqkv) by the attention backward into dqkvb; fp32
// products read the cotangents themselves.
//
// What bounds it on the H100: in bf16, as in the forward, device memory:
// the stash, one round trip of each activation per kernel, the fp32
// cotangents, the GELU pre-activation h1 and the dW partials, about 34 KB
// a row a block (about 11.8 GB at G = 120, 3.5 ms at 3.35 TB/s), against
// 3x the forward's GEMM products and, in attention, the recomputed
// forward's 2 N x N x 64 products and the backward's 7.  In fp32 the
// products (three TF32 ones each) on TF32 wgmma.

namespace rp {

static size_t align_up(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// the backward's scratch, carved from one workspace in this order
struct VitBwdBufs {
  void *y1, *qkv, *attn, *xa, *y2, *hg;             // T
  float *stats1, *stats2, *astat, *dxo, *dxa, *dtmp, *dqkv, *h1, *wpart,
      *bpart, *lnpart;                               // fp32
  void *dyb, *dqkvb;  // bf16 only: T(dxo) or T(dxa), T(dqkv)
};

// total bytes; with `base` given, also the buffers' addresses
static size_t vit_bwd_carve(char* base, int G, int N, int C, int heads,
                            int hidden, size_t tsize, VitBwdBufs* b) {
  const size_t M = (size_t)G * N, f = sizeof(float);
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += align_up(bytes);
    return p;
  };
  b->y1 = take(M * C * tsize);
  b->qkv = take(M * 3 * C * tsize);
  b->attn = take(M * C * tsize);
  b->xa = take(M * C * tsize);
  b->y2 = take(M * C * tsize);
  b->hg = take(M * hidden * tsize);
  b->stats1 = (float*)take(2 * M * f);
  b->stats2 = (float*)take(2 * M * f);
  b->astat = (float*)take(3 * M * heads * f);
  b->dxo = (float*)take(M * C * f);
  b->dxa = (float*)take(M * C * f);
  b->dtmp = (float*)take(M * C * f);
  b->dqkv = (float*)take(M * 3 * C * f);
  b->h1 = (float*)take(M * hidden * f);
  const size_t S = dw_chunks((int)M);  // the dW GEMMs' chunks
  b->wpart = (float*)take(S * (size_t)C * (hidden > 3 * C ? hidden : 3 * C) * f);
  b->bpart = (float*)take(S * (size_t)(hidden > 3 * C ? hidden : 3 * C) * f);
  b->lnpart = (float*)take((size_t)lnb_blocks((int)M) * 2 * C * f);
  b->dyb = tsize == 2 ? take(M * C * tsize) : nullptr;
  b->dqkvb = tsize == 2 ? take(M * 3 * C * tsize) : nullptr;
  return off;
}

namespace tc {

// a fp32 cotangent dy (n values) as a product's operand: for bf16 T(dy),
// cast into `copy`; for fp32 dy itself
static const bf16* operand(const float* dy, bf16* copy, size_t n,
                           cudaStream_t st, cudaError_t* err) {
  from_f32_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(dy, copy,
                                                                      n);
  *err = cudaGetLastError();
  return copy;
}
static const float* operand(const float* dy, float*, size_t, cudaStream_t,
                            cudaError_t* err) {
  *err = cudaSuccess;
  return dy;
}

// grads: the 12 fp32 stacked gradients in STACK_FIELDS order; wsplit (fp32
// only): 2 split_floats(C, hidden, depth) floats for the weights' splits,
// the recompute's then dX's
template <typename E>
static cudaError_t vit_stack_bwd(const E* xs, const E* g, const float* ln1s,
                                 const float* ln1b, const E* qkvw,
                                 const float* qkvb, const E* projw,
                                 const float* projb, const float* ln2s,
                                 const float* ln2b, const E* fc1w,
                                 const float* fc1b, const E* fc2w,
                                 const float* fc2b, E* dx, float* const* gr,
                                 void* ws, float* wsplit, int G, int N,
                                 int C, int heads, int hidden, int depth,
                                 cudaStream_t st) {
  constexpr bool kBf16 = sizeof(E) == 2;
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  const int M = G * N;
  VitBwdBufs b;
  vit_bwd_carve((char*)ws, G, N, C, heads, hidden, sizeof(E), &b);
  E *y1 = (E*)b.y1, *qkv = (E*)b.qkv, *attn = (E*)b.attn, *xa = (E*)b.xa,
    *y2 = (E*)b.y2, *hg = (E*)b.hg, *dyb = (E*)b.dyb, *dqkvb = (E*)b.dqkvb;
  float *dln1s = gr[0], *dln1b = gr[1], *dqkvw = gr[2], *dqkvbias = gr[3],
        *dprojw = gr[4], *dprojb = gr[5], *dln2s = gr[6], *dln2b = gr[7],
        *dfc1w = gr[8], *dfc1b = gr[9], *dfc2w = gr[10], *dfc2b = gr[11];
  const size_t nMC = (size_t)M * C;
  cudaError_t err;
#define RP_CHECK(call)                 \
  if ((err = (call)) != cudaSuccess) { \
    return err;                        \
  }
  // the weights as the recompute's GEMMs (w*) and dX's (t*) take them
  StackWeight<E> wq, wp, w1, w2, tq, tp, t1, t2;
  RP_CHECK(stack_weights(qkvw, projw, fc1w, fc2w, C, hidden, depth, false,
                         wsplit, &wq, &wp, &w1, &w2, st));
  RP_CHECK(stack_weights(qkvw, projw, fc1w, fc2w, C, hidden, depth, true,
                         wsplit ? wsplit + split_floats(C, hidden, depth)
                                : wsplit,
                         &tq, &tp, &t1, &t2, st));
  to_f32_kernel<E><<<(unsigned)((nMC + 255) / 256), 256, 0, st>>>(g, b.dxo,
                                                                  nMC);
  RP_CHECK(cudaGetLastError());
  for (int i = depth - 1; i >= 0; --i) {
    const E* xin = xs + (size_t)i * nMC;
    const size_t cc = (size_t)C * C, hc = (size_t)hidden * C;
    // recompute block i's forward pieces
    RP_CHECK(launch_layernorm<E>(xin, nullptr, nullptr, nullptr, ln1s + i * C,
                                 ln1b + i * C, y1, b.stats1, M, N, C, st));
    RP_CHECK(stack_gemm<kBias>(y1, wq[i], qkvb + i * 3 * C, nullptr, qkv, M,
                               3 * C, C, st));
    RP_CHECK(launch_attention(qkv, attn, b.astat, G, N, C, heads, st));
    RP_CHECK(stack_gemm<kBiasResid>(attn, wp[i], projb + i * C, xin, xa, M, C,
                                    C, st));
    RP_CHECK(launch_layernorm<E>(xa, nullptr, nullptr, nullptr, ln2s + i * C,
                                 ln2b + i * C, y2, b.stats2, M, N, C, st));
    RP_CHECK(stack_gemm<kBiasGeluSplit>(y2, w1[i], fc1b + (size_t)i * hidden,
                                        nullptr, hg, M, hidden, C, st, b.h1));
    // MLP: x_out = xa + fc2(gelu(fc1(LN2(xa))))
    const E* dyo = operand(b.dxo, dyb, nMC, st, &err);
    RP_CHECK(err);
    RP_CHECK(stack_weight_grad(dyo, b.dxo, hg, dfc2w + i * hc, dfc2b + i * C,
                               b.wpart, b.bpart, M, C, hidden, st));
    // dh1 into h1 and, for bf16, T(dh1) into hg
    RP_CHECK(stack_gemm_dx<kDxGeluGrad>(dyo, t2[i], b.h1, b.h1,
                                        kBf16 ? hg : nullptr, M, hidden, C,
                                        st));
    const E* dh1;
    if constexpr (kBf16)
      dh1 = hg;
    else
      dh1 = b.h1;
    RP_CHECK(stack_weight_grad(dh1, b.h1, y2, dfc1w + i * hc,
                               dfc1b + (size_t)i * hidden, b.wpart, b.bpart, M,
                               hidden, C, st));
    RP_CHECK(stack_gemm_dx<kDxPlain>(dh1, t1[i], nullptr, b.dtmp, nullptr, M,
                                     C, hidden, st));
    RP_CHECK(layernorm_grad<E>(b.dtmp, xa, b.stats2, ln2s + i * C, b.dxo,
                               b.dxa, dln2s + i * C, dln2b + i * C, b.lnpart,
                               M, C, st));
    // attention: xa = x_in + proj(attention(qkv(LN1(x_in))))
    const E* dya = operand(b.dxa, dyb, nMC, st, &err);
    RP_CHECK(err);
    RP_CHECK(stack_weight_grad(dya, b.dxa, attn, dprojw + i * cc,
                               dprojb + i * C, b.wpart, b.bpart, M, C, C, st));
    RP_CHECK(stack_gemm_dx<kDxPlain>(dya, tp[i], nullptr, b.dtmp, nullptr, M,
                                     C, C, st));  // dattn
    // T(do / l) into attn and, for bf16, T(do) into dyb, both read for the
    // last time by proj's dW and dX above (the dq kernel reads o from attn
    // first)
    RP_CHECK(launch_attention_bwd(qkv, b.dtmp, b.astat, b.dqkv, dqkvb, dyb,
                                  attn, G, N, C, heads, st));
    const E* dq;
    if constexpr (kBf16)
      dq = dqkvb;
    else
      dq = b.dqkv;
    RP_CHECK(stack_weight_grad(dq, b.dqkv, y1, dqkvw + i * 3 * cc,
                               dqkvbias + i * 3 * C, b.wpart, b.bpart, M, 3 * C,
                               C, st));
    RP_CHECK(stack_gemm_dx<kDxPlain>(dq, tq[i], nullptr, b.dtmp, nullptr, M,
                                     C, 3 * C, st));
    RP_CHECK(layernorm_grad<E>(b.dtmp, xin, b.stats1, ln1s + i * C, b.dxa,
                               b.dxo, dln1s + i * C, dln1b + i * C, b.lnpart,
                               M, C, st));
  }
  from_f32_kernel<E><<<(unsigned)((nMC + 255) / 256), 256, 0, st>>>(
      b.dxo, dx, nMC);
#undef RP_CHECK
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rp

extern "C" long long rp_vit_stack_bwd_workspace(int G, int N, int C,
                                                int heads, int hidden,
                                                int bf16) {
  rp::VitBwdBufs b;
  return (long long)rp::vit_bwd_carve(nullptr, G, N, C, heads, hidden,
                                      bf16 ? 2 : 4, &b);
}

// xs, g, the 12 stacked parameters and the 12 fp32 gradients in
// STACK_FIELDS order (weights in T, vectors fp32), dx in T, the workspace,
// fp32's weight splits (2 split_floats(C, hidden, depth) floats, sized by
// ops/vit_stack.py; bf16: unused)
extern "C" int rp_vit_stack_bwd(
    const void* xs, const void* g, const float* ln1s, const float* ln1b,
    const void* qkvw, const float* qkvb, const void* projw,
    const float* projb, const float* ln2s, const float* ln2b,
    const void* fc1w, const float* fc1b, const void* fc2w, const float* fc2b,
    void* dx, float* dln1s, float* dln1b, float* dqkvw, float* dqkvb,
    float* dprojw, float* dprojb, float* dln2s, float* dln2b, float* dfc1w,
    float* dfc1b, float* dfc2w, float* dfc2b, void* ws, void* wsplit, int G,
    int N, int C, int heads, int hidden, int depth, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* const gr[12] = {dln1s, dln1b, dqkvw, dqkvb, dprojw, dprojb,
                         dln2s, dln2b, dfc1w, dfc1b, dfc2w, dfc2b};
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return rp::tc::vit_stack_bwd<T>(
        (const T*)xs, (const T*)g, ln1s, ln1b, (const T*)qkvw, qkvb,
        (const T*)projw, projb, ln2s, ln2b, (const T*)fc1w, fc1b,
        (const T*)fc2w, fc2b, (T*)dx, gr, ws, (float*)wsplit, G, N, C, heads,
        hidden, depth, st);
  };
  return bf16 ? run((__nv_bfloat16*)nullptr) : run((float*)nullptr);
}

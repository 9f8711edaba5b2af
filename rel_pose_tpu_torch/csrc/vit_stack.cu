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
//   (b) qkv GEMM, bias epilogue                        -> common.cuh
//   (c) attention per (sequence, head, 32-query tile)  -> attention.cuh
//   (b) proj GEMM, + residual epilogue (in place on the stream)
//   (a) LayerNorm, (b) fc1 GEMM + GELU, (b) fc2 GEMM + residual
//
// What bounds it on the H100: the GEMMs and the two attention products
// (about 0.76 GFLOP per sequence per block) run as SIMT fp32 FMAs fed from
// shared memory, not on the tensor cores, so instruction issue and shared-
// memory loads bound them.  Activations make one device-memory round trip
// per kernel (the bf16 MLP hidden is 453 MB at batch 256, about 0.3 ms at
// 3.35 TB/s), small next to the products.
//
// Attention: attention.cuh, with q, k, v read from the qkv GEMM's (G, N, 3C)
// output (InterleavedQkv).
//
// That is the fp32 route (SIMT: the tensor cores have no fp32 product).
// bf16 takes the tensor cores: the same chain with the GEMMs of
// gemm_tc.cuh and the attention of attention_tc.cuh (mma.sync m16n8k16,
// fp32 sums, the same rounding points), rp::tc below.

#include "attention.cuh"
#include "attention_tc.cuh"

namespace rp {

template <typename T>
static cudaError_t launch_vit_attention(const T* qkv, T* out, float* stats,
                                        int G, int N, int C, int heads,
                                        cudaStream_t stream) {
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  return launch_attention(InterleavedQkv<T>{qkv, out, nullptr, nullptr, N, C},
                          stats, G, heads, N, scale, stream);
}

// All `depth` blocks over x (G, N, C).  Stacked weights are (depth, out, in)
// in T; vectors are fp32.  `out` carries the residual stream and ends as the
// result; y (G*N, C), qkv (G*N, 3C), attn (G*N, C) and hid (G*N, hidden) are
// scratch.  With `stash` given (training), block i's input is also written
// to stash[i] (depth, G, N, C) by the LayerNorm that reads it, xs[0] after
// the positional add (pallas_vit.py:358-366); without it nothing extra is
// written.  Returns the first CUDA error, checked after every launch.
template <typename T>
static cudaError_t vit_stack(const T* x, const T* pos, T* out, T* stash,
                             const float* ln1s, const float* ln1b,
                             const T* qkvw, const float* qkvb, const T* projw,
                             const float* projb, const float* ln2s,
                             const float* ln2b, const T* fc1w,
                             const float* fc1b, const T* fc2w,
                             const float* fc2b, T* y, T* qkv, T* attn, T* hid,
                             int G, int N, int C, int heads, int hidden,
                             int depth, cudaStream_t st) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  const int M = G * N;
  cudaError_t err;
#define RP_CHECK(call)                 \
  if ((err = (call)) != cudaSuccess) { \
    return err;                        \
  }
  for (int i = 0; i < depth; ++i) {
    const size_t cc = (size_t)C * C;
    T* xcopy = stash ? stash + (size_t)i * M * C : nullptr;
    RP_CHECK(i == 0 ? launch_layernorm<T>(x, pos, out, xcopy, ln1s, ln1b, y,
                                          nullptr, M, N, C, st)
                    : launch_layernorm<T>(out, nullptr, nullptr, xcopy,
                                          ln1s + i * C, ln1b + i * C, y,
                                          nullptr, M, N, C, st));
    RP_CHECK((launch_gemm<T, kBias>(y, qkvw + i * 3 * cc, qkvb + i * 3 * C,
                                    nullptr, qkv, M, 3 * C, C, st)));
    RP_CHECK(launch_vit_attention<T>(qkv, attn, nullptr, G, N, C, heads, st));
    RP_CHECK((launch_gemm<T, kBiasResid>(attn, projw + i * cc,
                                         projb + i * C, out, out, M, C, C,
                                         st)));
    RP_CHECK(launch_layernorm<T>(out, nullptr, nullptr, nullptr, ln2s + i * C,
                                 ln2b + i * C, y, nullptr, M, N, C, st));
    RP_CHECK((launch_gemm<T, kBiasGelu>(y, fc1w + (size_t)i * hidden * C,
                                        fc1b + (size_t)i * hidden, nullptr,
                                        hid, M, hidden, C, st)));
    RP_CHECK((launch_gemm<T, kBiasResid>(hid, fc2w + (size_t)i * C * hidden,
                                         fc2b + i * C, out, out, M, C,
                                         hidden, st)));
  }
#undef RP_CHECK
  return cudaSuccess;
}

// The bf16 stack on the tensor cores: vit_stack's chain, launch for launch
namespace tc {

static cudaError_t vit_stack(const bf16* x, const bf16* pos, bf16* out,
                             bf16* stash, const float* ln1s,
                             const float* ln1b, const bf16* qkvw,
                             const float* qkvb, const bf16* projw,
                             const float* projb, const float* ln2s,
                             const float* ln2b, const bf16* fc1w,
                             const float* fc1b, const bf16* fc2w,
                             const float* fc2b, bf16* y, bf16* qkv, bf16* attn,
                             bf16* hid, int G, int N, int C, int heads,
                             int hidden, int depth, cudaStream_t st) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  const int M = G * N;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  cudaError_t err;
#define RP_CHECK(call)                 \
  if ((err = (call)) != cudaSuccess) { \
    return err;                        \
  }
  for (int i = 0; i < depth; ++i) {
    const size_t cc = (size_t)C * C;
    bf16* xcopy = stash ? stash + (size_t)i * M * C : nullptr;
    RP_CHECK(i == 0 ? launch_layernorm<bf16>(x, pos, out, xcopy, ln1s, ln1b,
                                             y, nullptr, M, N, C, st)
                    : launch_layernorm<bf16>(out, nullptr, nullptr, xcopy,
                                             ln1s + i * C, ln1b + i * C, y,
                                             nullptr, M, N, C, st));
    RP_CHECK(launch_gemm<kBias>(y, qkvw + i * 3 * cc, qkvb + i * 3 * C,
                                nullptr, qkv, M, 3 * C, C, st));
    RP_CHECK(launch_attention(qkv, attn, nullptr, G, N, C, heads, scale, st));
    RP_CHECK(launch_gemm<kBiasResid>(attn, projw + i * cc, projb + i * C, out,
                                     out, M, C, C, st));
    RP_CHECK(launch_layernorm<bf16>(out, nullptr, nullptr, nullptr,
                                    ln2s + i * C, ln2b + i * C, y, nullptr, M,
                                    N, C, st));
    RP_CHECK(launch_gemm<kBiasGelu>(y, fc1w + (size_t)i * hidden * C,
                                    fc1b + (size_t)i * hidden, nullptr, hid, M,
                                    hidden, C, st));
    RP_CHECK(launch_gemm<kBiasResid>(hid, fc2w + (size_t)i * C * hidden,
                                     fc2b + i * C, out, out, M, C, hidden,
                                     st));
  }
#undef RP_CHECK
  return cudaSuccess;
}

}  // namespace tc
}  // namespace rp

extern "C" int rp_vit_stack(const void* x, const void* pos, void* out,
                            void* stash, const float* ln1s, const float* ln1b,
                            const void* qkvw, const float* qkvb,
                            const void* projw, const float* projb,
                            const float* ln2s, const float* ln2b,
                            const void* fc1w, const float* fc1b,
                            const void* fc2w, const float* fc2b, void* y,
                            void* qkv, void* attn, void* hid, int G, int N,
                            int C, int heads, int hidden, int depth, int bf16,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::tc::vit_stack(
        (const T*)x, (const T*)pos, (T*)out, (T*)stash, ln1s, ln1b,
        (const T*)qkvw, qkvb, (const T*)projw, projb, ln2s, ln2b,
        (const T*)fc1w, fc1b, (const T*)fc2w, fc2b, (T*)y, (T*)qkv,
        (T*)attn, (T*)hid, G, N, C, heads, hidden, depth, st);
  }
  return rp::vit_stack<float>(
      (const float*)x, (const float*)pos, (float*)out, (float*)stash, ln1s,
      ln1b, (const float*)qkvw, qkvb, (const float*)projw, projb, ln2s, ln2b,
      (const float*)fc1w, fc1b, (const float*)fc2w, fc2b, (float*)y,
      (float*)qkv, (float*)attn, (float*)hid, G, N, C, heads, hidden, depth,
      st);
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
//     flash-attention-2 split: one kernel per (sequence, head, 32-query
//     tile) forms dq, another per (sequence, head, 64-key tile) walks the
//     query tiles for dk and dv.
// The residual cotangent stays fp32 between kernels, as in VMEM.
//
// What bounds it on the H100: the products, all SIMT fp32 FMAs (about 2.8x
// the forward's: recompute, dX and dW for each GEMM; 7 N x N x 64 products
// for attention against the forward's 2).  Device memory traffic is the
// stash, one round trip of each activation per kernel, and the dW
// partials, tens of MB per block, below a millisecond at 3.35 TB/s.

namespace rp {

// dq, dk, dv of every head into dqkv (G*N, 3C) fp32, from the forward's
// qkv and row stats and dattn (G*N, C) fp32
template <typename T>
static cudaError_t launch_vit_attention_bwd(const T* qkv, const float* dattn,
                                            float* stats, float* dqkv, int G,
                                            int N, int C, int heads,
                                            cudaStream_t stream) {
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  return launch_attention_bwd(
      InterleavedQkv<T>{qkv, nullptr, dattn, dqkv, N, C}, stats, G, heads, N,
      scale, stream);
}

static size_t align_up(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// the backward's scratch, carved from one workspace in this order
struct VitBwdBufs {
  void *y1, *qkv, *attn, *xa, *y2, *hg;             // T
  float *stats1, *stats2, *astat, *dxo, *dxa, *dtmp, *dqkv, *h1, *wpart,
      *bpart, *lnpart;                               // fp32
  void *dyb, *dqkvb;  // bf16 only (rp::tc): T(dxo) or T(dxa), T(dqkv)
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
  // the dW chunks of common.cuh (fp32) or of gemm_tc.cuh (bf16)
  const size_t S =
      tsize == 2 ? tc::dw_chunks_tc((int)M) : dw_chunks((int)M);
  b->wpart = (float*)take(S * (size_t)C * (hidden > 3 * C ? hidden : 3 * C) * f);
  b->bpart = (float*)take(S * (size_t)(hidden > 3 * C ? hidden : 3 * C) * f);
  b->lnpart = (float*)take((size_t)lnb_blocks((int)M) * 2 * C * f);
  b->dyb = tsize == 2 ? take(M * C * tsize) : nullptr;
  b->dqkvb = tsize == 2 ? take(M * 3 * C * tsize) : nullptr;
  return off;
}

// grads: the 12 fp32 stacked gradients in STACK_FIELDS order
template <typename T>
static cudaError_t vit_stack_bwd(const T* xs, const T* g, const float* ln1s,
                                 const float* ln1b, const T* qkvw,
                                 const float* qkvb, const T* projw,
                                 const float* projb, const float* ln2s,
                                 const float* ln2b, const T* fc1w,
                                 const float* fc1b, const T* fc2w,
                                 const float* fc2b, T* dx, float* const* gr,
                                 void* ws, int G, int N, int C, int heads,
                                 int hidden, int depth, cudaStream_t st) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  const int M = G * N;
  VitBwdBufs b;
  vit_bwd_carve((char*)ws, G, N, C, heads, hidden, sizeof(T), &b);
  T *y1 = (T*)b.y1, *qkv = (T*)b.qkv, *attn = (T*)b.attn, *xa = (T*)b.xa,
    *y2 = (T*)b.y2, *hg = (T*)b.hg;
  float *dln1s = gr[0], *dln1b = gr[1], *dqkvw = gr[2], *dqkvb = gr[3],
        *dprojw = gr[4], *dprojb = gr[5], *dln2s = gr[6], *dln2b = gr[7],
        *dfc1w = gr[8], *dfc1b = gr[9], *dfc2w = gr[10], *dfc2b = gr[11];
  const size_t nMC = (size_t)M * C;
  cudaError_t err;
#define RP_CHECK(call)                 \
  if ((err = (call)) != cudaSuccess) { \
    return err;                        \
  }
  to_f32_kernel<T><<<(unsigned)((nMC + 255) / 256), 256, 0, st>>>(g, b.dxo,
                                                                  nMC);
  RP_CHECK(cudaGetLastError());
  for (int i = depth - 1; i >= 0; --i) {
    const T* xin = xs + (size_t)i * nMC;
    const size_t cc = (size_t)C * C, hc = (size_t)hidden * C;
    // recompute block i's forward pieces
    RP_CHECK(launch_layernorm<T>(xin, nullptr, nullptr, nullptr, ln1s + i * C,
                                 ln1b + i * C, y1, b.stats1, M, N, C, st));
    RP_CHECK((launch_gemm<T, kBias>(y1, qkvw + i * 3 * cc, qkvb + i * 3 * C,
                                    nullptr, qkv, M, 3 * C, C, st)));
    RP_CHECK(launch_vit_attention<T>(qkv, attn, b.astat, G, N, C, heads, st));
    RP_CHECK((launch_gemm<T, kBiasResid>(attn, projw + i * cc, projb + i * C,
                                         xin, xa, M, C, C, st)));
    RP_CHECK(launch_layernorm<T>(xa, nullptr, nullptr, nullptr, ln2s + i * C,
                                 ln2b + i * C, y2, b.stats2, M, N, C, st));
    RP_CHECK((launch_gemm<T, kBiasGeluSplit>(y2, fc1w + i * hc,
                                             fc1b + (size_t)i * hidden,
                                             nullptr, hg, M, hidden, C, st,
                                             b.h1)));
    // MLP: x_out = xa + fc2(gelu(fc1(LN2(xa))))
    RP_CHECK(weight_grad<T>(b.dxo, hg, dfc2w + i * hc, dfc2b + i * C, b.wpart,
                            b.bpart, M, C, hidden, st));
    RP_CHECK((launch_gemm_dx<T, kDxGeluGrad>(b.dxo, fc2w + i * hc, b.h1, b.h1,
                                             M, hidden, C, st)));  // dh1
    RP_CHECK(weight_grad<T>(b.h1, y2, dfc1w + i * hc,
                            dfc1b + (size_t)i * hidden, b.wpart, b.bpart, M,
                            hidden, C, st));
    RP_CHECK((launch_gemm_dx<T, kDxPlain>(b.h1, fc1w + i * hc, nullptr,
                                          b.dtmp, M, C, hidden, st)));
    RP_CHECK(layernorm_grad<T>(b.dtmp, xa, b.stats2, ln2s + i * C, b.dxo,
                               b.dxa, dln2s + i * C, dln2b + i * C, b.lnpart,
                               M, C, st));
    // attention: xa = x_in + proj(attention(qkv(LN1(x_in))))
    RP_CHECK(weight_grad<T>(b.dxa, attn, dprojw + i * cc, dprojb + i * C,
                            b.wpart, b.bpart, M, C, C, st));
    RP_CHECK((launch_gemm_dx<T, kDxPlain>(b.dxa, projw + i * cc, nullptr,
                                          b.dtmp, M, C, C, st)));  // dattn
    RP_CHECK(launch_vit_attention_bwd<T>(qkv, b.dtmp, b.astat, b.dqkv, G, N,
                                         C, heads, st));
    RP_CHECK(weight_grad<T>(b.dqkv, y1, dqkvw + i * 3 * cc, dqkvb + i * 3 * C,
                            b.wpart, b.bpart, M, 3 * C, C, st));
    RP_CHECK((launch_gemm_dx<T, kDxPlain>(b.dqkv, qkvw + i * 3 * cc, nullptr,
                                          b.dtmp, M, C, 3 * C, st)));
    RP_CHECK(layernorm_grad<T>(b.dtmp, xin, b.stats1, ln1s + i * C, b.dxa,
                               b.dxo, dln1s + i * C, dln1b + i * C, b.lnpart,
                               M, C, st));
  }
  from_f32_kernel<T><<<(unsigned)((nMC + 255) / 256), 256, 0, st>>>(b.dxo, dx,
                                                                    nMC);
#undef RP_CHECK
  return cudaGetLastError();
}

namespace tc {

// T(in) of n values into out
static cudaError_t cast_bf16(const float* in, bf16* out, size_t n,
                             cudaStream_t st) {
  from_f32_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(in, out,
                                                                      n);
  return cudaGetLastError();
}

// The bf16 backward on the tensor cores: rp::vit_stack_bwd's chain with
// the GEMMs and attention of gemm_tc.cuh / attention_tc.cuh.  A fp32
// cotangent enters the products as its bf16 copy: T(dxo) and T(dxa) cast
// into dyb, T(dh1) written by the fc2 dX epilogue into hg (free once fc2's
// dW has read it), T(dqkv) by the attention backward into dqkvb.
static cudaError_t vit_stack_bwd(const bf16* xs, const bf16* g,
                                 const float* ln1s, const float* ln1b,
                                 const bf16* qkvw, const float* qkvb,
                                 const bf16* projw, const float* projb,
                                 const float* ln2s, const float* ln2b,
                                 const bf16* fc1w, const float* fc1b,
                                 const bf16* fc2w, const float* fc2b,
                                 bf16* dx, float* const* gr, void* ws, int G,
                                 int N, int C, int heads, int hidden,
                                 int depth, cudaStream_t st) {
  if (C != heads * kHeadDim) return cudaErrorInvalidValue;
  const int M = G * N;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  VitBwdBufs b;
  vit_bwd_carve((char*)ws, G, N, C, heads, hidden, sizeof(bf16), &b);
  bf16 *y1 = (bf16*)b.y1, *qkv = (bf16*)b.qkv, *attn = (bf16*)b.attn,
       *xa = (bf16*)b.xa, *y2 = (bf16*)b.y2, *hg = (bf16*)b.hg,
       *dyb = (bf16*)b.dyb, *dqkvb = (bf16*)b.dqkvb;
  float *dln1s = gr[0], *dln1b = gr[1], *dqkvw = gr[2], *dqkvbias = gr[3],
        *dprojw = gr[4], *dprojb = gr[5], *dln2s = gr[6], *dln2b = gr[7],
        *dfc1w = gr[8], *dfc1b = gr[9], *dfc2w = gr[10], *dfc2b = gr[11];
  const size_t nMC = (size_t)M * C;
  cudaError_t err;
#define RP_CHECK(call)                 \
  if ((err = (call)) != cudaSuccess) { \
    return err;                        \
  }
  to_f32_kernel<bf16><<<(unsigned)((nMC + 255) / 256), 256, 0, st>>>(
      g, b.dxo, nMC);
  RP_CHECK(cudaGetLastError());
  for (int i = depth - 1; i >= 0; --i) {
    const bf16* xin = xs + (size_t)i * nMC;
    const size_t cc = (size_t)C * C, hc = (size_t)hidden * C;
    // recompute block i's forward pieces
    RP_CHECK(launch_layernorm<bf16>(xin, nullptr, nullptr, nullptr,
                                    ln1s + i * C, ln1b + i * C, y1, b.stats1,
                                    M, N, C, st));
    RP_CHECK(launch_gemm<kBias>(y1, qkvw + i * 3 * cc, qkvb + i * 3 * C,
                                nullptr, qkv, M, 3 * C, C, st));
    RP_CHECK(launch_attention(qkv, attn, b.astat, G, N, C, heads, scale, st));
    RP_CHECK(launch_gemm<kBiasResid>(attn, projw + i * cc, projb + i * C, xin,
                                     xa, M, C, C, st));
    RP_CHECK(launch_layernorm<bf16>(xa, nullptr, nullptr, nullptr,
                                    ln2s + i * C, ln2b + i * C, y2, b.stats2,
                                    M, N, C, st));
    RP_CHECK(launch_gemm<kBiasGeluSplit>(y2, fc1w + i * hc,
                                         fc1b + (size_t)i * hidden, nullptr,
                                         hg, M, hidden, C, st, b.h1));
    // MLP: x_out = xa + fc2(gelu(fc1(LN2(xa))))
    RP_CHECK(cast_bf16(b.dxo, dyb, nMC, st));
    RP_CHECK(weight_grad(dyb, b.dxo, hg, dfc2w + i * hc, dfc2b + i * C,
                         b.wpart, b.bpart, M, C, hidden, st));
    RP_CHECK(launch_gemm_dx<kDxGeluGrad>(dyb, fc2w + i * hc, b.h1, b.h1, hg,
                                         M, hidden, C, st));  // dh1, T(dh1)
    RP_CHECK(weight_grad(hg, b.h1, y2, dfc1w + i * hc,
                         dfc1b + (size_t)i * hidden, b.wpart, b.bpart, M,
                         hidden, C, st));
    RP_CHECK(launch_gemm_dx<kDxPlain>(hg, fc1w + i * hc, nullptr, b.dtmp,
                                      nullptr, M, C, hidden, st));
    RP_CHECK(layernorm_grad<bf16>(b.dtmp, xa, b.stats2, ln2s + i * C, b.dxo,
                                  b.dxa, dln2s + i * C, dln2b + i * C,
                                  b.lnpart, M, C, st));
    // attention: xa = x_in + proj(attention(qkv(LN1(x_in))))
    RP_CHECK(cast_bf16(b.dxa, dyb, nMC, st));
    RP_CHECK(weight_grad(dyb, b.dxa, attn, dprojw + i * cc, dprojb + i * C,
                         b.wpart, b.bpart, M, C, C, st));
    RP_CHECK(launch_gemm_dx<kDxPlain>(dyb, projw + i * cc, nullptr, b.dtmp,
                                      nullptr, M, C, C, st));  // dattn
    // T(do) and T(do / l) into dyb and attn, both read for the last time
    // by proj's dW and dX above
    RP_CHECK(launch_attention_bwd(qkv, b.dtmp, b.astat, b.dqkv, dqkvb, dyb,
                                  attn, G, N, C, heads, scale, st));
    RP_CHECK(weight_grad(dqkvb, b.dqkv, y1, dqkvw + i * 3 * cc,
                         dqkvbias + i * 3 * C, b.wpart, b.bpart, M, 3 * C, C,
                         st));
    RP_CHECK(launch_gemm_dx<kDxPlain>(dqkvb, qkvw + i * 3 * cc, nullptr,
                                      b.dtmp, nullptr, M, C, 3 * C, st));
    RP_CHECK(layernorm_grad<bf16>(b.dtmp, xin, b.stats1, ln1s + i * C, b.dxa,
                                  b.dxo, dln1s + i * C, dln1b + i * C,
                                  b.lnpart, M, C, st));
  }
  from_f32_kernel<bf16><<<(unsigned)((nMC + 255) / 256), 256, 0, st>>>(
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
// STACK_FIELDS order (weights in T, vectors fp32), dx in T, the workspace
extern "C" int rp_vit_stack_bwd(
    const void* xs, const void* g, const float* ln1s, const float* ln1b,
    const void* qkvw, const float* qkvb, const void* projw,
    const float* projb, const float* ln2s, const float* ln2b,
    const void* fc1w, const float* fc1b, const void* fc2w, const float* fc2b,
    void* dx, float* dln1s, float* dln1b, float* dqkvw, float* dqkvb,
    float* dprojw, float* dprojb, float* dln2s, float* dln2b, float* dfc1w,
    float* dfc1b, float* dfc2w, float* dfc2b, void* ws, int G, int N, int C,
    int heads, int hidden, int depth, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* const gr[12] = {dln1s, dln1b, dqkvw, dqkvb, dprojw, dprojb,
                         dln2s, dln2b, dfc1w, dfc1b, dfc2w, dfc2b};
  if (bf16) {
    using T = __nv_bfloat16;
    return rp::tc::vit_stack_bwd(
        (const T*)xs, (const T*)g, ln1s, ln1b, (const T*)qkvw, qkvb,
        (const T*)projw, projb, ln2s, ln2b, (const T*)fc1w, fc1b,
        (const T*)fc2w, fc2b, (T*)dx, gr, ws, G, N, C, heads, hidden, depth,
        st);
  }
  return rp::vit_stack_bwd<float>(
      (const float*)xs, (const float*)g, ln1s, ln1b, (const float*)qkvw,
      qkvb, (const float*)projw, projb, ln2s, ln2b, (const float*)fc1w, fc1b,
      (const float*)fc2w, fc2b, (float*)dx, gr, ws, G, N, C, heads, hidden,
      depth, st);
}

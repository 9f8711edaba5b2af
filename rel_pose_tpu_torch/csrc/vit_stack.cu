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
//   (c) attention per (sequence, head, 32-query tile)  -> below
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
// Attention design: the 576 x 576 fp32 score matrix of one head (1.33 MB)
// does not fit in shared memory, so each CUDA block takes 32 query rows and
// keeps their full 32 x N score rows (74 KB at N = 576): the row max and
// sum are then exact, as in the Pallas kernel, with no online rescaling.
// Scores are s = (q . k) * d^-1/2 * log2(e) in fp32, P = exp2(s - max)
// rounded to T, o = (P . v) / sum(exp2(s - max)), rounded to T.

#include "common.cuh"

namespace rp {

constexpr int kHeadDim = 64;  // the model's head width (192 / 3 heads)
constexpr int kQT = 32;       // query rows per CUDA block
constexpr int kKT = 64;       // key rows per shared-memory tile
constexpr int kAttnThreads = 256;
static_assert(kQT == 4 * (kAttnThreads / 32) && kKT == 64 && kHeadDim == 64,
              "register tiles: 8 warps x 4 rows, 32 lanes x 2 columns");
static_assert(kQT * kHeadDim % kAttnThreads == 0 &&
                  kKT * kHeadDim % kAttnThreads == 0,
              "tile loads: whole unrolled steps");

static size_t attention_smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)kQT * N + kQT * kHeadDim + kKT * (kHeadDim + 1) + kQT);
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
vit_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                     float* __restrict__ stats, int N, int C, float scale) {
  // stats, when given: each query row's (max, sum) of its exp2 row, at
  // [((g * heads + h) * N + row) * 3], for the backward
  extern __shared__ float smem[];
  float* S = smem;                             // [kQT][N]
  float* Qs = S + (size_t)kQT * N;             // [kQT][kHeadDim]
  float* KVs = Qs + kQT * kHeadDim;            // [kKT][kHeadDim + 1]
  float* linv = KVs + kKT * (kHeadDim + 1);    // [kQT]
  constexpr int LD = kHeadDim + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, g = blockIdx.z;
  const int rows = min(kQT, N - q0);
  const size_t C3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)g * N * C3;

  // Tile loads run a compile-time number of unrolled steps, so a tile's
  // global loads are all in flight at once (a runtime-bounded loop waits
  // out one L2 round trip per element).
#pragma unroll
  for (int u = 0; u < kQT * kHeadDim / kAttnThreads; ++u) {
    const int idx = tid + u * kAttnThreads;
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    Qs[idx] = r < rows ? to_f32(base[(q0 + r) * C3 + h * kHeadDim + c]) : 0.f;
  }
  // Register tiles: warp w owns query rows 4w .. 4w+3 (their shared-memory
  // loads are warp broadcasts), lane l the columns l and l + 32 -- 0.75
  // shared-memory loads per FMA.  Scores: columns are the tile's keys.
  const int wr = warp * 4;
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kKT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      KVs[r * LD + c] =
          k0 + r < N ? to_f32(base[(k0 + r) * C3 + C + h * kHeadDim + c])
                     : 0.f;
    }
    __syncthreads();
    float acc[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float k_lo = KVs[lane * LD + c], k_hi = KVs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float q = Qs[(wr + r) * kHeadDim + c];
        acc[r][0] = fmaf(q, k_lo, acc[r][0]);
        acc[r][1] = fmaf(q, k_hi, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (k0 + lane + 32 * s < N)
          S[(size_t)(wr + r) * N + k0 + lane + 32 * s] = acc[r][s] * scale;
  }
  __syncthreads();
  // exact row softmax statistics, one warp per row; P rounded to T in place
  for (int i = warp; i < kQT; i += kAttnThreads / 32) {
    float* row = S + (size_t)i * N;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = exp2f(row[j] - m);
      l += e;
      row[j] = round_to<T>(e);
    }
    l = warp_sum(l);
    if (lane == 0) {
      linv[i] = 1.f / l;
      if (stats && i < rows) {
        float* st = stats + (((size_t)g * gridDim.y + h) * N + q0 + i) * 3;
        st[0] = m;
        st[1] = l;
      }
    }
  }
  // o = P . v, same register tiles: columns are head columns
  float o[4][2] = {};
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kKT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      KVs[r * LD + c] =
          k0 + r < N
              ? to_f32(base[(k0 + r) * C3 + 2 * C + h * kHeadDim + c])
              : 0.f;
    }
    __syncthreads();
    const int kn = min(kKT, N - k0);
    for (int j = 0; j < kn; ++j) {
      const float v_lo = KVs[j * LD + lane], v_hi = KVs[j * LD + lane + 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = S[(size_t)(wr + r) * N + k0 + j];
        o[r][0] = fmaf(p, v_lo, o[r][0]);
        o[r][1] = fmaf(p, v_hi, o[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = wr + r;
    if (i < rows)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        out[((size_t)g * N + q0 + i) * C + h * kHeadDim + lane + 32 * s] =
            from_f32<T>(o[r][s] * linv[i]);
  }
}

template <typename T>
static cudaError_t launch_vit_attention(const T* qkv, T* out, float* stats,
                                        int G, int N, int C, int heads,
                                        cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory: two 99 KB blocks per SM
  err = cudaFuncSetAttribute(vit_attention_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  dim3 grid((N + kQT - 1) / kQT, heads, G);
  vit_attention_kernel<T><<<grid, kAttnThreads, smem, stream>>>(
      qkv, out, stats, N, C, scale);
  return cudaGetLastError();
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
    return rp::vit_stack<T>(
        (const T*)x, (const T*)pos, (T*)out, (T*)stash, ln1s, ln1b,
        (const T*)qkvw, qkvb, (const T*)projw, projb, ln2s, ln2b, (const T*)fc1w, fc1b,
        (const T*)fc2w, fc2b, (T*)y, (T*)qkv, (T*)attn, (T*)hid, G, N, C,
        heads, hidden, depth, st);
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

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKB = 64;  // keys per dk / dv block

static size_t attn_dq_smem_bytes(int N) {
  return sizeof(float) * (2 * (size_t)kQT * N + 2 * kQT * kHeadDim +
                          kKT * (kHeadDim + 1) + 3 * kQT);
}

static size_t attn_dkv_smem_bytes() {
  return sizeof(float) * (2 * kKB * (kHeadDim + 1) + 3 * kQT * kHeadDim +
                          2 * kQT * (kKB + 1) + 3 * kQT);
}

// dq for 32 query rows of one (sequence, head), after _attn_bwd_heads
// (pallas_vit_bwd.py:116-146): e = exp2(s - m) recomputed exactly as the
// forward forms it, dp = T(do) . v^T, c = rowsum(dp * e) / l,
// ds = T(e ((dp - c) / l) ln2 d^-1/2 log2e), dq = ds . k.  The 32 x N rows
// of e and dp stay in shared memory (147 KB at N = 576); c goes to
// stats[.., 2] for the dk / dv kernel.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
vit_attn_bwd_dq_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ dattn,
                       float* __restrict__ stats, float* __restrict__ dqkv,
                       int N, int C, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = kHeadDim + 1;
  float* E = smem;                            // [kQT][N]
  float* DP = E + (size_t)kQT * N;            // [kQT][N]: dp, then T(ds)
  float* Qs = DP + (size_t)kQT * N;           // [kQT][64]
  float* DOs = Qs + kQT * kHeadDim;           // [kQT][64]: T(do)
  float* KVs = DOs + kQT * kHeadDim;          // [kKT][LD]
  float* mrow = KVs + kKT * LD;               // [kQT]
  float* lrow = mrow + kQT;                   // [kQT]
  float* crow = lrow + kQT;                   // [kQT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, g = blockIdx.z;
  const int rows = min(kQT, N - q0);
  const size_t C3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)g * N * C3;
  const float* dob = dattn + (size_t)g * N * C;
  float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;

#pragma unroll
  for (int u = 0; u < kQT * kHeadDim / kAttnThreads; ++u) {
    const int idx = tid + u * kAttnThreads;
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    const bool ok = r < rows;
    Qs[idx] = ok ? to_f32(base[(q0 + r) * C3 + h * kHeadDim + c]) : 0.f;
    DOs[idx] =
        ok ? round_to<T>(dob[(size_t)(q0 + r) * C + h * kHeadDim + c]) : 0.f;
  }
  if (tid < kQT) {
    const bool ok = tid < rows;
    mrow[tid] = ok ? st[(size_t)(q0 + tid) * 3] : 0.f;
    lrow[tid] = ok ? st[(size_t)(q0 + tid) * 3 + 1] : 1.f;
  }
  const int wr = warp * 4;
  auto load_tile = [&](int k0, int off) {  // off: C for k, 2C for v
#pragma unroll
    for (int u = 0; u < kKT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      KVs[r * LD + c] =
          k0 + r < N ? to_f32(base[(k0 + r) * C3 + off + h * kHeadDim + c])
                     : 0.f;
    }
  };
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
    load_tile(k0, C);
    __syncthreads();
    float acc[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float k_lo = KVs[lane * LD + c], k_hi = KVs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float q = Qs[(wr + r) * kHeadDim + c];
        acc[r][0] = fmaf(q, k_lo, acc[r][0]);
        acc[r][1] = fmaf(q, k_hi, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (k0 + lane + 32 * s < N)
          E[(size_t)(wr + r) * N + k0 + lane + 32 * s] =
              exp2f(acc[r][s] * scale - mrow[wr + r]);
    __syncthreads();
    load_tile(k0, 2 * C);
    __syncthreads();
    float dp[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float v_lo = KVs[lane * LD + c], v_hi = KVs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = DOs[(wr + r) * kHeadDim + c];
        dp[r][0] = fmaf(d, v_lo, dp[r][0]);
        dp[r][1] = fmaf(d, v_hi, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (k0 + lane + 32 * s < N)
          DP[(size_t)(wr + r) * N + k0 + lane + 32 * s] = dp[r][s];
  }
  __syncthreads();
  for (int i = warp; i < kQT; i += kAttnThreads / 32) {
    const float* er = E + (size_t)i * N;
    const float* dr = DP + (size_t)i * N;
    float t = 0.f;
    for (int j = lane; j < N; j += 32) t += dr[j] * er[j];
    t = warp_sum(t);
    if (lane == 0) {
      const float c = t / lrow[i];
      crow[i] = c;
      if (i < rows) st[(size_t)(q0 + i) * 3 + 2] = c;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kQT * N; idx += kAttnThreads) {
    const int i = idx / N;
    DP[idx] = round_to<T>(E[idx] * ((DP[idx] - crow[i]) / lrow[i]) * kLn2 *
                          scale);
  }
  float dq[4][2] = {};
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();
    load_tile(k0, C);
    __syncthreads();
    const int kn = min(kKT, N - k0);
    for (int j = 0; j < kn; ++j) {
      const float k_lo = KVs[j * LD + lane], k_hi = KVs[j * LD + lane + 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = DP[(size_t)(wr + r) * N + k0 + j];
        dq[r][0] = fmaf(ds, k_lo, dq[r][0]);
        dq[r][1] = fmaf(ds, k_hi, dq[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = wr + r;
    if (i < rows)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        dqkv[((size_t)g * N + q0 + i) * C3 + h * kHeadDim + lane + 32 * s] =
            dq[r][s];
  }
}

// dk and dv for 64 keys of one (sequence, head): walks the query tiles,
// recomputes e and dp with the same arithmetic as the dq kernel (so the
// same bits), reads c from stats, and accumulates in registers
// dv += T(e)^T . T(do / l) and dk += ds^T . q over all N queries.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
vit_attn_bwd_dkv_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ dattn,
                        const float* __restrict__ stats,
                        float* __restrict__ dqkv, int N, int C, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = kHeadDim + 1, PLD = kKB + 1;
  float* Ks = smem;                   // [kKB][LD]
  float* Vs = Ks + kKB * LD;          // [kKB][LD]
  float* Qs = Vs + kKB * LD;          // [kQT][64]
  float* DOr = Qs + kQT * kHeadDim;   // [kQT][64]: T(do)
  float* DOn = DOr + kQT * kHeadDim;  // [kQT][64]: T(do / l)
  float* P = DOn + kQT * kHeadDim;    // [kQT][PLD]: T(e)
  float* DS = P + kQT * PLD;          // [kQT][PLD]: T(ds)
  float* mrow = DS + kQT * PLD;       // [kQT]
  float* lrow = mrow + kQT;           // [kQT]
  float* crow = lrow + kQT;           // [kQT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kKB, h = blockIdx.y, g = blockIdx.z;
  const int kn = min(kKB, N - k0);
  const size_t C3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)g * N * C3;
  const float* dob = dattn + (size_t)g * N * C;
  const float* st = stats + ((size_t)g * gridDim.y + h) * N * 3;

#pragma unroll
  for (int u = 0; u < kKB * kHeadDim / kAttnThreads; ++u) {
    const int idx = tid + u * kAttnThreads;
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    const bool ok = r < kn;
    const T* row = base + (k0 + r) * C3 + h * kHeadDim + c;
    Ks[r * LD + c] = ok ? to_f32(row[C]) : 0.f;
    Vs[r * LD + c] = ok ? to_f32(row[2 * C]) : 0.f;
  }
  const int wr = warp * 4;  // score rows (queries) of this warp
  const int wk = warp * 8;  // dk / dv rows (keys) of this warp
  float dk[8][2] = {}, dv[8][2] = {};
  for (int q0 = 0; q0 < N; q0 += kQT) {
    const int rows = min(kQT, N - q0);
    __syncthreads();
    if (tid < kQT) {
      const bool ok = tid < rows;
      const float* sr = st + (size_t)(q0 + tid) * 3;
      mrow[tid] = ok ? sr[0] : 0.f;
      lrow[tid] = ok ? sr[1] : 1.f;
      crow[tid] = ok ? sr[2] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kQT * kHeadDim / kAttnThreads; ++u) {
      const int idx = tid + u * kAttnThreads;
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      const bool ok = r < rows;
      Qs[idx] = ok ? to_f32(base[(q0 + r) * C3 + h * kHeadDim + c]) : 0.f;
      const float d = ok ? dob[(size_t)(q0 + r) * C + h * kHeadDim + c] : 0.f;
      DOr[idx] = round_to<T>(d);
      DOn[idx] = round_to<T>(d / lrow[r]);
    }
    __syncthreads();
    float sc[4][2] = {}, dp[4][2] = {};
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) {
      const float k_lo = Ks[lane * LD + c], k_hi = Ks[(lane + 32) * LD + c];
      const float v_lo = Vs[lane * LD + c], v_hi = Vs[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float q = Qs[(wr + r) * kHeadDim + c];
        const float d = DOr[(wr + r) * kHeadDim + c];
        sc[r][0] = fmaf(q, k_lo, sc[r][0]);
        sc[r][1] = fmaf(q, k_hi, sc[r][1]);
        dp[r][0] = fmaf(d, v_lo, dp[r][0]);
        dp[r][1] = fmaf(d, v_hi, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = wr + r;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = lane + 32 * s;
        const bool ok = i < rows && j < kn;
        const float e = exp2f(sc[r][s] * scale - mrow[i]);
        P[i * PLD + j] = ok ? round_to<T>(e) : 0.f;
        DS[i * PLD + j] =
            ok ? round_to<T>(e * ((dp[r][s] - crow[i]) / lrow[i]) * kLn2 *
                             scale)
               : 0.f;
      }
    }
    __syncthreads();
    for (int i = 0; i < kQT; ++i) {
      const float don0 = DOn[i * kHeadDim + lane];
      const float don1 = DOn[i * kHeadDim + lane + 32];
      const float qv0 = Qs[i * kHeadDim + lane];
      const float qv1 = Qs[i * kHeadDim + lane + 32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = P[i * PLD + wk + jj], ds = DS[i * PLD + wk + jj];
        dv[jj][0] = fmaf(p, don0, dv[jj][0]);
        dv[jj][1] = fmaf(p, don1, dv[jj][1]);
        dk[jj][0] = fmaf(ds, qv0, dk[jj][0]);
        dk[jj][1] = fmaf(ds, qv1, dk[jj][1]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (wk + jj >= kn) continue;
    float* row = dqkv + ((size_t)g * N + k0 + wk + jj) * C3 + h * kHeadDim;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      row[C + lane + 32 * s] = dk[jj][s];
      row[2 * C + lane + 32 * s] = dv[jj][s];
    }
  }
}

// dq, dk, dv of every head into dqkv (G*N, 3C) fp32, from the forward's
// qkv and row stats and dattn (G*N, C) fp32
template <typename T>
static cudaError_t launch_vit_attention_bwd(const T* qkv, const float* dattn,
                                            float* stats, float* dqkv, int G,
                                            int N, int C, int heads,
                                            cudaStream_t stream) {
  const float scale = 0.125f * 1.4426950408889634f;  // 64^-1/2 * log2(e)
  const size_t smem_q = attn_dq_smem_bytes(N), smem_kv = attn_dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      vit_attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vit_attn_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  vit_attn_bwd_dq_kernel<T>
      <<<dim3((N + kQT - 1) / kQT, heads, G), kAttnThreads, smem_q, stream>>>(
          qkv, dattn, stats, dqkv, N, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vit_attn_bwd_dkv_kernel<T>
      <<<dim3((N + kKB - 1) / kKB, heads, G), kAttnThreads, smem_kv, stream>>>(
          qkv, dattn, stats, dqkv, N, C, scale);
  return cudaGetLastError();
}

static size_t align_up(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// the backward's scratch, carved from one workspace in this order
struct VitBwdBufs {
  void *y1, *qkv, *attn, *xa, *y2, *hg;             // T
  float *stats1, *stats2, *astat, *dxo, *dxa, *dtmp, *dqkv, *h1, *wpart,
      *bpart, *lnpart;                               // fp32
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
  const size_t S = dw_chunks((int)M);
  b->wpart = (float*)take(S * (size_t)C * (hidden > 3 * C ? hidden : 3 * C) * f);
  b->bpart = (float*)take(S * (size_t)(hidden > 3 * C ? hidden : 3 * C) * f);
  b->lnpart = (float*)take((size_t)lnb_blocks((int)M) * 2 * C * f);
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
    return rp::vit_stack_bwd<T>(
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

// Hand kernels for the fusion transformer's self-attention block stack.
//
// Replaces: rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel (forward, no
// stash).  The Pallas kernel runs every block of one sequence inside one
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
vit_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N,
                     int C, float scale) {
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
    if (lane == 0) linv[i] = 1.f / l;
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
static cudaError_t launch_vit_attention(const T* qkv, T* out, int G, int N,
                                        int C, int heads, cudaStream_t stream) {
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
  vit_attention_kernel<T><<<grid, kAttnThreads, smem, stream>>>(qkv, out, N,
                                                                C, scale);
  return cudaGetLastError();
}

// All `depth` blocks over x (G, N, C).  Stacked weights are (depth, out, in)
// in T; vectors are fp32.  `out` carries the residual stream and ends as the
// result; y (G*N, C), qkv (G*N, 3C), attn (G*N, C) and hid (G*N, hidden) are
// scratch.  Returns the first CUDA error, checked after every launch.
template <typename T>
static cudaError_t vit_stack(const T* x, const T* pos, T* out,
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
    RP_CHECK(i == 0 ? launch_layernorm<T>(x, pos, out, ln1s, ln1b, y, M, N, C,
                                          st)
                    : launch_layernorm<T>(out, nullptr, nullptr,
                                          ln1s + i * C, ln1b + i * C, y, M, N,
                                          C, st));
    RP_CHECK((launch_gemm<T, kBias>(y, qkvw + i * 3 * cc, qkvb + i * 3 * C,
                                    nullptr, qkv, M, 3 * C, C, st)));
    RP_CHECK(launch_vit_attention<T>(qkv, attn, G, N, C, heads, st));
    RP_CHECK((launch_gemm<T, kBiasResid>(attn, projw + i * cc,
                                         projb + i * C, out, out, M, C, C,
                                         st)));
    RP_CHECK(launch_layernorm<T>(out, nullptr, nullptr, ln2s + i * C,
                                 ln2b + i * C, y, M, N, C, st));
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
                            const float* ln1s, const float* ln1b,
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
        (const T*)x, (const T*)pos, (T*)out, ln1s, ln1b, (const T*)qkvw, qkvb,
        (const T*)projw, projb, ln2s, ln2b, (const T*)fc1w, fc1b,
        (const T*)fc2w, fc2b, (T*)y, (T*)qkv, (T*)attn, (T*)hid, G, N, C,
        heads, hidden, depth, st);
  }
  return rp::vit_stack<float>(
      (const float*)x, (const float*)pos, (float*)out, ln1s, ln1b,
      (const float*)qkvw, qkvb, (const float*)projw, projb, ln2s, ln2b,
      (const float*)fc1w, fc1b, (const float*)fc2w, fc2b, (float*)y,
      (float*)qkv, (float*)attn, (float*)hid, G, N, C, heads, hidden, depth,
      st);
}

// Softmax attention over 64-wide heads in bf16 on Hopper's warpgroup
// tensor-core products (wgmma) with tiles brought by the Tensor Memory
// Accelerator (TMA): the bf16 body of kernels #1, #5 (the ViT stack's
// self-attention, layout Interleaved) and #7 (the --noess cross attention,
// layout Separate<bf16>).  attention_tc.cuh's attention_fwd / attention_bwd
// send bf16 here; fp32 runs the 3xTF32 wgmma body of
// attention_wgmma_f32.cuh, which shares this file's helpers.
//
// Replaces, in bf16,
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel's attn_stage and
//     pallas_vit_bwd.py:_attn_fwd_heads / _attn_bwd_heads (Interleaved: q,
//     k, v at columns h*64, C + h*64, 2C + h*64 of the qkv GEMM's (G, N, 3C)
//     output);
//   - rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel and _bwd_kernel
//     (Separate: (G, N, 64) q, k, v, o, do, dq, dk, dv).
//
// What bounds it on the H100: the products, 2 N^2 d multiply-adds a head
// forward and 5 backward (the function's; 7 executed, below), 64
// operations per byte of q, k, v, o at N = 576 -- under the 295 of bf16, so
// at full tensor rate HBM would bound them -- and the exp2 of every score,
// which at d = 64 costs about as much as its products (3.9 T scores/s
// against 989 T / 256).  So the design executes each score's exp2 once a
// kernel and no product twice:
//   forward (per 64-query tile): one pass over the key tiles with online
//     rescaling -- the running row max m, l and o rescaled by exp2(m_old -
//     m_new) when it rises, P = bf16(exp2(s - m_running)) -- so 2 N^2 d
//     multiply-adds and one exp2 per score; the exact (m, l) at the end go
//     to `stats` for the backward;
//   dq (per 64-query tile): c = rowsum(do o) from the forward's output o
//     (equal to rowsum(dp e) / l in exact arithmetic; c goes into the
//     stats' third slot), then one pass over the key tiles: s, dp = T(do) .
//     v^T, ds = T(layout's ds(e, dp, c, l)), dq += ds . k (3 products);
//   dk, dv (per 64-key tile, walking the query tiles): s^T = k . q^T,
//     dp^T = v . T(do)^T, dv += T(e)^T . T(do / l), dk += T(ds)^T . q (4).
// Every product is wgmma m64n64k16 (bf16 in, fp32 sums) for one warpgroup
// of 128 threads that owns the tile's 64 rows (warp w rows 16w .. 16w + 15,
// the accumulator in mma.sync's m16n8 layout, so that a rounded score
// accumulator is the next product's A operand in registers).  Operands in
// shared memory are 64 x 64 tiles, 128-byte rows in the 128-byte swizzle:
// the score products (s, dp and their transposes) read both K-major (the
// tiles' rows are the product's rows and columns); the products of a
// rounded score (P v, ds k, P^T T(do / l), ds^T q) take it from registers
// and B MN-major (the tile's rows are the sum index; the transpose bit).
// Holding q (dk / dv: k and v) as register fragments across the loop
// instead took more registers, fewer blocks an SM and more time on an H100
// (PERF.md).  The tiles arrive by TMA, one tensor map per operand over
// (G, N, columns), so that rows >= N load as zeros and never from the next
// sequence; the key (dk / dv: query) tiles stream through a 2-stage ring on
// mbarriers, refilled by thread 0 once the warpgroup has finished a stage.
// Keys >= N are masked out of every sum.  Sums run in a fixed order and
// nothing uses atomics: two calls give the same bits.

#pragma once

#include "mma_helpers.cuh"
#include "sm90.cuh"

namespace rp {
namespace tc {

// helpers of both attention bodies (this file's and
// attention_wgmma_f32.cuh's) and the essential block's (essential_tc.cuh)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// column of s[ni][e] within its 64-wide tile (the m16n8 accumulator layout,
// which wgmma's m64nN accumulator repeats per warp)
__device__ __forceinline__ int acc_col(int ni, int e) {
  return ni * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// an accumulator tile [16 x 64 a warp] rounded to bf16 as A fragments of
// the next product (its columns become the sum index): the m16n8k16 A
// layout, which wgmma's register A operand repeats per warp
__device__ __forceinline__ void to_afrag(unsigned (&f)[4][4],
                                         const float (&s)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    f[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    f[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// 4-byte cp.async (zero-filled when !ok)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

namespace wg {

constexpr int kT = 64;                  // rows of a query or key tile
constexpr int kThreads = 128;           // one warpgroup
constexpr int kTileBytes = kT * 128;    // 64 rows of 64 bf16
constexpr int kStages = 2;

// keeps the compiler from moving an accumulator's (or a register A
// operand's) reads or writes across the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[ni][e])::"memory");
}
__device__ __forceinline__ void fence_frag(unsigned (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[kk][e])::"memory");
}

#define RP_WG_ACC(d)                                                        \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define RP_WG_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A . B^T, both from shared memory, K-major; acc = 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RP_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RP_WG_ACC(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d += A . B, A in registers (m16n8k16 A fragments of this warp's 16 rows),
// B from shared memory, MN-major (transposed)
__device__ __forceinline__ void mma_rs(float (&d)[8][4],
                                       const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RP_WG_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : RP_WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// (RP_WG_ACC and RP_WG_D32 stay defined for attention_wgmma_f32.cuh's
// tf32 products, which undefines them)

// d = A . B^T over the 64-deep rows of two K-major tiles (issued, not
// waited for)
__device__ __forceinline__ void gemm_abt(float (&d)[8][4], uint32_t a,
                                         uint32_t b) {
  const uint64_t da = desc(a), db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss(d, kmajor_step(da, kk), kmajor_step(db, kk), kk > 0);
}

// d += T(p) . B, p a 64 x 64 accumulator rounded to bf16 as the A operand,
// B a tile whose rows are the sum index (issued, not waited for)
__device__ __forceinline__ void gemm_pb(float (&d)[8][4],
                                        const unsigned (&p)[4][4],
                                        uint32_t b) {
  const uint64_t db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(d, p[kk], mnmajor_step(db, kk));
}

// (dq, dk or dv) two adjacent columns: fp32 to f where the layout keeps it,
// bf16 to b
template <typename L>
__device__ __forceinline__ void put_grad(float* f, bf16* b, size_t o, float x,
                                         float y) {
  if constexpr (L::kF32Grads)
    *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
  *reinterpret_cast<__nv_bfloat162*>(b + o) = __floats2bfloat162_rn(x, y);
}

// ------------------------------------------------------------ forward --
// o for 64 query rows of (sequence g, head h) = (blockIdx.z, blockIdx.y);
// with `stats`, each row's (m, l).  Shared memory: Q, then the K and V
// rings, then the barriers (Q's, one a stage).
constexpr size_t kFwdSmem = (1 + 4) * kTileBytes + 8 * 3 + kAlign;

template <typename L>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
                float* __restrict__ stats, int N, int ldo, float scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t Qs = smem_u32(sm);
  auto Ks = [&](int st) { return Qs + (1 + st) * kTileBytes; };
  auto Vs = [&](int st) { return Qs + (3 + st) * kTileBytes; };
  const uint32_t qbar = Qs + 5 * kTileBytes;
  auto full = [&](int st) { return qbar + 8 * (1 + st); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const int nk = (N + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, kTileBytes);
    tma_load(Qs, mq, qbar, col, q0, g);
    for (int st = 0; st < kStages && st < nk; ++st) {
      mbar_expect_tx(full(st), 2 * kTileBytes);
      tma_load(Ks(st), mk, full(st), col, st * kT, g);
      tma_load(Vs(st), mv, full(st), col, st * kT, g);
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4] = {}, s[8][4];
  mbar_wait(qbar, 0);
  for (int t = 0; t < nk; ++t) {
    const int st = t % kStages, k0 = t * kT;
    mbar_wait(full(st), (t / kStages) & 1);
    wg_fence();
    gemm_abt(s, Qs, Ks(st));
    wg_commit();
    wg_wait();
    fence_acc(s);
    // the tile's row max, the running max and the rescale of l and o
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = __fmul_rn(s[ni][e], scale);
        if (k0 + acc_col(ni, e) < N) mt[e >> 1] = fmaxf(mt[e >> 1], s[ni][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = quad_max(mt[r]);
      alpha[r] = exp2f(m[r] - mt[r]);  // 0 at the first tile
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float ev =
            k0 + acc_col(ni, e) < N ? exp2f(s[ni][e] - m[r]) : 0.f;
        l[r] += ev;
        s[ni][e] = ev;
        o[ni][e] *= alpha[r];
      }
    unsigned pf[4][4];
    to_afrag(pf, s);  // P = bf16(e)
    fence_acc(o);
    wg_fence();
    gemm_pb(o, pf, Vs(st));
    wg_commit();
    wg_wait();
    fence_acc(o);
    fence_frag(pf);
    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + kStages < nk) {
      mbar_expect_tx(full(st), 2 * kTileBytes);
      tma_load(Ks(st), mk, full(st), col, (t + kStages) * kT, g);
      tma_load(Vs(st), mv, full(st), col, (t + kStages) * kT, g);
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  bf16* ob = out + (size_t)g * N * ldo + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * ldo +
                                         acc_col(ni, 0)) =
          __floats2bfloat162_rn(L::normalize(o[ni][2 * half], l[half]),
                                L::normalize(o[ni][2 * half + 1], l[half]));
    if (stats && (lane & 3) == 0) {
      float* sr = stats + (((size_t)g * gridDim.y + h) * N + row) * 3;
      sr[0] = m[half];
      sr[1] = l[half];
    }
  }
}

// ------------------------------------------------------------------ dq --
// dq for 64 query rows of (g, h), from the forward's (m, l) in stats and
// its output o (in the layout of do; it may alias dnb: each element is
// read before it is written, by the same thread).  The prologue forms c =
// rowsum(do o), writes it into the stats' third slot, rounds do into the
// swizzled DO tile and writes T(do / l) to dnb (and, for an fp32 cotangent,
// T(do) to dob), the dk / dv kernel's operands.  Shared memory: Q, DO, the
// K and V rings, c of the tile's rows, the barriers.
constexpr size_t kDqSmem = (2 + 4) * kTileBytes + kT * 4 + 8 * 3 + kAlign;

template <typename L>
__global__ void __launch_bounds__(kThreads)
attn_dq_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const typename L::Dout* __restrict__ dout, const bf16* ofwd,
               float* __restrict__ stats, bf16* __restrict__ dob, bf16* dnb,
               float* __restrict__ fq, bf16* __restrict__ gq, int N, int ld,
               int ldo, float scale, float sm_scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t Qs = smem_u32(sm), DOs = Qs + kTileBytes;
  auto Ks = [&](int st) { return Qs + (2 + st) * kTileBytes; };
  auto Vs = [&](int st) { return Qs + (4 + st) * kTileBytes; };
  float* crow = reinterpret_cast<float*>(sm + 6 * kTileBytes);
  const uint32_t qbar = Qs + 6 * kTileBytes + kT * 4;
  auto full = [&](int st) { return qbar + 8 * (1 + st); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const int nk = (N + kT - 1) / kT;
  float* st3 = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const size_t obase = (size_t)g * N * ldo + col;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, kTileBytes);
    tma_load(Qs, mq, qbar, col, q0, g);
    for (int st = 0; st < kStages && st < nk; ++st) {
      mbar_expect_tx(full(st), 2 * kTileBytes);
      tma_load(Ks(st), mk, full(st), col, st * kT, g);
      tma_load(Vs(st), mv, full(st), col, st * kT, g);
    }
  }
  // the prologue: 8 threads a row, 8 columns each
#pragma unroll
  for (int u = 0; u < kT * 8 / kThreads; ++u) {
    const int c = tid + u * kThreads, r = c >> 3, ch = c & 7;
    const int row = q0 + r;
    const bool ok = row < N;
    const size_t at = obase + (size_t)(ok ? row : 0) * ldo + ch * 8;
    float x[8] = {}, y[8] = {};
    if (ok) {
      if constexpr (sizeof(typename L::Dout) == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(dout + at));
        const float4 b = __ldg(reinterpret_cast<const float4*>(dout + at + 4));
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
        x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
      } else {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(dout + at));
        const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          x[2 * i] = f.x, x[2 * i + 1] = f.y;
        }
      }
      const uint4 b = *reinterpret_cast<const uint4*>(ofwd + at);
      const unsigned w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        y[2 * i] = f.x, y[2 * i + 1] = f.y;
      }
    }
    // c = do . o over the row's 8 threads, in a fixed order
    float cp = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cp += x[i] * y[i];
    cp += __shfl_xor_sync(0xffffffffu, cp, 1);
    cp += __shfl_xor_sync(0xffffffffu, cp, 2);
    cp += __shfl_xor_sync(0xffffffffu, cp, 4);
    const uint4 d = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                               pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    *reinterpret_cast<uint4*>(sm + kTileBytes + swz(r, ch)) = d;
    if (ch == 0) crow[r] = cp;
    if (ok) {
      const float li = st3[(size_t)row * 3 + 1];
      if constexpr (L::kF32Grads)
        *reinterpret_cast<uint4*>(dob + at) = d;
      *reinterpret_cast<uint4*>(dnb + at) = make_uint4(
          pack_bf16(x[0] / li, x[1] / li), pack_bf16(x[2] / li, x[3] / li),
          pack_bf16(x[4] / li, x[5] / li), pack_bf16(x[6] / li, x[7] / li));
      if (ch == 0) st3[(size_t)row * 3 + 2] = cp;
    }
  }
  // the DO tile's generic-proxy writes, before wgmma reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float m[2], l[2], c[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + (lane >> 2) + half * 8, row = q0 + r;
    m[half] = row < N ? st3[(size_t)row * 3] : 0.f;
    l[half] = row < N ? st3[(size_t)row * 3 + 1] : 1.f;
    c[half] = row < N ? crow[r] : 0.f;
  }

  float s[8][4], dp[8][4], dq[8][4] = {};
  mbar_wait(qbar, 0);
  for (int t = 0; t < nk; ++t) {
    const int st = t % kStages, k0 = t * kT;
    mbar_wait(full(st), (t / kStages) & 1);
    wg_fence();
    gemm_abt(s, Qs, Ks(st));
    gemm_abt(dp, DOs, Vs(st));
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float ev =
            k0 + acc_col(ni, e) < N
                ? exp2f(__fmul_rn(s[ni][e], scale) - m[r])
                : 0.f;
        dp[ni][e] = L::ds(ev, dp[ni][e], c[r], l[r], scale, sm_scale);
      }
    unsigned dsf[4][4];
    to_afrag(dsf, dp);  // T(ds)
    fence_acc(dq);
    wg_fence();
    gemm_pb(dq, dsf, Ks(st));
    wg_commit();
    wg_wait();
    fence_acc(dq);
    fence_frag(dsf);
    __syncthreads();
    if (tid == 0 && t + kStages < nk) {
      mbar_expect_tx(full(st), 2 * kTileBytes);
      tma_load(Ks(st), mk, full(st), col, (t + kStages) * kT, g);
      tma_load(Vs(st), mv, full(st), col, (t + kStages) * kT, g);
    }
  }

  const size_t in0 = (size_t)g * N * ld + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put_grad<L>(fq, gq, in0 + (size_t)row * ld + acc_col(ni, 0),
                  dq[ni][2 * half], dq[ni][2 * half + 1]);
  }
}

// ------------------------------------------------------------- dk, dv --
// dk and dv for 64 keys of (g, h), walking the query tiles through a
// 2-stage ring of (Q, T(do), T(do / l)) tiles by TMA and of their (m, l, c)
// by 4-byte cp.async (zero-filled past N).  Shared memory: K, V, the ring,
// the statistics, the barriers (K and V's, one a stage).
constexpr int kStats = 3 * kT;
constexpr size_t kDkvSmem =
    (2 + 3 * kStages) * kTileBytes + kStages * kStats * 4 + 8 * 3 + kAlign;

template <typename L>
__global__ void __launch_bounds__(kThreads)
attn_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mdn,
                const float* __restrict__ stats, float* __restrict__ fk,
                float* __restrict__ fv, bf16* __restrict__ gk,
                bf16* __restrict__ gv, int N, int ld, float scale,
                float sm_scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t Ks = smem_u32(sm), Vs = Ks + kTileBytes;
  auto Qs = [&](int st) { return Ks + (2 + st) * kTileBytes; };
  auto DOs = [&](int st) { return Ks + (2 + kStages + st) * kTileBytes; };
  auto DNs = [&](int st) { return Ks + (2 + 2 * kStages + st) * kTileBytes; };
  float* Ss = reinterpret_cast<float*>(sm + (2 + 3 * kStages) * kTileBytes);
  const uint32_t kvbar = Ks + (2 + 3 * kStages) * kTileBytes +
                         kStages * kStats * 4;
  auto full = [&](int st) { return kvbar + 8 * (1 + st); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const float* st3 = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const int nq = (N + kT - 1) / kT;

  auto load_stats = [&](int q0, int b) {
    const int valid = 3 * min(kT, N - q0);
    for (int i = tid; i < kStats; i += kThreads)
      cp_async4(Ss + b * kStats + i, st3 + (size_t)q0 * 3 + (i < valid ? i : 0),
                i < valid);
    cp_async_commit();
  };
  auto issue = [&](int it, int st) {
    mbar_expect_tx(full(st), 3 * kTileBytes);
    tma_load(Qs(st), mq, full(st), col, it * kT, g);
    tma_load(DOs(st), mdo, full(st), col, it * kT, g);
    tma_load(DNs(st), mdn, full(st), col, it * kT, g);
  };
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * kTileBytes);
    tma_load(Ks, mk, kvbar, col, k0, g);
    tma_load(Vs, mv, kvbar, col, k0, g);
    for (int st = 0; st < kStages && st < nq; ++st) issue(st, st);
  }
  load_stats(0, 0);

  float dk[8][4] = {}, dv[8][4] = {}, s[8][4], dp[8][4];
  mbar_wait(kvbar, 0);
  for (int it = 0; it < nq; ++it) {
    const int st = it % kStages, q0 = it * kT;
    cp_async_wait<0>();
    __syncthreads();  // stage (it - 1) % kStages and its statistics are free
    if (tid == 0 && it >= 1 && it - 1 + kStages < nq)
      issue(it - 1 + kStages, (it - 1) % kStages);
    if (it + 1 < nq) load_stats(q0 + kT, (it + 1) & 1);
    const float* sr = Ss + (it & 1) * kStats;
    mbar_wait(full(st), (it / kStages) & 1);
    wg_fence();
    gemm_abt(s, Ks, Qs(st));    // s^T: rows keys, columns queries
    gemm_abt(dp, Vs, DOs(st));  // dp^T
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e);
        const bool ok = q0 + j < N;
        const float mj = sr[3 * j], lj = sr[3 * j + 1], cj = sr[3 * j + 2];
        const float ev = exp2f(__fmul_rn(s[ni][e], scale) - mj);
        s[ni][e] = ok ? ev : 0.f;
        dp[ni][e] = ok ? L::ds(ev, dp[ni][e], cj, lj, scale, sm_scale) : 0.f;
      }
    unsigned pf[4][4], dsf[4][4];
    to_afrag(pf, s);    // T(e)^T
    to_afrag(dsf, dp);  // T(ds)^T
    fence_acc(dv);
    fence_acc(dk);
    wg_fence();
    gemm_pb(dv, pf, DNs(st));
    gemm_pb(dk, dsf, Qs(st));
    wg_commit();
    wg_wait();
    fence_acc(dv);
    fence_acc(dk);
    fence_frag(pf);
    fence_frag(dsf);
  }

  const size_t in0 = (size_t)g * N * ld + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const size_t o = in0 + (size_t)row * ld + acc_col(ni, 0);
      put_grad<L>(fk, gk, o, dk[ni][2 * half], dk[ni][2 * half + 1]);
      put_grad<L>(fv, gv, o, dv[ni][2 * half], dv[ni][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers --
// the tensor map of one operand: `heads` 64-column heads of G sequences of
// N rows from base, row stride ld elements, 64 x 64 boxes, 128-byte swizzle;
// rows >= N read as zeros
static cudaError_t make_map(CUtensorMap* map, const bf16* base, int G,
                            int heads, int N, int ld) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * kHeadDim, (cuuint64_t)N,
                              (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(bf16),
                                 (cuuint64_t)N * ld * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kHeadDim, (cuuint32_t)kT, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<bf16*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

#define RP_TRY(call)                                  \
  do {                                                \
    const cudaError_t rp_err_ = (call);               \
    if (rp_err_ != cudaSuccess) return rp_err_;       \
  } while (0)

// the forward over G sequences x heads; with `stats`, (m, l) per row at
// stats[((g * heads + h) * N + row) * 3]
template <typename L>
static cudaError_t attention_fwd(const bf16* q, const bf16* k, const bf16* v,
                                 bf16* out, float* stats, int G, int heads,
                                 int N, int ld, int ldo, float scale,
                                 cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  RP_TRY(make_map(&mq, q, G, heads, N, ld));
  RP_TRY(make_map(&mk, k, G, heads, N, ld));
  RP_TRY(make_map(&mv, v, G, heads, N, ld));
  RP_TRY(smem_attr(attn_fwd_kernel<L>, kFwdSmem));
  attn_fwd_kernel<L><<<dim3((N + kT - 1) / kT, heads, G), kThreads, kFwdSmem,
                       stream>>>(mq, mk, mv, out, stats, N, ldo, scale);
  return cudaGetLastError();
}

// dq, dk, dv (fq, fk, fv in fp32 where the layout keeps them; gq, gk, gv
// in bf16) from the cotangent dout, the forward's output o and its (m, l)
// in stats (c is written into their third slot); dnb is scratch in the
// layout of do for T(do / l) (it may be o), dob, for an fp32 cotangent, for
// T(do)
template <typename L>
static cudaError_t attention_bwd(const bf16* q, const bf16* k, const bf16* v,
                                 const typename L::Dout* dout, float* stats,
                                 bf16* dob, bf16* dnb, const bf16* o,
                                 float* fq, float* fk, float* fv, bf16* gq,
                                 bf16* gk, bf16* gv, int G, int heads, int N,
                                 int ld, int ldo, float scale, float sm_scale,
                                 cudaStream_t stream) {
  if (o == nullptr) return cudaErrorInvalidValue;
  const bf16* dkv_do;
  if constexpr (L::kF32Grads)
    dkv_do = dob;
  else
    dkv_do = dout;
  CUtensorMap mq, mk, mv, mdo, mdn;
  RP_TRY(make_map(&mq, q, G, heads, N, ld));
  RP_TRY(make_map(&mk, k, G, heads, N, ld));
  RP_TRY(make_map(&mv, v, G, heads, N, ld));
  RP_TRY(make_map(&mdo, dkv_do, G, heads, N, ldo));
  RP_TRY(make_map(&mdn, dnb, G, heads, N, ldo));
  RP_TRY(smem_attr(attn_dq_kernel<L>, kDqSmem));
  RP_TRY(smem_attr(attn_dkv_kernel<L>, kDkvSmem));
  const dim3 grid((N + kT - 1) / kT, heads, G);
  attn_dq_kernel<L><<<grid, kThreads, kDqSmem, stream>>>(
      mq, mk, mv, dout, o, stats, dob, dnb, fq, gq, N, ld, ldo, scale,
      sm_scale);
  RP_TRY(cudaGetLastError());
  attn_dkv_kernel<L><<<grid, kThreads, kDkvSmem, stream>>>(
      mq, mk, mv, mdo, mdn, stats, fk, fv, gk, gv, N, ld, scale, sm_scale);
  return cudaGetLastError();
}

#undef RP_TRY

}  // namespace wg
}  // namespace tc
}  // namespace rp

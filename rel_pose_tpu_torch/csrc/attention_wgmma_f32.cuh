// Softmax attention over 64-wide heads in fp32 on Hopper's warpgroup
// tensor-core products (wgmma .tf32) with tiles brought by the Tensor
// Memory Accelerator (TMA): the fp32 body of kernels #1, #5 (the ViT stack's
// self-attention, layout Interleaved) and #7 (the --noess cross attention,
// layout Separate<float>).  attention_tc.cuh's attention_fwd /
// attention_bwd send fp32 here, as they send bf16 to attention_wgmma.cuh.
//
// Replaces, in fp32,
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel's attention and
//     pallas_vit_bwd.py:_attn_fwd_heads / _attn_bwd_heads (Interleaved: q,
//     k, v at columns h*64, C + h*64, 2C + h*64 of the qkv GEMM's (G, N, 3C)
//     output);
//   - rel_pose_tpu/ops/pallas_attention.py:_fwd_kernel and _bwd_kernel
//     (Separate: (G, N, 64) q, k, v, o, do, dq, dk, dv).
//
// Every product is 3xTF32, as in the other fp32 kernels: each operand x is
// split into TF32 hi = rna(x) and lo = rna(x - hi), and lo_a hi_b, hi_a
// lo_b, then hi_a hi_b are summed (lo_a lo_b, below 2^-22 of |a||b|, is
// dropped): fp32 accuracy from the TF32 tensor cores.
//
// What bounds it on the H100: the products, 2 N^2 d multiply-adds a head
// forward and 5 backward (the function's; 8 executed, below), each taking
// three TF32 products, so 495 / 3 = 165 TFLOP/s at best: 32 operations per
// byte of fp32 q, k, v, o at N = 576, under the 49 at which that rate meets
// HBM, so at full rate HBM would bound them.  What decides here is what
// TF32 wgmma asks of its operands: (1) both shared-memory operands K-major
// (the transpose bits exist only for 16-bit types), (2) hi and lo copies of
// every operand, (3) 256-byte fp32 rows, two 128-byte swizzle columns of a
// tile; and with them, shared memory, which sets the blocks an SM.  The
// design:
//   - TMA lands every tile raw (64 x 64 fp32, rows of 256 bytes,
//     unswizzled; tensor maps over (G, N, columns), so rows >= N load as
//     zeros and never from the next sequence).  The warpgroup splits it,
//     once a block, into a hi / lo pair of K-major tiles in the 128-byte
//     swizzle: as it is (split_rows) for the B operands of the score
//     products (q k^T, do v^T, k q^T, v do^T), or transposed (split_cols)
//     for those of the products of a score (P v, ds k, ds^T q, e^T (do /
//     l)).  A transposed tile's rows are written in the order in which the
//     score accumulator holds its keys as register A fragments (slot t of
//     each 8-deep step is key 2t, slot t + 4 key 2t + 1), so the
//     accumulator is the next product's A operand as it is, split in
//     registers into hi / lo.  Splitting from the tile in shared memory
//     costs a pass over it a block (in place of every warp splitting its own
//     copy of every B fragment at every product, as mma.sync did); a
//     transposed copy in global memory instead would cost a pass over HBM
//     and a scratch tensor for each operand.
//   - every block fits twice on an SM (99-101 KB: at most the A operand
//     tile and one or two work pairs beside two raw boxes), so that one
//     block's splits and softmax run beside the other's products.  A tile
//     that stays an A operand across the loop lives in registers instead,
//     split once: q in the forward (its two work pairs let v's split run
//     during the score product and the next k's during P v), do in dq, v
//     in dk.  dk and dv are two kernels, each forming s^T and e: 8
//     products where 7 would do, but one kernel holding the K and V pairs
//     and a work pair for each B operand (183 KB) fits once on an SM, and
//     its one warpgroup waits on its own splits and softmax (PERF.md).
//   - the tensor cores' fp32 sums do not round to nearest: each product of
//     a 64-deep tile starts a fresh accumulator, its residual products
//     first, and the accumulator goes into the running o, dq, dk or dv by
//     one IEEE fp32 operation (the forward's online rescaling, o = o alpha
//     + pv, does so anyway).
//   forward (per 64-query tile): one pass over the key tiles with online
//     rescaling -- the running row max m, l and o rescaled by exp2(m_old -
//     m_new) when it rises, e = exp2(s - m_running) in fp32 -- 2 N^2 d
//     multiply-adds and one exp2 per score; the exact (m, l) at the end go
//     to `stats` for the backward;
//   dq (per 64-query tile): c = rowsum(do o) from the forward's output o
//     (equal to rowsum(dp e) / l in exact arithmetic; c goes into the stats'
//     third slot; do / l to the scratch dnb), then one pass over the key
//     tiles: s, dp = do . v^T, ds = layout's ds(e, dp, c, l), dq += ds . k
//     (3 products);
//   dk (per 64-key tile, walking the query tiles): s^T = k . q^T, dp^T =
//     v . do^T, dk += ds^T . q (3); dv: s^T, dv += e^T . (do / l) (2).
// One warpgroup of 128 threads owns a tile's 64 rows (warp w rows 16w ..
// 16w + 15, the accumulator in mma.sync's m16n8 layout).  Keys >= N are
// masked out of every sum.  Sums run in a fixed order and nothing uses
// atomics: two calls give the same bits.

#pragma once

#include "attention_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {

constexpr int kF32Tile = 2 * kF32Half;      // a 64 x 64 fp32 tile, 16 KB
constexpr int kF32Pair = 2 * kF32Tile;      // its hi tile, then its lo
constexpr int kF32Raw = kT * kHeadDim * 4;  // a TMA box as it lands, 16 KB

// byte offset of 16-byte chunk j (columns 4j .. 4j + 3) of row r in a
// K-major fp32 tile
__device__ __forceinline__ uint32_t swz_f32(int r, int j) {
  return (j >> 3) * kF32Half + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// x split into its hi / lo pair at byte offset off of each tile
__device__ __forceinline__ void put_split(unsigned char* pair, uint32_t off,
                                          float4 x) {
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(pair + off) = h;
  *reinterpret_cast<uint4*>(pair + kF32Tile + off) = l;
}

// a raw 64 x 64 tile (rows of 256 bytes) split into a pair of K-major tiles
// whose rows are its rows.  A quarter warp reads 128 contiguous bytes and
// writes 8 chunks of one swizzled row: no bank conflicts.
__device__ __forceinline__ void split_rows(unsigned char* pair,
                                           const float* raw) {
#pragma unroll
  for (int u = 0; u < kT * 16 / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads, r = c >> 4, j = c & 15;
    put_split(pair, swz_f32(r, j),
              *reinterpret_cast<const float4*>(raw + r * kHeadDim + 4 * j));
  }
}

// a raw 64 x 64 tile split into a pair of K-major tiles of its transpose:
// tile row c is raw column c, and its sum index runs over the raw rows in
// the order 0 2 4 6 1 3 5 7 within each group of 8 (slot t holds row 2t,
// slot t + 4 row 2t + 1), the order of the keys in a score accumulator's
// register A fragments.  A warp reads 32 columns of one raw row; a quarter
// warp writes one chunk to each of 8 consecutive rows: no bank conflicts.
__device__ __forceinline__ void split_cols(unsigned char* pair,
                                           const float* raw) {
  const int c = threadIdx.x & 63;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int j = (threadIdx.x >> 6) + 2 * u;  // slots 4j .. 4j + 3
    const float* p = raw + (8 * (j >> 1) + (j & 1)) * kHeadDim + c;
    put_split(pair, swz_f32(c, j),
              make_float4(p[0], p[2 * kHeadDim], p[4 * kHeadDim],
                          p[6 * kHeadDim]));
  }
}

// a score accumulator [8][4] split into hi / lo register A fragments: step
// kk takes keys 8kk + 2t and 8kk + 2t + 1 (the accumulator's own columns)
// in slots t and t + 4, the m16n8k8 A layout that wgmma's tf32 register
// operand repeats per warp
__device__ __forceinline__ void split_frag(unsigned (&h)[8][4],
                                           unsigned (&l)[8][4],
                                           const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    split_tf32(p[kk][0], h[kk][0], l[kk][0]);  // (g, key 2t)
    split_tf32(p[kk][2], h[kk][1], l[kk][1]);  // (g + 8, key 2t)
    split_tf32(p[kk][1], h[kk][2], l[kk][2]);  // (g, key 2t + 1)
    split_tf32(p[kk][3], h[kk][3], l[kk][3]);  // (g + 8, key 2t + 1)
  }
}

__device__ __forceinline__ void fence_frags(unsigned (&h)[8][4],
                                            unsigned (&l)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+r"(h[kk][e]), "+r"(l[kk][e])::"memory");
}

// d (+)= A . B^T, A and B K-major tf32 from shared memory; acc = 0
// overwrites d
__device__ __forceinline__ void mma_ss_tf32(float (&d)[8][4], uint64_t a,
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " RP_WG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : RP_WG_ACC(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A . B^T, A in registers (m16n8k8 tf32 A fragments of this warp's
// 16 rows), B K-major from shared memory
__device__ __forceinline__ void mma_rs_tf32(float (&d)[8][4],
                                            const unsigned (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " RP_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : RP_WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef RP_WG_ACC
#undef RP_WG_D32

// d = A . B^T over 64-deep rows, A and B hi / lo pairs at a and b: lo_a
// hi_b, hi_a lo_b, hi_a hi_b, into d afresh (issued, not waited for)
__device__ __forceinline__ void gemm3_ss(float (&d)[8][4], uint32_t a,
                                         uint32_t b) {
  const uint64_t ah = desc(a), al = desc(a + kF32Tile), bh = desc(b),
                 bl = desc(b + kF32Tile);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_ss_tf32(d, tf32_step(al, kk), tf32_step(bh, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_ss_tf32(d, tf32_step(ah, kk), tf32_step(bl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_ss_tf32(d, tf32_step(ah, kk), tf32_step(bh, kk), 1);
}

// d = P . B^T, P a score accumulator split into register fragments (h, l),
// B a hi / lo pair of a transposed tile (split_cols) at b, into d afresh
// (issued, not waited for)
__device__ __forceinline__ void gemm3_rs(float (&d)[8][4],
                                         const unsigned (&h)[8][4],
                                         const unsigned (&l)[8][4],
                                         uint32_t b) {
  const uint64_t bh = desc(b), bl = desc(b + kF32Tile);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_rs_tf32(d, l[kk], tf32_step(bh, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_rs_tf32(d, h[kk], tf32_step(bl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_rs_tf32(d, h[kk], tf32_step(bh, kk), 1);
}

// two adjacent fp32 columns at element o
__device__ __forceinline__ void put2(float* f, size_t o, float x, float y) {
  *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
}

// ------------------------------------------------------------ forward --
// o for 64 query rows of (sequence g, head h) = (blockIdx.z, blockIdx.y);
// with `stats`, each row's (m, l).  q is split once into register A
// fragments (hi / lo), so that shared memory holds two work pairs -- k's
// split and v's transposed split -- beside the raw K and V boxes and the
// barriers (99 KB, twice on an SM): v's split runs during the score
// product and the next k's during P v.
constexpr size_t kFwdF32Smem = 2 * kF32Pair + 2 * kF32Raw + 8 * 3 + kAlign;

template <typename L>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    float* __restrict__ out, float* __restrict__ stats, int N,
                    int ldo, float scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  unsigned char* WK = sm;
  unsigned char* WV = sm + kF32Pair;
  const float* rk = reinterpret_cast<const float*>(sm + 2 * kF32Pair);
  const float* rv = rk + kT * kHeadDim;
  const uint32_t Ks = smem_u32(sm), Vs = Ks + kF32Pair;
  const uint32_t Rk = Ks + 2 * kF32Pair, Rv = Rk + kF32Raw;
  const uint32_t qbar = Rv + kF32Raw, kbar = qbar + 8, vbar = qbar + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const int nk = (N + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, kF32Raw);
    tma_load(Vs, mq, qbar, col, q0, g);  // q lands raw in v's work pair
    mbar_expect_tx(kbar, kF32Raw);
    tma_load(Rk, mk, kbar, col, 0, g);
    mbar_expect_tx(vbar, kF32Raw);
    tma_load(Rv, mv, vbar, col, 0, g);
  }
  // q's register A fragments: rows 16w + (lane >> 2) (+ 8), columns
  // 8kk + (lane & 3) (+ 4)
  unsigned qh[8][4], ql[8][4];
  mbar_wait(qbar, 0);
  {
    const float* rq = reinterpret_cast<const float*>(WV) +
                      (warp * 16 + (lane >> 2)) * kHeadDim + (lane & 3);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(rq[(e & 1) * 8 * kHeadDim + 8 * kk + 4 * (e >> 1)],
                   qh[kk][e], ql[kk][e]);
  }
  mbar_wait(kbar, 0);
  split_rows(WK, rk);
  proxy_fence();
  __syncthreads();  // raw q is read before v's split overwrites it
  if (tid == 0 && nk > 1) {
    mbar_expect_tx(kbar, kF32Raw);
    tma_load(Rk, mk, kbar, col, kT, g);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4] = {}, s[8][4], pv[8][4];
  unsigned ph[8][4], pl[8][4];
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kT;
    wg_fence();
    gemm3_rs(s, qh, ql, Ks);  // s = q . k^T, q from registers
    wg_commit();
    mbar_wait(vbar, t & 1);
    split_cols(WV, rv);  // v^T, during the score product
    proxy_fence();
    __syncthreads();
    if (tid == 0 && t + 1 < nk) {
      mbar_expect_tx(vbar, kF32Raw);
      tma_load(Rv, mv, vbar, col, k0 + kT, g);
    }
    wg_wait();
    fence_acc(s);
    fence_frags(qh, ql);
    // the tile's row max, the running max and the rescale of l
    float mt[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = __fmul_rn(s[ni][e], scale);
        if (k0 + acc_col(ni, e) < N) mt[e >> 1] = fmaxf(mt[e >> 1], s[ni][e]);
      }
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
      }
    split_frag(ph, pl, s);
    __syncthreads();  // every warp's score products have read k's pair
    wg_fence();
    gemm3_rs(pv, ph, pl, Vs);
    wg_commit();
    if (t + 1 < nk) {
      mbar_wait(kbar, (t + 1) & 1);
      split_rows(WK, rk);  // the next k, during P v
      proxy_fence();
    }
    wg_wait();
    fence_acc(pv);
    fence_frags(ph, pl);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[ni][e] = __fmaf_rn(o[ni][e], alpha[e >> 1], pv[ni][e]);
    // every warp's P v products have read v's pair, and the next k is split
    __syncthreads();
    if (tid == 0 && t + 2 < nk) {
      mbar_expect_tx(kbar, kF32Raw);
      tma_load(Rk, mk, kbar, col, k0 + 2 * kT, g);
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  float* ob = out + (size_t)g * N * ldo + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put2(ob, (size_t)row * ldo + acc_col(ni, 0),
           L::normalize(o[ni][2 * half], l[half]),
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
// its output o (in the layout of do; it may alias dnb: each element is read
// before it is written, by the same thread).  The prologue reads do and o
// where this thread's register A fragments of do lie, forms c =
// rowsum(do o) (into the stats' third slot), writes do / l to dnb (the dk /
// dv kernel's operand) and keeps do split into hi / lo fragments in
// registers for the dp product, so that the block's shared memory -- the
// Q pair, one work pair (k, v, then k^T, each split in turn), the raw K
// and V boxes, the barriers -- fits twice on an SM.
constexpr size_t kDqF32Smem = 2 * kF32Pair + 2 * kF32Raw + 8 * 3 + kAlign;

template <typename L>
__global__ void __launch_bounds__(kThreads, 2)
attn_dq_f32_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const float* __restrict__ dout, const float* ofwd,
                   float* __restrict__ stats, float* dnb,
                   float* __restrict__ fq, int N, int ld, int ldo,
                   float scale, float sm_scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  unsigned char* W = sm + kF32Pair;
  const float* rk = reinterpret_cast<const float*>(sm + 2 * kF32Pair);
  const float* rv = rk + kT * kHeadDim;
  const uint32_t Qs = smem_u32(sm), Ws = Qs + kF32Pair;
  const uint32_t Rk = Qs + 2 * kF32Pair, Rv = Rk + kF32Raw;
  const uint32_t qbar = Rv + kF32Raw, kbar = qbar + 8, vbar = qbar + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const int nk = (N + kT - 1) / kT;
  float* st3 = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const size_t obase = (size_t)g * N * ldo + col;

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, kF32Raw);
    tma_load(Ws, mq, qbar, col, q0, g);  // q lands raw in the work pair
    mbar_expect_tx(kbar, kF32Raw);
    tma_load(Rk, mk, kbar, col, 0, g);
    mbar_expect_tx(vbar, kF32Raw);
    tma_load(Rv, mv, vbar, col, 0, g);
  }
  // the prologue: this thread's rows (r = 0: row g, 1: row g + 8 of its
  // warp's 16) and the A fragments' columns of do: x[kk][e] at row e & 1,
  // column 8kk + (lane & 3) + 4 (e >> 1)
  int row[2];
  float m[2], l[2], c[2] = {0.f, 0.f}, x[8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    m[r] = row[r] < N ? st3[(size_t)row[r] * 3] : 0.f;
    l[r] = row[r] < N ? st3[(size_t)row[r] * 3 + 1] : 1.f;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1;
      const size_t at = obase + (size_t)row[r] * ldo + 8 * kk + (lane & 3) +
                        4 * (e >> 1);
      x[kk][e] = row[r] < N ? __ldg(dout + at) : 0.f;
      c[r] += x[kk][e] * (row[r] < N ? ofwd[at] : 0.f);
    }
  // c = do . o over the row's 4 threads, in a fixed order
  c[0] = quad_sum(c[0]);
  c[1] = quad_sum(c[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row[r] < N && (lane & 3) == 0) st3[(size_t)row[r] * 3 + 2] = c[r];
  unsigned dh[8][4], dl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1;
      if (row[r] < N)
        dnb[obase + (size_t)row[r] * ldo + 8 * kk + (lane & 3) +
            4 * (e >> 1)] = x[kk][e] / l[r];
      split_tf32(x[kk][e], dh[kk][e], dl[kk][e]);
    }
  mbar_wait(qbar, 0);
  split_rows(sm, reinterpret_cast<const float*>(W));
  __syncthreads();  // raw q is read before k's split overwrites it

  float s[8][4], dp[8][4], part[8][4], dq[8][4] = {};
  unsigned fh[8][4], fl[8][4];
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kT;
    mbar_wait(kbar, t & 1);
    split_rows(W, rk);
    proxy_fence();
    __syncthreads();
    wg_fence();
    gemm3_ss(s, Qs, Ws);
    wg_commit();
    wg_wait();
    fence_acc(s);
    __syncthreads();  // every warp's score products have read the work pair
    mbar_wait(vbar, t & 1);
    split_rows(W, rv);
    proxy_fence();
    __syncthreads();
    if (tid == 0 && t + 1 < nk) {
      mbar_expect_tx(vbar, kF32Raw);
      tma_load(Rv, mv, vbar, col, k0 + kT, g);
    }
    wg_fence();
    gemm3_rs(dp, dh, dl, Ws);  // dp = do . v^T, do from registers
    wg_commit();
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = k0 + acc_col(ni, e) < N
                       ? exp2f(__fmul_rn(s[ni][e], scale) - m[e >> 1])
                       : 0.f;
    wg_wait();
    fence_acc(dp);
    fence_frags(dh, dl);
    __syncthreads();  // every warp's dp products have read the work pair
    split_cols(W, rk);  // k^T
    proxy_fence();
    __syncthreads();
    if (tid == 0 && t + 1 < nk) {
      mbar_expect_tx(kbar, kF32Raw);
      tma_load(Rk, mk, kbar, col, k0 + kT, g);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        dp[ni][e] = L::ds(s[ni][e], dp[ni][e], c[r], l[r], scale, sm_scale);
      }
    split_frag(fh, fl, dp);
    wg_fence();
    gemm3_rs(part, fh, fl, Ws);
    wg_commit();
    wg_wait();
    fence_acc(part);
    fence_frags(fh, fl);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[ni][e] = __fadd_rn(dq[ni][e], part[ni][e]);
    __syncthreads();  // every warp's dq products have read the work pair
  }

  const size_t in0 = (size_t)g * N * ld + col;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put2(fq, in0 + (size_t)row[r] * ld + acc_col(ni, 0), dq[ni][2 * r],
           dq[ni][2 * r + 1]);
  }
}

// ---------------------------------------------------------- dk and dv --
// dk and dv for 64 keys of (g, h), each walking the query tiles in a
// kernel of its own: the K pair, one work pair, two raw boxes (q and do,
// or q and do / l, each refilled by TMA once split for the last time), the
// (m, l, c) of two query tiles by 4-byte cp.async (zero-filled past N),
// the barriers.
constexpr int kStatsF32 = 3 * kT;
constexpr size_t kDkvF32Smem = 2 * kF32Pair + 2 * kF32Raw +
                               2 * kStatsF32 * 4 + 8 * 3 + kAlign;

// the statistics of query tile q0 into buffer b of shared memory
__device__ __forceinline__ void load_stats_f32(float* Ss, const float* st3,
                                               int q0, int b, int N) {
  const int valid = 3 * min(kT, N - q0);
  for (int i = threadIdx.x; i < kStatsF32; i += kThreads)
    cp_async4(Ss + b * kStatsF32 + i,
              st3 + (size_t)q0 * 3 + (i < valid ? i : 0), i < valid);
  cp_async_commit();
}

// dv += e^T . (do / l) over the query tiles: s^T = k . q^T, e = exp2(s^T
// scale - m) (2 products a tile)
template <typename L>
__global__ void __launch_bounds__(kThreads, 2)
attn_dv_f32_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mdn,
                   const float* __restrict__ stats, float* __restrict__ fv,
                   int N, int ld, float scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  unsigned char* W = sm + kF32Pair;
  const float* rq = reinterpret_cast<const float*>(sm + 2 * kF32Pair);
  const float* rdn = rq + kT * kHeadDim;
  float* Ss = reinterpret_cast<float*>(sm + 2 * kF32Pair + 2 * kF32Raw);
  const uint32_t Ks = smem_u32(sm), Ws = Ks + kF32Pair;
  const uint32_t Rq = Ks + 2 * kF32Pair, Rdn = Rq + kF32Raw;
  const uint32_t kbar = Rdn + kF32Raw + 2 * kStatsF32 * 4, qbar = kbar + 8,
                 dnbar = kbar + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const float* st3 = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const int nq = (N + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(kbar, 1);
    mbar_init(qbar, 1);
    mbar_init(dnbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kbar, kF32Raw);
    tma_load(Ws, mk, kbar, col, k0, g);  // k lands raw in the work pair
    mbar_expect_tx(qbar, kF32Raw);
    tma_load(Rq, mq, qbar, col, 0, g);
    mbar_expect_tx(dnbar, kF32Raw);
    tma_load(Rdn, mdn, dnbar, col, 0, g);
  }
  load_stats_f32(Ss, st3, 0, 0, N);
  mbar_wait(kbar, 0);
  split_rows(sm, reinterpret_cast<const float*>(W));

  float dv[8][4] = {}, s[8][4], part[8][4];
  unsigned fh[8][4], fl[8][4];
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kT;
    const bool more = it + 1 < nq;
    cp_async_wait<0>();
    __syncthreads();  // the work pair and the other statistics are free
    if (more) load_stats_f32(Ss, st3, q0 + kT, (it + 1) & 1, N);
    const float* sr = Ss + (it & 1) * kStatsF32;
    mbar_wait(qbar, it & 1);
    split_rows(W, rq);
    proxy_fence();
    __syncthreads();
    if (tid == 0 && more) {
      mbar_expect_tx(qbar, kF32Raw);
      tma_load(Rq, mq, qbar, col, q0 + kT, g);
    }
    wg_fence();
    gemm3_ss(s, Ks, Ws);  // s^T: rows keys, columns queries
    wg_commit();
    wg_wait();
    fence_acc(s);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e);
        s[ni][e] = q0 + j < N ? exp2f(__fmul_rn(s[ni][e], scale) - sr[3 * j])
                              : 0.f;
      }
    split_frag(fh, fl, s);
    __syncthreads();  // every warp's s^T products have read the work pair
    mbar_wait(dnbar, it & 1);
    split_cols(W, rdn);  // (do / l)^T
    proxy_fence();
    __syncthreads();
    if (tid == 0 && more) {
      mbar_expect_tx(dnbar, kF32Raw);
      tma_load(Rdn, mdn, dnbar, col, q0 + kT, g);
    }
    wg_fence();
    gemm3_rs(part, fh, fl, Ws);
    wg_commit();
    wg_wait();
    fence_acc(part);
    fence_frags(fh, fl);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv[ni][e] = __fadd_rn(dv[ni][e], part[ni][e]);
  }

  const size_t in0 = (size_t)g * N * ld + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put2(fv, in0 + (size_t)row * ld + acc_col(ni, 0), dv[ni][2 * half],
           dv[ni][2 * half + 1]);
  }
}

// dk += ds^T . q over the query tiles: s^T = k . q^T, dp^T = v . do^T with
// v split into register A fragments once, ds from the statistics (3
// products a tile)
template <typename L>
__global__ void __launch_bounds__(kThreads, 2)
attn_dk_f32_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ stats, float* __restrict__ fk,
                   int N, int ld, float scale, float sm_scale) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  unsigned char* W = sm + kF32Pair;
  const float* rq = reinterpret_cast<const float*>(sm + 2 * kF32Pair);
  const float* rdo = rq + kT * kHeadDim;
  float* Ss = reinterpret_cast<float*>(sm + 2 * kF32Pair + 2 * kF32Raw);
  const uint32_t Ks = smem_u32(sm), Ws = Ks + kF32Pair;
  const uint32_t Rq = Ks + 2 * kF32Pair, Rdo = Rq + kF32Raw;
  const uint32_t kvbar = Rdo + kF32Raw + 2 * kStatsF32 * 4,
                 qbar = kvbar + 8, dobar = kvbar + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, g = blockIdx.z;
  const int col = h * kHeadDim;
  const float* st3 = stats + ((size_t)g * gridDim.y + h) * N * 3;
  const int nq = (N + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    mbar_init(qbar, 1);
    mbar_init(dobar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // k and v land raw in the work pair
    mbar_expect_tx(kvbar, 2 * kF32Raw);
    tma_load(Ws, mk, kvbar, col, k0, g);
    tma_load(Ws + kF32Raw, mv, kvbar, col, k0, g);
    mbar_expect_tx(qbar, kF32Raw);
    tma_load(Rq, mq, qbar, col, 0, g);
    mbar_expect_tx(dobar, kF32Raw);
    tma_load(Rdo, mdo, dobar, col, 0, g);
  }
  load_stats_f32(Ss, st3, 0, 0, N);
  mbar_wait(kvbar, 0);
  split_rows(sm, reinterpret_cast<const float*>(W));
  // v's register A fragments: rows 16w + (lane >> 2) (+ 8), columns
  // 8kk + (lane & 3) (+ 4)
  unsigned vh[8][4], vl[8][4];
  {
    const float* rv = reinterpret_cast<const float*>(W + kF32Raw) +
                      (warp * 16 + (lane >> 2)) * kHeadDim + (lane & 3);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(rv[(e & 1) * 8 * kHeadDim + 8 * kk + 4 * (e >> 1)],
                   vh[kk][e], vl[kk][e]);
  }

  float dk[8][4] = {}, s[8][4], dp[8][4], part[8][4];
  unsigned fh[8][4], fl[8][4];
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kT;
    const bool more = it + 1 < nq;
    cp_async_wait<0>();
    __syncthreads();  // the work pair and the other statistics are free
    if (more) load_stats_f32(Ss, st3, q0 + kT, (it + 1) & 1, N);
    const float* sr = Ss + (it & 1) * kStatsF32;
    mbar_wait(qbar, it & 1);
    split_rows(W, rq);
    proxy_fence();
    __syncthreads();
    wg_fence();
    gemm3_ss(s, Ks, Ws);  // s^T: rows keys, columns queries
    wg_commit();
    wg_wait();
    fence_acc(s);
    __syncthreads();  // every warp's s^T products have read the work pair
    mbar_wait(dobar, it & 1);
    split_rows(W, rdo);
    proxy_fence();
    __syncthreads();
    if (tid == 0 && more) {
      mbar_expect_tx(dobar, kF32Raw);
      tma_load(Rdo, mdo, dobar, col, q0 + kT, g);
    }
    wg_fence();
    gemm3_rs(dp, vh, vl, Ws);  // dp^T = v . do^T, v from registers
    wg_commit();
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = exp2f(__fmul_rn(s[ni][e], scale) - sr[3 * acc_col(ni, e)]);
    wg_wait();
    fence_acc(dp);
    fence_frags(vh, vl);
    __syncthreads();  // every warp's dp^T products have read the work pair
    split_cols(W, rq);  // q^T
    proxy_fence();
    __syncthreads();
    if (tid == 0 && more) {
      mbar_expect_tx(qbar, kF32Raw);
      tma_load(Rq, mq, qbar, col, q0 + kT, g);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e);
        dp[ni][e] = q0 + j < N ? L::ds(s[ni][e], dp[ni][e], sr[3 * j + 2],
                                       sr[3 * j + 1], scale, sm_scale)
                               : 0.f;
      }
    split_frag(fh, fl, dp);
    wg_fence();
    gemm3_rs(part, fh, fl, Ws);  // ds^T . q
    wg_commit();
    wg_wait();
    fence_acc(part);
    fence_frags(fh, fl);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dk[ni][e] = __fadd_rn(dk[ni][e], part[ni][e]);
  }

  const size_t in0 = (size_t)g * N * ld + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      put2(fk, in0 + (size_t)row * ld + acc_col(ni, 0), dk[ni][2 * half],
           dk[ni][2 * half + 1]);
  }
}

// ------------------------------------------------------------ launchers --
#define RP_TRY(call)                            \
  do {                                          \
    const cudaError_t rp_err_ = (call);         \
    if (rp_err_ != cudaSuccess) return rp_err_; \
  } while (0)

// the forward over G sequences x heads; with `stats`, (m, l) per row at
// stats[((g * heads + h) * N + row) * 3]
template <typename L>
static cudaError_t attention_fwd(const float* q, const float* k,
                                 const float* v, float* out, float* stats,
                                 int G, int heads, int N, int ld, int ldo,
                                 float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  RP_TRY(make_map_f32(&mq, q, G, heads, N, ld));
  RP_TRY(make_map_f32(&mk, k, G, heads, N, ld));
  RP_TRY(make_map_f32(&mv, v, G, heads, N, ld));
  RP_TRY(smem_attr(attn_fwd_f32_kernel<L>, kFwdF32Smem));
  attn_fwd_f32_kernel<L><<<dim3((N + kT - 1) / kT, heads, G), kThreads,
                           kFwdF32Smem, stream>>>(mq, mk, mv, out, stats, N,
                                                  ldo, scale);
  return cudaGetLastError();
}

// dq, dk, dv (fq, fk, fv) from the cotangent dout, the forward's output o
// and its (m, l) in stats (c is written into their third slot); dnb is
// scratch in the layout of dout for do / l (it may be o)
template <typename L>
static cudaError_t attention_bwd(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 float* stats, float* dnb, const float* o,
                                 float* fq, float* fk, float* fv, int G,
                                 int heads, int N, int ld, int ldo,
                                 float scale, float sm_scale,
                                 cudaStream_t stream) {
  if (o == nullptr) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo, mdn;
  RP_TRY(make_map_f32(&mq, q, G, heads, N, ld));
  RP_TRY(make_map_f32(&mk, k, G, heads, N, ld));
  RP_TRY(make_map_f32(&mv, v, G, heads, N, ld));
  RP_TRY(make_map_f32(&mdo, dout, G, heads, N, ldo));
  RP_TRY(make_map_f32(&mdn, dnb, G, heads, N, ldo));
  RP_TRY(smem_attr(attn_dq_f32_kernel<L>, kDqF32Smem));
  RP_TRY(smem_attr(attn_dk_f32_kernel<L>, kDkvF32Smem));
  RP_TRY(smem_attr(attn_dv_f32_kernel<L>, kDkvF32Smem));
  const dim3 grid((N + kT - 1) / kT, heads, G);
  attn_dq_f32_kernel<L><<<grid, kThreads, kDqF32Smem, stream>>>(
      mq, mk, mv, dout, o, stats, dnb, fq, N, ld, ldo, scale, sm_scale);
  RP_TRY(cudaGetLastError());
  attn_dk_f32_kernel<L><<<grid, kThreads, kDkvF32Smem, stream>>>(
      mq, mk, mv, mdo, stats, fk, N, ld, scale, sm_scale);
  RP_TRY(cudaGetLastError());
  attn_dv_f32_kernel<L><<<grid, kThreads, kDkvF32Smem, stream>>>(
      mq, mk, mdn, stats, fv, N, ld, scale);
  return cudaGetLastError();
}

#undef RP_TRY

}  // namespace wg
}  // namespace tc
}  // namespace rp

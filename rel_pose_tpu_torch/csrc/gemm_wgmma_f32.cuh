// The fp32 GEMMs of the ViT stack (kernels #1 and #5) as 3xTF32 on
// Hopper's TF32 warpgroup products (wgmma .tf32) with operands brought by
// the Tensor Memory Accelerator (TMA), in persistent, warp-specialised
// blocks: the fp32 counterpart of gemm_wgmma.cuh's bf16 body.
//
// Replaces, in fp32, the jnp.dot / dot_general products inside
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel: qkv (:129), proj
//     (:242), fc1 (:264), fc2 (:272) -- op kOpFwd, the Linear's forward
//     with common.cuh's epilogues kBias, kBiasResid, kBiasGelu;
//   - rel_pose_tpu/ops/pallas_vit_bwd.py:_vit_stack_bwd_kernel: the
//     recompute (:178, :183, :189; kOpFwd, fc1 as kBiasGeluSplit), dX
//     (:200, :208, :222, :232; kOpDx, epilogues kDxPlain and kDxGeluGrad)
//     and dW (:196, :204, :218, :228; kOpDw, split-K over kDwChunk rows).
//
// Every product is 3xTF32, as in the rest of the fp32 port: each operand x
// splits into TF32 hi = rna(x) and lo = rna(x - hi) (mma_helpers.cuh's
// split_tf32), and lo_a hi_b, hi_a lo_b, then hi_a hi_b are summed (lo_a
// lo_b, below 2^-22 of |a||b|, is dropped).
//
// What bounds them on the H100: one GEMM does 2 M K N operations, each
// three TF32 products, so 495 / 3 = 165 TFLOP/s at best, on M K + M N fp32
// elements: 48-77 operations a byte at the ViT widths, about the 49 at
// which that rate meets HBM.  What decides here is what TF32 wgmma asks of
// its operands: both shared-memory operands K-major (the transpose bits
// exist only for 16-bit types), a hi and a lo copy of each, and registers
// for a second accumulator (below).  The design:
//   - forward and dX are one kernel shape, out = epilogue(A . B^T) with A
//     (M, K) and B (N, K) K-major.  B is a Linear weight, at most 768 x 192
//     fp32: gemm_split_weight_kernel splits it once a stack call into a
//     global (2 N, K) tensor, hi rows then lo rows -- for dX transposed, so
//     that dX's B (the weight read MN-major) is K-major too -- and TMA
//     lands ready K-major TF32 tiles (32 fp32 deep: one 128-byte swizzle
//     row) that no block splits again.  A lands raw in the 128-byte
//     swizzle; each consumer warpgroup reads its register A fragments from
//     it and splits them in registers (wgmma's RS form);
//   - dW = dY^T X sums over M, so both dY and X are MN-major in memory.
//     TMA lands 32-row raw boxes of both, and the warpgroup splits each,
//     transposed, into a hi / lo pair of K-major tiles in shared memory
//     (split_t), both operands then read by wgmma from there (SS).  Not
//     the RS form for dY: at two blocks an SM ptxas keeps every path within
//     128 registers a thread, which the two 64 x 96 accumulators and the A
//     fragments (48 + 48 + 32) fill.  A transposed global copy of dY or X
//     would cost an HBM pass over up to 69,120 x 768 fp32 a GEMM;
//   - the tensor cores' fp32 sums do not round to nearest (mma_helpers.cuh's
//     mma_3xtf32 says what summing into the accumulator itself cost), so
//     every kF32Steps k8 steps (32 deep: a stage) the products start a
//     fresh partial, residual products first, which one IEEE fp32 add puts
//     into the running sum once the products are done.  The depth is set by
//     the float64 bar (chip_smoke.py 3b on an H100; scripts/check_gemm_f32.py
//     compares depths, PERF.md has the readings): 64-deep partials failed
//     it, 32 deep passes, 16 and 8 deep with more room but slower.  Each
//     partial's products are waited for before the add, so the other
//     warpgroup's products fill the tensor cores meanwhile.  The partial
//     takes 48 registers a thread beside the running sum's 48 at 96 output
//     columns, so the tiles are 96 columns wide (96 divides 192, 576 and
//     768; 64 where it does not, the C = 64 / hidden 256 configuration);
//   - warp specialisation and persistence as gemm_wgmma.cuh: one producer
//     warpgroup (one thread issues the loads into a ring of kStages
//     32-deep stages on mbarriers), gridDim.x blocks walking the tiles in a
//     fixed order.  Forward and dX: two consumer warpgroups, 64 rows each of
//     a 128-row tile, sharing its B tiles, one block an SM (188 KB);
//     each warpgroup's fragment reads and splits run beside the other's
//     products.  dW: one consumer a block over a 64 x 96 tile of dW, two
//     blocks an SM (109 KB each), so one block's splits run beside the
//     other's products;
//   - epilogues element for element as common.cuh's Epilogue and
//     DxEpilogue in fp32, staged through shared memory and written in
//     rows of 4 columns (16-byte accesses), masked past M; resid and aux may
//     alias out.  dW writes per-chunk fp32 partials from the registers, the
//     bias column sums come from gemm_dw_bias_kernel, and sum_partials adds
//     both in chunk order.
// Rows past M (and, in dW, past the last chunk's rows) load as zeros.  No
// atomics: every output element is summed in one fixed order, so two calls
// give the same bits.

#pragma once

#include "gemm_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {

constexpr int kF32K = 32;                 // depth of one stage: 128 bytes
constexpr int kF32Box = 32 * kRowBytes;   // a 32 x 32 fp32 box, 4 KB
constexpr int kF32Steps = 4;              // k8 steps a fresh partial spans
constexpr int kF32WideN = 96;             // output columns of a wide tile

template <int OP, int BN_>
struct F32Cfg {
  static constexpr int BN = BN_;                   // kF32WideN or 64
  static constexpr int kWG = OP == kOpDw ? 1 : 2;  // consumer warpgroups
  static constexpr int BM = 64 * kWG;
  static constexpr int kStages = OP == kOpDw ? 3 : 4;
  static constexpr int kTileB = BN * kRowBytes;  // BN rows of 32 fp32
  // a stage: forward and dX, the raw A box (BM rows) and the weight's hi
  // and lo tiles; dW, the raw dY boxes (64 columns: two) and X boxes
  static constexpr int kABytes = OP == kOpDw ? 2 * kF32Box : BM * kRowBytes;
  static constexpr int kBBytes =
      OP == kOpDw ? BN / 32 * kF32Box : 2 * kTileB;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // dW's split pairs: A (64 rows) hi, lo, then B (BN rows) hi, lo
  static constexpr int kPairA = 2 * 64 * kRowBytes;
  static constexpr int kPairBytes = OP == kOpDw ? kPairA + 2 * kTileB : 0;
  static constexpr int kLdc = BN + 8;  // staged fp32 row, conflict-free
  // a consumer stages half its 64 rows at a time
  static constexpr int kStagingBytes =
      OP == kOpDw ? 0 : kWG * 32 * kLdc * (int)sizeof(float);
  static constexpr int kBarOff =
      kStages * kStageBytes + kPairBytes + kStagingBytes;
  static constexpr size_t kSmem = kAlign + kBarOff + 2 * kStages * 8;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kMinBlocks = OP == kOpDw ? 2 : 1;
  // as gemm_wgmma.cuh: ptxas keeps every path within the launch's share
  // (168 registers, dW 128); setmaxnreg moves the producer's to the
  // consumers
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = OP == kOpDw ? 216 : 232;
  static_assert(BN == 64 || BN == kF32WideN, "wgmma n64 or n96");
  static_assert(kF32K / 8 % kF32Steps == 0, "whole partials a stage");
  static_assert(kStageBytes % 1024 == 0 && kTileB % 1024 == 0,
                "swizzle atoms");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
  static_assert((kSmem + 1024) * kMinBlocks <= 228 * 1024,
                "blocks an SM (228 KB, 1 KB reserved a block)");
  static_assert(128 * (kProducerRegs + kWG * kConsumerRegs) * kMinBlocks <=
                    65536,
                "registers of an SM");
};

// ------------------------------------------------------------- products --
#define RP_F4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define RP_F16(d, j) RP_F4(d, j), RP_F4(d, j + 1), RP_F4(d, j + 2), \
                     RP_F4(d, j + 3)
#define RP_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define RP_D48                                                             \
  RP_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
         "%44, %45, %46, %47"

// d (+)= A . B^T over one 8-deep step, A in registers (this warp's 16 rows
// in the m16n8k8 tf32 A layout: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)), B K-major from shared memory; acc = 0 overwrites d.
// d holds N / 8 groups of the accumulator layout: d[j][e] at row 16 warp +
// lane / 4 + 8 (e >> 1), column 8 j + 2 (lane & 3) + (e & 1).
template <int N>
__device__ __forceinline__ void mma_rs_f32(float (&d)[N / 8][4],
                                           const unsigned (&a)[4],
                                           uint64_t b, int acc) {
  if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " RP_D48
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : RP_F16(d, 0), RP_F16(d, 4), RP_F16(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " RP_D32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : RP_F16(d, 0), RP_F16(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
}

// d (+)= A . B^T over one 8-deep step, A and B K-major from shared memory
template <int N>
__device__ __forceinline__ void mma_ss_f32(float (&d)[N / 8][4], uint64_t a,
                                           uint64_t b, int acc) {
  if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " RP_D48
        "}, %48, %49, p, 1, 1;\n}\n"
        : RP_F16(d, 0), RP_F16(d, 4), RP_F16(d, 8)
        : "l"(a), "l"(b), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " RP_D32
        "}, %32, %33, p, 1, 1;\n}\n"
        : RP_F16(d, 0), RP_F16(d, 4)
        : "l"(a), "l"(b), "r"(acc));
  }
}

#undef RP_D48
#undef RP_D32
#undef RP_F16
#undef RP_F4

// keeps the A fragments' registers unchanged until the products that read
// them are done (a wait precedes it)
__device__ __forceinline__ void fence_frags(unsigned (&h)[4][4],
                                            unsigned (&l)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+r"(h[q][e]), "+r"(l[q][e])::"memory");
}

// the running sum += a finished partial, one IEEE fp32 add an element
template <int J>
__device__ __forceinline__ void add_partial(float (&acc)[J][4],
                                            const float (&part)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
}

// R rows of 32 raw fp32 boxes (R / 32 boxes of 32 rows m by 32 columns c,
// each in the 128-byte swizzle as TMA lands it) split, transposed, into a
// hi / lo pair of K-major tiles (tile row c holds the 32 m in order; lo
// R * 128 bytes after hi).  Thread idx takes 16-byte chunk j (m = 4j ..
// 4j + 3) of tile row c: a warp reads 32 columns of one raw row and a
// quarter warp writes one chunk to each of 8 consecutive rows, both free of
// bank conflicts.
template <int R>
__device__ __forceinline__ void split_t(unsigned char* pair,
                                        const unsigned char* raw, int ltid) {
#pragma unroll
  for (int u = 0; u < R * 8 / 128; ++u) {
    const int idx = ltid + 128 * u, c = idx % R, j = idx / R, cc = c & 31;
    const unsigned char* rb = raw + (c >> 5) * kF32Box + 4 * (cc & 3);
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = 4 * j + q;
      x[q] = *reinterpret_cast<const float*>(rb + m * kRowBytes +
                                             (((cc >> 2) ^ (m & 7)) << 4));
    }
    uint4 h, l;
    split_tf32(x[0], h.x, l.x);
    split_tf32(x[1], h.y, l.y);
    split_tf32(x[2], h.z, l.z);
    split_tf32(x[3], h.w, l.w);
    const int off = c * kRowBytes + ((j ^ (c & 7)) << 4);
    *reinterpret_cast<uint4*>(pair + off) = h;
    *reinterpret_cast<uint4*>(pair + R * kRowBytes + off) = l;
  }
}

// ---------------------------------------------------------------- tiles --
// What one launch computes.  Forward and dX: out[M, N] from a depth-K
// product.  dW: the (Nout = M) x (Kin = N) weight gradient over the K rows
// of the cotangent, one fp32 partial per kDwChunk rows.
struct F32Args {
  const float* bias;   // forward: the Linear's bias (N)
  const float* resid;  // forward kBiasResid: (M, N), may alias out
  float* out;          // forward and dX (M, N); dW partials (S, M, N)
  float* aux;          // forward kBiasGeluSplit: acc + b (M, N) out; dX
                       // kDxGeluGrad: the pre-activation (M, N), may alias
                       // out
  int M, N, K;
};

struct F32Tile {
  int m0, n0, k0, nk, s;  // output origin, first row of the sum, stages,
                          // dW chunk
};

template <int OP, class Cfg>
__device__ __forceinline__ F32Tile f32_tile_at(int t, const F32Args& a) {
  const int ntn = a.N / Cfg::BN;
  F32Tile at;
  if constexpr (OP == kOpDw) {
    const int per = a.M / 64 * ntn;
    at.s = t / per;
    const int r = t - at.s * per;
    at.m0 = r / ntn * 64;
    at.n0 = r % ntn * Cfg::BN;
    at.k0 = at.s * kDwChunk;
    // the rows past the last chunk's end load as zeros
    at.nk = (min(a.K - at.k0, kDwChunk) + kF32K - 1) / kF32K;
  } else {
    at.s = 0;
    at.m0 = t / ntn * Cfg::BM;
    at.n0 = t % ntn * Cfg::BN;
    at.k0 = 0;
    at.nk = a.K / kF32K;
  }
  return at;
}

// ----------------------------------------------------------- epilogue --
// 32 staged rows of one consumer warpgroup (Cs, fp32, kLdc apart; staged
// row r is output row m0 + 16 (r / 8) + r % 8) from column n0 out through
// the epilogue, rows of 4 columns a thread (16-byte accesses), rows >= M
// skipped.  resid's / aux's loads all go ahead of the stores (the elements
// a thread reads are the ones it then writes, so they may alias out); each
// thread's columns repeat with period P, so it holds P bias vectors.
template <int OP, int EPI, int BN>
__device__ __forceinline__ void epilogue_f32(const F32Args& a,
                                             const float* Cs, int m0, int n0,
                                             int ltid, int wgi) {
  using Cfg = F32Cfg<OP, BN>;
  constexpr int C4 = BN / 4, kIters = 32 * C4 / 128;
  constexpr int P = C4 / gcd_int(128, C4);
  static_assert(32 * C4 % 128 == 0, "whole passes");
  constexpr bool kLoad = (OP == kOpFwd && EPI == kBiasResid) ||
                         (OP == kOpDx && EPI == kDxGeluGrad);
  float4 pre[kLoad ? kIters : 1];
  float4 bv[OP == kOpFwd ? P : 1];
  if constexpr (kLoad) {
    const float* src = OP == kOpFwd ? a.resid : a.aux;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int idx = ltid + 128 * i, r = idx / C4, c = (idx % C4) * 4;
      const int m = m0 + 16 * (r >> 3) + (r & 7);
      pre[i] = m < a.M ? *reinterpret_cast<const float4*>(
                             src + (size_t)m * a.N + n0 + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if constexpr (OP == kOpFwd) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      bv[i] = *reinterpret_cast<const float4*>(
          a.bias + n0 + ((ltid + 128 * i) % C4) * 4);
  }
  bar_sync_wg(1 + wgi);  // the staged rows are complete
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = ltid + 128 * i, r = idx / C4, c = (idx % C4) * 4;
    const int m = m0 + 16 * (r >> 3) + (r & 7);
    if (m >= a.M) continue;
    const size_t o = (size_t)m * a.N + n0 + c;
    const float4 v4 =
        *reinterpret_cast<const float4*>(Cs + r * Cfg::kLdc + c);
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float4 p4 = pre[kLoad ? i : 0];
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
    if constexpr (OP == kOpFwd) {
      const float4 b4 = bv[i % P];
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      float h[4], y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = v[e] + b[e];
        if constexpr (EPI == kBias) {
          y[e] = h[e];
        } else if constexpr (EPI == kBiasResid) {
          y[e] = p[e] + h[e];
        } else {  // kBiasGelu, kBiasGeluSplit: fp32 rounds nothing between
          y[e] = gelu_policy<float>(h[e]);
        }
      }
      if constexpr (EPI == kBiasGeluSplit)
        *reinterpret_cast<float4*>(a.aux + o) =
            make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(a.out + o) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else {  // kOpDx
      if constexpr (kLoad) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] *= gelu_grad_policy<float>(p[e]);
      }
      *reinterpret_cast<float4*>(a.out + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// --------------------------------------------------------- consumers --
// The products of one stage's k8 steps q0 .. q0 + kF32Steps - 1 into a
// fresh partial -- lo_a hi_b, then hi_a lo_b, then hi_a hi_b -- waited for
// and added to the running sum.  RS: A from the register fragments (a*),
// B from the hi / lo tiles (b*); SS: A too from tiles.
template <int BN>
__device__ __forceinline__ void partial_rs(float (&acc)[BN / 8][4],
                                           float (&part)[BN / 8][4],
                                           const unsigned (&ah)[4][4],
                                           const unsigned (&al)[4][4],
                                           uint64_t bh, uint64_t bl,
                                           int q0) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < kF32Steps; ++s)
    mma_rs_f32<BN>(part, al[q0 + s], kmajor_step(bh, q0 + s), s > 0);
#pragma unroll
  for (int s = 0; s < kF32Steps; ++s)
    mma_rs_f32<BN>(part, ah[q0 + s], kmajor_step(bl, q0 + s), 1);
#pragma unroll
  for (int s = 0; s < kF32Steps; ++s)
    mma_rs_f32<BN>(part, ah[q0 + s], kmajor_step(bh, q0 + s), 1);
  wg_commit();
  wg_wait<0>();
  fence_accum(part);
  add_partial(acc, part);
}

template <int BN>
__device__ __forceinline__ void partial_ss(float (&acc)[BN / 8][4],
                                           float (&part)[BN / 8][4],
                                           uint64_t ah, uint64_t al,
                                           uint64_t bh, uint64_t bl,
                                           int q0) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < kF32Steps; ++s)
    mma_ss_f32<BN>(part, kmajor_step(al, q0 + s), kmajor_step(bh, q0 + s),
                   s > 0);
#pragma unroll
  for (int s = 0; s < kF32Steps; ++s)
    mma_ss_f32<BN>(part, kmajor_step(ah, q0 + s), kmajor_step(bl, q0 + s),
                   1);
#pragma unroll
  for (int s = 0; s < kF32Steps; ++s)
    mma_ss_f32<BN>(part, kmajor_step(ah, q0 + s), kmajor_step(bh, q0 + s),
                   1);
  wg_commit();
  wg_wait<0>();
  fence_accum(part);
  add_partial(acc, part);
}

// Forward and dX: per stage, this warpgroup's 64 x 32 A fragments read
// from the raw box and split in registers, then the stage's partials into
// the running sum; the tile's epilogue.
template <int OP, int EPI, int BN>
__device__ __forceinline__ void consume_f32(const F32Args& a,
                                            unsigned char* sm, uint32_t base,
                                            uint32_t fullb, uint32_t emptyb,
                                            int tiles, int wgi) {
  using Cfg = F32Cfg<OP, BN>;
  constexpr int S = Cfg::kStages, J = BN / 8;
  const int ltid = threadIdx.x & 127, warp = ltid >> 5, lane = ltid & 31;
  const int g = lane >> 2;
  // fragment a[q][e] of k8 step q sits at row 64 wgi + 16 warp + g + 8 (e
  // & 1), column 8 q + (lane & 3) + 4 (e >> 1) of the stage's A box
  const int arow = (64 * wgi + 16 * warp + g) * kRowBytes + 4 * (lane & 3);
  float acc[J][4], part[J][4];
  unsigned ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const F32Tile at = f32_tile_at<OP, Cfg>(t, a);
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kk = 0; kk < at.nk; ++kk, ++it) {
      const int st = it % S;
      mbar_wait(fullb + 8 * st, (it / S) & 1);
      const unsigned char* As = sm + st * Cfg::kStageBytes + arow;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(*reinterpret_cast<const float*>(
                         As + (e & 1) * 8 * kRowBytes +
                         (((2 * q + (e >> 1)) ^ g) << 4)),
                     ah[q][e], al[q][e]);
      const uint32_t sb = base + st * Cfg::kStageBytes + Cfg::kABytes;
      const uint64_t bh = desc(sb), bl = desc(sb + Cfg::kTileB);
#pragma unroll
      for (int q0 = 0; q0 < kF32K / 8; q0 += kF32Steps)
        partial_rs<BN>(acc, part, ah, al, bh, bl, q0);
      fence_frags(ah, al);
      if (lane == 0) mbar_arrive(emptyb + 8 * st);
    }

    // this warpgroup's 64 rows out in two passes: pass h stages each
    // thread's rows lane / 4 + 8 h of its warp's 16 (32 rows: warp w's at
    // 8 w), then rows of 4 columns go out through the epilogue
    float* Cs = reinterpret_cast<float*>(sm + S * Cfg::kStageBytes) +
                wgi * 32 * Cfg::kLdc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bar_sync_wg(1 + wgi);  // the previous pass's reads are done
#pragma unroll
      for (int j = 0; j < J; ++j)
        *reinterpret_cast<float2*>(Cs + (warp * 8 + g) * Cfg::kLdc + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      asm volatile("" ::: "memory");
      epilogue_f32<OP, EPI, BN>(a, Cs, at.m0 + wgi * 64 + 8 * h, at.n0, ltid,
                                wgi);
    }
  }
}

// dW: per stage, the raw dY and X boxes split, transposed, into the
// K-major pairs A (64 rows of dW) and B (BN columns), then the stage's
// partials from shared memory into the running sum; each chunk's fp32
// partial of the tile written from the registers.
template <int BN>
__device__ __forceinline__ void consume_dw_f32(const F32Args& a,
                                               unsigned char* sm,
                                               uint32_t fullb,
                                               uint32_t emptyb, int tiles) {
  using Cfg = F32Cfg<kOpDw, BN>;
  constexpr int S = Cfg::kStages, J = BN / 8;
  const int ltid = threadIdx.x, warp = ltid >> 5, lane = ltid & 31;
  unsigned char* pa = sm + S * Cfg::kStageBytes;  // A hi, A lo
  unsigned char* pb = pa + Cfg::kPairA;           // B hi, B lo
  const uint32_t spa = smem_u32(pa), spb = smem_u32(pb);
  float acc[J][4], part[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const F32Tile at = f32_tile_at<kOpDw, Cfg>(t, a);
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kk = 0; kk < at.nk; ++kk, ++it) {
      const int st = it % S;
      mbar_wait(fullb + 8 * st, (it / S) & 1);
      const unsigned char* raw = sm + st * Cfg::kStageBytes;
      split_t<64>(pa, raw, ltid);
      split_t<BN>(pb, raw + Cfg::kABytes, ltid);
      proxy_fence();
      bar_sync_wg(1);  // the pairs are complete, the raw stage read
      if (lane == 0) mbar_arrive(emptyb + 8 * st);
      const uint64_t dah = desc(spa), dal = desc(spa + 64 * kRowBytes);
      const uint64_t dbh = desc(spb), dbl = desc(spb + Cfg::kTileB);
#pragma unroll
      for (int q0 = 0; q0 < kF32K / 8; q0 += kF32Steps)
        partial_ss<BN>(acc, part, dah, dal, dbh, dbl, q0);
      bar_sync_wg(1);  // every warp's products have read the pairs
    }
    // this chunk's fp32 partial, from the registers
    float* P = a.out + (size_t)at.s * a.M * a.N;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = at.m0 + warp * 16 + (lane >> 2) + 8 * h;
        const int c = at.n0 + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(P + (size_t)r * a.N + c) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
  }
}

// ------------------------------------------------------------- kernel --
// Block layout: consumer warpgroups 0 .. kWG - 1, then the producer.
// Shared memory: kStages stages, dW's pairs or the consumers' staging
// tiles, then the full and empty barriers.
template <int OP, int EPI, int BN>
__global__ void __launch_bounds__(F32Cfg<OP, BN>::kThreads,
                                  F32Cfg<OP, BN>::kMinBlocks)
gemm_f32_kernel(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb, const F32Args a,
                int tiles) {
  using Cfg = F32Cfg<OP, BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = aligned_smem(wg_smem);
  const uint32_t base = smem_u32(sm);
  const uint32_t fullb = base + Cfg::kBarOff, emptyb = fullb + 8 * S;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(fullb + 8 * st, 1);
      mbar_init(emptyb + 8 * st, 4 * Cfg::kWG);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == Cfg::kWG) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kProducerRegs));
    if (threadIdx.x == Cfg::kWG * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const F32Tile at = f32_tile_at<OP, Cfg>(t, a);
        for (int kk = 0; kk < at.nk; ++kk, ++it) {
          const int st = it % S;
          mbar_wait(emptyb + 8 * st, ((it / S) & 1) ^ 1);
          const uint32_t full = fullb + 8 * st;
          const uint32_t sa = base + st * Cfg::kStageBytes;
          const uint32_t sb = sa + Cfg::kABytes;
          const int k = at.k0 + kk * kF32K;
          mbar_expect_tx(full, Cfg::kStageBytes);
          if constexpr (OP == kOpDw) {
            tma_load_2d(sa, ma, full, at.m0, k);  // dY, columns m0 ..
            tma_load_2d(sa + kF32Box, ma, full, at.m0 + 32, k);
#pragma unroll
            for (int j = 0; j < BN / 32; ++j)  // X, columns n0 ..
              tma_load_2d(sb + j * kF32Box, mb, full, at.n0 + 32 * j, k);
          } else {
            tma_load_2d(sa, ma, full, k, at.m0);
            tma_load_2d(sb, mb, full, k, at.n0);                // hi
            tma_load_2d(sb + Cfg::kTileB, mb, full, k, a.N + at.n0);  // lo
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kConsumerRegs));
    if constexpr (OP == kOpDw)
      consume_dw_f32<BN>(a, sm, fullb, emptyb, tiles);
    else
      consume_f32<OP, EPI, BN>(a, sm, base, fullb, emptyb, tiles, wgi);
  }
}

// out[z] (2, R', C') = the TF32 hi rows, then the lo rows, of W[z] (R, C)
// or, with `transpose`, of its transpose (R' = C, C' = R), for z < gridDim.z
// stacked weights: the B operand of the forward and of dX.  32 x 32 tiles
// through shared memory, so that both the reads and the transposed writes
// are rows.
static __global__ void __launch_bounds__(256)
gemm_split_weight_kernel(const float* __restrict__ W,
                         float* __restrict__ out, int R, int C,
                         int transpose) {
  __shared__ float tile[32][33];
  const size_t n = (size_t)R * C;
  const float* w = W + blockIdx.z * n;
  float* o = out + 2 * blockIdx.z * n;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = r0 + i < R && c0 + tx < C
                      ? w[(size_t)(r0 + i) * C + c0 + tx]
                      : 0.f;
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    // row rr, column cc of the split matrix, ld its row length
    const int rr = transpose ? c0 + i : r0 + i;
    const int cc = transpose ? r0 + tx : c0 + tx;
    const int ld = transpose ? R : C;
    if (rr >= (transpose ? C : R) || cc >= ld) continue;
    unsigned h, l;
    split_tf32(transpose ? tile[tx][i] : tile[i][tx], h, l);
    o[(size_t)rr * ld + cc] = __uint_as_float(h);
    o[n + (size_t)rr * ld + cc] = __uint_as_float(l);
  }
}

// ------------------------------------------------------------ launchers --
// The tensor map of a row-major fp32 matrix (rows, cols): boxes of 32
// columns (128 bytes) by box_rows rows in the 128-byte swizzle; rows >=
// `rows` (and boxes past them) read as zeros.  TMA needs a 16-byte aligned
// base and row stride.
static cudaError_t map_f32(CUtensorMap* map, const float* base, int rows,
                           int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || cols % kF32K || rows < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kF32K, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

#define RP_TRY(call)                            \
  do {                                          \
    const cudaError_t rp_err_ = (call);         \
    if (rp_err_ != cudaSuccess) return rp_err_; \
  } while (0)

// One persistent launch over `tiles` tiles: at most as many blocks as the
// card holds at once (the shared-memory attribute and the count are set up
// once a device)
template <int OP, int EPI, int BN>
static cudaError_t f32_launch(const CUtensorMap& ma, const CUtensorMap& mb,
                              const F32Args& a, int tiles, cudaStream_t st) {
  using Cfg = F32Cfg<OP, BN>;
  auto kernel = gemm_f32_kernel<OP, EPI, BN>;
  constexpr int kDevices = 64;
  static int cap[kDevices];
  int dev;
  RP_TRY(cudaGetDevice(&dev));
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    int sms, per_sm;
    RP_TRY(smem_attr(kernel, Cfg::kSmem));
    RP_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    RP_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, Cfg::kThreads, Cfg::kSmem));
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap[dev] = sms * per_sm;
  }
  if (tiles < 1) return cudaSuccess;
  kernel<<<tiles < cap[dev] ? tiles : cap[dev], Cfg::kThreads, Cfg::kSmem,
           st>>>(ma, mb, a, tiles);
  return cudaGetLastError();
}

// the output columns of a tile: kF32WideN where the width allows, else 64
static int f32_tile_n(int N) { return N % kF32WideN == 0 ? kF32WideN : 64; }

// `rows` tiles down the output (dW: chunks x Nout / 64)
template <int OP, int EPI>
static cudaError_t f32_dispatch(const CUtensorMap& ma, const CUtensorMap& mb,
                                const F32Args& a, int rows, cudaStream_t st) {
  if (f32_tile_n(a.N) == kF32WideN)
    return f32_launch<OP, EPI, kF32WideN>(ma, mb, a,
                                          rows * (a.N / kF32WideN), st);
  return f32_launch<OP, EPI, 64>(ma, mb, a, rows * (a.N / 64), st);
}

// Ws (count, 2 R', C') from the stacked W (count, R, C): see
// gemm_split_weight_kernel
static cudaError_t split_weight_f32(const float* W, float* Ws, int count,
                                    int R, int C, bool transpose,
                                    cudaStream_t st) {
  if (count < 1 || count > 65535 || R < 1 || C < 1)
    return cudaErrorInvalidValue;
  gemm_split_weight_kernel<<<dim3((C + 31) / 32, (R + 31) / 32, count), 256,
                             0, st>>>(W, Ws, R, C, transpose ? 1 : 0);
  return cudaGetLastError();
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T) (common.cuh's Epilogue: kBias,
// kBiasGelu, kBiasResid, kBiasGeluSplit) from Ws = split_weight_f32(W), or
// dX's out[M, N] = epilogue(dY[M, K] . W[K, N]) (DxEpilogue) from Ws =
// split_weight_f32(W, transpose), W the torch Linear weight
template <int OP, int EPI>
static cudaError_t gemm_f32(const float* A, const float* Ws,
                            const float* bias, const float* resid, float* out,
                            float* aux, int M, int N, int K,
                            cudaStream_t st) {
  static_assert(OP != kOpDw, "gemm_dw_f32");
  if (M < 1 || N % 64 || K % kF32K) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  RP_TRY(map_f32(&ma, A, M, K, F32Cfg<OP, 64>::BM));
  RP_TRY(map_f32(&mb, Ws, 2 * N, K, f32_tile_n(N)));
  const F32Args a{bias, resid, out, aux, M, N, K};
  return f32_dispatch<OP, EPI>(ma, mb, a, (M + 127) / 128, st);
}

// dW (Nout, K) = dY^T X and db (Nout) = the column sums of dY over M rows:
// dY (M, Nout), X (M, K); part / bpart hold dw_chunks(M) partials of dW
// and db, summed in chunk order
static cudaError_t gemm_dw_f32(const float* dY, const float* X, float* dW,
                               float* db, float* part, float* bpart, int M,
                               int Nout, int K, cudaStream_t st) {
  if (M < 1 || Nout % 64 || K % 64) return cudaErrorInvalidValue;
  const int S = dw_chunks(M);
  gemm_dw_bias_kernel<<<dim3(S, Nout / 64), kBiasThreads, 0, st>>>(
      dY, bpart, M, Nout);
  RP_TRY(cudaGetLastError());
  CUtensorMap ma, mb;
  RP_TRY(map_f32(&ma, dY, M, Nout, 32));
  RP_TRY(map_f32(&mb, X, M, K, 32));
  const F32Args a{nullptr, nullptr, part, nullptr, Nout, K, M};
  RP_TRY((f32_dispatch<kOpDw, 0>(ma, mb, a, S * (Nout / 64), st)));
  RP_TRY(launch_sum_partials(part, S, (size_t)Nout * K, (size_t)Nout * K, dW,
                             st));
  return launch_sum_partials(bpart, S, Nout, Nout, db, st);
}

#undef RP_TRY

}  // namespace wg
}  // namespace tc
}  // namespace rp

// The bf16 GEMMs of the ViT stack (kernels #1 and #5) and of the essential
// block's qkv Linear on Hopper's
// warpgroup tensor-core products (wgmma) with operands brought by the
// Tensor Memory Accelerator (TMA), in persistent, warp-specialised blocks.
// fp32 runs on gemm_wgmma_f32.cuh (3xTF32 on TF32 wgmma), which shares this
// file's pieces.  The essential block's qkv Linear in bf16 (#2, #3) runs
// this forward too, with epilogue kRounded (essential_qkv_bf16,
// gemm_wgmma.cu).
//
// Replaces, in bf16, the jnp.dot / dot_general products inside
//   - rel_pose_tpu/ops/pallas_essential_block.py:
//     _essential_block_pair_kernel and _essential_block_x_kernel: the qkv
//     Linear (_linear_rounded), op kOpFwd with epilogue kRounded;
//   - rel_pose_tpu/ops/pallas_vit.py:_vit_stack_kernel: qkv (:129), proj
//     (:242), fc1 (:264), fc2 (:272) -- op kOpFwd, the Linear's forward
//     with common.cuh's epilogues kBias, kBiasResid, kBiasGelu;
//   - rel_pose_tpu/ops/pallas_vit_bwd.py:_vit_stack_bwd_kernel: the
//     recompute (:178, :183, :189; kOpFwd, fc1 as kBiasGeluSplit), dX
//     (:200, :208, :222, :232; kOpDx, epilogues kDxPlain and kDxGeluGrad)
//     and dW (:196, :204, :218, :228; kOpDw, split-K over kDwChunk rows).
//
// What bounds them on the H100: at the ViT widths (M = G * 576 rows, C =
// 192, hidden 768) one GEMM does 2 M K N operations on M K + M N bf16
// elements (and fp32 cotangents, GELU pre-activations and partials in the
// backward): 96-154 operations a byte, under the 295 at which the bf16
// tensor cores rather than HBM set the limit.  So HBM bounds each of them
// at the full tensor rate, and at K = 192 a 128 x 192 output tile has
// only three 64-deep K steps: the time goes to bringing operands in and
// writing outputs, not to the products.  The design:
//   - products: wgmma.mma_async m64nNk16 (bf16 in, fp32 sums), both
//     operands from shared memory in the 128-byte swizzle, N = 192 where
//     the output width allows (every GEMM at C = 192) and 64 otherwise
//     (the C = 64 / hidden 256 configuration);
//   - operands by TMA through 2-D tensor maps (columns, rows): rows past M
//     load as zeros, which handles the ragged last tile; a ring of
//     kGemmStages 64-deep K steps on mbarriers, filled by one producer
//     thread, emptied by the consumer warpgroups; each stage holds the A
//     box(es) and the B box(es) of one K step (40 KB at N = 192).  Layouts:
//     forward A and W K-major; dX dY' K-major and W MN-major (transpose
//     bit); dW dY'^T MN-major as A and X MN-major as B (both transposed);
//   - warp specialisation: one producer warpgroup (setmaxnreg down to 40
//     registers; one thread issues the loads) and kWG consumer warpgroups
//     (setmaxnreg up; a 64 x 192 fp32 accumulator is 96 registers a
//     thread).  Forward and dX: two consumers, 64 rows each of a 128-row
//     tile, sharing its B boxes.  dW: one consumer a block over a 64 x
//     192 tile of dW (Nout is 192 or 576, not a multiple of 128), two
//     blocks an SM;
//   - persistent: gridDim.x blocks walk the tiles in a fixed order, the
//     producer running ahead across tile boundaries, so that the next
//     tile's loads overlap this tile's epilogue.  The Nout / BN column
//     tiles of one row block are neighbours in that order, so blocks
//     running at once share A through L2 (dW: the tiles of one row chunk).
//     Not tried: a resident weight tile (192 x 192 bf16, 72 KB at K =
//     192), which a block could keep whenever the grid is a multiple of
//     the column tiles, leaving only A in the ring;
//   - epilogues element for element as common.cuh's Epilogue and
//     DxEpilogue: each consumer stages its fp32 sums through
//     shared memory and writes rows of 4 columns (8- and 16-byte accesses),
//     masked past M; resid may alias out, aux may alias out.  dW writes
//     per-chunk fp32 partials from the registers; its bias column sums of
//     the fp32 cotangent are a separate kernel (gemm_dw_bias_kernel) over
//     the same chunks; sum_partials adds both in chunk order.
// No atomics: every output element is summed in one fixed order, so two
// calls give the same bits.  bf16 x bf16 products are exact in fp32 and
// the sums are fp32: only their order differs from the plain version's.

#pragma once

#include "mma_helpers.cuh"  // bf16, store4, unpack4_bf16, split_tf32
#include "sm90.cuh"

namespace rp {
namespace tc {
namespace wg {

enum GemmOp { kOpFwd = 0, kOpDx = 1, kOpDw = 2 };

constexpr int kGemmK = 64;              // depth of one K step (128 bytes)
constexpr int kBox = 64 * kRowBytes;    // one 64 x 64 bf16 box, 8 KB
constexpr int kGemmStages = 4;          // forward and dX (dW: 3)
constexpr int kWideN = 192;             // output columns of a wide tile

template <int OP, int BN_>
struct GemmCfg {
  static constexpr int BN = BN_;                   // kWideN or 64
  static constexpr int kWG = OP == kOpDw ? 1 : 2;  // consumer warpgroups
  static constexpr int BM = 64 * kWG;
  static constexpr int kStages = OP == kOpDw ? 3 : kGemmStages;
  static constexpr int kTA = OP == kOpDw;   // A MN-major: transposed
  static constexpr int kTB = OP != kOpFwd;  // B MN-major: transposed
  static constexpr int kABytes = kWG * kBox;
  static constexpr int kBBytes = BN / 64 * kBox;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kLdc = BN + 8;  // staged fp32 row, conflict-free
  // a consumer stages half its 64 rows at a time
  static constexpr int kStagingBytes =
      OP == kOpDw ? 0 : kWG * 32 * kLdc * (int)sizeof(float);
  static constexpr int kBarOff = kStages * kStageBytes + kStagingBytes;
  static constexpr size_t kSmem = kAlign + kBarOff + 2 * kStages * 8;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kMinBlocks = OP == kOpDw ? 2 : 1;
  // registers a thread after setmaxnreg (producer + consumers: at most the
  // block's share at launch, 65,536 / kMinBlocks); ptxas allocates every
  // path within the launch's share (168 registers, dW 128), which the
  // epilogue is written to fit
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = OP == kOpDw ? 216 : 232;
  static_assert(BN == 64 || BN == kWideN, "wgmma n64 or n192");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
  static_assert(kSmem * kMinBlocks <= 227 * 1024,
                "blocks an SM (228 KB, 1 KB reserved a block)");
  static_assert(128 * (kProducerRegs + kWG * kConsumerRegs) * kMinBlocks <=
                    65536,
                "registers of an SM");
};

// ------------------------------------------------------------- products --
#define RP_F4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define RP_F32(d, j)                                                    \
  RP_F4(d, j), RP_F4(d, j + 1), RP_F4(d, j + 2), RP_F4(d, j + 3),       \
      RP_F4(d, j + 4), RP_F4(d, j + 5), RP_F4(d, j + 6), RP_F4(d, j + 7)

// d (+)= A . B over one 16-deep step, A and B from shared memory (the
// descriptors), TA / TB the transpose bits (1: MN-major); acc = 0
// overwrites d.  d holds N / 8 groups of the m64nN accumulator layout:
// d[j][e] at row 16 warp + lane / 4 + 8 (e >> 1), column 8 j + 2 (lane &
// 3) + (e & 1).
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_gemm(float (&d)[N / 8][4], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : RP_F32(d, 0), RP_F32(d, 8), RP_F32(d, 16)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : RP_F32(d, 0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
}

#undef RP_F32
#undef RP_F4

// keeps the compiler from moving the accumulator's reads or writes across
// the asynchronous products
template <int J>
__device__ __forceinline__ void fence_accum(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- tiles --
// What one launch computes.  Forward and dX: out[M, N] from a depth-K
// product.  dW: the (Nout = M) x (Kin = N) weight gradient over the K rows
// of the cotangent, one fp32 partial per kDwChunk rows.
struct GemmArgs {
  const float* bias;  // forward: the Linear's bias (N)
  const bf16* resid;  // forward kBiasResid: (M, N), may alias out
  void* out;          // forward bf16, dX fp32 (M, N); dW partials (S, M, N)
  float* aux;         // forward kBiasGeluSplit: acc + b (M, N) out; dX
                      // kDxGeluGrad: the pre-activation (M, N), may alias out
  bf16* outb;         // dX: T(out) (M, N), or null
  int M, N, K;
};

struct TileAt {
  int m0, n0, k0, nk, s;  // output origin, first row of the sum, K steps,
                          // dW chunk
};

template <int OP, class Cfg>
__device__ __forceinline__ TileAt tile_at(int t, const GemmArgs& a) {
  const int ntn = a.N / Cfg::BN;
  TileAt at;
  if constexpr (OP == kOpDw) {
    const int per = a.M / 64 * ntn;
    at.s = t / per;
    const int r = t - at.s * per;
    at.m0 = r / ntn * 64;
    at.n0 = r % ntn * Cfg::BN;
    at.k0 = at.s * kDwChunk;
    at.nk = (min(a.K - at.k0, kDwChunk) + kGemmK - 1) / kGemmK;
  } else {
    at.s = 0;
    at.m0 = t / ntn * Cfg::BM;
    at.n0 = t % ntn * Cfg::BN;
    at.k0 = 0;
    at.nk = a.K / kGemmK;
  }
  return at;
}

// ----------------------------------------------------------- epilogue --
__host__ __device__ constexpr int gcd_int(int x, int y) {
  return y == 0 ? x : gcd_int(y, x % y);
}

// 32 staged rows of one consumer warpgroup (Cs, fp32, kLdc apart; staged
// row r is output row m0 + 16 (r / 8) + r % 8) from column n0 out through
// the epilogue, rows of 4 columns a thread (8- and 16-byte accesses), rows
// >= M skipped.  The global loads go ahead of the stores, many in flight at
// once (the resid / aux elements a thread reads are the ones it then
// writes, each read before its write, so they may alias out); each
// thread's columns repeat with period P, so it holds P bias vectors.
template <int OP, int EPI, int BN>
__device__ __forceinline__ void epilogue(const GemmArgs& a, const float* Cs,
                                         int m0, int n0, int ltid, int wgi) {
  using Cfg = GemmCfg<OP, BN>;
  constexpr int C4 = BN / 4, kIters = 32 * C4 / 128;
  constexpr int P = C4 / gcd_int(128, C4);
  static_assert(32 * C4 % 128 == 0, "whole passes");
  constexpr bool kResid = OP == kOpFwd && EPI == kBiasResid;
  constexpr bool kAux = OP == kOpDx && EPI == kDxGeluGrad;
  // loads in flight: all of resid's; aux's (16 bytes each) in a window of
  // W, refilled as each is used, so that they fit the registers
  constexpr int W = kAux && kIters > 6 ? 6 : kIters;
  uint2 rs[kResid ? W : 1];
  float4 hx[kAux ? W : 1];
  float4 bv[OP == kOpFwd ? P : 1];
  auto prefetch = [&](int i) {
    const int idx = ltid + 128 * i, r = idx / C4, c = (idx % C4) * 4;
    const int m = m0 + 16 * (r >> 3) + (r & 7);
    const bool ok = m < a.M;
    const size_t o = (size_t)(ok ? m : 0) * a.N + n0 + c;
    if constexpr (kResid)
      rs[i % W] = ok ? *reinterpret_cast<const uint2*>(a.resid + o)
                     : make_uint2(0u, 0u);
    if constexpr (kAux)
      hx[i % W] = ok ? *reinterpret_cast<const float4*>(a.aux + o)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  };
#pragma unroll
  for (int i = 0; i < W; ++i) prefetch(i);
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
    uint2 rsi = rs[kResid ? i % W : 0];
    float4 hxi = hx[kAux ? i % W : 0];
    if (i + W < kIters) prefetch(i + W);
    if (m >= a.M) continue;
    const size_t o = (size_t)m * a.N + n0 + c;
    const float4 v4 =
        *reinterpret_cast<const float4*>(Cs + r * Cfg::kLdc + c);
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
    if constexpr (OP == kOpFwd) {
      const float4 b4 = bv[i % P];
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      float rv[4], y[4];
      if constexpr (kResid) unpack4_bf16(rsi, rv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (EPI == kBias) {
          y[e] = v[e] + b[e];
        } else if constexpr (EPI == kRounded) {
          y[e] = round_to<bf16>(v[e]) + round_to<bf16>(b[e]);
        } else if constexpr (EPI == kBiasGelu) {
          y[e] = gelu_policy<bf16>(round_to<bf16>(v[e] + b[e]));
        } else if constexpr (EPI == kBiasResid) {
          y[e] = rv[e] + (v[e] + b[e]);
        } else {  // kBiasGeluSplit
          y[e] = gelu_policy<bf16>(v[e] + b[e]);
        }
      }
      if constexpr (EPI == kBiasGeluSplit)
        *reinterpret_cast<float4*>(a.aux + o) = make_float4(
            v[0] + b[0], v[1] + b[1], v[2] + b[2], v[3] + b[3]);
      store4(static_cast<bf16*>(a.out) + o, y);
    } else {  // kOpDx
      if constexpr (kAux) {
        v[0] *= gelu_grad_policy<bf16>(hxi.x);
        v[1] *= gelu_grad_policy<bf16>(hxi.y);
        v[2] *= gelu_grad_policy<bf16>(hxi.z);
        v[3] *= gelu_grad_policy<bf16>(hxi.w);
      }
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
          make_float4(v[0], v[1], v[2], v[3]);
      if (a.outb) store4(a.outb + o, v);
    }
  }
}

// The consumer warpgroups' side of gemm_wgmma_kernel: the products of each
// tile from the ring, then its epilogue
template <int OP, int EPI, int BN>
__device__ __forceinline__ void consume(const GemmArgs& a, unsigned char* sm,
                                        uint32_t base, uint32_t fullb,
                                        uint32_t emptyb, int tiles, int wgi) {
  using Cfg = GemmCfg<OP, BN>;
  constexpr int S = Cfg::kStages;
  const int ltid = threadIdx.x & 127, warp = ltid >> 5, lane = ltid & 31;
  float acc[BN / 8][4];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at<OP, Cfg>(t, a);
    // the first product overwrites acc: zeros here end the previous tile's
    // values (otherwise live into its asm) before the epilogue
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kk = 0; kk < at.nk; ++kk, ++it) {
      const int st = it % S;
      mbar_wait(fullb + 8 * st, (it / S) & 1);
      const uint32_t sa = base + st * Cfg::kStageBytes + wgi * kBox;
      const uint32_t sb = base + st * Cfg::kStageBytes + Cfg::kABytes;
      const uint64_t da = desc(sa);
      const uint64_t db = desc(sb, Cfg::kTB ? kBox : kSbo);
      fence_accum(acc);
      wg_fence();
#pragma unroll
      for (int k16 = 0; k16 < kGemmK / 16; ++k16)
        mma_gemm<BN, Cfg::kTA, Cfg::kTB>(
            acc, Cfg::kTA ? mnmajor_step(da, k16) : kmajor_step(da, k16),
            Cfg::kTB ? mnmajor_step(db, k16) : kmajor_step(db, k16),
            kk > 0 || k16 > 0);
      wg_commit();
      if (kk > 0) {  // the previous step's products are done: free it
        wg_wait<1>();
        if (lane == 0) mbar_arrive(emptyb + 8 * ((it - 1) % S));
      }
    }
    wg_wait<0>();
    fence_accum(acc);
    if (lane == 0) mbar_arrive(emptyb + 8 * ((it - 1) % S));

    if constexpr (OP == kOpDw) {
      // this chunk's fp32 partial, from the registers
      float* P = static_cast<float*>(a.out) + (size_t)at.s * a.M * a.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = at.m0 + warp * 16 + (lane >> 2) + 8 * half;
          const int c = at.n0 + 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(P + (size_t)r * a.N + c) =
              make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        }
    } else {
      // this warpgroup's 64 rows out in two passes: pass h stages each
      // thread's rows lane / 4 + 8 h of its warp's 16 (32 rows: warp w's at
      // 8 w), then rows of 4 columns go out through the epilogue
      float* Cs = reinterpret_cast<float*>(sm + S * Cfg::kStageBytes) +
                  wgi * 32 * Cfg::kLdc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bar_sync_wg(1 + wgi);  // the previous pass's reads are done
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(Cs + (warp * 8 + (lane >> 2)) *
                                              Cfg::kLdc +
                                     8 * j + 2 * (lane & 3)) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        // the epilogue's global loads after these stores, with the
        // registers of the staged half free
        asm volatile("" ::: "memory");
        epilogue<OP, EPI, BN>(a, Cs, at.m0 + wgi * 64 + 8 * h, at.n0, ltid,
                              wgi);
      }
    }
  }
}

// ------------------------------------------------------------- kernel --
// Block layout: consumer warpgroups 0 .. kWG - 1, then the producer.
// Shared memory: Cfg::kStages stages [A boxes | B boxes], the consumers'
// staging tiles (forward, dX), then the full and empty barriers.
template <int OP, int EPI, int BN>
__global__ void __launch_bounds__(GemmCfg<OP, BN>::kThreads,
                                  GemmCfg<OP, BN>::kMinBlocks)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mb, const GemmArgs a,
                  int tiles) {
  using Cfg = GemmCfg<OP, BN>;
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
        const TileAt at = tile_at<OP, Cfg>(t, a);
        for (int kk = 0; kk < at.nk; ++kk, ++it) {
          const int st = it % S;
          mbar_wait(emptyb + 8 * st, ((it / S) & 1) ^ 1);
          const uint32_t full = fullb + 8 * st;
          const uint32_t sa = base + st * Cfg::kStageBytes;
          const uint32_t sb = sa + Cfg::kABytes;
          const int k = at.k0 + kk * kGemmK;
          mbar_expect_tx(full, Cfg::kStageBytes);
          if constexpr (OP == kOpDw) {
            tma_load_2d(sa, ma, full, at.m0, k);
          } else {
            tma_load_2d(sa, ma, full, k, at.m0);
          }
          if constexpr (OP == kOpFwd) {
            tma_load_2d(sb, mb, full, k, at.n0);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(sb + j * kBox, mb, full, at.n0 + 64 * j, k);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kConsumerRegs));
    consume<OP, EPI, BN>(a, sm, base, fullb, emptyb, tiles, wgi);
  }
}

// dW's bias partials: bpart[s][n] = sum over the rows of chunk s of dY[m,
// n] (fp32), block (chunk, 64 columns), 16 threads a row of 64 columns
// (float4 each) over every 16th row, the 16 row groups added in order
constexpr int kBiasThreads = 256;

static __global__ void __launch_bounds__(kBiasThreads)
gemm_dw_bias_kernel(const float* __restrict__ dY, float* __restrict__ bpart,
                    int M, int Nout) {
  __shared__ float4 red[kBiasThreads / 16][16];
  const int s = blockIdx.x, n0 = blockIdx.y * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int mbeg = s * kDwChunk, mend = min(M, mbeg + kDwChunk);
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int m = mbeg + ty; m < mend; m += kBiasThreads / 16) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        dY + (size_t)m * Nout + n0 + 4 * tx));
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  red[ty][tx] = t;
  __syncthreads();
  if (threadIdx.x < 64) {
    const int q = threadIdx.x >> 2, e = threadIdx.x & 3;
    float u = 0.f;
    for (int y = 0; y < kBiasThreads / 16; ++y) {
      const float4 r = red[y][q];
      u += e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
    }
    bpart[(size_t)s * Nout + n0 + threadIdx.x] = u;
  }
}

// ------------------------------------------------------------ launchers --
// The tensor map of a row-major bf16 matrix (rows, cols), 64-column boxes
// of box_rows rows in the 128-byte swizzle; rows >= `rows` read as zeros.
// TMA needs a 16-byte aligned base and row stride.
static cudaError_t gemm_map(CUtensorMap* map, const bf16* base, int rows,
                            int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || cols % 64 || rows < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(base), dims, strides, box, estr,
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
static cudaError_t gemm_launch(const CUtensorMap& ma, const CUtensorMap& mb,
                               const GemmArgs& a, int tiles,
                               cudaStream_t st) {
  using Cfg = GemmCfg<OP, BN>;
  auto kernel = gemm_wgmma_kernel<OP, EPI, BN>;
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

// kWideN-column tiles where the width allows, else 64; `rows` tiles down
// the output (dW: chunks x Nout / 64)
template <int OP, int EPI>
static cudaError_t gemm_dispatch(const CUtensorMap& ma, const CUtensorMap& mb,
                                 const GemmArgs& a, int rows,
                                 cudaStream_t st) {
  if (a.N % kWideN == 0)
    return gemm_launch<OP, EPI, kWideN>(ma, mb, a, rows * (a.N / kWideN), st);
  return gemm_launch<OP, EPI, 64>(ma, mb, a, rows * (a.N / 64), st);
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T): the forward of a Linear
// (common.cuh's Epilogue: kBias, kBiasGelu, kBiasResid, kBiasGeluSplit,
// kRounded)
template <int EPI>
static cudaError_t gemm_fwd(const bf16* A, const bf16* W, const float* bias,
                            const bf16* resid, bf16* out, float* aux, int M,
                            int N, int K, cudaStream_t st) {
  if (M < 1 || N % 64 || K % kGemmK) return cudaErrorInvalidValue;
  const int box_n = N % kWideN == 0 ? kWideN : 64;
  CUtensorMap ma, mb;
  RP_TRY(gemm_map(&ma, A, M, K, 128));
  RP_TRY(gemm_map(&mb, W, N, K, box_n));
  const GemmArgs a{bias, resid, out, aux, nullptr, M, N, K};
  return gemm_dispatch<kOpFwd, EPI>(ma, mb, a, (M + 127) / 128, st);
}

// out[M, N] = epilogue(dY'[M, K] . W[K, N]) in fp32 (common.cuh's
// DxEpilogue), W the torch Linear weight (K = its out features), dY' the
// cotangent's bf16 copy; with outb, T(out) there too
template <int EPI>
static cudaError_t gemm_dx(const bf16* dYb, const bf16* W, const float* aux,
                           float* out, bf16* outb, int M, int N, int K,
                           cudaStream_t st) {
  if (M < 1 || N % 64 || K % kGemmK) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  RP_TRY(gemm_map(&ma, dYb, M, K, 128));
  RP_TRY(gemm_map(&mb, W, K, N, 64));
  const GemmArgs a{nullptr, nullptr, out, const_cast<float*>(aux), outb, M,
                   N, K};
  return gemm_dispatch<kOpDx, EPI>(ma, mb, a, (M + 127) / 128, st);
}

// dW (Nout, K) = dY'^T X and db (Nout) = the column sums of dY over M rows:
// dY' the fp32 cotangent dY's bf16 copy, X (M, K); part / bpart hold
// dw_chunks(M) partials of dW and db, summed in chunk order
static cudaError_t gemm_dw(const bf16* dYb, const float* dY, const bf16* X,
                           float* dW, float* db, float* part, float* bpart,
                           int M, int Nout, int K, cudaStream_t st) {
  if (M < 1 || Nout % 64 || K % 64) return cudaErrorInvalidValue;
  const int S = dw_chunks(M);
  gemm_dw_bias_kernel<<<dim3(S, Nout / 64), kBiasThreads, 0, st>>>(
      dY, bpart, M, Nout);
  RP_TRY(cudaGetLastError());
  CUtensorMap ma, mb;
  RP_TRY(gemm_map(&ma, dYb, M, Nout, 64));
  RP_TRY(gemm_map(&mb, X, M, K, 64));
  const GemmArgs a{nullptr, nullptr, part, nullptr, nullptr, Nout, K, M};
  RP_TRY((gemm_dispatch<kOpDw, 0>(ma, mb, a, S * (Nout / 64), st)));
  RP_TRY(launch_sum_partials(part, S, (size_t)Nout * K, (size_t)Nout * K, dW,
                             st));
  return launch_sum_partials(bpart, S, Nout, Nout, db, st);
}

#undef RP_TRY

}  // namespace wg
}  // namespace tc
}  // namespace rp

// Tensor-core GEMMs of the ViT stack's bf16 path (kernels #1 and #5), and
// the mma.sync / ldmatrix / cp.async helpers that attention_tc.cuh shares.
//
// Replaces, for bf16 only, the SIMT gemm_kernel / gemm_dx_kernel /
// gemm_dw_kernel of common.cuh inside rel_pose_tpu/ops/pallas_vit.py:
// _vit_stack_kernel (qkv, proj, fc1, fc2) and pallas_vit_bwd.py:
// _vit_stack_bwd_kernel (the recompute, dX and dW of the same Linears).
// The fp32 path keeps common.cuh's SIMT kernels, bit for bit: the tensor
// cores have no fp32 product, and TF32 would change the results.
//
// What bounds them on the H100: at the ViT widths (M = G * 576 rows, K =
// 192 or 768, Nout = 192, 576 or 768) one GEMM does 2 M K Nout operations
// on 2 (M K + M Nout) bytes, 96-153 operations per byte, below the 295 at
// which the bf16 tensor cores rather than HBM are the limit: alone, each
// would wait on device memory at the full tensor-core rate.  (The stack's
// bound counts only its own inputs and outputs and is set by the
// operations.)  At the rate mma.sync reaches, the products themselves
// and the ldmatrix loads feeding them decide.
//
// Design: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on operands loaded
// from padded shared-memory tiles with ldmatrix (.trans for the operands
// that the backward reads along their other axis), fed by a 3-stage
// cp.async ring of K steps (128 x 192 output tiles, 64 deep, where the
// widths allow).  mma.sync and not wgmma + TMA: this is
// the first tensor-core version of these kernels, written without a way to
// compile or run it outside the card; mma.sync reaches a fraction of
// Hopper's wgmma rate (the gap is recorded in PERF.md), and moving to
// wgmma is later work.  Every product keeps the Pallas kernels' rounding
// points: operands are bf16 (bf16 x bf16 products are exact in fp32), sums
// are fp32, only their order differs from the SIMT kernels, and the
// epilogues are common.cuh's, element for element.  fp32 cotangents enter
// a product as T(dY): the producing kernel (or a cast kernel) writes the
// bf16 copy once, which gives the same bits as rounding on the load.  No
// atomics: the dW GEMM writes per-chunk partials that sum_partials adds
// in order, so two calls give the same bits.

#pragma once

#include "common.cuh"

namespace rp {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8j .. 8j+7 give the row addresses of j
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) . b (16x8, col); fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Accumulator layout of one m16n8 tile, lane = 4 g + t: c[0], c[1] at
// (row g, columns 2t, 2t + 1), c[2], c[3] at row g + 8.

// ------------------------------------------------------------ tile GEMM --
// C[BM, BN] += A[BM, K] . B[K, BN] over k in [kbeg, kend), bf16 operands.
// A is K-major (element (m, k) at A[m * lda + k]) or M-major (at
// A[k * lda + m]); B is K-major (element (k, n) at B[n * ldb + k], the
// torch Linear weight) or N-major (at B[k * ldb + n]).  Rows m >= m_end of
// a K-major A and k >= kend of an M-major A or N-major B load as zeros.
template <int BM_, int BN_, int WM_, int WN_, bool AK_, bool BK_,
          int BK_DEPTH = 32, int STAGES = 3>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr bool kAK = AK_, kBK = BK_;
  static constexpr int BK = BK_DEPTH, kStages = STAGES;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  // padded rows: 8 consecutive ldmatrix rows fall in distinct banks
  static constexpr int A_LD = kAK ? BK + 8 : BM + 8;
  static constexpr int A_ELEMS = kAK ? BM * A_LD : BK * A_LD;
  static constexpr int B_LD = kBK ? BK + 8 : BN + 8;
  static constexpr int B_ELEMS = kBK ? BN * B_LD : BK * B_LD;
  static constexpr int kStageElems = A_ELEMS + B_ELEMS;
  static constexpr int kSmemElems = kStages * kStageElems;
  static constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BN * BK / 8;
  static_assert(TM % 16 == 0 && NI % 2 == 0, "warp tile: 16 x 16 steps");
  static_assert(A_CHUNKS % kThreads == 0 && B_CHUNKS % kThreads == 0,
                "tile loads: whole steps");
  static constexpr int kSmemBytes = kSmemElems * 2;  // dynamic
  static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");
};

// launch attributes of a kernel with Cfg's dynamic shared memory
template <class Cfg, class K>
static cudaError_t prepare(K kernel) {
  if (Cfg::kSmemBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg::kSmemBytes);
}

template <class Cfg>
__device__ __forceinline__ void load_stage(bf16* st, const bf16* A,
                                           size_t lda, const bf16* B,
                                           size_t ldb, int m0, int n0, int k0,
                                           int m_end, int kend, int tid) {
  bf16* As = st;
  bf16* Bs = st + Cfg::A_ELEMS;
#pragma unroll
  for (int u = 0; u < Cfg::A_CHUNKS / Cfg::kThreads; ++u) {
    const int c = tid + u * Cfg::kThreads;
    if (Cfg::kAK) {
      constexpr int CPR = Cfg::BK / 8;
      const int r = c / CPR, kc = (c % CPR) * 8;
      const bool ok = m0 + r < m_end;
      cp_async16(As + r * Cfg::A_LD + kc,
                 A + (size_t)(ok ? m0 + r : 0) * lda + k0 + kc, ok);
    } else {
      constexpr int CPR = Cfg::BM / 8;
      const int r = c / CPR, mc = (c % CPR) * 8;
      const bool ok = k0 + r < kend;
      cp_async16(As + r * Cfg::A_LD + mc,
                 A + (size_t)(ok ? k0 + r : 0) * lda + m0 + mc, ok);
    }
  }
#pragma unroll
  for (int u = 0; u < Cfg::B_CHUNKS / Cfg::kThreads; ++u) {
    const int c = tid + u * Cfg::kThreads;
    if (Cfg::kBK) {
      constexpr int CPR = Cfg::BK / 8;
      const int r = c / CPR, kc = (c % CPR) * 8;
      cp_async16(Bs + r * Cfg::B_LD + kc, B + (size_t)(n0 + r) * ldb + k0 + kc,
                 true);
    } else {
      constexpr int CPR = Cfg::BN / 8;
      const int r = c / CPR, nc = (c % CPR) * 8;
      const bool ok = k0 + r < kend;
      cp_async16(Bs + r * Cfg::B_LD + nc,
                 B + (size_t)(ok ? k0 + r : 0) * ldb + n0 + nc, ok);
    }
  }
}

template <class Cfg>
__device__ __forceinline__ void compute_stage(
    const bf16* st, float (&acc)[Cfg::MI][Cfg::NI][4], int wm, int wn,
    int lane) {
  const bf16* As = st;
  const bf16* Bs = st + Cfg::A_ELEMS;
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; kk += 16) {
    unsigned af[Cfg::MI][4], bfr[Cfg::NI][2];
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi) {
      const int row0 = wm * Cfg::TM + mi * 16;
      if (Cfg::kAK)
        ldsm_x4(af[mi], As + (row0 + (lane & 15)) * Cfg::A_LD + kk +
                            (lane >> 4) * 8);
      else
        ldsm_x4_t(af[mi], As + (kk + (lane & 7) + (lane >> 4) * 8) *
                                   Cfg::A_LD +
                              row0 + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ni += 2) {
      const int col0 = wn * Cfg::TN + ni * 8;
      unsigned r[4];
      if (Cfg::kBK)
        ldsm_x4(r, Bs + (col0 + (lane & 7) + (lane >> 4) * 8) * Cfg::B_LD +
                       kk + ((lane >> 3) & 1) * 8);
      else
        ldsm_x4_t(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              Cfg::B_LD +
                         col0 + (lane >> 4) * 8);
      bfr[ni][0] = r[0];
      bfr[ni][1] = r[1];
      bfr[ni + 1][0] = r[2];
      bfr[ni + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
  }
}

// acc = A[m0:, kbeg:kend] . B[kbeg:kend, n0:] through the cp.async ring
template <class Cfg>
__device__ __forceinline__ void mainloop(bf16* smem, const bf16* A,
                                         size_t lda, const bf16* B,
                                         size_t ldb, int m0, int n0, int kbeg,
                                         int kend, int m_end,
                                         float (&acc)[Cfg::MI][Cfg::NI][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int nk = (kend - kbeg + Cfg::BK - 1) / Cfg::BK;
#pragma unroll
  for (int s = 0; s < Cfg::kStages - 1; ++s) {
    if (s < nk)
      load_stage<Cfg>(smem + s * Cfg::kStageElems, A, lda, B, ldb, m0, n0,
                      kbeg + s * Cfg::BK, m_end, kend, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<Cfg::kStages - 2>();
    __syncthreads();
    // the stage read at kt - 1 is free: every thread passed the barrier
    const int nt = kt + Cfg::kStages - 1;
    if (nt < nk)
      load_stage<Cfg>(smem + (nt % Cfg::kStages) * Cfg::kStageElems, A, lda,
                      B, ldb, m0, n0, kbeg + nt * Cfg::BK, m_end, kend, tid);
    cp_async_commit();
    compute_stage<Cfg>(smem + (kt % Cfg::kStages) * Cfg::kStageElems, acc, wm,
                       wn, lane);
  }
  cp_async_wait<0>();
}

// (row, column) of acc[mi][ni][2 * half] within the block tile
template <class Cfg>
__device__ __forceinline__ void acc_coords(int mi, int ni, int half, int& r,
                                           int& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r = (warp / Cfg::WN) * Cfg::TM + mi * 16 + (lane >> 2) + half * 8;
  c = (warp % Cfg::WN) * Cfg::TN + ni * 8 + 2 * (lane & 3);
}

// The block's fp32 sums, staged through the (drained) pipeline buffers as
// a [BM][BN + 8] tile, so that the epilogue reads and writes rows of 4
// consecutive columns: coalesced 8- and 16-byte accesses to out, resid and
// aux instead of 4-byte ones scattered over 8 rows.
template <class Cfg>
__device__ __forceinline__ float* stage_acc(
    bf16* smem, const float (&acc)[Cfg::MI][Cfg::NI][4]) {
  constexpr int LDC = Cfg::BN + 8;
  static_assert(Cfg::kSmemElems * sizeof(bf16) >=
                    Cfg::BM * LDC * sizeof(float),
                "the staged tile fits the pipeline buffers");
  float* Cs = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the pipeline buffers
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int r, c;
        acc_coords<Cfg>(mi, ni, half, r, c);
        *reinterpret_cast<float2*>(Cs + r * LDC + c) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
  __syncthreads();
  return Cs;
}

__device__ __forceinline__ uint2 pack4_bf16(const float (&v)[4]) {
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ void unpack4_bf16(uint2 u, float (&v)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// ------------------------------------------------------- forward GEMM --
// out[M, Nout] = epilogue(A[M, K] . W[Nout, K]^T) in bf16, common.cuh's
// Epilogue values (kBias, kBiasGelu, kBiasResid, kBiasGeluSplit); resid
// may alias out (each element is read, then written, by one thread).
using FwdTile = Tile<128, 64, 2, 2, true, true>;

template <int EPI, class Cfg = FwdTile>
__global__ void __launch_bounds__(Cfg::kThreads)
gemm_fwd_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                const float* __restrict__ bias, const bf16* resid, bf16* out,
                float* __restrict__ aux, int M, int Nout, int K) {
  extern __shared__ __align__(128) bf16 smem[];
  const int m0 = blockIdx.y * Cfg::BM, n0 = blockIdx.x * Cfg::BN;
  float acc[Cfg::MI][Cfg::NI][4];
  mainloop<Cfg>(smem, A, K, W, K, m0, n0, 0, K, M, acc);
  const float* Cs = stage_acc<Cfg>(smem, acc);
  constexpr int LDC = Cfg::BN + 8, C4 = Cfg::BN / 4;
  for (int idx = threadIdx.x; idx < Cfg::BM * C4; idx += Cfg::kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    const size_t o = (size_t)m * Nout + n;
    const float4 a4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    const float4 b4 = *reinterpret_cast<const float4*>(bias + n);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float rs[4], v[4];
    if (EPI == kBiasResid)
      unpack4_bf16(*reinterpret_cast<const uint2*>(resid + o), rs);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (EPI == kBias) {
        v[j] = a[j] + b[j];
      } else if (EPI == kBiasGelu) {
        v[j] = gelu_policy<bf16>(round_to<bf16>(a[j] + b[j]));
      } else if (EPI == kBiasResid) {
        v[j] = rs[j] + (a[j] + b[j]);
      } else {  // kBiasGeluSplit
        v[j] = gelu_policy<bf16>(a[j] + b[j]);
      }
    }
    if (EPI == kBiasGeluSplit)
      *reinterpret_cast<float4*>(aux + o) =
          make_float4(a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3]);
    *reinterpret_cast<uint2*>(out + o) = pack4_bf16(v);
  }
}

// 192 output columns and 64-deep K steps per block where the widths allow
// (every ViT GEMM at C = 192): A is read from L2 a third as often as with
// 64-column tiles, with half as many barriers (one 138 KB block per SM;
// the fastest of the tiles tried on an H100 at the eval shapes)
using FwdWide = Tile<128, 192, 4, 2, true, true, 64, 3>;

template <int EPI, class Cfg>
static cudaError_t launch_gemm_cfg(const bf16* A, const bf16* W,
                                   const float* bias, const bf16* resid,
                                   bf16* out, int M, int Nout, int K,
                                   cudaStream_t stream, float* aux) {
  static_assert(EPI != kRounded, "kRounded stays on common.cuh");
  const int mt = (M + Cfg::BM - 1) / Cfg::BM;
  if (Nout % Cfg::BN || K % Cfg::BK || mt > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare<Cfg>(gemm_fwd_kernel<EPI, Cfg>);
  if (err != cudaSuccess) return err;
  gemm_fwd_kernel<EPI, Cfg><<<dim3(Nout / Cfg::BN, mt), Cfg::kThreads,
                              Cfg::kSmemBytes, stream>>>(
      A, W, bias, resid, out, aux, M, Nout, K);
  return cudaGetLastError();
}

template <int EPI>
static cudaError_t launch_gemm(const bf16* A, const bf16* W,
                               const float* bias, const bf16* resid,
                               bf16* out, int M, int Nout, int K,
                               cudaStream_t stream, float* aux = nullptr) {
  if (Nout % FwdWide::BN == 0 && K % FwdWide::BK == 0)
    return launch_gemm_cfg<EPI, FwdWide>(A, W, bias, resid, out, M, Nout, K,
                                         stream, aux);
  return launch_gemm_cfg<EPI, FwdTile>(A, W, bias, resid, out, M, Nout, K,
                                       stream, aux);
}

// ------------------------------------------------------------ dX GEMM --
// out[M, Kout] = epilogue(T(dY)[M, Nred] . W[Nred, Kout]) in fp32, W the
// torch Linear weight (Nred = out features); common.cuh's DxEpilogue.
// With outb given, T(out) is also written there (the next products'
// operand).  aux may alias out.
using DxTile = Tile<128, 64, 2, 2, true, false>;

template <int EPI, class Cfg = DxTile>
__global__ void __launch_bounds__(Cfg::kThreads)
gemm_dx_kernel(const bf16* __restrict__ dYb, const bf16* __restrict__ W,
               const float* aux, float* out, bf16* __restrict__ outb, int M,
               int Kout, int Nred) {
  extern __shared__ __align__(128) bf16 smem[];
  const int m0 = blockIdx.y * Cfg::BM, n0 = blockIdx.x * Cfg::BN;
  float acc[Cfg::MI][Cfg::NI][4];
  mainloop<Cfg>(smem, dYb, Nred, W, Kout, m0, n0, 0, Nred, M, acc);
  const float* Cs = stage_acc<Cfg>(smem, acc);
  constexpr int LDC = Cfg::BN + 8, C4 = Cfg::BN / 4;
  for (int idx = threadIdx.x; idx < Cfg::BM * C4; idx += Cfg::kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    const size_t o = (size_t)m * Kout + n0 + c;
    float4 v = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    if (EPI == kDxGeluGrad) {
      const float4 h = *reinterpret_cast<const float4*>(aux + o);
      v.x *= gelu_grad_policy<bf16>(h.x);
      v.y *= gelu_grad_policy<bf16>(h.y);
      v.z *= gelu_grad_policy<bf16>(h.z);
      v.w *= gelu_grad_policy<bf16>(h.w);
    }
    *reinterpret_cast<float4*>(out + o) = v;
    if (outb)
      *reinterpret_cast<uint2*>(outb + o) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// as FwdWide, for the dX products at the training shapes
using DxWide = Tile<128, 192, 4, 2, true, false, 64, 3>;

template <int EPI, class Cfg>
static cudaError_t launch_gemm_dx_cfg(const bf16* dYb, const bf16* W,
                                      const float* aux, float* out,
                                      bf16* outb, int M, int Kout, int Nred,
                                      cudaStream_t stream) {
  const int mt = (M + Cfg::BM - 1) / Cfg::BM;
  if (Kout % Cfg::BN || Nred % Cfg::BK || mt > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare<Cfg>(gemm_dx_kernel<EPI, Cfg>);
  if (err != cudaSuccess) return err;
  gemm_dx_kernel<EPI, Cfg><<<dim3(Kout / Cfg::BN, mt), Cfg::kThreads,
                             Cfg::kSmemBytes, stream>>>(dYb, W, aux, out,
                                                        outb, M, Kout, Nred);
  return cudaGetLastError();
}

template <int EPI>
static cudaError_t launch_gemm_dx(const bf16* dYb, const bf16* W,
                                  const float* aux, float* out, bf16* outb,
                                  int M, int Kout, int Nred,
                                  cudaStream_t stream) {
  if (Kout % DxWide::BN == 0 && Nred % DxWide::BK == 0)
    return launch_gemm_dx_cfg<EPI, DxWide>(dYb, W, aux, out, outb, M, Kout,
                                           Nred, stream);
  return launch_gemm_dx_cfg<EPI, DxTile>(dYb, W, aux, out, outb, M, Kout,
                                         Nred, stream);
}

// ------------------------------------------------- dW GEMM, split-K -----
// dW[Nout, K] = sum_m T(dY)[m, n] X[m, k], db[n] = sum_m dY[m, n] (fp32
// dY): common.cuh's weight_grad on the tensor cores.  Block (k tile,
// n tile, chunk s) sums rows [s chunk, (s + 1) chunk) and writes its
// fp32 partial; the blocks of k tile 0 also write the chunk's column sums
// of dY; sum_partials adds the chunks in order.  A = T(dY) read M-major and
// B = X read N-major: both tiles go through ldmatrix.trans.
using DwTile = Tile<64, 64, 2, 2, false, false>;

// rows per dW chunk: more, shorter chunks than common.cuh's kDwChunk keep
// more SMs busy at the training shapes (M / 1,024 partials of Nout x K
// fp32; shorter chunks than that were slower on an H100)
constexpr int kDwChunkTc = 1024;

static int dw_chunks_tc(int M) { return (M + kDwChunkTc - 1) / kDwChunkTc; }

template <class Cfg = DwTile>
__global__ void __launch_bounds__(Cfg::kThreads)
gemm_dw_kernel(const bf16* __restrict__ dYb, const float* __restrict__ dY,
               const bf16* __restrict__ X, float* __restrict__ part,
               float* __restrict__ bias_part, int M, int Nout, int K,
               int chunk) {
  extern __shared__ __align__(128) bf16 smem[];
  __shared__ float red[Cfg::kThreads / Cfg::BM][Cfg::BM];
  const int k0 = blockIdx.x * Cfg::BN, n0 = blockIdx.y * Cfg::BM;
  const int s = blockIdx.z;
  const int mbeg = s * chunk, mend = min(M, mbeg + chunk);
  float acc[Cfg::MI][Cfg::NI][4];
  mainloop<Cfg>(smem, dYb, Nout, X, K, n0, k0, mbeg, mend, Nout, acc);
  float* P = part + (size_t)s * Nout * K;
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int r, c;
        acc_coords<Cfg>(mi, ni, half, r, c);
        *reinterpret_cast<float2*>(P + (size_t)(n0 + r) * K + k0 + c) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
  if (bias_part != nullptr && blockIdx.x == 0) {  // uniform over the block
    const int tid = threadIdx.x, col = tid % Cfg::BM, h = tid / Cfg::BM;
    constexpr int kSplit = Cfg::kThreads / Cfg::BM;
    static_assert(kSplit >= 1 && Cfg::kThreads % Cfg::BM == 0,
                  "whole threads per column");
    float t = 0.f;
    for (int m = mbeg + h; m < mend; m += kSplit)
      t += dY[(size_t)m * Nout + n0 + col];
    red[h][col] = t;
    __syncthreads();
    if (tid < Cfg::BM) {
      float u = 0.f;
      for (int j = 0; j < kSplit; ++j) u += red[j][tid];
      bias_part[(size_t)s * Nout + n0 + tid] = u;
    }
  }
}

// dW (Nout, K) and db (Nout) of a Linear from T(dY) (dYb), dY and X;
// part / bias_part hold dw_chunks_tc(M) partials
template <class Cfg = DwTile>
static cudaError_t weight_grad(const bf16* dYb, const float* dY,
                               const bf16* X, float* dW, float* db,
                               float* part, float* bias_part, int M, int Nout,
                               int K, cudaStream_t stream) {
  static_assert(kDwChunkTc % Cfg::BK == 0, "whole K steps per chunk");
  if (Nout % Cfg::BM || K % Cfg::BN) return cudaErrorInvalidValue;
  const int S = dw_chunks_tc(M);
  cudaError_t err = prepare<Cfg>(gemm_dw_kernel<Cfg>);
  if (err != cudaSuccess) return err;
  gemm_dw_kernel<Cfg><<<dim3(K / Cfg::BN, Nout / Cfg::BM, S), Cfg::kThreads,
                        Cfg::kSmemBytes, stream>>>(dYb, dY, X, part,
                                                   bias_part, M, Nout, K,
                                                   kDwChunkTc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(part, S, (size_t)Nout * K, (size_t)Nout * K, dW,
                            stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials(bias_part, S, Nout, Nout, db, stream);
}

}  // namespace tc
}  // namespace rp

// Tensor-core GEMM on mma.sync: the essential block's qkv Linear in bf16,
// and the mma.sync / ldmatrix / cp.async / TF32-split helpers that
// attention_tc.cuh, essential_tc.cuh and the wgmma bodies share.
//
// Replaces, in bf16, the forward GEMM inside pallas_essential_block.py's
// _essential_block_pair_kernel and _essential_block_x_kernel (the qkv
// Linear, essential_block.cu, epilogue kRounded).  Its fp32 counterpart
// runs on gemm_wgmma_f32.cuh's TF32 wgmma forward (epilogue kBias: in
// fp32 kRounded's roundings are the identity), as the ViT stack's GEMMs run
// on gemm_wgmma.cuh (bf16) and gemm_wgmma_f32.cuh (fp32): launch_gemm
// refuses any other epilogue at compile time.
//
// The product: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on K-major
// operands loaded with ldmatrix; bf16 x bf16 products are exact in fp32.
// The TF32 helpers below (split_tf32, mma_3xtf32 on m16n8k8) serve the fp32
// mma.sync bodies of essential_tc.cuh (#8, #9) and attention_tc.cuh:
// each fp32 operand is split in registers into a TF32 high part hi =
// rna(x) and a TF32 residual lo = rna(x - hi), and hi.hi + hi.lo + lo.hi is
// summed in fp32: only lo.lo (below 2^-22 of |a||b|) is dropped, so a
// product keeps fp32 accuracy.  (TF32 alone, hi.hi, keeps about 3 decimal
// digits: the port's precision policy forbids it.)
//
// What bounds it on the H100: at C = 192 the qkv Linear does 2 M C 3C
// operations on (M C + M 3C) elements, 96 operations per byte in bf16,
// below the 295 at which the bf16 tensor cores rather than HBM are the
// limit.  At the rate mma.sync reaches, the products themselves and the
// shared-memory loads feeding them decide.
//
// Design: operands from padded shared-memory tiles, fed by a 3-stage
// cp.async ring of K steps (128 x 192 output tiles where the widths
// allow).  Sums are fp32 and the epilogue is common.cuh's kRounded,
// element for element.

#pragma once

#include "sm90.cuh"

namespace rp {
namespace tc {

using bf16 = __nv_bfloat16;

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


// the TF32 value nearest x, ties away from zero, its low 13 mantissa bits
// zero: cvt.rna.tf32.f32's bits for every finite x, in two integer
// operations (the magnitude rounded half away from zero at bit 13; a carry
// moves into the exponent as rounding does)
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + r with hi, lo TF32 and |r| <= 2^-22 |x| (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a (16x8, row) . b (8x8, col) on TF32 operands; fp32 accumulate.
// Lane 4 g + t holds a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, column g), b1 (t + 4, g).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (no accumulator: C is zero)
__device__ __forceinline__ void mma_tf32_zc(float (&d)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += a . b to fp32 accuracy from split operands (3xTF32): the three
// products, the residual ones first, summed into a fresh 8-deep partial
// that one fp32 add (round to nearest) puts into c.  The tensor cores'
// fp32 sums do not round to nearest: with the products summed into c
// itself, each dropped part of an ulp of c, in one direction, at every
// product, and the ViT stack's outputs sat 10-30x farther from float64
// than the plain fp32 version's (H100); into the partial, what they drop
// is a part of an ulp of one 8-term sum.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  float t[4];
  mma_tf32_zc(t, al, bh[0], bh[1]);
  mma_tf32(t, ah, bl[0], bl[1]);
  mma_tf32(t, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// Accumulator layout of one m16n8 tile (both atoms), lane = 4 g + t:
// c[0], c[1] at (row g, columns 2t, 2t + 1), c[2], c[3] at row g + 8.

// ------------------------------------------------------------ tile GEMM --
// C[BM, BN] += A[BM, K] . B[K, BN] over k in [kbeg, kend), bf16 operands,
// both K-major: element (m, k) at A[m * lda + k], (k, n) at B[n * ldb + k]
// (the torch Linear weight).  Rows m >= m_end of A load as zeros.
template <typename E_, int BM_, int BN_, int WM_, int WN_, int BK_DEPTH = 32,
          int STAGES = 3>
struct Tile {
  using E = E_;
  static_assert(sizeof(E) == 2, "bf16 (fp32: gemm_wgmma_f32.cuh)");
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int BK = BK_DEPTH, kStages = STAGES;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  static constexpr int kVec = 16 / (int)sizeof(E);  // one cp.async
  static constexpr int kKStep = 16;                 // one mma's depth
  // Padded rows, so that 8 consecutive ldmatrix rows fall in distinct banks
  static constexpr int kPad = 8;
  static constexpr int A_LD = BK + kPad, A_ELEMS = BM * A_LD;
  static constexpr int B_LD = BK + kPad, B_ELEMS = BN * B_LD;
  static constexpr int kStageElems = A_ELEMS + B_ELEMS;
  static constexpr int kSmemElems = kStages * kStageElems;
  static constexpr int A_CHUNKS = BM * BK / kVec, B_CHUNKS = BN * BK / kVec;
  static_assert(TM % 16 == 0 && NI % 2 == 0, "warp tile: 16 x 16 steps");
  static_assert(BK % kKStep == 0, "whole mma steps per K step");
  static_assert(A_CHUNKS % kThreads == 0 && B_CHUNKS % kThreads == 0,
                "tile loads: whole steps");
  static constexpr int kSmemBytes = kSmemElems * (int)sizeof(E);  // dynamic
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

template <class Cfg, typename E = typename Cfg::E>
__device__ __forceinline__ void load_stage(E* st, const E* A, size_t lda,
                                           const E* B, size_t ldb, int m0,
                                           int n0, int k0, int m_end,
                                           int tid) {
  constexpr int CPR = Cfg::BK / Cfg::kVec;  // 16-byte chunks a row
  E* As = st;
  E* Bs = st + Cfg::A_ELEMS;
#pragma unroll
  for (int u = 0; u < Cfg::A_CHUNKS / Cfg::kThreads; ++u) {
    const int c = tid + u * Cfg::kThreads;
    const int r = c / CPR, kc = (c % CPR) * Cfg::kVec;
    const bool ok = m0 + r < m_end;
    cp_async16(As + r * Cfg::A_LD + kc,
               A + (size_t)(ok ? m0 + r : 0) * lda + k0 + kc, ok);
  }
#pragma unroll
  for (int u = 0; u < Cfg::B_CHUNKS / Cfg::kThreads; ++u) {
    const int c = tid + u * Cfg::kThreads;
    const int r = c / CPR, kc = (c % CPR) * Cfg::kVec;
    cp_async16(Bs + r * Cfg::B_LD + kc, B + (size_t)(n0 + r) * ldb + k0 + kc,
               true);
  }
}

// one K step of bf16 products: ldmatrix fragments, m16n8k16
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
      ldsm_x4(af[mi], As + (row0 + (lane & 15)) * Cfg::A_LD + kk +
                          (lane >> 4) * 8);
    }
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ni += 2) {
      const int col0 = wn * Cfg::TN + ni * 8;
      unsigned r[4];
      ldsm_x4(r, Bs + (col0 + (lane & 7) + (lane >> 4) * 8) * Cfg::B_LD +
                     kk + ((lane >> 3) & 1) * 8);
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

// acc = A[m0:, :K] . B[:K, n0:] through the cp.async ring
template <class Cfg, typename E = typename Cfg::E>
__device__ __forceinline__ void mainloop(E* smem, const E* A, size_t lda,
                                         const E* B, size_t ldb, int m0,
                                         int n0, int K, int m_end,
                                         float (&acc)[Cfg::MI][Cfg::NI][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::WN, wn = warp % Cfg::WN;
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int nk = (K + Cfg::BK - 1) / Cfg::BK;
#pragma unroll
  for (int s = 0; s < Cfg::kStages - 1; ++s) {
    if (s < nk)
      load_stage<Cfg>(smem + s * Cfg::kStageElems, A, lda, B, ldb, m0, n0,
                      s * Cfg::BK, m_end, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<Cfg::kStages - 2>();
    __syncthreads();
    // the stage read at kt - 1 is free: every thread passed the barrier
    const int nt = kt + Cfg::kStages - 1;
    if (nt < nk)
      load_stage<Cfg>(smem + (nt % Cfg::kStages) * Cfg::kStageElems, A, lda,
                      B, ldb, m0, n0, nt * Cfg::BK, m_end, tid);
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
    void* smem, const float (&acc)[Cfg::MI][Cfg::NI][4]) {
  constexpr int LDC = Cfg::BN + 8;
  static_assert(Cfg::kSmemBytes >= Cfg::BM * LDC * (int)sizeof(float),
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

// 4 fp32 values rounded to bf16 and stored as 4 consecutive elements
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = pack4_bf16(v);
}

// ---------------------------------------------------------- tile configs --
// The forward tile (K-major A and B), and the wide one of 192 output
// columns taken where the widths allow (the qkv Linear at C = 192): A is
// read from L2 a third as often as with 64-column tiles, with half as many
// barriers (one 138 KB block per SM; the fastest of the tiles tried on an
// H100 at the bf16 eval shapes).
struct Cfgs {
  using Fwd = Tile<bf16, 128, 64, 2, 2>;
  using FwdWide = Tile<bf16, 128, 192, 4, 2, 64, 3>;
};

// ------------------------------------------------------- forward GEMM --
// out[M, Nout] = T(T(A[M, K] . W[Nout, K]^T) + T(b)) in E: common.cuh's
// kRounded, the essential block's qkv Linear, element for element.
template <int EPI, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
gemm_fwd_kernel(const typename Cfg::E* __restrict__ A,
                const typename Cfg::E* __restrict__ W,
                const float* __restrict__ bias, typename Cfg::E* out, int M,
                int Nout, int K) {
  using E = typename Cfg::E;
  static_assert(EPI == kRounded, "the ViT GEMMs run on the wgmma bodies");
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  E* smem = reinterpret_cast<E*>(gemm_smem);
  const int m0 = blockIdx.y * Cfg::BM, n0 = blockIdx.x * Cfg::BN;
  float acc[Cfg::MI][Cfg::NI][4];
  mainloop<Cfg>(smem, A, K, W, K, m0, n0, K, M, acc);
  const float* Cs = stage_acc<Cfg>(smem, acc);
  constexpr int LDC = Cfg::BN + 8, C4 = Cfg::BN / 4;
  for (int idx = threadIdx.x; idx < Cfg::BM * C4; idx += Cfg::kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    const float4 a4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    const float4 b4 = *reinterpret_cast<const float4*>(bias + n);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = round_to<E>(a[j]) + round_to<E>(b[j]);
    store4(out + (size_t)m * Nout + n, v);
  }
}

template <int EPI, class Cfg, typename E = typename Cfg::E>
static cudaError_t launch_gemm_cfg(const E* A, const E* W, const float* bias,
                                   E* out, int M, int Nout, int K,
                                   cudaStream_t stream) {
  const int mt = (M + Cfg::BM - 1) / Cfg::BM;
  if (Nout % Cfg::BN || K % Cfg::BK || mt > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare<Cfg>(gemm_fwd_kernel<EPI, Cfg>);
  if (err != cudaSuccess) return err;
  gemm_fwd_kernel<EPI, Cfg><<<dim3(Nout / Cfg::BN, mt), Cfg::kThreads,
                              Cfg::kSmemBytes, stream>>>(A, W, bias, out, M,
                                                         Nout, K);
  return cudaGetLastError();
}

template <int EPI>
static cudaError_t launch_gemm(const bf16* A, const bf16* W,
                               const float* bias, bf16* out, int M, int Nout,
                               int K, cudaStream_t stream) {
  static_assert(EPI == kRounded,
                "the ViT GEMMs run on gemm_wgmma.cuh / gemm_wgmma_f32.cuh");
  using Wide = Cfgs::FwdWide;
  if (Nout % Wide::BN == 0 && K % Wide::BK == 0)
    return launch_gemm_cfg<EPI, Wide>(A, W, bias, out, M, Nout, K, stream);
  return launch_gemm_cfg<EPI, Cfgs::Fwd>(A, W, bias, out, M, Nout, K,
                                         stream);
}

}  // namespace tc
}  // namespace rp

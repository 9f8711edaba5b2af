// The warp-level tensor-core helpers every body shares: cp.async copies,
// ldmatrix, mma.sync m16n8k16 (bf16) and m16n8k8 (tf32), bf16 packing, and
// the TF32 split of an fp32 operand with its 3xTF32 product.  The mma.sync
// bodies (attention_tc.cuh's tile helpers, essential_tc.cuh,
// essential_tc_bwd.cuh) multiply with them; the wgmma bodies take the
// copies, the packing and the split.
//
// The TF32 helpers (split_tf32, mma_3xtf32 on m16n8k8) serve the fp32
// mma.sync bodies of essential_tc.cuh (#8) and attention_tc.cuh, and the
// split the fp32 wgmma bodies: each fp32 operand is split into a TF32 high
// part hi = rna(x) and a TF32 residual lo = rna(x - hi), and hi.hi + hi.lo
// + lo.hi is summed in fp32: only lo.lo (below 2^-22 of |a||b|) is
// dropped, so a product keeps fp32 accuracy.  (TF32 alone, hi.hi, keeps
// about 3 decimal digits: the port's precision policy forbids it.)

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

}  // namespace tc
}  // namespace rp

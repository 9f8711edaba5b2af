// Hopper (sm_90a) primitives shared by the wgmma bodies: the attention in
// bf16 (attention_wgmma.cuh) and fp32 (attention_wgmma_f32.cuh), the GEMMs
// of the ViT stack and of the fp32 essential block's qkv Linear
// (gemm_wgmma.cuh bf16, gemm_wgmma_f32.cuh fp32) and the fp32 essential
// block's moments and backward (essential_wgmma_f32.cuh; bf16 stays on
// essential_tc*.cuh's mma.sync).  mbarriers, TMA tile loads,
// the tensor-map encoder (and the fp32 attention's maps), wgmma's fence /
// commit / wait, the proxy fence, and the shared-memory matrix descriptor
// of a tile in the 128-byte swizzle (bf16 and tf32 k-steps).

#pragma once

#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace rp {
namespace tc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the kernel's dynamic shared memory, where it exceeds the default 48 KB
template <class K>
static cudaError_t smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

namespace wg {

// ------------------------------------------------------------ PTX pieces --
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of the given parity to complete; a wait of more than
// 2^32 cycles (about 2 s) is a fault, and traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// one 64 x 64 box of a 3-D tensor map at (column c0, row r0, sequence g)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c0, int r0,
                                         int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(r0),
      "r"(g)
      : "memory");
}

// one box of a 2-D tensor map at (column c0, row r0)
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap& map,
                                            uint32_t bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of products are pending
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy writes to shared memory before the
// async proxy (wgmma, TMA) reads them; a barrier follows
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory operand of wgmma: a tile of 128-byte rows at `addr`
// (1024-byte aligned), 128-byte swizzle, 8-row groups kSbo bytes apart
// (SBO).  K-major (the tile's rows are M or N, its columns the sum index):
// each 16-deep step starts kStepK bytes further along the rows.  MN-major
// (its rows are the sum index, its columns M or N): each step starts
// kStepMN bytes (16 rows) further, and 64-column atoms lie `lbo` bytes
// apart (LBO; a 64-wide operand has one atom, so LBO is never stepped
// over).  tests/test_torch_gemm_wgmma.py walks these addresses.
constexpr int kRowBytes = 128;                // 64 bf16: one swizzle row
constexpr int kSbo = 8 * kRowBytes;           // 1024
constexpr int kStepK = 32;                    // 16 bf16
constexpr int kStepMN = 16 * kRowBytes;       // 2048

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = kSbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t kmajor_step(uint64_t d, int kk) {
  return d + (uint64_t)(kk * kStepK / 16);  // in 16-byte units
}
__device__ __forceinline__ uint64_t mnmajor_step(uint64_t d, int kk) {
  return d + (uint64_t)(kk * kStepMN / 16);
}

// tf32 operands: a 64 x 64 fp32 tile K-major is two 128-byte swizzle
// columns kF32Half bytes apart (columns 0-31, then 32-63), each 64 rows of
// 128 bytes; a k8 step is 32 bytes, and steps 4-7 lie in the second
// column.  tests/test_torch_attention_wgmma_f32.py walks these addresses.
constexpr int kF32Half = 64 * kRowBytes;  // 8192
__device__ __forceinline__ uint64_t tf32_step(uint64_t d, int kk) {
  return d + (uint64_t)(((kk >> 2) * kF32Half + (kk & 3) * kStepK) / 16);
}

// byte offset of 16-byte chunk ch (columns 8 ch .. 8 ch + 7) of row r in a
// 128-byte-swizzled tile: what TMA writes and wgmma reads
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// the dynamic shared memory, rounded up to the 1024 bytes of the swizzle
// atom; the launchers ask for kAlign more than they use
constexpr int kAlign = 1024;
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (smem_u32(raw) & (kAlign - 1))) & (kAlign - 1));
}

// ------------------------------------------------------------ host side --
// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: the library links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
  if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// the fp32 attention's tensor map of one operand: `heads` 64-column heads
// of G sequences of N rows from base, row stride ld elements; 64 x 64
// boxes landing unswizzled (rows of 256 bytes: the block splits them into
// tf32 tiles itself); rows >= N read as zeros
static cudaError_t make_map_f32(CUtensorMap* map, const float* base, int G,
                                int heads, int N, int ld) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * kHeadDim, (cuuint64_t)N,
                              (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(float),
                                 (cuuint64_t)N * ld * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)kHeadDim, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace tc
}  // namespace rp

// The backward of the Essential Matrix Module's moments on the tensor
// cores, on essential_tc.cuh's layouts: replaces
//   - rel_pose_tpu/ops/pallas_essential.py:_bwd_kernel (#8), SliceLayout
//     (bilinear_bwd.cu, bilinear_bwd_f32.cu), bf16 and fp32;
// and holds what the wgmma bodies of #6
// (rel_pose_tpu/ops/pallas_essential_block_bwd.py:_essential_block_bwd_kernel,
// PairLayout: essential_wgmma.cuh in bf16, essential_wgmma_f32.cuh in fp32)
// take from it: the prologue kernel (PairLayout; bf16 writes its rows in
// wgmma's core-matrix tiles, kTiled) and the scratch layout.
// The kernels are templates on the element type T, as essential_tc.cuh's:
// bf16 products are mma.sync m16n8k16 with ldmatrix (.trans where a product
// reads a tile along its rows), fp32 ones 3xTF32 on m16n8k8 from 32-bit
// loads, an accumulator reused as the next product's A operand with
// attention_tc.cuh's k permutation.
//
// Per slice (essential_tc.cuh's notation, scale = the softmax scale sigma
// times log2e; the Pallas kernels' rounding points, #6 :68-111 and #8
// :100-141, sums in another order; T is the identity in fp32):
//   R = er / lr, Cm = ec / lc (the normalized row and column softmaxes),
//   A = R Cm (SINGLE: R), Ab = T(A);
//   vbdft = T(vb T(dF)^T), vadf = T(va T(dF));  dA = vadf vb^T (fp32);
//   dva = Ab vbdft, dvb = Ab^T vadf;
//   rho_i = sum_j dA Cm R, gamma_j = sum_i dA R Cm;
//   ds = R (dA Cm - rho) + Cm (dA R - gamma)  (SINGLE: R (dA - rho));
//   dsb = T(ds sigma), dq = dsb k, dk = dsb^T q.
// rho needs every key of its row, gamma every query of its column and ds
// both, so the work runs as passes over 64 x 64 tiles of s, each pass one
// launch (launch_bwd), one block of 4 warps per (64-row tile, slice)
// walking the other side's tiles:
//   a. eb_stats_kernel (essential_tc.cuh) for the queries (mr, 1/lr) and,
//      with the dual softmax, for the keys (mc, 1/lc);
//   b. eb_bwd_prologue_kernel: vb packed into kW-wide rows, vbdft and vadf
//      (scratch of the element type, the same rows);
//   c. eb_bwd_pass_kernel<rows = keys, REDUCE> (dual only): gamma;
//   d. <rows = queries, REDUCE>: rho;
//   e. <rows = queries, GRAD>: ds and A again; dq += dsb k, dva += Ab vbdft;
//   f. <rows = keys, GRAD>: ds^T and A^T on the transposed products
//      s^T = k q^T, dA^T = vb vadf^T; dk += dsb^T q, dvb += Ab^T vadf.
// The passes are one template: with rows = keys the roles of (R, rho) and
// (Cm, gamma) swap, and the formulas above are symmetric under that swap.
// The walked tiles stream through a 2-stage cp.async ring (fp32's pass e,
// whose walked stage holds three tiles, 1 stage: two of its 92 KB blocks
// share an SM, as two of the other fp32 passes' 110 KB ones do; bf16's run
// two 2-stage blocks an SM).  rho and gamma are not replaced by an
// algebraic shortcut (rho_i = vadf_i (A vb)_i), which would move a rounding
// point.  The outputs are _bwd_kernel's: dq, dk to (G, N, 64) and dva =
// T(Ab vbdft), dvb = T(Ab^T vadf) to (G, N, e), each rounded by itself (no
// scratch; with va and vb one tensor the caller's autograd adds the two).
// No atomics, sums in a fixed order: two calls give the same bits.
//
// What bounds it on the H100: the products, executed 2 score products in
// the statistics (one with SINGLE) and 4 score + 4 dA products in the
// passes (3 + 3), plus dq, dk, dva, dvb: about 11 N^2 64 multiply-adds a
// slice against the function's 5, at mma.sync's rate (fp32: three m16n8k8
// products each, and the split of every loaded operand); and 10 exp2 a
// score (4 with SINGLE).

#pragma once

#include "essential_tc.cuh"

namespace rp {
namespace tc {

// ----------------------------------------------------------- prologue --
// For 64 rows of slice g: vb packed to VB, vbdft = T(vb T(dF)^T) and
// vadf = T(va T(dF)), rows of kW elements (columns >= e zero); with kTiled
// (bf16, essential_wgmma.cuh) in wgmma's core-matrix tiles instead, one
// per 64 rows, rows >= N zero: 16-byte column c of row r of tile
// blockIdx.x at ((g gridDim.x + blockIdx.x) kW / 8 + c) 512 + r 8.  T(dF) sits
// in shared memory as [e][f], zero-padded to kW x kW; fp32 also keeps its
// transpose [f][e], so that both products read their B operand along its
// rows (words g kLd + t).
template <typename T, int E>
constexpr size_t prologue_smem_bytes() {
  using W = EbW<T, E>;
  return (3 * W::kTileElems + (W::kF32 ? 2 : 1) * W::kW * W::kLd) *
         sizeof(T);
}

template <class Layout, int E, bool CROSS, typename T, bool kTiled = false>
__global__ void __launch_bounds__(kAThreads)
eb_bwd_prologue_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
                       const T* __restrict__ in2, const T* __restrict__ in3,
                       size_t ld, const float* __restrict__ dF,
                       T* __restrict__ VB, T* __restrict__ VBDFT,
                       T* __restrict__ VADF, int N, int C, int heads) {
  using W = EbW<T, E>;
  // va in a tile of its own: a cross-features pair, or any slice (its va
  // and vb may differ)
  constexpr bool kOwnVa = CROSS || Layout::kSlice;
  extern __shared__ __align__(128) unsigned char eb_smem[];
  T* sm = reinterpret_cast<T*>(eb_smem);
  T* VBs = sm;
  T* VAs = kOwnVa ? sm + W::kTileElems : VBs;
  T* Os = sm + 2 * W::kTileElems;  // an output tile, staged
  T* DF = sm + 3 * W::kTileElems;  // [kW][kLd]: T(dF)[e][f]
  T* DFt = DF + W::kW * W::kLd;    // fp32: [kW][kLd], dF[e][f] at [f][e]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kAT, g = blockIdx.y;
  const EbView<T> vw =
      eb_view<Layout, E, CROSS>(in0, in1, in2, in3, ld, N, C, heads, g);
  Layout::template load_v<E>(VBs, vw.vb, vw, r0, N);
  if (kOwnVa) Layout::template load_v<E>(VAs, vw.va, vw, r0, N);
  cp_async_commit();
  const float* df = dF + (size_t)g * E * E;
  for (int i = tid; i < W::kW * W::kW; i += kAThreads) {
    const int e = i / W::kW, f = i % W::kW;
    const T v = from_f32<T>(e < E && f < E ? df[e * E + f] : 0.f);
    DF[e * W::kLd + f] = v;
    if constexpr (W::kF32) DFt[f * W::kLd + e] = v;
  }
  cp_async_wait<0>();
  __syncthreads();

  // one kW-wide output tile from the staging tile Os to rows r0.. of out,
  // 16 bytes a thread and step
  constexpr int V = 16 / (int)sizeof(T), CPR = W::kW / V;
  static_assert(!kTiled || V == 8, "core-matrix tiles: bf16");
  const size_t obase = ((size_t)g * N + r0) * W::kW;
  const size_t tbase = ((size_t)g * gridDim.x + blockIdx.x) * kAT * W::kW;
  // element offset of 16-byte chunk cc / V of row r
  auto at = [&](int r, int cc) {
    return kTiled ? tbase + (size_t)(cc / V) * (kAT * V) + r * V
                  : obase + (size_t)r * W::kW + cc;
  };
  auto store = [&](T* out) {
    __syncthreads();
    for (int c = tid; c < kAT * CPR; c += kAThreads) {
      const int r = c / CPR, cc = (c % CPR) * V;
      if (kTiled || r0 + r < N)
        *reinterpret_cast<uint4*>(out + at(r, cc)) =
            *reinterpret_cast<const uint4*>(Os + r * W::kLd + cc);
    }
    __syncthreads();
  };
  // an accumulator tile rounded into Os, the columns past 8 kNT zero
  auto stage = [&](const float (&c)[W::kNT][4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + (lane >> 2) + half * 8;
#pragma unroll
      for (int ni = 0; ni < W::kNT; ++ni)
        store2(Os + r * W::kLd + acc_col(ni, 0), c[ni][2 * half],
               c[ni][2 * half + 1]);
      for (int col = W::kNT * 8 + 2 * (lane & 3); col < W::kW; col += 8)
        store2(Os + r * W::kLd + col, 0.f, 0.f);
    }
  };

  // vb itself, packed
  for (int c = tid; c < kAT * CPR; c += kAThreads) {
    const int r = c / CPR, cc = (c % CPR) * V;
    if (kTiled || r0 + r < N)
      *reinterpret_cast<uint4*>(VB + at(r, cc)) =
          *reinterpret_cast<const uint4*>(VBs + r * W::kLd + cc);
  }
  if constexpr (W::kF32) {
    {
      // vbdft[n][e] = sum_f vb[n][f] dF[e][f]: DF's rows are the columns
      float c[W::kNT][4] = {};
      mma_abt_acc_f32<W::kNT, W::kK8, W::kLd, W::kLd>(c, VBs, DF);
      stage(c);
      store(VBDFT);
    }
    {
      // vadf[n][f] = sum_e va[n][e] dF[e][f]: DFt's rows are the columns
      float c[W::kNT][4] = {};
      mma_abt_acc_f32<W::kNT, W::kK8, W::kLd, W::kLd>(c, VAs, DFt);
      stage(c);
      store(VADF);
    }
  } else {
    unsigned af[W::kKS][4];
    {
      // vbdft[n][e] = sum_f vb[n][f] T(dF)[e][f]: DF's rows are the columns
      float c[W::kNT][4] = {};
      load_afrag_k<W::kKS, W::kLd>(af, VBs);
      mma_abt_acc<W::kNT, W::kKS, W::kLd>(c, af, DF);
      stage(c);
      store(VBDFT);
    }
    {
      // vadf[n][f] = sum_e va[n][e] T(dF)[e][f]: DF's rows are the sum index
      float c[W::kNT][4] = {};
      load_afrag_k<W::kKS, W::kLd>(af, VAs);
      mma_ab_acc<W::kNT, W::kKS, W::kLd>(c, af, DF);
      stage(c);
      store(VADF);
    }
  }
}

// -------------------------------------------------------------- passes --
// One pass over the (own 64-row tile, walked tile) pairs of slice g.  Own
// rows are queries with kRows (X = q, Y = vadf; walked X = k, Y = vb, Z =
// vbdft), keys without (X = k, Y = vb; walked X = q, Y = Z = vadf); the
// statistics of a side are (m, 1/l, reduction) per row, at
// [(g N + row) * 3].  Per tile: s = X Xw^T (scaled), d = Y Yw^T (dA or
// dA^T), then REDUCE sums rho (queries) or gamma (keys) into the own side's
// slot 2; GRAD forms T(ds sigma) and T(A) and accumulates out1 += . Xw,
// out2 += . Zw, and writes them to dst0 .. dst3 = dq, dk, dva, dvb (see the
// file's head).  SliceLayout only: #6's PairLayout passes run the wgmma
// bodies.
template <typename T, bool kRows, bool kGrad>
__host__ __device__ constexpr int pass_stages() {
  return sizeof(T) == 4 && kRows && kGrad ? 1 : 2;
}

template <typename T, int E, bool kRows, bool kGrad>
constexpr size_t pass_smem_bytes() {
  constexpr int kZ = kRows && kGrad;  // a walked Z tile of its own
  constexpr int S = pass_stages<T, kRows, kGrad>();
  return (tile_elems<T>() + EbW<T, E>::kTileElems +
          S * (tile_elems<T>() + (1 + kZ) * EbW<T, E>::kTileElems)) *
             sizeof(T) +
         S * 3 * kAT * sizeof(float);
}

template <class Layout, int E, bool kRows, bool kGrad, bool SINGLE,
          bool CROSS, typename T>
__global__ void __launch_bounds__(kAThreads, 2)
eb_bwd_pass_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
                   size_t ld, float* __restrict__ qstats,
                   float* __restrict__ kstats, const T* __restrict__ VB,
                   const T* __restrict__ VBDFT, const T* __restrict__ VADF,
                   T* __restrict__ dst0, T* __restrict__ dst1,
                   T* __restrict__ dst2, T* __restrict__ dst3, int N, int C,
                   int heads, float scale, float sigma) {
  static_assert(Layout::kSlice, "#6 runs essential_wgmma*.cuh");
  using W = EbW<T, E>;
  constexpr int TE = tile_elems<T>();
  constexpr bool kZ = kRows && kGrad;
  constexpr int S = pass_stages<T, kRows, kGrad>();
  // with SINGLE only the query side has statistics
  constexpr bool kOwnStats = !SINGLE || kRows;
  constexpr bool kWalkStats = !SINGLE || !kRows;
  extern __shared__ __align__(128) unsigned char eb_smem[];
  T* sm = reinterpret_cast<T*>(eb_smem);
  // stage st of the walked ring: X, Y (and Z) tiles at WX(st) .. (offsets,
  // not arrays of pointers: those were indexed from the stack)
  constexpr int kStage = TE + (1 + kZ) * W::kTileElems;
  T* OXs = sm;
  T* OYs = sm + TE;
  const auto WX = [&](int st) { return OYs + W::kTileElems + st * kStage; };
  const auto WY = [&](int st) { return WX(st) + TE; };
  const auto WZ = [&](int st) { return WY(st) + kZ * W::kTileElems; };
  float* WSs = reinterpret_cast<float*>(OYs + W::kTileElems + S * kStage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kAT, g = blockIdx.y;
  const EbView<T> vw = eb_view<Layout, E, CROSS>(
      in0, in1, (const T*)nullptr, (const T*)nullptr, ld, N, C, heads, g);
  const size_t gN = (size_t)g * N;
  const T* ownX = kRows ? vw.q : vw.k;
  const T* walkX = kRows ? vw.k : vw.q;
  const T* ownY = (kRows ? VADF : VB) + gN * W::kW;
  const T* walkY = (kRows ? VB : VADF) + gN * W::kW;
  const T* walkZ = VBDFT + gN * W::kW;
  float* ost = (kRows ? qstats : kstats) + gN * 3;
  const float* wst = (kRows ? kstats : qstats) + gN * 3;
  const int nt = (N + kAT - 1) / kAT;

  auto prefetch = [&](int w0, int st) {
    load_tile(WX(st), walkX, vw.ldqk, w0, N);
    load_rows<W::kW, W::kLd>(WY(st), walkY, W::kW, w0, N);
    if (kZ) load_rows<W::kW, W::kLd>(WZ(st), walkZ, W::kW, w0, N);
    if (kWalkStats) {
      const int valid = 3 * min(kAT, N - w0);
      for (int i = tid; i < 3 * kAT; i += kAThreads)
        cp_async4(WSs + st * 3 * kAT + i, wst + (size_t)w0 * 3 +
                                              (i < valid ? i : 0),
                  i < valid);
    }
  };
  load_tile(OXs, ownX, vw.ldqk, r0, N);
  load_rows<W::kW, W::kLd>(OYs, ownY, W::kW, r0, N);
  if constexpr (S == 2) prefetch(0, 0);
  cp_async_commit();

  // the own rows' statistics (benign values past N)
  float om[2] = {0.f, 0.f}, ol[2] = {1.f, 1.f}, ored[2] = {0.f, 0.f};
  if (kOwnStats) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
      if (row < N) {
        om[half] = ost[(size_t)row * 3];
        ol[half] = ost[(size_t)row * 3 + 1];
        if (kGrad) ored[half] = ost[(size_t)row * 3 + 2];
      }
    }
  }

  typename AttnFrags<T>::A xf;
  float s[8][4], d[8][4];
  float red[2] = {0.f, 0.f};
  float out1[8][4] = {}, out2[W::kNT][4] = {};
  for (int t = 0; t < nt; ++t) {
    __syncthreads();  // the stage loaded below was read at step t - 1
    if constexpr (S == 2) {
      if (t + 1 < nt) prefetch((t + 1) * kAT, (t + 1) & 1);
    } else {
      prefetch(t * kAT, 0);
    }
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    if (t == 0) load_afrag(xf, OXs);
    const int w0 = t * kAT, st = S == 2 ? t & 1 : 0;
    const float* ws = WSs + st * 3 * kAT;
    mma_abt(s, xf, WX(st));
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[ni][e] = 0.f;
    if constexpr (W::kF32) {
      mma_abt_acc_f32<8, W::kK8, W::kLd, W::kLd>(d, OYs, WY(st));
    } else {
      // reloaded each step: kept live, they pushed the gradient passes
      // past 255 registers
      unsigned yf[W::kKS][4];
      load_afrag_k<W::kKS, W::kLd>(yf, OYs);
      mma_abt_acc<8, W::kKS, W::kLd>(d, yf, WY(st));
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_col(ni, e), r = e >> 1;
        const float sv = __fmul_rn(s[ni][e], scale);
        const float dA = d[ni][e];
        float ds = 0.f, A = 0.f;
        if (w0 + j < N) {
          // own-side and walked-side normalized exps
          const float Po = kOwnStats ? exp2f(sv - om[r]) * ol[r] : 0.f;
          const float Pw =
              kWalkStats ? exp2f(sv - ws[3 * j]) * ws[3 * j + 1] : 0.f;
          const float R = kRows ? Po : Pw;
          const float Cm = kRows ? Pw : Po;
          if (!kGrad) {
            if (SINGLE)
              red[r] += dA * R;
            else
              red[r] += kRows ? (dA * Cm) * R : (dA * R) * Cm;
          } else {
            const float wred = kWalkStats ? ws[3 * j + 2] : 0.f;
            const float rho = kRows ? ored[r] : wred;
            if (SINGLE) {
              ds = R * (dA - rho);
              A = R;
            } else {
              const float gam = kRows ? wred : ored[r];
              ds = R * (dA * Cm - rho) + Cm * (dA * R - gam);
              A = R * Cm;
            }
          }
        }
        s[ni][e] = ds * sigma;
        d[ni][e] = A;
      }
    if constexpr (kGrad) {
      if constexpr (W::kF32) {
        mma_ab(out1, s, WX(st));                          // ds sigma, fp32
        mma_pb_acc_f32<W::kNT, W::kLd>(out2, d, WZ(st));  // A, fp32
      } else {
        unsigned dsf[4][4], abf[4][4];
        to_afrag(dsf, s);  // T(ds sigma)
        to_afrag(abf, d);  // T(A)
        mma_ab(out1, dsf, WX(st));
        mma_ab_acc<W::kNT, 4, W::kLd>(out2, abf, WZ(st));
      }
    }
  }

  if constexpr (!kGrad) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float t = quad_sum(red[half]);
      const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
      if (row < N && (lane & 3) == 0) ost[(size_t)row * 3 + 2] = t;
    }
    return;
  }
  // dq | dk and dva | dvb of the own rows, each rounded by itself
  T* gx = (kRows ? dst0 : dst1) + gN * kHeadDim;
  T* gv = (kRows ? dst2 : dst3) + gN * E;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + warp * 16 + (lane >> 2) + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      store2(gx + (size_t)row * kHeadDim + acc_col(ni, 0), out1[ni][2 * half],
             out1[ni][2 * half + 1]);
#pragma unroll
    for (int ni = 0; ni < W::kNT; ++ni) {
      const int col = acc_col(ni, 0);
      if (col < E)
        store2(gv + (size_t)row * E + col, out2[ni][2 * half],
               out2[ni][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------- workspace --
// Scratch of the backward, in this order, each piece 256-byte aligned:
// the query and key statistics (G N x 3 fp32 each), VB, VBDFT, VADF (G N kW
// elements of `elem` bytes each: 2 bf16, 4 fp32; with `tiled`, G ceil(N /
// 64) tiles of 64 rows) and, for PairLayout's dva (kDva), G N e fp32.
struct EbBwdWs {
  float* qstats;
  float* kstats;
  void* vb;
  void* vbdft;
  void* vadf;
  float* dva;
  size_t bytes;
  EbBwdWs(void* base, int G, int N, int E, bool kDva, int elem = 2,
          bool tiled = false) {
    const int kW = eb_kw_of(E, elem);
    const size_t st = eb_align(sizeof(float) * (size_t)G * N * 3);
    const size_t R = tiled ? (size_t)(N + kAT - 1) / kAT * kAT : N;
    const size_t rows = eb_align((size_t)elem * G * R * kW);
    const uintptr_t p = reinterpret_cast<uintptr_t>(base);
    qstats = reinterpret_cast<float*>(p);
    kstats = reinterpret_cast<float*>(p + st);
    vb = reinterpret_cast<void*>(p + 2 * st);
    vbdft = reinterpret_cast<void*>(p + 2 * st + rows);
    vadf = reinterpret_cast<void*>(p + 2 * st + 2 * rows);
    dva = kDva ? reinterpret_cast<float*>(p + 2 * st + 3 * rows) : nullptr;
    bytes = 2 * st + 3 * rows +
            (kDva ? eb_align(sizeof(float) * (size_t)G * N * E) : 0);
  }
};

// Host-side arguments of launch_bwd: the layout's in0 .. in3 and ld (see
// essential_tc.cuh), dF (G, e, e) fp32, the outputs out0 .. out3 (the
// pass kernel's dst0 .. dst3), the EbBwdWs bytes, G slices, the scale
// (sigma log2 e) and sigma.
template <typename T>
struct EbBwdArgsT {
  const T* in0;
  const T* in1;
  const T* in2;
  const T* in3;
  size_t ld;
  const float* dF;
  T* out0;
  T* out1;
  T* out2;
  T* out3;
  void* ws;
  int G, N, C, heads;
  float scale, sigma;
};

// the operand rows of the workspace in the element type
template <typename T>
struct EbBwdRows {
  T* vb;
  T* vbdft;
  T* vadf;
  explicit EbBwdRows(const EbBwdWs& ws)
      : vb(reinterpret_cast<T*>(ws.vb)),
        vbdft(reinterpret_cast<T*>(ws.vbdft)),
        vadf(reinterpret_cast<T*>(ws.vadf)) {}
};

template <class Layout, int E, bool kRows, bool kGrad, bool SINGLE,
          bool CROSS, typename T>
static cudaError_t launch_bwd_pass(const EbBwdArgsT<T>& a, const EbBwdWs& ws,
                                   dim3 grid, cudaStream_t st) {
  constexpr size_t smem = pass_smem_bytes<T, E, kRows, kGrad>();
  auto kernel =
      eb_bwd_pass_kernel<Layout, E, kRows, kGrad, SINGLE, CROSS, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const EbBwdRows<T> r(ws);
  kernel<<<grid, kAThreads, smem, st>>>(
      a.in0, a.in1, a.ld, ws.qstats, ws.kstats, r.vb, r.vbdft, r.vadf,
      a.out0, a.out1, a.out2, a.out3, a.N, a.C, a.heads, a.scale, a.sigma);
  return cudaGetLastError();
}

// G slices: at most 65,535 (the grid's second dimension)
template <class Layout, int E, bool SINGLE, bool CROSS, typename T>
cudaError_t launch_bwd(const EbBwdArgsT<T>& a, cudaStream_t st) {
  const int G = a.G, N = a.N;
  if (G > 65535 || N <= 0 || a.ws == nullptr) return cudaErrorInvalidValue;
  const EbBwdWs ws(a.ws, G, N, E, false, (int)sizeof(T));
  const dim3 grid((N + kAT - 1) / kAT, G);
  cudaError_t err = launch_stats<false, Layout>(
      a.in0, a.in1, a.ld, ws.qstats, G, N, a.C, a.heads, a.scale, st);
  if (err != cudaSuccess) return err;
  if constexpr (!SINGLE) {
    err = launch_stats<true, Layout>(a.in0, a.in1, a.ld, ws.kstats, G, N,
                                     a.C, a.heads, a.scale, st);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t psmem = prologue_smem_bytes<T, E>();
  auto prologue = eb_bwd_prologue_kernel<Layout, E, CROSS, T>;
  err = cudaFuncSetAttribute(
      prologue, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)psmem);
  if (err != cudaSuccess) return err;
  const EbBwdRows<T> r(ws);
  prologue<<<grid, kAThreads, psmem, st>>>(a.in0, a.in1, a.in2, a.in3, a.ld,
                                          a.dF, r.vb, r.vbdft, r.vadf, N,
                                          a.C, a.heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (!SINGLE) {  // gamma
    err = launch_bwd_pass<Layout, E, false, false, SINGLE, CROSS>(a, ws, grid,
                                                                  st);
    if (err != cudaSuccess) return err;
  }
  if ((err = launch_bwd_pass<Layout, E, true, false, SINGLE, CROSS>(
           a, ws, grid, st)) != cudaSuccess)
    return err;
  if ((err = launch_bwd_pass<Layout, E, true, true, SINGLE, CROSS>(
           a, ws, grid, st)) != cudaSuccess)
    return err;
  return launch_bwd_pass<Layout, E, false, true, SINGLE, CROSS>(a, ws, grid,
                                                                st);
}

// #8's backward: G slices of SliceLayout, e = 64 or 70, the dual or the
// single softmax (bilinear_bwd.cu; fp32 instantiated in
// bilinear_bwd_f32.cu)
template <typename T>
cudaError_t launch_slice_bwd(const EbBwdArgsT<T>& a, int e, int single,
                             cudaStream_t st) {
  constexpr int kE70 = kHeadDim + kEbPos;
  if (e == kE70)
    return single ? launch_bwd<SliceLayout, kE70, true, false>(a, st)
                  : launch_bwd<SliceLayout, kE70, false, false>(a, st);
  if (e == kHeadDim)
    return single ? launch_bwd<SliceLayout, kHeadDim, true, false>(a, st)
                  : launch_bwd<SliceLayout, kHeadDim, false, false>(a, st);
  return cudaErrorInvalidValue;
}

// #6's arguments
template <typename T>
struct EbbTcArgs {
  const T* qkv;       // (B, 2, N, 3C)
  const T* pos;       // (B, N, 6), or NULL with e = 64
  const float* dF;    // (B, 2, heads, e, e)
  T* dqkv;            // (B, 2, N, 3C)
  T* dva;             // (B, 2, N, C) with CROSS, else NULL
  float* dpos_part;   // (B, 2, heads, N, 6), or NULL with e = 64
  void* ws;           // EbBwdWs bytes
  int B, N, C, heads;
};

}  // namespace tc
}  // namespace rp

// Native host-side data pipeline of rel_pose_tpu_torch, a copy of
// rel_pose_tpu/native/host_pipeline.cpp.
//
// The reference framework's host pipeline runs on native code too (OpenCV
// C++ decode + torch C++ DataLoader collation); this library does the
// post-decode stages, replacing several numpy passes with fused,
// multithreaded C++:
//
//   rp_pair_to_chw_resize: uint8 HWC BGR pair -> float32 (2,3,OH,OW) with
//       nearest resize (torch F.interpolate semantics: src = floor(dst*in/out))
//       and HWC->CHW transpose fused into one pass.
//   rp_color_jitter: torchvision-style ColorJitter chain (brightness /
//       contrast / saturation / hue in caller-chosen order) + optional
//       grayscale on a float32 CHW image stack, one resident buffer.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Build: rel_pose_tpu_torch/native/__init__.py runs `make OUT=<path>` in
// this directory at first use (into rel_pose_tpu_torch/_build/).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int default_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(std::min(n, 16u));
}

// Run fn(start_row, end_row) over [0, rows) on `nthreads` threads.
template <typename F>
void parallel_rows(int rows, int nthreads, F fn) {
  if (nthreads <= 1 || rows < 64) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int lo = t * chunk;
    int hi = std::min(rows, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// images_in: n contiguous uint8 HWC images (h, w, 3).
// out: float32 (n, 3, oh, ow), planar per image.
// Nearest-neighbor with src = (dst * in) / out (integer floor) per axis.
void rp_pair_to_chw_resize(const uint8_t* images_in, int n, int h, int w,
                           float* out, int oh, int ow, int nthreads) {
  if (nthreads <= 0) nthreads = default_threads();
  std::vector<int> col_idx(ow);
  for (int x = 0; x < ow; ++x) col_idx[x] = (int)(((int64_t)x * w) / ow);
  const int64_t in_img = (int64_t)h * w * 3;
  const int64_t out_plane = (int64_t)oh * ow;

  parallel_rows(n * oh, nthreads, [&](int lo, int hi) {
    for (int r = lo; r < hi; ++r) {
      int img = r / oh;
      int y = r % oh;
      int sy = (int)(((int64_t)y * h) / oh);
      const uint8_t* src_row = images_in + img * in_img + (int64_t)sy * w * 3;
      float* o0 = out + img * 3 * out_plane + (int64_t)y * ow;
      float* o1 = o0 + out_plane;
      float* o2 = o1 + out_plane;
      for (int x = 0; x < ow; ++x) {
        const uint8_t* px = src_row + col_idx[x] * 3;
        o0[x] = (float)px[0];
        o1[x] = (float)px[1];
        o2[x] = (float)px[2];
      }
    }
  });
}

namespace {

// per-pixel HSV hue rotation on RGB floats in [0, 1]
inline void hue_rotate(float& r, float& g, float& b, float shift) {
  float maxc = std::max(r, std::max(g, b));
  float minc = std::min(r, std::min(g, b));
  float v = maxc;
  float diff = maxc - minc;
  float s = maxc > 0.f ? diff / maxc : 0.f;
  float hval = 0.f;
  if (diff > 0.f) {
    float rc = (maxc - r) / diff, gc = (maxc - g) / diff, bc = (maxc - b) / diff;
    if (maxc == r) hval = bc - gc;
    else if (maxc == g) hval = 2.f + rc - bc;
    else hval = 4.f + gc - rc;
    hval = hval / 6.f;
    hval -= std::floor(hval);
  }
  hval += shift;
  hval -= std::floor(hval);
  float i = std::floor(hval * 6.f);
  float f = hval * 6.f - i;
  float p = v * (1.f - s);
  float q = v * (1.f - s * f);
  float t = v * (1.f - s * (1.f - f));
  switch (((int)i) % 6) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
}

constexpr float kRW = 0.299f, kGW = 0.587f, kBW = 0.114f;

}  // namespace

// In-place torchvision-style color jitter on a float32 stack of n CHW BGR
// images with values in [0, 255] (the training layout).  All n images get
// the SAME transform (the reference jitters the pair jointly).
//
// ops: array of op codes applied in order.  0=brightness, 1=contrast,
// 2=saturation, 3=hue, 4=grayscale.  vals[i] is the factor for ops[i]
// (hue: fractional turn; grayscale: ignored).  Results are clamped to
// [0, 255] after each op, matching the float [0,1] clip in the numpy path.
void rp_color_jitter(float* data, int n, int h, int w, const int* ops,
                     const float* vals, int n_ops, int nthreads) {
  if (nthreads <= 0) nthreads = default_threads();
  const int64_t plane = (int64_t)h * w;

  for (int oi = 0; oi < n_ops; ++oi) {
    int op = ops[oi];
    float f = vals[oi];
    // contrast needs the mean gray of the CURRENT state, over all n images.
    // Parallelize over (image, row) — n is tiny (a pair), rows are many.
    const int total_rows = n * h;
    float mean_gray = 0.f;
    if (op == 1) {
      std::vector<double> partial((size_t)total_rows, 0.0);
      parallel_rows(total_rows, nthreads, [&](int lo, int hi) {
        for (int row = lo; row < hi; ++row) {
          int img = row / h;
          int y = row % h;
          const float* b = data + img * 3 * plane + (int64_t)y * w;
          const float* g = b + plane;
          const float* r = g + plane;
          double acc = 0.0;
          for (int i = 0; i < w; ++i)
            acc += kRW * r[i] + kGW * g[i] + kBW * b[i];
          partial[row] = acc;
        }
      });
      double total = 0.0;
      for (double p : partial) total += p;
      mean_gray = (float)(total / ((double)n * plane));
    }

    parallel_rows(total_rows, nthreads, [&](int lo, int hi) {
      for (int row = lo; row < hi; ++row) {
        int img = row / h;
        int y = row % h;
        float* bp = data + img * 3 * plane + (int64_t)y * w;
        float* gp = bp + plane;
        float* rp = gp + plane;
        for (int64_t i = 0; i < w; ++i) {
          float b = bp[i], g = gp[i], r = rp[i];
          switch (op) {
            case 0:  // brightness
              r *= f; g *= f; b *= f;
              break;
            case 1: {  // contrast: blend with mean gray
              r = f * r + (1.f - f) * mean_gray;
              g = f * g + (1.f - f) * mean_gray;
              b = f * b + (1.f - f) * mean_gray;
              break;
            }
            case 2: {  // saturation: blend with per-pixel gray
              float gray = kRW * r + kGW * g + kBW * b;
              r = f * r + (1.f - f) * gray;
              g = f * g + (1.f - f) * gray;
              b = f * b + (1.f - f) * gray;
              break;
            }
            case 3: {  // hue (work in [0,1])
              float rr = r / 255.f, gg = g / 255.f, bb = b / 255.f;
              hue_rotate(rr, gg, bb, f);
              r = rr * 255.f; g = gg * 255.f; b = bb * 255.f;
              break;
            }
            default: {  // grayscale
              float gray = kRW * r + kGW * g + kBW * b;
              r = gray; g = gray; b = gray;
              break;
            }
          }
          bp[i] = std::min(255.f, std::max(0.f, b));
          gp[i] = std::min(255.f, std::max(0.f, g));
          rp[i] = std::min(255.f, std::max(0.f, r));
        }
      }
    });
  }
}

namespace {

#define RP_CLAMP_STORE(i)                              \
  bp[i] = std::min(255.f, std::max(0.f, b));           \
  gp[i] = std::min(255.f, std::max(0.f, g));           \
  rp[i] = std::min(255.f, std::max(0.f, r));

// One jitter op over a contiguous block of `len` pixels (planar b/g/r).
// Each case is its own tight loop so the compiler auto-vectorizes; the
// caller keeps blocks cache-resident so chaining ops costs no DRAM traffic.
inline void apply_op_block(int op, float f, float mean_gray, float* bp,
                           float* gp, float* rp, int64_t len) {
  switch (op) {
    case 0:
      for (int64_t i = 0; i < len; ++i) {
        float b = bp[i] * f, g = gp[i] * f, r = rp[i] * f;
        RP_CLAMP_STORE(i);
      }
      break;
    case 1:
      for (int64_t i = 0; i < len; ++i) {
        float b = f * bp[i] + (1.f - f) * mean_gray;
        float g = f * gp[i] + (1.f - f) * mean_gray;
        float r = f * rp[i] + (1.f - f) * mean_gray;
        RP_CLAMP_STORE(i);
      }
      break;
    case 2:
      for (int64_t i = 0; i < len; ++i) {
        float gray = kRW * rp[i] + kGW * gp[i] + kBW * bp[i];
        float b = f * bp[i] + (1.f - f) * gray;
        float g = f * gp[i] + (1.f - f) * gray;
        float r = f * rp[i] + (1.f - f) * gray;
        RP_CLAMP_STORE(i);
      }
      break;
    case 3:
      // branchless hue rotation (selects instead of switch) so the loop
      // auto-vectorizes; float-op-for-float-op identical to hue_rotate.
      for (int64_t i = 0; i < len; ++i) {
        float r = rp[i] / 255.f, g = gp[i] / 255.f, b = bp[i] / 255.f;
        float maxc = std::max(r, std::max(g, b));
        float minc = std::min(r, std::min(g, b));
        float v = maxc, diff = maxc - minc;
        float vsafe = maxc > 0.f ? maxc : 1.f;   // unconditional division
        float s = maxc > 0.f ? diff / vsafe : 0.f;
        float safe = diff > 0.f ? diff : 1.f;
        float rc = (maxc - r) / safe;
        float gc = (maxc - g) / safe;
        float bc = (maxc - b) / safe;
        float hv = (maxc == r) ? (bc - gc)
                               : ((maxc == g) ? (2.f + rc - bc)
                                              : (4.f + gc - rc));
        hv = hv / 6.f;
        hv -= std::floor(hv);
        hv = diff > 0.f ? hv : 0.f;
        hv += f;
        hv -= std::floor(hv);
        float si = std::floor(hv * 6.f);
        float fr = hv * 6.f - si;
        float p = v * (1.f - s);
        float q = v * (1.f - s * fr);
        float t = v * (1.f - s * (1.f - fr));
        // flat 0/1 masks: GCC if-converts single-level selects but not the
        // 5-deep ternary chain a switch would need
        float m0 = si == 0.f ? 1.f : 0.f;
        float m1 = si == 1.f ? 1.f : 0.f;
        float m2 = si == 2.f ? 1.f : 0.f;
        float m3 = si == 3.f ? 1.f : 0.f;
        float m4 = si == 4.f ? 1.f : 0.f;
        float m5 = 1.f - m0 - m1 - m2 - m3 - m4;
        r = m0 * v + m1 * q + (m2 + m3) * p + m4 * t + m5 * v;
        g = m0 * t + (m1 + m2) * v + m3 * q + (m4 + m5) * p;
        b = (m0 + m1) * p + m2 * t + (m3 + m4) * v + m5 * q;
        r *= 255.f; g *= 255.f; b *= 255.f;
        RP_CLAMP_STORE(i);
      }
      break;
    default:
      for (int64_t i = 0; i < len; ++i) {
        float gray = kRW * rp[i] + kGW * gp[i] + kBW * bp[i];
        float b = gray, g = gray, r = gray;
        RP_CLAMP_STORE(i);
      }
      break;
  }
}

#undef RP_CLAMP_STORE

}  // namespace

// Fused cache-tiled jitter: the image is processed in row tiles sized to
// stay L2-resident, and the whole op chain runs per tile — ~one DRAM
// read+write of the image for the full chain instead of one per op, with
// each op's inner loop still auto-vectorized.  Contrast needs the mean gray
// of the state AFTER the ops before it, so a chain containing contrast runs
// as two tiled stages (prefix ops + gray reduction, then the rest).
// Identical math to rp_color_jitter (falls back to it for the never-drawn
// case of multiple contrast ops).
void rp_color_jitter_fused(float* data, int n, int h, int w, const int* ops,
                           const float* vals, int n_ops, int nthreads) {
  if (nthreads <= 0) nthreads = default_threads();
  if (n_ops <= 0) return;
  int ci = -1, n_contrast = 0;
  for (int i = 0; i < n_ops; ++i) {
    if (ops[i] == 1) { ci = (ci < 0) ? i : ci; ++n_contrast; }
  }
  if (n_contrast > 1) {  // torchvision draws each op at most once
    rp_color_jitter(data, n, h, w, ops, vals, n_ops, nthreads);
    return;
  }

  const int64_t plane = (int64_t)h * w;
  // ~96 KiB of pixel data (3 planes) per tile
  const int tile_rows = std::max(1, 8192 / std::max(1, w));
  const int tiles_per_img = (h + tile_rows - 1) / tile_rows;
  const int total_tiles = n * tiles_per_img;

  auto run_stage = [&](int op_lo, int op_hi, float mean_gray,
                       std::vector<double>* gray_out) {
    parallel_rows(total_tiles, nthreads, [&](int lo, int hi) {
      for (int t = lo; t < hi; ++t) {
        int img = t / tiles_per_img;
        int y0 = (t % tiles_per_img) * tile_rows;
        int64_t len = (int64_t)std::min(tile_rows, h - y0) * w;
        float* bp = data + img * 3 * plane + (int64_t)y0 * w;
        float* gp = bp + plane;
        float* rp = gp + plane;
        for (int oi = op_lo; oi < op_hi; ++oi)
          apply_op_block(ops[oi], vals[oi], mean_gray, bp, gp, rp, len);
        if (gray_out) {
          double acc = 0.0;
          for (int64_t i = 0; i < len; ++i)
            acc += kRW * rp[i] + kGW * gp[i] + kBW * bp[i];
          (*gray_out)[t] = acc;
        }
      }
    });
  };

  if (ci < 0) {
    run_stage(0, n_ops, 0.f, nullptr);
    return;
  }
  std::vector<double> partial((size_t)total_tiles, 0.0);
  run_stage(0, ci, 0.f, &partial);  // prefix ops + gray reduction
  double total = 0.0;
  for (double p : partial) total += p;
  float mean_gray = (float)(total / ((double)n * plane));
  run_stage(ci, n_ops, mean_gray, nullptr);  // contrast + the rest
}

// in: float32 (n, c, h, w); out: uint8 (n, c, oh, ow).  Nearest resize
// (torch floor semantics) fused with round-half-even + clamp to [0, 255]
// (numpy rint/clip/astype(uint8) equivalence) — replaces three GIL-held
// numpy passes in the augmentor epilogue with one threaded pass.
void rp_resize_quantize(const float* in, int n, int c, int h, int w,
                        uint8_t* out, int oh, int ow, int nthreads) {
  if (nthreads <= 0) nthreads = default_threads();
  std::vector<int> col_idx(ow);
  for (int x = 0; x < ow; ++x) col_idx[x] = (int)(((int64_t)x * w) / ow);
  const int64_t in_plane = (int64_t)h * w;
  const int64_t out_plane = (int64_t)oh * ow;
  const int planes = n * c;
  parallel_rows(planes * oh, nthreads, [&](int lo, int hi) {
    for (int r = lo; r < hi; ++r) {
      int pl = r / oh;
      int y = r % oh;
      int sy = (int)(((int64_t)y * h) / oh);
      const float* src = in + pl * in_plane + (int64_t)sy * w;
      uint8_t* dst = out + pl * out_plane + (int64_t)y * ow;
      for (int x = 0; x < ow; ++x) {
        float v = std::nearbyintf(src[col_idx[x]]);
        v = std::min(255.f, std::max(0.f, v));
        dst[x] = (uint8_t)v;
      }
    }
  });
}

int rp_num_threads() { return default_threads(); }

}  // extern "C"

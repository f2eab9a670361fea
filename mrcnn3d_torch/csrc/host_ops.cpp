// mrcnn3d native host runtime, the port's copy of native/host_ops.cpp
// (the functions are the same, byte for byte).
//
// C++ equivalents of the host-side hot paths that bottleneck the
// reference's training loop (SURVEY.md section 3: np.load of full
// volumes, per-slice normalisation, skimage 1.5x resize) and of the
// eval-time merge NMS.  This library owns the host side: threaded
// volume crop+normalise+layout transform, trilinear upscale, and the
// asymmetric-overlap greedy NMS used by the patch-merge evaluator
// (reference mmdet/ops/nms/nms_wrapper.py:84-140).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (mrcnn3d_torch/native/__init__.py); no pybind11 dependency.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int n_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw == 0 ? 4 : static_cast<int>(std::min(hw, 16u));
}

// run fn(lo, hi) over [0, n) split across threads
template <typename F>
void parallel_for(int64_t n, F fn) {
  int t = n_threads();
  if (n < 1024 || t <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Crop an (H, W, D) float32 volume at [y0:y0+ch, x0:x0+cw, z0:z0+cd],
// replicate grayscale to 3 channels, normalise per channel, and emit
// channel-last (cd, ch, cw, 3) float32 — the fused replacement for the
// reference's per-slice PIL->RGB->imnormalize loop
// (mmdet/datasets/coco_3d_2scales.py:246-258, transforms.py:13-51).
void crop_normalize_volume(const float* vol, int64_t H, int64_t W,
                           int64_t D, int64_t y0, int64_t x0, int64_t z0,
                           int64_t ch, int64_t cw, int64_t cd,
                           const float* mean, const float* std_,
                           float* out /* (cd, ch, cw, 3) */) {
  const float inv0 = 1.0f / std_[0], inv1 = 1.0f / std_[1],
              inv2 = 1.0f / std_[2];
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  parallel_for(cd * ch, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t z = i / ch, y = i % ch;
      const float* src = vol + ((y0 + y) * W + x0) * D + (z0 + z);
      float* dst = out + ((z * ch + y) * cw) * 3;
      for (int64_t x = 0; x < cw; ++x) {
        float v = src[x * D];
        dst[x * 3 + 0] = (v - m0) * inv0;
        dst[x * 3 + 1] = (v - m1) * inv1;
        dst[x * 3 + 2] = (v - m2) * inv2;
      }
    }
  });
}

// Trilinear resize of a channel-last (d, h, w, c) float32 volume to
// (od, oh, ow, c) with skimage grid-center coordinates
// (out i -> in (i + .5) * in/out - .5), edge clamped — the fused
// replacement for the per-channel skimage.transform.resize of the 1.5x
// training twin (reference coco_3d_2scales.py:219).
void resize_trilinear(const float* in, int64_t d, int64_t h, int64_t w,
                      int64_t c, int64_t od, int64_t oh, int64_t ow,
                      float* out) {
  std::vector<int64_t> zl(od), zh(od), yl(oh), yh(oh), xl(ow), xh(ow);
  std::vector<float> zf(od), yf(oh), xf(ow);
  auto prep = [](int64_t n, int64_t in_n, std::vector<int64_t>& lo,
                 std::vector<int64_t>& hi, std::vector<float>& fr) {
    for (int64_t i = 0; i < n; ++i) {
      float cpos = (i + 0.5f) * static_cast<float>(in_n) / n - 0.5f;
      cpos = std::max(0.0f, std::min(cpos, static_cast<float>(in_n - 1)));
      int64_t l = static_cast<int64_t>(cpos);
      lo[i] = l;
      hi[i] = std::min(l + 1, in_n - 1);
      fr[i] = cpos - l;
    }
  };
  prep(od, d, zl, zh, zf);
  prep(oh, h, yl, yh, yf);
  prep(ow, w, xl, xh, xf);

  parallel_for(od * oh, [&](int64_t lo_i, int64_t hi_i) {
    for (int64_t i = lo_i; i < hi_i; ++i) {
      int64_t z = i / oh, y = i % oh;
      const float wz1 = zf[z], wz0 = 1.0f - wz1;
      const float wy1 = yf[y], wy0 = 1.0f - wy1;
      const float* p00 = in + ((zl[z] * h + yl[y]) * w) * c;
      const float* p01 = in + ((zl[z] * h + yh[y]) * w) * c;
      const float* p10 = in + ((zh[z] * h + yl[y]) * w) * c;
      const float* p11 = in + ((zh[z] * h + yh[y]) * w) * c;
      float* dst = out + ((z * oh + y) * ow) * c;
      for (int64_t x = 0; x < ow; ++x) {
        const float wx1 = xf[x], wx0 = 1.0f - wx1;
        int64_t a = xl[x] * c, b = xh[x] * c;
        for (int64_t k = 0; k < c; ++k) {
          float v00 = p00[a + k] * wx0 + p00[b + k] * wx1;
          float v01 = p01[a + k] * wx0 + p01[b + k] * wx1;
          float v10 = p10[a + k] * wx0 + p10[b + k] * wx1;
          float v11 = p11[a + k] * wx0 + p11[b + k] * wx1;
          dst[x * c + k] = wz0 * (wy0 * v00 + wy1 * v01) +
                           wz1 * (wy0 * v10 + wy1 * v11);
        }
      }
    }
  });
}

// Asymmetric-overlap greedy NMS (reference nms_3d_python semantics:
// overlap = intersection / volume(other), +1 extents, descending-score
// pick order).  dets: (n, 7) [x1,y1,x2,y2,z1,z2,score].  Writes kept
// indices into `keep` (capacity n) and returns the count.
int64_t nms3d_overlap(const float* dets, int64_t n, float thr,
                      int64_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return dets[a * 7 + 6] > dets[b * 7 + 6];
  });
  std::vector<float> vol(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* b = dets + i * 7;
    vol[i] = (b[2] - b[0] + 1) * (b[3] - b[1] + 1) * (b[5] - b[4] + 1);
  }
  std::vector<char> dead(n, 0);
  int64_t count = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    if (dead[i]) continue;
    keep[count++] = i;
    const float* a = dets + i * 7;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      int64_t j = order[oj];
      if (dead[j]) continue;
      const float* b = dets + j * 7;
      float ix = std::min(a[2], b[2]) - std::max(a[0], b[0]) + 1;
      if (ix <= 0) continue;
      float iy = std::min(a[3], b[3]) - std::max(a[1], b[1]) + 1;
      if (iy <= 0) continue;
      float iz = std::min(a[5], b[5]) - std::max(a[4], b[4]) + 1;
      if (iz <= 0) continue;
      if (ix * iy * iz / vol[j] > thr) dead[j] = 1;
    }
  }
  return count;
}

// Voxel IoU between two uint8 binary volumes of identical size.
double voxel_iou(const uint8_t* a, const uint8_t* b, int64_t n) {
  std::atomic<int64_t> inter{0}, uni{0};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    int64_t li = 0, lu = 0;
    for (int64_t i = lo; i < hi; ++i) {
      bool va = a[i] != 0, vb = b[i] != 0;
      li += (va && vb);
      lu += (va || vb);
    }
    inter += li;
    uni += lu;
  });
  int64_t u = uni.load();
  return u == 0 ? 0.0 : static_cast<double>(inter.load()) / u;
}

}  // extern "C"

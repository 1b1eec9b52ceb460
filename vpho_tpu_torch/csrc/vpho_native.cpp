// Native host-side kernels for the data pipeline.
//
// The host-side runtime around the device compute (data preparation, mesh
// preprocessing, per-sample geometry) is C++ where the reference leaned on
// native deps (fpsample's C FPS at lib/dataset/base.py:228, sklearn ball-tree
// NN contact at lib/utils/physics_fn.py:47-117, HigherHRNet's patch stamping
// at lib/utils/misc_fn.py:285-330).
//
// Build: vpho_tpu_torch/native/__init__.py compiles it at first use with
// g++ -O3 -march=native -shared -fPIC into build/vpho_tpu_torch/ and binds it
// with ctypes; the numpy forms there are the plain versions.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Farthest-point sampling over an (n, 3) float32 cloud.
// out_idx must hold k int64 entries.  O(n*k), cache-friendly single pass per
// selection — replaces the fpsample bucket-kdline dependency for the YCB
// registry build (2048 samples from ~8k-vert meshes).
void vpho_fps(const float* verts, int64_t n, int64_t k, int64_t start_idx,
              int64_t* out_idx) {
  if (k > n) k = n;
  std::vector<float> d2(n, std::numeric_limits<float>::max());
  int64_t cur = start_idx;
  out_idx[0] = cur;
  for (int64_t i = 1; i < k; ++i) {
    const float cx = verts[cur * 3], cy = verts[cur * 3 + 1], cz = verts[cur * 3 + 2];
    float best = -1.f;
    int64_t best_j = 0;
    for (int64_t j = 0; j < n; ++j) {
      const float dx = verts[j * 3] - cx;
      const float dy = verts[j * 3 + 1] - cy;
      const float dz = verts[j * 3 + 2] - cz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < d2[j]) d2[j] = d;
      if (d2[j] > best) { best = d2[j]; best_j = j; }
    }
    cur = best_j;
    out_idx[i] = cur;
  }
}

// For each point in a (na, 3), the min Euclidean distance to b (nb, 3),
// and the index of the nearest b point.  Replaces the sklearn ball-tree
// nearest-neighbor queries in the contact labeling path.
void vpho_min_dist(const float* a, int64_t na, const float* b, int64_t nb,
                   float* out_dist, int64_t* out_idx) {
  for (int64_t i = 0; i < na; ++i) {
    const float ax = a[i * 3], ay = a[i * 3 + 1], az = a[i * 3 + 2];
    float best = std::numeric_limits<float>::max();
    int64_t best_j = 0;
    for (int64_t j = 0; j < nb; ++j) {
      const float dx = b[j * 3] - ax;
      const float dy = b[j * 3 + 1] - ay;
      const float dz = b[j * 3 + 2] - az;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < best) { best = d; best_j = j; }
    }
    out_dist[i] = std::sqrt(best);
    out_idx[i] = best_j;
  }
}

// Gaussian keypoint heatmap stamping, HigherHRNet semantics: int-truncated
// centers, 6*sigma+3 window, zero for out-of-range joints.
// pts: (j, 2) float32; out: (j, res, res) float32 (pre-zeroed by caller or
// overwritten here).
void vpho_stamp_heatmaps(const float* pts, int64_t num_j, int64_t res,
                         float sigma, float* out) {
  const int64_t win = static_cast<int64_t>(6 * sigma + 3);
  const float c0 = 3 * sigma + 1;
  std::memset(out, 0, sizeof(float) * num_j * res * res);
  for (int64_t j = 0; j < num_j; ++j) {
    const int64_t x = static_cast<int64_t>(pts[j * 2]);
    const int64_t y = static_cast<int64_t>(pts[j * 2 + 1]);
    if (pts[j * 2] < 0 || pts[j * 2 + 1] < 0 || x >= res || y >= res) continue;
    const int64_t ulx = static_cast<int64_t>(std::llround(x - 3 * sigma - 1));
    const int64_t uly = static_cast<int64_t>(std::llround(y - 3 * sigma - 1));
    float* plane = out + j * res * res;
    for (int64_t gy = 0; gy < win; ++gy) {
      const int64_t iy = uly + gy;
      if (iy < 0 || iy >= res) continue;
      const float dy = static_cast<float>(gy) - c0;
      for (int64_t gx = 0; gx < win; ++gx) {
        const int64_t ix = ulx + gx;
        if (ix < 0 || ix >= res) continue;
        const float dx = static_cast<float>(gx) - c0;
        const float v = std::exp(-(dx * dx + dy * dy) / (2 * sigma * sigma));
        float* cell = plane + iy * res + ix;
        if (v > *cell) *cell = v;
      }
    }
  }
}

// Hand-object contact weighting (physics_fn.py:96-112 sigmoid band) applied
// to precomputed signed normal distances.
void vpho_contact_weight(const float* normal_dist, int64_t n, float lo, float hi,
                         float decay_lo, float decay_hi, float* out) {
  const float mid1 = (decay_lo + lo) / 2;
  const float mid2 = (decay_hi + hi) / 2;
  const float s1 = 1.f + std::exp(-1600.f * (0.f - mid1));
  const float s2 = 1.f + std::exp(1600.f * (0.f - mid2));
  const float scale = 1.f / (s1 * s2 + 1e-10f);
  for (int64_t i = 0; i < n; ++i) {
    const float x = normal_dist[i];
    const float m1 = 1.f + std::exp(-1600.f * (x - mid1));
    const float m2 = 1.f + std::exp(1600.f * (x - mid2));
    float v = 1.f / (m1 * m2 + 1e-10f);
    if (!std::isfinite(m1) || !std::isfinite(m2)) v = 0.f;
    out[i] = v / scale;
  }
}

}  // extern "C"

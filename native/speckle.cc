// Exact connected-component speckle filter (cv2.filterSpeckles semantics).
//
// The device pipeline uses the on-device label-propagation filter
// (ops/disparity.speckle_filter); this native path is the host-side exact
// reference and the fast option for host post-processing: union-find over
// 4-connectivity where |d(p) - d(q)| <= max_diff, regions smaller than
// max_size invalidated. Single pass, O(H*W alpha).
//
// Built into libstereo_native.so; called via ctypes (native.py).

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

struct DSU {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  explicit DSU(size_t n) : parent(n), size(n, 1) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
  }
};

}  // namespace

extern "C" {

// disp: (H, W) float32; valid: (H, W) uint8 in/out (1 = keep).
// Regions of similar disparity smaller than max_size are invalidated.
void stereo_native_filter_speckles(const float* disp, uint8_t* valid, int h,
                                   int w, int max_size, float max_diff) {
  const size_t n = static_cast<size_t>(h) * w;
  DSU dsu(n);
  for (int y = 0; y < h; ++y) {
    const float* row = disp + static_cast<size_t>(y) * w;
    const uint8_t* vrow = valid + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      if (!vrow[x]) continue;
      const size_t i = static_cast<size_t>(y) * w + x;
      if (x + 1 < w && vrow[x + 1] &&
          std::abs(row[x + 1] - row[x]) <= max_diff) {
        dsu.unite(static_cast<int32_t>(i), static_cast<int32_t>(i + 1));
      }
      if (y + 1 < h && valid[i + w] &&
          std::abs(disp[i + w] - row[x]) <= max_diff) {
        dsu.unite(static_cast<int32_t>(i), static_cast<int32_t>(i + w));
      }
    }
  }
  for (size_t i = 0; i < n; ++i) {
    if (valid[i] && dsu.size[dsu.find(static_cast<int32_t>(i))] <= max_size) {
      valid[i] = 0;
    }
  }
}

}  // extern "C"

// Native point->voxel budgeting kernel (C ABI); the port's copy of
// ssd3d/native/voxelize.cc.
//
// Counterpart of the reference's pybind11 voxelizer
// (lib/builder/voxel_generator/points2voxel.cpp) with the same first-come
// semantics: points are visited in input order; each voxel accepts at most
// max_per_voxel points; out-of-range points are dropped. Emits a keep flag
// per point; the Python layer (ssd3d/data/nuscenes.py) applies key-frame
// priority and the final budget. Open-addressing hash over flat voxel ids —
// no dense grid allocation.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// points: [n, stride] float32 (xyz first); keep_out: n uint8.
// Returns the number of kept points, or -1 on error.
int64_t voxel_budget_flags(const float* points, int64_t n, int32_t stride,
                           const float* voxel_size, const float* range_lo,
                           const float* range_hi, int32_t max_per_voxel,
                           uint8_t* keep_out) {
  if (n <= 0 || stride < 3) return -1;
  int64_t grid[3];
  for (int d = 0; d < 3; ++d) {
    grid[d] = (int64_t)((range_hi[d] - range_lo[d]) / voxel_size[d] + 0.9999f);
    if (grid[d] <= 0) return -1;
  }

  // open addressing: capacity = next pow2 >= 2n
  size_t cap = 1;
  while (cap < (size_t)(2 * n)) cap <<= 1;
  std::vector<int64_t> keys(cap, -1);
  std::vector<int32_t> counts(cap, 0);
  const size_t mask = cap - 1;

  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * stride;
    keep_out[i] = 0;
    int64_t c[3];
    bool ok = true;
    for (int d = 0; d < 3; ++d) {
      float v = (p[d] - range_lo[d]) / voxel_size[d];
      if (v < 0 || p[d] <= range_lo[d] || p[d] >= range_hi[d]) {
        ok = false;
        break;
      }
      c[d] = (int64_t)v;
      if (c[d] >= grid[d]) {
        ok = false;
        break;
      }
    }
    if (!ok) continue;
    int64_t key = (c[0] * grid[1] + c[1]) * grid[2] + c[2];
    size_t slot = ((size_t)key * 0x9E3779B97F4A7C15ull) & mask;
    while (keys[slot] != -1 && keys[slot] != key) slot = (slot + 1) & mask;
    if (keys[slot] == -1) keys[slot] = key;
    if (counts[slot] < max_per_voxel) {
      ++counts[slot];
      keep_out[i] = 1;
      ++kept;
    }
  }
  return kept;
}

}  // extern "C"

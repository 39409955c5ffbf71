// K3: multi-ring ball query for Hopper.
//
// Replaces the Pallas kernel ssd3d/ops/pallas/ring_words.py:_kernel (via
// ring_words_pallas) together with the selection that follows it on the TPU
// (ssd3d/ops/grouping.py:_select_from_words_t). Contract of
// ssd3d.ops.grouping.ball_query_multi, after QueryBallPoint / the dilated
// query of the reference CUDA (tf_grouping_g.cu:215-255, :308-357): per ring,
// the first ns points in index order with lo2 <= d2 < hi2, or d2 == 0 for an
// annulus (plain rings: d2 < hi2); slots past the count repeat the first hit;
// cnt is capped at ns; a query with no hit gets idx all 0. d2 is
// ((dx*dx + dy*dy) + dz*dz) with dx = query - point, as the plain version.
//
// What bounds it on the H100: the distance pass over the cloud, m * n * 3
// loads and ~10 flops per (query, point) pair, cut short when every ring of a
// query is full. At SA1 (4,096 x 16,384, batch 8) the outer ring of 0.8 m
// rarely fills, so most queries scan the whole cloud: ~5.5e8 pairs.
//
// Design: one warp per query, 8 queries a block. The block streams the cloud
// through shared memory in tiles of 1,024 points, so each point is read from
// L2 once per 8 queries. All rings come from one distance computation; for
// each ring __ballot_sync gives the warp's hits and __popc of the lower lanes
// each hit's slot, which keeps index order without any sort. A warp whose
// rings are all full stops scanning; the block stops loading tiles when all
// eight are (__syncthreads_and).
#include "common.cuh"

namespace {

constexpr int kMaxRings = 4;
constexpr int kWarps = 8;
constexpr int kTile = 1024;

struct Rings {
  float lo2[kMaxRings];
  float hi2[kMaxRings];
  int annulus[kMaxRings];
  int ns[kMaxRings];
  int off[kMaxRings];  // column of ring r's first slot in idx
  int count;
  int ns_total;
};

__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ queries, int n,
                      int m, Rings rings, int* __restrict__ idx, int* __restrict__ cnt) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kWarps + warp;
  const bool active = qi < m;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* q = queries + ((size_t)b * m + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  int* out = idx + ((size_t)b * m + (active ? qi : 0)) * rings.ns_total;
  int c[kMaxRings];
  int first[kMaxRings];
#pragma unroll
  for (int r = 0; r < kMaxRings; ++r) {
    c[r] = 0;
    first[r] = 0;
  }
  bool done = !active;
  const float* p = xyz + (size_t)b * n * 3;
  const unsigned lower = (1u << lane) - 1u;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    // barrier: also keeps the previous tile alive until every warp is past it
    if (__syncthreads_and(done)) break;
    const int len = min(kTile, n - t0);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      sx[j] = p[3 * (t0 + j)];
      sy[j] = p[3 * (t0 + j) + 1];
      sz[j] = p[3 * (t0 + j) + 2];
    }
    __syncthreads();
    if (done) continue;
    for (int base = 0; base < len; base += 32) {
      const int jl = base + lane;
      const bool in = jl < len;
      float d2 = 0.0f;
      if (in) {
        const float dx = qx - sx[jl];
        const float dy = qy - sy[jl];
        const float dz = qz - sz[jl];
        d2 = (dx * dx + dy * dy) + dz * dz;
      }
      bool full = true;
#pragma unroll
      for (int r = 0; r < kMaxRings; ++r) {
        if (r < rings.count) {
          const bool v = in && (rings.annulus[r]
                                    ? ((d2 >= rings.lo2[r] && d2 < rings.hi2[r]) || d2 == 0.0f)
                                    : d2 < rings.hi2[r]);
          const unsigned hits = __ballot_sync(0xffffffffu, v);
          if (hits) {
            if (c[r] == 0) first[r] = t0 + base + __ffs(hits) - 1;
            const int slot = c[r] + __popc(hits & lower);
            if (v && slot < rings.ns[r]) out[rings.off[r] + slot] = t0 + jl;
            c[r] += __popc(hits);
          }
          full = full && c[r] >= rings.ns[r];
        }
      }
      if (full) {
        done = true;
        break;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < kMaxRings; ++r) {
    if (r < rings.count) {
      const int cr = min(c[r], rings.ns[r]);
      const int pad = cr > 0 ? first[r] : 0;
      for (int s = cr + lane; s < rings.ns[r]; s += 32) out[rings.off[r] + s] = pad;
      if (lane == 0) cnt[((size_t)b * m + qi) * rings.count + r] = cr;
    }
  }
}

}  // namespace

// xyz: f32 [b, n, 3]; queries: f32 [b, m, 3]; idx: i32 [b, m, sum(ns)], ring r
// in columns [sum(ns[:r]), sum(ns[:r+1])); cnt: i32 [b, m, n_rings].
// lo2 / hi2 / annulus / ns are host arrays of n_rings entries (n_rings <= 4).
extern "C" int ssd3d_ball_query(const float* xyz, const float* queries, int* idx, int* cnt,
                                int b, int n, int m, int n_rings, const float* lo2,
                                const float* hi2, const int* annulus, const int* ns,
                                cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0 || n_rings <= 0 || n_rings > kMaxRings) {
    return (int)cudaErrorInvalidValue;
  }
  Rings rings = {};
  rings.count = n_rings;
  int total = 0;
  for (int r = 0; r < n_rings; ++r) {
    if (ns[r] <= 0) return (int)cudaErrorInvalidValue;
    rings.lo2[r] = lo2[r];
    rings.hi2[r] = hi2[r];
    rings.annulus[r] = annulus[r];
    rings.ns[r] = ns[r];
    rings.off[r] = total;
    total += ns[r];
  }
  rings.ns_total = total;
  dim3 grid((m + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kWarps * 32, 0, stream>>>(xyz, queries, n, m, rings, idx, cnt);
  return (int)cudaGetLastError();
}

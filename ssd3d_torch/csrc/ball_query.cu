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
// What bounds it on the H100: the contract needs only the pairs inside the
// outer ring (a few to a few hundred points a query at SA1), but a query
// whose rings never fill must know that no later point is inside, so a scan
// over the cloud costs every pair: at SA1 (4,096 x 16,384, batch 8) the
// 0.8 m ring seldom fills and ~5.5e8 pairs are tested, ~25 instructions
// each. Two routes, chosen by the wrapper from the shape
// (ops/grouping.py `ball_query_route`):
//
// - Grid route: a pre-pass bins each cloud into a uniform 3-D grid whose
//   cell is at least the outer radius times (1 + margin), so every point
//   inside a ring lies in the query's cell or one of its 26 neighbours. One
//   block a cloud: a bounding-box reduction; the cell size (grown when the
//   grid would exceed the wrapper's cap on cells or 1,024 cells an axis);
//   a stable radix sort of the points by cell in shared memory (16-bit
//   keys, 4 bits a pass, each warp ranking its run of points with
//   __match_any_sync), so each cell's list is in ascending index order;
//   the cell offsets from the sorted keys; last, the points written in cell
//   order as (x, y, z, index). A point's and a query's cell come from the
//   same formula, in double precision, so rounding cannot move a point
//   inside a ring two cells away. The query
//   kernel gives a warp to a query and a lane to each of the 27 cells
//   around it (clamped to the grid; none for a query far outside it). The
//   lists are ascending, so the warp merges them in index order: each lane
//   advances to its list's next point inside any ring (with the point after
//   it already loaded), a warp minimum yields the next hit, and that hit
//   fills the ring slots as below. The warp stops when every ring is full or
//   every list is spent. No sort and no hit buffer: a dense cell overflows
//   nothing, it only takes longer.
// - Brute-force route (the kernel's first design), where the radius is
//   large against the cloud: one warp per query, 8 queries a block. The
//   block streams the cloud through shared memory in tiles of 1,024 points,
//   so each point is read from L2 once per 8 queries. All rings come from
//   one distance computation; for each ring __ballot_sync gives the warp's
//   hits and __popc of the lower lanes each hit's slot, which keeps index
//   order without any sort. A warp whose rings are all full stops scanning;
//   the block stops loading tiles when all eight are (__syncthreads_and).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxRings = 4;
constexpr int kWarps = 8;
constexpr int kTile = 1024;
constexpr int kMaxGridY = 65535;  // clouds on grid.y; more are looped over

struct Rings {
  float lo2[kMaxRings];
  float hi2[kMaxRings];
  int annulus[kMaxRings];
  int ns[kMaxRings];
  int off[kMaxRings];  // column of ring r's first slot in idx
  int count;
  int ns_total;
};

// One cloud's 8 queries (every thread of the block calls it: it holds
// barriers).
__device__ void ball_query_cloud(const float* __restrict__ xyz, const float* __restrict__ queries,
                                 int n, int m, const Rings& rings, int* __restrict__ idx,
                                 int* __restrict__ cnt, long long b, float* sx, float* sy,
                                 float* sz) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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

// The cloud is blockIdx.y, looped over when b exceeds the grid's 65,535.
__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ queries, int b,
                      int n, int m, Rings rings, int* __restrict__ idx, int* __restrict__ cnt) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y)
    ball_query_cloud(xyz, queries, n, m, rings, idx, cnt, bt, sx, sy, sz);
}

// ------------------------------------------------------------ grid route

constexpr int kBuildThreads = 1024;
constexpr int kGridMaxPoints = 16384;  // a point's slot in the sort is 16 bits
constexpr int kGridMaxCells = 65536;   // a cell is a 16-bit key
constexpr int kAxisCells = 1024;       // at most, an axis
constexpr int kGridWords = 8;          // doubles a cloud's grid takes in `grids`
constexpr int kNeighbours = 27;

// A cloud's grid, as the build writes it to `grids` (kGridWords doubles):
// lo[3], cell, dims[3], cells.
struct Grid {
  double lo[3];
  double cell;
  int dims[3];
  int cells;
};

__device__ __forceinline__ Grid load_grid(const double* g) {
  Grid out;
  out.lo[0] = g[0];
  out.lo[1] = g[1];
  out.lo[2] = g[2];
  out.cell = g[3];
  out.dims[0] = (int)g[4];
  out.dims[1] = (int)g[5];
  out.dims[2] = (int)g[6];
  out.cells = (int)g[7];
  return out;
}

// The cell coordinate of x along one axis, for points and queries alike:
// floor((x - lo) / cell) in double precision, held in [-2, dim + 1] (a query
// outside the grid: its neighbourhood there is empty or clamped).
__device__ __forceinline__ int axis_cell(float x, double lo, double cell, int dim) {
  double t = floor(((double)x - lo) / cell);
  t = fmin(fmax(t, -2.0), (double)dim + 1.0);
  return t == t ? (int)t : -2;  // NaN: outside
}

__device__ __forceinline__ int point_cell(float x, float y, float z, const Grid& g) {
  const int cx = min(max(axis_cell(x, g.lo[0], g.cell, g.dims[0]), 0), g.dims[0] - 1);
  const int cy = min(max(axis_cell(y, g.lo[1], g.cell, g.dims[1]), 0), g.dims[1] - 1);
  const int cz = min(max(axis_cell(z, g.lo[2], g.cell, g.dims[2]), 0), g.dims[2] - 1);
  return (cx * g.dims[1] + cy) * g.dims[2] + cz;
}

// Exclusive scan of v over the first `count` threads (count <= 1,024) of the
// block, in thread order; every thread calls it. s_sum: 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int count, int* s_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if ((int)threadIdx.x >= count) v = 0;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? s_sum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    s_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int out = incl - v + (warp > 0 ? s_sum[warp - 1] : 0);
  __syncthreads();  // s_sum may be reused
  return out;
}

// One block a cloud: the grid, then the cloud's points in cell order, each
// cell's in ascending index order: a stable LSD radix sort of the 16-bit cell
// keys, 4 bits a pass, the point indices riding along from index order.
// A pass: each warp counts the digits of its contiguous run of points;
// a scan over (digit, warp) gives each warp's first slot for each digit;
// each warp then walks its run in order, 32 points at a time,
// __match_any_sync ranking equal digits in lane order. Shared memory: two
// buffers of n keys and n indices, 16 bits each.
__global__ void __launch_bounds__(kBuildThreads)
    grid_build_kernel(const float* __restrict__ xyz, int n, double cell_min, int cap,
                      double* __restrict__ grids, int* __restrict__ cell_start,
                      float4* __restrict__ sorted) {
  extern __shared__ unsigned short s_buf[];
  unsigned short* keys[2] = {s_buf, s_buf + n};
  unsigned short* vals[2] = {s_buf + 2 * n, s_buf + 3 * n};
  __shared__ float s_red[6][32];
  __shared__ int s_sum[32];
  __shared__ int s_hist[16 * 32];  // [digit][warp]
  __shared__ int s_run[32 * 16];   // [warp][digit]
  __shared__ Grid s_grid;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const float* p = xyz + (size_t)blockIdx.x * n * 3;
  int* cs = cell_start + (size_t)blockIdx.x * (cap + 1);
  float4* out = sorted + (size_t)blockIdx.x * n;

  // bounding box
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = p[3 * j + a];
      if (isfinite(v)) {  // a non-finite point is inside no ring: any cell will do
        lo[a] = fminf(lo[a], v);
        hi[a] = fmaxf(hi[a], v);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
    if (lane == 0) {
      s_red[a][warp] = lo[a];
      s_red[3 + a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double blo[3], ext[3], emax = 0.0;
    for (int a = 0; a < 3; ++a) {
      float l = INFINITY, h = -INFINITY;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        l = fminf(l, s_red[a][w]);
        h = fmaxf(h, s_red[3 + a][w]);
      }
      if (!(l <= h)) l = h = 0.0f;  // no finite point on this axis
      blo[a] = l;
      ext[a] = (double)h - (double)l;
      emax = fmax(emax, ext[a]);
    }
    // at least cell_min, at most kAxisCells an axis and cap in all
    double cell = fmax(cell_min, emax / (kAxisCells - 1));
    if (!(cell > 0.0)) cell = 1.0;
    long long cells;
    int dims[3];
    for (;;) {
      cells = 1;
      for (int a = 0; a < 3; ++a) {
        dims[a] = (int)floor(ext[a] / cell) + 1;
        cells *= dims[a];
      }
      if (cells <= cap) break;
      cell *= 1.25;
    }
    Grid g;
    for (int a = 0; a < 3; ++a) {
      g.lo[a] = blo[a];
      g.dims[a] = dims[a];
    }
    g.cell = cell;
    g.cells = (int)cells;
    s_grid = g;
    double* gw = grids + (size_t)blockIdx.x * kGridWords;
    for (int a = 0; a < 3; ++a) {
      gw[a] = g.lo[a];
      gw[4 + a] = g.dims[a];
    }
    gw[3] = g.cell;
    gw[7] = g.cells;
  }
  __syncthreads();
  const Grid g = s_grid;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    keys[0][j] = (unsigned short)point_cell(p[3 * j], p[3 * j + 1], p[3 * j + 2], g);
    vals[0][j] = (unsigned short)j;
  }
  __syncthreads();

  const int chunk = (n + nwarps - 1) / nwarps;
  const int c0 = min(n, warp * chunk);
  const int c1 = min(n, c0 + chunk);
  int bits = 0;
  while ((1 << bits) < g.cells) bits += 4;
  int cur = 0;
  for (int sh = 0; sh < bits; sh += 4) {
    if (lane < 16) s_hist[lane * 32 + warp] = 0;
    __syncwarp();
    for (int base = c0; base < c1; base += 32) {
      const int j = base + lane;
      const unsigned live = __ballot_sync(0xffffffffu, j < c1);
      if (j < c1) {
        const int d = (keys[cur][j] >> sh) & 15;
        const unsigned peers = __match_any_sync(live, d);
        if (lane == __ffs(peers) - 1) s_hist[d * 32 + warp] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    const int t = threadIdx.x;
    const int first = block_exclusive_scan(t < 16 * 32 ? s_hist[t] : 0, 16 * 32, s_sum);
    if (t < 16 * 32) s_run[(t & 31) * 16 + (t >> 5)] = first;
    __syncthreads();
    const int nxt = cur ^ 1;
    for (int base = c0; base < c1; base += 32) {
      const int j = base + lane;
      const unsigned live = __ballot_sync(0xffffffffu, j < c1);
      if (j < c1) {
        const unsigned short key = keys[cur][j];
        const int d = (key >> sh) & 15;
        const unsigned peers = __match_any_sync(live, d);
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (lane == leader) {
          at = s_run[warp * 16 + d];
          s_run[warp * 16 + d] = at + __popc(peers);
        }
        at = __shfl_sync(live, at, leader) + __popc(peers & lower);
        keys[nxt][at] = key;
        vals[nxt][at] = vals[cur][j];
      }
      __syncwarp();
    }
    __syncthreads();
    cur = nxt;
  }

  // cell offsets from the sorted keys: each run of equal keys starts its
  // cell, and the empty cells before it start there too
  for (int q = threadIdx.x; q <= n; q += blockDim.x) {
    const int prev = q > 0 ? keys[cur][q - 1] : -1;
    const int next = q < n ? keys[cur][q] : g.cells;
    for (int c = prev + 1; c <= next; ++c) cs[c] = q;
  }
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int j = vals[cur][q];
    out[q] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], __int_as_float(j));
  }
}

__device__ __forceinline__ bool ring_hit(const Rings& rings, int r, float d2) {
  return rings.annulus[r] ? ((d2 >= rings.lo2[r] && d2 < rings.hi2[r]) || d2 == 0.0f)
                          : d2 < rings.hi2[r];
}

// One warp a query of cloud b: the 27 cells around it, one list a lane,
// merged in index order (see the file's header).
__device__ void grid_query(const float4* __restrict__ sorted, const int* __restrict__ cell_start,
                           const double* __restrict__ grids, const float* __restrict__ queries,
                           int n, int m, int cap, const Rings& rings, int* __restrict__ idx,
                           int* __restrict__ cnt, long long b, int qi) {
  const int lane = threadIdx.x & 31;
  const float* q = queries + ((size_t)b * m + qi) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const Grid g = load_grid(grids + (size_t)b * kGridWords);
  const float4* pts = sorted + (size_t)b * n;
  const int* cs = cell_start + (size_t)b * (cap + 1);

  // this lane's cell: offset (lane / 9, lane / 3 % 3, lane % 3) - 1
  int at = 0, end = 0;
  if (lane < kNeighbours) {
    const int cx = axis_cell(qx, g.lo[0], g.cell, g.dims[0]) + lane / 9 - 1;
    const int cy = axis_cell(qy, g.lo[1], g.cell, g.dims[1]) + lane / 3 % 3 - 1;
    const int cz = axis_cell(qz, g.lo[2], g.cell, g.dims[2]) + lane % 3 - 1;
    if (cx >= 0 && cx < g.dims[0] && cy >= 0 && cy < g.dims[1] && cz >= 0 && cz < g.dims[2]) {
      const int c = (cx * g.dims[1] + cy) * g.dims[2] + cz;
      at = cs[c];
      end = cs[c + 1];
    }
  }
  // the lane's head: its list's next point inside any ring (INT_MAX: spent);
  // `next` is the point after the last one read, loaded ahead
  float4 next = at < end ? pts[at] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int head = INT_MAX;
  float head_d2 = 0.0f;
  auto advance = [&]() {
    head = INT_MAX;
    while (at < end) {
      const float4 v = next;
      ++at;
      if (at < end) next = pts[at];
      const float dx = qx - v.x;
      const float dy = qy - v.y;
      const float dz = qz - v.z;
      const float d2 = (dx * dx + dy * dy) + dz * dz;
      bool any = false;
#pragma unroll
      for (int r = 0; r < kMaxRings; ++r) any = any || (r < rings.count && ring_hit(rings, r, d2));
      if (any) {
        head = __float_as_int(v.w);
        head_d2 = d2;
        return;
      }
    }
  };
  advance();

  int* out = idx + ((size_t)b * m + qi) * rings.ns_total;
  int c[kMaxRings];
  int first[kMaxRings];
#pragma unroll
  for (int r = 0; r < kMaxRings; ++r) {
    c[r] = 0;
    first[r] = 0;
  }
  for (;;) {
    const int j = (int)__reduce_min_sync(0xffffffffu, (unsigned)head);
    if (j == INT_MAX) break;
    const bool mine = head == j;  // one lane: a point lies in one cell
    const int owner = __ffs(__ballot_sync(0xffffffffu, mine)) - 1;
    const float d2 = __shfl_sync(0xffffffffu, head_d2, owner);
    bool full = true;
#pragma unroll
    for (int r = 0; r < kMaxRings; ++r) {
      if (r < rings.count) {
        if (ring_hit(rings, r, d2)) {
          if (c[r] == 0) first[r] = j;
          if (c[r] < rings.ns[r] && lane == 0) out[rings.off[r] + c[r]] = j;
          ++c[r];
        }
        full = full && c[r] >= rings.ns[r];
      }
    }
    if (full) break;
    if (mine) advance();
  }
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

// One warp a query, 8 a block.
__global__ void __launch_bounds__(kWarps * 32)
    ball_query_grid_kernel(const float4* __restrict__ sorted, const int* __restrict__ cell_start,
                           const double* __restrict__ grids, const float* __restrict__ queries,
                           int nb, int n, int m, int cap, Rings rings, int* __restrict__ idx,
                           int* __restrict__ cnt) {
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qi >= m) return;  // the whole warp: no barrier below
  // the cloud is blockIdx.y, looped over when nb exceeds the grid's 65,535
  for (long long b = blockIdx.y; b < nb; b += gridDim.y)
    grid_query(sorted, cell_start, grids, queries, n, m, cap, rings, idx, cnt, b, qi);
}

cudaError_t launch_grid_route(const float* xyz, const float* queries, int* idx, int* cnt, int b,
                              int n, int m, const Rings& rings, double* grids, int* cell_start,
                              float* sorted, int cap, double cell_min, cudaStream_t stream) {
  if (n > kGridMaxPoints || cap <= 0 || cap > kGridMaxCells || !(cell_min >= 0.0)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = 4 * sizeof(unsigned short) * (size_t)n;
  {  // an attribute of the current card: set at every call
    const cudaError_t err =
        cudaFuncSetAttribute(grid_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(4 * sizeof(unsigned short) * kGridMaxPoints));
    if (err != cudaSuccess) return err;
  }
  grid_build_kernel<<<b, kBuildThreads, smem, stream>>>(
      xyz, n, cell_min, cap, grids, cell_start, reinterpret_cast<float4*>(sorted));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((m + kWarps - 1) / kWarps, b < kMaxGridY ? b : kMaxGridY);
  ball_query_grid_kernel<<<grid, kWarps * 32, 0, stream>>>(
      reinterpret_cast<const float4*>(sorted), cell_start, grids, queries, b, n, m, cap, rings,
      idx, cnt);
  return cudaGetLastError();
}

}  // namespace

// xyz: f32 [b, n, 3]; queries: f32 [b, m, 3]; idx: i32 [b, m, sum(ns)], ring r
// in columns [sum(ns[:r]), sum(ns[:r+1])); cnt: i32 [b, m, n_rings].
// lo2 / hi2 / annulus / ns are host arrays of n_rings entries (n_rings <= 4).
// grid 0: the brute-force route. grid 1: the grid route, with scratch from
// the wrapper: grids f64 [b, 8], cell_start i32 [b, cap + 1], sorted f32
// [b, n, 4]; cap (<= 65,536) bounds a cloud's cells, cell_min (>= the outer
// radius) the cell's edge; n <= 16,384.
extern "C" int ssd3d_ball_query(const float* xyz, const float* queries, int* idx, int* cnt,
                                int b, int n, int m, int n_rings, const float* lo2,
                                const float* hi2, const int* annulus, const int* ns, int grid,
                                double* grids, int* cell_start, float* sorted, int cap,
                                double cell_min, cudaStream_t stream) {
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
  if (grid) {
    return (int)launch_grid_route(xyz, queries, idx, cnt, b, n, m, rings, grids, cell_start,
                                  sorted, cap, cell_min, stream);
  }
  dim3 blocks((m + kWarps - 1) / kWarps, b < kMaxGridY ? b : kMaxGridY);
  ball_query_kernel<<<blocks, kWarps * 32, 0, stream>>>(xyz, queries, b, n, m, rings, idx, cnt);
  return (int)cudaGetLastError();
}

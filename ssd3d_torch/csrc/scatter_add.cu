// K5: row scatter-add, the backward of the grouping gather (K4), with no
// float atomics: every destination row is summed in one fixed order.
//
// Replaces ssd3d/ops/pallas/scatter_add.py:68 (_scatter_add_raw, the Pallas
// _kernel via scatter_add_rows_pallas) and the XLA scatter of the gather's
// VJP, ssd3d/ops/pallas/gather.py:124 (_gather_bwd). Contract of the
// reference's GroupPointGrad (tf_grouping_g.cu:362-398):
//   dsrc[b, n, c] = 0;  dsrc[b, clamp(idx[b, r], 0, n-1), :] += g[b, r, :]
// f32 only; duplicate indices accumulate. Here each destination adds its
// source rows in ascending row order with plain f32 adds from 0.0f: the
// order of index_add_ on the CPU (the plain version there), so the two agree
// bit for bit, and two launches give the same bits.
//
// What bounds it on the H100: bytes. It reads rows * c f32 of g once (140 MB
// at the flagship's SA2 backward, 524,288 rows x 67, batch 8: 0.045 ms) and
// writes b * n * c f32 once; the index work is a few int32 arrays of b * rows
// and b * n entries.
//
// Design: a CSR of each cloud by destination, then one warp a destination.
// 1. histogram: a thread a row counts its destination (int atomics: a count
//    does not depend on the order of its adds);
// 2. scan: one block a cloud turns the counts into each destination's
//    first slot (offs, b x (n + 1)), and into the fill's cursors;
// 3. fill: a thread a row takes a slot of its destination with an int
//    atomic and writes its row number there; within a destination the rows
//    land in no fixed order;
// 4. sum: a warp a destination sorts its rows (a bitonic sort, ascending,
//    in the warp's 4 KB of shared memory up to 1,024 rows, in place in the
//    fill's array beyond), then adds them in that order, channels across the
//    lanes, 128 channels a pass, four rows' loads in flight. Rows average 16
//    a destination at SA2.
// The cloud is blockIdx.y in passes 1 and 3, looped over past the grid's
// 65,535; row and slot numbers are 32-bit within a cloud, every offset into
// g, dsrc and the fill's array is 64-bit, so b * rows may pass 2^31.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxGridY = 65535;
constexpr int kWarps = kThreads / 32;
constexpr int kSortShared = 1024;  // rows a warp sorts in shared memory
constexpr int kPer = 4;            // channels a lane adds a pass
constexpr int kAhead = 4;          // rows whose loads a lane keeps in flight

__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int* __restrict__ idx, int* __restrict__ cnt, int b, int n, int rows) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y)
    atomicAdd(cnt + bt * n + min(max(idx[bt * rows + r], 0), n - 1), 1);
}

// counts -> offs (exclusive, n + 1 a cloud) and the cursors, over cnt
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ cnt, int* __restrict__ offs, int b, int n) {
  __shared__ int wsum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long bt = blockIdx.x; bt < b; bt += gridDim.x) {
    int* c = cnt + bt * n;
    int* o = offs + bt * (n + 1);
    int carry = 0;
    for (int base = 0; base < n; base += kScanThreads) {
      const int i = base + threadIdx.x;
      const int v = i < n ? c[i] : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) wsum[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int s = wsum[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, s, d);
          if (lane >= d) s += y;
        }
        wsum[lane] = s;
      }
      __syncthreads();
      const int before = carry + (warp > 0 ? wsum[warp - 1] : 0) + x - v;
      if (i < n) {
        o[i] = before;
        c[i] = before;
      }
      carry += wsum[31];
      __syncthreads();  // wsum is read before the next chunk writes it
    }
    if (threadIdx.x == 0) o[n] = carry;
  }
}

__global__ void __launch_bounds__(kThreads)
    fill_kernel(const int* __restrict__ idx, int* __restrict__ cursor, int* __restrict__ order,
                int b, int n, int rows) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y) {
    const int d = min(max(idx[bt * rows + r], 0), n - 1);
    order[bt * rows + atomicAdd(cursor + bt * n + d, 1)] = r;
  }
}

// keys[lo] <= keys[hi] (lo < hi); a slot past len holds +infinity
__device__ __forceinline__ void order_pair(int* keys, int lo, int hi, int len) {
  if (hi >= len) return;
  const int a = keys[lo], c = keys[hi];
  if (a > c) {
    keys[lo] = c;
    keys[hi] = a;
  }
}

// Ascending bitonic sort of keys[0, len) by one warp, in the form whose
// merges all run one way (a mirrored compare opens each merge), so the
// slots past len act as +infinity and are never touched. keys is shared or
// global memory; __syncwarp orders each stage's accesses.
__device__ void warp_sort(int* keys, int len) {
  const int lane = threadIdx.x & 31;
  int p = 1;
  while (p < len) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int i = lane; i < p / 2; i += 32) {
      const int lo = i / (k / 2) * k + i % (k / 2);
      order_pair(keys, lo, lo - i % (k / 2) + k - 1 - i % (k / 2), len);
    }
    __syncwarp();
    for (int j = k / 4; j > 0; j >>= 1) {
      for (int i = lane; i < p / 2; i += 32) {
        const int lo = i / j * 2 * j + i % j;
        order_pair(keys, lo, lo + j, len);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sum_kernel(const float* __restrict__ g, const int* __restrict__ offs, int* __restrict__ order,
               float* __restrict__ dsrc, int n, int rows, int c, long long dests) {
  __shared__ int sorted[kWarps][kSortShared];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long dst = (long long)blockIdx.x * kWarps + warp; dst < dests;
       dst += (long long)gridDim.x * kWarps) {
    const long long bt = dst / n;
    const int d = (int)(dst - bt * n);
    const int beg = offs[bt * (n + 1) + d];
    const int len = offs[bt * (n + 1) + d + 1] - beg;
    int* keys = order + bt * rows + beg;
    if (len <= kSortShared) {
      for (int i = lane; i < len; i += 32) sorted[warp][i] = keys[i];
      keys = sorted[warp];
      __syncwarp();
    }
    warp_sort(keys, len);
    const float* gb = g + bt * rows * (long long)c;
    float* out = dsrc + dst * c;
    for (int c0 = lane; c0 < c; c0 += 32 * kPer) {
      float acc[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc[q] = 0.0f;
      int k = 0;
      for (; k + kAhead <= len; k += kAhead) {
        float x[kAhead][kPer];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const float* row = gb + (long long)keys[k + u] * c + c0;
#pragma unroll
          for (int q = 0; q < kPer; ++q) x[u][q] = c0 + 32 * q < c ? row[32 * q] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
#pragma unroll
          for (int q = 0; q < kPer; ++q) acc[q] += x[u][q];
      }
      for (; k < len; ++k) {
        const float* row = gb + (long long)keys[k] * c + c0;
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          if (c0 + 32 * q < c) acc[q] += row[32 * q];
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (c0 + 32 * q < c) out[c0 + 32 * q] = acc[q];
    }
    __syncwarp();  // the warp's buffer is read before the next destination fills it
  }
}

}  // namespace

// idx: i32 [b, rows]; g: f32 [b, rows, c]; dsrc: f32 [b, n, c], overwritten.
// Scratch from the wrapper, i32: cnt [b, n], offs [b, n + 1], order [b, rows].
extern "C" int ssd3d_scatter_add_rows(const int* idx, const float* g, float* dsrc, int* cnt,
                                      int* offs, int* order, int b, int n, int rows, int c,
                                      cudaStream_t stream) {
  if (b <= 0 || n <= 0 || rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)b * n, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 row_grid((rows + kThreads - 1) / kThreads, b < kMaxGridY ? b : kMaxGridY);
  if (rows > 0) {
    histogram_kernel<<<row_grid, kThreads, 0, stream>>>(idx, cnt, b, n, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_kernel<<<b < INT_MAX ? b : INT_MAX, kScanThreads, 0, stream>>>(cnt, offs, b, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (rows > 0) {
    fill_kernel<<<row_grid, kThreads, 0, stream>>>(idx, cnt, order, b, n, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long dests = (long long)b * n;
  const long long blocks = (dests + kWarps - 1) / kWarps;
  sum_kernel<<<(unsigned)(blocks < INT_MAX ? blocks : INT_MAX), kThreads, 0, stream>>>(
      g, offs, order, dsrc, n, rows, c, dests);
  return (int)cudaGetLastError();
}

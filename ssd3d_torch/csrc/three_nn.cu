// K6: three_nn, the 3 nearest known points of each unknown point.
//
// Replaces the Pallas kernel ssd3d/ops/pallas/three_nn.py:_three_nn_kernel
// (via three_nn_pallas). Contract: for each unknown point, the squared
// distances ((dx*dx + dy*dy) + dz*dz, dx = unknown - known, each product and
// sum rounded separately under -fmad=false) to its three nearest knowns,
// nearest first; equal distances fill the slots in index order (the scan of
// the reference CUDA op, tf_interpolate_g.cu). The indices equal the plain
// version's and the distances are bit-identical to it. No backward: the op
// has none.
//
// What bounds it on the H100: operations. The largest call (PointRCNN FP1,
// batch 4: 16,384 unknowns x 4,096 knowns per cloud) is 2.7e8 pairs of about
// 9 FLOP each, about 0.04 ms at 67 TFLOP/s of f32; it reads 1 MB and writes
// 1.5 MB. The TPU kernel built a [tile, m] distance matrix in VMEM and took
// three min passes over it; here no matrix exists.
//
// Design: one thread per unknown point, its 3-best list in registers,
// updated with strict < while the knowns are scanned in index order (that is
// the tie rule). A block of 128 unknowns of one cloud stages the knowns
// through shared memory in tiles of 1,024, coordinate-major (12 KB), so each
// known is read from device memory once per block and every thread of a warp
// reads the same shared word (a broadcast). The cloud is blockIdx.y, looped
// over when b exceeds the grid's 65,535, so any batch is taken.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kMaxGridY = 65535;

// One cloud's block of unknowns (every thread of the block calls it: it
// holds barriers).
__device__ void three_nn_cloud(const float* __restrict__ unknown, const float* __restrict__ known,
                               int n, int m, float* __restrict__ dist, int* __restrict__ idx,
                               long long b, float* sx, float* sy, float* sz) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float* u = unknown + (b * n + min(q, n - 1)) * 3;
  const float ux = u[0], uy = u[1], uz = u[2];
  const float* kb = known + b * m * 3;
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    __syncthreads();  // the previous tile (or cloud) is consumed
    for (int j = threadIdx.x; j < len; j += kThreads) {
      sx[j] = kb[3 * (t0 + j)];
      sy[j] = kb[3 * (t0 + j) + 1];
      sz[j] = kb[3 * (t0 + j) + 2];
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float dx = ux - sx[j];
      const float dy = uy - sy[j];
      const float dz = uz - sz[j];
      const float d = (dx * dx + dy * dy) + dz * dz;
      if (d < d2) {
        const int k = t0 + j;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = k;
          } else {
            d1 = d;
            i1 = k;
          }
        } else {
          d2 = d;
          i2 = k;
        }
      }
    }
  }
  if (q < n) {
    const long long o = (b * n + q) * 3;
    dist[o] = d0;
    dist[o + 1] = d1;
    dist[o + 2] = d2;
    idx[o] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
  }
}

// The cloud is blockIdx.y, looped over when b exceeds the grid's 65,535.
__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int b,
                    int n, int m, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y)
    three_nn_cloud(unknown, known, n, m, dist, idx, bt, sx, sy, sz);
}

}  // namespace

// unknown: f32 [b, n, 3]; known: f32 [b, m, 3], m >= 3; dist: f32 [b, n, 3];
// idx: i32 [b, n, 3]. All contiguous.
extern "C" int ssd3d_three_nn(const float* unknown, const float* known, float* dist, int* idx,
                              int b, int n, int m, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m < 3) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads, b < kMaxGridY ? b : kMaxGridY);
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(unknown, known, b, n, m, dist, idx);
  return (int)cudaGetLastError();
}

// K1: D-FPS (farthest point sampling over xyz) for Hopper.
//
// Replaces the Pallas kernels ssd3d/ops/pallas/fps.py:_fps_batch_kernel
// (via _fps_pallas_batch, batch >= 4) and _fps_kernel (via _fps_pallas_tiled,
// batch < 4). Contract: pick 0 is index 0; each point keeps the running
// minimum squared distance ((dx*dx + dy*dy) + dz*dz, exact per-coordinate
// differences) to the picked set; the next pick is the argmax, ties to the
// lowest index.
//
// What bounds it on the H100: the m picks are sequential, and each one needs a
// block-wide argmax, so the kernel is bound by barrier and shuffle latency
// (about m * 2 __syncthreads), not by bytes or FLOPs: the flagship's SA1 does
// 4,096 picks over 16,384 points, 16 distance updates per thread per pick.
//
// Design: one block of 1,024 threads per cloud (the reference CUDA op,
// tf_sampling_g.cu:124, is shaped the same way). The coordinates live in
// shared memory as three planes (16,384 * 12 B = 192 KB at the flagship
// size), so no global traffic happens inside the loop; each thread keeps the
// distance field of its PPT strided points in registers. Keeping the
// coordinates in registers too would need 64 registers a thread for data
// alone, the whole budget at 1,024 threads, and would spill. The kernel uses
// only b SMs; spreading one cloud over a cluster is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPoints = 16384;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
    dfps_kernel(const float* __restrict__ xyz, int n, int m, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float s_d[32];
  __shared__ int s_i[32];
  __shared__ int s_win;

  const float* p = xyz + (size_t)blockIdx.x * n * 3;
  int* o = out + (size_t)blockIdx.x * m;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  float dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    dist[k] = threadIdx.x + k * kThreads < n ? INFINITY : -1.0f;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bd = -1.0f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < n) {
        const float dx = sx[j] - lx;
        const float dy = sy[j] - ly;
        const float dz = sz[j] - lz;
        const float d = (dx * dx + dy * dy) + dz * dz;
        const float nd = fminf(dist[k], d);
        dist[k] = nd;
        if (ssd3d::better(nd, j, bd, bi)) {
          bd = nd;
          bi = j;
        }
      }
    }
    last = ssd3d::block_argmax(bd, bi, s_d, s_i, &s_win);
    if (threadIdx.x == 0) o[s] = last;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int* out, int b, int n, int m, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dfps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dfps_kernel<PPT><<<b, kThreads, smem, stream>>>(xyz, n, m, out);
  return cudaGetLastError();
}

}  // namespace

// xyz: f32 [b, n, 3] contiguous; out: i32 [b, m]. n <= 16,384.
extern "C" int ssd3d_dfps(const float* xyz, int* out, int b, int n, int m,
                          cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0 || n > kMaxPoints) return (int)cudaErrorInvalidValue;
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) return (int)launch<1>(xyz, out, b, n, m, stream);
  if (ppt <= 2) return (int)launch<2>(xyz, out, b, n, m, stream);
  if (ppt <= 4) return (int)launch<4>(xyz, out, b, n, m, stream);
  if (ppt <= 8) return (int)launch<8>(xyz, out, b, n, m, stream);
  return (int)launch<16>(xyz, out, b, n, m, stream);
}

// K2: F-FPS (farthest point sampling over fused xyz ++ feature vectors).
//
// Replaces the Pallas kernels ssd3d/ops/pallas/fps.py:_ffps_kernel (via
// ffps_pallas_pre / ffps_pallas, whole d2 matrix resident in VMEM) and
// _ffps_hbm_kernel (via ffps_pallas_hbm_rows / ffps_pallas_hbm, picked row
// streamed from HBM). Same loop as D-FPS: pick 0 is index 0, running minimum
// of squared distance, argmax with ties to the lowest index.
//
// Where the TPU built the [n, n] distance matrix first (512 MB at the
// flagship's SA2 segment, batch 8), this kernel computes the picked point's
// row on the fly: d2 = sum_c (f_c - f_pick,c)^2 with exact differences and
// the channels accumulated in order, the same arithmetic as the plain PyTorch
// version in ssd3d_torch/ops/sampling.py. One pick costs n * c multiply-adds
// and reads the cloud's n * c floats once (1.1 MB at n = 4,096, c = 67; the
// batch's 8.8 MB stays in the 50 MB L2).
//
// What bounds it on the H100: the per-pick read of the cloud from L2 by one
// SM, plus the two block barriers of the argmax. Design: one block of 1,024
// threads per cloud; the fused vectors arrive channel-major ([b, c, n]) so a
// warp reads 32 consecutive points of one channel per load (coalesced); the
// picked vector is staged in shared memory; the distance field stays in
// registers (PPT points a thread). Splitting a cloud over several SMs, and
// keeping the SA3 cloud (512 x 131 floats = 268 KB) on chip, is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPoints = 8192;
constexpr int kMaxChannels = 4096;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
    ffps_kernel(const float* __restrict__ feat, int n, int c, int m, int* __restrict__ out) {
  extern __shared__ float s_pick[];
  __shared__ float s_d[32];
  __shared__ int s_i[32];
  __shared__ int s_win;

  const float* f = feat + (size_t)blockIdx.x * c * n;
  int* o = out + (size_t)blockIdx.x * m;
  float dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    dist[k] = threadIdx.x + k * kThreads < n ? INFINITY : -1.0f;
  }
  if (threadIdx.x == 0) o[0] = 0;

  int last = 0;
  for (int s = 1; s < m; ++s) {
    // the previous block_argmax ended with a barrier, so nobody still reads
    // the old pick
    for (int ch = threadIdx.x; ch < c; ch += kThreads) s_pick[ch] = f[(size_t)ch * n + last];
    __syncthreads();
    float acc[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) acc[k] = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const float pv = s_pick[ch];
      const float* row = f + (size_t)ch * n;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int j = threadIdx.x + k * kThreads;
        if (j < n) {
          const float diff = row[j] - pv;
          acc[k] = acc[k] + diff * diff;
        }
      }
    }
    float bd = -1.0f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < n) {
        const float nd = fminf(dist[k], acc[k]);
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
cudaError_t launch(const float* feat, int* out, int b, int n, int c, int m,
                   cudaStream_t stream) {
  ffps_kernel<PPT><<<b, kThreads, (size_t)c * sizeof(float), stream>>>(feat, n, c, m, out);
  return cudaGetLastError();
}

}  // namespace

// feat: f32 [b, c, n] contiguous (channel-major); out: i32 [b, m].
// n <= 8,192, c <= 4,096.
extern "C" int ssd3d_ffps(const float* feat, int* out, int b, int n, int c, int m,
                          cudaStream_t stream) {
  if (b <= 0 || n <= 0 || c <= 0 || m <= 0 || n > kMaxPoints || c > kMaxChannels) {
    return (int)cudaErrorInvalidValue;
  }
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) return (int)launch<1>(feat, out, b, n, c, m, stream);
  if (ppt <= 2) return (int)launch<2>(feat, out, b, n, c, m, stream);
  if (ppt <= 4) return (int)launch<4>(feat, out, b, n, c, m, stream);
  return (int)launch<8>(feat, out, b, n, c, m, stream);
}

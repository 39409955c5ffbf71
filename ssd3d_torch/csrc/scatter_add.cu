// K5: row scatter-add, the backward of the grouping gather (K4).
//
// Replaces ssd3d/ops/pallas/scatter_add.py:68 (_scatter_add_raw, the Pallas
// _kernel via scatter_add_rows_pallas) and the XLA scatter of the gather's
// VJP, ssd3d/ops/pallas/gather.py:124 (_gather_bwd). Contract of the
// reference's GroupPointGrad (tf_grouping_g.cu:362-398):
//   dsrc[b, n, c] = 0;  dsrc[b, clamp(idx[b, r], 0, n-1), :] += g[b, r, :]
// f32 only; duplicate indices accumulate.
//
// What bounds it on the H100: bytes and atomic throughput. It reads rows * c
// f32 of g once (140 MB at the flagship's SA2 backward, 524,288 rows x 67,
// batch 8) and adds each into a destination of b * n * c f32 (8.8 MB there),
// which stays in the 50 MB L2, where the atomics resolve. Contention is real:
// ball-query padding repeats a ball's first hit, so one destination row gets
// up to ns adds from one ball, and neighbouring balls overlap.
//
// Design (simple and right first): the destination is zeroed with
// cudaMemsetAsync on the launch's stream, then one thread per (row, channel)
// element adds with f32 atomicAdd. A block is 32 x 8 threads: threadIdx.y
// picks one of 8 rows, threadIdx.x walks that row's channels 32 at a time, so
// a warp's loads from g are consecutive words of one row (coalesced), and no
// thread divides a 64-bit index: the row index is 32-bit and one division per
// row finds its batch. Grid-stride loop over rows, as in K4.
//
// The sum's order follows the atomics, so the last bits of dsrc vary from run
// to run (as they do for the plain version, index_add_ on the card). A
// deterministic variant (sorted or segmented accumulation) is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;      // threads along a row's channels
constexpr int kRowsPerBlock = 8;

__global__ void scatter_add_rows_kernel(const int* __restrict__ idx, const float* __restrict__ g,
                                        float* __restrict__ dsrc, int n, int rows, int c,
                                        int total_rows) {
  for (int row = blockIdx.x * kRowsPerBlock + threadIdx.y; row < total_rows;
       row += gridDim.x * kRowsPerBlock) {
    const int b = row / rows;  // one 32-bit division per row
    const int j = min(max(idx[row], 0), n - 1);
    const float* src = g + (long long)row * c;
    float* dst = dsrc + ((long long)b * n + j) * c;
    for (int ch = threadIdx.x; ch < c; ch += kLanes) {
      atomicAdd(dst + ch, src[ch]);
    }
  }
}

}  // namespace

// idx: i32 [b, rows]; g: f32 [b, rows, c]; dsrc: f32 [b, n, c], overwritten.
extern "C" int ssd3d_scatter_add_rows(const int* idx, const float* g, float* dsrc, int b,
                                      int n, int rows, int c, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)b * rows > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(dsrc, 0, sizeof(float) * (size_t)b * n * c, stream);
  if (err != cudaSuccess) return (int)err;
  const int total_rows = b * rows;
  if (total_rows == 0) return (int)cudaSuccess;
  int blocks = (total_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 132 * 64) blocks = 132 * 64;
  scatter_add_rows_kernel<<<blocks, dim3(kLanes, kRowsPerBlock), 0, stream>>>(
      idx, g, dsrc, n, rows, c, total_rows);
  return (int)cudaGetLastError();
}

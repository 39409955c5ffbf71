// K4: row gather, forward only.
//
// Replaces the Pallas kernel ssd3d/ops/pallas/gather.py:_kernel (via
// gather_rows_pallas): out[b, r, :] = src[b, idx[b, r], :], bit-identical to
// indexing. Elements are moved as 32-bit words, so f32 and i32 rows are
// copied exactly. Indices outside [0, n) are clamped, as the JAX package's
// group_points documents. The backward (a scatter-add) is not ported yet.
//
// What bounds it on the H100: bytes. It reads and writes rows * c words, e.g.
// 4.2 M rows of 4 words at SA1 (batch 8), 134 MB in and out, plus the index.
// Design: one thread per output word, consecutive threads on consecutive
// words of a row, so stores are coalesced and a row's loads fall into one or
// two sectors; grid-stride loop. The TPU's 256-channel split was a VMEM limit
// and has no counterpart here: any c is one launch.
#include <cstdint>

#include "common.cuh"

namespace {

__global__ void gather_rows_kernel(const uint32_t* __restrict__ src, const int* __restrict__ idx,
                                   uint32_t* __restrict__ out, int n, int rows, int c,
                                   long long total) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / c;  // b * rows + r
    const int ch = (int)(e - row * c);
    const long long b = row / rows;
    const int j = min(max(idx[row], 0), n - 1);
    out[e] = src[(b * n + j) * c + ch];
  }
}

}  // namespace

// src: 32-bit [b, n, c]; idx: i32 [b, rows]; out: 32-bit [b, rows, c].
extern "C" int ssd3d_gather_rows(const void* src, const int* idx, void* out, int b, int n,
                                 int rows, int c, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * rows * c;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  gather_rows_kernel<<<(int)blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(src), idx, static_cast<uint32_t*>(out), n, rows, c, total);
  return (int)cudaGetLastError();
}

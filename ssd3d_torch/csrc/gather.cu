// K4: row gather, forward (its backward, the row scatter-add, is K5 in
// scatter_add.cu).
//
// Replaces the Pallas kernel ssd3d/ops/pallas/gather.py:_kernel (via
// gather_rows_pallas): out[b, r, :] = src[b, idx[b, r], :], bit-identical to
// indexing. Rows are copied as 32-bit words (or vectors of them), so f32 and
// i32 rows are copied exactly. Indices outside [0, n) are clamped, as the JAX
// package's group_points documents.
//
// What bounds it on the H100: bytes. It writes rows * c words and reads as
// many (from L2 where the source fits there: SA1's [8, 16384, 4] is 2 MB),
// e.g. 2.1 M rows of 16 bytes at SA1 (batch 8).
//
// Design, two kernels, neither with a division per element:
// - rows of 16-byte vectors (c % 4 == 0 and both base pointers 16-byte
//   aligned: SA1's xyz + intensity, RegionPool's 128 channels): a group of G
//   lanes (a power of two, at most 32) copies one row, consecutive lanes on
//   consecutive vectors; a block of 256 threads copies 256 / G rows of one
//   batch element, so a row's batch and position come from blockIdx and
//   threadIdx, and its index is read once per row (one broadcast load for
//   the group's lanes).
// - any other width (67, 131, 259, RegionPool's 3-channel xyz and 1-channel
//   mask): a warp copies 32 consecutive rows, whose output is 32 * c
//   consecutive words, lane l taking words l, l + 32, ... so every lane
//   works and every store is coalesced. Lane i reads row i's index once; the
//   row of a word is a multiply-high by a magic reciprocal of c (exact for
//   the 32 * c words of a warp while c <= 8,192), and its index comes from
//   that row's lane by a shuffle.
// The alignment is checked on the actual pointers: a contiguous tensor with
// a storage offset may break it. Offsets are 64-bit. The batch is
// blockIdx.y, looped over when b exceeds the grid's 65,535. The TPU's
// 256-channel split was a VMEM limit and has no counterpart here: any c is
// one launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// V: the vector a lane moves (uint4; uint32_t for c > 8,192); cv: vectors a
// row; lg: log2 G.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                       V* __restrict__ out, int b, int n, int rows, int cv, int lg) {
  const int r = blockIdx.x * (kThreads >> lg) + (threadIdx.x >> lg);
  if (r >= rows) return;
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y) {
    const int j = min(max(idx[bt * rows + r], 0), n - 1);
    const V* s = src + (bt * n + j) * cv;
    V* o = out + (bt * rows + r) * cv;
    for (int ch = threadIdx.x & ((1 << lg) - 1); ch < cv; ch += 1 << lg) o[ch] = s[ch];
  }
}

// 32 rows of 32-bit words a warp; magic = 2^32 / c rounded up (unused at c = 1)
__global__ void __launch_bounds__(kThreads)
    gather_words_kernel(const uint32_t* __restrict__ src, const int* __restrict__ idx,
                        uint32_t* __restrict__ out, int b, int n, int rows, int c,
                        unsigned magic) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (r0 >= rows) return;  // the whole warp
  const int nr = min(32, rows - r0);
  const int words = nr * c;
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y) {
    const int j = lane < nr ? min(max(idx[bt * rows + r0 + lane], 0), n - 1) : 0;
    const uint32_t* s = src + bt * n * c;
    uint32_t* o = out + (bt * rows + r0) * c;
    for (int e0 = 0; e0 < words; e0 += 32) {
      const int e = e0 + lane;
      const int row = c == 1 ? e : (int)__umulhi((unsigned)e, magic);
      const int jr = __shfl_sync(0xffffffffu, j, row & 31);
      if (e < words) o[e] = s[(long long)jr * c + (e - row * c)];
    }
  }
}

template <typename V>
cudaError_t launch_rows(const void* src, const int* idx, void* out, int b, int n, int rows, int c,
                        cudaStream_t stream) {
  const int cv = c / (int)(sizeof(V) / 4);
  int lg = 0;
  while (lg < 5 && (1 << lg) < cv) ++lg;
  const dim3 grid((rows + (kThreads >> lg) - 1) / (kThreads >> lg), min(b, kMaxGridY));
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), idx, static_cast<V*>(out), b, n, rows, cv, lg);
  return cudaGetLastError();
}

cudaError_t launch_words(const void* src, const int* idx, void* out, int b, int n, int rows, int c,
                         cudaStream_t stream) {
  const int rows_a_block = kThreads;  // 32 a warp
  const dim3 grid((rows + rows_a_block - 1) / rows_a_block, min(b, kMaxGridY));
  const unsigned magic = c == 1 ? 0u : 0xFFFFFFFFu / (unsigned)c + 1u;
  gather_words_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const uint32_t*>(src), idx,
                                                     static_cast<uint32_t*>(out), b, n, rows, c,
                                                     magic);
  return cudaGetLastError();
}

}  // namespace

// src: 32-bit [b, n, c]; idx: i32 [b, rows]; out: 32-bit [b, rows, c].
extern "C" int ssd3d_gather_rows(const void* src, const int* idx, void* out, int b, int n,
                                 int rows, int c, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if (c % 4 == 0 && align % 16 == 0)
    return (int)launch_rows<uint4>(src, idx, out, b, n, rows, c, stream);
  if (c <= 8192) return (int)launch_words(src, idx, out, b, n, rows, c, stream);
  return (int)launch_rows<uint32_t>(src, idx, out, b, n, rows, c, stream);
}

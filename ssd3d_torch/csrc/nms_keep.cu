// K8: the greedy keep sweep of NMS.
//
// Replaces no Pallas kernel: the JAX package sweeps in a jax.lax.fori_loop
// (ssd3d/ops/nms.py:47 nms_bev, :170 iou_guided_nms) inside its jitted
// detector, where the port ran a Python loop of k steps, about three launches
// a step. This kernel is that loop's counterpart on the card, so that the
// whole forward runs with no host-driven loop and `torch.export` writes one
// node for the sweep instead of k steps.
//
// Contract: suppress bool [r, k, k] in visiting order -> keep bool [r, k];
// candidate j of row r is dropped iff some kept i < j has suppress[r, i, j]
// (entries on and below the diagonal are ignored). The IoU matrix, the
// threshold test, the sorts and the compaction stay in PyTorch, so keep equals
// the plain loop's bit for bit by construction: both read the same booleans.
//
// What bounds it on the H100: the sweep is sequential in the kept candidates
// (a latency chain, one dependent load per kept candidate); the bytes the
// function needs are the matrix's upper triangle read once (r * k * (k-1) / 2)
// and the keep mask written (r * k). The packed words (r * k * ceil(k/64) * 8,
// written and read) are scratch of this design and not part of that bound.
//
// Design (the classic GPU NMS, two kernels):
// - pack: one warp per 64-bit word of a row's upper triangle; lanes read 32
//   consecutive booleans twice and two ballots make the word. Words wholly on
//   or below the diagonal are written as 0 without a read.
// - sweep: one warp per row, the row's "removed" words in shared memory. The
//   next live candidate comes from the first zero bit of `removed` past the
//   current one (__ffsll), so dead candidates cost no load; a live one ORs its
//   packed words from its own word on (the lower ones are zero). At the end
//   keep = ~removed: a candidate's bit is set only by earlier kept rows.
#include "common.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kMaxBlocks = 1 << 20;
constexpr int kSmemMax = 232448;  // the H100's per-block shared memory

__global__ void __launch_bounds__(kPackThreads)
    nms_pack_kernel(const bool* __restrict__ suppress, unsigned long long* __restrict__ mask,
                    long long r, int k, int words) {
  const int lane = threadIdx.x & 31;
  const long long total = r * k * words;
  for (long long wid = (long long)blockIdx.x * (kPackThreads / 32) + (threadIdx.x >> 5);
       wid < total; wid += (long long)gridDim.x * (kPackThreads / 32)) {
    const int w = (int)(wid % words);
    const long long row_i = wid / words;  // row * k + i
    const int i = (int)(row_i % k);
    unsigned long long word = 0ull;
    if (w * 64 + 63 > i) {
      const bool* src = suppress + row_i * k;
      const int j0 = w * 64 + lane, j1 = j0 + 32;
      const bool a = j0 > i && j0 < k && src[j0];
      const bool b = j1 > i && j1 < k && src[j1];
      const unsigned lo = __ballot_sync(0xffffffffu, a);
      const unsigned hi = __ballot_sync(0xffffffffu, b);
      word = (unsigned long long)lo | ((unsigned long long)hi << 32);
    }
    if (lane == 0) mask[wid] = word;
  }
}

__global__ void __launch_bounds__(32)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask, bool* __restrict__ keep,
                     int r, int k, int words) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;
  for (int row = blockIdx.x; row < r; row += gridDim.x) {
    for (int w = lane; w < words; w += 32) removed[w] = 0ull;
    __syncwarp();
    const unsigned long long* m = mask + (long long)row * k * words;
    int i = 0;
    while (i < k) {
      int w = i >> 6;
      unsigned long long live = ~removed[w] & (~0ull << (i & 63));
      while (live == 0ull && ++w < words) live = ~removed[w];
      if (live == 0ull) break;
      i = (w << 6) + __ffsll((long long)live) - 1;
      if (i >= k) break;  // the last word's bits past k are never set
      __syncwarp();       // every lane has read `removed` before any lane ORs into it
      const unsigned long long* mi = m + (long long)i * words;
      for (int v = w + lane; v < words; v += 32) removed[v] |= mi[v];
      __syncwarp();
      ++i;
    }
    bool* out = keep + (long long)row * k;
    for (int j = lane; j < k; j += 32) out[j] = !((removed[j >> 6] >> (j & 63)) & 1ull);
    __syncwarp();
  }
}

}  // namespace

// suppress: bool [r, k, k]; mask: u64 scratch [r, k, words]; keep: bool [r, k].
extern "C" int ssd3d_nms_keep(const bool* suppress, unsigned long long* mask, bool* keep, int r,
                              int k, cudaStream_t stream) {
  if (r < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (r == 0 || k == 0) return (int)cudaSuccess;
  const int words = (k + 63) / 64;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)r * k * words;
  const long long blocks = (warps + kPackThreads / 32 - 1) / (kPackThreads / 32);
  nms_pack_kernel<<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kPackThreads, 0, stream>>>(
      suppress, mask, r, k, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<r < 65535 ? r : 65535, 32, smem, stream>>>(mask, keep, r, k, words);
  return (int)cudaGetLastError();
}

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
// What bounds it on the H100: the bytes the function needs are the matrix's
// upper triangle read once (r * k * (k-1) / 2) and the keep mask written
// (r * k); the packed words (written and read) are scratch of this design and
// not part of that bound. The sweep itself is sequential in the candidates of
// a row: its floor is the chain of tiles below, one after the other.
//
// Design (two kernels; the first design, a warp a row, took one dependent
// load from device memory a kept candidate):
// - pack: the upper triangle as 64-bit words in tile order. Word
//   mask[row][t][w][i] holds the bits j in 64w..64w+63 (j > 64t+i, j < k) of
//   candidate 64t+i, so the rows of tile t (candidates 64t..64t+63), words t
//   to W-1, are one contiguous run of (W - t) * 512 bytes. One warp a
//   candidate, two ballots a word, from its diagonal word on; blocks below
//   the diagonal (w < t) and the last tile's rows past k are never written
//   (the sweep masks both out). The pack stays a kernel of its own: it reads
//   the k * k booleans with the whole card, where the sweep has one block a
//   row.
// - sweep: one block of 256 threads a row. The row's tiles stream through
//   shared memory in stages (tile t's words in column chunks of up to 64
//   words), two buffers filled by 16-byte cp.async: stage s+1's copy is
//   issued before stage s resolves, and every row of a tile is loaded whether
//   it is kept or not, so no load waits on a keep decision.
// - the diagonal: warp 0 holds the tile's 64 x 64 block transposed (lane l
//   the columns l and l+32, three 32 x 32 bit transposes by shuffles; the
//   block is strictly upper triangular, so its fourth quarter is zero) and
//   the tile's live candidates (not removed by earlier tiles). The kept set is
//   the fixed point of K = {live j : no i in K suppresses j}, iterated from
//   K = live with two ballots a step: after s steps the candidates 0..s-1 of
//   the tile are final, and the fixed point is unique, so the loop ends within
//   the longest chain of suppressions inside the tile (64 steps at most, one
//   when nothing in the tile is suppressed): register operations, no memory
//   round trip. Lanes write the tile's 64 keep bytes.
// - the off-diagonal: each warp takes words w > t of the stage; a lane ORs
//   word w of the kept rows l and l+32 (shared memory, independent loads),
//   a warp OR-reduction, and lane 0 ORs the result into removed[w]. Two
//   barriers a stage: the stage landed, and the tile's kept word published.
// - removed (the row's W words) sits in shared memory beside the buffers, or,
//   where the budget leaves no room for it, in the scratch after the packed
//   words (one slice a block); no k the card can hold a matrix of is refused.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kPackThreads = 256;
constexpr int kPackUnroll = 4;  // words a pack warp loads before it ballots
constexpr int kMaxBlocks = 1 << 20;
constexpr int kSmemMax = 232448;  // the H100's per-block shared memory
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kChunkMax = 64;      // words of a stage
constexpr int kGridMax = 65535;    // blocks of the sweep (ops/nms.py sizes the scratch by it)
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPackThreads)
    nms_pack_kernel(const bool* __restrict__ suppress, u64* __restrict__ mask, long long r, int k,
                    int words) {
  const int lane = threadIdx.x & 31;
  const long long rows = r * k;  // candidate rows of all matrices
  for (long long cr = (long long)blockIdx.x * (kPackThreads / 32) + (threadIdx.x >> 5); cr < rows;
       cr += (long long)gridDim.x * (kPackThreads / 32)) {
    const long long row = cr / k;
    const int i = (int)(cr - row * k);
    const int t = i >> 6;
    const bool* src = suppress + cr * k;
    u64* dst = mask + (row * words + t) * words * 64 + (i & 63);  // word w at dst[64 * w]
    for (int w0 = t; w0 < words; w0 += kPackUnroll) {
      bool a[kPackUnroll], b[kPackUnroll];  // every load of the group before its ballots
#pragma unroll
      for (int u = 0; u < kPackUnroll; ++u) {
        const int j0 = (w0 + u) * 64 + lane, j1 = j0 + 32;
        a[u] = j0 > i && j0 < k && src[j0];
        b[u] = j1 > i && j1 < k && src[j1];
      }
#pragma unroll
      for (int u = 0; u < kPackUnroll; ++u) {
        const unsigned lo = __ballot_sync(kFull, a[u]);
        const unsigned hi = __ballot_sync(kFull, b[u]);
        if (lane == 0 && w0 + u < words) dst[64 * (w0 + u)] = (u64)lo | ((u64)hi << 32);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Words w0..w1-1 of tile t of one row's packed words (64 u64 a word column).
__device__ __forceinline__ void load_stage(const u64* m, int words, int t, int w0, int w1,
                                           u64* dst) {
  const u64* src = m + ((long long)t * words + w0) * 64;
  const int pieces = (w1 - w0) * 32;  // 16 bytes each
  for (int i = threadIdx.x; i < pieces; i += kSweepThreads) cp_async16(dst + 2 * i, src + 2 * i);
}

// The 32 x 32 bit transpose across a warp: lane l holds row l (bit c is
// column c) and gets column l (bit i is row i's bit l). Each step swaps the
// off-diagonal j x j blocks of every 2j x 2j block.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned left[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const unsigned m = left[s];  // the columns c with (c & j) == 0
    const unsigned y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~m) | ((y & ~m) >> j)) : ((x & m) | ((y & m) << j));
  }
  return x;
}

// Warp 0: the kept candidates of tile t from its diagonal block (the stage's
// first word column) and the bits earlier tiles removed; writes their keep
// bytes and returns the kept word.
__device__ __forceinline__ u64 resolve_tile(const u64* diag, u64 removed, int t, int k,
                                            bool* keep, int lane) {
  const u64 d0 = diag[lane], d1 = diag[lane + 32];  // rows lane and lane + 32
  const unsigned c0 = transpose32((unsigned)d0, lane);           // column lane, rows 0-31
  const unsigned c1lo = transpose32((unsigned)(d0 >> 32), lane);  // column lane + 32, rows 0-31
  const unsigned c1hi = transpose32((unsigned)(d1 >> 32), lane);  // column lane + 32, rows 32-63
  const int valid = min(64, k - 64 * t);
  const u64 live = (valid == 64 ? ~0ull : (1ull << valid) - 1ull) & ~removed;
  const bool l0 = (live >> lane) & 1ull, l1 = (live >> (lane + 32)) & 1ull;
  u64 kept = live;
  for (;;) {
    const unsigned klo = (unsigned)kept, khi = (unsigned)(kept >> 32);
    const bool s0 = (c0 & klo) != 0u;
    const bool s1 = (c1lo & klo) != 0u || (c1hi & khi) != 0u;
    const u64 next = (u64)__ballot_sync(kFull, l0 && !s0) |
                     ((u64)__ballot_sync(kFull, l1 && !s1) << 32);
    if (next == kept) break;
    kept = next;
  }
  const int j = 64 * t + lane;
  if (j < k) keep[j] = (kept >> lane) & 1ull;
  if (j + 32 < k) keep[j + 32] = (kept >> (lane + 32)) & 1ull;
  return kept;
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const u64* __restrict__ mask, u64* __restrict__ removed_scratch,
                     bool* __restrict__ keep, int r, int k, int words, int cw,
                     int removed_shared) {
  extern __shared__ u64 smem[];  // two stages of cw * 64 words, then removed when shared
  __shared__ u64 s_kept;
  u64* buf[2] = {smem, smem + cw * 64};
  u64* removed = removed_shared ? smem + 2 * cw * 64
                                : removed_scratch + (long long)blockIdx.x * words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = blockIdx.x; row < r; row += gridDim.x) {
    const u64* m = mask + (long long)row * words * words * 64;
    bool* out = keep + (long long)row * k;
    for (int w = threadIdx.x; w < words; w += kSweepThreads) removed[w] = 0ull;
    // stage (t, w0): words w0 .. min(w0 + cw, words) - 1 of tile t
    int t = 0, w0 = 0, s = 0;
    load_stage(m, words, 0, 0, min(cw, words), buf[0]);
    cp_async_commit();
    while (t < words) {
      const int w1 = min(w0 + cw, words);
      int nt = t, nw0 = w1;
      if (nw0 >= words) nw0 = ++nt;
      cp_async_wait_all();
      __syncthreads();  // stage s landed; the last stage's readers are done with the other buffer
      const u64* cur = buf[s & 1];
      if (nt < words) load_stage(m, words, nt, nw0, min(nw0 + cw, words), buf[(s + 1) & 1]);
      cp_async_commit();
      if (w0 == t) {
        if (warp == 0) {
          const u64 kept = resolve_tile(cur, removed[t], t, k, out, lane);
          if (lane == 0) s_kept = kept;
        }
        __syncthreads();  // the tile's kept word published
      }
      const u64 kept = s_kept;
      if (kept != 0ull) {
        for (int w = max(w0, t + 1) + warp; w < w1; w += kSweepWarps) {
          const u64* col = cur + (w - w0) * 64;
          const u64 v = (((kept >> lane) & 1ull) ? col[lane] : 0ull) |
                        (((kept >> (lane + 32)) & 1ull) ? col[lane + 32] : 0ull);
          const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
          const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
          if (lane == 0) removed[w] |= (u64)lo | ((u64)hi << 32);
        }
      }
      t = nt;
      w0 = nw0;
      ++s;
    }
    __syncthreads();  // the row's last reads end before the next row's copies and zeroing
  }
}

}  // namespace

// suppress: bool [r, k, k]; scratch: u64, r * W * W * 64 packed words then
// min(r, 65535) * W for `removed` where shared memory leaves no room (W =
// ceil(k / 64)); keep: bool [r, k]; smem_budget: the shared bytes a sweep
// block may take (the card's 232,448; tests lower it to force column chunks
// and `removed` in the scratch).
extern "C" int ssd3d_nms_keep(const bool* suppress, unsigned long long* scratch, bool* keep, int r,
                              int k, int smem_budget, cudaStream_t stream) {
  if (r < 0 || k < 0 || smem_budget <= 0) return (int)cudaErrorInvalidValue;
  if (r == 0 || k == 0) return (int)cudaSuccess;
  const int words = (k + 63) / 64;
  const size_t budget = smem_budget < kSmemMax ? (size_t)smem_budget : (size_t)kSmemMax;
  const size_t removed_bytes = (size_t)words * sizeof(u64);
  const size_t column = 2 * 64 * sizeof(u64);  // a word column in both stages
  const bool removed_shared = removed_bytes + column <= budget;
  const size_t room = removed_shared ? budget - removed_bytes : budget;
  const size_t fit = room / column;
  const int cw = fit < (size_t)(words < kChunkMax ? words : kChunkMax) ? (int)fit
                                                                    : (words < kChunkMax ? words : kChunkMax);
  if (cw < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cw * column + (removed_shared ? removed_bytes : 0);
  const long long packed = (long long)r * words * words * 64;
  const long long blocks = ((long long)r * k + kPackThreads / 32 - 1) / (kPackThreads / 32);
  nms_pack_kernel<<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kPackThreads, 0, stream>>>(
      suppress, scratch, r, k, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<r < kGridMax ? r : kGridMax, kSweepThreads, smem, stream>>>(
      scratch, scratch + packed, keep, r, k, words, cw, removed_shared ? 1 : 0);
  return (int)cudaGetLastError();
}

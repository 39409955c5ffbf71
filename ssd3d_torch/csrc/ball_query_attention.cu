// K9: the attention-ordered ball query.
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (ssd3d/ops/grouping.py:393 ball_query_attention, a fixed-shape program with
// a 32-step fori_loop bisection). The port's plain version sized its buffers
// from the widest ball, one host read a chunk of queries; this kernel is its
// counterpart on the card, fixed-shape and free of host reads, so attention
// configs run without a sync and export.
//
// Contract: xyz f32 [b, n, 3], new_xyz f32 [b, q, 3], key i32 [b, q, n] (the
// signed order key of the feature distance, larger = visited first), r2, ns
// -> idx i32 [b, q, ns], cnt i32 [b, q]. Of the points with
// ((dx*dx + dy*dy) + dz*dz) < r2 (dx = query - point, each operation rounded
// as written: -fmad=false and the _rn intrinsics), the ns with the largest
// key, a tie at the threshold going to the lowest index: first those above
// the threshold in index order, then the threshold's ties in index order;
// slots past cnt = min(total, ns) repeat the in-radius point with the largest
// key (lowest index on ties); an empty ball gives all 0. This is the plain
// version's arithmetic step for step, so the outputs are equal bit for bit.
//
// What bounds it on the H100: the in-radius test over every (query, point)
// pair (3 sub, 3 mul, 2 add, 1 compare: f32 instructions that are not FFMAs);
// the bytes are the keys of in-radius points (a point outside the radius needs
// no key), the clouds and the outputs.
//
// Design: one block of 256 threads a query.
// - compaction: tiles of 1,024 points, four a thread; ballots and one warp
//   scan over the tile's 32 (round, warp) counts give each in-radius point its
//   position in index order; its unsigned key (the signed key with the sign bit
//   flipped, which keeps the order) and index go to shared memory. One barrier
//   a tile (the counts are double-buffered).
// - a ball of more than `cap` members (at most kCapMax, the shared-memory
//   tier) is not kept: every later pass streams the cloud again, repeating
//   the in-radius test and reading the members' keys from device memory. No
//   size of ball or cloud is refused.
// - threshold: balls with fewer than ns members take T = 0 (the bisection
//   would find no higher threshold); else the 32-step bisection of the plain
//   version, a block-wide count a step: the largest unsigned T with
//   count(key >= T) >= ns.
// - one pass reduces count(key > T) and the (largest key, lowest index) pair;
//   one ordered pass (ballots and a warp scan again) writes the members above
//   T to slots 0.. and the ties to slots count(key > T).. while below ns; the
//   pad fills the rest.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // points a thread a compaction tile
constexpr int kCapMax = 4096;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxBlocks = 1 << 20;

struct Ball {
  const float* pts;   // this query's cloud [n, 3]
  const int* key;     // this query's keys [n]
  float qx, qy, qz, r2;
  const unsigned* s_key;
  const int* s_idx;
  bool stream;
};

__device__ __forceinline__ bool in_radius(const Ball& ball, int p) {
  const float dx = __fsub_rn(ball.qx, ball.pts[3 * p]);
  const float dy = __fsub_rn(ball.qy, ball.pts[3 * p + 1]);
  const float dz = __fsub_rn(ball.qz, ball.pts[3 * p + 2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return d2 < ball.r2;
}

__device__ __forceinline__ unsigned ukey(int key) { return (unsigned)key ^ 0x80000000u; }

// Member at position p of the ball's walk (p < len): the compacted entry p
// (always a member), or, streaming, point p if it is in the radius.
__device__ __forceinline__ bool member(const Ball& ball, int p, unsigned& k, int& i) {
  if (!ball.stream) {
    k = ball.s_key[p];
    i = ball.s_idx[p];
    return true;
  }
  if (!in_radius(ball, p)) return false;
  k = ukey(ball.key[p]);
  i = p;
  return true;
}

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(kFull, v); }

// Inclusive scan over segments of `width` lanes.
__device__ __forceinline__ int warp_scan(int v, int width) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < width; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d, width);
    if ((lane & (width - 1)) >= d) v += o;
  }
  return v;
}

// Sum over the block, one barrier: slots s[ph][warp], ph flipped every call
// (a slot is written again only after a later barrier all threads passed).
__device__ __forceinline__ int block_sum(int v, int (*s)[32], int& ph) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s[ph][threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s[ph][w];
  ph ^= 1;
  return t;
}

__global__ void __launch_bounds__(kThreads)
    ball_query_attention_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                                const int* __restrict__ key, int* __restrict__ idx,
                                int* __restrict__ cnt, int b, int n, int q, float r2, int ns,
                                int cap) {
  __shared__ unsigned s_key[kCapMax];
  __shared__ int s_idx[kCapMax];
  __shared__ int s_cnt[2][32];
  __shared__ unsigned long long s_best[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int ph = 0;
  const long long rows = (long long)b * q;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    Ball ball;
    ball.pts = xyz + (row / q) * n * 3;
    ball.key = key + row * n;
    ball.qx = new_xyz[3 * row];
    ball.qy = new_xyz[3 * row + 1];
    ball.qz = new_xyz[3 * row + 2];
    ball.r2 = r2;
    ball.s_key = s_key;
    ball.s_idx = s_idx;
    ball.stream = false;
    int* out = idx + row * ns;

    // compaction, in index order
    int total = 0;
    for (int p0 = 0; p0 < n; p0 += kThreads * kRounds) {
      bool in[kRounds];
      unsigned bal[kRounds];
#pragma unroll
      for (int s = 0; s < kRounds; ++s) {
        const int p = p0 + s * kThreads + threadIdx.x;
        in[s] = p < n && in_radius(ball, p);
        bal[s] = __ballot_sync(kFull, in[s]);
        if (lane == 0) s_cnt[ph][s * kWarps + warp] = __popc(bal[s]);
      }
      __syncthreads();
      const int c = s_cnt[ph][lane];  // entry e = round * kWarps + warp
      const int incl = warp_scan(c, 32);
      const int excl = incl - c;
      const int tile = __shfl_sync(kFull, incl, 31);
#pragma unroll
      for (int s = 0; s < kRounds; ++s) {
        const int before = __shfl_sync(kFull, excl, s * kWarps + warp);
        const int pos = total + before + __popc(bal[s] & lt);
        if (in[s] && pos < cap) {
          const int p = p0 + s * kThreads + threadIdx.x;
          s_key[pos] = ukey(ball.key[p]);
          s_idx[pos] = p;
        }
      }
      total += tile;
      ph ^= 1;
    }
    const int count = min(total, ns);
    if (threadIdx.x == 0) cnt[row] = count;
    if (total == 0) {
      for (int s = threadIdx.x; s < ns; s += kThreads) out[s] = 0;
      continue;  // no shared entry was written; the next row's barriers order the rest
    }
    ball.stream = total > cap;
    const int len = ball.stream ? n : total;
    __syncthreads();  // the compacted entries are visible

    // threshold: the largest T with count(key >= T) >= ns; 0 below ns members
    unsigned t = 0u;
    if (total >= ns) {
      for (int bit = 31; bit >= 0; --bit) {
        const unsigned cand = t | (1u << bit);
        int c = 0;
        for (int p = threadIdx.x; p < len; p += kThreads) {
          unsigned k;
          int i;
          if (member(ball, p, k, i) && k >= cand) ++c;
        }
        if (block_sum(c, s_cnt, ph) >= ns) t = cand;
      }
    }

    // count(key > T), and the first-visited member: the largest key, lowest index
    int above = 0;
    unsigned long long best = 0ull;
    for (int p = threadIdx.x; p < len; p += kThreads) {
      unsigned k;
      int i;
      if (member(ball, p, k, i)) {
        above += k > t;
        const unsigned long long v = ((unsigned long long)k << 32) | (0xffffffffu - (unsigned)i);
        best = v > best ? v : best;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, best, off);
      best = o > best ? o : best;
    }
    if (lane == 0) s_best[ph][warp] = best;
    const int cg = block_sum(above, s_cnt, ph);  // its barrier publishes s_best too
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned long long o = s_best[ph ^ 1][w];
      best = o > best ? o : best;
    }
    const int first = (int)(0xffffffffu - (unsigned)(best & 0xffffffffull));

    // ordered selection: above T to slots 0.., ties to slots cg.., below ns
    int run_gt = 0, run_eq = 0;
    for (int p0 = 0; p0 < len && (run_gt < cg || cg + run_eq < ns); p0 += kThreads) {
      const int p = p0 + threadIdx.x;
      unsigned k = 0u;
      int i = 0;
      const bool m = p < len && member(ball, p, k, i);
      const bool gt = m && k > t, eq = m && k == t;
      const unsigned bgt = __ballot_sync(kFull, gt), beq = __ballot_sync(kFull, eq);
      if (lane == 0) {
        s_cnt[ph][warp] = __popc(bgt);
        s_cnt[ph][kWarps + warp] = __popc(beq);
      }
      __syncthreads();
      const int c = lane < 2 * kWarps ? s_cnt[ph][lane] : 0;
      const int incl = warp_scan(c, kWarps);  // lanes 0-7: above; 8-15: ties
      const int excl = incl - c;
      const int before_gt = __shfl_sync(kFull, excl, warp);
      const int before_eq = __shfl_sync(kFull, excl, kWarps + warp);
      const int tile_gt = __shfl_sync(kFull, incl, kWarps - 1);
      const int tile_eq = __shfl_sync(kFull, incl, 2 * kWarps - 1);
      if (gt) {
        const int slot = run_gt + before_gt + __popc(bgt & lt);
        if (slot < ns) out[slot] = i;
      } else if (eq) {
        const int slot = cg + run_eq + before_eq + __popc(beq & lt);
        if (slot < ns) out[slot] = i;
      }
      run_gt += tile_gt;
      run_eq += tile_eq;
      ph ^= 1;
    }
    for (int s = count + threadIdx.x; s < ns; s += kThreads) out[s] = first;
    __syncthreads();  // the shared entries are read before the next row writes them
  }
}

}  // namespace

// xyz f32 [b, n, 3]; new_xyz f32 [b, q, 3]; key i32 [b, q, n]; idx i32
// [b, q, ns]; cnt i32 [b, q]; cap: balls of more members stream the cloud.
extern "C" int ssd3d_ball_query_attention(const float* xyz, const float* new_xyz, const int* key,
                                          int* idx, int* cnt, int b, int n, int q, float r2,
                                          int ns, int cap, cudaStream_t stream) {
  if (b < 0 || n <= 0 || q < 0 || ns <= 0 || cap < 0 || cap > kCapMax)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * q;
  if (rows == 0) return (int)cudaSuccess;
  const int grid = (int)(rows < kMaxBlocks ? rows : kMaxBlocks);
  ball_query_attention_kernel<<<grid, kThreads, 0, stream>>>(xyz, new_xyz, key, idx, cnt, b, n, q,
                                                             r2, ns, cap);
  return (int)cudaGetLastError();
}

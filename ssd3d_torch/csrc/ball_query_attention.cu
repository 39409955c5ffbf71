// K9: the attention-ordered ball query.
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (ssd3d/ops/grouping.py:393 ball_query_attention, a fixed-shape program with
// a 32-step fori_loop bisection over the order keys of a [chunk, n] feature
// distance matrix). This kernel is its counterpart on the card, fixed-shape
// and free of host reads, so attention configs run without a sync and export;
// it computes the keys itself, for the members of each ball only, so no
// [b, q, n] buffer exists on the card.
//
// What bounds it on the H100: the in-radius test of every (query, point)
// pair (3 sub, 3 mul, 2 add, 1 compare: f32 instructions that are not FFMAs)
// and each member's key (cf mul, cf - 1 add, 2 add, 1 mul and the order
// key); the bytes are each member's feature row, the clouds, the norms, the
// query features and the outputs.
//
// Contract: xyz f32 [b, n, 3], new_xyz f32 [b, q, 3], feats [b, n, cf] and
// new_feats [b, q, cf] (f32 or bf16), a_sq f32 [b, q] and b_sq f32 [b, n]
// (the squared norms, summed as square_distance sums them), r2, ns -> idx
// i32 [b, q, ns], cnt i32 [b, q]. A point is in the ball when
// ((dx*dx + dy*dy) + dz*dz) < r2 (dx = query - point). The key of an
// in-radius point is the order key of d = (a_sq + b_sq) - 2 * cross, cross
// the f32 dot of the two feature rows summed in channel order (bf16 widened
// exactly), every operation rounded as written (-fmad=false and the _rn
// intrinsics). Of the members, the ns with the largest key, a tie at the
// threshold going to the lowest index: first those above the threshold in
// index order, then the threshold's ties in index order; slots past cnt =
// min(total, ns) repeat the member with the largest key (lowest index on
// ties); an empty ball gives all 0. This is the plain version's arithmetic
// step for step, so the outputs are equal bit for bit.
//
// Design: two kernels, launched together by one call.
// - the query tile (every ball first): a block of 8 warps takes 32 queries
//   of one cloud, 4 a warp, and walks the cloud in tiles of 512 points staged
//   in shared memory (4-byte cp.async, two buffers: tile i+1 lands while tile
//   i is tested), so a point is read from L2 once a query tile, not once a
//   query. A warp tests 32 points against its 4 queries held in registers and
//   compacts each query's members in index order (a ballot and a popc a
//   query) into shared memory, up to `tile_cap` (at most 128) a query. Then
//   a warp a query, with no block barrier: the members' keys (their feature
//   rows read, nobody else's); T = 0 for a ball of fewer than ns members
//   (the bisection would find no higher threshold), else the 32-step
//   bisection of the plain version with warp sums; count(key > T) and the
//   (largest key, lowest index) member; the ordered selection (ballots again)
//   and the pad. A ball of more than `tile_cap` members is appended to a
//   list in device memory (an atomic count) and left to the second kernel.
// - the ball list: one block of 256 threads a listed ball, the grid reading
//   the list's length on the card (no host read). Compaction in tiles of
//   1,024 points with ballots and a warp scan; each member's key computed as
//   it is compacted, up to `smem_cap` (at most kCapMax, 4,096) in shared
//   memory; a larger ball streams its cloud again in every later pass,
//   repeating the in-radius test and recomputing its members' keys. The
//   threshold bisection and the selection are block-wide. No size of ball or
//   cloud is refused.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the query tile
constexpr int kTileWarps = 8;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kQueriesPerWarp = 4;
constexpr int kTileQueries = kTileWarps * kQueriesPerWarp;
constexpr int kTilePoints = 512;
constexpr int kTileCapMax = 128;

// the ball list
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // points a thread a compaction tile
constexpr int kCapMax = 4096;
constexpr int kListBlocks = 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The unsigned order key of a member: d = (a_sq + b_sq) - 2 * cross, cross
// summed in channel order from 0, its signed order key (the sign-flip
// transform) with the sign bit flipped, which keeps the order unsigned.
template <typename T>
__device__ __forceinline__ unsigned member_key(const T* __restrict__ f, const T* __restrict__ nf,
                                               int cf, float a_sq, float b_sq) {
  float cross = 0.0f;
  for (int c = 0; c < cf; ++c) cross = __fadd_rn(cross, __fmul_rn(widen(nf[c]), widen(f[c])));
  const float d = __fsub_rn(__fadd_rn(a_sq, b_sq), __fmul_rn(2.0f, cross));
  const int bits = __float_as_int(d);
  return (unsigned)(bits < 0 ? bits ^ 0x7fffffff : bits) ^ 0x80000000u;
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float px, float py,
                                       float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// ------------------------------------------------------------ the query tile

__device__ __forceinline__ void load_points(const float* pts, int n, int tile, float* dst) {
  const int p0 = tile * kTilePoints;
  const int len = 3 * min(kTilePoints, n - p0);
  for (int i = threadIdx.x; i < len; i += kTileThreads) cp_async4(dst + i, pts + 3 * p0 + i);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    attention_tile_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                          const T* __restrict__ feats, const T* __restrict__ new_feats,
                          const float* __restrict__ a_sq, const float* __restrict__ b_sq,
                          int* __restrict__ idx, int* __restrict__ cnt, int* __restrict__ list,
                          int n, int q, int cf, float r2, int ns, int tile_cap) {
  __shared__ float s_pts[2][3 * kTilePoints];
  __shared__ int s_idx[kTileQueries][kTileCapMax];
  __shared__ unsigned s_key[kTileQueries][kTileCapMax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int tiles_q = (q + kTileQueries - 1) / kTileQueries;
  const long long cloud = blockIdx.x / tiles_q;
  const int q0 = (blockIdx.x % tiles_q) * kTileQueries + warp * kQueriesPerWarp;
  const float* pts = xyz + cloud * n * 3;
  const float nan = __int_as_float(0x7fffffff);  // compares false: never in a ball
  float qx[kQueriesPerWarp], qy[kQueriesPerWarp], qz[kQueriesPerWarp];
  int total[kQueriesPerWarp];
#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    const bool ok = q0 + j < q;
    const float* c = new_xyz + (cloud * q + q0 + j) * 3;
    qx[j] = ok ? c[0] : nan;
    qy[j] = ok ? c[1] : nan;
    qz[j] = ok ? c[2] : nan;
    total[j] = 0;
  }

  // the in-radius test and the compaction, in index order
  const int tiles_p = (n + kTilePoints - 1) / kTilePoints;
  load_points(pts, n, 0, s_pts[0]);
  cp_async_commit();
  for (int tile = 0; tile < tiles_p; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // tile landed; every warp is done with the other buffer
    if (tile + 1 < tiles_p) load_points(pts, n, tile + 1, s_pts[(tile + 1) & 1]);
    cp_async_commit();
    const float* sp = s_pts[tile & 1];
    const int p0 = tile * kTilePoints, len = min(kTilePoints, n - p0);
    for (int c0 = 0; c0 < len; c0 += 32) {
      const int pl = c0 + lane;
      const bool ok = pl < len;
      const float px = ok ? sp[3 * pl] : nan, py = ok ? sp[3 * pl + 1] : nan,
                  pz = ok ? sp[3 * pl + 2] : nan;
#pragma unroll
      for (int j = 0; j < kQueriesPerWarp; ++j) {
        const bool in = dist2(qx[j], qy[j], qz[j], px, py, pz) < r2;
        const unsigned bal = __ballot_sync(kFull, in);
        if (bal) {
          const int pos = total[j] + __popc(bal & lt);
          if (in && pos < tile_cap) s_idx[warp * kQueriesPerWarp + j][pos] = p0 + pl;
          total[j] += __popc(bal);
        }
      }
    }
  }
  __syncwarp();  // the warp's compacted entries are visible to its lanes

  // a warp a query: keys, threshold, selection
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    if (q0 + j >= q) break;
    const long long row = cloud * q + q0 + j;
    const int tot = total[j];
    int* out = idx + row * ns;
    if (lane == 0) cnt[row] = min(tot, ns);
    if (tot == 0) {
      for (int s = lane; s < ns; s += 32) out[s] = 0;
      continue;
    }
    if (tot > tile_cap) {  // the ball list takes it
      if (lane == 0) list[1 + atomicAdd(list, 1)] = (int)row;
      continue;
    }
    const int* sidx = s_idx[warp * kQueriesPerWarp + j];
    unsigned* skey = s_key[warp * kQueriesPerWarp + j];
    const T* fc = feats + cloud * n * cf;
    const float* bc = b_sq + cloud * n;
    const float aq = a_sq[row];
    for (int m = lane; m < tot; m += 32) {
      const int p = sidx[m];
      skey[m] = member_key(fc + (long long)p * cf, new_feats + row * cf, cf, aq, bc[p]);
    }
    __syncwarp();
    unsigned t = 0u;  // the largest T with count(key >= T) >= ns; 0 below ns members
    if (tot >= ns) {
      for (int bit = 31; bit >= 0; --bit) {
        const unsigned cand = t | (1u << bit);
        int c = 0;
        for (int m = lane; m < tot; m += 32) c += skey[m] >= cand;
        if ((int)__reduce_add_sync(kFull, c) >= ns) t = cand;
      }
    }
    int above = 0;
    unsigned long long best = 0ull;
    for (int m = lane; m < tot; m += 32) {
      const unsigned k = skey[m];
      above += k > t;
      const unsigned long long v = ((unsigned long long)k << 32) | (0xffffffffu - (unsigned)sidx[m]);
      best = v > best ? v : best;
    }
    above = (int)__reduce_add_sync(kFull, above);
    const int first = (int)(0xffffffffu - (unsigned)(warp_max(best) & 0xffffffffull));
    int run_gt = 0, run_eq = 0;
    for (int m0 = 0; m0 < tot && (run_gt < above || above + run_eq < ns); m0 += 32) {
      const int m = m0 + lane;
      const unsigned k = m < tot ? skey[m] : 0u;
      const bool gt = m < tot && k > t, eq = m < tot && k == t;
      const unsigned bgt = __ballot_sync(kFull, gt), beq = __ballot_sync(kFull, eq);
      if (gt) {
        const int slot = run_gt + __popc(bgt & lt);
        if (slot < ns) out[slot] = sidx[m];
      } else if (eq) {
        const int slot = above + run_eq + __popc(beq & lt);
        if (slot < ns) out[slot] = sidx[m];
      }
      run_gt += __popc(bgt);
      run_eq += __popc(beq);
    }
    for (int s = min(tot, ns) + lane; s < ns; s += 32) out[s] = first;
  }
}

// -------------------------------------------------------------- the ball list

template <typename T>
struct Ball {
  const float* pts;  // this query's cloud [n, 3]
  const T* f;        // its features [n, cf]
  const T* nf;       // the query's features [cf]
  const float* b_sq;
  float a_sq;
  int cf;
  float qx, qy, qz, r2;
  const unsigned* s_key;
  const int* s_idx;
  bool stream;

  __device__ __forceinline__ bool in_radius(int p) const {
    return dist2(qx, qy, qz, pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]) < r2;
  }
  __device__ __forceinline__ unsigned key(int p) const {
    return member_key(f + (long long)p * cf, nf, cf, a_sq, b_sq[p]);
  }
  // Member at position p of the ball's walk (p < len): the compacted entry p
  // (always a member), or, streaming, point p if it is in the radius.
  __device__ __forceinline__ bool member(int p, unsigned& k, int& i) const {
    if (!stream) {
      k = s_key[p];
      i = s_idx[p];
      return true;
    }
    if (!in_radius(p)) return false;
    k = key(p);
    i = p;
    return true;
  }
};

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
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) s[ph][threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s[ph][w];
  ph ^= 1;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_list_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                          const T* __restrict__ feats, const T* __restrict__ new_feats,
                          const float* __restrict__ a_sq, const float* __restrict__ b_sq,
                          int* __restrict__ idx, int* __restrict__ cnt,
                          const int* __restrict__ list, int n, int q, int cf, float r2, int ns,
                          int cap) {
  __shared__ unsigned s_key[kCapMax];
  __shared__ int s_idx[kCapMax];
  __shared__ int s_cnt[2][32];
  __shared__ unsigned long long s_best[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int ph = 0;
  const int listed = list[0];
  for (int e = blockIdx.x; e < listed; e += gridDim.x) {
    const long long row = list[1 + e];
    const long long cloud = row / q;
    Ball<T> ball;
    ball.pts = xyz + cloud * n * 3;
    ball.f = feats + cloud * n * cf;
    ball.nf = new_feats + row * cf;
    ball.b_sq = b_sq + cloud * n;
    ball.a_sq = a_sq[row];
    ball.cf = cf;
    ball.qx = new_xyz[3 * row];
    ball.qy = new_xyz[3 * row + 1];
    ball.qz = new_xyz[3 * row + 2];
    ball.r2 = r2;
    ball.s_key = s_key;
    ball.s_idx = s_idx;
    ball.stream = false;
    int* out = idx + row * ns;

    // compaction, in index order, each member's key computed as it is kept
    int total = 0;
    for (int p0 = 0; p0 < n; p0 += kThreads * kRounds) {
      bool in[kRounds];
      unsigned bal[kRounds];
#pragma unroll
      for (int s = 0; s < kRounds; ++s) {
        const int p = p0 + s * kThreads + threadIdx.x;
        in[s] = p < n && ball.in_radius(p);
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
          s_key[pos] = ball.key(p);
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
      continue;  // no shared entry was written; the next ball's barriers order the rest
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
          if (ball.member(p, k, i) && k >= cand) ++c;
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
      if (ball.member(p, k, i)) {
        above += k > t;
        const unsigned long long v = ((unsigned long long)k << 32) | (0xffffffffu - (unsigned)i);
        best = v > best ? v : best;
      }
    }
    best = warp_max(best);
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
      const bool m = p < len && ball.member(p, k, i);
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
    __syncthreads();  // the shared entries are read before the next ball writes them
  }
}

template <typename T>
cudaError_t launch(const float* xyz, const float* new_xyz, const void* feats,
                   const void* new_feats, const float* a_sq, const float* b_sq, int* idx,
                   int* cnt, int* list, int b, int n, int q, int cf, float r2, int ns,
                   int tile_cap, int smem_cap, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(list, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)b * ((q + kTileQueries - 1) / kTileQueries);
  attention_tile_kernel<T><<<(unsigned)tiles, kTileThreads, 0, stream>>>(
      xyz, new_xyz, static_cast<const T*>(feats), static_cast<const T*>(new_feats), a_sq, b_sq,
      idx, cnt, list, n, q, cf, r2, ns, tile_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)b * q;
  attention_list_kernel<T><<<(int)(rows < kListBlocks ? rows : kListBlocks), kThreads, 0, stream>>>(
      xyz, new_xyz, static_cast<const T*>(feats), static_cast<const T*>(new_feats), a_sq, b_sq,
      idx, cnt, list, n, q, cf, r2, ns, smem_cap);
  return cudaGetLastError();
}

}  // namespace

// xyz f32 [b, n, 3]; new_xyz f32 [b, q, 3]; feats [b, n, cf], new_feats
// [b, q, cf], f32 or (bf16 != 0) bf16; a_sq f32 [b, q]; b_sq f32 [b, n];
// idx i32 [b, q, ns]; cnt i32 [b, q]; list i32 [1 + b * q] scratch (the
// count of listed balls, then their rows); tile_cap: balls of more members
// go to the ball list; smem_cap: listed balls of more members stream the
// cloud.
extern "C" int ssd3d_ball_query_attention(const float* xyz, const float* new_xyz,
                                          const void* feats, const void* new_feats,
                                          const float* a_sq, const float* b_sq, int* idx,
                                          int* cnt, int* list, int b, int n, int q, int cf,
                                          int bf16, float r2, int ns, int tile_cap, int smem_cap,
                                          cudaStream_t stream) {
  if (b < 0 || n <= 0 || q < 0 || cf < 0 || ns <= 0 || tile_cap < 0 || tile_cap > kTileCapMax ||
      smem_cap < 0 || smem_cap > kCapMax || (long long)b * q >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)b * q == 0) return (int)cudaSuccess;
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(xyz, new_xyz, feats, new_feats, a_sq, b_sq, idx, cnt, list, b,
                                   n, q, cf, r2, ns, tile_cap, smem_cap, stream)
           : launch<float>(xyz, new_xyz, feats, new_feats, a_sq, b_sq, idx, cnt, list, b, n, q,
                           cf, r2, ns, tile_cap, smem_cap, stream);
  return (int)err;
}

// K2m: F-FPS over a given [b, n, n] squared-distance matrix, for Hopper.
//
// Replaces the matrix entries of the TPU's F-FPS: ssd3d/ops/pallas/fps.py
// ffps_pallas (the `_ffps_kernel` pallas_call over a VMEM-resident matrix)
// and ffps_pallas_hbm (`_ffps_hbm_kernel`, streaming the picked row from
// HBM), which serve ssd3d/ops/sampling.py farthest_point_sample_from_dist.
// Contract: pick 0 is index 0; each point keeps the running minimum of the
// rows of the picked points (row p is dist[p][:], read as given, so the
// matrix need not be symmetric), starting at +inf; the next pick is the
// argmax, ties to the lowest index. A NaN wins, at its lowest index, as
// torch.argmax lets it, and the running minimum keeps a NaN, as
// torch.minimum does; -0 equals +0.
//
// What bounds it on the H100: a pick reads one row of n floats, so the
// bytes are b * npoint * n * 4 (at [8, 4096, 4096] -> 512, 67 MB: 20 us at
// 3.35 TB/s). But the picks are serial and each row is the argmax of the
// last pick, so the kernel waits, a pick, on one dependent row read (from
// HBM where the matrix is larger than L2) and one argmax over the cloud,
// about 1-2 us, not on bandwidth.
//
// Two routes, chosen by the wrapper (ops/sampling.py `ffps_dist_route`):
//
// - Cluster route: one cloud over a thread-block cluster of 2 to 16 CTAs,
//   one CTA an SM. CTA r owns a contiguous slice of the columns; its thread
//   t owns the slice's points t + k * threads, reads their entries of the
//   picked row coalesced and keeps their running minima in registers, PPT a
//   thread (up to 16 of 1,024 threads: 262,144 points over 16 CTAs, more
//   than a matrix the card holds). The row's slices are read on up to 16
//   SMs at once. The argmax is K1's key exchange (csrc/cluster.cuh): a key
//   in every CTA's slot, sent with st.async and counted on that CTA's
//   mbarrier of the pick's parity, no cluster barrier inside the loop. The
//   key is this file's own (`make_key`: order-preserving bits of any float,
//   NaN on top, -0 as +0), not `fps_key`, which takes d >= 0 only. Two
//   exchanges:
//   * "warps", K1's: every warp sends its key to every CTA (csize x warps
//     slots a pick), and every warp reduces them all;
//   * "prefetch": the warps' keys are reduced within the CTA first (one
//     named barrier that only warp 0 waits on), then warp 0 sends the CTA's
//     best key, csize slots a pick, and prefetches its winner's whole row
//     into L2, one prefetch.global.L2 a 128-byte line over its lanes. The
//     global winner is one of the CTAs' own winners, so the winning row is
//     on its way while the exchange settles, and the dependent read of it
//     finds it in L2 (or in flight) instead of going to HBM. The cost is up
//     to csize rows read from HBM a pick instead of one. (The CTA's key
//     without the prefetch, a bulk cp.async.bulk.prefetch.L2 of the row, and
//     a prefetch every 32 bytes were slower, PERF.md §6.)
//   The wrapper takes "prefetch" for rows of 2,048 points or more, whose
//   read from HBM outlasts the CTA's reduction and the prefetch, and
//   "warps" for shorter rows (`ffps_dist_exchange`), and the largest
//   cluster size at which all b clusters are resident at once
//   (cudaOccupancyMaxActiveClusters, `ffps_dist_cluster_size`).
// - Block route (the first design), where no cluster size fits (more
//   clouds than the card holds clusters of 2): one block of 1,024 threads a cloud;
//   thread t owns the points t + k * 1024, reads their entries of the row
//   coalesced and keeps their running minima in registers, PPT of them (up
//   to 16: n <= 16,384, the "registers" tier), or, past that, in a scratch
//   buffer [b, n] in global memory that only the owner reads and writes (the
//   "global" tier, any n). The argmax: a warp reduces with shuffles, lane 0
//   writes its warp's key into a slot of this pick's parity, one
//   __syncthreads, then every warp reduces the 32 slots itself. Slots are
//   double-buffered by parity: a warp writes pick s + 2's slot only after
//   the barrier of pick s + 1, which every warp reaches after reading pick
//   s's slots.
#include <cstdint>

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;
using namespace ssd3d;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// the distance's bits, ordered as unsigned integers for every float: -0 is
// +0 (they compare equal), a NaN is above +inf
__device__ __forceinline__ unsigned ordered_bits(float d) {
  if (d != d) return 0xFFFFFFFFu;
  const unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (d, j) -> a key above 0 for every float d: one unsigned max picks the
// largest d and, on a tie, the lowest j
__device__ __forceinline__ unsigned long long make_key(float d, int j) {
  return ((unsigned long long)ordered_bits(d) << 32) | (0xFFFFFFFFu - (unsigned)j);
}

// torch.minimum: a NaN on either side stays
__device__ __forceinline__ float nan_min(float m, float r) {
  return (r < m || r != r) ? r : m;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o > k ? o : k;
  }
  return k;
}

// ----------------------------------------------------------- block route

// PPT > 0: the running minima in registers, PPT a thread; PPT == 0: in
// scratch [b, n]
template <int PPT>
__global__ void __launch_bounds__(kThreads)
    ffps_dist_kernel(const float* __restrict__ dist, int n, int m, float* __restrict__ scratch,
                     int* __restrict__ out) {
  __shared__ unsigned long long slots[2][kWarps];
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* mat = dist + (size_t)b * n * n;
  float md[PPT > 0 ? PPT : 1];
  float* sc = PPT == 0 ? scratch + (size_t)b * n : nullptr;
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) md[k] = __int_as_float(0x7f800000);
  } else {
    for (int j = t; j < n; j += kThreads) sc[j] = __int_as_float(0x7f800000);
  }
  if (t == 0) out[(size_t)b * m] = 0;
  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float* row = mat + (size_t)last * n;
    unsigned long long best = 0;  // below every real key
    if constexpr (PPT > 0) {
      float r[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int j = t + k * kThreads;
        r[k] = j < n ? __ldg(row + j) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int j = t + k * kThreads;
        if (j < n) {
          md[k] = nan_min(md[k], r[k]);
          const unsigned long long key = make_key(md[k], j);
          best = key > best ? key : best;
        }
      }
    } else {
      for (int j = t; j < n; j += kThreads) {
        const float v = nan_min(sc[j], __ldg(row + j));
        sc[j] = v;
        const unsigned long long key = make_key(v, j);
        best = key > best ? key : best;
      }
    }
    best = warp_max(best);
    if (lane == 0) slots[s & 1][warp] = best;
    __syncthreads();
    const unsigned long long win = warp_max(slots[s & 1][lane]);
    last = (int)(0xFFFFFFFFu - (unsigned)(win & 0xFFFFFFFFull));
    if (t == 0) out[(size_t)b * m + s] = last;
  }
}

template <int PPT>
cudaError_t launch(const float* dist, int* out, float* scratch, int b, int n, int m,
                   cudaStream_t stream) {
  ffps_dist_kernel<PPT><<<b, kThreads, 0, stream>>>(dist, n, m, scratch, out);
  return cudaGetLastError();
}

cudaError_t launch_block_route(const float* dist, int* out, float* scratch, int b, int n, int m,
                               int ppt, cudaStream_t stream) {
  if (ppt > 0 && (long long)ppt * kThreads < n) return cudaErrorInvalidValue;
  switch (ppt) {
    case 0:
      if (scratch == nullptr) return cudaErrorInvalidValue;
      return launch<0>(dist, out, scratch, b, n, m, stream);
    case 1: return launch<1>(dist, out, scratch, b, n, m, stream);
    case 2: return launch<2>(dist, out, scratch, b, n, m, stream);
    case 4: return launch<4>(dist, out, scratch, b, n, m, stream);
    case 8: return launch<8>(dist, out, scratch, b, n, m, stream);
    case 16: return launch<16>(dist, out, scratch, b, n, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------- cluster route
//
// The plan (points a CTA, threads, points a thread) comes from ops/sampling.py
// `ffps_dist_cluster_plan`; the entry point checks that it covers the cloud.

constexpr int kMaxCluster = 16;
constexpr int kWarpSlots = kMaxCluster * kWarps;  // "warps": one a warp of the cluster
constexpr int kSpreadSmem = 120 * 1024;           // > half an SM: one CTA an SM
constexpr int kLineFloats = 32;                   // an L2 line, 128 bytes

// the exchanges (the entry point's `exchange`): 0 K1's, every warp sends its
// key; 1 the CTA's best key, sent by warp 0, its row prefetched into L2
constexpr int kExchangeWarps = 0;
constexpr int kExchangePrefetch = 1;

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)key);
}

// Warp 0's prefetch of a row of n floats into L2: one prefetch.global.L2 a
// line (every 32 floats from the row's start, so each line the row touches
// once, and the row's last float for its last line), spread over the lanes.
__device__ __forceinline__ void prefetch_row_l2(const float* row, int n, int lane) {
  for (int c = lane * kLineFloats; c < n; c += 32 * kLineFloats) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + c));
  }
  if (lane == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(row + n - 1));
}

// One cloud over one cluster; see the file's header. slice: points a CTA;
// PPT * blockDim.x >= slice. kPrefetch: the "prefetch" exchange, else K1's.
template <int PPT, bool kPrefetch>
__global__ void __launch_bounds__(kThreads)
    ffps_dist_cluster_kernel(const float* __restrict__ dist, int n, int m, int slice,
                             int* __restrict__ out) {
  __shared__ unsigned long long s_key[2][kPrefetch ? kMaxCluster : kWarpSlots];
  __shared__ unsigned long long s_warp[2][kWarps];  // "prefetch": the warps' keys, by parity
  __shared__ __align__(8) unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int nslots = kPrefetch ? csize : csize * nwarps;
  const size_t cloud = blockIdx.x / csize;
  const float* mat = dist + cloud * n * n;
  int* o = out + cloud * m;
  const int first = rank * slice;
  const int count = max(0, min(slice, n - first));
  float md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) md[k] = __int_as_float(0x7f800000);
  if (t == 0) {
    mbar_init(smem_addr(&s_bar[0]), 1);
    mbar_init(smem_addr(&s_bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA's barriers are ready before the first st.async
  cluster.sync();

  // where this warp's (or, "prefetch", this CTA's) key lands in CTA `lane`
  const uint32_t to = lane % csize;
  const int slot = kPrefetch ? rank : rank * nwarps + warp;
  const uint32_t to_slot0 = cluster_addr(smem_addr(&s_key[0][slot]), to);
  const uint32_t to_slot1 = cluster_addr(smem_addr(&s_key[1][slot]), to);
  const uint32_t to_bar0 = cluster_addr(smem_addr(&s_bar[0]), to);
  const uint32_t to_bar1 = cluster_addr(smem_addr(&s_bar[1]), to);
  if (rank == 0 && t == 0) o[0] = 0;

  int last = 0;  // pick 0 is index 0
  for (int s = 1; s < m; ++s) {
    const int par = s & 1;
    // this buffer's previous phase (pick s - 2) has ended: arm it for pick s
    if (t == 0) mbar_expect_tx(smem_addr(&s_bar[par]), nslots * 8);
    const float* row = mat + (size_t)last * n + first;
    float r[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int e = t + k * nthreads;
      r[k] = e < count ? __ldg(row + e) : 0.0f;
    }
    unsigned long long best = 0ull;  // below every real key
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int e = t + k * nthreads;
      if (e < count) {
        md[k] = nan_min(md[k], r[k]);
        const unsigned long long key = make_key(md[k], first + e);
        best = key > best ? key : best;
      }
    }
    best = warp_max_key(best);
    if constexpr (kPrefetch) {
      // warp 0 waits for the other warps' keys (named barrier 1), which go
      // on to wait for the exchange. s_warp[par] is rewritten at pick s + 2,
      // after every CTA's key of pick s + 1, so after warp 0 read it.
      if (lane == 0) s_warp[par][warp] = best;
      if (warp == 0) {
        asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
        unsigned long long cta = lane < nwarps ? s_warp[par][lane] : 0ull;
        cta = warp_max_key(cta);
        if (lane < csize) st_async(par ? to_slot1 : to_slot0, cta, par ? to_bar1 : to_bar0);
        if (cta != 0ull) prefetch_row_l2(mat + (size_t)key_index(cta) * n, n, lane);
      } else {
        asm volatile("bar.arrive 1, %0;" ::"r"(nthreads) : "memory");
      }
    } else {
      if (lane < csize) st_async(par ? to_slot1 : to_slot0, best, par ? to_bar1 : to_bar0);
    }
    mbar_wait(smem_addr(&s_bar[par]), ((s - 1) >> 1) & 1);

    unsigned long long win = 0ull;
    for (int i = lane; i < nslots; i += 32) {
      const unsigned long long key = s_key[par][i];
      win = key > win ? key : win;
    }
    last = key_index(warp_max_key(win));
    if (rank == 0 && t == 0) o[s] = last;
  }
  cluster.sync();  // no CTA exits while a store into it may be in flight
}

using ClusterFn = void (*)(const float*, int, int, int, int*);

// the instantiation for (points a thread, the "prefetch" exchange or K1's),
// or null
ClusterFn cluster_fn(int ppt, bool pf) {
  switch (ppt) {
    case 1: return pf ? ffps_dist_cluster_kernel<1, true> : ffps_dist_cluster_kernel<1, false>;
    case 2: return pf ? ffps_dist_cluster_kernel<2, true> : ffps_dist_cluster_kernel<2, false>;
    case 4: return pf ? ffps_dist_cluster_kernel<4, true> : ffps_dist_cluster_kernel<4, false>;
    case 8: return pf ? ffps_dist_cluster_kernel<8, true> : ffps_dist_cluster_kernel<8, false>;
    case 16: return pf ? ffps_dist_cluster_kernel<16, true> : ffps_dist_cluster_kernel<16, false>;
    default: return nullptr;
  }
}

bool valid_size(int csize) {
  return csize == 2 || csize == 4 || csize == 8 || csize == 16;
}

// the spread's shared memory and cluster sizes of 16 (attributes of the
// current card, so set at every call, as a process may launch on several)
cudaError_t prepare(ClusterFn fn) {
  const void* f = reinterpret_cast<const void*>(fn);
  cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSpreadSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

cudaLaunchConfig_t cluster_config(int b, int csize, int threads, cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kSpreadSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cta(int csize, int threads, int ppt) {
  return valid_size(csize) && threads >= 32 && threads <= kThreads && threads % 32 == 0 &&
         cluster_fn(ppt, true) != nullptr;
}

cudaError_t launch_cluster_route(const float* dist, int* out, int b, int n, int m, int ppt,
                                 int csize, int threads, int exchange, cudaStream_t stream) {
  if (!valid_cta(csize, threads, ppt)) return cudaErrorInvalidValue;
  if (exchange < kExchangeWarps || exchange > kExchangePrefetch) return cudaErrorInvalidValue;
  const int slice = (int)(((long long)n + csize - 1) / csize);
  if ((long long)threads * ppt < slice) return cudaErrorInvalidValue;
  const ClusterFn fn = cluster_fn(ppt, exchange != kExchangeWarps);
  cudaError_t err = prepare(fn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(b, csize, threads, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, fn, dist, n, m, slice, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dist: f32 [b, n, n]; out: int32 [b, m]. route:
// 0, the block route: ppt, minima a thread in registers (1, 2, 4, 8 or 16,
//   with 1,024 * ppt >= n), or 0 for the scratch buffer scratch: f32 [b, n];
// 1, the cluster route over clusters of csize (2, 4, 8 or 16) CTAs of
//   `threads` threads (a multiple of 32, at most 1,024), ppt minima a thread,
//   threads * ppt >= ceil(n / csize); exchange 0 K1's (every warp sends),
//   1 the CTA's best key with its row prefetched into L2.
extern "C" int ssd3d_ffps_dist(const float* dist, int* out, float* scratch, int b, int n, int m,
                               int route, int ppt, int csize, int threads, int exchange,
                               cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (route == 0) return (int)launch_block_route(dist, out, scratch, b, n, m, ppt, stream);
  if (route != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster_route(dist, out, b, n, m, ppt, csize, threads, exchange, stream);
}

// How many of the cluster route's clusters of csize CTAs of `threads`
// threads and ppt minima a thread are resident at once on this card (no
// launch), or minus the cudaError.
extern "C" int ssd3d_ffps_dist_max_clusters(int csize, int threads, int ppt) {
  if (!valid_cta(csize, threads, ppt)) return -(int)cudaErrorInvalidValue;
  const ClusterFn fn = cluster_fn(ppt, true);
  cudaError_t err = prepare(fn);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, csize, threads, &attr, nullptr);
  int active = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(fn), &cfg);
  }
  return err == cudaSuccess ? active : -(int)err;
}

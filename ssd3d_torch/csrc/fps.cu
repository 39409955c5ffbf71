// K1: D-FPS (farthest point sampling over xyz) for Hopper.
//
// Replaces the Pallas kernels ssd3d/ops/pallas/fps.py:_fps_batch_kernel
// (via _fps_pallas_batch, batch >= 4) and _fps_kernel (via _fps_pallas_tiled,
// batch < 4). Contract: pick 0 is index 0; each point keeps the running
// minimum squared distance (fma(dz, dz, fma(dy, dy, dx*dx)), exact
// per-coordinate differences: the chain the JAX package's CPU path computes,
// where XLA contracts its sum of squares into fused multiply-adds) to the
// picked set; the next pick is the argmax, ties to the lowest index.
//
// What bounds it on the H100: the m picks are sequential, and each one needs
// an argmax over the whole cloud, so the kernel is bound by the latency of
// that reduction, not by bytes or FLOPs: the flagship's SA1 does 4,095 picks
// over 16,384 points at ~10 operations a point, which one SM alone cannot do
// in under ~2 ms.
//
// Three routes, chosen by the wrapper from the shape (ops/sampling.fps_route):
//
// - Cluster route, for a few clouds (every D-FPS call of 3DSSD and of
//   PointRCNN's RPN): one cloud over a thread-block cluster of up to 16 CTAs,
//   one CTA an SM (each asks for more than half an SM's shared memory). Each
//   CTA holds the whole cloud in shared memory, only to read a pick's
//   coordinates, and its slice with the running distances in registers, about
//   eight points a thread. A candidate is one 64-bit key, the distance's bits
//   (for d >= 0 they order as unsigned integers) over 0xFFFFFFFF - index, so
//   one unsigned max picks the largest distance and, on a tie, the lowest
//   index, in a warp (two redux.sync) and across the cluster alike; a padding
//   slot is key 0. A pick: every warp sends its key with st.async into its own
//   slot of every CTA of the cluster, each store counted on the receiving
//   CTA's mbarrier of this pick's parity, then waits for its own CTA's
//   mbarrier (all keys of the cluster arrived) and reduces the slots itself.
//   No block or cluster barrier runs inside the loop: a cluster barrier a pick
//   (the first design) cost ~1.4 us a pick, the mbarrier exchange ~0.6 us.
//   Slots and mbarriers are double-buffered by parity: a warp sends pick
//   s + 2 only after every warp of the cluster has sent pick s + 1, which each
//   does after reading pick s. The size of the cluster is the largest of 16,
//   8, 4 and 2 at which all b clusters are resident at once
//   (cudaOccupancyMaxActiveClusters): the H100's GPCs do not all hold 16 SMs,
//   and a second wave would double the time.
// - One-block route, for many clouds (the RCNN's 400): one block of 1,024
//   threads per cloud (the reference CUDA op, tf_sampling_g.cu:124, is shaped
//   the same way), the coordinates in shared memory as three planes, the
//   distances in registers, and a block-wide argmax with two barriers a pick.
// - Slice route, for clouds past 16,384 points (nuScenes' 65,536 and more),
//   which neither route above holds in shared memory: one cloud over a
//   cluster of 1 to 16 CTAs, each CTA holding only its contiguous slice of
//   the cloud, with the same key exchange; after it, every thread reads the
//   winner's xyz (12 bytes) from global memory, where L2 serves it, as K2's
//   cluster route reads its winner's row. Three tiers, by the slice
//   (ops/sampling.py `dfps_slice_plan` mirrors `slice_plan` below):
//   registers (xyz and distance, as the cluster route keeps them: up to
//   8,192 points a CTA, 131,072 a cluster of 16); shared memory (xyz as
//   three planes, 12 bytes a point, the distances in registers, 16 a thread
//   of 1,024: up to 16,384 points a CTA, 262,144 a cluster of 16); global
//   (xyz read from the input at every pick, the distances in a scratch
//   buffer in global memory: any n, slow but correct). A cluster of one CTA
//   is one block a cloud reading its points from global memory.
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;
using namespace ssd3d;

namespace {

// the squared distance as the JAX package's CPU path rounds it: dx * dx,
// then two fused multiply-adds (the file is compiled with -fmad=false, so
// these are the only ones)
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, dx * dx));
}

constexpr int kThreads = 1024;
constexpr int kMaxPoints = 16384;

// ------------------------------------------------------- one-block route

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
        const float d = dist2(dx, dy, dz);
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
cudaError_t launch_block(const float* xyz, int* out, int b, int n, int m, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dfps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dfps_kernel<PPT><<<b, kThreads, smem, stream>>>(xyz, n, m, out);
  return cudaGetLastError();
}

cudaError_t launch_block_route(const float* xyz, int* out, int b, int n, int m,
                               cudaStream_t stream) {
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch_block<1>(xyz, out, b, n, m, stream);
  if (ppt <= 2) return launch_block<2>(xyz, out, b, n, m, stream);
  if (ppt <= 4) return launch_block<4>(xyz, out, b, n, m, stream);
  if (ppt <= 8) return launch_block<8>(xyz, out, b, n, m, stream);
  return launch_block<16>(xyz, out, b, n, m, stream);
}

// -------------------------------------------------------- cluster route

constexpr int kCtaThreads = 512;                           // at most, a CTA
constexpr int kTargetPpt = 8;                              // points a thread, where it can
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = kMaxCluster * kCtaThreads / 32;  // one a warp of the cluster
constexpr int kSpreadSmem = 120 * 1024;                    // > half an SM: one CTA an SM

// One cloud over one cluster. Each CTA keeps the whole cloud in shared memory
// (three planes; only to read a pick's coordinates) and its slice, PPT points
// a thread, with the running distances in registers. A pick: every warp
// reduces its key and sends it with st.async into its own slot of every CTA
// of the cluster, counted on that CTA's barrier of this pick's parity; every
// warp waits for its CTA's barrier (all nwarps * csize keys arrived) and
// reduces the slots itself. No block or cluster barrier inside the loop.
template <int PPT>
__global__ void __launch_bounds__(kCtaThreads)
    dfps_cluster_kernel(const float* __restrict__ xyz, int n, int m, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ unsigned long long s_key[2][kMaxSlots];
  __shared__ __align__(8) unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nslots = csize * nwarps;
  const int slot = rank * nwarps + (threadIdx.x >> 5);
  const float* p = xyz + (size_t)(blockIdx.x / csize) * n * 3;
  int* o = out + (size_t)(blockIdx.x / csize) * m;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&s_bar[0]), 1);
    mbar_init(smem_addr(&s_bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the cloud and the barriers are ready in every CTA before the first st.async
  cluster.sync();

  // this CTA's slice: points rank * PPT * blockDim.x + k * blockDim.x + threadIdx.x
  const int first = rank * PPT * blockDim.x + threadIdx.x;
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = first + k * blockDim.x;
    px[k] = j < n ? sx[j] : 0.0f;
    py[k] = j < n ? sy[j] : 0.0f;
    pz[k] = j < n ? sz[j] : 0.0f;
    dist[k] = INFINITY;
  }
  // where this warp's key lands in CTA `lane` (lanes < csize send)
  const uint32_t to = lane % csize;
  const uint32_t to_slot0 = cluster_addr(smem_addr(&s_key[0][slot]), to);
  const uint32_t to_slot1 = cluster_addr(smem_addr(&s_key[1][slot]), to);
  const uint32_t to_bar0 = cluster_addr(smem_addr(&s_bar[0]), to);
  const uint32_t to_bar1 = cluster_addr(smem_addr(&s_bar[1]), to);
  float lx = sx[0], ly = sy[0], lz = sz[0];  // pick 0 is index 0
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;

  for (int s = 1; s < m; ++s) {
    const int par = s & 1;
    // this buffer's previous phase (pick s - 2) has ended: arm it for pick s
    if (threadIdx.x == 0) mbar_expect_tx(smem_addr(&s_bar[par]), nslots * 8);
    unsigned long long best = 0ull;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = first + k * blockDim.x;
      const float dx = px[k] - lx;
      const float dy = py[k] - ly;
      const float dz = pz[k] - lz;
      const float d = dist2(dx, dy, dz);
      const float nd = fminf(dist[k], d);
      dist[k] = nd;
      const unsigned long long key = j < n ? fps_key(nd, j) : 0ull;
      best = key > best ? key : best;
    }
    const unsigned long long wbest = warp_max_key(best);
    if (lane < csize) st_async(par ? to_slot1 : to_slot0, wbest, par ? to_bar1 : to_bar0);
    mbar_wait(smem_addr(&s_bar[par]), ((s - 1) >> 1) & 1);

    unsigned long long win = 0ull;
    for (int i = lane; i < nslots; i += 32) {
      const unsigned long long key = s_key[par][i];
      win = key > win ? key : win;
    }
    win = warp_max_key(win);
    const int j = (int)(0xFFFFFFFFu - (unsigned)win);
    lx = sx[j];
    ly = sy[j];
    lz = sz[j];
    if (rank == 0 && threadIdx.x == 0) o[s] = j;
  }
  cluster.sync();  // no CTA exits while a store into it may be in flight
}

using ClusterFn = void (*)(const float*, int, int, int*);

struct ClusterPlan {
  ClusterFn fn;
  int csize, threads, log_ppt;
};

// The CTA shape for n points over csize CTAs: kTargetPpt points a thread
// where that keeps a CTA between one warp and kCtaThreads threads, then the
// fewest points a thread (a power of two) that covers the slice.
// n <= 16,384 and csize >= 2 give at most 16.
ClusterPlan plan(int n, int csize) {
  constexpr ClusterFn kFns[5] = {dfps_cluster_kernel<1>, dfps_cluster_kernel<2>,
                                 dfps_cluster_kernel<4>, dfps_cluster_kernel<8>,
                                 dfps_cluster_kernel<16>};
  const int slice = (n + csize - 1) / csize;
  const int want = ((slice + kTargetPpt - 1) / kTargetPpt + 31) / 32 * 32;
  const int threads = want < 32 ? 32 : want > kCtaThreads ? kCtaThreads : want;
  int log_ppt = 0;
  while ((threads << log_ppt) < slice) ++log_ppt;
  return {kFns[log_ppt], csize, threads, log_ppt};
}

size_t cluster_smem(int n) {
  const size_t cloud = (size_t)3 * n * sizeof(float);
  return cloud > (size_t)kSpreadSmem ? cloud : (size_t)kSpreadSmem;
}

cudaLaunchConfig_t cluster_config(const ClusterPlan& pl, int b, int n, cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * pl.csize);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = cluster_smem(n);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster size at which all b clusters are resident at once, or
// 2 if none is (the clusters then run in waves). Occupancy answers, and the
// attributes they need, are cached by (card, instantiation, threads, size):
// one CTA an SM whatever n, so the shared memory a CTA asks for does not
// change them; the attributes are the card's own. Past kMaxCards cards
// nothing is cached.
constexpr int kMaxCards = 16;

cudaError_t choose_cluster(int b, int n, ClusterPlan* out) {
  // max active clusters + 1; 0 = not asked
  static int cache[kMaxCards][5][kCtaThreads / 32 + 1][4];
  int card = 0;
  const cudaError_t dev_err = cudaGetDevice(&card);
  if (dev_err != cudaSuccess) return dev_err;
  const int sizes[4] = {16, 8, 4, 2};
  for (int si = 0; si < 4; ++si) {
    const ClusterPlan pl = plan(n, sizes[si]);
    int uncached = 0;
    int& known = card < kMaxCards ? cache[card][pl.log_ppt][pl.threads / 32][si] : uncached;
    if (known == 0) {
      const void* fn = reinterpret_cast<const void*>(pl.fn);
      cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)cluster_smem(kMaxPoints));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(pl, 1, n, &attr, nullptr);
      int active = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
      if (err != cudaSuccess) return err;
      known = active + 1;
    }
    *out = pl;
    if (known - 1 >= b) return cudaSuccess;
  }
  return cudaSuccess;  // *out is the size-2 plan
}

cudaError_t launch_cluster_route(const float* xyz, int* out, int b, int n, int m,
                                 cudaStream_t stream) {
  ClusterPlan pl;
  cudaError_t err = choose_cluster(b, n, &pl);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(pl, b, n, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, pl.fn, xyz, n, m, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------- slice route
//
// The plan below (tier, slice, threads, points a thread, shared memory) is
// mirrored by ops/sampling.py `dfps_slice_plan`.

constexpr int kSliceThreads = 1024;                            // shared and global tiers
constexpr int kSliceSlots = kMaxCluster * kSliceThreads / 32;  // one a warp of the cluster
constexpr int kRegSlice = kCtaThreads * 16;                    // 8,192: the register tier
constexpr int kSharedSlice = kSliceThreads * 16;               // 16,384: the shared tier
constexpr int kSliceSmemMax = 3 * kSharedSlice * (int)sizeof(float);

enum Tier { kRegisters = 0, kShared = 1, kGlobal = 2 };

// One cloud over one cluster, each CTA holding its slice only (see the
// file's header). `slice` points a CTA; `scratch` f32 [b, n], the global
// tier's running distances.
template <int TIER, int PPT>
__global__ void __launch_bounds__(TIER == kRegisters ? kCtaThreads : kSliceThreads)
    dfps_slice_kernel(const float* __restrict__ xyz, int n, int m, int slice,
                      float* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_key[2][kSliceSlots];
  __shared__ __align__(8) unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nslots = csize * nwarps;
  const int slot = rank * nwarps + (threadIdx.x >> 5);
  const size_t cloud = blockIdx.x / csize;
  const float* p = xyz + cloud * n * 3;
  int* o = out + cloud * m;
  const int first = rank * slice;
  const int count = max(0, min(slice, n - first));
  float* sx = smem;  // the shared tier's slice, three planes
  float* sy = sx + slice;
  float* sz = sy + slice;
  float* sd = TIER == kGlobal ? scratch + cloud * n + first : nullptr;

  if (TIER == kShared) {
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const float* q = p + 3 * (size_t)(first + e);
      sx[e] = q[0];
      sy[e] = q[1];
      sz[e] = q[2];
    }
  }
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&s_bar[0]), 1);
    mbar_init(smem_addr(&s_bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the slices and the barriers are ready in every CTA before the first st.async
  cluster.sync();

  // this thread's points of the slice: threadIdx.x + k * blockDim.x
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    const float* q = p + 3 * (size_t)(first + e);
    px[k] = TIER == kRegisters && e < count ? q[0] : 0.0f;
    py[k] = TIER == kRegisters && e < count ? q[1] : 0.0f;
    pz[k] = TIER == kRegisters && e < count ? q[2] : 0.0f;
    dist[k] = INFINITY;
  }
  const uint32_t to = lane % csize;
  const uint32_t to_slot0 = cluster_addr(smem_addr(&s_key[0][slot]), to);
  const uint32_t to_slot1 = cluster_addr(smem_addr(&s_key[1][slot]), to);
  const uint32_t to_bar0 = cluster_addr(smem_addr(&s_bar[0]), to);
  const uint32_t to_bar1 = cluster_addr(smem_addr(&s_bar[1]), to);
  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);  // pick 0 is index 0
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;

  for (int s = 1; s < m; ++s) {
    const int par = s & 1;
    if (threadIdx.x == 0) mbar_expect_tx(smem_addr(&s_bar[par]), nslots * 8);
    unsigned long long best = 0ull;
    if (TIER == kGlobal) {
      for (int e = threadIdx.x; e < count; e += blockDim.x) {
        const float* q = p + 3 * (size_t)(first + e);
        const float dx = __ldg(q) - lx;
        const float dy = __ldg(q + 1) - ly;
        const float dz = __ldg(q + 2) - lz;
        const float d = dist2(dx, dy, dz);
        const float nd = fminf(s > 1 ? sd[e] : INFINITY, d);
        sd[e] = nd;
        const unsigned long long key = fps_key(nd, first + e);
        best = key > best ? key : best;
      }
    } else {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int e = threadIdx.x + k * blockDim.x;
        const bool in = e < count;
        const float x = TIER == kRegisters ? px[k] : (in ? sx[e] : 0.0f);
        const float y = TIER == kRegisters ? py[k] : (in ? sy[e] : 0.0f);
        const float z = TIER == kRegisters ? pz[k] : (in ? sz[e] : 0.0f);
        const float dx = x - lx;
        const float dy = y - ly;
        const float dz = z - lz;
        const float d = dist2(dx, dy, dz);
        const float nd = fminf(dist[k], d);
        dist[k] = nd;
        const unsigned long long key = in ? fps_key(nd, first + e) : 0ull;
        best = key > best ? key : best;
      }
    }
    const unsigned long long wbest = warp_max_key(best);
    if (lane < csize) st_async(par ? to_slot1 : to_slot0, wbest, par ? to_bar1 : to_bar0);
    mbar_wait(smem_addr(&s_bar[par]), ((s - 1) >> 1) & 1);

    unsigned long long win = 0ull;
    for (int i = lane; i < nslots; i += 32) {
      const unsigned long long key = s_key[par][i];
      win = key > win ? key : win;
    }
    const int j = fps_key_index(warp_max_key(win));
    const float* w = p + 3 * (size_t)j;  // the winner's xyz, from L2
    lx = __ldg(w);
    ly = __ldg(w + 1);
    lz = __ldg(w + 2);
    if (rank == 0 && threadIdx.x == 0) o[s] = j;
  }
  cluster.sync();  // no CTA exits while a store into it may be in flight
}

using SliceFn = void (*)(const float*, int, int, int, float*, int*);

struct SlicePlan {
  SliceFn fn;
  int tier, slice, threads;
  size_t smem;
};

// The CTA for n points over csize CTAs: the register tier (the cluster
// route's shape: kTargetPpt points a thread up to kCtaThreads threads, then
// up to 16) where the slice holds at most kRegSlice points; the shared tier
// (kSliceThreads threads, 16 points a thread) up to kSharedSlice; else the
// global tier. Every CTA asks for more than half an SM's shared memory.
SlicePlan slice_plan(int n, int csize) {
  constexpr SliceFn kRegFns[5] = {
      dfps_slice_kernel<kRegisters, 1>, dfps_slice_kernel<kRegisters, 2>,
      dfps_slice_kernel<kRegisters, 4>, dfps_slice_kernel<kRegisters, 8>,
      dfps_slice_kernel<kRegisters, 16>};
  SlicePlan pl;
  pl.slice = (int)(((long long)n + csize - 1) / csize);
  pl.smem = kSpreadSmem;
  if (pl.slice <= kRegSlice) {
    const int want = ((pl.slice + kTargetPpt - 1) / kTargetPpt + 31) / 32 * 32;
    pl.threads = want < 32 ? 32 : want > kCtaThreads ? kCtaThreads : want;
    int log_ppt = 0;
    while ((pl.threads << log_ppt) < pl.slice) ++log_ppt;
    pl.fn = kRegFns[log_ppt];
    pl.tier = kRegisters;
  } else if (pl.slice <= kSharedSlice) {
    pl.fn = dfps_slice_kernel<kShared, 16>;
    pl.tier = kShared;
    pl.threads = kSliceThreads;
    const size_t planes = (size_t)3 * pl.slice * sizeof(float);
    pl.smem = planes > pl.smem ? planes : pl.smem;
  } else {
    pl.fn = dfps_slice_kernel<kGlobal, 1>;
    pl.tier = kGlobal;
    pl.threads = kSliceThreads;
  }
  return pl;
}

bool valid_slice_size(int csize) {
  return csize == 1 || csize == 2 || csize == 4 || csize == 8 || csize == 16;
}

// the launch configuration of b clusters of the plan's CTAs
cudaError_t slice_config(const SlicePlan& pl, int csize, int b, cudaLaunchAttribute* attr,
                         cudaStream_t stream, cudaLaunchConfig_t* cfg) {
  const void* fn = reinterpret_cast<const void*>(pl.fn);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3(b * csize);
  cfg->blockDim = dim3(pl.threads);
  cfg->dynamicSmemBytes = pl.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

cudaError_t launch_slice_route(const float* xyz, int* out, float* scratch, int b, int n, int m,
                               int csize, cudaStream_t stream) {
  if (!valid_slice_size(csize)) return cudaErrorInvalidValue;
  const SlicePlan pl = slice_plan(n, csize);
  if (pl.tier == kGlobal && scratch == nullptr) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = slice_config(pl, csize, b, &attr, stream, &cfg);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pl.fn, xyz, n, m, pl.slice, scratch, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// xyz: f32 [b, n, 3] contiguous; out: i32 [b, m]. route: 0 one block a
// cloud and 1 a cluster a cloud (both n <= 16,384: they hold the whole
// cloud in shared memory); 2 the slice route, any n, over clusters of csize
// (1, 2, 4, 8 or 16) CTAs, with scratch f32 [b, n] where the plan's tier is
// the global one (ops/sampling.py `dfps_slice_plan`), else unused.
extern "C" int ssd3d_dfps(const float* xyz, int* out, float* scratch, int b, int n, int m,
                          int route, int csize, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (route == 2) return (int)launch_slice_route(xyz, out, scratch, b, n, m, csize, stream);
  if (n > kMaxPoints) return (int)cudaErrorInvalidValue;  // a forced route that cannot hold it
  if (route == 1) return (int)launch_cluster_route(xyz, out, b, n, m, stream);
  if (route == 0) return (int)launch_block_route(xyz, out, b, n, m, stream);
  return (int)cudaErrorInvalidValue;
}

// The cluster route's cluster size for b clouds of n points (no launch), or
// minus the cudaError of the occupancy query.
extern "C" int ssd3d_dfps_cluster_size(int b, int n) {
  if (b <= 0 || n <= 0 || n > kMaxPoints) return -(int)cudaErrorInvalidValue;
  ClusterPlan pl;
  const cudaError_t err = choose_cluster(b, n, &pl);
  return err == cudaSuccess ? pl.csize : -(int)err;
}

// How many of the slice route's clusters of csize CTAs, for clouds of n
// points, are resident at once on this card (no launch), or minus the
// cudaError.
extern "C" int ssd3d_dfps_slice_clusters(int n, int csize) {
  if (n <= 0 || !valid_slice_size(csize)) return -(int)cudaErrorInvalidValue;
  const SlicePlan pl = slice_plan(n, csize);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = slice_config(pl, csize, 1, &attr, nullptr, &cfg);
  int active = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(pl.fn), &cfg);
  return err == cudaSuccess ? active : -(int)err;
}

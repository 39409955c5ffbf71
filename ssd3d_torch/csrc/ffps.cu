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
// the channels accumulated in order by one thread, the same arithmetic as the
// plain PyTorch version in ssd3d_torch/ops/sampling.py. One pick costs
// n * c subtract-multiply-add chains.
//
// What bounds it on the H100: the m picks are sequential, and each needs the
// whole cloud's n * c chains and then an argmax over the cloud. One SM alone
// re-reads the cloud from L2 every pick (1.1 MB at SA2: ~9.6 us a pick). Over
// a cluster, a pick costs the slice's chains (about 0.4 us at SA2 on 64
// SMs: 3 f32 operations a channel, none fused), the key exchange (~0.6 us,
// as K1's) and the winner's row reaching every CTA (an L2 round trip).
//
// Three routes, chosen by the wrapper from the shape (ops/sampling.py
// `ffps_route`):
//
// - Cluster route: one cloud over a thread-block cluster of 2 to 16 CTAs,
//   one CTA an SM. Each CTA keeps its contiguous slice of the points, all c
//   channels, in shared memory, point-major (a row stride of c rounded up to
//   a multiple of four floats, an odd number of 16-byte vectors, so a warp's
//   vector loads of 32 consecutive rows meet no bank conflict), loaded
//   straight from the [b, n, c] input. A thread owns points of the slice
//   and sums each point's channels in order; the running distances stay in
//   shared memory. The argmax is K1's exchange (fps.cu): each warp sends its
//   64-bit key (distance bits over 0xFFFFFFFF - index) with st.async into
//   its own slot of every CTA, counted on that CTA's mbarrier of the pick's
//   parity, and no block or cluster barrier runs in the loop. Every warp
//   then copies the winner's row from global memory (L2, then L1 for the
//   CTA's other warps) into its own row buffer, so no block barrier is
//   needed for the broadcast either. (Two other ways to move the row were
//   slower at every path shape, PERF.md §6: reading it from the owning
//   CTA's shared memory over DSMEM, and each CTA sending its best key with
//   that point's row to every CTA, behind a block barrier.) The wrapper
//   takes the largest cluster size whose
//   slice fits in shared memory and at which all b clusters are resident at
//   once (cudaOccupancyMaxActiveClusters).
// - One-block route, where no cluster size satisfies both (SA2's shape at
//   16 clouds): one block of 1,024 threads per cloud, the fused vectors
//   channel-major ([b, c, n], transposed by the wrapper) so a warp reads 32
//   consecutive points of one channel per load; the picked vector staged in
//   shared memory; the distances in registers; a block-wide argmax with two
//   barriers a pick.
// - Stream route, for shapes that no cluster slice fits and the one-block
//   route does not take (n > 8,192 or c > 4,096 with a slice too large for
//   shared memory: a full 16,384-point scan with SA1's 64 features): one
//   cloud over a cluster of 16 CTAs (in waves where not all clusters are
//   resident), the fused vectors channel-major as the one-block route takes
//   them. Each thread keeps its points' running distances in registers (in
//   a scratch buffer in global memory past 8 points a thread of 1,024, a
//   slice of 8,192) and re-reads its points' channels from global memory at
//   every pick; every thread reads the winner's channels from global memory
//   as it sums (one address a warp: a broadcast L1 serves), and the argmax
//   is the cluster route's key exchange. Slow (each pick streams the cloud
//   through L2) but it takes any n and c.
#include <climits>

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;
using namespace ssd3d;

namespace {

// ------------------------------------------------------- one-block route

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

cudaError_t launch_block_route(const float* feat, int* out, int b, int n, int c, int m,
                               cudaStream_t stream) {
  if (n > kMaxPoints || c > kMaxChannels) return cudaErrorInvalidValue;
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(feat, out, b, n, c, m, stream);
  if (ppt <= 2) return launch<2>(feat, out, b, n, c, m, stream);
  if (ppt <= 4) return launch<4>(feat, out, b, n, c, m, stream);
  return launch<8>(feat, out, b, n, c, m, stream);
}

// -------------------------------------------------------- cluster route
//
// The plan below (slice, threads, row stride, shared memory) is mirrored by
// ops/sampling.py `ffps_cluster_plan`, which decides whether a size fits.

constexpr int kCtaThreads = 512;                           // at most, a CTA
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = kMaxCluster * kCtaThreads / 32;  // one a warp of the cluster
constexpr int kSpreadSmem = 120 * 1024;                    // > half an SM: one CTA an SM
constexpr int kMaxSmem = 232448;                           // a block's shared memory
constexpr int kRowLoads = 8;                               // a lane, copying a row
// the kernel's static shared memory: keys and two barriers
constexpr int kStaticSmem = 8 * (2 * kMaxSlots + 2);

struct Plan {
  int slice;    // points a CTA
  int threads;  // a CTA
  int stride;   // floats a row
  size_t smem;  // dynamic shared memory
};

// c rounded up to whole 16-byte vectors, and to an odd number of them
__host__ __device__ inline int row_stride(int c) {
  int vec = (c + 3) / 4;
  if (vec % 2 == 0) ++vec;
  return 4 * vec;
}

Plan plan(int n, int c, int csize) {
  Plan p;
  p.slice = (n + csize - 1) / csize;
  const int want = (p.slice + 31) / 32 * 32;
  p.threads = want > kCtaThreads ? kCtaThreads : want;
  p.stride = row_stride(c);
  const size_t need = sizeof(float) * ((size_t)p.slice * p.stride +
                                       (size_t)(p.threads / 32) * p.stride + p.slice);
  p.smem = need > (size_t)kSpreadSmem ? need : (size_t)kSpreadSmem;
  return p;
}

// One cloud over one cluster; see the file's header.
__global__ void __launch_bounds__(kCtaThreads)
    ffps_cluster_kernel(const float* __restrict__ feat, int n, int c, int m, int slice,
                        int stride, int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_key[2][kMaxSlots];  // a pick's keys (by parity), one a warp
  __shared__ __align__(8) unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nslots = csize * nwarps;
  const int slot = rank * nwarps + warp;
  float* s_pts = smem;                                // [slice][stride]
  float* s_rows = s_pts + (size_t)slice * stride;     // [nwarps][stride]
  float* s_dist = s_rows + (size_t)nwarps * stride;   // [slice]
  float* my_row = s_rows + (size_t)warp * stride;
  const float* f = feat + (size_t)(blockIdx.x / csize) * n * c;
  int* o = out + (size_t)(blockIdx.x / csize) * m;
  const int first = rank * slice;
  const int count = max(0, min(slice, n - first));

  // this CTA's slice, point-major, zero in the padding columns
  for (int e = threadIdx.x; e < slice * stride; e += blockDim.x) {
    const int p = e / stride;
    const int ch = e - p * stride;
    s_pts[e] = (p < count && ch < c) ? f[(size_t)(first + p) * c + ch] : 0.0f;
  }
  for (int p = threadIdx.x; p < slice; p += blockDim.x) s_dist[p] = INFINITY;
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&s_bar[0]), 1);
    mbar_init(smem_addr(&s_bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every slice and barrier is ready before the first st.async
  cluster.sync();

  // the warp's copy of point j's row from global memory (its lanes finished
  // with the last one), kRowLoads loads a lane in flight at once
  auto load_row = [&](int j) {
    __syncwarp();
    const float* g = f + (size_t)j * c;
    for (int ch0 = 0; ch0 < c; ch0 += 32 * kRowLoads) {
      float v[kRowLoads];
#pragma unroll
      for (int k = 0; k < kRowLoads; ++k) {
        const int ch = ch0 + 32 * k + lane;
        if (ch < c) v[k] = __ldg(g + ch);
      }
#pragma unroll
      for (int k = 0; k < kRowLoads; ++k) {
        const int ch = ch0 + 32 * k + lane;
        if (ch < c) my_row[ch] = v[k];
      }
    }
    __syncwarp();
  };

  // where this warp's key lands in CTA `lane` (lanes < csize send)
  const uint32_t to = lane % csize;
  const uint32_t to_slot0 = cluster_addr(smem_addr(&s_key[0][slot]), to);
  const uint32_t to_slot1 = cluster_addr(smem_addr(&s_key[1][slot]), to);
  const uint32_t to_bar0 = cluster_addr(smem_addr(&s_bar[0]), to);
  const uint32_t to_bar1 = cluster_addr(smem_addr(&s_bar[1]), to);
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  load_row(0);  // pick 0 is index 0
  const int full4 = c & ~3;

  for (int s = 1; s < m; ++s) {
    const int par = s & 1;
    // this buffer's previous phase (pick s - 2) has ended: arm it for pick s
    if (threadIdx.x == 0) mbar_expect_tx(smem_addr(&s_bar[par]), nslots * 8);
    unsigned long long best = 0ull;
    for (int p = threadIdx.x; p < count; p += blockDim.x) {
      const float* x = s_pts + (size_t)p * stride;
      float acc = 0.0f;
      int ch = 0;
      for (; ch < full4; ch += 4) {
        const float4 a = *reinterpret_cast<const float4*>(x + ch);
        const float4 r = *reinterpret_cast<const float4*>(my_row + ch);
        float d = a.x - r.x;
        acc = acc + d * d;
        d = a.y - r.y;
        acc = acc + d * d;
        d = a.z - r.z;
        acc = acc + d * d;
        d = a.w - r.w;
        acc = acc + d * d;
      }
      for (; ch < c; ++ch) {
        const float d = x[ch] - my_row[ch];
        acc = acc + d * d;
      }
      const float nd = fminf(s_dist[p], acc);
      s_dist[p] = nd;
      const unsigned long long key = fps_key(nd, first + p);
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
    const int j = fps_key_index(warp_max_key(win));
    if (rank == 0 && threadIdx.x == 0) o[s] = j;
    if (s + 1 < m) load_row(j);
  }
  cluster.sync();  // no CTA exits while a store into it may be in flight
}

cudaError_t cluster_config(const Plan& pl, int csize, int b, cudaLaunchAttribute* attr,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg) {
  if (pl.smem + kStaticSmem > (size_t)kMaxSmem) {
    return cudaErrorInvalidValue;  // the slice does not fit
  }
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

// attributes of the current card, so set at every call, as a process may
// launch on several
cudaError_t prepare() {
  const void* f = reinterpret_cast<const void*>(ffps_cluster_kernel);
  cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem - kStaticSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

bool valid_size(int csize) {
  return csize == 2 || csize == 4 || csize == 8 || csize == 16;
}

// --------------------------------------------------------- stream route
//
// The plan below is mirrored by ops/sampling.py `ffps_stream_plan`.

constexpr int kStreamCluster = 16;
constexpr int kStreamThreads = 1024;
constexpr int kStreamMaxPpt = 8;
constexpr int kStreamSlots = kStreamCluster * kStreamThreads / 32;

// One cloud over a cluster of 16 CTAs; see the file's header. feat is
// channel-major [b, c, n]; PPT points a thread with their distances in
// registers, or PPT 0: the distances in scratch f32 [b, n].
template <int PPT>
__global__ void __launch_bounds__(kStreamThreads)
    ffps_stream_kernel(const float* __restrict__ feat, int n, int c, int m, int slice,
                       float* __restrict__ scratch, int* __restrict__ out) {
  __shared__ unsigned long long s_key[2][kStreamSlots];
  __shared__ __align__(8) unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nslots = csize * nwarps;
  const int slot = rank * nwarps + (threadIdx.x >> 5);
  const size_t cloud = blockIdx.x / csize;
  const float* f = feat + cloud * c * n;
  int* o = out + cloud * m;
  const int first = rank * slice;
  const int count = max(0, min(slice, n - first));
  float* sd = PPT == 0 ? scratch + cloud * n + first : nullptr;
  float dist[PPT > 0 ? PPT : 1];
#pragma unroll
  for (int k = 0; k < (PPT > 0 ? PPT : 1); ++k) dist[k] = INFINITY;
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&s_bar[0]), 1);
    mbar_init(smem_addr(&s_bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every CTA's barriers are ready before the first st.async

  const uint32_t to = lane % csize;
  const uint32_t to_slot0 = cluster_addr(smem_addr(&s_key[0][slot]), to);
  const uint32_t to_slot1 = cluster_addr(smem_addr(&s_key[1][slot]), to);
  const uint32_t to_bar0 = cluster_addr(smem_addr(&s_bar[0]), to);
  const uint32_t to_bar1 = cluster_addr(smem_addr(&s_bar[1]), to);
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;

  int last = 0;  // pick 0 is index 0
  for (int s = 1; s < m; ++s) {
    const int par = s & 1;
    if (threadIdx.x == 0) mbar_expect_tx(smem_addr(&s_bar[par]), nslots * 8);
    unsigned long long best = 0ull;
    if (PPT > 0) {
      float acc[PPT > 0 ? PPT : 1];
#pragma unroll
      for (int k = 0; k < PPT; ++k) acc[k] = 0.0f;
      for (int ch = 0; ch < c; ++ch) {
        const float* row = f + (size_t)ch * n;
        const float pv = __ldg(row + last);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int e = threadIdx.x + k * kStreamThreads;
          if (e < count) {
            const float diff = __ldg(row + first + e) - pv;
            acc[k] = acc[k] + diff * diff;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int e = threadIdx.x + k * kStreamThreads;
        const float nd = fminf(dist[k], acc[k]);
        dist[k] = nd;
        const unsigned long long key = e < count ? fps_key(nd, first + e) : 0ull;
        best = key > best ? key : best;
      }
    } else {
      for (int e = threadIdx.x; e < count; e += kStreamThreads) {
        float acc = 0.0f;
        for (int ch = 0; ch < c; ++ch) {
          const float* row = f + (size_t)ch * n;
          const float diff = __ldg(row + first + e) - __ldg(row + last);
          acc = acc + diff * diff;
        }
        const float nd = fminf(s > 1 ? sd[e] : INFINITY, acc);
        sd[e] = nd;
        const unsigned long long key = fps_key(nd, first + e);
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
    last = fps_key_index(warp_max_key(win));
    if (rank == 0 && threadIdx.x == 0) o[s] = last;
  }
  cluster.sync();  // no CTA exits while a store into it may be in flight
}

using StreamFn = void (*)(const float*, int, int, int, int, float*, int*);

// slice = ceil(n / 16) points a CTA, 1,024 threads, and the fewest points a
// thread (1, 2, 4 or 8) that cover the slice; 0 (the scratch buffer) past 8
int stream_ppt(int slice) {
  int ppt = 1;
  while (ppt * kStreamThreads < slice && ppt < kStreamMaxPpt) ppt *= 2;
  return ppt * kStreamThreads < slice ? 0 : ppt;
}

cudaError_t launch_stream_route(const float* feat, int* out, float* scratch, int b, int n, int c,
                                int m, cudaStream_t stream) {
  const int slice = (int)(((long long)n + kStreamCluster - 1) / kStreamCluster);
  const int ppt = stream_ppt(slice);
  if (ppt == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  const StreamFn fn = ppt == 0   ? &ffps_stream_kernel<0>
                      : ppt == 1 ? &ffps_stream_kernel<1>
                      : ppt == 2 ? &ffps_stream_kernel<2>
                      : ppt == 4 ? &ffps_stream_kernel<4>
                                 : &ffps_stream_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kStreamCluster);
  cfg.blockDim = dim3(kStreamThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kStreamCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, feat, n, c, m, slice, scratch, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// F-FPS. out: i32 [b, m]. route:
// 0, the one-block route: feat f32 [b, c, n] contiguous (channel-major),
//   n <= 8,192, c <= 4,096;
// 1, the cluster route over clusters of csize (2, 4, 8 or 16) CTAs: feat f32
//   [b, n, c] contiguous (point-major); the slice must fit in shared memory
//   (ops/sampling.py `ffps_cluster_plan`);
// 2, the stream route, any n and c: feat f32 [b, c, n] contiguous; scratch
//   f32 [b, n] where ceil(n / 16) > 8,192 (ops/sampling.py
//   `ffps_stream_plan`), else unused.
extern "C" int ssd3d_ffps(const float* feat, int* out, float* scratch, int b, int n, int c, int m,
                          int route, int csize, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || c <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (route == 0) return (int)launch_block_route(feat, out, b, n, c, m, stream);
  if (route == 2) return (int)launch_stream_route(feat, out, scratch, b, n, c, m, stream);
  if (route != 1 || !valid_size(csize)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(n, c, csize);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(pl, csize, b, &attr, stream, &cfg);
  if (err == cudaSuccess) err = prepare();
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, ffps_cluster_kernel, feat, n, c, m, pl.slice, pl.stride, out);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of csize CTAs, each holding a slice of an n x c cloud,
// are resident at once on this card (no launch), or minus the cudaError.
extern "C" int ssd3d_ffps_max_clusters(int n, int c, int csize) {
  if (n <= 0 || c <= 0 || !valid_size(csize)) return -(int)cudaErrorInvalidValue;
  const Plan pl = plan(n, c, csize);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(pl, csize, 1, &attr, nullptr, &cfg);
  if (err == cudaSuccess) err = prepare();
  int active = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(ffps_cluster_kernel),
                                         &cfg);
  }
  return err == cudaSuccess ? active : -(int)err;
}

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
// torch.minimum does.
//
// What bounds it on the H100: a pick reads one row of n floats, so the
// bytes are b * npoint * n * 4 (at [8, 4096, 4096] -> 512, 67 MB: 20 us at
// 3.35 TB/s). But the picks are serial and each row is the argmax of the
// last pick, so the kernel waits on the latency of one row read from HBM
// (a random row of a matrix far larger than L2) and one block-wide argmax
// a pick, about 1-2 us, not on bandwidth.
//
// Design: one block of 1,024 threads a cloud; thread t owns the points
// t + k * 1024, reads their entries of the row coalesced (a warp reads 128
// contiguous bytes) and keeps their running minima in registers, PPT of
// them (up to 16: n <= 16,384, the "registers" tier), or, past that, in a
// scratch buffer [b, n] in global memory that only the owner reads and
// writes (the "global" tier, any n). The argmax is K1's key exchange
// (csrc/fps.cu): one 64-bit key, order-preserving bits of the distance over
// 0xFFFFFFFF - index, so one unsigned max picks the largest distance and,
// on a tie, the lowest index; a warp reduces with shuffles, lane 0 writes
// its warp's key into a slot of this pick's parity, one __syncthreads, then
// every warp reduces the 32 slots itself. Slots are double-buffered by
// parity: a warp writes pick s + 2's slot only after the barrier of pick
// s + 1, which every warp reaches after reading pick s's slots.
#include <cstdint>

#include "common.cuh"

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

}  // namespace

// dist: f32 [b, n, n]; out: int32 [b, m]; ppt: minima a thread in registers
// (1, 2, 4, 8 or 16, with 1,024 * ppt >= n), or 0 for the scratch buffer
// scratch: f32 [b, n] (ppt == 0 only).
extern "C" int ssd3d_ffps_dist(const float* dist, int* out, float* scratch, int b, int n, int m,
                               int ppt, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (ppt > 0 && (long long)ppt * kThreads < n) return (int)cudaErrorInvalidValue;
  switch (ppt) {
    case 0:
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<0>(dist, out, scratch, b, n, m, stream);
    case 1: return (int)launch<1>(dist, out, scratch, b, n, m, stream);
    case 2: return (int)launch<2>(dist, out, scratch, b, n, m, stream);
    case 4: return (int)launch<4>(dist, out, scratch, b, n, m, stream);
    case 8: return (int)launch<8>(dist, out, scratch, b, n, m, stream);
    case 16: return (int)launch<16>(dist, out, scratch, b, n, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

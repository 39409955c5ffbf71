// K6: three_nn, the 3 nearest known points of each unknown point.
//
// Replaces the Pallas kernel ssd3d/ops/pallas/three_nn.py:_three_nn_kernel
// (via three_nn_pallas). Contract: for each unknown point, the squared
// distances ((dx*dx + dy*dy) + dz*dz, dx = unknown - known, each product and
// sum rounded separately under -fmad=false) to its three nearest knowns,
// nearest first; equal distances fill the slots in index order (the scan of
// the reference CUDA op, tf_interpolate_g.cu). The indices equal the plain
// version's and the distances are bit-identical to it. No backward: the op
// has none.
//
// What bounds it on the H100: issue slots and the path from shared memory
// to the registers. The largest call (PointRCNN FP1, batch 4: 16,384
// unknowns x 4,096 knowns a cloud) is 2.7e8 pairs of 9 operations (3 sub,
// 3 mul, 2 add, a compare), none of them an FFMA, so each takes an issue
// slot of its own: 33.5e12 a second on 132 SMs, 0.072 ms. It reads 1 MB and
// writes 1.5 MB. Each pair also brings a known's 16 bytes to a thread's
// registers, and a load from shared memory hands an SM 128 bytes a cycle:
// 0.129 ms at FP1. The TPU kernel built a [tile, m] distance matrix in VMEM
// and took three min passes over it; here no matrix exists, and brute force
// is the right work at these sizes (d² as |u|² + |k|² - 2u·k on the tensor
// cores would round otherwise).
//
// Design (ops/interpolate.py `three_nn_slices` picks S from the shape):
// - A thread takes one unknown with its 3-best list in registers. The
//   knowns of a tile are staged in shared memory as float4 (x, y, z, 0):
//   one 16-byte broadcast load a known, where three scalar loads were.
// - Knowns are screened 8 at a time: their 8 distances and the least of
//   them in registers, then the scan's insertions in index order only where
//   the least beats the third slot. A warp runs those insertions for all of
//   its lanes when any one needs them, which in a scan of knowns in no
//   spatial order is about half the chunks; one compare and branch a chunk
//   replaces one a pair.
// - Where the unknowns alone give too few warps to fill the card (FP2-FP4
//   and any small call), the knowns split into S slices (2, 4 or 8) of
//   contiguous indices, scanned by S neighbouring lanes of a warp, each
//   keeping its own 3-best list (strict <, so equal distances stay in index
//   order within a slice). The lanes then merge their lists by warp
//   shuffles (xor 1, 2, 4), ordering candidates by (d, index): the three
//   smallest (d, index) pairs of the union are what one scan of all the
//   knowns in index order keeps, ties included. A slice's tail past m, and
//   a tile's last chunk, are padded with knowns at infinity, which never
//   enter a list.
// - Each slice's part of a tile starts one float4 past a multiple of 8, so
//   the S lanes reading one known each hit S different groups of 4 banks.
// Measured and dropped (PERF.md §6): U = 2 or 4 unknowns a thread,
// which halve or quarter the loads a pair but leave fewer warps to cover
// the insertions' branches, were slower at every FP shape; 128 and 512
// threads a block, chunks of 4 and 16, and the knowns as three planes of
// floats were no faster.
// The cloud is blockIdx.y, looped over when b exceeds the grid's 65,535, so
// any batch is taken.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // knowns staged at once, over all slices
constexpr int kChunk = 8;    // knowns whose distances are screened together
constexpr int kMaxGridY = 65535;

// the scan's insertion: strict <, so an equal distance keeps the earlier known
__device__ __forceinline__ void insert(float d, int k, float& d0, float& d1, float& d2, int& i0,
                                       int& i1, int& i2) {
  if (d < d2) {
    if (d < d1) {
      d2 = d1;
      i2 = i1;
      if (d < d0) {
        d1 = d0;
        i1 = i0;
        d0 = d;
        i0 = k;
      } else {
        d1 = d;
        i1 = k;
      }
    } else {
      d2 = d;
      i2 = k;
    }
  }
}

// (d, k) before (e, j): the order of one scan in index order
__device__ __forceinline__ bool before(float d, int k, float e, int j) {
  return d < e || (d == e && k < j);
}

// the merge's insertion of another slice's candidate, ordered by (d, index)
__device__ __forceinline__ void insert_merge(float d, int k, float& d0, float& d1, float& d2,
                                             int& i0, int& i1, int& i2) {
  if (before(d, k, d2, i2)) {
    if (before(d, k, d1, i1)) {
      d2 = d1;
      i2 = i1;
      if (before(d, k, d0, i0)) {
        d1 = d0;
        i1 = i0;
        d0 = d;
        i0 = k;
      } else {
        d1 = d;
        i1 = k;
      }
    } else {
      d2 = d;
      i2 = k;
    }
  }
}

// Lane s of each group of S neighbouring lanes scans slice s of the knowns
// for its unknown; see the file's header.
template <int S>
__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int b,
                    int n, int m, float* __restrict__ dist, int* __restrict__ idx) {
  constexpr int kPart = kTile / S;  // knowns of a slice in a tile
  __shared__ float4 sk[S * (kPart + 1)];
  const int s = threadIdx.x % S;
  const long long q = (long long)blockIdx.x * (kThreads / S) + threadIdx.x / S;
  const int per_slice = (m + S - 1) / S;
  const float4* mine = sk + s * (kPart + 1);
  for (long long bt = blockIdx.y; bt < b; bt += gridDim.y) {
    const float* kb = known + bt * m * 3;
    const float* p = unknown + (bt * n + min(q, (long long)n - 1)) * 3;
    const float ux = p[0], uy = p[1], uz = p[2];
    float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
    int i0 = 0, i1 = 0, i2 = 0;
    for (int t0 = 0; t0 < per_slice; t0 += kPart) {
      const int len = min(kPart, per_slice - t0);
      __syncthreads();  // the previous tile (or cloud) is consumed
      for (int e = threadIdx.x; e < S * kPart; e += kThreads) {
        const int sl = e / kPart;
        const int j = e - sl * kPart;
        if (j < len + kChunk - 1) {  // the last chunk of a tile padded
          const int k = sl * per_slice + t0 + j;
          sk[sl * (kPart + 1) + j] =
              j < len && k < m ? make_float4(kb[3 * k], kb[3 * k + 1], kb[3 * k + 2], 0.0f)
                               : make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
        }
      }
      __syncthreads();
      const int base = s * per_slice + t0;
      for (int j0 = 0; j0 < len; j0 += kChunk) {
        float dd[kChunk];
        float least = INFINITY;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kv = mine[j0 + jj];
          const float dx = ux - kv.x;
          const float dy = uy - kv.y;
          const float dz = uz - kv.z;
          dd[jj] = (dx * dx + dy * dy) + dz * dz;
          least = fminf(least, dd[jj]);
        }
        if (least < d2) {
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj)
            insert(dd[jj], base + j0 + jj, d0, d1, d2, i0, i1, i2);
        }
      }
    }
    // merge the S slices' lists: after the step of xor `off`, each lane holds
    // the merge of its 2 * off neighbours' slices
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
      const float e0 = __shfl_xor_sync(0xffffffffu, d0, off);
      const float e1 = __shfl_xor_sync(0xffffffffu, d1, off);
      const float e2 = __shfl_xor_sync(0xffffffffu, d2, off);
      const int j0 = __shfl_xor_sync(0xffffffffu, i0, off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1, off);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2, off);
      insert_merge(e0, j0, d0, d1, d2, i0, i1, i2);
      insert_merge(e1, j1, d0, d1, d2, i0, i1, i2);
      insert_merge(e2, j2, d0, d1, d2, i0, i1, i2);
    }
    if (s == 0 && q < n) {
      const long long o = (bt * n + q) * 3;
      dist[o] = d0;
      dist[o + 1] = d1;
      dist[o + 2] = d2;
      idx[o] = i0;
      idx[o + 1] = i1;
      idx[o + 2] = i2;
    }
  }
}

template <int S>
cudaError_t launch(const float* unknown, const float* known, float* dist, int* idx, int b, int n,
                   int m, cudaStream_t stream) {
  constexpr int per_block = kThreads / S;
  dim3 grid((n + per_block - 1) / per_block, b < kMaxGridY ? b : kMaxGridY);
  three_nn_kernel<S><<<grid, kThreads, 0, stream>>>(unknown, known, b, n, m, dist, idx);
  return cudaGetLastError();
}

}  // namespace

// unknown: f32 [b, n, 3]; known: f32 [b, m, 3], m >= 3; dist: f32 [b, n, 3];
// idx: i32 [b, n, 3]. All contiguous. The knowns in s slices (1, 2, 4 or
// 8): ops/interpolate.py `three_nn_slices`.
extern "C" int ssd3d_three_nn(const float* unknown, const float* known, float* dist, int* idx,
                              int b, int n, int m, int s, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m < 3) return (int)cudaErrorInvalidValue;
  switch (s) {
    case 1: return (int)launch<1>(unknown, known, dist, idx, b, n, m, stream);
    case 2: return (int)launch<2>(unknown, known, dist, idx, b, n, m, stream);
    case 4: return (int)launch<4>(unknown, known, dist, idx, b, n, m, stream);
    case 8: return (int)launch<8>(unknown, known, dist, idx, b, n, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared helpers for the ssd3d_torch kernels.
//
// Every file is compiled with -fmad=false: the plain PyTorch versions round
// each operation as written, and with FMA contraction a squared distance
// would differ in the last bit, which changes ring membership at the radius
// boundaries and flips FPS ties. Where the plain version's chain has a fused
// multiply-add (K1's squared distance), the kernel calls __fmaf_rn.
#pragma once

#include <cuda_runtime.h>

namespace ssd3d {

// "larger distance wins; equal distance -> smaller index": the argmax tie rule
// of jnp.argmax / torch.argmax (first maximal index)
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od = __shfl_xor_sync(0xffffffffu, d, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Block-wide argmax over (d, i) with the tie rule above. Every thread of the
// block calls it; the winner index is returned to all of them. s_d / s_i hold
// one slot per warp, s_win one int. Two barriers: the first publishes the
// per-warp winners, the second the block winner (and protects the per-warp
// slots from the next call's writes).
__device__ __forceinline__ int block_argmax(float d, int i, float* s_d, int* s_i,
                                            int* s_win) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_argmax(d, i);
  if (lane == 0) {
    s_d[warp] = d;
    s_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    float wd = lane < nwarps ? s_d[lane] : -1.0f;
    int wi = lane < nwarps ? s_i[lane] : 0x7fffffff;
    warp_argmax(wd, wi);
    if (lane == 0) *s_win = wi;
  }
  __syncthreads();
  return *s_win;
}

}  // namespace ssd3d

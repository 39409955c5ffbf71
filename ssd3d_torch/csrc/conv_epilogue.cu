// K10: the epilogue of an eval-mode PointConv (bias, folded BatchNorm, ReLU,
// cast) and, on its pool route, the max over each ball's samples times the
// scale's has-points mask.
//
// Replaces no Pallas kernel: the JAX package leaves the conv + BatchNorm +
// ReLU of ssd3d/nn/layers.py:133 (PointConv.__call__) to XLA, which fuses the
// bias, the affine, the ReLU and the casts into one pass inside its jitted
// forward. The port ran them as eager PyTorch ops, one pass over the
// [b, m, ns, c] activation each: + bias in the compute dtype, .float(),
// * inv, + shift, relu, the next layer's cast, and after a scale's last layer
// amax over the samples and the has-points multiply; about 42 bytes moved an
// output element. This kernel is one pass, right after the product.
//
// What bounds it on the H100: bytes. It reads y once and writes the output
// once: 4 bytes an element in bf16 on the rows route, 2 + 4 / ns on the pool
// route, against the eager chain's ~42. The [c] vectors stay in registers.
//
// Contract: y [rows, c] in the compute dtype (f32 or bf16: the product
// x @ kernel), the conv bias and BatchNorm's folded inv and shift (f32 [c];
// inv = rsqrt(var + eps) * scale, shift = bias - mean * inv, computed by
// torch ops in `PointConv`) ->
// - rows route: out [rows, c], f32 or y's dtype (the next layer's compute
//   dtype): relu(f32(round_cd(y + round_cd(bias))) * inv + shift);
// - pool route: out f32 [rows / ns, c], the max of those over each group of
//   ns consecutive rows (a ball's samples), times has[g] where given.
// Each operation rounds where the eager chain rounds: the bias add in f32,
// then round-to-nearest-even to bf16 (PyTorch's bf16 add); the multiply and
// the add in f32 apart (__fmul_rn, __fadd_rn; the library builds with
// -fmad=false); the ReLU as torch.relu's clamp_min (NaN kept, else fmaxf);
// the max as amax's (NaN propagates); the mask an f32 multiply. So the output
// equals the eager chain's bit for bit.
//
// Design: a thread owns one 16-byte vector of a row's channels (8 bf16 or 4
// f32; one element where c or a pointer does not allow 16 bytes), so a row
// of c channels takes c / 8 threads in bf16 and a block of 256 threads
// covers 256 / (c / 8) rows at once: 128 of SA1's 16-wide rows, 2 of CG
// layer4's 1,024-wide ones; rows wider than 256 vectors loop over their
// vectors. The thread loads its channels' bias, inv and shift once, then
// strides over the rows (pool: the groups) with a grid of 8 blocks an SM,
// four rows' loads in flight before their stores. No atomics, no shared
// memory, no host sync.
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kInFlight = 4;  // rows loaded before the first is stored

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// one output element before the pool: the bias added in the compute dtype T
// (f32, then rounded to T), then * inv, + shift and the ReLU in f32
template <typename T>
__device__ __forceinline__ float epilogue(T y, float b, float inv, float shift) {
  const float t = widen(narrow<T>(__fadd_rn(widen(y), b)));
  const float v = __fadd_rn(__fmul_rn(t, inv), shift);
  return isnan(v) ? v : fmaxf(v, 0.0f);  // torch.relu: clamp_min(v, 0)
}

// amax's step: a NaN wins
__device__ __forceinline__ float max_nan(float m, float v) { return (v > m || isnan(v)) ? v : m; }

// V elements of T, moved as one access (16 bytes where V * sizeof(T) >= 16)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

// the channels' bias (rounded to the compute dtype T), inv and shift of
// vector j
template <typename T, int V>
__device__ __forceinline__ void load_params(const float* __restrict__ bias,
                                            const float* __restrict__ inv,
                                            const float* __restrict__ shift, int j, float* b,
                                            float* s, float* h) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    b[k] = widen(narrow<T>(bias[j * V + k]));
    s[k] = inv[j * V + k];
    h[k] = shift[j * V + k];
  }
}

// cv: vectors a row; tpr: threads a row (cv, at most kThreads)
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
    epilogue_rows_kernel(const Tin* __restrict__ y, const float* __restrict__ bias,
                         const float* __restrict__ inv, const float* __restrict__ shift,
                         Tout* __restrict__ out, long long rows, int cv, int tpr) {
  const int per_block = kThreads / tpr;
  const int sub = threadIdx.x / tpr;
  if (sub >= per_block) return;
  const long long step = (long long)gridDim.x * per_block;
  const Pack<Tin, V>* yv = reinterpret_cast<const Pack<Tin, V>*>(y);
  Pack<Tout, V>* ov = reinterpret_cast<Pack<Tout, V>*>(out);
  for (int j = threadIdx.x % tpr; j < cv; j += tpr) {
    float b[V], s[V], h[V];
    load_params<Tin, V>(bias, inv, shift, j, b, s, h);
    for (long long r0 = (long long)blockIdx.x * per_block + sub; r0 < rows;
         r0 += step * kInFlight) {
      Pack<Tin, V> in[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long r = r0 + u * step;
        if (r < rows) in[u] = yv[r * cv + j];
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long r = r0 + u * step;
        if (r < rows) {
          Pack<Tout, V> o;
#pragma unroll
          for (int k = 0; k < V; ++k) o.v[k] = narrow<Tout>(epilogue(in[u].v[k], b[k], s[k], h[k]));
          ov[r * cv + j] = o;
        }
      }
    }
  }
}

// groups of ns consecutive rows -> one f32 row each, times has[g] (has may
// be null)
template <typename Tin, int V>
__global__ void __launch_bounds__(kThreads)
    epilogue_pool_kernel(const Tin* __restrict__ y, const float* __restrict__ bias,
                         const float* __restrict__ inv, const float* __restrict__ shift,
                         const int* __restrict__ has, float* __restrict__ out, long long groups,
                         int ns, int cv, int tpr) {
  const int per_block = kThreads / tpr;
  const int sub = threadIdx.x / tpr;
  if (sub >= per_block) return;
  const long long step = (long long)gridDim.x * per_block;
  const Pack<Tin, V>* yv = reinterpret_cast<const Pack<Tin, V>*>(y);
  Pack<float, V>* ov = reinterpret_cast<Pack<float, V>*>(out);
  for (int j = threadIdx.x % tpr; j < cv; j += tpr) {
    float b[V], s[V], h[V];
    load_params<Tin, V>(bias, inv, shift, j, b, s, h);
    for (long long g = (long long)blockIdx.x * per_block + sub; g < groups; g += step) {
      const Pack<Tin, V>* row = yv + g * ns * cv + j;
      float m[V];
#pragma unroll
      for (int k = 0; k < V; ++k) m[k] = -INFINITY;
      int i = 0;
      for (; i + kInFlight <= ns; i += kInFlight) {
        Pack<Tin, V> in[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) in[u] = row[(long long)(i + u) * cv];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k) m[k] = max_nan(m[k], epilogue(in[u].v[k], b[k], s[k], h[k]));
      }
      for (; i < ns; ++i) {
        const Pack<Tin, V> in = row[(long long)i * cv];
#pragma unroll
        for (int k = 0; k < V; ++k) m[k] = max_nan(m[k], epilogue(in.v[k], b[k], s[k], h[k]));
      }
      Pack<float, V> o;
      const float w = has != nullptr ? (float)has[g] : 1.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = has != nullptr ? __fmul_rn(m[k], w) : m[k];
      ov[g * cv + j] = o;
    }
  }
}

// blocks for `items` rows (or groups) of cv vectors: enough for every item
// at once, at most kBlocksPerSm an SM
int grid_for(long long items, int cv, int sms, int* tpr) {
  *tpr = cv < kThreads ? cv : kThreads;
  const int per_block = kThreads / *tpr;
  const long long want = (items + per_block - 1) / per_block;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(want < most ? want : most);
}

template <typename Tin, typename Tout, int V>
cudaError_t launch_rows(const void* y, const float* bias, const float* inv, const float* shift,
                        void* out, long long rows, int c, int sms, cudaStream_t stream) {
  int tpr;
  const int grid = grid_for(rows, c / V, sms, &tpr);
  epilogue_rows_kernel<Tin, Tout, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(y), bias, inv, shift, static_cast<Tout*>(out), rows, c / V, tpr);
  return cudaGetLastError();
}

template <typename Tin, int V>
cudaError_t launch_pool(const void* y, const float* bias, const float* inv, const float* shift,
                        const int* has, void* out, long long groups, int ns, int c, int sms,
                        cudaStream_t stream) {
  int tpr;
  const int grid = grid_for(groups, c / V, sms, &tpr);
  epilogue_pool_kernel<Tin, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(y), bias, inv, shift, has, static_cast<float*>(out), groups, ns,
      c / V, tpr);
  return cudaGetLastError();
}

}  // namespace

// y: [rows, c] f32 (in_bf16 0) or bf16 (1); bias, inv, shift: f32 [c]; has:
// i32 [rows / ns] or null; ns: 0 for the rows route (out [rows, c], bf16
// where out_bf16, which needs a bf16 y), else the pool route's group (out f32
// [rows / ns, c]); sms: the card's SM count.
extern "C" int ssd3d_conv_epilogue(const void* y, const float* bias, const float* inv,
                                   const float* shift, const int* has, void* out, long long rows,
                                   int ns, int c, int in_bf16, int out_bf16, int sms,
                                   cudaStream_t stream) {
  if (rows <= 0 || c <= 0 || ns < 0 || sms <= 0 || (out_bf16 && (!in_bf16 || ns > 0)) ||
      (ns > 0 && rows % ns != 0))
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (ns > 0) {
    const long long groups = rows / ns;
    if (in_bf16)
      return (int)(aligned && c % 8 == 0
                       ? launch_pool<bf16, 8>(y, bias, inv, shift, has, out, groups, ns, c, sms,
                                              stream)
                       : launch_pool<bf16, 1>(y, bias, inv, shift, has, out, groups, ns, c, sms,
                                              stream));
    return (int)(aligned && c % 4 == 0
                     ? launch_pool<float, 4>(y, bias, inv, shift, has, out, groups, ns, c, sms,
                                             stream)
                     : launch_pool<float, 1>(y, bias, inv, shift, has, out, groups, ns, c, sms,
                                             stream));
  }
  if (!in_bf16)
    return (int)(aligned && c % 4 == 0
                     ? launch_rows<float, float, 4>(y, bias, inv, shift, out, rows, c, sms, stream)
                     : launch_rows<float, float, 1>(y, bias, inv, shift, out, rows, c, sms,
                                                    stream));
  const bool vec = aligned && c % 8 == 0;
  if (out_bf16)
    return (int)(vec ? launch_rows<bf16, bf16, 8>(y, bias, inv, shift, out, rows, c, sms, stream)
                     : launch_rows<bf16, bf16, 1>(y, bias, inv, shift, out, rows, c, sms, stream));
  return (int)(vec ? launch_rows<bf16, float, 8>(y, bias, inv, shift, out, rows, c, sms, stream)
                   : launch_rows<bf16, float, 1>(y, bias, inv, shift, out, rows, c, sms, stream));
}

// K7: fused set abstraction, one launch per SA layer: for every radius scale
// the gather of each centre's ball, the centre subtraction, the folded
// conv + BatchNorm + ReLU chain and the masked max-pool, then the optional
// aggregation layer. Only the pooled [b, m, c_out] result reaches device
// memory; the grouped [b, m, ns, c] tensors of the unfused route never exist.
//
// Replaces the Pallas kernels ssd3d/ops/pallas/sa_fused.py:_kernel_multi (via
// _sa_multi_raw / sa_fused_multi, every scale of a layer) and :_kernel (via
// _sa_fused_raw / sa_fused_pallas, one scale, unmasked: R = 1 with a mask of
// ones). Each layer is relu((x . W + b) * inv + shift) in f32, with BatchNorm
// folded to inv = rsqrt(var + eps) * scale, shift = bias - mean * inv. The
// dot sums the input channels in order with fmaf (the build's -fmad=false
// leaves explicit fmaf fused); the plain version's matmul sums in cuBLAS's or
// the CPU BLAS's order, so the two agree to f32 rounding, not bit for bit.
// The TPU's single bf16 pass for f32 dots is not carried over.
//
// What bounds it on the H100: operations. PointRCNN's RCNN SA1 at batch 4 is
// 400 clouds x 128 centres x 64 samples x 2 x 65,920 weights = 432 GFLOP,
// 6.4 ms at 67 TFLOP/s of f32 outside the tensor cores; its bytes (the
// pooled cloud once, 0.25 GB) take 0.08 ms. The design is a register-tiled
// f32 GEMM per block, not yet tensor cores (TF32 or bf16 wgmma is later work).
//
// Design: one block of 256 threads per (cloud, tile of TM centres), TM =
// 128 / max(ns), so a block always owns 128 rows (TM x ns samples). The
// tile's rows are gathered (one warp per row, coalesced along channels) into
// shared buffer A; layers ping-pong between A and B (row strides padded to
// an odd number of words, so the two rows a warp reads fall in different
// banks). Each thread keeps an 8 x 8 tile of outputs in registers (rows
// ty + 16 i, columns tx + 16 j), columns in passes of 128; the weights come
// through shared memory 16 input channels at a time. At SA1 (ns 64, 259
// channels in) A and B take 198 KB, so one block runs per SM; the block opts
// in to that much shared memory with cudaFuncSetAttribute. Pooled scales are
// concatenated in shared memory and go through the aggregation layer there.
#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "sa_fused.cuh"

namespace {

using namespace k7;

constexpr int kThreads = 256;
constexpr int kMaxEntries = kMaxScales * kMaxLayers + 1;  // + aggregation

struct SaSpec {
  int R, cp, tm, sa, sb, sum_c, has_agg;
  int ns[kMaxScales];
  int nl[kMaxScales];
  const int* idx[kMaxScales];
  int ci[kMaxEntries];
  int co[kMaxEntries];
  long long off[kMaxEntries];  // W [ci, co], then bias, inv, shift [co] each
};

// Y[r, :co] = relu((X[r, :ci] . W + bias) * inv + shift) for r < rows
__device__ void dense_layer(const float* X, int sx, int ci, float* Y, int sy, int co, int rows,
                            const float* __restrict__ W, float* sW) {
  const float* bias = W + (size_t)ci * co;
  const float* inv = bias + co;
  const float* shift = inv + co;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int col0 = 0; col0 < co; col0 += kCols) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < ci; k0 += kKC) {
      const int kl = min(kKC, ci - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < kKC * kCols; e += kThreads) {
        const int kk = e / kCols, o = col0 + e % kCols;
        sW[e] = (kk < kl && o < co) ? W[(size_t)(k0 + kk) * co + o] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kl; ++kk) {
        float xv[8], wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = X[(ty + 16 * i) * sx + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = sW[kk * kCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = col0 + tx + 16 * j;
      if (o < co) {
        const float bb = bias[o], iv = inv[o], sh = shift[o];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 16 * i;
          if (r < rows) Y[r * sy + o] = fmaxf((acc[i][j] + bb) * iv + sh, 0.0f);
        }
      }
    }
  }
  __syncthreads();  // Y is complete; X may be overwritten
}

__global__ void __launch_bounds__(kThreads)
    sa_fused_kernel(const float* __restrict__ src, const float* __restrict__ centers,
                    const float* __restrict__ masks, const float* __restrict__ params,
                    float* __restrict__ out, int n, int m, SaSpec sp) {
  extern __shared__ float smem[];
  float* bufA = smem;
  float* bufB = bufA + kRows * sp.sa;
  float* sW = bufB + kRows * sp.sb;
  float* feat = sW + kKC * kCols;  // [tm, sum_c]
  const int tiles = (m + sp.tm - 1) / sp.tm;
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * sp.tm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cf = sp.cp - 3;

  int entry = 0, off_c = 0;
  for (int k = 0; k < sp.R; ++k) {
    const int ns = sp.ns[k];
    const int rows = sp.tm * ns;
    // gather the tile's balls (features, then xyz minus the centre) into A
    for (int rr = warp; rr < rows; rr += kThreads / 32) {
      const int j = min(j0 + rr / ns, m - 1);
      int r = sp.idx[k][((size_t)b * m + j) * ns + rr % ns];
      r = min(max(r, 0), n - 1);
      const float* row = src + ((size_t)b * n + r) * sp.cp;
      const float* ctr = centers + ((size_t)b * m + j) * 3;
      for (int c = lane; c < sp.cp; c += 32) {
        const float v = row[c];
        bufA[rr * sp.sa + c] = c < cf ? v : v - ctr[c - cf];
      }
    }
    __syncthreads();
    float* x = bufA;
    float* y = bufB;
    int sx = sp.sa, sy = sp.sb, ci = sp.cp;
    for (int l = 0; l < sp.nl[k]; ++l, ++entry) {
      dense_layer(x, sx, ci, y, sy, sp.co[entry], rows, params + sp.off[entry], sW);
      ci = sp.co[entry];
      float* t = x;
      x = y;
      y = t;
      const int ts = sx;
      sx = sy;
      sy = ts;
    }
    // max over each centre's samples, times the scale's has-points mask
    for (int e = threadIdx.x; e < sp.tm * ci; e += kThreads) {
      const int t = e / ci, o = e % ci;
      const float* col = x + (t * ns) * sx + o;
      float mx = col[0];
      for (int s = 1; s < ns; ++s) mx = fmaxf(mx, col[s * sx]);
      const int j = min(j0 + t, m - 1);
      feat[t * sp.sum_c + off_c + o] = mx * masks[((size_t)b * m + j) * sp.R + k];
    }
    off_c += ci;
    __syncthreads();  // feat is complete; A may be overwritten by the next scale
  }

  const int c_out = sp.has_agg ? sp.co[entry] : sp.sum_c;
  for (int e = threadIdx.x; e < sp.tm * c_out; e += kThreads) {
    const int t = e / c_out, o = e % c_out;
    if (j0 + t >= m) continue;
    float v;
    if (sp.has_agg) {
      const float* W = params + sp.off[entry];
      const float* bias = W + (size_t)sp.sum_c * c_out;
      float acc = 0.0f;
      for (int c = 0; c < sp.sum_c; ++c) acc = fmaf(feat[t * sp.sum_c + c], W[(size_t)c * c_out + o], acc);
      v = fmaxf((acc + bias[o]) * bias[c_out + o] + bias[2 * c_out + o], 0.0f);
    } else {
      v = feat[t * sp.sum_c + o];
    }
    out[((size_t)b * m + j0 + t) * c_out + o] = v;
  }
}

int odd(int c) { return c | 1; }

}  // namespace

// src: f32 [b, n, cp] (features, then xyz); centers: f32 [b, m, 3]; masks: f32
// [b, m, R]; idx[k]: i32 [b, m, ns[k]]; params: f32, per layer entry e (the
// scales' layers in order, then the aggregation layer if has_agg) W [ci, co],
// bias, inv, shift at off[e]; out: f32 [b, m, c_out]. ns, nl, idx, ci, co and
// off are host arrays. Every ns divides 128.
extern "C" int ssd3d_sa_fused(const float* src, const float* centers, const float* masks,
                              const float* params, float* out, int b, int n, int m, int cp, int R,
                              const int* ns, const int* nl, const void* const* idx, int has_agg,
                              const int* ci, const int* co, const long long* off,
                              cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0 || cp < 3 || R < 1 || R > kMaxScales)
    return (int)cudaErrorInvalidValue;
  SaSpec sp{};
  sp.R = R;
  sp.cp = cp;
  sp.has_agg = has_agg;
  int max_ns = 0, entries = 0, sa = cp, sb = 1;
  for (int k = 0; k < R; ++k) {
    if (ns[k] < 1 || kRows % ns[k] != 0 || nl[k] < 1 || nl[k] > kMaxLayers)
      return (int)cudaErrorInvalidValue;
    max_ns = std::max(max_ns, ns[k]);
    sp.ns[k] = ns[k];
    sp.nl[k] = nl[k];
    sp.idx[k] = static_cast<const int*>(idx[k]);
    int c = cp;
    for (int l = 0; l < nl[k]; ++l, ++entries) {
      if (ci[entries] != c || co[entries] < 1) return (int)cudaErrorInvalidValue;
      c = co[entries];
      if (l % 2 == 0) sb = std::max(sb, c);  // even layers write B, odd ones A
      else sa = std::max(sa, c);
    }
    sp.sum_c += c;
  }
  if (has_agg && ci[entries] != sp.sum_c) return (int)cudaErrorInvalidValue;
  for (int e = 0; e < entries + (has_agg ? 1 : 0); ++e) {
    sp.ci[e] = ci[e];
    sp.co[e] = co[e];
    sp.off[e] = off[e];
  }
  sp.tm = kRows / max_ns;
  sp.sa = odd(sa);
  sp.sb = odd(sb);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (sp.sa + sp.sb) + kKC * kCols + (size_t)sp.tm * sp.sum_c);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)b * ((m + sp.tm - 1) / sp.tm);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(sa_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_fused_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(src, centers, masks, params, out,
                                                                n, m, sp);
  return (int)cudaGetLastError();
}

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
// TPU's single bf16 pass for f32 dots is not carried over.
//
// What bounds it on the H100: operations. PointRCNN's RCNN SA1 at batch 4 is
// 400 clouds x 128 centres x 64 samples x 2 x 65,920 weights = 432 GFLOP:
// 6.4 ms at 67 TFLOP/s of f32 outside the tensor cores, or, as the three
// TF32 products below, 1,296 TF32 GFLOP, 2.6 ms at 495 TFLOP/s. Its bytes
// (the pooled cloud once, 0.25 GB) take 0.08 ms.
//
// Two routes, chosen by the wrapper from the shape (ops/sa_fused.py
// `sa_fused_route`); both give one block 128 rows (128 / max(ns) whole
// balls, so every ns divides 128) and 256 threads.
//
// - Tensor-core route (every layer of a scale at most 256 wide): 3xTF32 on
//   Hopper's wgmma. Each f32 operand x is split into big = x with its low 13
//   mantissa bits cleared (a TF32 value) and small = the same truncation of
//   x - big; a dot is big.big + big.small + small.big, accumulated in f32,
//   which keeps f32-grade error (the missing small.small term is 2^-22 of a
//   product). The rows are gathered with 4-byte cp.async (a row of 259 floats
//   is not 16-byte aligned; TMA cannot gather rows) into one shared tile, row
//   stride = 8 (mod 32) words; a warp loads its 16 rows' indices and xyz in
//   batches, so the gather waits on one round trip, not one a row. Each of the
//   two warpgroups owns 64 rows: per 8 input channels every thread loads its A
//   fragment (rows g and g + 8, channels 2t and 2t + 1 as two float2) from the
//   tile, splits it in registers and issues wgmma.m64n128k8 with A in
//   registers, once per term and per 128 output columns. The weights come
//   through a ring of five 16 KB stages, each holding one chunk of input
//   channels of W^T as big and small in the no-swizzle K-major core-matrix
//   layout the descriptor names; the wrapper writes them so once per call,
//   with each block of 8 input channels in the order the A fragments load them
//   (0, 2, 4, 6, 1, 3, 5, 7). Thread 0 keeps the ring three chunks ahead with
//   TMA bulk copies, each stage guarded by a "full" mbarrier (the bytes
//   landed) and an "empty" one (all 8 warps are done with it), so no block
//   barrier stands between chunks. A warpgroup retires a chunk's wgmmas only
//   after it has issued the next chunk's (two sets of A fragments in turn), so
//   its tensor-core queue does not drain at chunk boundaries. The accumulators
//   stay in registers (64 or 128 a thread); the epilogue applies the folded
//   BatchNorm and ReLU and writes the layer's output over its own rows of the
//   tile, which the next layer reads. The max-pool reads the tile.
// - FMA route (the first design, for the wider layers the tensor-core route
//   does not take): a register-tiled f32 GEMM. The tile's rows go into
//   shared buffer A (one warp per row); layers ping-pong between A and B (row
//   strides padded to an odd number of words). Each thread keeps an 8 x 8
//   tile of outputs in registers, columns in passes of 128; the weights come
//   through shared memory 16 input channels at a time. The dot sums the
//   input channels in order with fmaf (the build's -fmad=false leaves
//   explicit fmaf fused).
//
// Either route agrees with the plain version (cuBLAS's or the CPU BLAS's
// f32 order) to f32 rounding, not bit for bit. Pooled scales are
// concatenated in shared memory and go through the aggregation layer there,
// in f32 fmaf (a few rows a block).
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sa_fused.cuh"

namespace {

using namespace k7;

constexpr int kThreads = 256;
constexpr int kMaxEntries = kMaxScales * kMaxLayers + 1;  // + aggregation
constexpr int kCore = 32;                 // floats of a core matrix: 8 rows x 16 bytes
constexpr int kSlab = kCols / 8 * kCore;  // floats of 4 input channels x 128 columns
constexpr int kAhead = kTcStages - 2;     // chunks the ring's producer runs ahead

struct SaSpec {
  int R, cp, tm, sum_c, has_agg, layers;
  int sa, sb;         // FMA route: the two row buffers' strides
  int kp0, stride;    // tensor-core route: the gathered K (cp padded to 8), the tile's stride
  int ns[kMaxScales];
  int nl[kMaxScales];
  const int* idx[kMaxScales];
  int ci[kMaxEntries];
  int co[kMaxEntries];
  int kp[kMaxEntries];         // tensor-core route: ci padded to a multiple of 8
  int np[kMaxEntries];         // tensor-core route: passes of kCols columns
  long long off[kMaxEntries];  // W [ci, co], bias, inv, shift; tensor-core route: staged W
  long long eoff[kMaxEntries]; // tensor-core route: bias, inv, shift, np * kCols each
};

// The pooled scales [tm, sum_c] through the aggregation layer (if any) to
// out[b, j0 + t, :] for the tile's centres.
__device__ __forceinline__ void store_pooled(const SaSpec& sp, const float* feat,
                                             const float* __restrict__ params,
                             float* __restrict__ out, int b, int m, int j0, int entry) {
  const int c_out = sp.has_agg ? sp.co[entry] : sp.sum_c;
  for (int e = threadIdx.x; e < sp.tm * c_out; e += kThreads) {
    const int t = e / c_out, o = e % c_out;
    if (j0 + t >= m) continue;
    float v;
    if (sp.has_agg) {
      const float* W = params + sp.off[entry];
      const float* bias = W + (size_t)sp.sum_c * c_out;
      float acc = 0.0f;
      for (int c = 0; c < sp.sum_c; ++c)
        acc = fmaf(feat[t * sp.sum_c + c], W[(size_t)c * c_out + o], acc);
      v = fmaxf((acc + bias[o]) * bias[c_out + o] + bias[2 * c_out + o], 0.0f);
    } else {
      v = feat[t * sp.sum_c + o];
    }
    out[((size_t)b * m + j0 + t) * c_out + o] = v;
  }
}

// Max over each centre's ns rows of the tile (row stride s, ci columns),
// times the scale's has-points mask, into feat[:, off_c:].
__device__ __forceinline__ void pool_scale(const SaSpec& sp, const float* x, int s, int ci, int k,
                           const float* __restrict__ masks, float* feat, int off_c, int b, int m,
                           int j0) {
  const int ns = sp.ns[k];
  for (int e = threadIdx.x; e < sp.tm * ci; e += kThreads) {
    const int t = e / ci, o = e % ci;
    const float* col = x + (t * ns) * s + o;
    float mx = col[0];
#pragma unroll 8
    for (int q = 1; q < ns; ++q) mx = fmaxf(mx, col[q * s]);
    const int j = min(j0 + t, m - 1);
    feat[t * sp.sum_c + off_c + o] = mx * masks[((size_t)b * m + j) * sp.R + k];
  }
}

// ------------------------------------------------------- FMA route

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
    sa_fused_fma_kernel(const float* __restrict__ src, const float* __restrict__ centers,
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
    pool_scale(sp, x, sx, ci, k, masks, feat, off_c, b, m, j0);
    off_c += ci;
    __syncthreads();  // feat is complete; A may be overwritten by the next scale
  }

  store_pooled(sp, feat, params, out, b, m, j0, entry);
}

// ------------------------------------------------ tensor-core route

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` from global memory into shared memory by the TMA engine, counted
// on bar, which is told to expect them
__device__ __forceinline__ void tma_load(float* dst, const float* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// x with the low 13 mantissa bits cleared: a TF32 value
__device__ __forceinline__ uint32_t tf32_trunc(float x) { return __float_as_uint(x) & 0xffffe000u; }

// A no-swizzle K-major operand: core matrices of 8 columns x 4 input
// channels (128 bytes); the two along K kSlab floats apart (LBO), those along
// N kCore floats apart (SBO).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | ((uint64_t)(kSlab * 4 / 16) << 16) |
         ((uint64_t)(kCore * 4 / 16) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the compiler may not move reads of d above the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 rows x 128 columns] += A (registers, 64 x 8) . B (shared, 8 x 128)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// input channels a weight chunk holds for a layer of np column passes
__device__ __forceinline__ int chunk_k(int np) { return kTcStage / (2 * np * kCols); }

// Scale k's balls of the tile into its rows: features by 4-byte cp.async
// (a row of 259 floats is not 16-byte aligned), xyz minus the centre and
// zeros up to kp0 by plain stores; rows past tm * ns all zeros. A warp's 16
// rows take their indices in one load (a lane a row) and their 48 xyz
// values in two, so no load waits on another.
__device__ __forceinline__ void gather_tile(const SaSpec& sp, int k, const float* __restrict__ src,
                                            const float* __restrict__ centers, float* tile, int b,
                                            int n, int m, int j0) {
  constexpr int kWarpRows = kRows / (kThreads / 32);  // 16, rows warp + 8 q
  const int ns = sp.ns[k], rows = sp.tm * ns, cf = sp.cp - 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rr_l = warp + (kThreads / 32) * (lane % kWarpRows);  // lane q's row
  const int j_l = min(j0 + rr_l / ns, m - 1);
  int r_l = 0;
  if (rr_l < rows) r_l = min(max(sp.idx[k][((size_t)b * m + j_l) * ns + rr_l % ns], 0), n - 1);
  float xyz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // value p = lane + 32 h: row p / 3, coordinate p % 3
    const int p = lane + 32 * h, q = p / 3, d = p % 3;
    const int r = __shfl_sync(0xffffffffu, r_l, q % kWarpRows);
    const int j = __shfl_sync(0xffffffffu, j_l, q % kWarpRows);
    xyz[h] = p < 3 * kWarpRows && warp + (kThreads / 32) * q < rows
                 ? src[((size_t)b * n + r) * sp.cp + cf + d] - centers[((size_t)b * m + j) * 3 + d]
                 : 0.0f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h, q = p / 3;
    if (p < 3 * kWarpRows) tile[(warp + (kThreads / 32) * q) * sp.stride + cf + p % 3] = xyz[h];
  }
  for (int q = 0; q < kWarpRows; ++q) {
    const int rr = warp + (kThreads / 32) * q;
    const int r = __shfl_sync(0xffffffffu, r_l, q);
    float* dst = tile + rr * sp.stride;
    if (rr >= rows) {
      for (int c = lane; c < sp.kp0; c += 32) dst[c] = 0.0f;
      continue;
    }
    const float* row = src + ((size_t)b * n + r) * sp.cp;
    for (int c = lane; c < cf; c += 32) cp_async4(dst + c, row + c);
    if (lane < sp.kp0 - sp.cp) dst[sp.cp + lane] = 0.0f;
  }
  cp_async_commit();
}

// Issues one weight chunk (NKB x 8 input channels from k0) into a
// warpgroup's NP x 128 accumulator columns and commits it as one wgmma
// group; rows r0 and r0 + 8 of the tile are this thread's. The A fragments
// go into hi and lo, which stay in use until the group is retired.
template <int NP, int NKB>
__device__ __forceinline__ void issue_chunk(float (&acc)[NP][64], uint32_t (&hi)[NKB][4],
                                            uint32_t (&lo)[NKB][4], const float* tile, int stride,
                                            int r0, int k0, const float* stage, int lane) {
  constexpr int kPart = NKB * 2 * kSlab;  // floats of one (big or small, pass) block
  const float* xr = tile + r0 * stride + k0 + 2 * (lane & 3);
#pragma unroll
  for (int kb = 0; kb < NKB; ++kb) {
    const float2 x = *reinterpret_cast<const float2*>(xr + 8 * kb);
    const float2 y = *reinterpret_cast<const float2*>(xr + 8 * stride + 8 * kb);
    // A columns t and t + 4 are channels 2t and 2t + 1 (the weights' order)
    const float v[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[kb][q] = tf32_trunc(v[q]);
      lo[kb][q] = tf32_trunc(v[q] - __uint_as_float(hi[kb][q]));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < NKB; ++kb) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float* big = stage + j * kPart + 2 * kb * kSlab;
      wgmma_tf32(acc[j], hi[kb], b_desc(big));
      wgmma_tf32(acc[j], hi[kb], b_desc(big + NP * kPart));
      wgmma_tf32(acc[j], lo[kb], b_desc(big));
    }
  }
  wgmma_commit();
}

// relu((acc + bias) * inv + shift) over this thread's rows of the tile,
// columns [0, NP * kCols) (zero past co: the padding's weights are zero)
template <int NP>
__device__ __forceinline__ void epilogue(const float (&acc)[NP][64], float* tile, int stride,
                                         int r0, const float* __restrict__ ep, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int i = 0; i < kCols / 8; ++i) {
      const int col = j * kCols + 8 * i + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(ep + col);
      const float2 iv = *reinterpret_cast<const float2*>(ep + NP * kCols + col);
      const float2 sh = *reinterpret_cast<const float2*>(ep + 2 * NP * kCols + col);
      const float* d = &acc[j][4 * i];
      *reinterpret_cast<float2*>(tile + r0 * stride + col) = make_float2(
          fmaxf((d[0] + bb.x) * iv.x + sh.x, 0.0f), fmaxf((d[1] + bb.y) * iv.y + sh.y, 0.0f));
      *reinterpret_cast<float2*>(tile + (r0 + 8) * stride + col) = make_float2(
          fmaxf((d[2] + bb.x) * iv.x + sh.x, 0.0f), fmaxf((d[3] + bb.y) * iv.y + sh.y, 0.0f));
    }
  }
}

// The weight ring: kTcStages stages, each with a "full" barrier (the TMA
// engine's bytes landed) and an "empty" one (all 8 warps are done with it).
// Chunks are numbered across the launch, entry by entry; chunk i lives in
// stage i % kTcStages, in that stage's (i / kTcStages)-th phase. Thread 0
// is the producer: ahead of consuming chunk i it starts chunk i + kAhead,
// whose stage chunk i - 2 freed, so it seldom waits and the two warpgroups
// wait for each other only through the ring.
struct Ring {
  float* stage;
  uint64_t* full;
  uint64_t* empty;
  int next = 0;      // the producer's next chunk
  int e = 0, c = 0;  // its entry and chunk within the entry
  int total = 0;

  __device__ void produce(const SaSpec& sp, const float* __restrict__ params) {
    const int s = next % kTcStages;
    if (next >= kTcStages) mbar_wait(&empty[s], (next / kTcStages - 1) & 1);
    const int kc = chunk_k(sp.np[e]);
    tma_load(stage + s * kTcStage, params + sp.off[e] + (long long)c * kTcStage,
             2 * sp.np[e] * min(kc, sp.kp[e] - c * kc) * kCols * 4, &full[s]);
    ++next;
    if (++c * kc >= sp.kp[e]) {
      ++e;
      c = 0;
    }
  }

  // chunk i's stage, once the producer has had its turn and the bytes landed
  __device__ const float* acquire(const SaSpec& sp, const float* __restrict__ params, int i) {
    if (threadIdx.x == 0 && next < total && next <= i + kAhead) produce(sp, params);
    __syncwarp();
    mbar_wait(&full[i % kTcStages], (i / kTcStages) & 1);
    return stage + (i % kTcStages) * kTcStage;
  }

  // this warp is done with chunk i's stage
  __device__ void release(int i, int lane) {
    if (lane == 0) mbar_arrive(&empty[i % kTcStages]);
  }
};

// One layer (entry) of NP column passes over the warpgroup's 64 rows of the
// tile, its weights through the ring from chunk i on. A chunk's wgmma group
// is retired only after the next one is issued (two sets of A fragments in
// turn), so the tensor cores are never left to drain between chunks. Then
// the epilogue writes the layer's output over the thread's rows (a warp
// reads and writes only its own 16 rows).
template <int NP>
__device__ __forceinline__ void tc_layer(const SaSpec& sp, const float* __restrict__ params,
                                         int entry, Ring& ring, int& i, float* tile, int r0,
                                         int lane) {
  constexpr int kc = kTcStage / (2 * NP * kCols), kNkb = kc / 8;
  float acc[NP][64];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[j][q] = 0.0f;
  uint32_t hi0[kNkb][4], lo0[kNkb][4], hi1[kNkb][4], lo1[kNkb][4];
  const int kp = sp.kp[entry];
  int k0 = 0;
  // full chunks two at a time: issue one, retire the one before it
  for (; k0 + 2 * kc <= kp; k0 += 2 * kc, i += 2) {
    issue_chunk<NP, kNkb>(acc, hi0, lo0, tile, sp.stride, r0, k0, ring.acquire(sp, params, i),
                          lane);
    if (k0 > 0) {
      wgmma_wait<1>();
      ring.release(i - 1, lane);
    }
    issue_chunk<NP, kNkb>(acc, hi1, lo1, tile, sp.stride, r0, k0 + kc,
                          ring.acquire(sp, params, i + 1), lane);
    wgmma_wait<1>();
    ring.release(i, lane);
  }
  if (k0 + kc <= kp) {  // one full chunk left
    issue_chunk<NP, kNkb>(acc, hi0, lo0, tile, sp.stride, r0, k0, ring.acquire(sp, params, i),
                          lane);
    if (k0 > 0) {
      wgmma_wait<1>();
      ring.release(i - 1, lane);
    }
    k0 += kc;
    ++i;
  }
  wgmma_wait<0>();
  if (k0 > 0) ring.release(i - 1, lane);
  if (k0 < kp) {  // a short last chunk: kp is a multiple of 8, not always of kc
    uint32_t hi[1][4], lo[1][4];
    issue_chunk<NP, 1>(acc, hi, lo, tile, sp.stride, r0, k0, ring.acquire(sp, params, i), lane);
    wgmma_wait<0>();
    ring.release(i, lane);
    ++i;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) fence_acc(acc[j]);
  __syncwarp();
  epilogue<NP>(acc, tile, sp.stride, r0, params + sp.eoff[entry], lane);
  __syncwarp();  // the warp's rows are written before its lanes read them
}

__global__ void __launch_bounds__(kThreads, 1)
    sa_fused_tc_kernel(const float* __restrict__ src, const float* __restrict__ centers,
                       const float* __restrict__ masks, const float* __restrict__ params,
                       float* __restrict__ out, int n, int m, SaSpec sp) {
  extern __shared__ __align__(128) float smem[];
  float* ring_smem = smem;                          // [kTcStages][kTcStage]
  float* tile = ring_smem + kTcStages * kTcStage;   // [kRows][stride]
  float* feat = tile + kRows * sp.stride;           // [tm][sum_c]
  uint64_t* bars = reinterpret_cast<uint64_t*>(feat + ((sp.tm * sp.sum_c + 1) & ~1));
  const int tiles = (m + sp.tm - 1) / sp.tm;
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * sp.tm;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // warp w owns rows 16w .. 16w + 15

  Ring ring{ring_smem, bars, bars + kTcStages};
  for (int e = 0; e < sp.layers; ++e)
    ring.total += (sp.kp[e] + chunk_k(sp.np[e]) - 1) / chunk_k(sp.np[e]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)  // the ring's first chunks, while the tile is gathered
    while (ring.next < ring.total && ring.next < kAhead) ring.produce(sp, params);
  int i = 0, entry = 0, off_c = 0;
  for (int k = 0; k < sp.R; ++k) {
    // rows past the balls are zeros and computed all the same: a branch
    // around the wgmmas would make ptxas serialize them
    gather_tile(sp, k, src, centers, tile, b, n, m, j0);
    cp_async_wait_all();
    __syncthreads();  // the tile is complete
    for (int l = 0; l < sp.nl[k]; ++l, ++entry) {
      if (sp.np[entry] == 1) tc_layer<1>(sp, params, entry, ring, i, tile, r0, lane);
      else tc_layer<2>(sp, params, entry, ring, i, tile, r0, lane);
    }
    __syncthreads();  // the last layer's rows are in the tile
    const int ci = sp.co[entry - 1];
    pool_scale(sp, tile, sp.stride, ci, k, masks, feat, off_c, b, m, j0);
    off_c += ci;
    __syncthreads();  // feat is complete; the tile may be overwritten by the next scale
  }
  store_pooled(sp, feat, params, out, b, m, j0, entry);
}

int odd(int c) { return c | 1; }

int pad_stride(int c) { return c + ((8 - c % 32) + 32) % 32; }  // >= c, = 8 (mod 32)

}  // namespace

// src: f32 [b, n, cp] (features, then xyz); centers: f32 [b, m, 3]; masks: f32
// [b, m, R]; idx[k]: i32 [b, m, ns[k]]; params: f32, per layer entry e (the
// scales' layers in order, then the aggregation layer if has_agg) at off[e]:
// W [ci, co], bias, inv, shift; on the tensor-core routes a scale layer's
// entry is instead its staged weights at off[e] (the chunks of W^T as
// ops/sa_fused.py `stage_weights` writes them, 16-byte aligned) and bias,
// inv, shift (np * 128 each, zero past co) at eoff[e]. out: f32 [b, m,
// c_out]. ns, nl, idx, ci, co, off and eoff are host arrays. Every ns
// divides 128. route: 0 FMA, 1 wgmma.
extern "C" int ssd3d_sa_fused(const float* src, const float* centers, const float* masks,
                              const float* params, float* out, int b, int n, int m, int cp, int R,
                              const int* ns, const int* nl, const void* const* idx, int has_agg,
                              const int* ci, const int* co, const long long* off,
                              const long long* eoff, int route, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || m <= 0 || cp < 3 || R < 1 || R > kMaxScales || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  const bool tc = route != 0;
  SaSpec sp{};
  sp.R = R;
  sp.cp = cp;
  sp.has_agg = has_agg;
  sp.kp0 = (cp + 7) / 8 * 8;
  int max_ns = 0, entries = 0, sa = cp, sb = 1, widest = sp.kp0;
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
      if (l % 2 == 0) sb = std::max(sb, c);  // FMA: even layers write B, odd ones A
      else sa = std::max(sa, c);
      sp.kp[entries] = (ci[entries] + 7) / 8 * 8;
      sp.np[entries] = (c + kCols - 1) / kCols;
      if (tc && sp.np[entries] > kTcPasses) return (int)cudaErrorInvalidValue;
      widest = std::max(widest, sp.np[entries] * kCols);
    }
    sp.sum_c += c;
  }
  if (has_agg && ci[entries] != sp.sum_c) return (int)cudaErrorInvalidValue;
  for (int e = 0; e < entries + (has_agg ? 1 : 0); ++e) {
    sp.ci[e] = ci[e];
    sp.co[e] = co[e];
    sp.off[e] = off[e];
    sp.eoff[e] = eoff[e];
  }
  sp.layers = entries;
  sp.tm = kRows / max_ns;
  sp.sa = odd(sa);
  sp.sb = odd(sb);
  sp.stride = pad_stride(widest);
  const long long blocks = (long long)b * ((m + sp.tm - 1) / sp.tm);
  if (!tc) {
    const size_t smem =
        sizeof(float) * ((size_t)kRows * (sp.sa + sp.sb) + kKC * kCols + (size_t)sp.tm * sp.sum_c);
    if (smem > (size_t)kMaxSmem || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(sa_fused_fma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sa_fused_fma_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(src, centers, masks, params,
                                                                      out, n, m, sp);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ((size_t)kTcStages * kTcStage + (size_t)kRows * sp.stride +
                                       (((size_t)sp.tm * sp.sum_c + 1) & ~(size_t)1)) +
                      sizeof(uint64_t) * 2 * kTcStages;
  if (smem > (size_t)kMaxSmem || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sa_fused_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_fused_tc_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(src, centers, masks, params,
                                                                   out, n, m, sp);
  return (int)cudaGetLastError();
}

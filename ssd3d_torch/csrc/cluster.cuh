// Thread-block cluster helpers shared by the cluster routes of K1 (fps.cu)
// and K2 (ffps.cu): the 64-bit FPS candidate key, its warp-wide maximum, and
// the PTX for distributed shared memory (mapa), mbarriers and st.async.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ssd3d {

constexpr unsigned kFullMask = 0xffffffffu;

// (d, j) -> d's bits over 0xFFFFFFFF - j: for d >= 0 (a squared distance or
// +inf) a larger key is a larger d or, at equal d, a lower j (ssd3d::better)
__device__ __forceinline__ unsigned long long fps_key(float d, int j) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (0xFFFFFFFFu - (unsigned)j);
}

// the index a key carries
__device__ __forceinline__ int fps_key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)key);
}

// the warp's largest key, returned to every lane
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long key) {
  const unsigned hi = __reduce_max_sync(kFullMask, (unsigned)(key >> 32));
  const unsigned lo =
      __reduce_max_sync(kFullMask, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a shared::cta address of this CTA -> the same variable's shared::cluster
// address in the CTA of the cluster with rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// one arrival on the barrier, and `bytes` more to come before its phase ends
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }"
               ::"r"(bar), "r"(bytes) : "memory");
}

// until the barrier's phase of parity `parity` has ended (acquire at cluster
// scope: the other CTAs' st.async writes are then visible)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// a 64-bit store into another CTA's shared memory that counts its 8 bytes on
// that CTA's barrier
__device__ __forceinline__ void st_async(uint32_t remote, unsigned long long v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(remote), "l"(v), "r"(bar) : "memory");
}

}  // namespace ssd3d

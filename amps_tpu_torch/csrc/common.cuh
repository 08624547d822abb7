// Device helpers of the FFT tile (analysis_fft.cuh) and its kernels: the
// discriminator's arctangent (rx_front.cu, rx_phases.cu), the cp.async
// copies of the tile's row loader (synth.cu) and the thread-block
// cluster's rank, shared-memory window and barrier (the tile past 4096
// channels).

#pragma once

#include <cuda_runtime.h>

namespace {

// amps_tpu.dsp.fm.fast_atan2 with the same constants and the same
// operation order; the _rn intrinsics keep nvcc from contracting the
// polynomial into FMAs, so equal inputs give equal bits.
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float z = lo / fmaxf(hi, 1e-30f);
  const float z2 = __fmul_rn(z, z);
  float p = __fmul_rn(z2, -0.085133f);
  p = __fmul_rn(z2, __fadd_rn(0.180141f, p));
  p = __fmul_rn(z2, __fadd_rn(-0.3302995f, p));
  float base = __fmul_rn(z, __fadd_rn(0.999866f, p));
  base = (ay > ax) ? __fsub_rn(static_cast<float>(3.14159265358979323846 / 2), base) : base;
  base = (x < 0.f) ? __fsub_rn(static_cast<float>(3.14159265358979323846), base) : base;
  return (y < 0.f) ? -base : base;
}

// N = 4 or 8 bytes from global to shared memory without passing through
// registers; with valid = false the destination is zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's rank in its cluster, read afresh at each call (asm
// volatile): a kernel that loops over the tile recomputes it, and the
// window addresses below, instead of holding them in registers across
// the loop.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// The address of the shared-memory object p in block `rank` of the
// cluster, in the 32-bit shared::cluster window (distributed shared
// memory), and a float2 read through it.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return a;
}
__device__ __forceinline__ float2 ld_cluster(unsigned a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}
// A barrier of every thread of the cluster: what a thread wrote or read
// in any block's shared memory before it is done for every thread after
// it (arrive with release, wait with acquire semantics).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

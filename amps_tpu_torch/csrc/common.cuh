// Device helpers of the FFT tile (analysis_fft.cuh) and its kernels: the
// discriminator's arctangent (rx_front.cu, rx_phases.cu) and the
// cp.async copies of the tile's row loader (synth.cu).

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

}  // namespace

// Analysis channelizer for Hopper: the polyphase fold and M-point DFT of
// one streaming block, writing the channel-major baseband planes
//   Y (M, Nh, 2) float32 riq, or (2, M, Nh) planar planes.
//
// Replaces the TPU kernel amps_tpu/pallas/channelizer_kernel.py
// (analyze_chmajor_pallas, body _make_kernel) and computes exactly what
// the port's plain analysis, kernels/analysis.py::analyze_reference,
// computes:
// riq or planar input with the history prepended, any hop parity, any
// number of hops.  None of the TPU kernel's limits or workarounds is
// carried over: no even-parity assert, no Nh % tile_h == 0 (the ragged
// last sub-tile is masked by analysis_tile.cuh), no odd bank pre-shifted
// by P samples, no 128-lane M, no stack-and-transpose to planes.
//
//   y_k[n] = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2π km/M}  (analysis_tile.cuh)
//
// What bounds it on an H100.  The function needs an FFT-sized transform
// (5·M·log2 M flops a hop) and the fold (2·T·M FMAs): ~0.69 GFLOP at
// M = 1024, Nh = 8192, 0.01 ms at the f32 peak of 67 TFLOP/s, against
// ~101 MB of input and output (0.03 ms at 3.35 TB/s), so the bytes bound
// the function.  This kernel computes the dense transform instead, with
// the channel-pair symmetry 2·M² real FMAs per hop: ~17.3 G FMA, 0.52 ms
// at the f32 peak, so the f32 FMA pipe bounds this design, as it does
// rx_phases.cu and rx_front.cu; an FFT-shaped transform is the redesign.
// It is the first analysis kernel whose output is larger than its input
// (8 bytes per channel per hop, 2x the input at P = M/2), so the store
// must stay coalesced or it becomes the bound instead.
//
// Design.  Grid = (hop tiles of 128 hops) x (channel tiles of 64).  A
// block runs two 64-hop sub-tiles of analysis_tile.cuh (the tile's first
// analysis hop is h0 - 1, so h0 is set one past the block's first hop;
// the tile masks hops outside [0, Nh) and rows outside the input).  The
// 4-channel x 4-hop register micro-tile of each thread goes through a
// shared-memory stage of one sub-tile, and leaves in rows of 64
// consecutive hops of one channel: 512 contiguous bytes riq, 256 per
// plane planar.  Offsets into Y are 64-bit.  No atomics.

#include <cuda_runtime.h>

#include "analysis_tile.cuh"

namespace {

constexpr int kTileHops = 2 * HS;       // hops per thread block
constexpr int SS = HS + 1;              // stage row stride

__global__ void __launch_bounds__(kThreads, 2)
analysis_kernel(const float* __restrict__ x, int planar_in, long long n_ext,
                const float* __restrict__ coef,   // (T, M) fold coefficients
                const float* __restrict__ cu,     // (M, M/2) cos(2π(mu mod M)/M)
                const float* __restrict__ su,     // (M, M/2) sin, column 0 = (-1)^m
                float* __restrict__ y,            // (M, Nh, 2) or (2, M, Nh)
                int planar_out, int M, int T, int Nh, int hop0_parity) {
  extern __shared__ __align__(16) float smem[];
  const int hb = blockIdx.x * kTileHops;          // the block's first hop
  AnalysisTile at(smem, x, planar_in, n_ext, coef, cu, su, M, T, Nh, hb + 1,
                  blockIdx.y * KU);
  float* st_r = smem + transform_smem_floats(T);  // [KC][SS] Re of the sub-tile
  float* st_i = st_r + KC * SS;                   // [KC][SS] Im
  const int tid = at.tid, tx = at.tx, u0 = at.u0;
  const size_t plane = static_cast<size_t>(M) * Nh;

  at.start();
  for (int i0 = 0; i0 < kTileHops; i0 += HS) {
    float A[2][4], B[2][4], C[2][4], D[2][4];
    at.transform(i0, kTileHops, A, B, C, D);
    float yr[4][4], yi[4][4];
    at.channels(i0, hop0_parity, A, B, C, D, yr, yi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int slot = at.slot(c);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        st_r[slot * SS + tx * 4 + b] = yr[c][b];
        st_i[slot * SS + tx * 4 + b] = yi[c][b];
      }
    }
    __syncthreads();
    // the sub-tile's rows: hop hb + i0 + l of channel slot_channel(slot)
    for (int e = tid; e < KC * HS; e += kThreads) {
      const int slot = e / HS, l = e % HS;
      const int n = hb + i0 + l;
      if (n < Nh) {
        const size_t o = static_cast<size_t>(slot_channel(slot, u0, M)) * Nh + n;
        const float re = st_r[slot * SS + l], im = st_i[slot * SS + l];
        if (planar_out) {
          y[o] = re;
          y[plane + o] = im;
        } else {
          reinterpret_cast<float2*>(y)[o] = make_float2(re, im);
        }
      }
    }
    // the stage is rewritten by the next sub-tile only after that
    // sub-tile's transform, whose first step synchronises the block
  }
}

size_t smem_bytes(int T) {
  return sizeof(float) * (transform_smem_floats(T) + 2 * KC * SS);
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

extern "C" int analysis_channel_tile() { return KC; }
extern "C" int analysis_tile_hops() { return kTileHops; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int analysis_launch(const void* x, int planar_in, long long n_ext,
                               const void* coef, const void* cu,
                               const void* su, void* y, int planar_out, int M,
                               int T, int Nh, int hop0_parity, void* stream) {
  if (M % KC || T < 1 || T > kMaxT || Nh < 1 ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Nh + kTileHops - 1) / kTileHops, M / KC);
  analysis_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), planar_in, n_ext,
      static_cast<const float*>(coef), static_cast<const float*>(cu),
      static_cast<const float*>(su), static_cast<float*>(y), planar_out, M, T,
      Nh, hop0_parity);
  return static_cast<int>(cudaGetLastError());
}

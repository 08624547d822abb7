// Streaming receive front end for Hopper: polyphase analysis channelizer
// + FM quadrature discriminator, writing the demod plane and the
// per-hop power series of one streaming block.
//
// Replaces the TPU kernel amps_tpu/pallas/rx_front_kernel.py
// (analyze_demod_pallas, body _make_kernel), generalised to what the
// streaming receiver (amps_tpu/runtime/streamer.py _rx_stream_block)
// computes: the discriminator's hop -1 is the carried last sample of the
// previous block, any hop parity, the demod in f32, and the power as a
// per-hop series (the receiver blocks it into 384-hop rssi blocks at an
// offset of its own).  Its plain PyTorch version is
// amps_tpu_torch/kernels/rx_front.py::analyze_demod_reference.
//
//   y_k[n]  = analysis (analysis_tile.cuh),  y_k[-1] = prev[k]
//   d_k[n]  = fast_atan2(Im, Re) of y_k[n] conj(y_k[n-1])
//   pw_k[n] = Re^2 + Im^2 of the same product
//   last[k] = y_k[Nh-1]
//
// What bounds it on an H100.  The dense transform, as in rx_phases.cu:
// 2·M² real FMAs per hop with the channel-pair symmetry, ~17 G FMA for a
// 1<<22-sample block at M = 1024, against 16 MB of input and 2 x 32 MB
// of output.  Arithmetic bounds this design; the output is written once,
// coalesced.  The function itself needs only an FFT-sized transform
// (5·M·log2 M flops a hop), which leaves the bytes as its bound.
//
// Design.  Grid = (hop tiles of 383 hops) x (channel tiles of 64).  A
// block computes the 384 analysis hops h0-1 .. h0+382, six whole 64-hop
// sub-tiles of analysis_tile.cuh, and owns the demod of the last 383:
// the hop behind its tile is recomputed instead of carried, except for
// the stream's hop -1, which is `prev`.  The discriminator runs on the
// thread's register micro-tile (the previous hop from the neighbouring
// lane by a warp shuffle, or from the previous sub-tile's carry); demod
// and power go through a shared-memory stage of one sub-tile and leave
// in rows of 64 consecutive hops.  The block that owns hop Nh-1 writes
// `last`.  No atomics: every output element has one writer.

#include <cuda_runtime.h>

#include "analysis_tile.cuh"

namespace {

constexpr int kTileHops = 6 * HS - 1;   // demod hops owned by a block
constexpr int SS = HS + 1;              // stage row stride

__global__ void __launch_bounds__(kThreads, 2)
rx_front_kernel(const float* __restrict__ x, int planar, long long n_ext,
                const float* __restrict__ coef,   // (T, M) fold coefficients
                const float* __restrict__ cu,     // (M, M/2) cos(2π(mu mod M)/M)
                const float* __restrict__ su,     // (M, M/2) sin, column 0 = (-1)^m
                const float* __restrict__ prev,   // (M, 2) y_k[-1]
                float* __restrict__ demod,        // (M, Nh)
                float* __restrict__ pw,           // (M, Nh)
                float* __restrict__ last,         // (M, 2) y_k[Nh-1]
                int M, int T, int Nh, int hop0_parity) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HY = kTileHops + 1;     // analysis hops: h0-1 .. h0+382
  const int h0 = blockIdx.x * kTileHops;
  AnalysisTile at(smem, x, planar, n_ext, coef, cu, su, M, T, Nh, h0,
                  blockIdx.y * KU);
  float* yc_r = smem + transform_smem_floats(T);  // [2][KC] last y of a sub-tile
  float* yc_i = yc_r + 2 * KC;
  float* st_d = yc_i + 2 * KC;          // [KC][SS] demod of the sub-tile
  float* st_p = st_d + KC * SS;         // [KC][SS] power of the sub-tile
  const int tid = at.tid, tx = at.tx, u0 = at.u0;

  at.start();
  for (int i0 = 0; i0 < HY; i0 += HS) {
    float A[2][4], B[2][4], C[2][4], D[2][4];
    at.transform(i0, HY, A, B, C, D);
    const int sub = i0 / HS;
    float yr[4][4], yi[4][4];
    at.channels(i0, hop0_parity, A, B, C, D, yr, yi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int slot = at.slot(c);
      const int ch = slot_channel(slot, u0, M);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = h0 - 1 + i0 + tx * 4 + b;
        if (n < 0) {                    // the stream's hop -1: carried
          yr[c][b] = prev[2 * ch];
          yi[c][b] = prev[2 * ch + 1];
        } else if (n == Nh - 1 && i0 + tx * 4 + b >= 1) {
          last[2 * ch] = yr[c][b];
          last[2 * ch + 1] = yi[c][b];
        }
      }
      // the hop before 4tx: the lane to the left (same ty), or for tx = 0
      // the previous sub-tile's last hop
      const float lr = __shfl_up_sync(0xffffffffu, yr[c][3], 1);
      const float li = __shfl_up_sync(0xffffffffu, yi[c][3], 1);
      float qr = tx ? lr : yc_r[((sub + 1) & 1) * KC + slot];
      float qi = tx ? li : yc_i[((sub + 1) & 1) * KC + slot];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float re = __fadd_rn(__fmul_rn(yr[c][b], qr), __fmul_rn(yi[c][b], qi));
        const float im = __fsub_rn(__fmul_rn(yi[c][b], qr), __fmul_rn(yr[c][b], qi));
        st_d[slot * SS + tx * 4 + b] = fast_atan2(im, re);
        st_p[slot * SS + tx * 4 + b] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        qr = yr[c][b];
        qi = yi[c][b];
      }
      if (tx == 15) {
        yc_r[(sub & 1) * KC + slot] = yr[c][3];
        yc_i[(sub & 1) * KC + slot] = yi[c][3];
      }
    }
    __syncthreads();
    // the sub-tile's demod and power, row by row: analysis hop i0 + l is
    // stream hop h0 - 1 + i0 + l, owned for i0 + l >= 1
    for (int e = tid; e < KC * HS; e += kThreads) {
      const int slot = e / HS, l = e % HS;
      const int n = h0 - 1 + i0 + l;
      if (i0 + l >= 1 && n < Nh) {
        const size_t o = static_cast<size_t>(slot_channel(slot, u0, M)) * Nh + n;
        demod[o] = st_d[slot * SS + l];
        pw[o] = st_p[slot * SS + l];
      }
    }
  }
}

size_t smem_bytes(int T) {
  return sizeof(float) * (transform_smem_floats(T) + 4 * KC + 2 * KC * SS);
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

extern "C" int rx_front_channel_tile() { return KC; }
extern "C" int rx_front_tile_hops() { return kTileHops; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rx_front_launch(const void* x, int planar, long long n_ext,
                               const void* coef, const void* cu,
                               const void* su, const void* prev, void* demod,
                               void* pw, void* last, int M, int T, int Nh,
                               int hop0_parity, void* stream) {
  if (M % KC || T < 1 || T > kMaxT || Nh < 1 ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      rx_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Nh + kTileHops - 1) / kTileHops, M / KC);
  rx_front_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), planar, n_ext,
      static_cast<const float*>(coef), static_cast<const float*>(cu),
      static_cast<const float*>(su), static_cast<const float*>(prev),
      static_cast<float*>(demod), static_cast<float*>(pw),
      static_cast<float*>(last), M, T, Nh, hop0_parity);
  return static_cast<int>(cudaGetLastError());
}

// Fused receive front end for Hopper: polyphase analysis channelizer +
// FM quadrature discriminator + integrate-and-dump phase streams, with
// the 384-hop band-power partials.
//
// Replaces the TPU kernel amps_tpu/pallas/rx_phases_kernel.py
// (analyze_phases_pallas, body _make_kernel).  It computes what the JAX
// XLA chain computes (dsp/channelizer.py bank fold -> dsp/fm.py
// quadrature_demod_planar -> rx/correlator.py symbol_phase_streams and
// window_power_blocks); its plain PyTorch version is
// amps_tpu_torch/kernels/rx_phases.py::analyze_phases_reference.
//
// Math.  The bank fold with the permutation-absorbed matrices and the
// derotation e^{+j2πk/M} collapse to a forward DFT of the folded hop
// window: for channel k and hop n,
//   f_n[m]  = sum_t coef[t, m] x[nP + tM + m]             (m < M, P = M/2)
//   y_k[n]  = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2π km/M}
//   d_k[n]  = fast_atan2(Im, Re) of y_k[n] conj(y_k[n-1]),  y_k[-1] = 0
//   pw_k[n] = Re^2 + Im^2 of the same product
//   phases[k, p, j] = mean(d_k[p + sps*j .. p + sps*j + sps-1])
//   pw_blk[k, b]    = sum of pw_k over hops [384b, 384b+384) ∩ [0, Nh), / 384
//
// What bounds it on an H100.  At M = 1024 the dense transform is 4·M²
// real MACs per hop — about 34 G MAC (69 GFLOP) for a 1<<22-sample block,
// half that with the channel-pair symmetry used below — against 32 MB of
// input and ~12 MB of output, so the kernel is bound by arithmetic: the
// f32 FMA pipe, the shared-memory reads that feed it, and the latency at
// the block's barriers.  The function itself needs only an FFT-sized
// transform (5·M·log2 M flops a hop), which leaves the bytes as its
// bound.  It computes the transform in f32 FMA for every
// spec (transform_bf16 is accepted by the caller and not used); the later
// step is bf16 wgmma and/or the two-stage Cooley-Tukey split
// (dsp/channelizer.py _dft_split_mats, ~7.5x fewer MACs at M = 1024).
//
// Design.  Grid = (hop tiles of 384 hops) x (channel tiles of 64).  384
// is RSSI_BLOCK and a multiple of sps, so a block owns whole symbols and
// whole rssi blocks: no atomics, a fixed summation order.  A block
// recomputes one hop behind its tile (the discriminator's y[n-1]) and
// sps-1 hops ahead (the last symbol's window) instead of carrying state
// between blocks.
//   * The fold and the channel-pair transform of each 64-hop sub-tile are
//     analysis_tile.cuh's, shared with rx_front.cu.
//   * The hop sign, discriminator and power run on the micro-tile in
//     registers (the previous hop comes from the neighbouring lane by a
//     warp shuffle); the demod goes to a 128-hop ring per channel that is
//     dumped into symbols as they complete.  A block needs ~103 KB of
//     shared memory at T = 8 and 127 registers a thread, so two share an SM.
// Only the phases and the power partials reach device memory — the
// (2, M, Nh) analysis planes and the (M, Nh) demod plane never do.  The
// ragged last tile is masked (hops >= Nh fold to zero and add no power),
// so the stream is never padded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "analysis_tile.cuh"

namespace {

constexpr int kTileHops = 384;   // hops owned by a block (RSSI_BLOCK)
constexpr int kRing = 128;       // demod ring per channel (>= HS + 2 sps - 2)

__global__ void __launch_bounds__(kThreads, 2)
rx_phases_kernel(const float* __restrict__ x, int planar, long long n_ext,
                 const float* __restrict__ coef,   // (T, M) fold coefficients
                 const float* __restrict__ cu,     // (M, M/2) cos(2π(mu mod M)/M)
                 const float* __restrict__ su,     // (M, M/2) sin, column 0 = (-1)^m
                 float* __restrict__ ph_f32,       // (M, sps, nsym), or null
                 __nv_bfloat16* __restrict__ ph_bf16,
                 float* __restrict__ pw_blk,       // (M, ntile)
                 int M, int T, int sps, int Nh, int nsym, int hop0_parity,
                 int ntile) {
  extern __shared__ __align__(16) float smem[];
  const int HY = kTileHops + sps;       // analysis hops: h0-1 .. h0+384+sps-2
  const int tile = blockIdx.x;
  const int h0 = tile * kTileHops;
  AnalysisTile at(smem, x, planar, n_ext, coef, cu, su, M, T, Nh, h0,
                  blockIdx.y * KU);
  float* yc_r = smem + transform_smem_floats(T);  // [2][KC] last y of a sub-tile
  float* yc_i = yc_r + 2 * KC;
  float* pwp = yc_i + 2 * KC;           // [KC][16] power partials
  float* ring = pwp + 16 * KC;          // [KC][kRing] demod, by hop mod kRing

  const int tid = at.tid, tx = at.tx, u0 = at.u0;
  const int S = kTileHops / sps;           // symbols a block owns
  const int j0 = h0 / sps;
  const float w = 1.0f / static_cast<float>(sps);
  float pw_acc[4] = {0.f, 0.f, 0.f, 0.f};
  int jd = 0;                              // symbols dumped so far

  at.start();
  for (int i0 = 0; i0 < HY; i0 += HS) {
    float A[2][4], B[2][4], C[2][4], D[2][4];
    at.transform(i0, HY, A, B, C, D);
    const int sub = i0 / HS;
    float yr[4][4], yi[4][4];
    at.channels(i0, hop0_parity, A, B, C, D, yr, yi);
    // discriminator and band power.  The hop before 4tx is the last hop of
    // the lane to the left (same ty), or for tx = 0 the previous
    // sub-tile's last hop, kept in a double-buffered carry.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int slot = at.slot(c);
      const float lr = __shfl_up_sync(0xffffffffu, yr[c][3], 1);
      const float li = __shfl_up_sync(0xffffffffu, yi[c][3], 1);
      float qr = tx ? lr : yc_r[((sub + 1) & 1) * KC + slot];
      float qi = tx ? li : yc_i[((sub + 1) & 1) * KC + slot];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + tx * 4 + b;
        if (i >= 1 && i < HY) {
          const float re = __fadd_rn(__fmul_rn(yr[c][b], qr), __fmul_rn(yi[c][b], qi));
          const float im = __fsub_rn(__fmul_rn(yi[c][b], qr), __fmul_rn(yr[c][b], qi));
          const int e = i - 1;                     // demod hop h0 + e
          ring[slot * kRing + (e & (kRing - 1))] = fast_atan2(im, re);
          if (e < kTileHops && h0 + e < Nh)
            pw_acc[c] += __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
        qr = yr[c][b];
        qi = yi[c][b];
      }
      if (tx == 15) {
        yc_r[(sub & 1) * KC + slot] = yr[c][3];
        yc_i[(sub & 1) * KC + slot] = yi[c][3];
      }
    }
    __syncthreads();
    // integrate-and-dump the symbols whose demod hops are now complete:
    // symbol j of phase p averages demod hops p + sps*j .. p + sps*j + sps-1
    const int e_hi = min(i0 + HS, HY) - 2;
    const int jn = e_hi >= 2 * sps - 2 ? min(S, (e_hi - 2 * sps + 2) / sps + 1) : 0;
    const int nj = jn - jd;
    for (int e = tid; e < KC * sps * nj; e += kThreads) {
      const int jl = jd + e % nj, rest = e / nj;
      const int p = rest % sps, slot = rest / sps;
      const int j = j0 + jl;
      if (j >= nsym) continue;
      const float* d = ring + slot * kRing;
      float acc = 0.f;
      for (int v = 0; v < sps; ++v)
        acc = __fadd_rn(acc, __fmul_rn(d[(p + sps * jl + v) & (kRing - 1)], w));
      const size_t o = (static_cast<size_t>(slot_channel(slot, u0, M)) * sps + p) * nsym + j;
      if (ph_bf16)
        ph_bf16[o] = __float2bfloat16_rn(acc);
      else
        ph_f32[o] = acc;
    }
    jd = jn;
  }

  // band power: each thread's partial sums per channel, added over tx in order
#pragma unroll
  for (int c = 0; c < 4; ++c)
    pwp[at.slot(c) * 16 + tx] = pw_acc[c];
  __syncthreads();
  if (tid < KC) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s = __fadd_rn(s, pwp[tid * 16 + t]);
    pw_blk[static_cast<size_t>(slot_channel(tid, u0, M)) * ntile + tile] =
        s / static_cast<float>(kTileHops);
  }
}

size_t smem_bytes(int T) {
  return sizeof(float) * (transform_smem_floats(T) + 4 * KC + 16 * KC +
                          KC * kRing);
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

extern "C" int rx_phases_channel_tile() { return KC; }
extern "C" int rx_phases_tile_hops() { return kTileHops; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rx_phases_launch(const void* x, int planar, long long n_ext,
                                const void* coef, const void* cu,
                                const void* su, void* phases, int out_bf16,
                                void* pw_blk, int M, int T, int sps, int Nh,
                                int nsym, int hop0_parity, void* stream) {
  if (M % KC || T < 1 || T > kMaxT || sps < 1 || kTileHops % sps ||
      HS + 2 * sps - 2 > kRing || Nh < sps ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      rx_phases_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntile = (Nh + kTileHops - 1) / kTileHops;
  const dim3 grid(ntile, M / KC);
  rx_phases_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), planar, n_ext,
      static_cast<const float*>(coef), static_cast<const float*>(cu),
      static_cast<const float*>(su),
      out_bf16 ? nullptr : static_cast<float*>(phases),
      out_bf16 ? static_cast<__nv_bfloat16*>(phases) : nullptr,
      static_cast<float*>(pw_blk), M, T, sps, Nh, nsym, hop0_parity, ntile);
  return static_cast<int>(cudaGetLastError());
}

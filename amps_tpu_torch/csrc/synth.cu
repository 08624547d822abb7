// Synthesis polyphase channelizer for Hopper: M channel basebands of a
// block of hops -> one wideband stream, with the overlap-add carry.
//
// Replaces the TPU kernel amps_tpu/pallas/synthesizer_kernel.py
// (synthesize_pallas, body _make_kernel), generalised to any hop parity
// and a carry-in; its plain PyTorch version is
// amps_tpu_torch/dsp/channelizer.py::_synthesize_block, reached through
// amps_tpu_torch/kernels/synth.py::synthesize_block_reference.
//
//   u_n[m] = sum_k (-1)^{k(n+parity)} Y_k[n] e^{+j2π km/M}      (m < M)
//   x[bP + p] = carry_in[bP + p] (for b < 2T - 1)
//             + sum_{j<2T} gP[jP + p] u_{b-j}[(j&1)P + p],  0 <= b-j < Nh
// Output hops b < Nh are the block's output, the next 2T - 1 the new
// carry.
//
// What bounds it on an H100: the bytes.  A superframe at M = 1024 (Nh =
// 50004) reads 410 MB of channel basebands and writes 205 MB of wideband,
// 0.183 ms at 3.35 TB/s; its FFT and overlap-add, ~4.2 GFLOP, take 0.063
// ms at the f32 peak (0.030 and 0.010 ms at Nh = 8192; PERF.md §6).
//
// Design.  One kernel, on the all-channel FFT tile (analysis_fft.cuh),
// and no u plane in device memory.
//   * The inverse transform is the tile's forward FFT, read by index.
//     With F_n = FFT_M(Y_n) (no sign, no conjugate),
//       sum_k Y_k e^{+j2πkm/M} = F[(-m) mod M]   and
//       (-1)^k = e^{+j2πkP/M},
//     so u_n[m] = F_n[(-m - P·odd_n) mod M], odd_n = (n + parity) & 1:
//     column p's two reads, F[(M - p) mod M] and F[P - p], swap roles on
//     odd hops.  The rows load by cp.async (FftTile::load_rows).
//   * The overlap-add runs in registers.  A thread owns columns p < P
//     and holds, for each, the running sums of the next RING = 2·MT
//     output hops and the gains gP[jP + p], j < RING (zero for j >= 2T).
//     A block owns all P columns up to M = 1024 at MT = 8 (512 at MT =
//     16), P / 256 of them a thread, rounded up.  More columns do not fit
//     a thread's 255 registers (3 spilled 4.6 KB at M = 1536; 8 would
//     need 384 registers at 4096), so the columns split into G groups, a
//     grid axis (synth_groups): a thread holds at most 2 columns at MT =
//     8 and 1 at MT = 16, and each group's block loads and transforms the
//     whole pass itself -- G times the FFT and the row reads (2 groups at
//     M = 1536 and 2048, 4 at 4096, T <= 8), the G blocks of a run
//     adjacent in the grid so that their row reads meet in L2.  Wherever
//     there are column groups, or the plan is mixed radix, the gains are
//     read from the table at each hop instead of held, and the tile reads
//     its thread index afresh in each pass (FftTile's kLoop), so nvcc
//     does not hoist every pass's index arithmetic into the registers the
//     ring needs: no instantiation spills.  After the FFT of a pass, a
//     thread walks the pass's hops in order: hop h adds its terms into
//     the sums of hops h .. h+RING-1, then output hop h is complete and
//     leaves, the carry-in added for h < 2T - 1, and the ring shifts by
//     one (the hop loop is unrolled, so the shift is register renaming).
//     The terms of an output hop add in order j = 2T-1 down to 0 (fmaf),
//     the reverse of the plain version's order.
//   * A persistent sweep: run i (G blocks) owns output hops [iR, iR + R)
//     of the Nh + 2T - 1 (carry included), R sized so the grid fills the
//     card once, and walks input hops from iR - (2T-1) in passes of H:
//     the first 2T-1 hops only warm the ring (the halo), hops outside
//     [0, Nh) load as zero, and the run whose range reaches past Nh
//     writes the new carry.  Every output sample has one writer; no atomics.

#include <cuda_runtime.h>

#include <algorithm>

#include "analysis_fft.cuh"

namespace {

// columns of the ring a thread may hold at width M and ring 2·MT: a
// block's ceil(P/256), but at most 2 at MT = 8 and 1 at MT = 16
__host__ __device__ constexpr int synth_thread_columns(int M, int MT) {
  return (M / 2 + kFftThreads - 1) / kFftThreads < (MT <= 8 ? 2 : 1)
             ? (M / 2 + kFftThreads - 1) / kFftThreads
             : (MT <= 8 ? 2 : 1);
}
// column groups of a pass (the grid's first axis; 1 up to M = 1024 at
// MT = 8, up to 512 at MT = 16)
__host__ __device__ constexpr int synth_groups(int M, int MT) {
  return (M / 2 + kFftThreads * synth_thread_columns(M, MT) - 1) /
         (kFftThreads * synth_thread_columns(M, MT));
}

template <int M, int MT>
__global__ void __launch_bounds__(kFftThreads, 1)
synth_kernel(const float2* __restrict__ Y,          // (Nh, M) complex
             const float2* __restrict__ tw,         // twiddle table (analysis_fft.cuh)
             const float* __restrict__ gm,          // (T, M) taps * P = gP[jP + p]
             const float2* __restrict__ carry_in,   // ((2T-1)P)
             float2* __restrict__ out,              // (Nh P)
             float2* __restrict__ carry_out,        // ((2T-1)P)
             int T, int Nh, int hop0_parity, int R) {
  extern __shared__ __align__(16) float smem[];
  constexpr int G = synth_groups(M, MT);
  // a power of two in one group keeps the ring's fast form: gains in
  // registers, the tile's index arithmetic hoisted out of the pass loop.
  // Elsewhere (column groups, or the wider register butterflies and the
  // generic pass of a mixed plan) those registers go to the passes: the
  // gains are read from the table (L1) at each hop and the tile reads its
  // thread index afresh in each pass, which keeps every instantiation
  // free of spills
  constexpr bool kFrugal = G > 1 || !fft_pow2(M);
  using Tile = FftTile<M, fft_wide_hops(M), kFrugal>;
  constexpr int H = Tile::H, P = M / 2;
  constexpr int RING = 2 * MT;
  constexpr int PC = (P + G - 1) / G;       // columns of a group
  constexpr int CPT = (PC + kFftThreads - 1) / kFftThreads;   // columns a thread
  // every column of every thread is one of the group's unless they are
  // ragged
  constexpr bool kWhole =
      (G > 1 || CPT > 1) && PC % kFftThreads == 0 && G * PC == P;
  // the group's columns [pg, pe) and the run
  const int pg = G > 1 ? blockIdx.x * PC : 0;
  const int pe = G > 1 ? min(pg + PC, P) : P;
  const int run = G > 1 ? blockIdx.y : blockIdx.x;
  Tile tile(smem);
  tile.load_twiddles(tw);
  const int keep = 2 * T - 1;               // carry hops
  const int o0 = run * R;
  const int o1 = min(o0 + R, Nh + keep);    // output hops [o0, o1)
  const size_t n_out = static_cast<size_t>(Nh) * P;

  float g[CPT][kFrugal ? 1 : RING];
  float2 acc[CPT][RING];    // acc[c][i]: the sum of output hop h + i
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int p = pg + threadIdx.x + c * kFftThreads;
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      if constexpr (!kFrugal)
        g[c][j] = (j < 2 * T && p < pe) ? __ldg(gm + j * P + p) : 0.f;
      acc[c][j] = make_float2(0.f, 0.f);
    }
  }

#pragma unroll 1
  for (int hb = o0 - keep; hb < o1; hb += H) {
    tile.load_rows(Y, hb, Nh);
    tile.fft();
#pragma unroll
    for (int l = 0; l < H; ++l) {
      const int h = hb + l;
      const bool odd = (h + hop0_parity) & 1;
      const bool store = h >= o0 && h < o1;
      const float2* row = tile.S + l * Tile::HS;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int p = pg + threadIdx.x + c * kFftThreads;
        if (kWhole || p < pe) {
          const float2 a = row[Tile::pad(p == 0 ? 0 : M - p)];
          const float2 b = row[Tile::pad(P - p)];
          const float2 ue = odd ? b : a;   // u_h[p]
          const float2 uo = odd ? a : b;   // u_h[P + p]
#pragma unroll
          for (int j = 0; j < RING; ++j) {
            const float2 u = (j & 1) ? uo : ue;
            float gj;
            if constexpr (kFrugal) gj = j < 2 * T ? __ldg(gm + j * P + p) : 0.f;
            else gj = g[c][j];
            acc[c][j].x = fmaf(gj, u.x, acc[c][j].x);
            acc[c][j].y = fmaf(gj, u.y, acc[c][j].y);
          }
          if (store) {
            const size_t i = static_cast<size_t>(h) * P + p;
            float2 s = acc[c][0];
            if (h < keep) {
              const float2 ci = carry_in[i];
              s = make_float2(__fadd_rn(s.x, ci.x), __fadd_rn(s.y, ci.y));
            }
            if (i < n_out)
              out[i] = s;
            else
              carry_out[i - n_out] = s;
          }
#pragma unroll
          for (int j = 0; j + 1 < RING; ++j) acc[c][j] = acc[c][j + 1];
          acc[c][RING - 1] = make_float2(0.f, 0.f);
        }
      }
    }
    __syncthreads();    // the next pass's rows overwrite the plane
  }
}

template <int M, int MT>
int launch_width(const void* Y, const void* tw, const void* gm,
                 const void* carry_in, void* out, void* carry_out, int T,
                 int Nh, int hop0_parity, cudaStream_t st) {
  using Tile = FftTile<M, fft_wide_hops(M)>;
  cudaError_t err = cudaFuncSetAttribute(
      synth_kernel<M, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, synth_kernel<M, MT>, kFftThreads, Tile::kSmemBytes)) !=
          cudaSuccess)
    return static_cast<int>(err);
  // one wave: output hops split evenly over the runs, but at least a pass
  // of them a run; a run is G blocks, one a column group
  constexpr int G = synth_groups(M, MT);
  const int NO = Nh + 2 * T - 1;
  const int G0 = std::max(1, sms * per_sm / G);
  const int R = std::max((NO + G0 - 1) / G0, Tile::H);
  const int runs = (NO + R - 1) / R;
  synth_kernel<M, MT><<<G > 1 ? dim3(G, runs) : dim3(runs), kFftThreads,
                        Tile::kSmemBytes, st>>>(
      static_cast<const float2*>(Y), static_cast<const float2*>(tw),
      static_cast<const float*>(gm), static_cast<const float2*>(carry_in),
      static_cast<float2*>(out), static_cast<float2*>(carry_out), T, Nh,
      hop0_parity, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

// hops a pass of a thread block transforms at width M (-1: M not taken)
extern "C" int synth_tile_hops(int M) {
  return with_width(M, [](auto w) { return fft_wide_hops(decltype(w)::value); });
}
// a block's shared memory at width M, in bytes (-1: M not taken)
extern "C" int synth_smem_bytes(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    return fft_smem_bytes(Mw, fft_wide_hops(Mw));
  });
}
// the column groups at width M and T taps (-1: M not taken)
extern "C" int synth_column_groups(int M, int T) {
  return with_width(M, [T](auto w) {
    constexpr int Mw = decltype(w)::value;
    return T <= 8 ? synth_groups(Mw, 8) : synth_groups(Mw, kFftMaxT);
  });
}
// the FFT's plan at width M: its number of passes and the radix of pass
// p (-1: M not taken)
extern "C" int synth_fft_passes(int M) {
  return with_width(M, [](auto w) { return fft_passes(decltype(w)::value); });
}
extern "C" int synth_fft_radix(int M, int p) {
  return with_width(M, [p](auto w) { return fft_radix(decltype(w)::value, p); });
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int synth_launch(const void* Y, const void* tw, const void* gm,
                            const void* carry_in, void* out, void* carry_out,
                            int M, int T, int Nh, int hop0_parity,
                            void* stream) {
  if (T < 1 || T > kFftMaxT || Nh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_width(M, [&](auto w) {
    constexpr int Mw = decltype(w)::value;
    return T <= 8 ? launch_width<Mw, 8>(Y, tw, gm, carry_in, out, carry_out,
                                        T, Nh, hop0_parity, st)
                  : launch_width<Mw, kFftMaxT>(Y, tw, gm, carry_in, out,
                                               carry_out, T, Nh, hop0_parity,
                                               st);
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

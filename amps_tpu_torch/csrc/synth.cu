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
//     one (up to 4096 the hop loop is unrolled, so the shift is register
//     renaming).
//     The terms of an output hop add in order j = 2T-1 down to 0 (fmaf),
//     the reverse of the plain version's order.
//   * Past M = 4096 a cluster of C blocks runs each group (the tile's
//     split, analysis_fft.cuh; C = 2 up to 8192, 3 .. 8 past it): rank
//     r loads the values k = C·c + r of each hop-major row, the cluster
//     computes F = FFT_M(Y_n), and rank r's plane holds F[rN + c] (N =
//     M/C), so F[k] lies in rank k / N at position k mod N (in the
//     Bluestein mode, a cluster of 8 at the unsplit widths past 8192,
//     rank k mod 8 at position k / 8: Tile::owner, Tile::slot; K4's
//     park, groups and passes are those of M = 32768, the transform
//     running twice while the ring waits).  A thread
//     computes the rank and position of column p's two reads, F[(M - p)
//     mod M] and F[P - p], once a pass and reads both through the
//     shared::cluster window (distributed shared memory).  At C = 2 (N
//     = P) they sit at the one position (N - p) mod N of the two planes
//     -- in rank 1's and rank 0's for p > 0, the other way round at p =
//     0 --; for odd C they do not (P mod N = N/2).  The C ranks split
//     the group's columns, a contiguous range of ceil(P / (G·C)) a
//     block, which covers every column once whether or not C divides P:
//     the groups stay G (a run is C·G blocks, B below), each cluster
//     re-running its share of the pass.  A cluster barrier after the
//     ring (instead of the block's) keeps a plane from being refilled
//     while another rank still reads it.  Registers: a half-width
//     plan's passes and the combine beside the ring's 64 registers
//     spilled up to 1.5 KB (M = 6144, 8190), so past 4096 the ring
//     waits in shared memory while the tile loads and transforms a pass
//     (32 sums a thread, 64 KB a block: a pass is then synth_hops hops,
//     4 at 8192 and 16384 against the other kernels' 6), the hop loop
//     is not unrolled (its shift is then 32 moves a hop), and an odd
//     radix whose register pass would hold more than 16 values a thread
//     runs as the generic pass where the table holds the whole W_N
//     (FftTile::generic_pass): no instantiation spills.
//   * A persistent sweep: run i (B blocks) owns output hops [iR, iR + R)
//     of the Nh + 2T - 1 (carry included), R sized so the grid fills the
//     card once, and walks input hops from iR - (2T-1) in passes of H:
//     the first 2T-1 hops only warm the ring (the halo), hops outside
//     [0, Nh) load as zero, and the run whose range reaches past Nh
//     writes the new carry.  Every output sample has one writer; no atomics.
//   * Past T = 16 taps (a ring of 2T sums would outgrow a thread's
//     registers at every width, and past 4096 its parked 64 KB) the sum
//     splits over chunks of 16 gain rows, by linearity: chunk c < C =
//     ceil(T/16) takes the T_c = min(16, T - 16c) rows 16c .. 16c+T_c-1,
//       y_c[b] = sum_{j<2T_c} gP[(32c + j)P + p] u_{b-j}[(j&1)P + p],
//     the kernel above at T = T_c on those rows (32c is even, so each
//     term keeps its half of u) with a zero carry, Nh + 2T_c - 1 hops;
//     output hop h of the whole sum is sum_c y_c[h - 32c], plus the
//     carry-in for h < 2T - 1 (synth_combine_kernel).  synth_launch runs
//     the C chunk launches one after another on the stream into a scratch
//     the caller allocates (synth_scratch_values), then the recombination,
//     which writes the block and the new carry.  This leaves the kernel,
//     and so every T <= 16, as it was; it costs C times the FFT and the
//     row reads, and one pass over the chunks' planes.  The other way, a
//     kernel that reads, adds and writes its chunk's share of the output
//     in place, would save that pass but add a read and a flag to the
//     ring's store, in a kernel whose registers are tight at every
//     cluster width; a kernel that transforms each pass once for all
//     chunks is later work.

#include <cuda_runtime.h>

#include <algorithm>

#include "analysis_fft.cuh"

namespace {

// columns of the ring a thread may hold at width M and ring 2·MT: a
// block's ceil(P/256) (P/C a block in a cluster of C), but at most 2 at
// MT = 8 and 1 at MT = 16
__host__ __device__ constexpr int synth_thread_columns(int M, int MT) {
  return (M / 2 / fft_blocks(M) + kFftThreads - 1) / kFftThreads <
                 (MT <= 8 ? 2 : 1)
             ? (M / 2 / fft_blocks(M) + kFftThreads - 1) / kFftThreads
             : (MT <= 8 ? 2 : 1);
}
// column groups of a pass (the grid's first axis; 1 up to M = 1024 at
// MT = 8, up to 512 at MT = 16), each a block or, past 4096, a cluster
__host__ __device__ constexpr int synth_groups(int M, int MT) {
  return (M / 2 + fft_blocks(M) * kFftThreads * synth_thread_columns(M, MT) -
          1) /
         (fft_blocks(M) * kFftThreads * synth_thread_columns(M, MT));
}
// a thread's ring past 4096: thread_columns · 2·MT = 32 running sums at
// both rings, parked in shared memory while the tile transforms a pass
constexpr int kSynthParkValues = 32;
__host__ __device__ constexpr int synth_park_bytes(int M) {
  return fft_blocks(M) > 1 ? 8 * kSynthParkValues * kFftThreads : 0;
}
// hops a pass transforms: the tile's fft_wide_hops, or past 4096 the most
// even hops whose plane fits beside the parked ring (4 at N = 4096)
__host__ __device__ constexpr int synth_hops(int M) {
  return fft_blocks(M) == 1
             ? fft_wide_hops(M)
             : ((kFftMaxSmem - synth_park_bytes(M)) /
                    (8 * fft_hop_stride(fft_width(M))) & ~1);
}
// a block's shared memory: the plane of synth_hops, and the parked ring
__host__ __device__ constexpr int synth_smem(int M) {
  return fft_smem_bytes(M, synth_hops(M)) + synth_park_bytes(M);
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
  constexpr int RK = fft_blocks(M);
  constexpr int B = G * RK;                 // blocks of a run
  // a power of two in one group keeps the ring's fast form: gains in
  // registers, the tile's index arithmetic hoisted out of the pass loop.
  // Elsewhere (column groups, a cluster, or the wider register
  // butterflies and the generic pass of a mixed plan) those registers go
  // to the passes: the gains are read from the table (L1) at each hop
  // and the tile reads its thread index afresh in each pass, which keeps
  // every instantiation free of spills
  constexpr bool kFrugal = B > 1 || !fft_pow2(M);
  // past 4096 the ring waits in shared memory, after the plane, while the
  // tile loads and transforms a pass: the passes of a half-width plan and
  // the combine then have the registers K1's block has (without it ptxas
  // spilled up to 1.5 KB at M = 6144 and 8190)
  constexpr bool kPark = RK > 1;
  using Tile = FftTile<M, synth_hops(M), kFrugal>;
  constexpr int H = Tile::H, P = M / 2;
  constexpr int RING = 2 * MT;
  constexpr int PC = (P + B - 1) / B;       // columns of a block
  constexpr int CPT = (PC + kFftThreads - 1) / kFftThreads;   // columns a thread
  // every column of every thread is one of the block's unless they are
  // ragged
  constexpr bool kWhole =
      (B > 1 || CPT > 1) && PC % kFftThreads == 0 && B * PC == P;
  static_assert(!kPark || (CPT * RING == kSynthParkValues &&
                           synth_smem(M) <= kFftMaxSmem),
                "the parked ring fits beside the plane");
  // the block's columns [pg, pe) and the run
  const int pg = B > 1 ? blockIdx.x * PC : 0;
  const int pe = B > 1 ? min(pg + PC, P) : P;
  const int run = B > 1 ? blockIdx.y : blockIdx.x;
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

  // the parked ring: value (c, j) of thread t at (c·RING + j)·kFftThreads + t
  float2* park = tile.S + H * Tile::HS;
#pragma unroll 1
  for (int hb = o0 - keep; hb < o1; hb += H) {
    if constexpr (kPark) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int j = 0; j < RING; ++j)
          park[(c * RING + j) * kFftThreads + Tile::tid()] = acc[c][j];
    }
    tile.load_rows(Y, hb, Nh);
    tile.fft();
    if constexpr (kPark) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int j = 0; j < RING; ++j)
          acc[c][j] = park[(c * RING + j) * kFftThreads + Tile::tid()];
    }
    // F[k] lies in rank k / N at position k mod N, read through the
    // shared::cluster window (its addresses made afresh each pass):
    // column c's reads at hop 0 (Fa, Fb: F[(M - p) mod M], F[P - p])
    unsigned Fa[CPT], Fb[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if constexpr (RK > 1) {
        const int p = pg + threadIdx.x + c * kFftThreads;
        const int ka = p > 0 && p < P ? M - p : 0, kb = p < P ? P - p : 0;
        Fa[c] = cluster_addr(tile.S, Tile::owner(ka)) +
                8 * Tile::pad(Tile::slot(ka));
        Fb[c] = cluster_addr(tile.S, Tile::owner(kb)) +
                8 * Tile::pad(Tile::slot(kb));
      } else {
        Fa[c] = Fb[c] = 0;
      }
    }
    // the hop loop unrolled, so that the ring's shift is register
    // renaming; past 4096 rolled, where its unrolled reads of both planes
    // spilled (M = 6144)
#pragma unroll(kPark ? 1 : H)
    for (int l = 0; l < H; ++l) {
      const int h = hb + l;
      const bool odd = (h + hop0_parity) & 1;
      const bool store = h >= o0 && h < o1;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int p = pg + threadIdx.x + c * kFftThreads;
        if (kWhole || p < pe) {
          float2 a, b;     // F[(M - p) mod M], F[P - p]
          if constexpr (RK > 1) {
            const unsigned q = 8 * l * Tile::HS;
            a = ld_cluster(Fa[c] + q);
            b = ld_cluster(Fb[c] + q);
          } else {
            const float2* row = tile.S + l * Tile::HS;
            a = row[Tile::pad(p == 0 ? 0 : M - p)];
            b = row[Tile::pad(P - p)];
          }
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
    // the next pass's rows overwrite the plane, which the partner reads
    // in a cluster
    if constexpr (RK > 1) cluster_sync();
    else __syncthreads();
  }
}

// The recombination of a filter of T > kFftChunkT taps: output hop h =
// sum_c part_c[h - 2·16c] over the chunks c, ascending, each where it
// lies in its Nh + 2T_c - 1 hops (part_c follow one another), then the
// carry-in for h < 2T - 1; hops below Nh go to out, the rest to
// carry_out.
__global__ void __launch_bounds__(kFftThreads)
synth_combine_kernel(const float2* __restrict__ part,
                     const float2* __restrict__ carry_in,
                     float2* __restrict__ out, float2* __restrict__ carry_out,
                     int P, int T, int Nh) {
  const long long n = static_cast<long long>(Nh + 2 * T - 1) * P;
  const long long n_out = static_cast<long long>(Nh) * P;
  for (long long i = static_cast<long long>(blockIdx.x) * kFftThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kFftThreads) {
    const int h = static_cast<int>(i / P), p = static_cast<int>(i % P);
    float2 s = make_float2(0.f, 0.f);
    const float2* pc = part;
#pragma unroll 1
    for (int t0 = 0; t0 < T; t0 += kFftChunkT) {
      const int hops = Nh + 2 * min(kFftChunkT, T - t0) - 1;
      const int b = h - 2 * t0;
      if (b >= 0 && b < hops) {
        const float2 v = pc[static_cast<size_t>(b) * P + p];
        s = make_float2(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y));
      }
      pc += static_cast<size_t>(hops) * P;
    }
    if (h < 2 * T - 1) {
      const float2 ci = carry_in[i];
      s = make_float2(__fadd_rn(s.x, ci.x), __fadd_rn(s.y, ci.y));
    }
    if (i < n_out)
      out[i] = s;
    else
      carry_out[i - n_out] = s;
  }
}

// float2 values of the scratch a call of T taps needs: none up to
// kFftChunkT; past it a zero carry of a chunk's 2·16 - 1 hops, then each
// chunk's Nh + 2T_c - 1 hops
inline long long synth_scratch(int M, int T, int Nh) {
  if (T <= kFftChunkT) return 0;
  long long hops = 2 * kFftChunkT - 1;
  for (int t0 = 0; t0 < T; t0 += kFftChunkT)
    hops += Nh + 2 * std::min(kFftChunkT, T - t0) - 1;
  return hops * (M / 2);
}

template <int M, int MT>
int launch_width(const void* Y, const void* tw, const void* gm,
                 const void* carry_in, void* out, void* carry_out, int T,
                 int Nh, int hop0_parity, cudaStream_t st) {
  constexpr int H = synth_hops(M), smem = synth_smem(M);
  constexpr int G = synth_groups(M, MT);
  constexpr int B = G * fft_blocks(M);   // blocks of a run
  // run-slots the card holds at once: its blocks, or past 4096 its
  // clusters, over the run's blocks or clusters (0 where a run needs more
  // clusters than the card holds at once: the run's G clusters then take
  // turns, and the launch still has one run, below)
  int slots = 0;
  if constexpr (fft_blocks(M) > 1) {
    const int n = fft_max_clusters<M>(synth_kernel<M, MT>, smem);
    if (n < 0) return -n;
    if (n == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots = n / G;
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        synth_kernel<M, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, synth_kernel<M, MT>, kFftThreads, smem)) !=
            cudaSuccess)
      return static_cast<int>(err);
    slots = sms * per_sm / G;
  }
  // one wave: output hops split evenly over the runs, but at least a pass
  // of them a run; a run is B blocks, G column groups of fft_blocks(M)
  const int NO = Nh + 2 * T - 1;
  const int G0 = std::max(1, slots);
  const int R = std::max((NO + G0 - 1) / G0, H);
  const int runs = (NO + R - 1) / R;
  return fft_launch<M>(
      synth_kernel<M, MT>, B > 1 ? dim3(B, runs) : dim3(runs), smem, st,
      static_cast<const float2*>(Y),
      static_cast<const float2*>(tw), static_cast<const float*>(gm),
      static_cast<const float2*>(carry_in), static_cast<float2*>(out),
      static_cast<float2*>(carry_out), T, Nh, hop0_parity, R);
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

// hops a pass of a thread block transforms at width M (-1: M not taken)
extern "C" int synth_tile_hops(int M) {
  return with_width(M, [](auto w) { return synth_hops(decltype(w)::value); });
}
// a block's shared memory at width M, in bytes (-1: M not taken)
extern "C" int synth_smem_bytes(int M) {
  return with_width(M, [](auto w) { return synth_smem(decltype(w)::value); });
}
// the column groups at width M and T taps: the ring of 8 up to T = 8,
// else that of 16, which every full chunk of T > 16 runs (-1: M not
// taken)
extern "C" int synth_column_groups(int M, int T) {
  return with_width(M, [T](auto w) {
    constexpr int Mw = decltype(w)::value;
    return T <= 8 ? synth_groups(Mw, 8) : synth_groups(Mw, kFftChunkT);
  });
}
// float2 values of the scratch a call of T taps and Nh hops needs at
// width M (-1: M not taken)
extern "C" long long synth_scratch_values(int M, int T, int Nh) {
  return with_width(M, [](auto) { return 0; }) < 0
             ? -1
             : synth_scratch(M, T, Nh);
}
// the FFT's plan at width M (a block's transform, M/C in a cluster): its
// number of passes and the radix of pass p (-1: M not taken)
extern "C" int synth_fft_passes(int M) {
  return with_width(M, [](auto w) {
    return fft_passes(fft_width(decltype(w)::value));
  });
}
extern "C" int synth_fft_radix(int M, int p) {
  return with_width(M, [p](auto w) {
    return fft_radix(fft_width(decltype(w)::value), p);
  });
}
// blocks of a cluster at width M (-1: M not taken)
extern "C" int synth_cluster_size(int M) {
  return with_width(M, [](auto w) { return fft_blocks(decltype(w)::value); });
}
// the length of the chirp transform at width M: 0, or L in the Bluestein
// mode (-1: M not taken)
extern "C" int synth_bluestein_length(int M) {
  return with_width(M, [](auto w) {
    return fft_bluestein(decltype(w)::value);
  });
}
// clusters the card holds at once at a cluster width M, the fewer of the
// two rings' kernels (-1: M not taken or not a cluster width; below -1:
// -(the CUDA error))
extern "C" int synth_max_clusters(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    if constexpr (fft_blocks(Mw) == 1) {
      return -1;
    } else {
      return fft_max_clusters<Mw>(synth_kernel<Mw, 8>,
                                  synth_kernel<Mw, kFftChunkT>,
                                  synth_smem(Mw));
    }
  });
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  Past
// kFftChunkT taps: the chunk launches and the recombination, in
// `scratch`, of scratch_n >= synth_scratch_values(M, T, Nh) float2
// values (none needed up to kFftChunkT).
extern "C" int synth_launch(const void* Y, const void* tw, const void* gm,
                            const void* carry_in, void* out, void* carry_out,
                            void* scratch, long long scratch_n, int M, int T,
                            int Nh, int hop0_parity, void* stream) {
  if (T < 1 || Nh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_width(M, [&](auto w) {
    constexpr int Mw = decltype(w)::value;
    // one launch of T_c <= kFftChunkT taps on the gain rows at g
    const auto ring = [&](const float* g, const void* ci, void* o, void* co,
                          int Tc) {
      return Tc <= 8 ? launch_width<Mw, 8>(Y, tw, g, ci, o, co, Tc, Nh,
                                           hop0_parity, st)
                     : launch_width<Mw, kFftChunkT>(Y, tw, g, ci, o, co, Tc,
                                                    Nh, hop0_parity, st);
    };
    if (T <= kFftChunkT)
      return ring(static_cast<const float*>(gm), carry_in, out, carry_out, T);
    if (scratch == nullptr || scratch_n < synth_scratch(Mw, T, Nh))
      return static_cast<int>(cudaErrorInvalidValue);
    constexpr int P = Mw / 2;
    float2* zero = static_cast<float2*>(scratch);
    float2* part = zero + (2 * kFftChunkT - 1) * P;
    cudaError_t err = cudaMemsetAsync(
        zero, 0, sizeof(float2) * (2 * kFftChunkT - 1) * P, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    float2* pc = part;
    for (int t0 = 0; t0 < T; t0 += kFftChunkT) {
      const int Tc = std::min(kFftChunkT, T - t0);
      const float* g = static_cast<const float*>(gm) +
                       static_cast<size_t>(t0) * Mw;   // gain rows t0 ..
      const int e = ring(g, zero, pc, pc + static_cast<size_t>(Nh) * P, Tc);
      if (e != 0) return e;
      pc += static_cast<size_t>(Nh + 2 * Tc - 1) * P;
    }
    const long long n = static_cast<long long>(Nh + 2 * T - 1) * P;
    const int blocks = static_cast<int>(
        std::min<long long>((n + kFftThreads - 1) / kFftThreads, 8192));
    synth_combine_kernel<<<blocks, kFftThreads, 0, st>>>(
        part, static_cast<const float2*>(carry_in), static_cast<float2*>(out),
        static_cast<float2*>(carry_out), P, T, Nh);
    return static_cast<int>(cudaGetLastError());
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

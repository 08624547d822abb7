// Fused receive front end for Hopper: polyphase analysis channelizer +
// FM quadrature discriminator + integrate-and-dump phase streams, with
// the 384-hop band-power block means.
//
// Replaces the TPU kernel amps_tpu/pallas/rx_phases_kernel.py
// (analyze_phases_pallas, body _make_kernel).  It computes what the JAX
// XLA chain computes (dsp/channelizer.py bank fold -> dsp/fm.py
// quadrature_demod_planar -> rx/correlator.py symbol_phase_streams and
// window_power_blocks); its plain PyTorch version is
// amps_tpu_torch/kernels/rx_phases.py::analyze_phases_reference.
//
//   y_k[n]  = analysis (analysis_fft.cuh),  y_k[-1] = 0
//   d_k[n]  = fast_atan2(Im, Re) of y_k[n] conj(y_k[n-1])
//   pw_k[n] = Re^2 + Im^2 of the same product
//   phases[k, p, j] = mean(d_k[p + sps*j .. p + sps*j + sps-1])
//   pw_blk[k, b]    = sum of pw_k over hops [384b, 384b+384) ∩ [0, Nh), / 384
//
// What bounds it on an H100: the bytes.  A 1<<22-sample block at M =
// 1024 (Nh = 8192) reads 33.6 MB of f32 riq input and writes 16.8 MB of
// bf16 phases and a few KB of power means, 0.015 ms at 3.35 TB/s; its FFT
// and fold, ~0.69 GFLOP, take 0.010 ms at the f32 peak (PERF.md §6).
//
// Design.  One block per run of R demod hops h0 .. h0+R-1 over all M
// channels (analysis_fft.cuh), R a multiple of sps, so the block owns
// the whole symbols j with sps·j in its run.  It folds and transforms
// analysis hops h0-1 .. h0+R+sps-2: one hop behind for the
// discriminator and sps-1 ahead for its last symbol's windows,
// recomputed instead of carried (K2's rule, rx_front.cu).  The stream's
// hop -1 is zero, chosen as data; hops >= Nh fold from zero rows and
// reach no output.
//   * Discriminator in place: a thread owns M/256 channels (rounded up)
//     and walks their hops downwards as independent chains, so the demod
//     of hop l overwrites y(l) once y(l+1) has used it; the products and
//     fast_atan2 are K2's, bit for bit.
//   * Dump: symbol j of phase p averages the plane's demod hops in order
//     (the plain version's weights and order); consecutive threads take
//     consecutive symbols of one (k, p) row, rounded to bf16 or kept f32
//     only at the store.
//   * Power: a block sums the power of its owned hops < Nh per channel,
//     split at the 384-hop boundary its run may cross, into a (M, runs,
//     2) scratch; a second small kernel adds each rssi block's partials
//     in run order and divides by 384.  No atomics.
// Only the phases and the power means reach device memory -- the
// (2, M, Nh) analysis planes and the (M, Nh) demod plane never do.
// G independent bands of the same geometry run as one launch: blockIdx.y
// is the band, whose input and outputs lie G-major one after another.
// Past M = 4096 a cluster of C blocks runs each run (grid x = C x the
// runs), block rank r holding channels rN .. rN+N-1 (N = M/C; the tile's
// pass across the cluster, analysis_fft.cuh), or in the Bluestein mode
// the NC = ceil(M/8) channels 8c + r (tile.channel(c), those below M):
// the discriminator, dump and power above run on the block's channels,
// six hops at N = 4096 and a run of 3 at sps = 3.  Any number of taps
// T: each width has a kernel for T <= 16 and one that folds a longer
// filter in chunks of 16 taps (kLongT, analysis_fft.cuh).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "analysis_fft.cuh"

namespace {

constexpr int kRssiBlock = 384;

// demod hops a block owns: the most whole symbols whose look-ahead fits
// in the tile's hops (0 if sps is too large for the tile)
__host__ __device__ constexpr int run_hops(int M, int sps) {
  return sps < 1 ? 0 : (fft_wide_hops(M) - sps) / sps * sps;
}

template <int M, bool kLongT>
__global__ void __launch_bounds__(kFftThreads, fft_min_blocks(M))
rx_phases_kernel(const float* __restrict__ x, int planar, long long n_ext,
                 const float* __restrict__ coef,   // (T, M) fold coefficients
                 const float2* __restrict__ tw,    // twiddle table (analysis_fft.cuh)
                 float* __restrict__ ph_f32,       // (M, sps, nsym), or null
                 __nv_bfloat16* __restrict__ ph_bf16,
                 float2* __restrict__ pw_part,     // (M, nrun) partial pairs
                 int T, int sps, int Nh, int nsym, int hop0_parity, int nrun) {
  extern __shared__ __align__(16) float smem[];
  using Tile = FftTile<M, fft_wide_hops(M)>;
  constexpr int HS = Tile::HS;
  constexpr int NC = Tile::NC;            // positions holding channels
  Tile tile(smem);
  const int R = run_hops(M, sps);
  const int run = blockIdx.x / Tile::RK;
  const size_t band = blockIdx.y;         // one of G independent bands
  x += band * 2 * static_cast<size_t>(n_ext);
  pw_part += band * M * nrun;
  const size_t ph0 = band * M * sps * static_cast<size_t>(nsym);
  const int h0 = run * R;                 // tile hop l is stream hop h0-1+l
  tile.load_twiddles(tw);
  tile.template fold<kLongT>(x, planar, n_ext, coef, T, h0 - 1);
  __syncthreads();
  tile.fft();

  // discriminator and power, tile hops L-1 down to 1; a thread's CPT
  // channels run as independent chains
  constexpr int CPT = (NC + kFftThreads - 1) / kFftThreads;
  // a thread's last chain is past the positions only where NC > 256 is
  // ragged
  constexpr bool kRagged = NC > kFftThreads && NC % kFftThreads != 0;
  const int L = R + sps;
  const int b0 = h0 / kRssiBlock;
  if (CPT > 1 || threadIdx.x < NC) {
    float2 c[CPT];
    float pw0[CPT], pw1[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int k = threadIdx.x + i * kFftThreads;
      c[i] = (!kRagged || k < NC) ? tile.y(L - 1, k, h0 + L - 2, hop0_parity)
                                 : make_float2(0.f, 0.f);
      pw0[i] = pw1[i] = 0.f;
    }
    for (int l = L - 1; l >= 1; --l) {
      const int n = h0 - 1 + l;
      const bool own = l <= R && n < Nh;
      const bool first = n / kRssiBlock == b0;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int k = threadIdx.x + i * kFftThreads;
        if (kRagged && k >= NC) continue;
        const float2 b = tile.y(l - 1, k, n - 1, hop0_parity);
        const float2 q = n ? b : make_float2(0.f, 0.f);
        const float re =
            __fadd_rn(__fmul_rn(c[i].x, q.x), __fmul_rn(c[i].y, q.y));
        const float im =
            __fsub_rn(__fmul_rn(c[i].y, q.x), __fmul_rn(c[i].x, q.y));
        tile.S[l * HS + Tile::pad(k)].x = fast_atan2(im, re);
        const float pw = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        if (own && first) pw0[i] = __fadd_rn(pw0[i], pw);
        if (own && !first) pw1[i] = __fadd_rn(pw1[i], pw);
        c[i] = b;
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int k = threadIdx.x + i * kFftThreads;
      if ((!kRagged || k < NC) && (!Tile::LB || tile.holds(k)))
        pw_part[static_cast<size_t>(tile.channel(k)) * nrun + run] =
            make_float2(pw0[i], pw1[i]);
    }
  }
  __syncthreads();

  // integrate-and-dump: symbol j0 + jl of phase p averages demod hops
  // h0 + p + sps*jl .. + sps-1, tile hops 1 + p + sps*jl ..  Element e =
  // (k sps + p) S + jl of the block's channels k; a thread steps e by
  // kFftThreads, its (k, p, jl) by carries instead of divisions.
  const int S = R / sps, j0 = h0 / sps;
  const float w = 1.0f / static_cast<float>(sps);
  const int row0 = threadIdx.x / S, drow = kFftThreads / S;
  const int dj = kFftThreads % S, dp = drow % sps, dk = drow / sps;
  int jl = threadIdx.x % S, p = row0 % sps, k = row0 / sps;
  while (k < NC) {
    const int j = j0 + jl;
    if (j < nsym && (!Tile::LB || tile.holds(k))) {
      const float2* d = tile.S + (1 + p + sps * jl) * HS + Tile::pad(k);
      float acc = 0.f;
      for (int v = 0; v < sps; ++v)
        acc = __fadd_rn(acc, __fmul_rn(d[v * HS].x, w));
      const size_t o =
          ph0 + (static_cast<size_t>(tile.channel(k)) * sps + p) * nsym + j;
      if (ph_bf16)
        ph_bf16[o] = __float2bfloat16_rn(acc);
      else
        ph_f32[o] = acc;
    }
    jl += dj;
    p += dp;
    k += dk;
    if (jl >= S) {
      jl -= S;
      ++p;
    }
    if (p >= sps) {
      p -= sps;
      ++k;
    }
  }
}

// pw_blk[k, b] = the partials of the runs that meet rssi block b, in run
// order, / 384: a run that starts in b gives its first partial, the one
// that crosses into b from b-1 its second
__global__ void __launch_bounds__(kFftThreads)
rx_phases_power_kernel(const float2* __restrict__ pw_part,
                       float* __restrict__ pw_blk, int M, int R, int nrun,
                       int nblk) {
  const int i = blockIdx.x * kFftThreads + threadIdx.x;
  if (i >= M * nblk) return;
  const int k = i / nblk, b = i % nblk;
  const int r0 = b * kRssiBlock / R;
  const int r1 = min((b * kRssiBlock + kRssiBlock - 1) / R, nrun - 1);
  const float2* part = pw_part + static_cast<size_t>(k) * nrun;
  float s = 0.f;
  for (int r = r0; r <= r1; ++r)
    s = __fadd_rn(s, r * R / kRssiBlock == b ? part[r].x : part[r].y);
  pw_blk[i] = s / static_cast<float>(kRssiBlock);
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

// analysis hops a thread block computes at width M (-1: M not taken)
extern "C" int rx_phases_tile_hops(int M) {
  return with_width(M, [](auto w) { return fft_wide_hops(decltype(w)::value); });
}
// a block's shared memory at width M, in bytes (-1: M not taken)
extern "C" int rx_phases_smem_bytes(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    return fft_smem_bytes(Mw, fft_wide_hops(Mw));
  });
}
// the FFT's plan at width M (a block's transform, M/C in a cluster): its
// number of passes and the radix of pass p (-1: M not taken)
extern "C" int rx_phases_fft_passes(int M) {
  return with_width(M, [](auto w) {
    return fft_passes(fft_width(decltype(w)::value));
  });
}
extern "C" int rx_phases_fft_radix(int M, int p) {
  return with_width(M, [p](auto w) {
    return fft_radix(fft_width(decltype(w)::value), p);
  });
}
// blocks of a cluster at width M (-1: M not taken)
extern "C" int rx_phases_cluster_size(int M) {
  return with_width(M, [](auto w) { return fft_blocks(decltype(w)::value); });
}
// the length of the chirp transform at width M: 0, or L in the Bluestein
// mode (-1: M not taken)
extern "C" int rx_phases_bluestein_length(int M) {
  return with_width(M, [](auto w) {
    return fft_bluestein(decltype(w)::value);
  });
}
// clusters of the kernel (the fewer of its two instantiations) the card
// holds at once at a cluster width M
// (-1: M not taken or not a cluster width; below -1: -(the CUDA error))
extern "C" int rx_phases_max_clusters(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    if constexpr (fft_blocks(Mw) == 1) {
      return -1;
    } else {
      return fft_max_clusters<Mw>(rx_phases_kernel<Mw, false>,
                                  rx_phases_kernel<Mw, true>,
                                  FftTile<Mw, fft_wide_hops(Mw)>::kSmemBytes);
    }
  });
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 =
// launched).  x, phases, pw_part and pw_blk hold G bands one after another;
// pw_part is a (G, M, nrun, 2) float scratch, nrun = the runs of
// run_hops(M, sps) demod hops that cover Nh.
extern "C" int rx_phases_launch(const void* x, int planar, long long n_ext,
                                const void* coef, const void* tw,
                                void* phases, int out_bf16, void* pw_part,
                                void* pw_blk, int M, int T, int sps, int Nh,
                                int nsym, int hop0_parity, int nrun, int G,
                                void* stream) {
  if (T < 1 || Nh < sps || nsym < 0 || G < 1 || G > 65535 ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_width(M, [&](auto w) {
    constexpr int Mw = decltype(w)::value;
    using Tile = FftTile<Mw, fft_wide_hops(Mw)>;
    const int R = run_hops(Mw, sps);
    if (R < sps || nrun != (Nh + R - 1) / R)
      return static_cast<int>(cudaErrorInvalidValue);
    // a filter longer than kFftChunkT taps: the instantiation that
    // folds in chunks
    const auto kernel = T > kFftChunkT ? rx_phases_kernel<Mw, true>
                                       : rx_phases_kernel<Mw, false>;
    int err = fft_launch<Mw>(
        kernel, dim3(nrun * Tile::RK, G), Tile::kSmemBytes, st,
        static_cast<const float*>(x), planar, n_ext,
        static_cast<const float*>(coef), static_cast<const float2*>(tw),
        out_bf16 ? nullptr : static_cast<float*>(phases),
        out_bf16 ? static_cast<__nv_bfloat16*>(phases) : nullptr,
        static_cast<float2*>(pw_part), T, sps, Nh, nsym, hop0_parity, nrun);
    if (err != 0) return err;
    const int nblk = (Nh + kRssiBlock - 1) / kRssiBlock;
    // the bands' channels are G·M rows of both power arrays
    rx_phases_power_kernel<<<(G * Mw * nblk + kFftThreads - 1) / kFftThreads,
                             kFftThreads, 0, st>>>(
        static_cast<const float2*>(pw_part), static_cast<float*>(pw_blk),
        G * Mw, R, nrun, nblk);
    return static_cast<int>(cudaGetLastError());
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

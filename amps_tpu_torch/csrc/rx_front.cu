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
//   y_k[n]  = analysis (analysis_fft.cuh),  y_k[-1] = prev[k]
//   d_k[n]  = fast_atan2(Im, Re) of y_k[n] conj(y_k[n-1])
//   pw_k[n] = Re^2 + Im^2 of the same product
//   last[k] = y_k[Nh-1]
//
// What bounds it on an H100: the bytes.  A 1<<22-sample block at M =
// 1024 (Nh = 8192) reads 33.6 MB of f32 riq input and writes two 33.6 MB
// planes, ~101 MB or 0.031 ms at 3.35 TB/s; its FFT and fold, ~0.69
// GFLOP, take 0.010 ms at the f32 peak (PERF.md §6).
//
// Design.  One block per run of H analysis hops (24 at M = 1024) over all
// M channels (analysis_fft.cuh): hops h0-1 .. h0+H-2 are folded once and
// transformed by an f32 Stockham FFT in shared memory, and the block owns
// the demod of the last H-1.  The hop behind its run is recomputed
// instead of carried, except for the stream's hop -1, which is `prev`;
// both previous values go through the same product, chosen as data.  The
// discriminator and power read the plane, which doubles as the store
// stage: consecutive threads take consecutive hops of one channel, so each
// channel's H-1 hops leave as one contiguous row of each plane (92 bytes
// at M = 1024).  The block that owns hop Nh-1 writes `last`.  No
// atomics: every output element has one writer.  Past M = 4096 a
// cluster of C blocks runs each run, block rank r holding channels
// rN .. rN+N-1 (N = M/C; the tile's pass across the cluster,
// analysis_fft.cuh), or in the Bluestein mode channels 8c + r
// (tile.channel(c)); the grid's x is then C x the runs.  Any number of
// taps T: each width has a kernel for T <= 16 and one that folds a
// longer filter in chunks of 16 taps (kLongT, analysis_fft.cuh).

#include <cuda_runtime.h>

#include "analysis_fft.cuh"

namespace {

template <int M, bool kLongT>
__global__ void __launch_bounds__(kFftThreads, fft_min_blocks(M))
rx_front_kernel(const float* __restrict__ x, int planar, long long n_ext,
                const float* __restrict__ coef,   // (T, M) fold coefficients
                const float2* __restrict__ tw,    // twiddle table (analysis_fft.cuh)
                const float2* __restrict__ prev,  // (M,) y_k[-1]
                float* __restrict__ demod,        // (M, Nh)
                float* __restrict__ pw,           // (M, Nh)
                float2* __restrict__ last,        // (M,) y_k[Nh-1]
                int T, int Nh, int hop0_parity) {
  extern __shared__ __align__(16) float smem[];
  using Tile = FftTile<M, fft_wide_hops(M)>;
  constexpr int HO = Tile::H - 1;         // demod hops a block owns
  constexpr int NC = Tile::NC;            // positions holding channels
  Tile tile(smem);
  // tile hop l is stream hop h0-1+l
  const int h0 = static_cast<int>(blockIdx.x / Tile::RK) * HO;
  tile.load_twiddles(tw);
  tile.template fold<kLongT>(x, planar, n_ext, coef, T, h0 - 1);
  __syncthreads();
  tile.fft();
  for (int e = threadIdx.x; e < NC * HO; e += kFftThreads) {
    const int ch = e / HO, l = 1 + e % HO;
    const int k = tile.channel(ch);
    const int n = h0 - 1 + l;
    if (n < Nh && (!Tile::LB || tile.holds(ch))) {
      const float2 c = tile.y(l, ch, n, hop0_parity);
      const float2 b = tile.y(l - 1, ch, n - 1, hop0_parity);
      const float2 p0 = prev[k];
      const float2 q = n ? b : p0;
      const float re = __fadd_rn(__fmul_rn(c.x, q.x), __fmul_rn(c.y, q.y));
      const float im = __fsub_rn(__fmul_rn(c.y, q.x), __fmul_rn(c.x, q.y));
      const size_t o = static_cast<size_t>(k) * Nh + n;
      demod[o] = fast_atan2(im, re);
      pw[o] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      if (n == Nh - 1) last[k] = c;
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

// demod hops a thread block owns at width M (-1: M not taken)
extern "C" int rx_front_tile_hops(int M) {
  return with_width(M, [](auto w) { return fft_wide_hops(decltype(w)::value) - 1; });
}
// a block's shared memory at width M, in bytes (-1: M not taken)
extern "C" int rx_front_smem_bytes(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    return fft_smem_bytes(Mw, fft_wide_hops(Mw));
  });
}
// the FFT's plan at width M (a block's transform, M/C in a cluster): its
// number of passes and the radix of pass p (-1: M not taken)
extern "C" int rx_front_fft_passes(int M) {
  return with_width(M, [](auto w) {
    return fft_passes(fft_width(decltype(w)::value));
  });
}
extern "C" int rx_front_fft_radix(int M, int p) {
  return with_width(M, [p](auto w) {
    return fft_radix(fft_width(decltype(w)::value), p);
  });
}
// blocks of a cluster at width M (-1: M not taken)
extern "C" int rx_front_cluster_size(int M) {
  return with_width(M, [](auto w) { return fft_blocks(decltype(w)::value); });
}
// the length of the chirp transform at width M: 0, or L in the Bluestein
// mode (-1: M not taken)
extern "C" int rx_front_bluestein_length(int M) {
  return with_width(M, [](auto w) {
    return fft_bluestein(decltype(w)::value);
  });
}
// clusters of the kernel (the fewer of its two instantiations) the card
// holds at once at a cluster width M
// (-1: M not taken or not a cluster width; below -1: -(the CUDA error))
extern "C" int rx_front_max_clusters(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    if constexpr (fft_blocks(Mw) == 1) {
      return -1;
    } else {
      return fft_max_clusters<Mw>(rx_front_kernel<Mw, false>,
                                  rx_front_kernel<Mw, true>,
                                  FftTile<Mw, fft_wide_hops(Mw)>::kSmemBytes);
    }
  });
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rx_front_launch(const void* x, int planar, long long n_ext,
                               const void* coef, const void* tw,
                               const void* prev, void* demod, void* pw,
                               void* last, int M, int T, int Nh,
                               int hop0_parity, void* stream) {
  if (T < 1 || Nh < 1 ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = with_width(M, [&](auto w) {
    constexpr int Mw = decltype(w)::value;
    using Tile = FftTile<Mw, fft_wide_hops(Mw)>;
    const dim3 grid((Nh + Tile::H - 2) / (Tile::H - 1) * Tile::RK);
    // a filter longer than kFftChunkT taps: the instantiation that
    // folds in chunks
    const auto kernel =
        T > kFftChunkT ? rx_front_kernel<Mw, true> : rx_front_kernel<Mw, false>;
    return fft_launch<Mw>(
        kernel, grid, Tile::kSmemBytes,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
        planar, n_ext, static_cast<const float*>(coef),
        static_cast<const float2*>(tw), static_cast<const float2*>(prev),
        static_cast<float*>(demod), static_cast<float*>(pw),
        static_cast<float2*>(last), T, Nh, hop0_parity);
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

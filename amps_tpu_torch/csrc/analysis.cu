// Analysis channelizer for Hopper: the polyphase fold and M-point FFT of
// one streaming block, writing the channel-major baseband planes
//   Y (M, Nh, 2) float32 riq, or (2, M, Nh) planar planes.
//
// Replaces the TPU kernel amps_tpu/pallas/channelizer_kernel.py
// (analyze_chmajor_pallas, body _make_kernel) and computes what the
// port's plain analysis, kernels/analysis.py::analyze_reference,
// computes: riq or planar input with the history prepended, any hop
// parity, any number of hops, any M the tile takes (analysis_fft.cuh:
// every even M from 2 to 16384 -- past 8192 split, or else Bluestein's
// chirp transform of length 32768 --, and M = C·N, C <= 8, N <= 4096, up
// to 32768).  None of the TPU kernel's limits or workarounds is carried
// over: no even-parity assert, no Nh % tile_h == 0, no odd bank
// pre-shifted by P samples, no 128-lane M, no stack-and-transpose to
// planes.
//
//   y_k[n] = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2π km/M}  (analysis_fft.cuh)
//
// What bounds it on an H100: the bytes.  A superframe at M = 1024 (Nh =
// 50004) reads 205 MB of input and writes 410 MB of planes, 0.185 ms at
// 3.35 TB/s; its FFT and fold, ~4.2 GFLOP, take 0.063 ms at the f32 peak
// of 67 TFLOP/s (0.031 and 0.010 ms at Nh = 8192; PERF.md §6).  The
// output is twice the input (8 bytes per channel per hop at P = M/2), so
// the store must stay coalesced.
//
// Design.  One block per run of H hops (12 at M = 1024) over all M
// channels (analysis_fft.cuh): each hop is folded once, straight from
// device memory, and transformed by an f32 Stockham FFT in shared memory,
// ~5·M·log2 M flops a hop instead of the dense DFT's 4·M².  The plane is
// the store stage: consecutive threads take consecutive hops of one
// channel, so each channel's H hops leave as one contiguous row (96 bytes
// riq, 48 per plane planar, at M = 1024).  Offsets into Y are 64-bit.
// No atomics.  Past M = 4096 a cluster of C blocks runs each run, block
// rank r folding and storing channels rN .. rN+N-1 (N = M/C; the tile's
// pass across the cluster, analysis_fft.cuh), or in the Bluestein mode
// channels 8c + r (tile.channel(c)); the grid's x is then C x the runs.  Any
// number of taps T: each width has a kernel for T <= 16 and one that
// folds a longer filter in chunks of 16 taps (kLongT, analysis_fft.cuh).

#include <cuda_runtime.h>

#include "analysis_fft.cuh"

namespace {

template <int M, bool kLongT>
__global__ void __launch_bounds__(kFftThreads, fft_min_blocks(M))
analysis_kernel(const float* __restrict__ x, int planar_in, long long n_ext,
                const float* __restrict__ coef,   // (T, M) fold coefficients
                const float2* __restrict__ tw,    // twiddle table (analysis_fft.cuh)
                float* __restrict__ y,            // (M, Nh, 2) or (2, M, Nh)
                int planar_out, int T, int Nh, int hop0_parity) {
  extern __shared__ __align__(16) float smem[];
  using Tile = FftTile<M, fft_tile_hops(M)>;
  constexpr int H = Tile::H, NC = Tile::NC;   // NC: positions of channels
  Tile tile(smem);
  // tile hop l is stream hop h0 + l
  const int h0 = static_cast<int>(blockIdx.x / Tile::RK) * H;
  tile.load_twiddles(tw);
  tile.template fold<kLongT>(x, planar_in, n_ext, coef, T, h0);
  __syncthreads();
  tile.fft();
  const size_t plane = static_cast<size_t>(M) * Nh;
  for (int e = threadIdx.x; e < NC * H; e += kFftThreads) {
    const int c = e / H, l = e % H;
    const int n = h0 + l;
    if (n < Nh && (!Tile::LB || tile.holds(c))) {
      const float2 v = tile.y(l, c, n, hop0_parity);
      const size_t o = static_cast<size_t>(tile.channel(c)) * Nh + n;
      if (planar_out) {
        y[o] = v.x;
        y[plane + o] = v.y;
      } else {
        reinterpret_cast<float2*>(y)[o] = v;
      }
    }
  }
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

// hops a thread block owns at width M (-1: M not taken)
extern "C" int analysis_tile_hops(int M) {
  return with_width(M, [](auto w) { return fft_tile_hops(decltype(w)::value); });
}
// a block's shared memory at width M, in bytes (-1: M not taken)
extern "C" int analysis_smem_bytes(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    return fft_smem_bytes(Mw, fft_tile_hops(Mw));
  });
}
// the FFT's plan at width M (a block's transform, M/C in a cluster): its
// number of passes and the radix of pass p (-1: M not taken)
extern "C" int analysis_fft_passes(int M) {
  return with_width(M, [](auto w) {
    return fft_passes(fft_width(decltype(w)::value));
  });
}
extern "C" int analysis_fft_radix(int M, int p) {
  return with_width(M, [p](auto w) {
    return fft_radix(fft_width(decltype(w)::value), p);
  });
}
// blocks of a cluster at width M (-1: M not taken)
extern "C" int analysis_cluster_size(int M) {
  return with_width(M, [](auto w) { return fft_blocks(decltype(w)::value); });
}
// the length of the chirp transform at width M: 0, or L in the Bluestein
// mode (-1: M not taken)
extern "C" int analysis_bluestein_length(int M) {
  return with_width(M, [](auto w) {
    return fft_bluestein(decltype(w)::value);
  });
}
// clusters of the kernel (the fewer of its two instantiations) the card
// holds at once at a cluster width M
// (-1: M not taken or not a cluster width; below -1: -(the CUDA error))
extern "C" int analysis_max_clusters(int M) {
  return with_width(M, [](auto w) {
    constexpr int Mw = decltype(w)::value;
    if constexpr (fft_blocks(Mw) == 1) {
      return -1;
    } else {
      return fft_max_clusters<Mw>(analysis_kernel<Mw, false>,
                                  analysis_kernel<Mw, true>,
                                  FftTile<Mw, fft_tile_hops(Mw)>::kSmemBytes);
    }
  });
}

// clusters of `blocks` blocks of the analysis kernel at width M, its
// shared memory a block, that the card holds at once with cluster sizes
// past the portable 8 allowed
// (cudaFuncAttributeNonPortableClusterSizeAllowed): a probe of the
// card's limit for a chirp transform longer than a cluster of 8 holds.
// It launches nothing (-1: M not taken; below -1: -(the CUDA error))
extern "C" int analysis_probe_clusters(int M, int blocks) {
  return with_width(M, [blocks](auto w) {
    constexpr int Mw = decltype(w)::value;
    const auto kernel = analysis_kernel<Mw, false>;
    const int smem = FftTile<Mw, fft_tile_hops(Mw)>::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kFftThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = blocks;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err != cudaSuccess ? -static_cast<int>(err) : n;
  });
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int analysis_launch(const void* x, int planar_in, long long n_ext,
                               const void* coef, const void* tw, void* y,
                               int planar_out, int M, int T, int Nh,
                               int hop0_parity, void* stream) {
  if (T < 1 || Nh < 1 ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = with_width(M, [&](auto w) {
    constexpr int Mw = decltype(w)::value;
    using Tile = FftTile<Mw, fft_tile_hops(Mw)>;
    const dim3 grid((Nh + Tile::H - 1) / Tile::H * Tile::RK);
    // a filter longer than kFftChunkT taps: the instantiation that
    // folds in chunks
    const auto kernel =
        T > kFftChunkT ? analysis_kernel<Mw, true> : analysis_kernel<Mw, false>;
    return fft_launch<Mw>(
        kernel, grid, Tile::kSmemBytes,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
        planar_in, n_ext, static_cast<const float*>(coef),
        static_cast<const float2*>(tw), static_cast<float*>(y), planar_out,
        T, Nh, hop0_parity);
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

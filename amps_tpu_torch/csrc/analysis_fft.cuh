// The all-channel FFT tile of one thread block, shared by the four
// kernels: the analysis kernel (analysis.cu), the streaming and the
// one-shot receive front ends (rx_front.cu, rx_phases.cu) and the
// synthesis kernel (synth.cu).
//
// Math.  The bank fold with the permutation-absorbed matrices and the
// derotation e^{+j2πk/M} collapse to a forward DFT of the folded hop
// window: for channel k and hop n,
//   f_n[m] = sum_t coef[t, m] x[nP + tM + m]              (m < M, P = M/2)
//   y_k[n] = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2π km/M}
// so y is the forward M-point FFT of the folded window, then the hop sign.
// The synthesis runs the same forward FFT on hop-major rows of channel
// basebands (load_rows) and reads its inverse transform off it by index
// (synth.cu).
//
// A block owns all M channels of H consecutive hops a0 .. a0+H-1 (M any
// even width from 2 to 4096; H even, set by the kernel); past 4096 a
// cluster of C blocks owns them (below), and past 8192, where no cluster
// splits M, a cluster of 8 runs Bluestein's chirp transform (last).  The
// small banks (M = 2 .. 32: one pass of radix 2, 4, 8 or 16, or 16 then
// 2, or a few short passes) run the same code with most of a block's
// threads idle in the fold and the passes:
//   * fold: a thread folds one m for the H/2 hops of one parity, whose
//     windows share H/2 + T - 1 input rows (hop a tap t reads row
//     a + 2t, +1 for m >= P), loaded all at once straight from device
//     memory into registers; consecutive threads take consecutive m, so a
//     warp reads 256 contiguous bytes of a row.  The taps add in order
//     t = 0, 1, ... (fmaf from 0) for every hop.  Rows outside the input
//     load as zero; hops outside [0, Nh) are computed like any other and
//     never stored.  Past T = 16 the taps fold in chunks of 16, in a
//     kernel instantiation of its own (kLongT), so that the short
//     filters' kernels stay as they were: chunk c loads the H/2 + 15
//     rows of taps 16c .. 16c+15 as above (8 taps a chunk where
//     registers are tightest, kFoldChunk) and adds them into each hop's
//     running sum, which waits between chunks in the thread's own cells
//     of the plane (the f32 value a register would hold, so the sum is
//     the one an unchunked fold would make, in the same order), and the
//     chunk loop is not unrolled: any T takes the registers and code of
//     one chunk.
//   * load_rows (instead of the fold): H hop-major rows of M complex
//     values copied straight into the plane by cp.async, consecutive
//     threads on consecutive values; rows outside [0, Nh) load as zero.
//   * transform: the block's (H x M) plane sits in shared memory, each
//     hop's row padded by one float2 every 32 against bank conflicts.  An
//     f32 Stockham autosort FFT runs in place on it, over the plan of
//     M = 2^a · r, r odd: passes of radix 16 while four bits of 2^a
//     remain, then one of 2, 4 or 8, then one pass per odd prime factor
//     of r in ascending order (a power of two keeps the radix-16 plan
//     alone).  Pass p has Ns = the product of the radices before it;
//     butterfly j of a hop reads R values at stride M/R, multiplies value
//     r by the twiddle W_M^{(j mod Ns) r M/(Ns R)}, runs its R-point DFT
//     in registers (radix 16 as 4 x 4; 3, 5 and 7 by the pair symmetry
//     of their real and imaginary parts) and writes them at
//     (j/Ns)·Ns·R + j mod Ns + r·Ns.  A thread holds up to 16 complex
//     values of a batch of whole hops between the batch's read and its
//     write, with a barrier between, so no pass needs a second buffer;
//     where a thread's butterflies do not divide into whole hops, the
//     last lanes of a batch sit idle.  Past M = 3584 a radix 3, 5 or 7
//     pass may have more butterflies a hop than 256 threads hold at 16
//     values; there a thread holds ceil(M/R/256) butterflies (up to 21
//     values), so a batch always holds a whole hop.  A prime q >= 11
//     runs the generic pass (gpass): each of the q outputs of a
//     butterfly is a q-term sum
//     X[g·Ns·q + o] = sum_r x[j + r·M/q] W_{Ns·q}^{r·o}, twiddle
//     included, with W_{Ns·q}^e read from a whole W_M table; a thread
//     holds 8 outputs of its batch between read and write (16 past M =
//     2048, so that a batch holds a whole hop), summing 8 at a time.
//     Channel k ends at row position k: natural order, no index map.  The twiddles
//     come from a table (fft_twiddle_offset) that the wrapper builds in
//     float64 and casts to f32, laid out so that consecutive butterflies
//     read consecutive entries; the butterflies' own constants head it:
//     W_16^1..3 (at M = 8 only W_16^2 = W_8^1 is a power of W_M, and the
//     only one read), then, where M is not a power of two, W_3, W_5^1..2
//     and W_7^1..3 (each a power of W_M wherever its radix is in the plan).
//     Up to M = 2048 the block copies the table into shared memory beside
//     the plane; past 2048 the plane alone takes a block's shared memory
//     (six hops at M = 4096: 202,800 bytes of the 232,448), so the passes
//     read the table (32.7 KB at 4096) from device memory through the
//     read-only cache, where it stays.
//   * every hop runs the same instruction sequence wherever it sits in
//     the run: multiplies are __fmul_rn or explicit fmaf, adds __fadd_rn,
//     so nvcc contracts nothing differently from hop to hop and chained
//     calls equal one call bit for bit.
// The caller's epilogue reads y(l, c, n) -- tile hop l, the block's
// channel c, with the hop sign of stream hop n -- from the plane, which
// doubles as the store stage.
//
// Past M = 4096 one hop's plane no longer fits a block six times over
// (K3's run at sps = 3), so a thread-block cluster of C blocks on
// neighbouring SMs shares each hop, decimated in time: C is the smallest
// divisor of M from 2 to 8 with N = M/C <= 4096 (fft_ranks; 2 for every
// even M up to 8192, 3 .. 8 past it, up to M = 32768), and
//   F_s[c] = FFT_N(f[C·m + s])[c],
//   y[rN + c] = sum_s W_M^{s(rN + c)} F_s[c]   (s, r < C, c < N).
//   * Rank r of the cluster folds (or loads) the part f[C·m + r] of every
//     hop of the run into its own N-wide plane and transforms it with the
//     tile's plan at width N -- the passes above, unchanged -- so each
//     block holds six hops at N = 4096 (202,800 bytes) as at M = 4096.
//   * The pass across the cluster leaves rank r the channels rN ..
//     rN+N-1, a contiguous range in natural order, so that K1-K3's
//     epilogues run on the block's N channels at an offset (k0 = rN).
//     Per hop, each thread reads its channels' values from its own plane
//     and from the others' (distributed shared memory), computes y, and
//     holds it in registers across a cluster barrier (arrive.release /
//     wait.acquire), after which every rank has read that hop of this
//     plane and the write goes in place.  A cluster barrier before the
//     first hop (every plane transformed) and after the last (every plane
//     done; K4 then reads the others' planes) bracket it, so no block
//     exits or refills its plane while another may still read it.
//   * C = 2 (combine, up to M = 8192): y[c] = E[c] + W_M^c O[c], y[c + N]
//     = E[c] - W_M^c O[c], with E = F_0, O = F_1; its twiddles W_M^c,
//     c < N, are a block of their own after the N-point plan's table
//     (fft_table_size), whose W_N^e are the same numbers as W_M^{2e}.
//     The other split (rank r owning k and k + N for a quarter of k)
//     reads half as much of the partner, but scatters each block's
//     channels over two ranges; the contiguous half was taken for the
//     simpler epilogues.
//   * C > 2 (cross): rank s first turns its plane into G_s[c] = W_M^{s·c}
//     F_s[c] in place (a thread reads each of its channels' twiddle once
//     for all H hops), then
//       y[rN + c] = G_0[c] + sum_{s=1}^{C-1} W_C^{s·r} G_s[c],
//     s ascending, each term two fmaf a part; its tables are the blocks
//     W_M^{s·c} (1 <= s < C, c < N) and W_C^e (e < C) after the plan's.
//     It reads C - 1 remote values a channel and hop.
//   * Every rank computes its sum with the same instructions, and every
//     hop the same sequence, so chained calls still equal one.
//
// Past M = 8192 a width that no cluster of up to 8 blocks splits (an even
// M up to 16384 whose half has no factor 2 .. 7 leaving M/C <= 4096:
// 8194 = 2·17·241, 16382 = 2·8191, 937 widths) runs Bluestein's chirp
// transform (fft_bluestein, LB = L = 32768 >= 2M - 1), an instantiation
// of its own: with the chirp w[n] = e^{-jπn²/M},
//   X[k] = w[k] sum_n (x[n] w[n]) conj(w[k - n]),
// a circular convolution of length L on the cluster of 8 blocks of 4096
// points that the split width L = 32768 runs:
//   * chirp_in: rank r folds (or loads) x[8c + r] for the c < NC =
//     ceil(M/8) with 8c + r < M (fold_rows, load_rows), multiplies each
//     by the chirp and zeroes every other position of its plane;
//   * the plan at N = 4096 and cross at L: rank r holds A[rN + c];
//   * icross: Z = conj(A·B) in place (B = FFT_L(b) / L of the conjugate
//     chirp b, a table), then the inverse's pass across the cluster,
//     decimated in frequency: rank s's plane becomes
//       V_s[c] = W_L^{s·c} sum_r W_8^{r·s} Z_r[c]
//     (cross's tables, read and held across a cluster barrier hop by hop
//     as in cross), whose N-point transform, the plan again, is
//     conj(z[8m + s]), z the convolution;
//   * chirp_out: channel k = 8m + s < M is w[k] z[k], at rank k mod 8,
//     position k / 8 (channel(), holds(), owner(), slot()), so the
//     epilogues and K4's reads follow the map instead of k0 + c.
// The table is L's (the plan's at 4096, W_L^{s·c}, W_8^e), then the
// chirp in 8 rows of NC (row r: w[8c + r], zero past M; the angle from
// n² mod 2M in exact integers and float64) and B, in device memory.
// Every split width keeps its instructions: the mode is `if constexpr`.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kFftThreads = 256;
constexpr int kFftChunkT = 16;   // taps a fold chunk holds in registers
constexpr int kFftValues = 16;   // complex values a thread holds in a pass

// the widest transform one block runs; past it a cluster of up to
// kFftClusterSize blocks (the portable cluster size) splits each hop
// (fft_ranks)
constexpr int kFftBlockWidth = 4096;
constexpr int kFftClusterSize = 8;
constexpr int kFftMaxWidth = kFftClusterSize * kFftBlockWidth;
constexpr int kFftMaxSmem = 232448;   // shared memory a block may opt in to
// the widest M whose twiddle table sits in shared memory beside the plane;
// past it the passes read the table from device memory
constexpr int kFftSharedTwiddleWidth = 2048;
// plane bytes a block of the analysis kernel may hold at a width that is
// not a power of two: ~100 KB, the plane of M = 1024's 12 hops
constexpr int kFftPlaneBudget = 102400;

__host__ __device__ constexpr bool fft_pow2(int M) {
  return (M & (M - 1)) == 0;
}
// blocks of a cluster that share a hop at bank width M: 1 up to
// kFftBlockWidth; past it the smallest C from 2 to kFftClusterSize that
// divides M with M/C <= kFftBlockWidth (0: no such C, M not taken)
__host__ __device__ constexpr int fft_ranks(int M) {
  if (M <= kFftBlockWidth) return 1;
  for (int c = 2; c <= kFftClusterSize; ++c)
    if (M % c == 0 && M / c <= kFftBlockWidth) return c;
  return 0;
}
// Bluestein's length at bank width M: L = kFftMaxWidth for every even M
// up to kFftMaxWidth / 2 that no cluster splits (fft_ranks(M) == 0: 937
// widths in (8192, 16384], 8194 the first), whose M-point DFT the tile
// computes as a chirp convolution of length L >= 2M - 1 (below); 0 for
// every other M
__host__ __device__ constexpr int fft_bluestein(int M) {
  return M % 2 == 0 && 2 * M <= kFftMaxWidth && fft_ranks(M) == 0
             ? kFftMaxWidth
             : 0;
}
// blocks of the cluster that runs bank width M: fft_ranks(M), or in the
// Bluestein mode those of its length L (8)
__host__ __device__ constexpr int fft_blocks(int M) {
  return fft_bluestein(M) ? fft_ranks(fft_bluestein(M)) : fft_ranks(M);
}
// the transform width of one block: M, or M/C in a cluster of C, or in
// the Bluestein mode L/C (4096)
__host__ __device__ constexpr int fft_width(int M) {
  return (fft_bluestein(M) ? fft_bluestein(M) : M) / fft_blocks(M);
}
// plane positions of a block that hold channels: its fft_width(M), or in
// the Bluestein mode ceil(M/C), position c of rank r holding channel
// C·c + r where that is below M
__host__ __device__ constexpr int fft_channels(int M) {
  return fft_bluestein(M) ? (M + fft_blocks(M) - 1) / fft_blocks(M)
                          : fft_width(M);
}
// hop stride of the plane: one float2 of padding every 32
__host__ __device__ constexpr int fft_hop_stride(int M) {
  return M + M / 32 + 1;
}
__host__ __device__ constexpr bool fft_shared_twiddles(int M) {
  return M <= kFftSharedTwiddleWidth;
}
// past kFftSharedTwiddleWidth, the hops a block of any of the four kernels
// computes: the most even hops (up to 16) whose plane fits in a block's
// shared memory -- 12 at M = 2050, 8 at 3072, 6 at 4096 and, with a
// block's plane of M/C, 6 at 8192 and 16384 -- so that K3 at sps = 3 (one hop
// behind, two ahead, whole symbols) owns 3 of them
__host__ __device__ constexpr int fft_fit_hops(int M) {
  const int h = kFftMaxSmem / (8 * fft_hop_stride(fft_width(M)));
  return h >= 16 ? 16 : h & ~1;
}
// analysis hops a block of the analysis kernel computes at width M: ~100
// KB of plane at M=1024, so two blocks share an SM; at a width up to 2048
// that is not a power of two the most even hops (2 .. 16) whose plane
// fits in kFftPlaneBudget; past 2048 fft_fit_hops
__host__ __device__ constexpr int fft_tile_hops(int M) {
  if (!fft_shared_twiddles(M)) return fft_fit_hops(M);
  if (!fft_pow2(M)) {
    const int h = kFftPlaneBudget / (8 * fft_hop_stride(M));
    return h >= 16 ? 16 : (h < 2 ? 2 : h & ~1);
  }
  return M <= 512 ? 16 : (M == 1024 ? 12 : 4);
}
// hops a block of the kernels with a heavier epilogue computes (rx_front,
// rx_phases, synth): twice the analysis kernel's, since their 4-byte rows
// need twice the hops to fill the same sectors; one block an SM at M=1024;
// past 2048 fft_fit_hops, as the analysis kernel
__host__ __device__ constexpr int fft_wide_hops(int M) {
  return fft_shared_twiddles(M) ? 2 * fft_tile_hops(M) : fft_fit_hops(M);
}
// blocks of the analysis and receive kernels an SM is built for: two up
// to 2048, one past it, where one block's plane takes the SM's shared
// memory (and the passes may hold up to 21 values a thread)
__host__ __device__ constexpr int fft_min_blocks(int M) {
  return fft_shared_twiddles(M) ? 2 : 1;
}
// a = the exponent of 2 in M, r = M / 2^a
__host__ __device__ constexpr int fft_twos(int M) {
  return M % 2 ? 0 : 1 + fft_twos(M / 2);
}
__host__ __device__ constexpr int fft_pow2_passes(int M) {
  return fft_twos(M) / 4 + (fft_twos(M) % 4 ? 1 : 0);
}
// radix of pass p, 0 past the plan: 16 while four bits of 2^a remain,
// then one pass of 2, 4 or 8, then the odd prime factors of r ascending
__host__ __device__ constexpr int fft_radix(int M, int p) {
  const int a = fft_twos(M);
  if (p < a / 4) return 16;
  if (a % 4 && p == a / 4) return 1 << (a % 4);
  p -= fft_pow2_passes(M);
  int r = M >> a, q = 3;
  while (r > 1) {
    if (r % q) {
      q += 2;
    } else {
      if (p-- == 0) return q;
      r /= q;
    }
  }
  return 0;
}
__host__ __device__ constexpr int fft_passes(int M) {
  int p = 0;
  while (fft_radix(M, p)) ++p;
  return p;
}
// a prime radix with no register butterfly: the generic pass
__host__ __device__ constexpr bool fft_generic(int R) {
  return R % 2 == 1 && R > 7;
}
// Ns of pass p: the product of the radices before it
__host__ __device__ constexpr int fft_ns(int M, int p) {
  return p == 0 ? 1 : fft_ns(M, p - 1) * fft_radix(M, p - 1);
}
// the butterflies' constants at the head of the table: W_16^1..3, and
// where M is not a power of two W_3, W_5^1..2, W_7^1..3
__host__ __device__ constexpr int fft_head_size(int M) {
  return fft_pow2(M) ? 3 : 9;
}
__host__ __device__ constexpr int fft_head_offset(int R) {
  return R == 3 ? 3 : (R == 5 ? 4 : 6);
}
// The twiddle table: the head, then for each pass p > 0 with a register
// butterfly the (R-1) x Ns block tw[off_p + (r-1)·Ns + jm] =
// W_M^{jm·r·M/(Ns·R)}, so that consecutive butterflies read consecutive
// entries; a generic pass has no block.  Where the plan has a generic
// pass, the whole W_M^e, e < M, follows at fft_twiddle_offset(M,
// fft_passes(M)).
__host__ __device__ constexpr int fft_twiddle_offset(int M, int p) {
  return p <= 1 ? fft_head_size(M)
                : fft_twiddle_offset(M, p - 1) +
                      (fft_generic(fft_radix(M, p - 1))
                           ? 0
                           : (fft_radix(M, p - 1) - 1) * fft_ns(M, p - 1));
}
__host__ __device__ constexpr bool fft_has_generic(int M) {
  for (int p = 0; fft_radix(M, p); ++p)
    if (fft_generic(fft_radix(M, p))) return true;
  return false;
}
__host__ __device__ constexpr int fft_twiddle_size(int M) {
  return fft_twiddle_offset(M, fft_passes(M)) + (fft_has_generic(M) ? M : 0);
}
// the whole table of bank width M: the plan's table at the transform
// width N; in a cluster of C then the twiddles of the pass across it,
// W_M^{s·c} for 1 <= s < C, c < N (at C = 2 the combine's W_M^c), and
// past C = 2 the C constants W_C^e.  In the Bluestein mode that is the
// table of L (W_L for W_M), and then the chirp, C rows of
// fft_channels(M) (row r: w[C·c + r], zero past M), and B, L values
__host__ __device__ constexpr int fft_table_size(int M) {
  return fft_twiddle_size(fft_width(M)) + (fft_blocks(M) - 1) * fft_width(M) +
         (fft_blocks(M) > 2 ? fft_blocks(M) : 0) +
         (fft_bluestein(M)
              ? fft_blocks(M) * fft_channels(M) + fft_bluestein(M)
              : 0);
}
// shared memory of a block of H hops at bank width M: the plane (a
// block's fft_width(M) channels), and the table up to
// kFftSharedTwiddleWidth
__host__ __device__ constexpr int fft_smem_bytes(int M, int H) {
  return 8 * (H * fft_hop_stride(fft_width(M)) +
              (fft_shared_twiddles(M) ? fft_twiddle_size(M) : 0));
}

// Calls f(std::integral_constant<int, M>) for the widths this library
// instantiates -- every power of two from 2 to 4096, or, in a library
// built with -DAMPS_FFT_WIDTH=M (any other width, the cluster widths past
// 4096 included), that one width --; returns -1 for any other M.
template <class F>
int with_width(int M, F f) {
#ifdef AMPS_FFT_WIDTH
  return M == AMPS_FFT_WIDTH
             ? f(std::integral_constant<int, AMPS_FFT_WIDTH>{})
             : -1;
#else
  switch (M) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 2048: return f(std::integral_constant<int, 2048>{});
    case 4096: return f(std::integral_constant<int, 4096>{});
    default: return -1;
  }
#endif
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -__fmul_rn(a.y, w.y)),
                     fmaf(a.x, w.y, __fmul_rn(a.y, w.x)));
}
__device__ __forceinline__ float2 mul_mi(float2 a) {   // -i·a
  return make_float2(a.y, -a.x);
}

// In-register forward R-point DFT, natural order in and out.
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a = cadd(v0, v2), b = csub(v0, v2);
  const float2 c = cadd(v1, v3), d = mul_mi(csub(v1, v3));
  v0 = cadd(a, c);
  v1 = cadd(b, d);
  v2 = csub(a, c);
  v3 = csub(b, d);
}
// c = {W_16^1, W_16^2, W_16^3}, read from the twiddle table
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R], const float2 (&c)[3]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 16) {
    // 4 x 4: DFTs over n2 of v[n1 + 4 n2], the twiddle W_16^{n1 k2}, DFTs
    // over n1; V[k2 + 4 k1]
    float2 x[4][4];
#pragma unroll
    for (int n1 = 0; n1 < 4; ++n1) {
      x[n1][0] = v[n1];
      x[n1][1] = v[n1 + 4];
      x[n1][2] = v[n1 + 8];
      x[n1][3] = v[n1 + 12];
      dft4(x[n1][0], x[n1][1], x[n1][2], x[n1][3]);
    }
    const float2 w6 = mul_mi(c[1]);          // W_16^6 = -i W_16^2
    x[1][1] = cmul(x[1][1], c[0]);
    x[1][2] = cmul(x[1][2], c[1]);
    x[1][3] = cmul(x[1][3], c[2]);
    x[2][1] = cmul(x[2][1], c[1]);
    x[2][2] = mul_mi(x[2][2]);
    x[2][3] = cmul(x[2][3], w6);
    x[3][1] = cmul(x[3][1], c[2]);
    x[3][2] = cmul(x[3][2], w6);
    const float2 t = cmul(x[3][3], c[0]);   // W_16^9 = -W_16^1
    x[3][3] = make_float2(-t.x, -t.y);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      dft4(x[0][k2], x[1][k2], x[2][k2], x[3][k2]);
      v[k2] = x[0][k2];
      v[k2 + 4] = x[1][k2];
      v[k2 + 8] = x[2][k2];
      v[k2 + 12] = x[3][k2];
    }
  } else {
    static_assert(R == 8, "radix 2, 4, 8 or 16");
    const float c8 = c[1].x;
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    dft4(e[0], e[1], e[2], e[3]);
    dft4(o[0], o[1], o[2], o[3]);
    // W_8^1 = √½(1 - i), W_8^2 = -i, W_8^3 = -√½(1 + i)
    o[1] = make_float2(__fmul_rn(c8, __fadd_rn(o[1].x, o[1].y)),
                       __fmul_rn(c8, __fsub_rn(o[1].y, o[1].x)));
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(__fmul_rn(c8, __fsub_rn(o[3].y, o[3].x)),
                       -__fmul_rn(c8, __fadd_rn(o[3].x, o[3].y)));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cadd(e[k], o[k]);
      v[k + 4] = csub(e[k], o[k]);
    }
  }
}

// In-register forward R-point DFT, R = 3, 5 or 7, natural order in and
// out; c = W_R^1 .. W_R^{(R-1)/2}, read from the twiddle table.  With
// a_k = v_k + v_{R-k}, b_k = v_k - v_{R-k} and W_R^e = (C_e, S_e):
//   X_m, X_{R-m} = v_0 + sum_k C_{km} a_k  ±  i sum_k S_{km} b_k
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&v)[R],
                                        const float2 (&c)[(R - 1) / 2]) {
  constexpr int HR = (R - 1) / 2;
  float2 a[HR], b[HR];
  float2 x0 = v[0];
#pragma unroll
  for (int k = 1; k <= HR; ++k) {
    a[k - 1] = cadd(v[k], v[R - k]);
    b[k - 1] = csub(v[k], v[R - k]);
    x0 = cadd(x0, a[k - 1]);
  }
#pragma unroll
  for (int m = 1; m <= HR; ++m) {
    float re = v[0].x, ri = v[0].y, tr = 0.f, ti = 0.f;
#pragma unroll
    for (int k = 1; k <= HR; ++k) {
      const int e = k * m % R;   // W_R^e = conj(W_R^{R-e}) past R/2
      const float2 w = c[(e <= HR ? e : R - e) - 1];
      const float s = e <= HR ? w.y : -w.y;
      re = fmaf(w.x, a[k - 1].x, re);
      ri = fmaf(w.x, a[k - 1].y, ri);
      tr = fmaf(s, b[k - 1].x, tr);
      ti = fmaf(s, b[k - 1].y, ti);
    }
    v[m] = make_float2(__fsub_rn(re, ti), __fadd_rn(ri, tr));
    v[R - m] = make_float2(__fadd_rn(re, ti), __fsub_rn(ri, tr));
  }
  v[0] = x0;
}

// kLoop: the kernel runs the tile again and again in a loop (synth.cu's
// passes), beside state it holds in registers across the loop.  M is the
// bank's width; past kFftBlockWidth the tile is one rank of a cluster of
// RK blocks, whose plane holds N = M/RK channels (in the Bluestein mode
// N = L/RK positions, NC of them channels).
template <int M, int H_, bool kLoop = false>
struct FftTile {
  static constexpr int P = M / 2;
  static constexpr int LB = fft_bluestein(M);  // Bluestein's L, or 0
  static constexpr int RK = fft_blocks(M);     // blocks of the cluster
  static constexpr int N = fft_width(M);       // transform width
  static constexpr int NC = fft_channels(M);   // positions holding channels
  static constexpr int H = H_;                 // analysis hops of a block
  static constexpr int FH = H / 2;             // hops a thread folds
  static constexpr int HS = fft_hop_stride(N);  // hop stride of the plane
  static constexpr int TWN = fft_table_size(M);
  static constexpr int kSmemBytes = fft_smem_bytes(M, H);
  // taps of a chunk of a long filter's fold: kFftChunkT, or 8 where a
  // thread folds 16 hops or the plan has the generic pass, where K3's
  // long-filter instantiations spilled 4-104 bytes with 16 (ptxas, M =
  // 160, 256, 448, 512, 2038); the sum is the same either way
  static constexpr int kFoldChunk =
      FH >= 16 || fft_has_generic(N) ? 8 : kFftChunkT;
  static constexpr bool kSharedTw = fft_shared_twiddles(M);
  static_assert(H % 2 == 0 && M >= 2 && M <= kFftMaxWidth && M % 2 == 0 &&
                    RK > 0 && RK * N == (LB ? LB : M),
                "even widths 2 .. 16384 (past 8192 M = C·N with C <= 8, "
                "N <= 4096, or Bluestein's L), past it M = C·N");
  static_assert(N <= kFftBlockWidth, "a block transforms at most 4096");
  static_assert(kSmemBytes <= kFftMaxSmem, "the plane fits a block");

  float2* S;   // [H][HS] the plane
  // [TWN] the twiddle table: in shared memory after the plane, or (past
  // kFftSharedTwiddleWidth) the wrapper's table in device memory
  const float2* W;
  // the block's first channel (rank · N in a cluster, 0 alone; the rank
  // in the Bluestein mode)
  int k0;

  __device__ __forceinline__ explicit FftTile(float* smem)
      : S(reinterpret_cast<float2*>(smem)), W(S + H * HS),
        k0(RK > 1 ? (LB ? rank() : rank() * N) : 0) {}

  // the channel at plane position c: k0 + c, or in the Bluestein mode
  // RK·c + rank; and whether position c holds one (only in the Bluestein
  // mode not: where RK·c + rank >= M).  The epilogues test
  // `!Tile::LB || tile.holds(c)`: a bare `tile.holds(c)`, though always
  // true at a split width, changed the split widths' SASS (K1-K3)
  __device__ __forceinline__ int channel(int c) const {
    return LB ? RK * c + k0 : k0 + c;
  }
  __device__ __forceinline__ bool holds(int c) const {
    return !LB || RK * c + k0 < M;
  }
  // the rank and the position whose plane holds channel k after fft(): k
  // / N and k mod N, or in the Bluestein mode k mod RK and k / RK
  __device__ __forceinline__ static int owner(int k) {
    return LB ? k % RK : k / N;
  }
  __device__ __forceinline__ static int slot(int k) {
    return LB ? k / RK : k % N;
  }

  // the block's rank in its cluster (0 alone), read afresh at each use
  __device__ __forceinline__ static int rank() {
    if constexpr (RK > 1) return static_cast<int>(cluster_rank());
    else return 0;
  }

  __device__ __forceinline__ static int pad(int i) { return i + (i >> 5); }

  __device__ __forceinline__ void load_twiddles(const float2* __restrict__ tw) {
    if constexpr (kSharedTw) {
      float2* w = S + H * HS;
      for (int i = threadIdx.x; i < TWN; i += kFftThreads) w[i] = __ldg(tw + i);
    } else {
      W = tw;
    }
  }
  // a twiddle of the table, read where the table lies
  __device__ __forceinline__ static float2 ld(const float2* w) {
    if constexpr (kSharedTw) return *w;
    else return __ldg(w);
  }
  // the thread's index in the row loader and the passes: in a kernel
  // that loops over the tile, read afresh at each use, so that nvcc
  // recomputes each pass's index arithmetic instead of hoisting all of it
  // out of the loop into registers the loop's own state needs
  // (threadIdx.x itself, unsigned, outside a loop; an int in a loop,
  // whose signed index arithmetic ptxas fits beside K4's ring at every
  // width, where the unsigned form spills at M = 4094)
  __device__ __forceinline__ static auto tid() {
    if constexpr (kLoop) {
      int t;
      asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
      return t;
    } else {
      return threadIdx.x;
    }
  }

  // The folded windows of hops a0 .. a0+H-1 into the plane (in a
  // cluster of RK, the block's part f[RK·m + rank], m < NC and, in the
  // Bluestein mode, RK·m + rank < M).  x is (n_ext, 2)
  // interleaved or (2, n_ext) planar, n_ext a multiple of P.  A kernel
  // instantiated for kLongT takes T > kFftChunkT, in chunks of
  // kFoldChunk taps; one without it T <= kFftChunkT, so that a long
  // filter's fold never costs a short one registers.
  template <bool kLongT = false>
  __device__ __forceinline__ void fold(const float* __restrict__ x,
                                       int planar, long long n_ext,
                                       const float* __restrict__ coef, int T,
                                       int a0) {
    if constexpr (kLongT) {
      if (planar) fold_rows<true, kFoldChunk, true>(x, n_ext, coef, T, a0);
      else fold_rows<false, kFoldChunk, true>(x, n_ext, coef, T, a0);
    } else if (T <= 8) {
      if (planar) fold_rows<true, 8>(x, n_ext, coef, T, a0);
      else fold_rows<false, 8>(x, n_ext, coef, T, a0);
    } else {
      if (planar) fold_rows<true, kFftChunkT>(x, n_ext, coef, T, a0);
      else fold_rows<false, kFftChunkT>(x, n_ext, coef, T, a0);
    }
  }

  // Hop-major rows n0 .. n0+H-1 of Y ((Nh, M) complex) into the plane
  // (in a cluster of RK, the block's values k = RK·c + rank of each row,
  // c < NC), by cp.async (consecutive threads on consecutive c, all
  // copies in flight together); rows outside [0, Nh), and k >= M in the
  // Bluestein mode, load as zero.  Ends with the copies landed and a
  // barrier.
  __device__ __forceinline__ void load_rows(const float2* __restrict__ Y,
                                            int n0, int Nh) {
#pragma unroll 4
    for (int e = tid(); e < H * NC; e += kFftThreads) {
      const int l = e / NC, c = e % NC;
      const int k = RK > 1 ? RK * c + rank() : c;
      const int n = n0 + l;
      const bool ok = n >= 0 && n < Nh && (!LB || k < M);
      cp_async<8>(S + l * HS + pad(c),
                  Y + (ok ? static_cast<size_t>(n) * M + k : 0), ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  // fold for T <= MT: all FH + MT - 1 rows are loaded before any tap
  // adds (a row past the taps or outside the input loads as zero, its
  // coefficient is zero), so a thread's loads are in flight together.
  // CHUNKED (T > MT): the same for each chunk of MT taps t0 .. t0+MT-1,
  // in order, each hop's sum carried from chunk to chunk in the thread's
  // own cell of the plane
  template <bool PLANAR, int MT, bool CHUNKED = false>
  __device__ __forceinline__ void fold_rows(const float* __restrict__ x,
                                            long long n_ext,
                                            const float* __restrict__ coef,
                                            int T, int a0) {
    const long long nrow = n_ext / P;
#pragma unroll 1
    for (int it = threadIdx.x; it < 2 * NC; it += kFftThreads) {
      const int g = it / NC, c = it % NC;   // hops g, g + 2, ... of the tile
      const int m = RK > 1 ? RK * c + rank() : c;  // the window's sample
      if constexpr (LB) {
        if (m >= M) continue;               // no sample: chirp_in zeroes it
      }
      const int hi = m >= P ? 1 : 0, col = m - hi * P;
#pragma unroll 1
      for (int t0 = 0; t0 < (CHUNKED ? T : 1); t0 += MT) {
        const int TC = CHUNKED ? min(MT, T - t0) : T;   // the chunk's taps
        float cf[MT];
        float2 xv[FH + MT - 1];
#pragma unroll
        for (int t = 0; t < MT; ++t)
          cf[t] = t < TC ? __ldg(coef + (t0 + t) * M + m) : 0.f;
#pragma unroll
        for (int i = 0; i < FH + MT - 1; ++i) {
          const long long row = a0 + g + 2 * (t0 + i) + hi;
          const bool ok = i < FH + TC - 1 && row >= 0 && row < nrow;
          const long long s = ok ? row * P + col : 0;
          const float2 v =
              PLANAR ? make_float2(__ldg(x + s), __ldg(x + n_ext + s))
                     : __ldg(reinterpret_cast<const float2*>(x) + s);
          xv[i] = ok ? v : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < FH; ++j) {
          float2* f = S + (g + 2 * j) * HS + pad(c);
          float fr = 0.f, fi = 0.f;
          if (CHUNKED && t0 > 0) {
            fr = f->x;
            fi = f->y;
          }
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            fr = fmaf(cf[t], xv[j + t].x, fr);
            fi = fmaf(cf[t], xv[j + t].y, fi);
          }
          *f = make_float2(fr, fi);
        }
      }
    }
  }

  // One Stockham pass of radix R after passes whose radices multiply to
  // Ns, over batches of whole hops; ends with a barrier.
  template <int R, int Ns, int OFF>
  __device__ __forceinline__ void pass() {
    constexpr int IH = N / R;                    // butterflies per hop
    // butterflies a thread holds: kFftValues / R, or as many as a whole
    // hop needs (a radix 3, 5 or 7 past N = 3584)
    constexpr int IPT = kFftValues / R * kFftThreads >= IH
                            ? kFftValues / R
                            : (IH + kFftThreads - 1) / kFftThreads;
    constexpr int HB = kFftThreads * IPT / IH;   // hops per batch
    // lanes e >= HB·IH of a batch sit idle where the hops do not fill it
    constexpr bool kFull = kFftThreads * IPT == HB * IH;
    static_assert(HB >= 1, "a batch holds a whole hop");
    const float2 c[3] = {ld(W), ld(W + 1), ld(W + 2)};
    float2 co[R % 2 ? (R - 1) / 2 : 1];
    if constexpr (R % 2) {
#pragma unroll
      for (int i = 0; i < (R - 1) / 2; ++i)
        co[i] = ld(W + fft_head_offset(R) + i);
    }
#pragma unroll 1
    for (int b = 0; b < (H + HB - 1) / HB; ++b) {
      float2 v[IPT][R];
#pragma unroll
      for (int q = 0; q < IPT; ++q) {
        const int e = tid() + q * kFftThreads;
        const int hop = b * HB + e / IH, j = e % IH;
        if ((kFull || e < HB * IH) && hop < H) {
          const float2* h = S + hop * HS;
#pragma unroll
          for (int r = 0; r < R; ++r) v[q][r] = h[pad(j + r * IH)];
          if (Ns > 1) {
            const float2* w = W + OFF + j % Ns;
#pragma unroll
            for (int r = 1; r < R; ++r)
              v[q][r] = cmul(v[q][r], ld(w + (r - 1) * Ns));
          }
          if constexpr (R % 2) dft_odd<R>(v[q], co);
          else dft<R>(v[q], c);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < IPT; ++q) {
        const int e = tid() + q * kFftThreads;
        const int hop = b * HB + e / IH, j = e % IH;
        if ((kFull || e < HB * IH) && hop < H) {
          float2* h = S + hop * HS;
          const int d = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
          for (int r = 0; r < R; ++r) h[pad(d + r * Ns)] = v[q][r];
        }
      }
      __syncthreads();
    }
  }

  // The generic pass of an odd prime Q >= 11 after passes whose radices
  // multiply to Ns: output t = g·NQ + o of a hop (NQ = Ns·Q) is
  //   sum_r x[j + r·N/Q] W_NQ^{r·o},  j = g·Ns + o mod Ns,
  // the butterfly's twiddle and Q-point DFT in one sum, W_NQ^e read as
  // W_N^{e·N/NQ} from the table's whole W_N.  A thread holds kGenOut
  // outputs of a batch of whole hops (8, or 16 past N = 2048; lanes past
  // the hops sit idle) and sums them 8 at a time; the terms
  // add in order r = 0, 1, ... (fmaf), in runs of kGenRun whose sums
  // then add in order, which keeps a long sum's f32 error near that of
  // the short radices.  Ends with a barrier.
  template <int Q, int Ns>
  __device__ __forceinline__ void gpass() {
    constexpr int kGenSum = kFftValues / 2;      // outputs summed at once
    // outputs a thread holds
    constexpr int kGenOut = kGenSum * kFftThreads >= N
                                ? kGenSum
                                : (N + kFftThreads * kGenSum - 1) /
                                      (kFftThreads * kGenSum) * kGenSum;
    constexpr int kGenRun = 32;    // terms summed apart before they join
    constexpr int NQ = Ns * Q, IH = N / Q, STEP = N / NQ;
    constexpr int HB = kFftThreads * kGenOut / N;   // hops per batch
    static_assert(HB >= 1, "a batch holds a whole hop");
    const float2* wm = W + fft_twiddle_offset(N, fft_passes(N));
#pragma unroll 1
    for (int b = 0; b < (H + HB - 1) / HB; ++b) {
      float2 acc[kGenOut];
#pragma unroll
      for (int i0 = 0; i0 < kGenOut; i0 += kGenSum) {
        // the row of output i's hop: one row where a batch is one hop
        // (every output that is live sits in hop b)
        const float2* x[HB == 1 ? 1 : kGenSum];
        int idx[kGenSum], step[kGenSum], ex[kGenSum];
#pragma unroll
        for (int i = 0; i < kGenSum; ++i) {
          const int e = tid() + (i0 + i) * kFftThreads;
          const int hop = b * HB + e / N, t = e % N;
          const bool live = e < HB * N && hop < H;
          const int o = t % NQ, j = (t / NQ) * Ns + o % Ns;
          if constexpr (HB == 1) x[0] = S + b * HS;
          else x[i] = S + (live ? hop : 0) * HS;
          idx[i] = live ? j : 0;           // x index of term r: j + r·IH
          step[i] = live ? o * STEP : 0;   // W_N exponent step, < N
          ex[i] = 0;                       // W_N exponent of term r
          acc[i0 + i] = make_float2(0.f, 0.f);
        }
#pragma unroll 1
        for (int r0 = 0; r0 < Q; r0 += kGenRun) {
          float2 part[kGenSum];
#pragma unroll
          for (int i = 0; i < kGenSum; ++i) part[i] = make_float2(0.f, 0.f);
#pragma unroll 1
          for (int r = r0; r < min(r0 + kGenRun, Q); ++r) {
#pragma unroll
            for (int i = 0; i < kGenSum; ++i) {
              const float2 v = x[HB == 1 ? 0 : i][pad(idx[i] + r * IH)];
              const float2 w = ld(wm + ex[i]);
              part[i].x = fmaf(v.x, w.x, fmaf(-v.y, w.y, part[i].x));
              part[i].y = fmaf(v.x, w.y, fmaf(v.y, w.x, part[i].y));
              ex[i] += step[i];
              if (ex[i] >= N) ex[i] -= N;
            }
          }
#pragma unroll
          for (int i = 0; i < kGenSum; ++i)
            acc[i0 + i] = cadd(acc[i0 + i], part[i]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kGenOut; ++i) {
        const int e = tid() + i * kFftThreads;
        const int hop = b * HB + e / N, t = e % N;
        if (e < HB * N && hop < H) S[hop * HS + pad(t)] = acc[i];
      }
      __syncthreads();
    }
  }

  // a radix the generic pass runs: a prime >= 11, or, in a kernel that
  // loops over the tile beside state of its own, a radix 3, 5 or 7 whose
  // register pass would hold more than kFftValues values a thread, where
  // the table holds the whole W_N anyway (at M = 8190: N = 4095 =
  // 3²·5·7·13, where the register passes beside K4's state spilled)
  __host__ __device__ static constexpr bool generic_pass(int R) {
    return fft_generic(R) ||
           (kLoop && R % 2 == 1 && fft_has_generic(N) &&
            kFftValues / R * kFftThreads < N / R);
  }

  template <int p = 0, int Ns = 1>
  __device__ __forceinline__ void passes() {
    if constexpr (p < fft_passes(N)) {
      constexpr int R = fft_radix(N, p);
      if constexpr (generic_pass(R)) gpass<R, Ns>();
      else pass<R, Ns, fft_twiddle_offset(N, p)>();
      passes<p + 1, Ns * R>();
    }
  }

  // The transform of the block's plane; in a cluster then the pass across
  // it: radix 2 across a pair (combine), radix RK across more (cross).
  // In the Bluestein mode the chirp convolution of length LB around them
  // (above).  Ends with a barrier (a cluster barrier in a cluster).
  __device__ __forceinline__ void fft() {
    if constexpr (LB) {
      chirp_in();
      passes();
      cross();      // rank r holds A[rN + c]
      icross();     // rank s holds the inverse's input V_s
      passes();     // rank s holds conj(z[RK·m + s])
      chirp_out();
    } else {
      passes();
      if constexpr (RK == 2) combine();
      else if constexpr (RK > 2) cross();
    }
  }

  // Bluestein's input: each value f[RK·c + rank] of the plane times the
  // chirp w[RK·c + rank], and zero at every position that holds no
  // sample (c >= NC, or RK·c + rank >= M).  Ends with a barrier.
  __device__ __forceinline__ void chirp_in() {
    const float2* w = W + fft_table_size(LB) + k0 * NC;   // the rank's row
#pragma unroll 1
    for (int c = tid(); c < N; c += kFftThreads) {
      const bool live = c < NC && holds(c);
      const float2 wc = live ? ld(w + c) : make_float2(0.f, 0.f);
#pragma unroll 1
      for (int l = 0; l < H; ++l) {
        float2* f = S + l * HS + pad(c);
        *f = live ? cmul(*f, wc) : make_float2(0.f, 0.f);
      }
    }
    __syncthreads();
  }

  // Bluestein's spectral product and the inverse transform's pass across
  // the cluster, decimated in frequency.  With A_r[c] = A[rN + c] in rank
  // r's plane (after cross) and Z_r[c] = conj(A_r[c] B[rN + c]), B the
  // table's FFT_L of the conjugate chirp over L:
  //   V_s[c] = W_L^{s·c} sum_r W_RK^{r·s} Z_r[c],
  // r ascending, into rank s's plane (W_L^{s·c} and W_RK^e are cross's
  // tables), hop by hop as cross (read every plane, hold the sums across
  // a cluster barrier, write in place), so that FFT_N(V_s)[m] =
  // conj(z[RK·m + s]), z the convolution.  Ends with a barrier.
  __device__ __forceinline__ void icross() {
    constexpr int CV = (N + kFftThreads - 1) / kFftThreads;  // values a thread
    const int s = rank();
    const float2* wt = W + fft_twiddle_size(N);   // W_L^{s·c}: (RK-1) x N
    const float2* b = W + fft_table_size(LB) + RK * NC + s * N;
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int c = tid() + i * kFftThreads;
      if (c < N) {
        const float2 bc = ld(b + c);
#pragma unroll 1
        for (int l = 0; l < H; ++l) {
          float2* f = S + l * HS + pad(c);
          const float2 z = cmul(*f, bc);
          *f = make_float2(z.x, -z.y);
        }
      }
    }
    float2 wc[RK];   // W_RK^{r·s}
#pragma unroll
    for (int r = 0; r < RK; ++r) wc[r] = ld(wt + (RK - 1) * N + r * s % RK);
    cluster_sync();     // every plane's product written
#pragma unroll 1
    for (int l = 0; l < H; ++l) {
      unsigned far[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) far[r] = cluster_addr(S, r);
      float2 v[CV];
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N) {
          const int o = l * HS + pad(c);
          float2 acc = s == 0 ? S[o] : ld_cluster(far[0] + 8 * o);
#pragma unroll
          for (int r = 1; r < RK; ++r) {
            const float2 g = r == s ? S[o] : ld_cluster(far[r] + 8 * o);
            const float2 w = wc[r];
            acc.x = fmaf(g.x, w.x, fmaf(-g.y, w.y, acc.x));
            acc.y = fmaf(g.x, w.y, fmaf(g.y, w.x, acc.y));
          }
          v[i] = acc;
        }
      }
      cluster_sync();   // every rank has read hop l of this plane
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N)
          S[l * HS + pad(c)] = s > 0 ? cmul(v[i], ld(wt + (s - 1) * N + c))
                                     : v[i];
      }
    }
    __syncthreads();
  }

  // Bluestein's output: position c < NC of rank s holds conj(z[k]), k =
  // RK·c + s, and channel k < M is X[k] = w[k] z[k] (zero where k >= M).
  // Ends with a cluster barrier: K4 then reads the other planes.
  __device__ __forceinline__ void chirp_out() {
    const float2* w = W + fft_table_size(LB) + k0 * NC;   // the rank's row
#pragma unroll 1
    for (int c = tid(); c < NC; c += kFftThreads) {
      const float2 wc = ld(w + c);
#pragma unroll 1
      for (int l = 0; l < H; ++l) {
        float2* f = S + l * HS + pad(c);
        *f = cmul(make_float2(f->x, -f->y), wc);
      }
    }
    cluster_sync();
  }

  // y[rN + c] of every hop into this rank's plane from E (rank 0's plane)
  // and O (rank 1's): E[c] ± W_M^c O[c].  Hop by hop: read both planes,
  // hold the results across a cluster barrier (the partner has then read
  // this hop of this plane), write in place.
  __device__ __forceinline__ void combine() {
    constexpr int CV = (N + kFftThreads - 1) / kFftThreads;  // values a thread
    const int r = rank();
    const unsigned peer = cluster_addr(S, r ^ 1);   // the partner's plane
    const float2* wk = W + fft_twiddle_size(N);     // W_M^c, c < N
    cluster_sync();     // both planes transformed
#pragma unroll 1
    for (int l = 0; l < H; ++l) {
      float2 v[CV];
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N) {
          const float2 own = S[l * HS + pad(c)];
          const float2 far = ld_cluster(peer + 8 * (l * HS + pad(c)));
          const float2 t = cmul(r ? own : far, ld(wk + c));   // W_M^c O[c]
          const float2 e = r ? far : own;
          v[i] = r ? csub(e, t) : cadd(e, t);
        }
      }
      cluster_sync();   // the partner has read hop l of this plane
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N) S[l * HS + pad(c)] = v[i];
      }
    }
    cluster_sync();     // both planes combined
  }

  // y[rN + c] of every hop into this rank's plane, in a cluster of RK > 2.
  // First G_r[c] = W_M^{r·c} F_r[c] in place (rank 0's twiddles are 1);
  // then hop by hop: G_0[c] + sum_{s=1}^{RK-1} W_RK^{s·r} G_s[c], s
  // ascending, each G_s read from plane s (its own, or another's through
  // the shared::cluster window, addresses made afresh each hop), the
  // sums held across a cluster barrier (every rank has then read this hop
  // of this plane), then written in place.
  __device__ __forceinline__ void cross() {
    constexpr int CV = (N + kFftThreads - 1) / kFftThreads;  // values a thread
    const int r = rank();
    const float2* wt = W + fft_twiddle_size(N);   // W_M^{s·c}: (RK-1) x N
    if (r > 0) {
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N) {
          const float2 w = ld(wt + (r - 1) * N + c);
#pragma unroll 1
          for (int l = 0; l < H; ++l) {
            float2* f = S + l * HS + pad(c);
            *f = cmul(*f, w);
          }
        }
      }
    }
    float2 wc[RK];   // W_RK^{s·r}
#pragma unroll
    for (int s = 0; s < RK; ++s) wc[s] = ld(wt + (RK - 1) * N + s * r % RK);
    cluster_sync();     // every plane twiddled
#pragma unroll 1
    for (int l = 0; l < H; ++l) {
      unsigned far[RK];
#pragma unroll
      for (int s = 0; s < RK; ++s) far[s] = cluster_addr(S, s);
      float2 v[CV];
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N) {
          const int o = l * HS + pad(c);
          float2 acc = r == 0 ? S[o] : ld_cluster(far[0] + 8 * o);
#pragma unroll
          for (int s = 1; s < RK; ++s) {
            const float2 g = s == r ? S[o] : ld_cluster(far[s] + 8 * o);
            const float2 w = wc[s];
            acc.x = fmaf(g.x, w.x, fmaf(-g.y, w.y, acc.x));
            acc.y = fmaf(g.x, w.y, fmaf(g.y, w.x, acc.y));
          }
          v[i] = acc;
        }
      }
      cluster_sync();   // every rank has read hop l of this plane
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = tid() + i * kFftThreads;
        if (c < N) S[l * HS + pad(c)] = v[i];
      }
    }
    cluster_sync();     // every plane done
  }

  // y_k of tile hop l, the block's channel at position c (k =
  // channel(c)), with the hop sign (-1)^{k(n+parity)} of stream hop n
  __device__ __forceinline__ float2 y(int l, int c, int n, int parity) const {
    const float2 v = S[l * HS + pad(c)];
    const int k = LB ? channel(c) : (RK > 1 ? k0 + c : c);
    return ((k & 1) && ((n + parity) & 1)) ? make_float2(-v.x, -v.y) : v;
  }
};

// ---- host side: the launch of a tile kernel at bank width M ----

// A launch of kFftThreads-thread blocks with smem bytes of dynamic
// shared memory, in clusters of fft_blocks(M) blocks along grid x.
inline cudaLaunchConfig_t fft_config(int M, dim3 grid, int smem,
                                     cudaStream_t st,
                                     cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kFftThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = fft_blocks(M);
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = fft_blocks(M) > 1 ? 1 : 0;
  return cfg;
}

// Sets the kernel's shared memory to smem bytes and launches it (grid x
// a multiple of fft_blocks(M)); returns the launch's CUDA error.
template <int M, class... Params, class... Args>
int fft_launch(void (*kernel)(Params...), dim3 grid, int smem,
               cudaStream_t st, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = fft_config(M, grid, smem, st, &cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of fft_blocks(M) blocks of the kernel, smem bytes each,
// that the card holds at once (0: it cannot schedule one), or -(the CUDA
// error).
template <int M, class... Params>
int fft_max_clusters(void (*kernel)(Params...), int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      fft_config(M, dim3(fft_blocks(M)), smem, nullptr, &cluster);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}
// The fewer of two kernels' clusters (or the first one's error).
template <int M, class K>
int fft_max_clusters(K a, K b, int smem) {
  const int na = fft_max_clusters<M>(a, smem);
  const int nb = fft_max_clusters<M>(b, smem);
  return na < 0 ? na : (nb < 0 ? nb : (na < nb ? na : nb));
}

}  // namespace

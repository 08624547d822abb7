// RECC trigger search for Hopper: the seizure trigger's correlation with
// every symbol-rate phase stream of a channel row, its window energies,
// the normalised quality and K greedy picks, in one pass a row.
//
// Replaces no TPU kernel: the JAX package searches with a banded Toeplitz
// matmul (amps_tpu/rx/correlator.py::find_bursts_phases), which the
// port's plain version keeps (amps_tpu_torch/rx/correlator.py::
// find_bursts_phases_reference).  On the card that matmul ran as four f32
// GEMMs over gigabyte planes, with casts, squares, six normalising passes
// and K argmax/mask rounds around them; this kernel writes no plane.
//
// What it computes, for lag o = bO + j of phase p (O the correlation
// block, L = 74 taps of the ±1 trigger, the word-sync tail t >= 52):
//   part 0: the taps whose symbol lies in block b; part 1: in block b+1;
//   corr  = A(A(sum_0 s_t x) + A(sum_1 s_t x))       the whole trigger
//   wcorr = the same over the word-sync taps
//   en, wen = the same over D(x * x)                  (squares in D)
//   norm(c, e, n) = A(c / A(A(sqrt(max(e, A(1e-9)))) * n))
//   quality = min(norm(corr, en, tnorm), norm(wcorr, wen, wsnorm))
// D is the phases' dtype (bf16 or f32), A the accumulation dtype (bf16
// with out_bf16, else f32); each sum is taken in f32 (in f32, A(part 0)
// + A(part 1) is one more order of the sum).  Symbols past nsym read
// zero.  Picks: K rounds of the first maximum over the row in
// phase-major, then lag order, skipping every position within
// (s - lo, s + hi) samples of an accepted pick s; a round with nothing
// left picks index 0 with -inf.  A zero quality may come out as -0 where
// the plain version has +0; the two compare equal.
//
// What bounds it on an H100: the adds.  With each pair of neighbouring
// symbols added as one sum or difference (and their squares as one sum),
// each (channel, phase, lag) takes 37 adds for the correlation and 37
// for the energies, and each symbol about 4 more (its square and its
// pair's sum, difference and sum of squares); at the loop's rows of
// 16384 channels x 3 phases x 3630 lags that is 13.9 G FP32 adds, 0.42
// ms at 33.5 T/s, against 0.11 ms for the 364 MB of bf16 phases at 3.35
// TB/s.
//
// Design.  One block of kThreads owns a channel row.  When the row's
// symbols and its quality fit in the wrapper's resident budget of shared
// memory (the loop's 3 x 3703 bf16 symbols do), the block loads the row
// once in 16-byte words, computes the quality of every lag into shared
// memory, folding the first pick round's argmax into it, and runs the
// other pick rounds there as block-wide argmax reductions.  A longer row
// is cut into tiles of one phase and a few blocks of lags; each pick
// round loads and recomputes every tile and folds it into the round's
// argmax.  Shared memory holds a symbol as one 32-bit word, each block of
// O padded by one word: bf16 data packs the symbol with its square in
// bf16, f32 data holds the symbol.  It holds the quality in A.  A thread
// computes a run of kRun consecutive lags that ends kRun (q + 1) lags
// before block b+1: it reads its window's symbols in chunks of kRun, once
// each, and adds each pair of them into every lag of the run whose taps
// they are, as their sum or difference (the signs are constants: the taps
// are template arguments), which halves the adds.  The lanes of a warp
// take the same q in consecutive blocks, so the window reaches block b+1
// at the same chunk for the warp (but where it spans two q) and the
// padding keeps their reads in 32 banks.  The bf16 norm replaces the IEEE
// root and quotient by approximate ones that round alike (norm).  Nothing
// is written back but the K picks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <type_traits>
#include <utility>

namespace {

constexpr int kTaps = 74;       // trigger symbols (26 dotting + 11 word-sync bits)
constexpr int kWordSync = 52;   // the first word-sync tap
constexpr int kRun = 8;         // consecutive lags a thread computes at once
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = kRun + kTaps - 1;   // symbols a run reads
constexpr int kGuard = kRun;    // words before the symbols: a run may start there

// the trigger's bits: dotting 1010... then the word sync 11100010010
__host__ __device__ constexpr int trigger_bit(int k) {
  return k < 26 ? (k % 2 == 0) : ((0x712 >> (36 - k)) & 1);
}
// Manchester: bit 0 is (+1, -1), bit 1 is (-1, +1)
__host__ __device__ constexpr bool tap_positive(int t) {
  return (trigger_bit(t / 2) == 0) == (t % 2 == 0);
}

// Shared memory of a tile of nph phases and nb blocks of O lags: the
// guard words, the symbols of nb + 1 blocks, the K picks, the quality of
// nb blocks (qbytes a value), in bytes.
__host__ __device__ constexpr long long smem_bytes(int nph, int nb, int O,
                                                   int K, int qbytes) {
  return 4LL * (kGuard + static_cast<long long>(nph) * (nb + 1) * (O + 1) +
                K) +
         static_cast<long long>(qbytes) * nph * nb * (O + 1);
}

struct Search {
  const void* x;        // (rows, sps, nsym), D
  int sps, nsym, no, O, nblk, K;
  float eps, tnorm, wsnorm;   // constants in A
  float threshold;
  int lo, hi, lead;     // exclusion (s - lo, s + hi); starts = pos + lead
  int resident, tile_blocks;
  int* starts;          // (rows, K)
  unsigned char* valid;
  float* quality;
};

// A symbol as shared memory holds it, and back: bf16 data packs the
// symbol's bits (low half) with those of its square rounded to bf16;
// f32 data holds the symbol, its square is taken when read.
__device__ __forceinline__ unsigned sym_word(float x, const __nv_bfloat16*) {
  const float e = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, x)));
  return (__float_as_uint(x) >> 16) | (__float_as_uint(e) & 0xffff0000u);
}
__device__ __forceinline__ unsigned sym_word(float x, const float*) {
  return __float_as_uint(x);
}
__device__ __forceinline__ void sym_value(unsigned w, float& x, float& e,
                                          const __nv_bfloat16*) {
  x = __uint_as_float(w << 16);
  e = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void sym_value(unsigned w, float& x, float& e,
                                          const float*) {
  x = __uint_as_float(w);
  e = __fmul_rn(x, x);
}

// a value rounded to the accumulation dtype
template <bool kBf16Acc>
__device__ __forceinline__ float acc(float v) {
  if constexpr (kBf16Acc) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Two bf16 values in one register, and back.
__device__ __forceinline__ unsigned pack(float hi, float lo) {
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}
__device__ __forceinline__ float high(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float low(unsigned w) {
  return __uint_as_float(w << 16);
}

// A quality as shared memory holds it: a bf16 value by its upper half.
template <bool kBf16Acc>
using Qual = std::conditional_t<kBf16Acc, unsigned short, float>;
__device__ __forceinline__ void put_qual(unsigned short& d, float q) {
  d = static_cast<unsigned short>(__float_as_uint(q) >> 16);
}
__device__ __forceinline__ void put_qual(float& d, float q) { d = q; }
__device__ __forceinline__ float get_qual(unsigned short d) {
  return __uint_as_float(static_cast<unsigned>(d) << 16);
}
__device__ __forceinline__ float get_qual(float d) { return d; }

// A(c / A(A(sqrt(max(e, eps))) * n)).  In bf16 every operand is a bf16
// value: the square root of one, or the quotient of two, never lies
// within 2^-17 (relative) of a midpoint between bf16 values (its square,
// or the divisor times it, would need more than 8 significant bits), so
// the approximate root and quotient (within 3 f32 ulp, 2^-21) round to
// the bf16 of the correctly rounded f32 ones.
template <bool kBf16Acc>
__device__ __forceinline__ float norm(float c, float e, float n, float eps) {
  const float m = fmaxf(e, eps);
  if constexpr (kBf16Acc) {
    const float q = acc<true>(__fmul_rn(acc<true>(m * rsqrtf(m)), n));
    return acc<true>(__fdividef(c, q));
  } else {
    return __fdiv_rn(c, __fmul_rn(__fsqrt_rn(m), n));
  }
}

// f(std::integral_constant<int, I>) for I = 0 .. N-1, in order: the taps
// are template constants, whatever the unroller decides.
template <typename F, int... I>
__device__ __forceinline__ void static_for(F&& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for(f, std::make_integer_sequence<int, N>{});
}

// Add tap t of one lag (x and its square e); nothing past the trigger.
template <int t>
__device__ __forceinline__ void add_tap(float x, float e, float& hc,
                                        float& wc, float& he, float& we) {
  if constexpr (t >= 0 && t < kTaps) {
    if constexpr (t < kWordSync) {
      hc = tap_positive(t) ? hc + x : hc - x;
      he = he + e;
    } else {
      wc = tap_positive(t) ? wc + x : wc - x;
      we = we + e;
    }
  }
}

// The quality of kRun consecutive lags from the run's first symbol s[0]
// in the padded layout: s[i] for i < split, s[i + 1] past it (block b+1
// begins after the pad word).  The window's symbols are read in chunks of
// kRun; split is a multiple of kRun, so it falls between two chunks, and
// symbols 2m and 2m + 1 lie in one part.  Each lag adds them as a pair
// where both are its taps on one side of kWordSync: by a Manchester
// symbol pair's difference (even lags) or by the sum or difference of two
// neighbouring bits' halves (odd lags).  kSplit: the part-0 sums are
// rounded to bf16 and set aside at the split, two to a register (A is
// bf16 and some window of the run reaches block b+1).
template <typename D, bool kBf16Acc, bool kSplit>
__device__ __forceinline__ void run_quality(const unsigned* __restrict__ s,
                                            int split, const Search& a,
                                            float (&q)[kRun]) {
  static_assert(kRun % 2 == 0 && kWordSync % 2 == 0, "pairs of symbols");
  static_assert(kBf16Acc || !kSplit, "an f32 sum needs no split");
  // head (t < kWordSync) and word-sync sums of the correlation and energy
  float hc[kRun], wc[kRun], he[kRun], we[kRun];
  // part 0 of (corr, wcorr) and of (en, wen) in bf16 (kSplit)
  unsigned c0[kRun], e0[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    hc[r] = wc[r] = he[r] = we[r] = 0.f;
    c0[r] = e0[r] = 0u;
  }
  static_for<(kWindow + kRun - 1) / kRun>([&](auto cc) {
    constexpr int c = decltype(cc)::value;
    if (kSplit && c * kRun == split) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        c0[r] = pack(acc<true>(hc[r] + wc[r]), acc<true>(wc[r]));
        e0[r] = pack(acc<true>(he[r] + we[r]), acc<true>(we[r]));
        hc[r] = wc[r] = he[r] = we[r] = 0.f;
      }
    }
    const unsigned* sc = c * kRun >= split ? s + 1 : s;
    unsigned xs[kRun];
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      xs[u] = c * kRun + u < kWindow ? sc[c * kRun + u] : 0u;
    }
    // (the nested lambdas name their constants by the types they are given)
    static_for<kRun / 2>([&](auto uu) {
      constexpr int u = 2 * decltype(uu)::value;
      constexpr int i = decltype(cc)::value * kRun + u;   // symbols i, i+1
      if constexpr (i < kWindow) {
        float x0, q0, x1, q1;   // the two symbols and their squares
        sym_value(xs[u], x0, q0, static_cast<const D*>(nullptr));
        sym_value(xs[u + 1], x1, q1, static_cast<const D*>(nullptr));
        const float sum = x0 + x1, diff = x0 - x1, esum = q0 + q1;
        static_for<kRun>([&](auto rr) {
          constexpr int r = decltype(rr)::value;
          constexpr int t =   // the tap of symbol i
              decltype(cc)::value * kRun + 2 * decltype(uu)::value - r;
          constexpr bool last = t + r + 1 >= kWindow;   // i + 1 is no symbol
          if constexpr (t >= 0 && t + 1 < kTaps && !last &&
                        (t < kWordSync) == (t + 1 < kWordSync)) {
            // s_t x0 + s_t+1 x1 = +-(x0 + x1) or +-(x0 - x1)
            constexpr bool pos = tap_positive(t);
            const float v = pos == tap_positive(t + 1) ? sum : diff;
            if constexpr (t < kWordSync) {
              hc[r] = pos ? hc[r] + v : hc[r] - v;
              he[r] = he[r] + esum;
            } else {
              wc[r] = pos ? wc[r] + v : wc[r] - v;
              we[r] = we[r] + esum;
            }
          } else {
            add_tap<t>(x0, q0, hc[r], wc[r], he[r], we[r]);
            if constexpr (!last) {
              add_tap<t + 1>(x1, q1, hc[r], wc[r], he[r], we[r]);
            }
          }
        });
      }
    });
  });
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    // part 1 (or, without a split, part 0 beside an empty part 1: A(x +
    // 0) is x but for the sign of a zero)
    float cf = acc<kBf16Acc>(hc[r] + wc[r]), cw = acc<kBf16Acc>(wc[r]);
    float ef = acc<kBf16Acc>(he[r] + we[r]), ew = acc<kBf16Acc>(we[r]);
    if constexpr (kSplit) {
      cf = acc<true>(high(c0[r]) + cf);
      cw = acc<true>(low(c0[r]) + cw);
      ef = acc<true>(high(e0[r]) + ef);
      ew = acc<true>(low(e0[r]) + ew);
    }
    q[r] = fminf(norm<kBf16Acc>(cf, ef, a.tnorm, a.eps),
                 norm<kBf16Acc>(cw, ew, a.wsnorm, a.eps));
  }
}

// A tile: phases p0 .. p0+nph-1, blocks of lags b0 .. b0+nb-1.  Shared
// memory holds kGuard words, then the tile's symbols, sym[(pp (nb+1) +
// bb) W + j] for the nb + 1 blocks from b0 (W = O + 1), the K picks, then
// its quality, qual[(pp nb + bb) W + j].
struct Tile {
  int p0, nph, b0, nb;
};

// The values of a 16-byte word of the data: 8 bf16 or 4 f32.
__device__ __forceinline__ float word_value(const uint4& w, int k,
                                            const __nv_bfloat16*) {
  const unsigned u = (&w.x)[k / 2];
  return __uint_as_float(k % 2 ? u & 0xffff0000u : u << 16);
}
__device__ __forceinline__ float word_value(const uint4& w, int k,
                                            const float*) {
  return __uint_as_float((&w.x)[k]);
}

// Global to shared memory in 16-byte words, kLoads of them in flight a
// thread.  A phase's symbols start anywhere (rows of odd length), so the
// words cover them from the last 16-byte boundary at or before the
// first, and keep only the tile's; past the row's end, zeros.
template <typename D>
__device__ void load_tile(const Search& a, int row, const Tile& t,
                          unsigned* sym) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(D));
  constexpr int kLoads = 4;
  const int W = a.O + 1, n = (t.nb + 1) * a.O;
  const float rcp = 1.f / static_cast<float>(a.O);
  const long long s0 = static_cast<long long>(t.b0) * a.O;
  // the symbols of the tile that the row holds
  const int held = static_cast<int>(min(static_cast<long long>(n),
                                        max(a.nsym - s0, 0LL)));
  // symbol e of the tile goes to dst[e + e / O] (a pad word a block)
  const auto put = [&](unsigned* dst, int e, unsigned v) {
    int b = static_cast<int>(static_cast<float>(e) * rcp);
    b += (b + 1) * a.O <= e;   // the float quotient is off by at most one
    b -= b * a.O > e;
    dst[e + b] = v;
  };
  for (int pp = 0; pp < t.nph; ++pp) {
    const D* x = static_cast<const D*>(a.x) +
                 (static_cast<size_t>(row) * a.sps + t.p0 + pp) * a.nsym + s0;
    unsigned* dst = sym + pp * (t.nb + 1) * W;
    const size_t addr = reinterpret_cast<size_t>(x);
    const int lead = static_cast<int>(addr % 16) / static_cast<int>(sizeof(D));
    const uint4* words = reinterpret_cast<const uint4*>(addr - addr % 16);
    const int nw = (lead + held + kVec - 1) / kVec;
    for (int w0 = threadIdx.x; w0 < nw; w0 += kThreads * kLoads) {
      uint4 w[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (w0 + u * kThreads < nw) w[u] = __ldg(words + w0 + u * kThreads);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (w0 + u * kThreads >= nw) break;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int e = (w0 + u * kThreads) * kVec + k - lead;
          if (e >= 0 && e < held) {
            const D* tag = nullptr;
            put(dst, e, sym_word(word_value(w[u], k, tag), tag));
          }
        }
      }
    }
    for (int e = held + threadIdx.x; e < n; e += kThreads) put(dst, e, 0u);
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The quality of every lag of the tile into `qual`; with `fold` (a first
// pick round, which excludes nothing), each also into the thread's best
// (bv, bi) by value, then by flat index p * no + o.
template <typename D, bool kBf16Acc>
__device__ void quality_tile(const Search& a, const Tile& t,
                             const unsigned* sym, Qual<kBf16Acc>* qual,
                             bool fold, float& bv, int& bi) {
  const int W = a.O + 1;
  const int nq = (a.O + kRun - 1) / kRun;      // runs a block of lags
  const int n = t.nph * t.nb;
  // consecutive lanes take run q of consecutive blocks (a warp spans at
  // most two q, which diverge only at the split)
  for (int it = threadIdx.x; it < nq * n; it += kThreads) {
    const int q = it / n, m = it - q * n;
    const int pp = m / t.nb, bb = m - pp * t.nb;
    // runs end kRun (q + 1) lags before block b+1, so the window reaches
    // it at a multiple of kRun; the last run of a block whose O is no
    // multiple of kRun starts before it (in the guard words for the
    // first), and its lags there are dropped
    const int split = kRun * (q + 1);
    const int j0 = a.O - split;
    const unsigned* s = sym + (pp * (t.nb + 1) + bb) * W + j0;
    float qr[kRun];
    if constexpr (kBf16Acc) {
      if (split < kWindow) {
        run_quality<D, true, true>(s, split, a, qr);
      } else {
        run_quality<D, true, false>(s, split, a, qr);
      }
    } else {
      run_quality<D, false, false>(s, split, a, qr);
    }
    const int o0 = (t.b0 + bb) * a.O + j0;
    const int i0 = (t.p0 + pp) * a.no + o0;
    Qual<kBf16Acc>* dst = qual + (pp * t.nb + bb) * W + j0;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (j0 + r >= 0 && o0 + r < a.no) {
        put_qual(dst[r], qr[r]);
        if (fold && better(qr[r], i0 + r, bv, bi)) {
          bv = qr[r];
          bi = i0 + r;
        }
      }
    }
  }
}

// Fold the tile's lags that no accepted pick excludes into (bv, bi).
template <bool kBf16Acc>
__device__ void scan_tile(const Search& a, const Tile& t,
                          const Qual<kBf16Acc>* qual, const int* picks,
                          int k, float& bv, int& bi) {
  const int W = a.O + 1, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int pp = 0; pp < t.nph; ++pp) {
    const int p = t.p0 + pp;
    for (int bb = warp; bb < t.nb; bb += kWarps) {
      const Qual<kBf16Acc>* src = qual + (pp * t.nb + bb) * W;
      for (int j = lane; j < a.O; j += 32) {
        const int o = (t.b0 + bb) * a.O + j;
        if (o >= a.no) break;
        const int pos = p + a.sps * o;
        bool out = false;
        for (int k2 = 0; k2 < k; ++k2) {
          out |= pos > picks[k2] - a.lo && pos < picks[k2] + a.hi;
        }
        const float v = get_qual(src[j]);
        const int idx = p * a.no + o;
        if (!out && better(v, idx, bv, bi)) {
          bv = v;
          bi = idx;
        }
      }
    }
  }
}

// The block's best of every thread's (bv, bi) is pick k: its position
// joins `picks`, and the outputs are written.
__device__ void pick(const Search& a, int row, int k, float bv, int bi,
                     int* picks) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    }
    if (bi == INT_MAX) {   // every position excluded: torch.argmax's 0
      bi = 0;
      bv = -INFINITY;
    }
    const int p = bi / a.no, o = bi - p * a.no;
    const int pos = p + a.sps * o;
    picks[k] = pos;
    const size_t out = static_cast<size_t>(row) * a.K + k;
    a.starts[out] = pos + a.lead;
    a.quality[out] = bv;
    a.valid[out] = bv >= a.threshold;
  }
  __syncthreads();
}

// Three blocks an SM where the row's quality is bf16 (the loop's rows
// then take 69 KB of shared memory a block), two in f32.
template <typename D, bool kBf16Acc>
__global__ void __launch_bounds__(kThreads, kBf16Acc ? 3 : 2)
trigger_search_kernel(const Search a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int row = blockIdx.x;
  const int W = a.O + 1;
  const int nph = a.resident ? a.sps : 1;
  const int nb = a.resident ? a.nblk : a.tile_blocks;
  unsigned* sym = smem + kGuard;
  int* picks = reinterpret_cast<int*>(sym + nph * (nb + 1) * W);
  auto* qual = reinterpret_cast<Qual<kBf16Acc>*>(picks + a.K);
  if (a.resident) {
    const Tile t{0, a.sps, 0, a.nblk};
    float bv = -INFINITY;
    int bi = INT_MAX;
    load_tile<D>(a, row, t, sym);
    __syncthreads();
    quality_tile<D, kBf16Acc>(a, t, sym, qual, true, bv, bi);
    pick(a, row, 0, bv, bi, picks);   // (its barrier publishes qual)
    for (int k = 1; k < a.K; ++k) {
      bv = -INFINITY;
      bi = INT_MAX;
      scan_tile<kBf16Acc>(a, t, qual, picks, k, bv, bi);
      pick(a, row, k, bv, bi, picks);
    }
    return;
  }
  for (int k = 0; k < a.K; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int p = 0; p < a.sps; ++p) {
      for (int b0 = 0; b0 < a.nblk; b0 += nb) {
        const Tile t{p, 1, b0, min(nb, a.nblk - b0)};
        __syncthreads();   // the previous tile's scan is done
        load_tile<D>(a, row, t, sym);
        __syncthreads();
        quality_tile<D, kBf16Acc>(a, t, sym, qual, k == 0, bv, bi);
        if (k > 0) {
          __syncthreads();
          scan_tile<kBf16Acc>(a, t, qual, picks, k, bv, bi);
        }
      }
    }
    pick(a, row, k, bv, bi, picks);
  }
}

template <typename D, bool kBf16Acc>
int launch(const Search& a, int rows, int smem, cudaStream_t st) {
  const auto kernel = trigger_search_kernel<D, kBf16Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

// the kernel's constants, for the wrapper's check
extern "C" int trigger_search_taps() { return kTaps; }
extern "C" int trigger_search_word_sync() { return kWordSync; }
extern "C" int trigger_search_tap(int t) {
  return t < 0 || t >= kTaps ? 0 : tap_positive(t) ? 1 : -1;
}
// shared memory of a tile of nph phases and nb blocks of O lags and the K
// picks, with a quality in bf16 (bf16_acc) or f32, in bytes (the
// wrapper's plan reads it)
extern "C" long long trigger_search_smem_bytes(int nph, int nb, int O, int K,
                                               int bf16_acc) {
  return smem_bytes(nph, nb, O, K, bf16_acc ? 2 : 4);
}

// x (rows, sps, nsym) bf16 (bf16_data) or f32; outputs (rows, K).  The
// wrapper plans the tiles: resident (every phase and all nblk blocks of
// lags at once) or tile_blocks blocks of one phase.  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int trigger_search_launch(
    const void* x, int bf16_data, int bf16_acc, int rows, int sps, int nsym,
    int O, int K, float eps, float tnorm, float wsnorm, float threshold,
    int lo, int hi, int lead, int resident, int tile_blocks, void* starts,
    void* valid, void* quality, void* stream) {
  const int no = nsym - kTaps + 1;
  if (rows < 1 || sps < 1 || no < 1 || O < kTaps - 1 || K < 1 ||
      (!resident && tile_blocks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (no + O - 1) / O;
  const long long smem =
      resident ? trigger_search_smem_bytes(sps, nblk, O, K, bf16_acc)
               : trigger_search_smem_bytes(1, tile_blocks, O, K, bf16_acc);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Search a{x, sps, nsym, no, O, nblk, K, eps, tnorm, wsnorm, threshold, lo,
           hi, lead, resident, tile_blocks, static_cast<int*>(starts),
           static_cast<unsigned char*>(valid), static_cast<float*>(quality)};
  const auto st = static_cast<cudaStream_t>(stream);
  const int s = static_cast<int>(smem);
  if (bf16_data) {
    return bf16_acc ? launch<__nv_bfloat16, true>(a, rows, s, st)
                    : launch<__nv_bfloat16, false>(a, rows, s, st);
  }
  return bf16_acc ? launch<float, true>(a, rows, s, st)
                  : launch<float, false>(a, rows, s, st);
}

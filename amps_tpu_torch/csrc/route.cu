// The device-memory route of the four kernels: every even bank width M
// that no in-shared-memory mode of the FFT tile takes (analysis_fft.cuh:
// the 4432 even widths in (16384, 32768] that no cluster splits, and
// every M past 32768).  Each kernel folds (K1-K3) or loads (K4) the hops
// of a chunk into a scratch plane in device memory, transforms the plane
// with a Stockham FFT of length L = 2^k run as passes between two planes,
// and ends in an epilogue of its own:
//
//   * direct, where M is a power of two: L = M and the plane's FFT is the
//     M-point DFT;
//   * Bluestein elsewhere, L the least power of two >= 2M - 1: with the
//     chirp w[n] = e^{-jπn²/M},
//       X[k] = w[k] conj(FFT_L(conj(FFT_L(a) · B̂)))[k],
//     a[n] = x[n] w[n] for n < M and zero past it, B̂ = FFT_L(b) / L of
//     the conjugate chirp b (b[n] = conj(w[|n|]), wrapped to L - n), the
//     circular convolution of the tile's cluster mode (analysis_fft.cuh)
//     at length L.
//
// The transform.  Passes of radix R_0 .. R_{p-1}, each a power of two
// from 256 to 4096 (route_radix: as even as the bits of L allow, two
// passes up to 2^24, three past it), product L.  Pass p with Ns = R_0 ·
// ... · R_{p-1} is the FFT tile's own Stockham pass lifted to device
// memory: butterfly j of a row reads R values at stride L/R, multiplies
// value r by W_L^{(j mod Ns)·r·L/(Ns·R)} (a table of W_L^e, e < L), runs
// the R-point DFT as the FFT tile at width R in shared memory (its plan,
// its table, unchanged), and writes value r at (j/Ns)·Ns·R + j mod Ns +
// r·Ns; the output is in natural order.  A block takes route_hops(R)
// consecutive butterflies as the tile's hops (16 up to R = 1024, 8 at
// 2048, 4 at 4096), so each of its R strided reads is a run of that many
// values; its writes run along j past the first pass and along r in it.
// Bluestein's product by B̂ and the conjugate fold into the first pass of
// the second transform (its loads), the chirp into the fold (chirp_in)
// and the epilogue's reads (chirp_out).
//
// Chunks.  The scratch is two planes of `rows` rows of L values (the
// wrapper sizes it to a fixed budget); the launcher walks the block's hops
// in chunks of rows (K1, K4) or rows - 1 (K2, K3, whose plane also holds
// the hop behind the chunk, recomputed, as the tile kernels recompute it)
// and runs fold -> passes -> epilogue a chunk.  The stream's hop -1 is
// `prev` (K2) or zero (K3).  K3's symbol sums and 384-hop power sums wait
// between chunks in a small state plane, each channel's in one thread;
// K4's output sums that a later chunk still adds to wait in the output
// itself.  Every hop's transform is the same instruction sequence
// wherever it sits, so chained calls of K2 equal one call bit for bit.
//
// The epilogues are those of the tile kernels, with the same products:
//   K1  y_k[n] = (-1)^{k(n+parity)} X_n[k] into (M, Nh, 2) or (2, M, Nh);
//   K2  the discriminator and the power of y_k[n] conj(y_k[n-1])
//       (fast_atan2 and the products of rx_front.cu), `last`;
//   K3  K2's per hop, then each phase's symbol sums in hop order (the
//       tile's weights), rounded at the store, and the 384-hop power sums;
//   K4  x[bP + p] = sum_{j<2T} gP[jP + p] u_{b-j}[(j&1)P + p], the terms
//       in input-hop order (j = 2T-1 down to 0, fmaf), then the carry-in,
//       u_n[m] = F_n[(-m - P·odd_n) mod M] with F_n = FFT_M(Y_n)
//       (synth.cu); any T in one launch a chunk.
// Every offset into a plane or an output is 64-bit.
//
// This source builds into the main library only (kernels/build.py); M, L
// and T are runtime arguments, so no width builds a library of its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "analysis_fft.cuh"

namespace {

constexpr int kRouteMinRadix = 256;     // the passes' radices: 256 .. 4096
constexpr int kRouteMaxRadix = 4096;
constexpr int kRouteMaxBits = 12;       // log2(kRouteMaxRadix)
constexpr int kRouteMaxSps = 16;        // K3's symbol length on the route
constexpr int kRssiHops = 384;

// butterflies a block of a pass of radix R takes, the tile's hops
__host__ __device__ constexpr int route_hops(int R) {
  return R <= 1024 ? 16 : (R == 2048 ? 8 : 4);
}
__host__ __device__ constexpr int route_log2(long long L) {
  return L > 1 ? 1 + route_log2(L / 2) : 0;
}
// passes of the route's FFT of length L = 2^k: ceil(k / 12)
__host__ __device__ constexpr int route_passes(long long L) {
  return (route_log2(L) + kRouteMaxBits - 1) / kRouteMaxBits;
}
// radix of pass p: the k bits split as evenly as they go, the larger
// shares first
__host__ __device__ constexpr int route_radix(long long L, int p) {
  const int k = route_log2(L), n = route_passes(L);
  return p < 0 || p >= n ? 0 : 1 << (k / n + (p < k % n ? 1 : 0));
}
// offset of radix R's tile table in the concatenated tables of 256 ..
// 4096 (each fft_table_size(R) values, kernels/route.py)
__host__ __device__ constexpr int route_tile_offset(int R) {
  return R <= kRouteMinRadix ? 0
                             : route_tile_offset(R / 2) + fft_table_size(R / 2);
}

// the tables of one width: W_L^e (e < L), the tile tables of the radices,
// and in the Bluestein mode the chirp (M) and B̂ (L); chirp null: direct
struct RouteTables {
  const float2* twl;
  const float2* tile;
  const float2* chirp;
  const float2* bhat;
  long long L;
};

// One Stockham pass of radix R over `rows` rows of L values, src -> dst;
// with bhat, each value is first conj(v · B̂) (Bluestein's product, on the
// first pass of the second transform).
template <int R>
__global__ void __launch_bounds__(kFftThreads)
route_pass_kernel(const float2* __restrict__ src, float2* __restrict__ dst,
                  const float2* __restrict__ twl,
                  const float2* __restrict__ tile_tw,
                  const float2* __restrict__ bhat, long long L, long long Ns) {
  extern __shared__ __align__(16) float smem[];
  constexpr int H = route_hops(R);
  using Tile = FftTile<R, H>;
  Tile tile(smem);
  tile.load_twiddles(tile_tw);
  const long long nb = L / R;                           // butterflies a row
  const long long g0 = static_cast<long long>(blockIdx.x) * H;
  const long long row = g0 / nb, j0 = g0 % nb;
  const long long step = L / (Ns * R);                  // W_L exponent step
  const float2* s = src + row * L;
  for (int e = threadIdx.x; e < H * R; e += kFftThreads) {
    const int l = e % H, r = e / H;
    const long long j = j0 + l, i = j + r * nb;
    float2 v = __ldg(s + i);
    if (bhat) {
      const float2 z = cmul(v, __ldg(bhat + i));
      v = make_float2(z.x, -z.y);
    }
    if (Ns > 1 && r > 0) v = cmul(v, __ldg(twl + (j % Ns) * r * step));
    tile.S[l * Tile::HS + Tile::pad(r)] = v;
  }
  __syncthreads();
  tile.fft();
  float2* d = dst + row * L;
  // the writes run along j where Ns holds a block's butterflies, else
  // along r (the first pass: row j·R + r)
  const bool along_j = Ns >= H;
  for (int e = threadIdx.x; e < H * R; e += kFftThreads) {
    const int l = along_j ? e % H : e / R, r = along_j ? e / H : e % R;
    const long long j = j0 + l;
    d[(j / Ns) * Ns * R + j % Ns + r * Ns] = tile.S[l * Tile::HS + Tile::pad(r)];
  }
}

// K1-K3's fold of stream hops h0 .. h0+rows-1 into rows of L values:
// f[m] = sum_t coef[t, m] x[(h + 2t + hi)P + col] (the tile's taps order,
// fmaf from 0; rows outside the input add nothing), times the chirp in
// the Bluestein mode, zero for m >= M.
__global__ void __launch_bounds__(kFftThreads)
route_fold_kernel(const float* __restrict__ x, int planar, long long n_ext,
                  const float* __restrict__ coef,
                  const float2* __restrict__ chirp, float2* __restrict__ a,
                  long long L, int M, int T, int h0) {
  const long long m = static_cast<long long>(blockIdx.x) * kFftThreads +
                      threadIdx.x;
  if (m >= L) return;
  const long long row = blockIdx.y;
  float2 v = make_float2(0.f, 0.f);
  if (m < M) {
    const int P = M / 2;
    const int hi = m >= P ? 1 : 0;
    const long long col = m - hi * P, nrow = n_ext / P;
    const long long hop = h0 + row;
    float fr = 0.f, fi = 0.f;
    for (int t = 0; t < T; ++t) {
      const long long rw = hop + 2 * t + hi;
      if (rw < 0 || rw >= nrow) continue;
      const long long s = rw * P + col;
      const float c = __ldg(coef + static_cast<long long>(t) * M + m);
      const float2 xv =
          planar ? make_float2(__ldg(x + s), __ldg(x + n_ext + s))
                 : __ldg(reinterpret_cast<const float2*>(x) + s);
      fr = fmaf(c, xv.x, fr);
      fi = fmaf(c, xv.y, fi);
    }
    v = make_float2(fr, fi);
    if (chirp) v = cmul(v, __ldg(chirp + m));
  }
  a[row * L + m] = v;
}

// K4's load of hop-major rows n0 .. n0+rows-1 of Y (Nh, M) into rows of L
// values, times the chirp in the Bluestein mode, zero for k >= M.
__global__ void __launch_bounds__(kFftThreads)
route_load_kernel(const float2* __restrict__ Y,
                  const float2* __restrict__ chirp, float2* __restrict__ a,
                  long long L, int M, int n0) {
  const long long k = static_cast<long long>(blockIdx.x) * kFftThreads +
                      threadIdx.x;
  if (k >= L) return;
  const long long row = blockIdx.y;
  float2 v = make_float2(0.f, 0.f);
  if (k < M) {
    v = __ldg(Y + (n0 + row) * M + k);
    if (chirp) v = cmul(v, __ldg(chirp + k));
  }
  a[row * L + k] = v;
}

// X_n[k] of plane row `row`: the transform itself, or in the Bluestein
// mode w[k] conj(z[k]) (chirp_out)
__device__ __forceinline__ float2 route_value(const float2* __restrict__ z,
                                              const float2* __restrict__ chirp,
                                              long long row, long long L,
                                              int k) {
  const float2 v = z[row * L + k];
  return chirp ? cmul(make_float2(v.x, -v.y), __ldg(chirp + k)) : v;
}
// with the hop sign (-1)^{k(n+parity)} of stream hop n (FftTile::y)
__device__ __forceinline__ float2 route_y(const float2* __restrict__ z,
                                          const float2* __restrict__ chirp,
                                          long long row, long long L, int k,
                                          int n, int parity) {
  const float2 v = route_value(z, chirp, row, L, k);
  return ((k & 1) && ((n + parity) & 1)) ? make_float2(-v.x, -v.y) : v;
}

// K1's and K2's epilogues run on tiles of 32 channels x 32 hops (a
// block of 256 threads, 8 rows of 32): each thread reads its values along
// the channels (a plane row), the tile turns in shared memory, and the
// stores run along the hops of a channel (its output row), so both sides
// stay coalesced.
constexpr int kRouteTile = 32;

// K1's epilogue: hops n0 .. n0+cnt-1 (plane rows 0 ..) into Y.
__global__ void __launch_bounds__(kFftThreads)
route_analysis_out(const float2* __restrict__ z,
                   const float2* __restrict__ chirp, float* __restrict__ y,
                   int planar_out, long long L, int M, int Nh, int n0,
                   int cnt, int parity) {
  __shared__ float2 t[kRouteTile][kRouteTile + 1];
  const int tx = threadIdx.x % kRouteTile, ty = threadIdx.x / kRouteTile;
  const int k0 = blockIdx.x * kRouteTile, l0 = blockIdx.y * kRouteTile;
  for (int i = ty; i < kRouteTile; i += kFftThreads / kRouteTile) {
    const int l = l0 + i, k = k0 + tx;
    if (l < cnt && k < M) t[i][tx] = route_y(z, chirp, l, L, k, n0 + l, parity);
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(M) * Nh;
  for (int i = ty; i < kRouteTile; i += kFftThreads / kRouteTile) {
    const int k = k0 + i, l = l0 + tx;
    if (l < cnt && k < M) {
      const float2 v = t[tx][i];
      const size_t o = static_cast<size_t>(k) * Nh + n0 + l;
      if (planar_out) {
        y[o] = v.x;
        y[plane + o] = v.y;
      } else {
        reinterpret_cast<float2*>(y)[o] = v;
      }
    }
  }
}

// the discriminator's product of y_k[n] and q = y_k[n-1] (rx_front.cu)
__device__ __forceinline__ float2 route_product(float2 c, float2 q) {
  return make_float2(
      __fadd_rn(__fmul_rn(c.x, q.x), __fmul_rn(c.y, q.y)),
      __fsub_rn(__fmul_rn(c.y, q.x), __fmul_rn(c.x, q.y)));
}

// K2's epilogue: hops n0 .. n0+cnt-1 at plane rows 1 .. (row 0 is hop
// n0 - 1; the stream's hop -1 is prev); the tile holds (demod, power).
__global__ void __launch_bounds__(kFftThreads)
route_front_out(const float2* __restrict__ z, const float2* __restrict__ chirp,
                const float2* __restrict__ prev, float* __restrict__ demod,
                float* __restrict__ pw, float2* __restrict__ last,
                long long L, int M, int Nh, int n0, int cnt, int parity) {
  __shared__ float2 t[kRouteTile][kRouteTile + 1];
  const int tx = threadIdx.x % kRouteTile, ty = threadIdx.x / kRouteTile;
  const int k0 = blockIdx.x * kRouteTile, l0 = blockIdx.y * kRouteTile;
  for (int i = ty; i < kRouteTile; i += kFftThreads / kRouteTile) {
    const int l = l0 + i, k = k0 + tx;
    if (l < cnt && k < M) {
      const int n = n0 + l;
      const float2 c = route_y(z, chirp, l + 1, L, k, n, parity);
      const float2 q = n ? route_y(z, chirp, l, L, k, n - 1, parity) : prev[k];
      const float2 w = route_product(c, q);
      t[i][tx] = make_float2(fast_atan2(w.y, w.x),
                             __fadd_rn(__fmul_rn(w.x, w.x),
                                       __fmul_rn(w.y, w.y)));
      if (n == Nh - 1) last[k] = c;
    }
  }
  __syncthreads();
  for (int i = ty; i < kRouteTile; i += kFftThreads / kRouteTile) {
    const int k = k0 + i, l = l0 + tx;
    if (l < cnt && k < M) {
      const float2 v = t[tx][i];
      const size_t o = static_cast<size_t>(k) * Nh + n0 + l;
      demod[o] = v.x;
      pw[o] = v.y;
    }
  }
}

// K3's epilogue: hops n0 .. n0+cnt-1 at plane rows 1 .. (the stream's hop
// -1 is zero).  A thread owns channel k and walks the hops in order: each
// phase p's running symbol sum (hops p + sps·j .. + sps-1, the tile's
// weights and order), stored when its last hop arrives, and the running
// 384-hop power sum, stored / 384 at the block's last hop; both wait in
// state (M, kRouteMaxSps + 1) between chunks.
__global__ void __launch_bounds__(kFftThreads)
route_phases_out(const float2* __restrict__ z,
                 const float2* __restrict__ chirp,
                 float* __restrict__ ph_f32, __nv_bfloat16* __restrict__ ph_bf16,
                 float* __restrict__ pw_blk, float* __restrict__ state,
                 long long L, int M, int sps, int Nh, int nsym, int n0,
                 int cnt, int parity) {
  const int k = blockIdx.x * kFftThreads + threadIdx.x;
  if (k >= M) return;
  float* st = state + static_cast<size_t>(k) * (kRouteMaxSps + 1);
  float acc[kRouteMaxSps];
#pragma unroll
  for (int p = 0; p < kRouteMaxSps; ++p) acc[p] = n0 && p < sps ? st[p] : 0.f;
  float s = n0 ? st[kRouteMaxSps] : 0.f;
  const float w = 1.0f / static_cast<float>(sps);
  const int nblk = (Nh + kRssiHops - 1) / kRssiHops;
  for (int l = 0; l < cnt; ++l) {
    const int n = n0 + l;
    const float2 c = route_y(z, chirp, l + 1, L, k, n, parity);
    const float2 q = n ? route_y(z, chirp, l, L, k, n - 1, parity)
                       : make_float2(0.f, 0.f);
    const float2 pr = route_product(c, q);
    const float d = fast_atan2(pr.y, pr.x);
    const float pw = __fadd_rn(__fmul_rn(pr.x, pr.x), __fmul_rn(pr.y, pr.y));
#pragma unroll
    for (int p = 0; p < kRouteMaxSps; ++p) {
      if (p < sps && n >= p) {
        acc[p] = __fadd_rn(acc[p], __fmul_rn(d, w));
        if ((n - p) % sps == sps - 1) {
          const int j = (n - p) / sps;
          if (j < nsym) {
            const size_t o = (static_cast<size_t>(k) * sps + p) * nsym + j;
            if (ph_bf16)
              ph_bf16[o] = __float2bfloat16_rn(acc[p]);
            else
              ph_f32[o] = acc[p];
          }
          acc[p] = 0.f;
        }
      }
    }
    if (n % kRssiHops == 0) s = 0.f;
    s = __fadd_rn(s, pw);
    if (n % kRssiHops == kRssiHops - 1 || n == Nh - 1)
      pw_blk[static_cast<size_t>(k) * nblk + n / kRssiHops] =
          s / static_cast<float>(kRssiHops);
  }
#pragma unroll
  for (int p = 0; p < kRouteMaxSps; ++p)
    if (p < sps) st[p] = acc[p];
  st[kRouteMaxSps] = s;
}

// K4's overlap-add of input hops c0 .. c0+cnt-1 (plane rows 0 ..) into
// the output hops b0 + blockIdx.y they reach.  An output hop whose sum an
// earlier chunk began reads it back from the output; one that a later
// chunk still adds to is stored unfinished; a finished one gets the
// carry-in (b < 2T - 1) and goes to out (b < Nh) or carry_out.
__global__ void __launch_bounds__(kFftThreads)
route_synth_out(const float2* __restrict__ z, const float2* __restrict__ chirp,
                const float* __restrict__ gm,
                const float2* __restrict__ carry_in, float2* __restrict__ out,
                float2* __restrict__ carry_out, long long L, int M, int T,
                int Nh, int c0, int cnt, int parity) {
  const int P = M / 2;
  const int p = blockIdx.x * kFftThreads + threadIdx.x;
  if (p >= P) return;
  const int b = c0 + blockIdx.y;                  // output hop
  const int keep = 2 * T - 1, c1 = c0 + cnt;
  const size_t i = static_cast<size_t>(b) * P + p;
  const size_t n_out = static_cast<size_t>(Nh) * P;
  float2* dst = i < n_out ? out + i : carry_out + (i - n_out);
  float2 acc = max(0, b - keep) < c0 ? *dst : make_float2(0.f, 0.f);
  const int ka = p > 0 ? M - p : 0, kb = P - p;   // F[(M - p) mod M], F[P - p]
  for (int n = max(c0, b - keep); n <= min(c1 - 1, b); ++n) {
    const int j = b - n;
    const long long row = n - c0;
    const float2 fa = route_value(z, chirp, row, L, ka);
    const float2 fb = route_value(z, chirp, row, L, kb);
    const bool odd = (n + parity) & 1;
    const float2 u = (j & 1) ? (odd ? fa : fb) : (odd ? fb : fa);
    const float g = __ldg(gm + static_cast<size_t>(j) * P + p);
    acc.x = fmaf(g, u.x, acc.x);
    acc.y = fmaf(g, u.y, acc.y);
  }
  if (b < c1 || c1 == Nh) {
    if (b < keep) {
      const float2 ci = carry_in[i];
      acc = make_float2(__fadd_rn(acc.x, ci.x), __fadd_rn(acc.y, ci.y));
    }
  }
  *dst = acc;
}

template <int R>
int route_pass_launch(const float2* src, float2* dst, const RouteTables& t,
                      const float2* bhat, long long Ns, int rows,
                      cudaStream_t st) {
  constexpr int H = route_hops(R);
  constexpr int smem = FftTile<R, H>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      route_pass_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = rows * (t.L / R) / H;
  route_pass_kernel<R><<<static_cast<unsigned>(blocks), kFftThreads, smem,
                         st>>>(src, dst, t.twl, t.tile + route_tile_offset(R),
                               bhat, t.L, Ns);
  return static_cast<int>(cudaGetLastError());
}

// one forward FFT_L of `rows` rows: *z holds the input, *spare is free;
// on return *z holds the output (the two swap at each pass)
int route_fft(float2** z, float2** spare, const RouteTables& t,
              const float2* bhat, int rows, cudaStream_t st) {
  long long Ns = 1;
  for (int p = 0; p < route_passes(t.L); ++p) {
    const int R = route_radix(t.L, p);
    const float2* b = p == 0 ? bhat : nullptr;
    int err;
    switch (R) {
      case 256: err = route_pass_launch<256>(*z, *spare, t, b, Ns, rows, st); break;
      case 512: err = route_pass_launch<512>(*z, *spare, t, b, Ns, rows, st); break;
      case 1024: err = route_pass_launch<1024>(*z, *spare, t, b, Ns, rows, st); break;
      case 2048: err = route_pass_launch<2048>(*z, *spare, t, b, Ns, rows, st); break;
      case 4096: err = route_pass_launch<4096>(*z, *spare, t, b, Ns, rows, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
    float2* tmp = *z;
    *z = *spare;
    *spare = tmp;
    Ns *= R;
  }
  return 0;
}

// the M-point DFT of each row on the route: one transform (direct), or
// Bluestein's two with B̂ between them
int route_transform(float2** z, float2** spare, const RouteTables& t,
                    int rows, cudaStream_t st) {
  int err = route_fft(z, spare, t, nullptr, rows, st);
  if (err == 0 && t.chirp) err = route_fft(z, spare, t, t.bhat, rows, st);
  return err;
}

// (K2 and K3 also need a second row: the hop behind the chunk)
bool route_ok(const RouteTables& t, int M, int rows) {
  if (M < 2 || M % 2 || rows < 1 || t.L < 2 * kRouteMinRadix ||
      (t.L & (t.L - 1)) || route_passes(t.L) < 1)
    return false;
  for (int p = 0; p < route_passes(t.L); ++p)
    if (route_radix(t.L, p) < kRouteMinRadix) return false;
  return t.chirp ? t.L >= 2LL * M - 1 : t.L == M;
}

unsigned route_grid(long long n) {
  return static_cast<unsigned>((n + kFftThreads - 1) / kFftThreads);
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----

// the route's plan at length L: its passes and the radix of pass p (0
// past the plan), and the butterflies a block of a radix-R pass takes
extern "C" int route_fft_passes(long long L) { return route_passes(L); }
extern "C" int route_fft_radix(long long L, int p) { return route_radix(L, p); }
extern "C" int route_block_hops(int R) { return route_hops(R); }
// values of the concatenated tile tables of the radices 256 .. 4096
extern "C" int route_tile_values() {
  return route_tile_offset(kRouteMaxRadix) + fft_table_size(kRouteMaxRadix);
}
// K3's longest symbol on the route, and the floats of its state a channel
extern "C" int route_max_sps() { return kRouteMaxSps; }

// Every launcher below walks the block in chunks through `scratch` (two
// planes of `rows` rows of L float2), runs every kernel of a chunk on
// `stream` and returns the first CUDA error (0 = launched).

// K1 on the route: x as analysis_launch (analysis.cu), y (M, Nh, 2) or
// (2, M, Nh).
extern "C" int route_analysis_launch(
    const void* x, int planar_in, long long n_ext, const void* coef,
    const void* twl, const void* tile, const void* chirp, const void* bhat,
    long long L, void* y, int planar_out, int M, int T, int Nh,
    int hop0_parity, void* scratch, int rows, void* stream) {
  const RouteTables t{static_cast<const float2*>(twl),
                      static_cast<const float2*>(tile),
                      static_cast<const float2*>(chirp),
                      static_cast<const float2*>(bhat), L};
  if (T < 1 || Nh < 1 || !route_ok(t, M, rows) ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < Nh; n0 += rows) {
    const int cnt = min(rows, Nh - n0);
    float2* z = static_cast<float2*>(scratch);
    float2* spare = z + static_cast<long long>(rows) * L;
    route_fold_kernel<<<dim3(route_grid(L), cnt), kFftThreads, 0, st>>>(
        static_cast<const float*>(x), planar_in, n_ext,
        static_cast<const float*>(coef), t.chirp, z, L, M, T, n0);
    int err = static_cast<int>(cudaGetLastError());
    if (err == 0) err = route_transform(&z, &spare, t, cnt, st);
    if (err != 0) return err;
    route_analysis_out<<<dim3((M + kRouteTile - 1) / kRouteTile,
                              (cnt + kRouteTile - 1) / kRouteTile),
                         kFftThreads, 0, st>>>(
        z, t.chirp, static_cast<float*>(y), planar_out, L, M, Nh, n0, cnt,
        hop0_parity);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

// K2 on the route: x, prev, demod, pw and last as rx_front_launch
// (rx_front.cu).
extern "C" int route_front_launch(
    const void* x, int planar, long long n_ext, const void* coef,
    const void* twl, const void* tile, const void* chirp, const void* bhat,
    long long L, const void* prev, void* demod, void* pw, void* last, int M,
    int T, int Nh, int hop0_parity, void* scratch, int rows, void* stream) {
  const RouteTables t{static_cast<const float2*>(twl),
                      static_cast<const float2*>(tile),
                      static_cast<const float2*>(chirp),
                      static_cast<const float2*>(bhat), L};
  if (T < 1 || Nh < 1 || rows < 2 || !route_ok(t, M, rows) ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < Nh; n0 += rows - 1) {
    const int cnt = min(rows - 1, Nh - n0);
    float2* z = static_cast<float2*>(scratch);
    float2* spare = z + static_cast<long long>(rows) * L;
    route_fold_kernel<<<dim3(route_grid(L), cnt + 1), kFftThreads, 0, st>>>(
        static_cast<const float*>(x), planar, n_ext,
        static_cast<const float*>(coef), t.chirp, z, L, M, T, n0 - 1);
    int err = static_cast<int>(cudaGetLastError());
    if (err == 0) err = route_transform(&z, &spare, t, cnt + 1, st);
    if (err != 0) return err;
    route_front_out<<<dim3((M + kRouteTile - 1) / kRouteTile,
                           (cnt + kRouteTile - 1) / kRouteTile),
                      kFftThreads, 0, st>>>(
        z, t.chirp, static_cast<const float2*>(prev),
        static_cast<float*>(demod), static_cast<float*>(pw),
        static_cast<float2*>(last), L, M, Nh, n0, cnt, hop0_parity);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

// K3 on the route, one band: x as rx_phases_launch (rx_phases.cu), phases
// (M, sps, nsym) bf16 or f32, pw_blk (M, ceil(Nh / 384)), state a (M,
// route_max_sps() + 1) float scratch.
extern "C" int route_phases_launch(
    const void* x, int planar, long long n_ext, const void* coef,
    const void* twl, const void* tile, const void* chirp, const void* bhat,
    long long L, void* phases, int out_bf16, void* pw_blk, void* state,
    int M, int T, int sps, int Nh, int nsym, int hop0_parity, void* scratch,
    int rows, void* stream) {
  const RouteTables t{static_cast<const float2*>(twl),
                      static_cast<const float2*>(tile),
                      static_cast<const float2*>(chirp),
                      static_cast<const float2*>(bhat), L};
  if (T < 1 || sps < 1 || sps > kRouteMaxSps || Nh < sps || nsym < 0 ||
      rows < 2 || !route_ok(t, M, rows) ||
      n_ext != static_cast<long long>(Nh + 2 * T - 1) * (M / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < Nh; n0 += rows - 1) {
    const int cnt = min(rows - 1, Nh - n0);
    float2* z = static_cast<float2*>(scratch);
    float2* spare = z + static_cast<long long>(rows) * L;
    route_fold_kernel<<<dim3(route_grid(L), cnt + 1), kFftThreads, 0, st>>>(
        static_cast<const float*>(x), planar, n_ext,
        static_cast<const float*>(coef), t.chirp, z, L, M, T, n0 - 1);
    int err = static_cast<int>(cudaGetLastError());
    if (err == 0) err = route_transform(&z, &spare, t, cnt + 1, st);
    if (err != 0) return err;
    route_phases_out<<<route_grid(M), kFftThreads, 0, st>>>(
        z, t.chirp, out_bf16 ? nullptr : static_cast<float*>(phases),
        out_bf16 ? static_cast<__nv_bfloat16*>(phases) : nullptr,
        static_cast<float*>(pw_blk), static_cast<float*>(state), L, M, sps,
        Nh, nsym, n0, cnt, hop0_parity);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

// K4 on the route: Y, gm, carry_in, out and carry_out as synth_launch
// (synth.cu), any T.
extern "C" int route_synth_launch(
    const void* Y, const void* twl, const void* tile, const void* chirp,
    const void* bhat, long long L, const void* gm, const void* carry_in,
    void* out, void* carry_out, int M, int T, int Nh, int hop0_parity,
    void* scratch, int rows, void* stream) {
  const RouteTables t{static_cast<const float2*>(twl),
                      static_cast<const float2*>(tile),
                      static_cast<const float2*>(chirp),
                      static_cast<const float2*>(bhat), L};
  if (T < 1 || Nh < 1 || !route_ok(t, M, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int keep = 2 * T - 1;
  for (int c0 = 0; c0 < Nh; c0 += rows) {
    const int cnt = min(rows, Nh - c0);
    float2* z = static_cast<float2*>(scratch);
    float2* spare = z + static_cast<long long>(rows) * L;
    route_load_kernel<<<dim3(route_grid(L), cnt), kFftThreads, 0, st>>>(
        static_cast<const float2*>(Y), t.chirp, z, L, M, c0);
    int err = static_cast<int>(cudaGetLastError());
    if (err == 0) err = route_transform(&z, &spare, t, cnt, st);
    if (err != 0) return err;
    // the output hops the chunk reaches: c0 .. c0+cnt-1+keep
    route_synth_out<<<dim3(route_grid(M / 2), cnt + keep), kFftThreads, 0,
                      st>>>(
        z, t.chirp, static_cast<const float*>(gm),
        static_cast<const float2*>(carry_in), static_cast<float2*>(out),
        static_cast<float2*>(carry_out), L, M, T, Nh, c0, cnt, hop0_parity);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

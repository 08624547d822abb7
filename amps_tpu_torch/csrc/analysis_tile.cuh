// The dense analysis channelizer of one thread block, used by rx_phases.cu
// alone (+ discriminator + integrate-and-dump).  analysis.cu and
// rx_front.cu run the all-channel FFT tile, analysis_fft.cuh, instead;
// rx_phases.cu moves onto it in a later step.
//
// Math.  The bank fold with the permutation-absorbed matrices and the
// derotation e^{+j2πk/M} collapse to a forward DFT of the folded hop
// window: for channel k and hop n,
//   f_n[m] = sum_t coef[t, m] x[nP + tM + m]              (m < M, P = M/2)
//   y_k[n] = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2π km/M}
//
// A block owns 32 channel pairs (u, M - u) and walks its hops in
// sub-tiles of HS = 64 analysis hops, the first at hop h0 - 1.  Per
// sub-tile and chunk of MK = 32 values of m:
//   * the input rows the chunk's hop windows share (HS + 2T - 2 rows of
//     MK samples) are copied to shared memory once by cp.async, double
//     buffered one chunk ahead; the table slices and fold coefficients
//     of the next chunk go through registers;
//   * a thread folds one m for FH hops of one parity, whose windows
//     share FH + T - 1 rows, so each row is read from shared memory
//     once; the taps still add in order t = 0, 1, ... for every hop;
//   * channels k and M - k share their cos rows and negate their sin
//     rows, so a thread's 2-pair x 4-hop register micro-tile of four
//     partial sums (A = Σ fr·c, B = Σ fi·s, C = Σ fi·c, D = Σ fr·s)
//     gives both: half the FMAs of the dense DFT.
// Hops outside [0, Nh) fold to zero, so the stream is never padded.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int KU = 32;           // channel pairs (u, M-u) per block
constexpr int KC = 2 * KU;       // channels per block
constexpr int HS = 64;           // hops per transform sub-tile
constexpr int MK = 32;           // contraction chunk (values of m)
constexpr int FS = HS + 4;       // fold row stride: float4-aligned
constexpr int kMaxT = 16;        // taps per phase held in registers
constexpr int FH = MK * HS / kThreads;  // hops a thread folds per chunk
constexpr int EQ = MK * KU / kThreads;  // table values a thread stages
constexpr int CQ = kMaxT / (kThreads / MK);  // fold coefficients a thread stages

static_assert(KU * HS == kThreads * 8, "2x4 pair-hop micro-tile per thread");
static_assert(kThreads / MK == 8 && 8 * FH == HS,
              "fold: 8 thread groups of FH same-parity hops cover the sub-tile");
static_assert(MK * KU % kThreads == 0 && MK * HS % kThreads == 0 &&
              kMaxT * MK % kThreads == 0, "staging");

// Output channel of slot s of the block whose first pair index is u0:
// slots [0, KU) hold channels u, slots [KU, KC) their partners M - u
// (channel M/2 for u = 0).
__device__ __forceinline__ int slot_channel(int s, int u0, int M) {
  const int u = u0 + (s % KU);
  if (s < KU) return u;
  return u ? M - u : M / 2;
}

// Floats of shared memory the transform uses (tables, fold planes, fold
// coefficients, two input-row buffers of float2).
__host__ __device__ constexpr int transform_smem_floats(int T) {
  return 2 * MK * KU + 2 * MK * FS + kMaxT * MK + 2 * 2 * (HS + 2 * T - 2) * MK;
}

struct AnalysisTile {
  const float* __restrict__ x;   // (n_ext, 2) interleaved or (2, n_ext) planar
  int planar;
  long long n_ext;
  const float* __restrict__ coef;  // (T, M) fold coefficients
  const float* __restrict__ cu;    // (M, M/2) cos(2π(mu mod M)/M)
  const float* __restrict__ su;    // (M, M/2) sin, column 0 = (-1)^m
  int M, T, Nh, h0, u0;
  int tid, ty, tx, mm, xrows;
  long long nrow;
  float *Ec, *Es, *Fr, *Fi, *Cf;
  float2* Xs;
  float pc[EQ], ps[EQ], pcf[CQ];
  int buf;

  // `smem` holds transform_smem_floats(T) floats; h0 is the block's
  // first owned hop (its first analysis hop is h0 - 1).
  __device__ __forceinline__ AnalysisTile(
      float* smem, const float* x_, int planar_, long long n_ext_,
      const float* coef_, const float* cu_, const float* su_, int M_, int T_,
      int Nh_, int h0_, int u0_)
      : x(x_), planar(planar_), n_ext(n_ext_), coef(coef_), cu(cu_), su(su_),
        M(M_), T(T_), Nh(Nh_), h0(h0_), u0(u0_), buf(0) {
    tid = threadIdx.x;
    ty = tid >> 4;                 // transform: pairs 2ty.., hops 4tx..
    tx = tid & 15;
    mm = tid % MK;                 // the fold's value of m within a chunk
    xrows = HS + 2 * T - 2;        // input rows a chunk's windows read
    nrow = n_ext / (M / 2);
    Ec = smem;                     // [MK][KU]
    Es = Ec + MK * KU;
    Fr = Es + MK * KU;             // [MK][FS]
    Fi = Fr + MK * FS;
    Cf = Fi + MK * FS;             // [kMaxT][MK]
    Xs = reinterpret_cast<float2*>(Cf + kMaxT * MK);  // [2][xrows][MK]
  }

  // One chunk (sub-tile i0, values m0 .. m0+MK-1) of operands is fetched
  // one chunk ahead, so that its loads are in flight during the previous
  // chunk's fold and contraction.  Sample nP + tM + m is row n + 2t (+1
  // for m >= P), column m mod P of the input, so the chunk's hop windows
  // share HS + 2T - 2 rows of MK samples.
  __device__ __forceinline__ void fetch(int i0, int m0, float2* X) {
    const int P = M / 2;
    const int hb = h0 - 1 + i0 + (m0 >= P ? 1 : 0);
    const int c0 = m0 >= P ? m0 - P : m0;
    for (int e = tid; e < xrows * MK; e += kThreads) {
      const long long row = hb + e / MK;
      const bool ok = row >= 0 && row < nrow;
      const long long i = ok ? row * P + c0 + e % MK : 0;
      if (planar) {
        cp_async<4>(&X[e].x, x + i, ok);
        cp_async<4>(&X[e].y, x + n_ext + i, ok);
      } else {
        cp_async<8>(&X[e], x + 2 * i, ok);
      }
    }
    cp_async_commit();
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const int e = tid + q * kThreads;   // = (m - m0) * KU + pair
      const size_t g = static_cast<size_t>(m0 + e / KU) * P + u0 + e % KU;
      pc[q] = __ldg(cu + g);
      ps[q] = __ldg(su + g);
    }
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int t = tid / MK + q * (kThreads / MK);
      pcf[q] = t < T ? __ldg(coef + t * M + m0 + mm) : 0.f;
    }
  }

  __device__ __forceinline__ void start() { fetch(0, 0, Xs); }

  // The partial sums of sub-tile i0 (analysis hops h0-1+i0 ..
  // h0-1+i0+HS-1, of which those at i0 + hc >= HY are not computed) over
  // all M values of m; fetches the next chunk, and the next sub-tile's
  // first chunk, as it goes.
  __device__ __forceinline__ void transform(int i0, int HY, float (&A)[2][4],
                                            float (&B)[2][4], float (&C)[2][4],
                                            float (&D)[2][4]) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) A[a][b] = B[a][b] = C[a][b] = D[a][b] = 0.f;

    for (int m0 = 0; m0 < M; m0 += MK) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < EQ; ++q) {
        Ec[tid + q * kThreads] = pc[q];
        Es[tid + q * kThreads] = ps[q];
      }
#pragma unroll
      for (int q = 0; q < CQ; ++q) Cf[tid + q * kThreads] = pcf[q];
      cp_async_wait_all();
      __syncthreads();
      const float2* X = Xs + buf * xrows * MK;
      buf ^= 1;
      if (m0 + MK < M)
        fetch(i0, m0 + MK, Xs + buf * xrows * MK);
      else if (i0 + HS < HY)
        fetch(i0 + HS, 0, Xs + buf * xrows * MK);
      // fold the (MK x HS) slice of the hop windows from the staged rows.
      // A thread folds one m for FH hops of one parity, b + 2j: hop b + 2j
      // tap t reads row b + 2(j + t), so its FH windows share FH + T - 1
      // rows, each read from shared memory once.
      {
        const int g = tid / MK;
        const int b = 2 * FH * (g >> 1) + (g & 1);
        float cf[kMaxT], fr[FH], fi[FH];
#pragma unroll
        for (int t = 0; t < kMaxT; ++t) cf[t] = Cf[t * MK + mm];
#pragma unroll
        for (int j = 0; j < FH; ++j) fr[j] = fi[j] = 0.f;
#pragma unroll
        for (int i = 0; i < FH + kMaxT - 1; ++i) {
          if (i < FH + T - 1) {
            const float2 xv = X[(b + 2 * i) * MK + mm];
            const float xr = xv.x, xi = xv.y;
#pragma unroll
            for (int j = 0; j < FH; ++j) {
              const int t = i - j;
              if (t >= 0 && t < kMaxT && t < T) {
                fr[j] = fmaf(cf[t], xr, fr[j]);
                fi[j] = fmaf(cf[t], xi, fi[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < FH; ++j) {
          const int hc = b + 2 * j;
          const int n = h0 - 1 + i0 + hc;
          const bool live = i0 + hc < HY && n >= 0 && n < Nh;
          Fr[mm * FS + hc] = live ? fr[j] : 0.f;
          Fi[mm * FS + hc] = live ? fi[j] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < MK; ++kk) {
        const float2 c2 = *reinterpret_cast<const float2*>(Ec + kk * KU + ty * 2);
        const float2 s2 = *reinterpret_cast<const float2*>(Es + kk * KU + ty * 2);
        const float4 vr = *reinterpret_cast<const float4*>(Fr + kk * FS + tx * 4);
        const float4 vi = *reinterpret_cast<const float4*>(Fi + kk * FS + tx * 4);
        const float c[2] = {c2.x, c2.y};
        const float s[2] = {s2.x, s2.y};
        const float fr4[4] = {vr.x, vr.y, vr.z, vr.w};
        const float fi4[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            A[a][b] = fmaf(fr4[b], c[a], A[a][b]);
            B[a][b] = fmaf(fi4[b], s[a], B[a][b]);
            C[a][b] = fmaf(fi4[b], c[a], C[a][b]);
            D[a][b] = fmaf(fr4[b], s[a], D[a][b]);
          }
      }
    }
  }

  // y_u = (A + B, C - D), y_{M-u} = (A - B, C + D) since cos is even and
  // sin odd in k; for u = 0 the sin column holds channel M/2's (-1)^m,
  // so y_0 = (A, C) and y_{M/2} = (D, B).  Then the hop-parity sign
  // (-1)^{k(n+parity)}: k and M - k share parity, M/2 is even.  The
  // thread's 4 channels (c = a: slot 2ty + a; c = 2 + a: its partner)
  // x 4 hops (4tx + b) stay in registers.
  __device__ __forceinline__ void channels(int i0, int hop0_parity,
                                           const float (&A)[2][4],
                                           const float (&B)[2][4],
                                           const float (&C)[2][4],
                                           const float (&D)[2][4],
                                           float (&yr)[4][4],
                                           float (&yi)[4][4]) const {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int u = u0 + ty * 2 + a;
        const int n = h0 - 1 + i0 + tx * 4 + b;
        const float sg = ((u & 1) && ((n + hop0_parity) & 1)) ? -1.f : 1.f;
        if (u) {
          yr[a][b] = sg * (A[a][b] + B[a][b]);
          yi[a][b] = sg * (C[a][b] - D[a][b]);
          yr[2 + a][b] = sg * (A[a][b] - B[a][b]);
          yi[2 + a][b] = sg * (C[a][b] + D[a][b]);
        } else {
          yr[a][b] = sg * A[a][b];
          yi[a][b] = sg * C[a][b];
          yr[2 + a][b] = sg * D[a][b];
          yi[2 + a][b] = sg * B[a][b];
        }
      }
  }

  // the block slot of the thread's register channel c
  __device__ __forceinline__ int slot(int c) const {
    return (c < 2 ? 0 : KU) + ty * 2 + (c & 1);
  }
};

}  // namespace

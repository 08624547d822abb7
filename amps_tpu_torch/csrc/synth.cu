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
//   x[bP + p] = carry_in[bP + p] (for bP + p < L - P)
//             + sum_{j<2T} gP[jP + p] u_{b-j}[(j&1)P + p],  0 <= b-j < Nh
// Samples [0, Nh·P) are the block's output, the next L - P the new carry.
//
// What bounds it on an H100.  The dense transform is 4·M² real MACs per
// hop, 2·M² with the channel-pair symmetry below: ~105 G FMA for one
// M = 1024 superframe (50004 hops), against 410 MB of input, 410 MB of
// u planes written and read once, and 205 MB of output.  The transform
// is bound by the f32 FMA pipe; the overlap-add by device memory.  The
// function itself needs only an FFT-sized transform (5·M·log2 M flops a
// hop) and no u planes, which leaves the Y and output bytes as its
// bound.
//
// Design.  Two kernels on the caller's stream.
//   * synth_transform_kernel: a tiled f32 SIMT GEMM.  Grid = (hop tiles
//     of 64) x (tiles of 32 channel-column pairs (m, M - m)).  Per chunk
//     of 32 values of k, the block stages the signed Y values and the
//     cos/sin table slices in shared memory (the next chunk is loaded
//     into registers while the current one is contracted), and a thread
//     accumulates a 2-pair x 4-hop register micro-tile of four partial
//     sums A = Σ yr·c, B = Σ yi·s, C = Σ yi·c, D = Σ yr·s; columns m and
//     M - m share cos and negate sin, so that gives both:
//       u[m] = (A - B, D + C),  u[M-m] = (A + B, C - D),
//     and for m = 0 the sin column holds column M/2's (-1)^k:
//       u[0] = (A, C),  u[M/2] = (D, B).
//     The tile is staged once more to write whole rows of u.
//   * synth_ola_kernel: output-stationary overlap-add.  A thread owns one
//     output sample and gathers its 2T terms from hops b - j in order
//     j = 0, 1, ... (the plain version's order, with the same roundings),
//     then adds the carry-in; no atomics.
// The u planes, (Nh, M) each, live in a scratch buffer the wrapper
// allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int KU = 32;           // column pairs per block
constexpr int HB = 64;           // hops per block
constexpr int MK = 32;           // contraction chunk (values of k)
constexpr int FS = HB + 4;       // Y row stride: float4-aligned
constexpr int US = 2 * KU + 1;   // output stage row stride
constexpr int YQ = HB * MK / kThreads;  // Y values a thread loads per chunk
constexpr int EQ = MK * KU / kThreads;  // table values a thread loads per chunk

constexpr int kSmemFloats = (2 * MK * KU + 2 * MK * FS > 2 * HB * US)
                                ? 2 * MK * KU + 2 * MK * FS : 2 * HB * US;

static_assert(KU * HB == kThreads * 8, "2x4 pair-hop micro-tile per thread");
static_assert(kSmemFloats * 4 <= 48 * 1024, "static shared memory");
static_assert(HB * MK % kThreads == 0 && MK * KU % kThreads == 0, "staging");

__global__ void __launch_bounds__(kThreads)
synth_transform_kernel(const float2* __restrict__ Y,   // (Nh, M) complex
                       const float* __restrict__ cu,   // (M, M/2) cos(2π(km mod M)/M)
                       const float* __restrict__ su,   // (M, M/2) sin, column 0 = (-1)^k
                       float* __restrict__ ur,         // (Nh, M)
                       float* __restrict__ ui,         // (Nh, M)
                       int M, int Nh, int hop0_parity) {
  // the contraction's operands, and after it the output stage
  __shared__ __align__(16) float sm[kSmemFloats];
  float* Ec = sm;                 // [MK][KU]
  float* Es = Ec + MK * KU;
  float* Yr = Es + MK * KU;       // [MK][FS]
  float* Yi = Yr + MK * FS;
  float* Ur = sm;                 // [HB][US]
  float* Ui = Ur + HB * US;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // pairs 2ty.., hops 4tx..
  const int n0 = blockIdx.x * HB;
  const int u0 = blockIdx.y * KU;
  const int P = M / 2;

  float2 py[YQ];
  float pc[EQ], ps[EQ];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < YQ; ++q) {
      const int e = tid + q * kThreads;   // = hop * MK + (k - k0)
      const int n = n0 + e / MK;
      py[q] = n < Nh ? __ldg(Y + static_cast<size_t>(n) * M + k0 + e % MK)
                     : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const int e = tid + q * kThreads;   // = (k - k0) * KU + pair
      const size_t g = static_cast<size_t>(k0 + e / KU) * P + u0 + e % KU;
      pc[q] = __ldg(cu + g);
      ps[q] = __ldg(su + g);
    }
  };

  float A[2][4], B[2][4], C[2][4], D[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) A[a][b] = B[a][b] = C[a][b] = D[a][b] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < M; k0 += MK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < YQ; ++q) {
      const int e = tid + q * kThreads;
      const int h = e / MK, kk = e % MK;
      // (-1)^{k(n+parity)}, exact
      const bool neg = ((k0 + kk) & 1) && ((n0 + h + hop0_parity) & 1);
      Yr[kk * FS + h] = neg ? -py[q].x : py[q].x;
      Yi[kk * FS + h] = neg ? -py[q].y : py[q].y;
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      Ec[tid + q * kThreads] = pc[q];
      Es[tid + q * kThreads] = ps[q];
    }
    __syncthreads();
    if (k0 + MK < M) fetch(k0 + MK);
#pragma unroll 4
    for (int kk = 0; kk < MK; ++kk) {
      const float2 c2 = *reinterpret_cast<const float2*>(Ec + kk * KU + ty * 2);
      const float2 s2 = *reinterpret_cast<const float2*>(Es + kk * KU + ty * 2);
      const float4 vr = *reinterpret_cast<const float4*>(Yr + kk * FS + tx * 4);
      const float4 vi = *reinterpret_cast<const float4*>(Yi + kk * FS + tx * 4);
      const float c[2] = {c2.x, c2.y};
      const float s[2] = {s2.x, s2.y};
      const float yr4[4] = {vr.x, vr.y, vr.z, vr.w};
      const float yi4[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          A[a][b] = fmaf(yr4[b], c[a], A[a][b]);
          B[a][b] = fmaf(yi4[b], s[a], B[a][b]);
          C[a][b] = fmaf(yi4[b], c[a], C[a][b]);
          D[a][b] = fmaf(yr4[b], s[a], D[a][b]);
        }
    }
  }

  __syncthreads();
  // stage the tile: row h, slot s (s < KU: column u0 + s; s >= KU: its
  // partner M - u, or M/2 for u = 0)
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = ty * 2 + a, h = tx * 4 + b;
      const bool zero = (u0 + s) == 0;
      Ur[h * US + s] = zero ? A[a][b] : A[a][b] - B[a][b];
      Ui[h * US + s] = zero ? C[a][b] : D[a][b] + C[a][b];
      Ur[h * US + KU + s] = zero ? D[a][b] : A[a][b] + B[a][b];
      Ui[h * US + KU + s] = zero ? B[a][b] : C[a][b] - D[a][b];
    }
  __syncthreads();
  for (int e = tid; e < HB * 2 * KU; e += kThreads) {
    const int h = e / (2 * KU), s = e % (2 * KU);
    const int n = n0 + h;
    if (n >= Nh) continue;
    const int u = u0 + (s % KU);
    const int m = s < KU ? u : (u ? M - u : P);
    const size_t o = static_cast<size_t>(n) * M + m;
    ur[o] = Ur[h * US + s];
    ui[o] = Ui[h * US + s];
  }
}

__global__ void __launch_bounds__(kThreads)
synth_ola_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                 const float* __restrict__ gm,     // (T, M) taps * P
                 const float2* __restrict__ carry_in,  // (L - P)
                 float2* __restrict__ out,         // (Nh * P)
                 float2* __restrict__ carry_out,   // (L - P)
                 int M, int T, int Nh) {
  const int P = M / 2;
  const long long total = static_cast<long long>(Nh + 2 * T - 1) * P;
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= total) return;
  const long long b = s / P;
  const int p = static_cast<int>(s % P);
  float accr = 0.f, acci = 0.f;
  for (int j = 0; j < 2 * T; ++j) {
    const long long h = b - j;
    if (h < 0 || h >= Nh) continue;
    const int col = (j & 1) * P + p;
    const float g = __ldg(gm + (j >> 1) * M + col);
    const size_t o = static_cast<size_t>(h) * M + col;
    accr = __fadd_rn(accr, __fmul_rn(g, __ldg(ur + o)));
    acci = __fadd_rn(acci, __fmul_rn(g, __ldg(ui + o)));
  }
  const long long keep = static_cast<long long>(2 * T - 1) * P;   // L - P
  if (s < keep) {
    const float2 c = carry_in[s];
    accr = __fadd_rn(accr, c.x);
    acci = __fadd_rn(acci, c.y);
  }
  const long long main = static_cast<long long>(Nh) * P;
  if (s < main)
    out[s] = make_float2(accr, acci);
  else
    carry_out[s - main] = make_float2(accr, acci);
}

}  // namespace

// ---- host launcher (plain C interface, loaded with ctypes) ----

extern "C" int synth_column_tile() { return 2 * KU; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 =
// launched).  u is a (2, Nh, M) float scratch buffer.
extern "C" int synth_launch(const void* Y, const void* cu, const void* su,
                            const void* gm, const void* carry_in, void* u,
                            void* out, void* carry_out, int M, int T, int Nh,
                            int hop0_parity, void* stream) {
  if (M % (2 * KU) || M % MK || T < 1 || Nh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ur = static_cast<float*>(u);
  float* ui = ur + static_cast<size_t>(Nh) * M;
  const dim3 grid((Nh + HB - 1) / HB, M / (2 * KU));
  synth_transform_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float2*>(Y), static_cast<const float*>(cu),
      static_cast<const float*>(su), ur, ui, M, Nh, hop0_parity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(Nh + 2 * T - 1) * (M / 2);
  const unsigned nblk = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  synth_ola_kernel<<<nblk, kThreads, 0, st>>>(
      ur, ui, static_cast<const float*>(gm),
      static_cast<const float2*>(carry_in), static_cast<float2*>(out),
      static_cast<float2*>(carry_out), M, T, Nh);
  return static_cast<int>(cudaGetLastError());
}

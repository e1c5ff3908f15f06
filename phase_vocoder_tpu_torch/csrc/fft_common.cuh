// fft_common.cuh — the FFTs in shared memory that the per-frame kernels of
// pvoc_fused.cu and stft.cu share (their analysis, fold analysis and
// synthesis passes; the JAX package's matrix DFTs of ops/pallas/fused.py
// and ops/pallas/stft.py have no other counterpart here).
//
// One block transforms one frame of n complex values held in shared memory
// as two float arrays. Two bodies, chosen by the host-made FftPlan:
//   * n a power of two up to 4096: fft_shared, radix-2 decimation in time,
//     in place, on values stored in bit-reversed order;
//   * any other even n up to 4096: fft_mixed, a mixed-radix Stockham
//     (autosort) transform on values stored in natural order. n is split
//     into the radices 4, 2, 3, 5, 7 and whatever larger primes remain;
//     a stage of radix r computes every output as the r-term sum of its
//     butterfly with one combined twiddle per term, so any radix works and
//     a prime n/2 degenerates into a direct DFT stage of that length
//     (n r complex multiply-adds a stage instead of n log r).
// FP32 throughout, no tensor cores; the twiddles come from a float32 table
// of cos and sin of 2 pi k / n for k < n/2, built in float64 on the host
// (the second half of the circle is the first negated, n being even), so
// every transform rounds the same way in every kernel.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kFftMaxStages = 12;
// Outputs a thread holds in registers in a mixed-radix stage: n is at most
// kFftPerThread * blockDim.x (4096 with the kernels' 256 threads).
constexpr int kFftPerThread = 16;

// How one n-point transform runs: log2n > 0 selects the radix-2 body,
// log2n == 0 the mixed-radix body with its radices in order.
struct FftPlan {
  int n;
  int log2n;
  int stages;
  int radix[kFftMaxStages];
};

// In-place radix-2 decimation-in-time FFT of n complex values held in
// shared memory in bit-reversed order. sign -1: forward, +1: inverse
// (unscaled). twc/tws hold cos and sin of 2 pi k / n for k < n/2. Ends
// with a barrier, so the caller may read the result at once.
__device__ void fft_shared(float* sr, float* si, int n,
                           const float* __restrict__ twc,
                           const float* __restrict__ tws, float sign) {
  for (int len = 2; len <= n; len <<= 1) {
    const int half = len >> 1;
    const int step = n / len;
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
      const int pos = j & (half - 1);
      const int a = (j - pos) * 2 + pos;
      const int b = a + half;
      const float wr = twc[pos * step];
      const float wi = sign * tws[pos * step];
      const float vr = sr[b] * wr - si[b] * wi;
      const float vi = sr[b] * wi + si[b] * wr;
      const float ur = sr[a], ui = si[a];
      sr[a] = ur + vr;
      si[a] = ui + vi;
      sr[b] = ur - vr;
      si[b] = ui - vi;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int bitrev(int t, int log2n) {
  return (int)(__brev((unsigned)t) >> (32 - log2n));
}

// Mixed-radix Stockham FFT of p.n complex values held in shared memory in
// natural order; the result is in natural order too. With ns the product
// of the radices already done, output o of a radix-r stage has
// k = o mod ns, u = (o / ns) mod r and butterfly j = (o / (ns r)) ns + k,
// and is the sum over t < r of in[j + t n/r] W^(t (k n/(ns r) + u n/r)),
// W = e^(sign 2 pi i / n). Each thread keeps its outputs in registers
// until the whole block has read the stage's inputs, so the stage runs in
// place. Ends with a barrier.
__device__ void fft_mixed(float* sr, float* si, const FftPlan& p,
                          const float* __restrict__ twc,
                          const float* __restrict__ tws, float sign) {
  const int n = p.n;
  const int nh = n >> 1;
  float vr[kFftPerThread], vi[kFftPerThread];
  int ns = 1;
  for (int s = 0; s < p.stages; ++s) {
    const int r = p.radix[s];
    const int nr = n / r;
    const int q = nr / ns;
#pragma unroll
    for (int i = 0; i < kFftPerThread; ++i) {
      const int o = threadIdx.x + i * blockDim.x;
      if (o < n) {
        const int k = o % ns;
        const int u = (o / ns) % r;
        const int j = (o / (ns * r)) * ns + k;
        const int step = (k * q + u * nr) % n;
        int e = 0;
        float ar = 0.f, ai = 0.f;
        for (int t = 0; t < r; ++t) {
          const bool neg = e >= nh;
          const int h = neg ? e - nh : e;
          const float c = twc[h], sn = sign * tws[h];
          const float wr = neg ? -c : c;
          const float wi = neg ? -sn : sn;
          const float xr = sr[j + t * nr], xi = si[j + t * nr];
          ar += xr * wr - xi * wi;
          ai += xr * wi + xi * wr;
          e += step;
          if (e >= n) e -= n;
        }
        vr[i] = ar;
        vi[i] = ai;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFftPerThread; ++i) {
      const int o = threadIdx.x + i * blockDim.x;
      if (o < n) {
        sr[o] = vr[i];
        si[o] = vi[i];
      }
    }
    __syncthreads();
    ns *= r;
  }
}

// The kernels that transform are templates on kPow2 (the plan's body), so
// that the power-of-two instantiation holds none of the mixed-radix body's
// registers; the host picks the instantiation by the plan's log2n.

// Where value t of a frame goes in shared memory before fft_run.
template <bool kPow2>
__device__ __forceinline__ int fft_slot(int t, const FftPlan& p) {
  return kPow2 ? bitrev(t, p.log2n) : t;
}

// The transform of plan p on values stored at fft_slot; natural order out.
template <bool kPow2>
__device__ __forceinline__ void fft_run(float* sr, float* si,
                                        const FftPlan& p,
                                        const float* __restrict__ twc,
                                        const float* __restrict__ tws,
                                        float sign) {
  if (kPow2) {
    fft_shared(sr, si, p.n, twc, tws, sign);
  } else {
    fft_mixed(sr, si, p, twc, tws, sign);
  }
}

// The plan of an n-point transform, n even and at most 4096 (or 1).
inline FftPlan make_fft_plan(int n) {
  FftPlan p;
  p.n = n;
  p.log2n = 0;
  p.stages = 0;
  for (int i = 0; i < kFftMaxStages; ++i) p.radix[i] = 1;
  if (n >= 2 && (n & (n - 1)) == 0) {
    while ((1 << p.log2n) < n) ++p.log2n;
    return p;
  }
  int m = n;
  const int small[5] = {4, 2, 3, 5, 7};
  for (int i = 0; i < 5; ++i) {
    while (m % small[i] == 0) {
      p.radix[p.stages++] = small[i];
      m /= small[i];
    }
  }
  for (int f = 11; m > 1; f += 2) {
    while (m % f == 0) {
      p.radix[p.stages++] = f;
      m /= f;
    }
  }
  return p;
}

}  // namespace

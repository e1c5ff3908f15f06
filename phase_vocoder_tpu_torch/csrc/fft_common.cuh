// fft_common.cuh — the radix-2 FFT in shared memory that the per-frame
// kernels of pvoc_fused.cu and stft.cu share.
//
// One block transforms one frame of n complex values (n a power of two up
// to 4096) held in shared memory as two float arrays. FP32 throughout, no
// tensor cores; the twiddles come from a float32 table built in float64 on
// the host, so every transform rounds the same way in every kernel.

#pragma once

#include <cuda_runtime.h>

namespace {

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

inline int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

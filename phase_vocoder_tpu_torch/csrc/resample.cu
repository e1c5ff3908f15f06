// resample_lerp — linear-interpolation resampler on an H100.
//
// Replaces: phase_vocoder_tpu/ops/resample.py, _select_body_v4 (via
// _resample_mxu, irrational steps in [0.5, 2)) and _select_body (via
// _select_kernel_call, steps below 0.5). Same function as the JAX
// resample_linear: out[j] = lerp(x, j / factor), clamped at the edges.
// It also serves the octave (rational) steps, which the JAX package
// computes with an XLA matmul: float64 positions are exact there.
//
// What bounds it here: memory. Each output reads two input floats and
// writes one, with no reuse beyond what L2 catches.
//
// What the design does about it. One thread per output sample, coalesced
// store, neighbouring threads on neighbouring inputs. The TPU's span and
// shear machinery existed only because element gathers are slow there;
// the H100 gathers well, so it is not carried over. The position j/factor
// is computed in float64 (FP64 is cheap on this card), which replaces the
// TPU's host-split f64 block positions and its edge clamp for outputs
// that run past the input's end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void resample_lerp_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int64_t n,
                                     int64_t out_len, double factor) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_len) return;
  double pos = (double)j / factor;
  pos = fmin(fmax(pos, 0.0), (double)(n - 1));
  const int64_t lo = (int64_t)floor(pos);
  const int64_t hi = lo + 1 < n ? lo + 1 : n - 1;
  const float frac = (float)(pos - (double)lo);
  out[j] = x[lo] * (1.0f - frac) + x[hi] * frac;
}

}  // namespace

// x (n floats, n >= 1), out (out_len floats, out_len >= 1).
extern "C" int resample_lerp(const float* x, float* out, long long n,
                             long long out_len, double factor,
                             cudaStream_t stream) {
  const int T = 256;
  const unsigned blocks = (unsigned)((out_len + T - 1) / T);
  resample_lerp_kernel<<<blocks, T, 0, stream>>>(x, out, n, out_len, factor);
  return cudaGetLastError();
}

// resample — the linear-interpolation resamplers on an H100. Every entry
// computes out[j] = lerp(x, j / factor), clamped at the edges (the JAX
// resample_linear); they differ in where the positions are made.
//
// Replaces: these kernels of phase_vocoder_tpu/ops/resample.py,
//   * _select_body_v4 (via _resample_mxu, _SEL_IMPL "mxu", irrational
//     steps in [0.5, 2)) and _select_body for steps below 0.5 ->
//     resample_lerp below: the position j / factor in float64 inside the
//     kernel (FP64 is cheap on this card), which replaces the TPU's
//     host-split f64 block positions and its edge clamp for outputs past
//     the input's end. It also serves the octave (rational) steps, which
//     the JAX package computes with an XLA matmul: float64 positions are
//     exact there;
//   * _select_body_v3 (via _resample_fused, _SEL_IMPL "fused") ->
//     resample_blocked below: the positions made inside the kernel from
//     per-block exact scalars (start_int, start_frac: the float64 split of
//     q*B/factor, made on the host) and two static per-lane tables
//     (jo_int, jo_frac of j/factor), in float32, as the JAX _positions;
//   * _select_body_v2 (via _select_kernel_call, "roll2") and
//     _select_mm_body / _select_body (via _select_kernel_call, "matmul" /
//     "roll") -> select_lerp below, with and without chunk bases: select
//     and lerp from index and weight tensors that plain tensor code made
//     outside the kernel.
//
// What bounds them here: memory. Each output reads two input floats and
// writes one (select_lerp also an index and a weight), with no reuse
// beyond what L1/L2 catch.
//
// What the design does about it. One thread per output sample, coalesced
// store, neighbouring threads on neighbouring inputs. The TPU's span
// matrices, superblock drift, lane rolls, bf16 splits and 0/1 matmuls
// existed only because element gathers are slow there; the H100 gathers
// well, so none is carried over: a span row is its origin in x, and a
// select is a load at origin + c*j + k. The lerp is written with
// __fmul_rn/__fadd_rn in the blocked and select kernels, so that nvcc
// contracts nothing and the result is the plain version's
// lo*(1-w) + hi*w rounding for rounding.

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

// One block of threads per output block of B = blockDim.x samples.
__global__ void resample_blocked_kernel(const float* __restrict__ x,
                                        const long long* __restrict__ start_int,
                                        const float* __restrict__ start_frac,
                                        const int* __restrict__ jo_int,
                                        const float* __restrict__ jo_frac,
                                        float* __restrict__ out, int64_t n,
                                        int64_t out_len) {
  const int64_t q = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t o = q * blockDim.x + j;
  if (o >= out_len) return;
  const float u = __fadd_rn(start_frac[q], jo_frac[j]);  // in [0, 2)
  const float e = floorf(u);
  int64_t lo = (int64_t)start_int[q] + jo_int[j] + (int64_t)e;
  lo = lo < 0 ? 0 : (lo > n - 1 ? n - 1 : lo);
  const int64_t hi = lo + 1 < n ? lo + 1 : n - 1;
  const float w = __fadd_rn(u, -e);
  out[o] = __fadd_rn(__fmul_rn(x[lo], __fadd_rn(1.0f, -w)),
                     __fmul_rn(x[hi], w));
}

// One thread per output (q, j) of (nb, B): i = origin[q] + c*j + k[q, j]
// (+ bases[q, j / 128] when bases is not null), both taps clamped.
__global__ void select_lerp_kernel(const float* __restrict__ x,
                                   const long long* __restrict__ origin,
                                   const int* __restrict__ bases,
                                   const int* __restrict__ k,
                                   const float* __restrict__ fr,
                                   float* __restrict__ out, int64_t n,
                                   int64_t total, int B, int c) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int64_t q = o / B;
  const int j = (int)(o % B);
  int64_t i = (int64_t)origin[q] + (int64_t)c * j + k[o];
  if (bases != nullptr) i += bases[q * (B / 128) + j / 128];
  const int64_t lo = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  const int64_t i1 = i + 1;
  const int64_t hi = i1 < 0 ? 0 : (i1 > n - 1 ? n - 1 : i1);
  const float w = fr[o];
  out[o] = __fadd_rn(__fmul_rn(x[lo], __fadd_rn(1.0f, -w)),
                     __fmul_rn(x[hi], w));
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

// x (n floats, n >= 1), out (out_len floats, out_len >= 1); start_int and
// start_frac hold ceil(out_len / 512) blocks, jo_int and jo_frac 512 lanes.
extern "C" int resample_blocked(const float* x, const long long* start_int,
                                const float* start_frac, const int* jo_int,
                                const float* jo_frac, float* out, long long n,
                                long long out_len, cudaStream_t stream) {
  const int B = 512;
  const unsigned blocks = (unsigned)((out_len + B - 1) / B);
  resample_blocked_kernel<<<blocks, B, 0, stream>>>(
      x, start_int, start_frac, jo_int, jo_frac, out, n, out_len);
  return cudaGetLastError();
}

// x (n floats, n >= 1); origin (nb) int64; k and fr (nb, B); out (nb, B);
// bases (nb, B / 128) int32 or null. c >= 0.
extern "C" int select_lerp(const float* x, const long long* origin,
                           const int* bases, const int* k, const float* fr,
                           float* out, long long n, long long nb, int B, int c,
                           cudaStream_t stream) {
  const int T = 256;
  const int64_t total = nb * (int64_t)B;
  const unsigned blocks = (unsigned)((total + T - 1) / T);
  select_lerp_kernel<<<blocks, T, 0, stream>>>(x, origin, bases, k, fr, out,
                                               n, total, B, c);
  return cudaGetLastError();
}

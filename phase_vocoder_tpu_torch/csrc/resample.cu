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
// What the design does about it. resample_lerp: one thread per output
// sample, coalesced store, neighbouring threads on neighbouring inputs.
// select_lerp and resample_blocked: one block per output block, four
// outputs a thread through 16-byte table loads and stores; select_lerp
// stages the block's span of x in shared memory (select_lerp_kernel
// below), resample_blocked reads its taps through L1
// (resample_blocked_kernel below). The TPU's span
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

// One block per output block q (one row of the (nb, B) tables), 4
// outputs a thread: outputs j = 4t .. 4t+3 take i = origin[q] + c*j +
// k[q, j] (+ bases[q, j / 128]: one chunk for the four, since 128 is a
// multiple of 4), both taps clamped to [0, n-1]. origin[q] and the bases
// are block- and warp-uniform loads; k and fr come in as int4/float4 and
// the outputs leave as a float4 where kVec (B a multiple of 4 and the
// three tables 16-byte aligned). The block's taps lie in one contiguous
// span of x, from its smallest clamped index to its largest: the block
// finds the span's ends by a min/max reduction over its indices and, when
// it holds at most kSpan floats (every table select_tables makes with
// c <= 2), copies it into shared memory with coalesced loads and selects
// from there; a wider span reads its taps through the read-only path.
// Each output is the same lerp of the same taps as one thread an output
// computed it, so the result does not depend on the layout.
constexpr int kSpan = 2048;

__device__ __forceinline__ long long clamp_ll(long long v, long long n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
select_lerp_kernel(const float* __restrict__ x,
                   const long long* __restrict__ origin,
                   const int* __restrict__ bases, const int* __restrict__ k,
                   const float* __restrict__ fr, float* __restrict__ out,
                   long long n, int B, int c) {
  __shared__ float span[kSpan];
  __shared__ long long ends[2][32];  // each warp's smallest and largest index
  const int64_t row = (int64_t)blockIdx.x * B;
  const int j0 = 4 * threadIdx.x;
  const int m = min(4, B - j0);  // outputs of this thread (<= 0: none)
  int kk[4] = {0, 0, 0, 0};
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  if (kVec && m == 4) {
    const int4 kv = __ldg(reinterpret_cast<const int4*>(k + row + j0));
    const float4 fv = __ldg(reinterpret_cast<const float4*>(fr + row + j0));
    kk[0] = kv.x, kk[1] = kv.y, kk[2] = kv.z, kk[3] = kv.w;
    w[0] = fv.x, w[1] = fv.y, w[2] = fv.z, w[3] = fv.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < m) {
        kk[r] = __ldg(k + row + j0 + r);
        w[r] = __ldg(fr + row + j0 + r);
      }
    }
  }
  long long base = __ldg(origin + blockIdx.x);
  if (bases != nullptr && m > 0) base += __ldg(bases + (int64_t)blockIdx.x * (B / 128) + j0 / 128);
  long long idx[4];
  long long lo_i = INT64_MAX, hi_i = INT64_MIN;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    idx[r] = base + (long long)c * (j0 + r) + kk[r];
    if (r < m) {
      lo_i = min(lo_i, idx[r]);
      hi_i = max(hi_i, idx[r] + 1);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo_i = min(lo_i, __shfl_xor_sync(0xffffffffu, lo_i, d));
    hi_i = max(hi_i, __shfl_xor_sync(0xffffffffu, hi_i, d));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ends[0][warp] = lo_i;
    ends[1][warp] = hi_i;
  }
  __syncthreads();
  for (int v = 0; v < (int)(blockDim.x >> 5); ++v) {
    lo_i = min(lo_i, ends[0][v]);
    hi_i = max(hi_i, ends[1][v]);
  }
  // The span of clamped taps: clamping is monotone, so every lo and hi of
  // the block lies in [a, z].
  const long long a = clamp_ll(lo_i, n), z = clamp_ll(hi_i, n);
  const bool staged = z - a < kSpan;  // the same for the whole block
  if (staged) {
    for (int s = threadIdx.x; s <= (int)(z - a); s += blockDim.x) span[s] = __ldg(x + a + s);
    __syncthreads();
  }
  float y[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long lo = clamp_ll(idx[r], n), hi = clamp_ll(idx[r] + 1, n);
    const float xl = staged ? span[lo - a] : __ldg(x + lo);
    const float xh = staged ? span[hi - a] : __ldg(x + hi);
    y[r] = __fadd_rn(__fmul_rn(xl, __fadd_rn(1.0f, -w[r])), __fmul_rn(xh, w[r]));
  }
  if (kVec && m == 4) {
    *reinterpret_cast<float4*>(out + row + j0) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < m) out[row + j0 + r] = y[r];
    }
  }
}

// One block per output block q of kBlockOut = 512 samples (the JAX
// _SEL_BLOCK), 4 outputs a thread (128 threads): outputs j = 4t .. 4t+3
// read jo_int / jo_frac as an int4 / float4 where kVec (the two tables and
// out 16-byte aligned), the block's start_int[q] (the one 64-bit base) and
// start_frac[q] once, and output j takes u = start_frac[q] + jo_frac[j]
// in float32, e = floor(u), the tap start_int[q] + jo_int[j] + e clamped
// to [0, n-1], its neighbour clamped to n-1, and the weight u - e. The
// taps go through the read-only path (a warp's 256 taps fall in ~24 sectors,
// which L1 serves), and the outputs leave as a float4 where kVec. Each
// output is the lerp one thread an output computed, rounding for rounding.
// Staging the block's span of x in shared memory first, as
// select_lerp_kernel does, took 0.0192 ms at the -7 st / 300 s shape
// against 0.0108 for this on an H100: the copy and its barrier are one
// more dependent step in every block's short life.
constexpr int kBlockOut = 512;
constexpr int kBlockThreads = kBlockOut / 4;

template <bool kVec>
__global__ void __launch_bounds__(kBlockThreads)
resample_blocked_kernel(const float* __restrict__ x, const long long* __restrict__ start_int,
                        const float* __restrict__ start_frac, const int* __restrict__ jo_int,
                        const float* __restrict__ jo_frac, float* __restrict__ out, long long n,
                        long long out_len) {
  const int64_t row = (int64_t)blockIdx.x * kBlockOut;
  const int j0 = 4 * threadIdx.x;
  const long long left = out_len - row - j0;
  const int m = left < 4 ? (int)left : 4;  // outputs of this thread (<= 0: none)
  int jo[4];
  float jf[4];
  if (kVec) {
    const int4 iv = __ldg(reinterpret_cast<const int4*>(jo_int + j0));
    const float4 fv = __ldg(reinterpret_cast<const float4*>(jo_frac + j0));
    jo[0] = iv.x, jo[1] = iv.y, jo[2] = iv.z, jo[3] = iv.w;
    jf[0] = fv.x, jf[1] = fv.y, jf[2] = fv.z, jf[3] = fv.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      jo[r] = __ldg(jo_int + j0 + r);
      jf[r] = __ldg(jo_frac + j0 + r);
    }
  }
  const long long base = __ldg(start_int + blockIdx.x);
  const float sf = __ldg(start_frac + blockIdx.x);
  float y[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float u = __fadd_rn(sf, jf[r]);  // in [0, 2)
    const float e = floorf(u);
    const float w = __fadd_rn(u, -e);
    const long long lo = clamp_ll(base + (jo[r] + (int)e), n);
    const long long hi = lo + 1 < n ? lo + 1 : n - 1;
    y[r] = __fadd_rn(__fmul_rn(__ldg(x + lo), __fadd_rn(1.0f, -w)), __fmul_rn(__ldg(x + hi), w));
  }
  if (kVec && m == 4) {
    *reinterpret_cast<float4*>(out + row + j0) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < m) out[row + j0 + r] = y[r];
    }
  }
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
  const unsigned blocks = (unsigned)((out_len + kBlockOut - 1) / kBlockOut);
  const bool vec = (((uintptr_t)jo_int | (uintptr_t)jo_frac | (uintptr_t)out) & 15) == 0;
  if (vec) {
    resample_blocked_kernel<true><<<blocks, kBlockThreads, 0, stream>>>(
        x, start_int, start_frac, jo_int, jo_frac, out, n, out_len);
  } else {
    resample_blocked_kernel<false><<<blocks, kBlockThreads, 0, stream>>>(
        x, start_int, start_frac, jo_int, jo_frac, out, n, out_len);
  }
  return cudaGetLastError();
}

// x (n floats, n >= 1); origin (nb) int64; k and fr (nb, B); out (nb, B);
// bases (nb, B / 128) int32 or null. c >= 0, 1 <= B <= 4096.
extern "C" int select_lerp(const float* x, const long long* origin,
                           const int* bases, const int* k, const float* fr,
                           float* out, long long n, long long nb, int B, int c,
                           cudaStream_t stream) {
  if (B < 1 || B > 4096 || nb < 1) return cudaErrorInvalidValue;
  const unsigned threads = (unsigned)(((B + 3) / 4 + 31) / 32 * 32);
  const bool vec = B % 4 == 0 &&
                   (((uintptr_t)k | (uintptr_t)fr | (uintptr_t)out) & 15) == 0;
  if (vec) {
    select_lerp_kernel<true><<<(unsigned)nb, threads, 0, stream>>>(x, origin, bases, k, fr, out,
                                                                 n, B, c);
  } else {
    select_lerp_kernel<false><<<(unsigned)nb, threads, 0, stream>>>(x, origin, bases, k, fr, out,
                                                                  n, B, c);
  }
  return cudaGetLastError();
}

// stft — the windowed analysis (polar or cartesian), the polar synthesis
// + overlap-add, and the windowed inverse-DFT frames of the phase-vocoder
// routes on an H100.
//
// Replaces: phase_vocoder_tpu/ops/pallas/stft.py
//   * _stft_kernel (framing + Hann window + forward DFT, as wrapped by
//     stft_fused -> (re, im), and by stft_polar with the polar conversion
//     that it leaves to XLA) -> stft_fused and stft_polar below;
//   * _istft_kernel (polar -> cartesian, inverse DFT, synthesis window,
//     fold overlap-add carried across the in-order grid, un-normalized, as
//     wrapped by istft_ola) -> istft_ola below;
//   * _istft_frames_kernel (polar) and _istft_frames_cart_kernel
//     (cartesian): the masked inverse DFT and synthesis window without the
//     overlap-add, for any synthesis hop, as wrapped by istft_frames and
//     istft_frames_cart -> istft_frames below (pass 1 of istft_ola, with
//     a flag for the input form).
//
// What bounds them: device memory traffic. A frame's real FFT is ~2.5 N
// log2 N FP32 operations against 8 N bytes moved (12 N with overlapping
// analysis frames read once), so at any N the bytes of the signal or the
// (nf, N/2+1) spectra and the (nf, N) frames take longer than the
// arithmetic at 67 TFLOP/s. FP32 FMA, no tensor cores, IEEE sqrtf, atan2f
// and sincosf: the phases feed the branch-faithful phase scan, whose point
// is to follow the float64 golden model's princarg choices, and every
// operand split with a ~2^-17 floor failed its 1e-4 gate.
//
// What the design does about it, for a power-of-two N from 256 to 4096
// (stft_real_kernel, istft_real_kernel; the transform is fft_real.cuh,
// and so is the whole analysis body, analysis_groups, which
// pvoc_fused.cu's analysis_real runs too).
// It replaces, at those N, one 256-thread block per frame running a
// complex N-point radix-2 FFT of the real frame in shared memory (10
// stages at N = 1024, each ending in a block barrier; a 32-way
// bank-conflicted bit-reversed scatter on load; every twiddle read from
// global memory; each analysis block reading its own overlapping frame):
//   * a real frame goes through an N/2-point complex FFT. Analysis packs
//     z[n] = g[2n] + i g[2n+1] (g = x w), transforms, and splits bin k
//     (k = 0 .. N/2, Z[N/2] = Z[0]) with the post-twiddle
//     X[k] = (Z[k] + conj Z[N/2-k])/2 - i W^k (Z[k] - conj Z[N/2-k])/2,
//     W = e^(-2 pi i / N). Synthesis builds Y = mask * (polar or
//     cartesian input), the imaginary parts of DC and Nyquist dropped (as
//     a real inverse transform drops them: psi there is 0 or +-pi plus a
//     multiple of pi, whose f32 sine is not zero), merges
//     Z[k] = (Y[k] + conj Y[N/2-k]) + i W^-k (Y[k] - conj Y[N/2-k]),
//     runs the inverse N/2-point FFT, and writes Re z[n] / N and
//     Im z[n] / N, windowed, to samples 2n and 2n+1. Half the butterflies
//     and half the shared memory of a complex N-point transform.
//   * a frame is N/32 threads holding 16 values each, radix 16 and 8 in
//     registers, natural order in and out (no bit reversal), synchronised
//     only among themselves (a warp at N <= 1024, a named barrier above);
//     a 256-thread block holds 8192 / N frames and walks over frame groups
//     (a grid of as many blocks as fit on the SMs at once).
//   * the stage twiddles sit in shared memory, gathered once per block
//     from the host's float64-built table; the post-twiddles and the
//     window are read through the read-only cache, in order.
//   * analysis reads a group of F consecutive frames from one contiguous
//     span x[i0*hop : (i0+F-1)*hop + N] with 16-byte asynchronous copies
//     (4-byte ones up to the first 16-byte boundary and after the last, so
//     x may start at any element), so overlapping frames are read once,
//     and the next group's span arrives while this group transforms. Its
//     bins leave in the JAX layout, (nf, N/2+1) each for (mag, phi) =
//     (sqrt(re^2+im^2), atan2(im, re)) or for (re, im): from each frame's
//     threads at N >= 1024, through shared memory in one block-wide sweep
//     of the group's contiguous rows below (where a warp holds 2-4 frames
//     and would store 32- or 64-byte pieces of their rows at once).
//   * every frame runs the same instructions on its own inputs, so a
//     frame's bits do not depend on its slot, its block, nf or the launch:
//     a whole-signal analysis equals a per-segment one bit for bit, and a
//     rerun equals the run.
// Other even N (and powers of two below 256) keep the one-block-per-frame
// kernels of fft_common.cuh's transform (stft_polar_kernel,
// istft_frames_kernel): a complex N-point FFT in shared memory, the frame
// loaded at its bit-reversed or natural slots.
//
// istft_ola, pass 2: the overlap-add in gather form, a thread per output
// sample summing the <= m frames that cover it in increasing frame order,
// without normalization. The TPU kernel carries the OLA tail in VMEM from
// one grid step to the next; CUDA blocks run in no order, so the gather
// takes its place. No atomics: reruns are bitwise equal.
// Offsets into the signal, spectra and frames are 64-bit. Build without
// fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"
#include "fft_real.cuh"

namespace {

constexpr int kThreads = 256;

// One block per frame: X = rfft(x[i*hop : i*hop+N] * w); (oa, ob)[i] =
// (|X|, arg X) when polar is 1, (Re X, Im X) when 0.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
stft_polar_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float* __restrict__ twc,
                  const float* __restrict__ tws, float* __restrict__ oa,
                  float* __restrict__ ob, FftPlan plan, int hop, int polar) {
  extern __shared__ float sm[];
  const int n_fft = plan.n;
  float* sr = sm;
  float* si = sm + n_fft;
  const int64_t i = blockIdx.x;
  const float* xf = x + i * hop;
  for (int t = threadIdx.x; t < n_fft; t += blockDim.x) {
    const int r = fft_slot<kPow2>(t, plan);
    sr[r] = xf[t] * win[t];
    si[r] = 0.f;
  }
  __syncthreads();
  fft_run<kPow2>(sr, si, plan, twc, tws, -1.f);
  const int nb = n_fft / 2 + 1;
  float* arow = oa + i * nb;
  float* brow = ob + i * nb;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    const float re = sr[k], im = si[k];
    arow[k] = polar ? sqrtf(re * re + im * im) : re;
    brow[k] = polar ? atan2f(im, re) : im;
  }
}

// istft_ola pass 1 and istft_frames, one block per frame:
// frames[i] = w * irfft(Y_i) with the imaginary parts of DC and Nyquist
// dropped, where Y_i = mask_i * a_i * e^{i b_i} (polar: a = mag, b = psi)
// or mask_i * (a_i + i b_i) (cartesian: a = re, b = im).
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
istft_frames_kernel(const float* __restrict__ a,
                    const float* __restrict__ b,
                    const float* __restrict__ mask,
                    const float* __restrict__ win,
                    const float* __restrict__ twc,
                    const float* __restrict__ tws,
                    float* __restrict__ frames, FftPlan plan, int polar) {
  extern __shared__ float sm[];
  const int n_fft = plan.n;
  float* sr = sm;
  float* si = sm + n_fft;
  const int64_t i = blockIdx.x;
  const int nh = n_fft / 2;
  const int nb = nh + 1;
  const float mk = mask[i];
  const float* arow = a + i * nb;
  const float* brow = b + i * nb;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float re, im;
    if (polar) {
      const float m = arow[k] * mk;
      float s, c;
      sincosf(brow[k], &s, &c);
      re = m * c;
      im = m * s;
    } else {
      re = arow[k] * mk;
      im = brow[k] * mk;
    }
    const int r = fft_slot<kPow2>(k, plan);
    sr[r] = re;
    if (k == 0 || k == nh) {
      si[r] = 0.f;
    } else {
      si[r] = im;
      const int rm = fft_slot<kPow2>(n_fft - k, plan);  // Hermitian half: conj(Y[k])
      sr[rm] = re;
      si[rm] = -im;
    }
  }
  __syncthreads();
  fft_run<kPow2>(sr, si, plan, twc, tws, 1.f);
  const float scale = 1.f / n_fft;
  float* out = frames + i * n_fft;
  for (int t = threadIdx.x; t < n_fft; t += blockDim.x) {
    out[t] = sr[t] * scale * win[t];
  }
}

// istft_ola pass 2: out[n] = sum over the frames j covering n, in
// increasing j, of frames[j][n - j*rs]; no normalization.
__global__ void ola_sum_kernel(const float* __restrict__ frames,
                               float* __restrict__ out, int64_t out_len,
                               int64_t nf, int n_fft, int rs, int m) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= out_len) return;
  const int64_t r = n / rs;
  const int t = (int)(n % rs);
  const int64_t jlo = r - m + 1 > 0 ? r - m + 1 : 0;
  const int64_t jhi = r < nf - 1 ? r : nf - 1;
  float acc = 0.f;
  for (int64_t j = jlo; j <= jhi; ++j) {
    const int off = (int)(r - j) * rs + t;
    if (off < n_fft) acc += frames[j * n_fft + off];
  }
  out[n] = acc;
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ------------------ a power-of-two N from 256 to 4096: fft_real.cuh's body

using real_fft::kV;

// The analysis, F frames a group (fft_real.cuh's analysis_groups over one
// batch row): X = rfft(x[i*hop : i*hop+N] * w); (oa, ob)[i] = (|X|,
// arg X) when POLAR, (Re X, Im X) when not.
template <int LOG2N, bool POLAR>
__global__ void __launch_bounds__(real_fft::kThreads, real_fft::kMinBlocks)
stft_real_kernel(const float* __restrict__ x, const float* __restrict__ win,
                 const float* __restrict__ twc, const float* __restrict__ tws,
                 float* __restrict__ oa, float* __restrict__ ob, long long nf,
                 int hop) {
  real_fft::analysis_groups<real_fft::Plan<LOG2N>, POLAR ? real_fft::kPolar : real_fft::kCart>(
      x, 0, nf, 1, nullptr, hop, win, twc, tws, oa, ob);
}

// Y = mask * a * e^{i b} (POLAR) or mask * (a + i b) (cartesian).
template <bool POLAR>
__device__ __forceinline__ void spectrum_bin(float a, float b, float mk,
                                             float& re, float& im) {
  if (POLAR) {
    const float m = a * mk;
    float s, c;
    sincosf(b, &s, &c);
    re = m * c;
    im = m * s;
  } else {
    re = a * mk;
    im = b * mk;
  }
}

// The synthesis, F frames a group: frames[i] = w * irfft(Y_i) with the
// imaginary parts of DC and Nyquist dropped, Y_i = mask_i * a_i *
// e^{i b_i} (POLAR) or mask_i * (a_i + i b_i) (cartesian), through the
// merge Z[k] = (Y[k] + conj Y[M-k]) + i W^-k (Y[k] - conj Y[M-k]),
// W^-k = twc[k] + i tws[k], the inverse M-point FFT z, and
// frames[i][2n], [2n+1] = (Re z[n], Im z[n]) / N * w.
// Shared memory: stage twiddles (2 M), F frame buffers (2 FS each).
template <int LOG2N, bool POLAR>
__global__ void __launch_bounds__(real_fft::kThreads, real_fft::kMinBlocks)
istft_real_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ mask,
                  const float* __restrict__ win,
                  const float* __restrict__ twc,
                  const float* __restrict__ tws, float* __restrict__ frames,
                  long long nf) {
  using P = real_fft::Plan<LOG2N>;
  constexpr int M = P::M, T = P::T, F = P::F;
  constexpr int R0 = 1 << P::lr(0), RL = 1 << P::lr(P::S - 1);
  extern __shared__ __align__(16) float sm[];
  float* twr = sm;
  float* twi = sm + M;
  const int slot = threadIdx.x / T, t = threadIdx.x % T;
  float* br = sm + 2 * M + slot * 2 * P::FS;
  float* bi = br + P::FS;
  real_fft::build_twiddles<P>(twr, twi, twc, tws);
  __syncthreads();
  const float2* win2 = reinterpret_cast<const float2*>(win);
  float2* out2 = reinterpret_cast<float2*>(frames);
  const float scale = 1.f / P::N;
  const long long groups = (nf + F - 1) / F;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long i = g * F + slot;
    const bool live = i < nf;
    real_fft::group_sync<T>(slot);  // the last group's buffer reads done
    if (live) {
      const float mk = __ldg(mask + i);
      const float* arow = a + i * (M + 1);
      const float* brow = b + i * (M + 1);
      // All of the thread's loads first, so that they are in flight
      // together; bin k = t + T u, u < 16, then bin M (thread 0).
      float ra[kV], rb[kV];
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        ra[u] = __ldg(arow + t + T * u);
        rb[u] = __ldg(brow + t + T * u);
      }
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        const int k = t + T * u;
        float re, im;
        spectrum_bin<POLAR>(ra[u], rb[u], mk, re, im);
        br[real_fft::pad(k)] = re;
        bi[real_fft::pad(k)] = k == 0 ? 0.f : im;
      }
      if (t == 0) {
        float re, im;
        spectrum_bin<POLAR>(__ldg(arow + M), __ldg(brow + M), mk, re, im);
        br[real_fft::pad(M)] = re;
        bi[real_fft::pad(M)] = 0.f;
      }
    }
    real_fft::group_sync<T>(slot);
    float vr[kV], vi[kV];
#pragma unroll
    for (int kk = 0; kk < kV / R0; ++kk) {
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        const int n = real_fft::source<P, 0>(t, kk, r);
        const float yr = br[real_fft::pad(n)], yi = bi[real_fft::pad(n)];
        const float cr = br[real_fft::pad(M - n)], ci = -bi[real_fft::pad(M - n)];  // conj Y[M-n]
        const float sr = yr + cr, si = yi + ci;
        const float dr = yr - cr, di = yi - ci;
        const float c = __ldg(twc + n), s = __ldg(tws + n);
        vr[kk * R0 + r] = sr - (c * di + s * dr);
        vi[kk * R0 + r] = si + (c * dr - s * di);
      }
    }
    real_fft::fft<P, false>(vr, vi, br, bi, twr, twi, t, slot);
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kV / RL; ++kk) {
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const int n = real_fft::dest<P, P::S - 1>(t, kk, r);
          const float2 w = __ldg(win2 + n);
          out2[i * M + n] = make_float2(vr[kk * RL + r] * scale * w.x,
                                        vi[kk * RL + r] * scale * w.y);
        }
      }
    }
  }
}

template <int LOG2N, bool POLAR>
cudaError_t launch_stft_real(const float* x, const float* fft, float* oa,
                             float* ob, long long nf, int hop,
                             cudaStream_t stream) {
  using P = real_fft::Plan<LOG2N>;
  const size_t smem = real_fft::analysis_smem<P>(hop);
  unsigned grid = 0;
  const cudaError_t err = real_fft::grid_for(stft_real_kernel<LOG2N, POLAR>, smem,
                                             (nf + P::F - 1) / P::F, &grid);
  if (err != cudaSuccess) return err;
  stft_real_kernel<LOG2N, POLAR><<<grid, real_fft::kThreads, smem, stream>>>(
      x, fft, fft + P::N, fft + P::N + P::M, oa, ob, nf, hop);
  return cudaGetLastError();
}

template <int LOG2N, bool POLAR>
cudaError_t launch_istft_real(const float* a, const float* b,
                              const float* mask, const float* fft,
                              float* frames, long long nf,
                              cudaStream_t stream) {
  using P = real_fft::Plan<LOG2N>;
  const size_t smem = sizeof(float) * (2 * P::M + P::F * 2 * P::FS);
  unsigned grid = 0;
  const cudaError_t err = real_fft::grid_for(istft_real_kernel<LOG2N, POLAR>, smem,
                                             (nf + P::F - 1) / P::F, &grid);
  if (err != cudaSuccess) return err;
  istft_real_kernel<LOG2N, POLAR><<<grid, real_fft::kThreads, smem, stream>>>(
      a, b, mask, fft, fft + P::N, fft + P::N + P::M, frames, nf);
  return cudaGetLastError();
}

// The analysis and synthesis by fft_real.cuh's body at N = 2^log2n.
template <bool POLAR>
cudaError_t analysis_real(int log2n, const float* x, const float* fft,
                          float* oa, float* ob, long long nf, int hop,
                          cudaStream_t stream) {
  switch (log2n) {
    case 8: return launch_stft_real<8, POLAR>(x, fft, oa, ob, nf, hop, stream);
    case 9: return launch_stft_real<9, POLAR>(x, fft, oa, ob, nf, hop, stream);
    case 10: return launch_stft_real<10, POLAR>(x, fft, oa, ob, nf, hop, stream);
    case 11: return launch_stft_real<11, POLAR>(x, fft, oa, ob, nf, hop, stream);
    default: return launch_stft_real<12, POLAR>(x, fft, oa, ob, nf, hop, stream);
  }
}

template <bool POLAR>
cudaError_t synthesis_real(int log2n, const float* a, const float* b,
                           const float* mask, const float* fft, float* frames,
                           long long nf, cudaStream_t stream) {
  switch (log2n) {
    case 8: return launch_istft_real<8, POLAR>(a, b, mask, fft, frames, nf, stream);
    case 9: return launch_istft_real<9, POLAR>(a, b, mask, fft, frames, nf, stream);
    case 10: return launch_istft_real<10, POLAR>(a, b, mask, fft, frames, nf, stream);
    case 11: return launch_istft_real<11, POLAR>(a, b, mask, fft, frames, nf, stream);
    default: return launch_istft_real<12, POLAR>(a, b, mask, fft, frames, nf, stream);
  }
}

// The analysis over nf frames: (mag, phi) when polar is 1, (re, im) when
// 0, by fft_real.cuh's body where it serves n_fft, else by
// stft_polar_kernel in the instantiation of n_fft's plan.
cudaError_t launch_analysis(const float* x, const float* fft, float* oa,
                            float* ob, long long nf, int n_fft, int hop,
                            int polar, cudaStream_t stream) {
  if (const int l = real_fft::real_log2(n_fft)) {
    return polar ? analysis_real<true>(l, x, fft, oa, ob, nf, hop, stream)
                 : analysis_real<false>(l, x, fft, oa, ob, nf, hop, stream);
  }
  const size_t smem = 2 * n_fft * sizeof(float);
  const FftPlan plan = make_fft_plan(n_fft);
  const float* twc = fft + n_fft;
  const float* tws = fft + n_fft + n_fft / 2;
  if (plan.log2n > 0) {
    stft_polar_kernel<true><<<(unsigned)nf, kThreads, smem, stream>>>(
        x, fft, twc, tws, oa, ob, plan, hop, polar);
  } else {
    stft_polar_kernel<false><<<(unsigned)nf, kThreads, smem, stream>>>(
        x, fft, twc, tws, oa, ob, plan, hop, polar);
  }
  return cudaGetLastError();
}

// The windowed inverse frames over nf frames, by fft_real.cuh's body
// where it serves n_fft, else by istft_frames_kernel in the instantiation
// of n_fft's plan.
cudaError_t launch_frames(const float* a, const float* b, const float* mask,
                          const float* fft, float* frames, long long nf,
                          int n_fft, int polar, cudaStream_t stream) {
  if (const int l = real_fft::real_log2(n_fft)) {
    return polar ? synthesis_real<true>(l, a, b, mask, fft, frames, nf, stream)
                 : synthesis_real<false>(l, a, b, mask, fft, frames, nf, stream);
  }
  const size_t smem = 2 * n_fft * sizeof(float);
  const FftPlan plan = make_fft_plan(n_fft);
  const float* twc = fft + n_fft;
  const float* tws = fft + n_fft + n_fft / 2;
  if (plan.log2n > 0) {
    istft_frames_kernel<true><<<(unsigned)nf, kThreads, smem, stream>>>(
        a, b, mask, fft, twc, tws, frames, plan, polar);
  } else {
    istft_frames_kernel<false><<<(unsigned)nf, kThreads, smem, stream>>>(
        a, b, mask, fft, twc, tws, frames, plan, polar);
  }
  return cudaGetLastError();
}

}  // namespace

// x holds >= (nf-1)*hop + n_fft float32 samples, from any element offset;
// fft (2*n_fft) = [Hann window (n_fft) | cos (n_fft/2) | sin (n_fft/2)];
// mag and phi are (nf, n_fft/2+1). n_fft even, up to 4096.
extern "C" int stft_polar(const float* x, const float* fft, float* mag,
                          float* phi, long long nf, int n_fft, int hop,
                          cudaStream_t stream) {
  return launch_analysis(x, fft, mag, phi, nf, n_fft, hop, 1, stream);
}

// stft_polar's spectrum in cartesian form: re and im (nf, n_fft/2+1).
extern "C" int stft_fused(const float* x, const float* fft, float* re,
                          float* im, long long nf, int n_fft, int hop,
                          cudaStream_t stream) {
  return launch_analysis(x, fft, re, im, nf, n_fft, hop, 0, stream);
}

// mag and psi (nf, n_fft/2+1), mask (nf,), fft as above; frames (nf,
// n_fft) is scratch; out ((nf-1)*rs + n_fft) receives the un-normalized
// overlap-add.
extern "C" int istft_ola(const float* mag, const float* psi,
                         const float* mask, const float* fft, float* frames,
                         float* out, long long nf, int n_fft, int rs,
                         cudaStream_t stream) {
  cudaError_t err =
      launch_frames(mag, psi, mask, fft, frames, nf, n_fft, 1, stream);
  if (err != cudaSuccess) return err;
  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  const int m = (n_fft + rs - 1) / rs;
  ola_sum_kernel<<<blocks_for(out_len, kThreads), kThreads, 0, stream>>>(
      frames, out, out_len, nf, n_fft, rs, m);
  return cudaGetLastError();
}

// Windowed frames (nf, n_fft) of the masked inverse DFT, no overlap-add:
// a, b (nf, n_fft/2+1) are (mag, psi) when polar is 1, (re, im) when 0;
// mask (nf,), fft as above.
extern "C" int istft_frames(const float* a, const float* b,
                            const float* mask, const float* fft,
                            float* frames, long long nf, int n_fft,
                            int polar, cudaStream_t stream) {
  return launch_frames(a, b, mask, fft, frames, nf, n_fft, polar, stream);
}

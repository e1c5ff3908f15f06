// stft — the polar analysis and the polar synthesis + overlap-add of the
// branch-faithful phase-vocoder route on an H100.
//
// Replaces: phase_vocoder_tpu/ops/pallas/stft.py
//   * _stft_kernel (framing + Hann window + forward DFT, as wrapped by
//     stft_fused/stft_polar, with the polar conversion that stft_polar
//     leaves to XLA) -> stft_polar below;
//   * _istft_kernel (polar -> cartesian, inverse DFT, synthesis window,
//     fold overlap-add carried across the in-order grid, un-normalized, as
//     wrapped by istft_ola) -> istft_ola below;
//   * _istft_frames_kernel (polar) and _istft_frames_cart_kernel
//     (cartesian): the masked inverse DFT and synthesis window without the
//     overlap-add, for any synthesis hop, as wrapped by istft_frames and
//     istft_frames_cart -> istft_frames below (pass 1 of istft_ola, with
//     a flag for the input form).
//
// What bounds them here: device memory traffic. Each frame's DFT is the
// FFT of fft_common.cuh in shared memory (radix 2 for a power-of-two N,
// ~5 N log2 N FLOP, a hundredth of the TPU kernels' matrix DFTs; mixed
// radix for any other even N up to 4096), so the time goes to reading
// the signal or the (nf, N/2+1) magnitude and phase tensors and writing
// their counterparts. FP32 FMA, no tensor cores: the phases feed the
// branch-faithful phase scan, whose point is to follow the float64 golden
// model's princarg choices.
//
// What the design does about it:
//   stft_polar: one block per frame loads x[i*hop : i*hop+N] (framing is
//     the load), multiplies by the window, transforms, and writes
//     mag = sqrt(re^2+im^2) and phi = atan2(im, re) straight into two
//     (nf, N/2+1) tensors, the JAX layout: the spectrum never reaches
//     device memory as (re, im).
//   istft_ola, pass 1 (and istft_frames): one block per frame turns
//     mask*mag*(cos psi, sin psi), or mask*(re, im) for the cartesian
//     form, into the Hermitian spectrum in shared memory (imaginary
//     parts of DC and Nyquist forced to zero, as a real inverse transform
//     drops them: psi there is 0 or +-pi plus a multiple of pi, whose f32
//     sine is not zero), runs the inverse FFT, and writes w * x / N to an
//     (nf, N) frames tensor.
//   istft_ola, pass 2: the overlap-add in gather form, a thread per output
//     sample summing the <= m frames that cover it in increasing frame
//     order, without normalization. The TPU kernel carries the OLA tail in
//     VMEM from one grid step to the next; CUDA blocks run in no order, so
//     the gather takes its place. No atomics: reruns are bitwise equal.
// Offsets into the signal, spectra and frames are 64-bit. Build without
// fast math: sqrtf, atan2f and sincosf are the IEEE-accurate versions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

// One block per frame: (mag, phi)[i] = polar(rfft(x[i*hop : i*hop+N] * w)).
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
stft_polar_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float* __restrict__ twc,
                  const float* __restrict__ tws, float* __restrict__ mag,
                  float* __restrict__ phi, FftPlan plan, int hop) {
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
  float* mrow = mag + i * nb;
  float* prow = phi + i * nb;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    const float re = sr[k], im = si[k];
    mrow[k] = sqrtf(re * re + im * im);
    prow[k] = atan2f(im, re);
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

// istft_frames_kernel over nf frames, in the instantiation of n_fft's plan.
cudaError_t launch_frames(const float* a, const float* b, const float* mask,
                          const float* fft, float* frames, long long nf,
                          int n_fft, int polar, cudaStream_t stream) {
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

// x holds >= (nf-1)*hop + n_fft float32 samples; fft (2*n_fft) =
// [Hann window (n_fft) | cos (n_fft/2) | sin (n_fft/2)]; mag and phi are
// (nf, n_fft/2+1). n_fft even, up to 4096.
extern "C" int stft_polar(const float* x, const float* fft, float* mag,
                          float* phi, long long nf, int n_fft, int hop,
                          cudaStream_t stream) {
  const size_t smem = 2 * n_fft * sizeof(float);
  const FftPlan plan = make_fft_plan(n_fft);
  const float* twc = fft + n_fft;
  const float* tws = fft + n_fft + n_fft / 2;
  if (plan.log2n > 0) {
    stft_polar_kernel<true><<<(unsigned)nf, kThreads, smem, stream>>>(
        x, fft, twc, tws, mag, phi, plan, hop);
  } else {
    stft_polar_kernel<false><<<(unsigned)nf, kThreads, smem, stream>>>(
        x, fft, twc, tws, mag, phi, plan, hop);
  }
  return cudaGetLastError();
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

// pvoc_fused — the whole phase-vocoder time-scale modification on an H100.
//
// Replaces: phase_vocoder_tpu/ops/pallas/fused.py, _pvoc_kernel (the
// single-recording Pallas kernel) and its tile body _pvoc_tile, as wrapped
// by fused_time_stretch. Same function: raw samples in, normalized
// stretched waveform of length (nf-1)*Rs + N out, for Ra | N and any
// 0 < Rs <= N/2; N a power of two up to 4096.
//
// What bounds it here: device memory traffic. The TPU kernel spends its
// time in DFT matrix products on the MXU; here each frame's DFT is a
// radix-2 FFT in shared memory in FP32 (~5 N log2 N FLOP per transform,
// about a hundredth of a matrix DFT), so the passes are bound by the
// spectra (nf x (N+2) floats, written and read twice) and the windowed
// frames (nf x N floats) that go through device memory between launches.
// FP32 FMA, no tensor cores: the forward transform feeds the unit phasors,
// and every operand split with a ~2^-17 floor failed the 1e-4 golden gate
// on the TPU; the FFT also sums with less rounding error than a direct
// FP32 matrix DFT of length N.
//
// What the design does about it. The TPU kernel runs its grid in order
// and carries state from tile to tile in VMEM scratch; CUDA blocks run in
// no order, so the work is split into launches that need no carried state:
//   (a) analysis: one block per frame loads x[i*Ra : i*Ra+N] (framing is
//       the load), multiplies by the Hann window and runs the FFT of
//       fft_common.cuh with f64-built twiddles; bins 0..N/2 go to the
//       spectrum row;
//   (b) phase: elementwise per (frame, bin). Integer k = Rs/Ra uses the
//       closed form P_i = u_0 (u_i conj u_0)^k, which needs only frame 0.
//       q >= 2 builds the step terms, then a three-pass chunked prefix
//       product (in-chunk products -> serial scan of chunk carries per
//       bin -> apply and renormalize), with no atomics;
//   (c) synthesis: Y = |X| P, then per frame the inverse FFT of the
//       Hermitian spectrum, scaled by 1/N and windowed, to (nf, N) frames;
//   (d) overlap-add in gather form: a thread per output sample sums the
//       <= m frames covering it in increasing frame order and multiplies
//       by the inverse window energy of its row (head, interior or tail).
// Every pass is deterministic, so reruns are bitwise equal. Offsets into
// the signal, spectra and frames are 64-bit. Build without fast math: the
// principal-root branch near zre = -1 and the atan2 accuracy rely on IEEE
// sqrtf, division and atan2f.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kThreads = 256;

struct Geo {
  int64_t nf;
  int n_fft;
  int log2n;
  int nh;     // N/2: general bins are 1..nh-1, Nyquist is nh
  int nb;     // bins per row, nh+1; a spectrum row is [re(nb) | im(nb)]
  int ra, rs;
  int p, q;   // k = Rs/Ra = p/q reduced
  int alg;    // 1: principal roots + integer power; 0: angle domain
  float kf;   // float32(p/q) for the angle domain
  int chunk;  // frames per scan chunk (q >= 2)
};

// (a) One block per frame: spec[i] = rfft(x[i*Ra : i*Ra+N] * w).
__global__ void __launch_bounds__(kThreads)
fft_analysis(const float* __restrict__ x, const float* __restrict__ win,
             const float* __restrict__ twc, const float* __restrict__ tws,
             float* __restrict__ spec, Geo g) {
  extern __shared__ float sm[];
  float* sr = sm;
  float* si = sm + g.n_fft;
  const int64_t i = blockIdx.x;
  const float* xf = x + i * g.ra;
  for (int t = threadIdx.x; t < g.n_fft; t += blockDim.x) {
    const int r = bitrev(t, g.log2n);
    sr[r] = xf[t] * win[t];
    si[r] = 0.f;
  }
  __syncthreads();
  fft_shared(sr, si, g.n_fft, twc, tws, -1.f);
  float* row = spec + i * 2 * g.nb;
  for (int k = threadIdx.x; k < g.nb; k += blockDim.x) {
    row[k] = sr[k];
    row[g.nb + k] = si[k];
  }
}

// (c) One block per frame: frames[i] = w * irfft(Y_i) (imaginary parts of
// DC and Nyquist are zero by construction).
__global__ void __launch_bounds__(kThreads)
fft_synthesis(const float* __restrict__ y, const float* __restrict__ win,
              const float* __restrict__ twc, const float* __restrict__ tws,
              float* __restrict__ frames, Geo g) {
  extern __shared__ float sm[];
  float* sr = sm;
  float* si = sm + g.n_fft;
  const int64_t i = blockIdx.x;
  const float* row = y + i * 2 * g.nb;
  for (int k = threadIdx.x; k < g.n_fft; k += blockDim.x) {
    const int r = bitrev(k, g.log2n);
    if (k <= g.nh) {
      sr[r] = row[k];
      si[r] = row[g.nb + k];
    } else {  // Hermitian half: Y[N-k] conjugated
      sr[r] = row[g.n_fft - k];
      si[r] = -row[g.nb + g.n_fft - k];
    }
  }
  __syncthreads();
  fft_shared(sr, si, g.n_fft, twc, tws, 1.f);
  const float scale = 1.f / g.n_fft;
  float* out = frames + i * g.n_fft;
  for (int t = threadIdx.x; t < g.n_fft; t += blockDim.x) {
    out[t] = sr[t] * scale * win[t];
  }
}

// ------------------------------------------------------- phasor algebra
// Twins of fused.py _int_pow, _principal_sqrt and _pow_k (angle path with
// atan2f in place of the Cephes polynomial Mosaic needed).

__device__ __forceinline__ void int_pow(float zr, float zi, int k, float& rr,
                                        float& ri) {
  float ar = 1.f, ai = 0.f, br = zr, bi = zi;
  int e = k;
  while (e > 0) {
    if (e & 1) {
      const float t = ar * br - ai * bi;
      ai = ar * bi + ai * br;
      ar = t;
    }
    e >>= 1;
    if (e) {
      const float t = br * br - bi * bi;
      bi = 2.f * br * bi;
      br = t;
    }
  }
  rr = ar;
  ri = ai;
}

__device__ __forceinline__ void principal_sqrt(float zr, float zi, float& wr,
                                               float& wi) {
  if (zr >= 0.f) {
    const float r = sqrtf(fmaxf(0.5f * (1.f + zr), 0.25f));
    wr = r;
    wi = zi / (2.f * r);
  } else {
    const float t = sqrtf(fmaxf(0.5f * (1.f - zr), 0.25f));
    wi = zi >= 0.f ? t : -t;
    wr = fabsf(zi) / (2.f * t);
  }
}

__device__ __forceinline__ void pow_k(float zr, float zi, const Geo& g,
                                      float& wr, float& wi) {
  if (g.alg) {
    for (int s = 1; s < g.q; s <<= 1) principal_sqrt(zr, zi, zr, zi);
    if (g.p == 1) {
      wr = zr;
      wi = zi;
    } else {
      int_pow(zr, zi, g.p, wr, wi);
    }
  } else {
    // zi == -0 counts as +0, so the branch point maps to +pi as the
    // golden model's princarg does.
    const float ang = atan2f(zi == 0.f ? 0.f : zi, zr) * g.kf;
    wr = cosf(ang);
    wi = sinf(ang);
  }
}

__device__ __forceinline__ void unit_phasor(float re, float im, float& mag,
                                            float& ur, float& ui) {
  const float n2 = re * re + im * im;
  mag = sqrtf(n2);
  if (n2 > kTiny) {
    ur = re / mag;
    ui = im / mag;
  } else {
    ur = 1.f;
    ui = 0.f;
  }
}

__device__ __forceinline__ void normalize(float& re, float& im) {
  const float r = sqrtf(fmaxf(re * re + im * im, kTiny));
  re = re / r;
  im = im / r;
}

// Y for the forced-real bins, which bypass the phasor machinery: DC passes
// through, Nyquist passes through times (-1)^(Rs*i) with i the global
// frame index. Returns false for a general bin.
__device__ __forceinline__ bool write_real_bin(const float* spec, float* y,
                                               int64_t i, int b,
                                               const Geo& g) {
  if (b != 0 && b != g.nh) return false;
  const int64_t row = i * 2 * g.nb;
  const float sign = (b == g.nh && (g.rs & 1) && (i & 1)) ? -1.f : 1.f;
  y[row + b] = spec[row + b] * sign;
  y[row + g.nb + b] = 0.f;
  return true;
}

// (b), integer k: Y_i = |X_i| u_0 (u_i conj u_0)^k.
__global__ void phase_closed(const float* __restrict__ spec,
                             float* __restrict__ y, Geo g) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * g.nb) return;
  const int64_t i = idx / g.nb;
  const int b = (int)(idx % g.nb);
  if (write_real_bin(spec, y, i, b, g)) return;
  const int64_t row = i * 2 * g.nb;
  float mag, ur, ui, m0, u0r, u0i;
  unit_phasor(spec[row + b], spec[row + g.nb + b], mag, ur, ui);
  unit_phasor(spec[b], spec[g.nb + b], m0, u0r, u0i);
  const float zr = ur * u0r + ui * u0i;
  const float zi = ui * u0r - ur * u0i;
  float wr, wi;
  pow_k(zr, zi, g, wr, wi);
  y[row + b] = mag * (wr * u0r - wi * u0i);
  y[row + g.nb + b] = mag * (wr * u0i + wi * u0r);
}

// (b), q >= 2, pass 1: step terms c (u_i conj u_{i-1} h)^k, term_0 = u_0,
// written into y's general bins.
__global__ void phase_terms(const float* __restrict__ spec,
                            const float* __restrict__ consts,
                            float* __restrict__ y, Geo g) {
  const int ng = g.nh - 1;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * ng) return;
  const int64_t i = idx / ng;
  const int b = 1 + (int)(idx % ng);
  const int64_t row = i * 2 * g.nb;
  float mag, ur, ui;
  unit_phasor(spec[row + b], spec[row + g.nb + b], mag, ur, ui);
  float tr = ur, ti = ui;
  if (i > 0) {
    const int64_t prev = row - 2 * g.nb;
    float mp, pr, pi;
    unit_phasor(spec[prev + b], spec[prev + g.nb + b], mp, pr, pi);
    const float hr = consts[b], hi = consts[g.nh + b];
    const float cr = consts[2 * g.nh + b], ci = consts[3 * g.nh + b];
    const float dr = ur * pr + ui * pi;
    const float di = ui * pr - ur * pi;
    const float zr = dr * hr - di * hi;
    const float zi = dr * hi + di * hr;
    float wr, wi;
    pow_k(zr, zi, g, wr, wi);
    tr = wr * cr - wi * ci;
    ti = wr * ci + wi * cr;
  }
  y[row + b] = tr;
  y[row + g.nb + b] = ti;
}

// Pass 2: inclusive product of the terms inside each chunk (in place),
// and the chunk's total.
__global__ void scan_chunks(float* __restrict__ y, float* __restrict__ tot,
                            Geo g) {
  const int ng = g.nh - 1;
  const int64_t nch = (g.nf + g.chunk - 1) / g.chunk;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nch * ng) return;
  const int64_t c = idx / ng;
  const int b = 1 + (int)(idx % ng);
  const int64_t i0 = c * g.chunk;
  const int64_t i1 = i0 + g.chunk < g.nf ? i0 + g.chunk : g.nf;
  float lr = 0.f, li = 0.f;
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t row = i * 2 * g.nb;
    const float tr = y[row + b], ti = y[row + g.nb + b];
    if (i == i0) {
      lr = tr;
      li = ti;
    } else {
      const float t = lr * tr - li * ti;
      li = lr * ti + li * tr;
      lr = t;
    }
    y[row + b] = lr;
    y[row + g.nb + b] = li;
  }
  tot[(c * ng + (b - 1)) * 2] = lr;
  tot[(c * ng + (b - 1)) * 2 + 1] = li;
}

// Pass 3: per bin, the exclusive product of the chunk totals, renormalized
// at every step.
__global__ void scan_carry(const float* __restrict__ tot,
                           float* __restrict__ carry, Geo g) {
  const int ng = g.nh - 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= ng) return;
  const int64_t nch = (g.nf + g.chunk - 1) / g.chunk;
  float cr = 1.f, ci = 0.f;
  for (int64_t c = 0; c < nch; ++c) {
    const int64_t k = (c * ng + b) * 2;
    carry[k] = cr;
    carry[k + 1] = ci;
    const float tr = tot[k], ti = tot[k + 1];
    const float t = cr * tr - ci * ti;
    ci = cr * ti + ci * tr;
    cr = t;
    normalize(cr, ci);
  }
}

// Pass 4: P_i = normalize(carry_c L_i), Y = |X| P; forced-real bins as usual.
__global__ void phase_apply(const float* __restrict__ spec,
                            const float* __restrict__ carry,
                            float* __restrict__ y, Geo g) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * g.nb) return;
  const int64_t i = idx / g.nb;
  const int b = (int)(idx % g.nb);
  if (write_real_bin(spec, y, i, b, g)) return;
  const int64_t row = i * 2 * g.nb;
  const int64_t k = ((i / g.chunk) * (g.nh - 1) + (b - 1)) * 2;
  const float cr = carry[k], ci = carry[k + 1];
  const float lr = y[row + b], li = y[row + g.nb + b];
  float pr = cr * lr - ci * li;
  float pi = cr * li + ci * lr;
  normalize(pr, pi);
  float mag, ur, ui;
  unit_phasor(spec[row + b], spec[row + g.nb + b], mag, ur, ui);
  y[row + b] = mag * pr;
  y[row + g.nb + b] = mag * pi;
}

// (d) Gather-form overlap-add with the COLA normalization. norm_rows holds
// 2m-1 rows of Rs inverse window energies: head rows 0..m-2, tail rows
// (output rows nf..nf+m-2), then the interior row.
__global__ void ola_gather(const float* __restrict__ frames,
                           const float* __restrict__ norm_rows,
                           float* __restrict__ out, int64_t out_len, Geo g,
                           int m) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= out_len) return;
  const int64_t r = n / g.rs;
  const int t = (int)(n % g.rs);
  const int64_t jlo = r - m + 1 > 0 ? r - m + 1 : 0;
  const int64_t jhi = r < g.nf - 1 ? r : g.nf - 1;
  float acc = 0.f;
  for (int64_t j = jlo; j <= jhi; ++j) {
    const int off = (int)(r - j) * g.rs + t;
    if (off < g.n_fft) acc += frames[j * g.n_fft + off];
  }
  int64_t nrow;
  if (r >= g.nf) {
    nrow = m - 1 + (r - g.nf);
  } else if (r < m - 1) {
    nrow = r;
  } else {
    nrow = 2 * m - 2;
  }
  out[n] = acc * norm_rows[nrow * g.rs + t];
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" const char* pvoc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Buffers (all float32, allocated by the caller):
//   x (>= (nf-1)*ra + n_fft), out ((nf-1)*rs + n_fft),
//   spec and y (nf, 2*(n_fft/2+1)), frames (nf, n_fft),
//   tot and carry (ceil(nf/chunk), n_fft/2-1, 2), unused when q == 1;
// tables: fft (2*n_fft) = [Hann window (n_fft) | cos (n_fft/2) |
//   sin (n_fft/2)], consts (4, n_fft/2) = hre, him, cre, cim,
//   norm_rows (2m-1, rs).
extern "C" int pvoc_fused(const float* x, float* out, float* spec, float* y,
                          float* frames, float* tot, float* carry,
                          const float* fft, const float* consts,
                          const float* norm_rows, long long nf, int n_fft,
                          int ra, int rs, int p, int q, int alg, int chunk,
                          float kf, cudaStream_t stream) {
  Geo g;
  g.nf = nf;
  g.n_fft = n_fft;
  g.log2n = log2_int(n_fft);
  g.nh = n_fft / 2;
  g.nb = g.nh + 1;
  g.ra = ra;
  g.rs = rs;
  g.p = p;
  g.q = q;
  g.alg = alg;
  g.kf = kf;
  g.chunk = chunk;
  const float* win = fft;
  const float* twc = fft + n_fft;
  const float* tws = fft + n_fft + g.nh;
  const int m = (n_fft + rs - 1) / rs;
  const int ng = g.nh - 1;
  const size_t smem = 2 * n_fft * sizeof(float);
  cudaError_t err;

  fft_analysis<<<(unsigned)nf, kThreads, smem, stream>>>(x, win, twc, tws,
                                                         spec, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (q == 1) {
    phase_closed<<<blocks_for(nf * g.nb, kThreads), kThreads, 0, stream>>>(
        spec, y, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else {
    const int64_t nch = (nf + chunk - 1) / chunk;
    phase_terms<<<blocks_for(nf * ng, kThreads), kThreads, 0, stream>>>(
        spec, consts, y, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_chunks<<<blocks_for(nch * ng, kThreads), kThreads, 0, stream>>>(
        y, tot, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_carry<<<blocks_for(ng, kThreads), kThreads, 0, stream>>>(tot, carry,
                                                                  g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    phase_apply<<<blocks_for(nf * g.nb, kThreads), kThreads, 0, stream>>>(
        spec, carry, y, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  fft_synthesis<<<(unsigned)nf, kThreads, smem, stream>>>(y, win, twc, tws,
                                                          frames, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  ola_gather<<<blocks_for(out_len, kThreads), kThreads, 0, stream>>>(
      frames, norm_rows, out, out_len, g, m);
  return cudaGetLastError();
}

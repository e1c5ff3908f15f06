// pvoc_fused — the phase-vocoder time-scale modification on an H100: the
// whole recording, a batch of recordings, one segment of a stream, the
// phasor terms alone, or the synthesis from given phasors.
//
// Replaces: these kernels of phase_vocoder_tpu/ops/pallas/fused.py,
//   * _pvoc_kernel (the single-recording Pallas kernel) and its tile body
//     _pvoc_tile, as wrapped by fused_time_stretch -> pvoc_fused below.
//     Raw samples in, normalized stretched waveform of length
//     (nf-1)*Rs + N out, for Ra | N and any 0 < Rs <= N/2; N even, up to
//     4096;
//   * _pvoc_kernel_z (fused_time_stretch(zrev=True)) -> pvoc_fused_zrev
//     below: the same TSM with the analysis through the fold pass (a'),
//     which uses the frame's real symmetry to halve the transform, where
//     the TPU body's even/odd fold halves its DFT matrices;
//   * _pvoc_kernel_batched, as wrapped by fused_time_stretch_batch ->
//     pvoc_fused_batch below: the same TSM over the rows of a (B, T)
//     batch, each row with its own frame count (ragged), its own anchor,
//     scan and head/tail normalization;
//   * _pvoc_kernel_stream, as wrapped by fused_stream_segment ->
//     pvoc_fused_segment below: the same TSM on one F-frame segment, with
//     the cross-segment state (anchor/previous unit phasor, running phasor
//     P, the OLA tail, the started flag and the global frame offset)
//     flowing in and out;
//   * _terms_kernel and _terms_kernel_batched, as wrapped by
//     stft_phasor_terms and stft_phasor_terms_batch -> pvoc_terms below:
//     framing, the windowed FFT, |X|, the unit phasors and the step terms
//     of every bin (DC and Nyquist included), optionally with the
//     renormalized prefix product, for one recording or every row of a
//     batch. No synthesis;
//   * _synth_kernel and _synth_kernel_batched, as wrapped by
//     phasor_istft_ola and phasor_istft_ola_batch -> pvoc_phasor_synth
//     below: Y = mask |X| P from given magnitudes and phasors, the
//     windowed inverse FFT and the fold overlap-add, normalized or (with a
//     frame mask) not.
//
// What bounds it here: device memory traffic. The TPU kernel spends its
// time in DFT matrix products on the MXU; here each frame's DFT is an FFT
// in FP32 (~2.5-5 N log2 N FLOP per transform, about a hundredth of a
// matrix DFT), so the passes are bound by the spectra (nf x (N+2) floats,
// written once and read once at integer k where fft_real.cuh serves N,
// and a packed Y besides elsewhere) and the windowed frames (nf x N
// floats) that go through device memory between launches; at integer k
// the synthesis pass also does the closed form's square roots and
// divisions.
// FP32 FMA, no tensor cores: the forward transform feeds the unit phasors,
// and every operand split with a ~2^-17 floor failed the 1e-4 golden gate
// on the TPU; the FFT also sums with less rounding error than a direct
// FP32 matrix DFT of length N.
//
// What the design does about it. The TPU kernel runs its grid in order
// and carries state from tile to tile in VMEM scratch; CUDA blocks run in
// no order, so the work is split into launches that need no carried state:
//   (a) analysis. For a power-of-two N from 256 to 4096 (analysis_real,
//       fft_real.cuh's analysis_groups, the body of stft.cu's analysis):
//       the windowed frame g = x w is packed as z[n] = g[2n] + i g[2n+1],
//       transformed by an N/2-point Stockham FFT in registers (radix
//       16/8; N/32 threads a frame, a warp at N = 1024; 8192/N frames a
//       256-thread block; stage twiddles in shared memory, built from the
//       float64 host table) and split with a post-twiddle:
//       X[k] = (Z[k] + conj Z[N/2-k])/2 - i W^k (Z[k] - conj Z[N/2-k])/2,
//       W = e^{-2 pi i / N}, one thread making bins k and N/2-k; DC and
//       Nyquist leave with zero imaginary parts. A block reads the span
//       of a group of consecutive frames of one batch row once, with
//       asynchronous copies one group ahead (framing is the load, from any
//       element offset), and the groups of every batch row are flattened
//       over a resident grid; bins 0..N/2 go to the packed spectrum row,
//       through one block-wide sweep of the group's rows below N = 1024.
//       Every other N (128, and every N that is not a power of two) keeps
//       one block a frame (fft_analysis: the frame loaded at its FFT
//       slots, the complex N-point FFT of fft_common.cuh, radix 2 or mixed
//       radix, in shared memory);
//   (a') fold analysis (pvoc_fused_zrev, N a multiple of 4): the TPU body
//       folds with E = w (f[t] + f[N-t]) and O = w (f[t] - f[N-t]) because
//       that halves its cos and sin matrices; an FFT gains nothing from E
//       and O (each still needs a full-length transform), while the packed
//       form above halves the butterfly work and the shared memory, so the
//       packed form is the fold pass. At the powers of two from 256 to
//       4096 it is (a) itself: pvoc_fused_zrev runs analysis_real, and its
//       output equals pvoc_fused's bit for bit. At the other N that are
//       multiples of 4 it keeps one block a frame (fft_analysis_fold: the
//       packed frame through fft_common.cuh's N/2-point FFT, then the
//       split), read straight from x: no reversed or packed copy of the
//       signal reaches device memory;
//   (b) phase: elementwise per (frame, bin). Integer k = Rs/Ra uses the
//       closed form P_i = u_0 (u_i conj u_0)^k, which needs only frame 0.
//       Where fft_real.cuh serves N this is no pass of its own: a small
//       pass (phase_anchor) makes each batch row's anchor table u_0 (a
//       stream segment has it in its carry already), and synth_real forms
//       Y = |X| P from the packed spectrum and that table as it loads each
//       bin, so the spectra are read once and no packed Y goes through
//       device memory. Every other N keeps the elementwise phase_closed.
//       q >= 2 builds the step terms, then a three-pass chunked prefix
//       product (in-chunk products -> serial scan of chunk carries per
//       bin -> apply and renormalize), with no atomics. pvoc_terms runs
//       the terms and the in-chunk products as one pass (terms_chunks: a
//       block walks the frames of one chunk over every bin, a thread a
//       bin, the spectrum rows copied into shared memory a tile of rows
//       ahead), and its apply pass on the same layout
//       (scan_apply_chunks); the serial carry scan (scan_carry_staged,
//       every caller) is one warp a block, its chunk totals staged into
//       shared memory a stage ahead of the chain;
//   (c) synthesis: Y = |X| P, then per frame the inverse FFT of the
//       Hermitian spectrum, scaled by 1/N and windowed, to (nf, N) frames.
//       For a power-of-two N from 256 to 4096 (synth_real) a real frame
//       goes through fft_real.cuh's N/2-point body: the pre-twiddle merge
//       Z[k] = (Y[k] + conj Y[N/2-k]) + i W^-k (Y[k] - conj Y[N/2-k]), the
//       inverse N/2-point Stockham FFT in registers (radix 16/8), and
//       Re z[n], Im z[n] to samples 2n, 2n+1; N/32 threads a frame (a warp
//       at N = 1024), 8192/N frames a 256-thread block, stage twiddles in
//       shared memory, a grid of as many blocks as run at once walking
//       over the frame groups of every batch row. synth_real reads Y from
//       the packed rows of the q >= 2 phase passes, forms it at integer k
//       from the spectrum and the anchor table (b), or, in
//       pvoc_phasor_synth, forms it from the magnitude and phasor planes as
//       it loads them, so that in those two no packed copy of Y goes
//       through device memory. Every other N
//       takes fft_synthesis: one block a frame, a complex N-point FFT in
//       shared memory (fft_common.cuh: radix 2 at N = 128, mixed radix for
//       N not a power of two), after phasor_y packs Y;
//   (d) overlap-add in gather form (ola_rows): a warp (or, for short
//       rows, a part of one) owns an output row of Rs samples and sums, for each sample, the <= m frames covering
//       it in increasing frame order, then multiplies by the inverse window
//       energy of its row (head, interior or tail), chosen once a row; the
//       frames are read and the row written in contiguous float4 runs
//       where Rs allows, and a resident grid walks over the rows.
// A batch is the same launches with the batch row as gridDim.y (in
// analysis_real and synth_real, the batch rows' frame groups flattened
// over one grid, a group never across two rows; in ola_rows, the batch
// rows' output rows): every buffer holds B
// rows of nf frames, a row's passes touch only its own frames (the first
// n_b of them, n_b read from a device array of frame counts), so each row
// computes exactly what the single-recording launch computes for its own
// signal.
// The TPU grid's batch axis reset its VMEM carry at each row's first
// tile; here there is no carry to reset.
// A stream segment is the same launches with the state as arguments: the
// first frame's previous phasor (q >= 2) or anchor (integer k) is read
// from the carry once the recording has started; the carry scan starts
// from the carried P, and its running value after the last chunk is the
// next segment's P (equal to what the apply pass writes for the last
// frame); the gather starts each of the first m-1 rows from the
// un-normalized partial sum the previous segment left, and leaves the sums
// of its own last frames into the next m-1 rows the same way. With F a
// multiple of the chunk and F >= m-1, every float operation happens in the
// order of the single-recording run, so a stream is bitwise equal to it.
// analysis_real and synth_real run the same instructions for every frame
// on its own inputs, so a frame's bits do not depend on its slot, its
// block, its batch row, its span's alignment or the launch, and these
// contracts hold for them as for the one-block-a-frame passes. Every pass is deterministic, so reruns are
// bitwise equal. Offsets into
// the signal, spectra and frames are 64-bit. Build without fast math: the
// principal-root branch near zre = -1 and the atan2 accuracy rely on IEEE
// sqrtf, division and atan2f.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"
#include "fft_real.cuh"

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kThreads = 256;

struct Geo {
  int64_t nf;        // frames per batch row of this launch's buffers
  int64_t goff;      // global index of its frame 0
  int64_t nf_total;  // frames of the recording (normalization rows)
  int started;       // 0 only before the recording's first frame
  int n_fft;
  FftPlan fft;   // the N-point transform
  FftPlan half;  // the N/2-point transform of the fold analysis
  int nh;     // N/2: general bins are 1..nh-1, Nyquist is nh
  int nb;     // bins per row, nh+1; a spectrum row is [re(nb) | im(nb)]
  int ra, rs;
  int p, q;   // k = Rs/Ra = p/q reduced
  int alg;    // 1: principal roots + integer power; 0: angle domain
  float kf;   // float32(p/q) for the angle domain
  int chunk;  // frames per scan chunk (q >= 2)
  int batch;          // batch rows, gridDim.y of every pass
  int64_t x_stride;   // samples between two rows of x
  const int* nfs;     // frames of each row (device), or null: all have nf
};

// Frames of batch row b: its own count in a ragged batch, else nf.
__device__ __forceinline__ int64_t row_frames(const Geo& g, int b) {
  return g.nfs != nullptr ? (int64_t)g.nfs[b] : g.nf;
}

// Where the prefix product's bins live: bin b of frame i of batch row r
// has its real part at (r*nf + i)*stride + b and its imaginary part im_off
// further; bins b0..b0+n-1.
struct Lanes {
  int64_t stride;
  int64_t im_off;
  int b0;
  int n;
};

// (a), N not served by fft_real.cuh: one block per frame,
// spec[i] = rfft(x[i*Ra : i*Ra+N] * w).
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
fft_analysis(const float* __restrict__ x, const float* __restrict__ win,
             const float* __restrict__ twc, const float* __restrict__ tws,
             float* __restrict__ spec, Geo g) {
  extern __shared__ float sm[];
  float* sr = sm;
  float* si = sm + g.n_fft;
  const int bat = blockIdx.y;
  const int64_t i = blockIdx.x;
  if (i >= row_frames(g, bat)) return;
  const float* xf = x + bat * g.x_stride + i * g.ra;
  for (int t = threadIdx.x; t < g.n_fft; t += blockDim.x) {
    const int r = fft_slot<kPow2>(t, g.fft);
    sr[r] = xf[t] * win[t];
    si[r] = 0.f;
  }
  __syncthreads();
  fft_run<kPow2>(sr, si, g.fft, twc, tws, -1.f);
  float* row = spec + (bat * g.nf + i) * 2 * g.nb;
  for (int k = threadIdx.x; k < g.nb; k += blockDim.x) {
    row[k] = sr[k];
    row[g.nb + k] = si[k];
  }
}

// (a'), N not served by fft_real.cuh: one block per frame, the fold
// analysis: the same spectrum row from
// an N/2-point transform of z[n] = g[2n] + i g[2n+1], g = x w, split with
// the post-twiddle W^k = twc[k] - i tws[k] (k < N/2; W^(N/2) = -1).
// hwc/hws are the twiddles of the N/2-point transform.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
fft_analysis_fold(const float* __restrict__ x, const float* __restrict__ win,
                  const float* __restrict__ twc,
                  const float* __restrict__ tws,
                  const float* __restrict__ hwc,
                  const float* __restrict__ hws, float* __restrict__ spec,
                  Geo g) {
  extern __shared__ float sm[];
  const int L = g.nh;
  float* sr = sm;
  float* si = sm + L;
  const int bat = blockIdx.y;
  const int64_t i = blockIdx.x;
  if (i >= row_frames(g, bat)) return;
  const float* xf = x + bat * g.x_stride + i * g.ra;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const int r = fft_slot<kPow2>(t, g.half);
    sr[r] = xf[2 * t] * win[2 * t];
    si[r] = xf[2 * t + 1] * win[2 * t + 1];
  }
  __syncthreads();
  fft_run<kPow2>(sr, si, g.half, hwc, hws, -1.f);
  float* row = spec + (bat * g.nf + i) * 2 * g.nb;
  for (int k = threadIdx.x; k <= L; k += blockDim.x) {
    const int a = k == L ? 0 : k;
    const int b = k == 0 ? 0 : L - k;
    const float zr = sr[a], zi = si[a];
    const float mr = sr[b], mi = -si[b];  // conj Z[N/2 - k]
    const float er = 0.5f * (zr + mr), ei = 0.5f * (zi + mi);
    const float pr = 0.5f * (zi - mi), pi = -0.5f * (zr - mr);
    const float wr = k < L ? twc[k] : -1.f;
    const float wi = k < L ? -tws[k] : 0.f;
    row[k] = er + (pr * wr - pi * wi);
    row[g.nb + k] = ei + (pr * wi + pi * wr);
  }
}

// (a) and (a') on fft_real.cuh's analysis body (analysis_groups), N =
// 2^LOG2N from 256 to 4096: spec[b nf + i] = rfft(x[b x_stride + i Ra :]
// [: N] * w) as the packed row [re(nb) | im(nb)], for row b's first
// row_frames(g, b) frames. A group's span ends at its last live frame, so
// a segment reads nothing past its n_valid frames of x_seg.
// Registers: as many as the blocks that its shared memory lets an SM hold
// at hop N/4 allow (analysis_smem: 52-54 KB a block at N = 256, 512; 59
// and 69 KB at 1024, 2048; 89 KB at 4096): 4 blocks an SM (64 registers)
// at N = 256, 512, 3 (80) at 1024, 2048, 2 (128) at 4096. Under a cap of
// 64 it spilled 8-52 bytes at N = 1024-4096 (nvcc -Xptxas -v) and its
// pass ran 1.5-11% slower there on an H100.
template <int LOG2N>
__global__ void __launch_bounds__(real_fft::kThreads, LOG2N <= 9 ? 4 : LOG2N <= 11 ? 3 : 2)
analysis_real(const float* __restrict__ x, const float* __restrict__ win,
              const float* __restrict__ twc, const float* __restrict__ tws,
              float* __restrict__ spec, Geo g) {
  real_fft::analysis_groups<real_fft::Plan<LOG2N>, real_fft::kPacked>(
      x, g.x_stride, g.nf, g.batch, g.nfs, g.ra, win, twc, tws, spec, nullptr);
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

// a / r for r > 0: a zero dividend is kept as it is (that is the
// quotient, sign included) and 1 is divided in its place, since IEEE
// division takes its slow path for a zero dividend; the DC and Nyquist
// bins carry exact zeros through the phasor passes.
__device__ __forceinline__ float div_nz(float a, float r) {
  const float q = __fdiv_rn(a == 0.f ? 1.f : a, r);
  return a == 0.f ? a : q;
}

__device__ __forceinline__ void unit_phasor(float re, float im, float& mag,
                                            float& ur, float& ui) {
  const float n2 = re * re + im * im;
  mag = sqrtf(n2);
  if (n2 > kTiny) {
    ur = div_nz(re, mag);  // the DC and Nyquist bins' imaginary parts are 0
    ui = div_nz(im, mag);
  } else {
    ur = 1.f;
    ui = 0.f;
  }
}

// The chunked prefix product's complex products and renormalization, each
// rounding written out (__fmaf_rn, __fmul_rn, IEEE square root and
// division): nvcc picks which product of a*b +- c*d it fuses by the
// surrounding code, so the same expression in two kernels could round two
// ways. These are the roundings nvcc gave the passes as they were first
// written (one thread an element or a bin), kept so that every scanned
// phasor keeps its bits whichever kernel forms it.
// a b with a the running product and b the next factor (the in-chunk
// products, the chain of chunk totals).
__device__ __forceinline__ void cmul_scan(float ar, float ai, float br,
                                          float bi, float& re, float& im) {
  re = __fmaf_rn(ar, br, -__fmul_rn(ai, bi));
  im = __fmaf_rn(ai, br, __fmul_rn(ar, bi));
}

__device__ __forceinline__ void normalize(float& re, float& im) {
  const float r = __fsqrt_rn(fmaxf(__fmaf_rn(re, re, __fmul_rn(im, im)), kTiny));
  re = div_nz(re, r);
  im = div_nz(im, r);
}

// The integer-k closed form, rounded as written: every product and sum
// of the next three functions is its own IEEE operation (__fmul_rn,
// __fadd_rn: nvcc contracts none of them into an FMA), so that every
// kernel that forms the closed form or its anchor rounds it alike. nvcc
// picks which product of a*b + c*d it fuses by the surrounding code, so
// the same expression inlined into two kernels could round two ways.
// This is also the plain version's order (ops/fused.py _unit, _int_pow,
// _cmul on the CPU, where nothing is fused).
__device__ __forceinline__ float mul_add(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}
__device__ __forceinline__ float mul_sub(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// unit_phasor of the closed form (its anchors and bins).
__device__ __forceinline__ void unit_phasor_rn(float re, float im, float& mag,
                                               float& ur, float& ui) {
  const float n2 = mul_add(re, re, im, im);
  mag = __fsqrt_rn(n2);
  if (n2 > kTiny) {
    ur = __fdiv_rn(re, mag);
    ui = __fdiv_rn(im, mag);
  } else {
    ur = 1.f;
    ui = 0.f;
  }
}

// Y of general bin X = (re, im) at integer k = p: |X| u_0 (u conj u_0)^k,
// u = X/|X|; z^k by repeated squaring (int_pow's order) where g.alg, else
// pow_k's angle domain. phase_closed and synth_real's closed-form load
// both call it, so that the two make the same Y.
__device__ __forceinline__ void closed_bin(float re, float im, float u0r,
                                           float u0i, const Geo& g,
                                           float& yr, float& yi) {
  float mag, ur, ui;
  unit_phasor_rn(re, im, mag, ur, ui);
  const float zr = mul_add(ur, u0r, ui, u0i);
  const float zi = mul_sub(ui, u0r, ur, u0i);
  float wr = zr, wi = zi;
  if (!g.alg) {
    pow_k(zr, zi, g, wr, wi);
  } else if (g.p != 1) {
    float ar = 1.f, ai = 0.f, br = zr, bi = zi;
    for (int e = g.p; e > 0;) {
      if (e & 1) {
        const float t = mul_sub(ar, br, ai, bi);
        ai = mul_add(ar, bi, ai, br);
        ar = t;
      }
      e >>= 1;
      if (e) {
        const float t = mul_sub(br, br, bi, bi);
        bi = __fmul_rn(__fmul_rn(2.f, br), bi);
        br = t;
      }
    }
    wr = ar;
    wi = ai;
  }
  yr = __fmul_rn(mag, mul_sub(wr, u0r, wi, u0i));
  yi = __fmul_rn(mag, mul_add(wr, u0i, wi, u0r));
}

// (c), N not served by fft_real.cuh: one block per frame, frames[i] =
// w * irfft(Y_i) (imaginary parts of DC and Nyquist are zero by
// construction).
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
fft_synthesis(const float* __restrict__ y, const float* __restrict__ win,
              const float* __restrict__ twc, const float* __restrict__ tws,
              float* __restrict__ frames, Geo g) {
  extern __shared__ float sm[];
  float* sr = sm;
  float* si = sm + g.n_fft;
  const int bat = blockIdx.y;
  const int64_t i = blockIdx.x;
  if (i >= row_frames(g, bat)) return;
  const int64_t fr = bat * g.nf + i;
  const float* row = y + fr * 2 * g.nb;
  for (int k = threadIdx.x; k < g.n_fft; k += blockDim.x) {
    const int r = fft_slot<kPow2>(k, g.fft);
    if (k <= g.nh) {
      sr[r] = row[k];
      si[r] = row[g.nb + k];
    } else {  // Hermitian half: Y[N-k] conjugated
      sr[r] = row[g.n_fft - k];
      si[r] = -row[g.nb + g.n_fft - k];
    }
  }
  __syncthreads();
  fft_run<kPow2>(sr, si, g.fft, twc, tws, 1.f);
  const float scale = 1.f / g.n_fft;
  float* out = frames + fr * g.n_fft;
  for (int t = threadIdx.x; t < g.n_fft; t += blockDim.x) {
    out[t] = sr[t] * scale * win[t];
  }
}

// Where synth_real finds Y: the packed rows [re(nb) | im(nb)] that the
// phase passes leave in y (kRows); Y = (|X| P_re) mask + i (|X| P_im) mask
// formed from the (B, nf, nb) planes mag, pre, pim and the optional
// (B, nf) mask, in phasor_y's order (kPlanes); or, at integer k, the
// closed form of phase_closed formed from the packed spectrum rows X in y
// and the anchor table u0 (kClosed).
enum SynthSource { kRows, kPlanes, kClosed };

// (c) on fft_real.cuh's body, N = 2^LOG2N from 256 to 4096:
// frames[i] = w * irfft(Y_i) with the imaginary parts of DC and Nyquist
// dropped, through the merge Z[k] = (Y[k] + conj Y[M-k]) + i W^-k (Y[k] -
// conj Y[M-k]), W^-k = twc[k] + i tws[k], the inverse M-point FFT z and
// frames[i][2n], [2n+1] = (Re z[n], Im z[n]) / N * w. Y comes from SRC
// (SynthSource). With kPlanes and kClosed it is formed as the bins are
// loaded, so that no packed copy of Y goes through device memory; kClosed
// runs phase_closed's arithmetic (closed_bin, DC passed through, Nyquist
// times (-1)^(Rs (goff + i))) on each bin as it arrives, so its Y is
// phase_closed's bit for bit. A group is F consecutive frames of
// one batch row; the rows' groups are flattened over a resident grid. A
// group wholly past its row's frames is skipped by the whole block; in a
// group that is not, a frame past the row's frames runs the transform
// with its group (its barriers are its group's) and writes nothing.
// Shared memory: stage twiddles (2 M), F frame buffers (2 FS each).
// Registers: fft_real.cuh's cap of 64 (kMinBlocks blocks an SM), but at
// N = 2048 three blocks an SM (80 registers, no spill): under the cap of
// 64 this kernel spilled 44-68 bytes there (nvcc -Xptxas -v) and ran
// slower on an H100. kClosed at N = 4096 also takes three (80 registers):
// under 64 it spilled 44 bytes. kClosed loads the frame's X first (32
// values a thread, as kRows), then each bin's anchor from L1 as it forms
// that bin's Y: in four rounds of four bins, loads first in each, its
// pass ran slower on an H100.
template <int LOG2N, int SRC>
__global__ void __launch_bounds__(real_fft::kThreads,
                                  LOG2N == 11 || (LOG2N == 12 && SRC == kClosed) ? 3
                                                                             : real_fft::kMinBlocks)
synth_real(const float* __restrict__ y, const float* __restrict__ u0,
           const float* __restrict__ mag,
           const float* __restrict__ pre, const float* __restrict__ pim,
           const float* __restrict__ mask, const float* __restrict__ win,
           const float* __restrict__ twc, const float* __restrict__ tws,
           float* __restrict__ frames, Geo g) {
  using P = real_fft::Plan<LOG2N>;
  using real_fft::kV;
  using real_fft::pad;
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
  const int64_t per_row = (g.nf + F - 1) / F;
  const int64_t groups = per_row * g.batch;
  for (int64_t gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const int bat = (int)(gi / per_row);
    const int64_t i0 = (gi - bat * per_row) * F;
    const int64_t n_row = row_frames(g, bat);
    if (i0 >= n_row) continue;  // the same for the whole block
    const int64_t i = i0 + slot;
    const bool live = i < n_row;
    const int64_t fr = bat * g.nf + i;  // the frame's row in the buffers
    real_fft::group_sync<T>(slot);  // the last group's buffer reads done
    if (live) {
      // All of a round's loads first, so that they are in flight
      // together; bin k = t + T u, u < 16, then bin M (thread 0).
      if constexpr (SRC == kPlanes) {
        float ra[kV], rb[kV];
        const float mk = mask != nullptr ? __ldg(mask + fr) : 1.f;
        const float* m_row = mag + fr * (M + 1);
        const float* re_row = pre + fr * (M + 1);
        const float* im_row = pim + fr * (M + 1);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          ra[u] = __ldg(m_row + t + T * u);
          rb[u] = __ldg(re_row + t + T * u);
        }
#pragma unroll
        for (int u = 0; u < kV; ++u) br[pad(t + T * u)] = (ra[u] * rb[u]) * mk;
#pragma unroll
        for (int u = 0; u < kV; ++u) rb[u] = __ldg(im_row + t + T * u);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const int k = t + T * u;
          bi[pad(k)] = k == 0 ? 0.f : (ra[u] * rb[u]) * mk;
        }
        if (t == 0) br[pad(M)] = (__ldg(m_row + M) * __ldg(re_row + M)) * mk;
      } else if constexpr (SRC == kClosed) {
        // X of bins k (all loads first, as kRows), then each bin's anchor
        // (bins 1..M-1 of the frame's batch row, u0 + bat 2 (M-1): [re |
        // im]; the same table for every frame of the row, so it stays in
        // L1) and its Y.
        const float* row = y + fr * 2 * (M + 1);
        const float* a_row = u0 + (int64_t)bat * 2 * (M - 1);
        float ra[kV], rb[kV];
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          ra[u] = __ldg(row + t + T * u);
          rb[u] = __ldg(row + M + 1 + t + T * u);
        }
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const int k = t + T * u;
          const int a = k > 0 ? k - 1 : 0;  // bin 0 takes no anchor
          const float ar = __ldg(a_row + a), ai = __ldg(a_row + M - 1 + a);
          if (k == 0) {  // DC passes through
            br[pad(0)] = ra[u];
            bi[pad(0)] = 0.f;
          } else {
            float yr, yi;
            closed_bin(ra[u], rb[u], ar, ai, g, yr, yi);
            br[pad(k)] = yr;
            bi[pad(k)] = yi;
          }
        }
        if (t == 0) {  // Nyquist times (-1)^(Rs (goff + i))
          const float sign = ((g.rs & 1) && ((g.goff + i) & 1)) ? -1.f : 1.f;
          br[pad(M)] = __ldg(row + M) * sign;
        }
      } else {
        const float* row = y + fr * 2 * (M + 1);
        float ra[kV], rb[kV];
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          ra[u] = __ldg(row + t + T * u);
          rb[u] = __ldg(row + M + 1 + t + T * u);
        }
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const int k = t + T * u;
          br[pad(k)] = ra[u];
          bi[pad(k)] = k == 0 ? 0.f : rb[u];
        }
        if (t == 0) br[pad(M)] = __ldg(row + M);
      }
      if (t == 0) bi[pad(M)] = 0.f;
    }
    real_fft::group_sync<T>(slot);
    float vr[kV], vi[kV];
#pragma unroll
    for (int kk = 0; kk < kV / R0; ++kk) {
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        const int n = real_fft::source<P, 0>(t, kk, r);
        const float yr = br[pad(n)], yi = bi[pad(n)];
        const float cr = br[pad(M - n)], ci = -bi[pad(M - n)];  // conj Y[M-n]
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
          out2[fr * M + n] = make_float2(vr[kk * RL + r] * scale * w.x,
                                         vi[kk * RL + r] * scale * w.y);
        }
      }
    }
  }
}

// The step term of a general bin with constants h = (hr, hi) and
// c = (cr, ci): c (u conj(u_prev) h)^k.
__device__ __forceinline__ void step_term_hc(float ur, float ui, float pr,
                                             float pi, float hr, float hi,
                                             float cr, float ci, const Geo& g,
                                             float& tr, float& ti) {
  const float dr = ur * pr + ui * pi;
  const float di = ui * pr - ur * pi;
  const float zr = dr * hr - di * hi;
  const float zi = dr * hi + di * hr;
  float wr, wi;
  pow_k(zr, zi, g, wr, wi);
  tr = wr * cr - wi * ci;
  ti = wr * ci + wi * cr;
}

// The step term of general bin b, its constants read from consts.
__device__ __forceinline__ void step_term(float ur, float ui, float pr,
                                          float pi, int b,
                                          const float* __restrict__ consts,
                                          const Geo& g, float& tr,
                                          float& ti) {
  step_term_hc(ur, ui, pr, pi, consts[b], consts[g.nh + b],
               consts[2 * g.nh + b], consts[3 * g.nh + b], g, tr, ti);
}

// Chunks of the prefix product per batch row in the scan buffers.
__device__ __forceinline__ int64_t row_chunks(const Geo& g) {
  return (g.nf + g.chunk - 1) / g.chunk;
}

// P = normalize(c L), c = (cr, ci) the carry of the frame's chunk and L
// the frame's in-chunk product.
__device__ __forceinline__ void apply_carry(float cr, float ci, float lr,
                                            float li, float& pr, float& pi) {
  pr = __fmaf_rn(cr, lr, -__fmul_rn(ci, li));
  pi = __fmaf_rn(cr, li, __fmul_rn(ci, lr));
  normalize(pr, pi);
}

// apply_carry with the carry of frame i's chunk; frame i of batch row bat.
__device__ __forceinline__ void carry_apply(const float* __restrict__ carry,
                                            int bat, int64_t i, int k,
                                            const Geo& g, const Lanes& L,
                                            float lr, float li, float& pr,
                                            float& pi) {
  const int64_t c = ((bat * row_chunks(g) + i / g.chunk) * L.n + k) * 2;
  apply_carry(carry[c], carry[c + 1], lr, li, pr, pi);
}

// Y for the forced-real bins, which bypass the phasor machinery: DC passes
// through, Nyquist passes through times (-1)^(Rs*i) with i the global
// frame index. fr is the frame's row in the buffers. Returns false for a
// general bin.
__device__ __forceinline__ bool write_real_bin(const float* spec, float* y,
                                               int64_t fr, int64_t i, int b,
                                               const Geo& g) {
  if (b != 0 && b != g.nh) return false;
  const int64_t row = fr * 2 * g.nb;
  const float sign =
      (b == g.nh && (g.rs & 1) && ((g.goff + i) & 1)) ? -1.f : 1.f;
  y[row + b] = spec[row + b] * sign;
  y[row + g.nb + b] = 0.f;
  return true;
}

// (b), integer k, where fft_real.cuh does not serve N: Y_i = |X_i| u_0
// (u_i conj u_0)^k into the packed rows y. The anchor u_0 comes from the
// row's frame 0 until the recording has started, then from rows 0-1 of
// the carry (ng = nh-1 general bins per row).
__global__ void phase_closed(const float* __restrict__ spec,
                             const float* __restrict__ carry_in,
                             float* __restrict__ y, Geo g) {
  const int bat = blockIdx.y;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * g.nb) return;
  const int64_t i = idx / g.nb;
  if (i >= row_frames(g, bat)) return;
  const int b = (int)(idx % g.nb);
  const int64_t f0 = bat * g.nf;  // the row's frame 0 in the buffers
  if (write_real_bin(spec, y, f0 + i, i, b, g)) return;
  const int64_t row = (f0 + i) * 2 * g.nb;
  float m0, u0r, u0i;
  if (g.started) {
    u0r = carry_in[b - 1];
    u0i = carry_in[g.nh - 1 + b - 1];
  } else {
    const int64_t row0 = f0 * 2 * g.nb;
    unit_phasor_rn(spec[row0 + b], spec[row0 + g.nb + b], m0, u0r, u0i);
  }
  closed_bin(spec[row + b], spec[row + g.nb + b], u0r, u0i, g, y[row + b],
             y[row + g.nb + b]);
}

// The anchor table of the closed-form load (integer k): row b of anchor,
// (batch, 2, ng) = [re | im], is u_0 of batch row b, the unit phasor of its
// frame 0 until the recording has started, then rows 0-1 of carry_in.
// A stream segment reads carry_phasor's output instead, which holds the
// same anchor.
__global__ void phase_anchor(const float* __restrict__ spec,
                             const float* __restrict__ carry_in,
                             float* __restrict__ anchor, Geo g) {
  const int ng = g.nh - 1;
  const int bat = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ng) return;
  float m, ur, ui;
  if (g.started) {
    ur = carry_in[k];
    ui = carry_in[ng + k];
  } else {
    const int64_t row = (int64_t)bat * g.nf * 2 * g.nb;
    unit_phasor_rn(spec[row + k + 1], spec[row + g.nb + k + 1], m, ur, ui);
  }
  float* out = anchor + (int64_t)bat * 2 * ng;
  out[k] = ur;
  out[ng + k] = ui;
}

// (b), q >= 2, pass 1: step terms into y's general bins. The recording's
// first frame takes u_0; a segment's first frame takes its previous unit
// phasor from rows 0-1 of the carry.
__global__ void phase_terms(const float* __restrict__ spec,
                            const float* __restrict__ consts,
                            const float* __restrict__ carry_in,
                            float* __restrict__ y, Geo g) {
  const int ng = g.nh - 1;
  const int bat = blockIdx.y;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * ng) return;
  const int64_t i = idx / ng;
  if (i >= row_frames(g, bat)) return;
  const int b = 1 + (int)(idx % ng);
  const int64_t row = (bat * g.nf + i) * 2 * g.nb;
  float mag, ur, ui;
  unit_phasor(spec[row + b], spec[row + g.nb + b], mag, ur, ui);
  float tr = ur, ti = ui;
  if (i > 0 || g.started) {
    float mp, pr, pi;
    if (i > 0) {
      const int64_t prev = row - 2 * g.nb;
      unit_phasor(spec[prev + b], spec[prev + g.nb + b], mp, pr, pi);
    } else {
      pr = carry_in[b - 1];
      pi = carry_in[ng + b - 1];
    }
    step_term(ur, ui, pr, pi, b, consts, g, tr, ti);
  }
  y[row + b] = tr;
  y[row + g.nb + b] = ti;
}

// ------------------------------------------- the chunk passes of pvoc_terms
// A block owns a run of consecutive frames of one batch row, over every
// lane (bin): a scan chunk of g.chunk frames where the pass chains along
// it, else a few tiles. Its T threads take lanes k = t + q T (q < R), and
// each walks the run's frames in order. The frames' rows come into shared
// memory a tile of F rows at a time, copied by the whole block with
// coalesced asynchronous copies, double-buffered (tile s+1 copies while
// tile s is used), so that what a block reads and writes is a few tiles of
// contiguous rows. (One thread a (chunk, bin), each reading its own bin
// row by row, scatters a warp's 128-byte accesses over every chunk in
// flight; on an H100 that ran slower than the one-thread-an-element passes
// it was to replace.) No 64-bit division: the run and the batch row come
// from the grid.
struct ChunkPlan {
  int R;  // lanes a thread
  int T;  // threads a block, a multiple of 32
  int F;  // rows a tile
};

// n lanes a row (<= 3072), rows of n_fft / 2 + 1 lanes: a tile of about
// 8192 floats a plane (two tiles of two planes: ~64 KB of shared memory).
ChunkPlan chunk_plan(int n, int n_fft) {
  ChunkPlan p;
  p.R = (n + 1023) / 1024;
  p.T = 32 * ((n + 32 * p.R - 1) / (32 * p.R));
  const int f = 8192 / n_fft;
  p.F = f < 1 ? 1 : (f > 32 ? 32 : f);
  return p;
}

// Shared memory of a chunk pass: two tiles of F rows of two planes of n.
size_t chunk_smem(const ChunkPlan& p, int n) { return sizeof(float) * 4 * p.F * n; }

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most N of the thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// An asynchronous 8-byte copy global -> shared (through L1).
__device__ __forceinline__ void async_copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// The block's copy of `count` floats (even; src and dst 8-byte aligned)
// into shared memory, as one copy group of each thread.
__device__ __forceinline__ void copy_pairs(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count / 2; i += blockDim.x) async_copy8(dst + 2 * i, src + 2 * i);
  async_commit();
}
// The same for any count and alignment, 4 bytes at a time, from two
// places (the two planes) into dst and dst + im_off.
__device__ __forceinline__ void copy_planes(float* dst, int im_off, const float* re,
                                            const float* im, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    real_fft::async_copy4(dst + i, re + i);
    real_fft::async_copy4(dst + im_off + i, im + i);
  }
  async_commit();
}

// pvoc_terms pass 1 (with kScan also scan pass 2, the in-chunk products):
// the lanes are the bins 0..nb-1. A thread keeps each of its bins'
// previous unit phasor in registers (only the run's first frame reads its
// predecessor's row from device memory) and writes, for each frame, |X|
// into mag and u into u (when not null), both (B, nf, nb), and into t
// ((2, B, nf, nb) = [re | im]) either the step terms or, with kScan
// (runs = chunks), their inclusive product inside the chunk, whose last
// value (the chunk's total) goes to tot (B*nch, nb, 2). The terms:
// c (u conj(u_prev) h)^k at the general bins, u conj(u_prev) times
// spin = (-1)^Rs at Nyquist and times 1 at DC, u_0 at the recording's
// first frame. Tiles hold F spectrum rows ([re(nb) | im(nb)], contiguous
// in spec). Each value is the expression the one-thread-an-element terms
// pass evaluated, and the in-chunk product that of scan_chunks.
template <bool kScan, int R>
__global__ void __launch_bounds__(1024)
terms_chunks(const float* __restrict__ spec, const float* __restrict__ consts,
             float* __restrict__ mag, float* __restrict__ t,
             float* __restrict__ u, float* __restrict__ tot, Geo g, int run,
             int F) {
  extern __shared__ float tiles[];
  const int64_t i0 = (int64_t)blockIdx.x * run;
  const int n = (int)(g.nf - i0 < run ? g.nf - i0 : run);  // frames of the run
  const int rs2 = 2 * g.nb;  // floats of a spectrum row
  const int64_t f0 = blockIdx.y * g.nf + i0;  // the run's first frame in the buffers
  const float* sp = spec + f0 * rs2;
  const int ntiles = (n + F - 1) / F;
  copy_pairs(tiles, sp, (n < F ? n : F) * rs2);

  const int64_t plane = g.batch * g.nf * g.nb;
  int b[R];
  bool real_bin[R];
  float spin[R], hr[R], hi[R], cr[R], ci[R], pr[R], pi[R], lr[R], li[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    b[q] = threadIdx.x + q * blockDim.x;
    real_bin[q] = b[q] == 0 || b[q] == g.nh;
    spin[q] = (b[q] == g.nh && (g.rs & 1)) ? -1.f : 1.f;
    hr[q] = hi[q] = cr[q] = ci[q] = 0.f;
    pr[q] = 1.f;
    pi[q] = lr[q] = li[q] = 0.f;
    if (b[q] < g.nb && !real_bin[q]) {
      hr[q] = consts[b[q]];
      hi[q] = consts[g.nh + b[q]];
      cr[q] = consts[2 * g.nh + b[q]];
      ci[q] = consts[3 * g.nh + b[q]];
    }
    if (b[q] < g.nb && i0 > 0) {
      float m;
      unit_phasor(sp[b[q] - rs2], sp[b[q] - g.nb], m, pr[q], pi[q]);
    }
  }
  for (int s = 0; s < ntiles; ++s) {
    const int rows = n - s * F < F ? n - s * F : F;
    if (s + 1 < ntiles) {
      const int next = n - (s + 1) * F < F ? n - (s + 1) * F : F;
      copy_pairs(tiles + ((s + 1) & 1) * F * rs2, sp + (int64_t)(s + 1) * F * rs2, next * rs2);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const float* tile = tiles + (s & 1) * F * rs2;
    for (int r = 0; r < rows; ++r) {
      const int j = s * F + r;  // frame of the run
      const int64_t e = (f0 + j) * g.nb;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (b[q] >= g.nb) continue;
        float m, ur, ui;
        unit_phasor(tile[r * rs2 + b[q]], tile[r * rs2 + g.nb + b[q]], m, ur, ui);
        float tr = ur, ti = ui;
        if (i0 + j > 0) {
          if (real_bin[q]) {
            tr = (ur * pr[q] + ui * pi[q]) * spin[q];
            ti = (ui * pr[q] - ur * pi[q]) * spin[q];
          } else {
            step_term_hc(ur, ui, pr[q], pi[q], hr[q], hi[q], cr[q], ci[q], g, tr, ti);
          }
        }
        pr[q] = ur;
        pi[q] = ui;
        mag[e + b[q]] = m;
        if (u != nullptr) {
          u[e + b[q]] = ur;
          u[plane + e + b[q]] = ui;
        }
        if constexpr (kScan) {
          if (j == 0) {
            lr[q] = tr;
            li[q] = ti;
          } else {
            cmul_scan(lr[q], li[q], tr, ti, lr[q], li[q]);
          }
          tr = lr[q];
          ti = li[q];
        }
        t[e + b[q]] = tr;
        t[plane + e + b[q]] = ti;
      }
    }
    __syncthreads();  // the tile is free for the copy after next
  }
  if constexpr (kScan) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (b[q] >= g.nb) continue;
      const int64_t c = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * g.nb + b[q];
      tot[2 * c] = lr[q];
      tot[2 * c + 1] = li[q];
    }
  }
}

// Scan pass 2: inclusive product of the terms inside each chunk (in
// place), and the chunk's total.
__global__ void scan_chunks(float* __restrict__ y, float* __restrict__ tot,
                            Geo g, Lanes L) {
  const int bat = blockIdx.y;
  const int64_t nch = row_chunks(g);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nch * L.n) return;
  const int64_t c = idx / L.n;
  const int k = (int)(idx % L.n);
  const int b = L.b0 + k;
  const int64_t n_row = row_frames(g, bat);
  const int64_t i0 = c * g.chunk;
  if (i0 >= n_row) return;
  const int64_t i1 = i0 + g.chunk < n_row ? i0 + g.chunk : n_row;
  const int64_t base = bat * g.nf * L.stride + b;
  float lr = 0.f, li = 0.f;
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t re = base + i * L.stride;
    const float tr = y[re], ti = y[re + L.im_off];
    if (i == i0) {
      lr = tr;
      li = ti;
    } else {
      const float t = lr * tr - li * ti;
      li = lr * ti + li * tr;
      lr = t;
    }
    y[re] = lr;
    y[re + L.im_off] = li;
  }
  const int64_t j = ((bat * nch + c) * L.n + k) * 2;
  tot[j] = lr;
  tot[j + 1] = li;
}

// Scan pass 3: per lane, the exclusive product of the chunk totals,
// renormalized at every step (carry[c] = running, then running =
// normalize(running tot[c])), starting from the carried P (rows 2-3 of
// carry_in) or from 1. The running value after the last chunk goes to rows
// 2-3 of carry_out. The chain is serial, so a step's latency is the
// pass's time: a block is one warp of 32 lanes (ceil(n/32) blocks a batch
// row), and each lane copies the totals of the next kStage chunks into
// shared memory asynchronously (a lane's 8-byte (re, im) pair; a warp's
// copies of one chunk are 256 contiguous bytes), one stage ahead of the
// chain, double-buffered, so that no step waits on device memory; the
// chain is unrolled over a stage, so the reads and the stores' addresses
// leave it. Every lane reads only what it copied, so no barrier is
// needed. The chain's roundings (cmul_scan, normalize) and
// order are those of the one-thread-a-bin scan before it, so each carry
// keeps its bits.
constexpr int kStage = 16;

__global__ void __launch_bounds__(32)
scan_carry_staged(const float* __restrict__ tot, float* __restrict__ carry,
                  const float* __restrict__ carry_in,
                  float* __restrict__ carry_out, Geo g, Lanes L) {
  __shared__ float2 buf[2][kStage][32];
  const int lane = threadIdx.x;
  const int k = blockIdx.x * 32 + lane;
  if (k >= L.n) return;
  const int bat = blockIdx.y;
  const int64_t nch = (row_frames(g, bat) + g.chunk - 1) / g.chunk;
  const int64_t c0 = bat * row_chunks(g);
  const float2* src = reinterpret_cast<const float2*>(tot) + c0 * L.n + k;
  float2* dst = reinterpret_cast<float2*>(carry) + c0 * L.n + k;
  float cr = 1.f, ci = 0.f;
  if (carry_in != nullptr) {
    cr = carry_in[2 * L.n + k];
    ci = carry_in[3 * L.n + k];
  }
  const int64_t nst = (nch + kStage - 1) / kStage;
  auto stage = [&](int64_t s) {
    for (int r = 0; r < kStage; ++r) {
      const int64_t c = s * kStage + r;
      if (c < nch) async_copy8(&buf[s & 1][r][lane], src + c * L.n);
    }
    async_commit();
  };
  if (nst > 0) stage(0);
  for (int64_t s = 0; s < nst; ++s) {
    const int m = (int)(nch - s * kStage < kStage ? nch - s * kStage : kStage);
    const float2(&b)[kStage][32] = buf[s & 1];
    // The carry of the stage's first chunk depends on every total read
    // before; once its store has issued, the buffer they came from is free
    // for the next stage's copies.
    dst[s * kStage * L.n] = make_float2(cr, ci);
    if (s + 1 < nst) {
      stage(s + 1);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      if (r < m) {
        if (r > 0) dst[(s * kStage + r) * L.n] = make_float2(cr, ci);
        const float2 tt = b[r][lane];
        cmul_scan(cr, ci, tt.x, tt.y, cr, ci);
        normalize(cr, ci);
      }
    }
  }
  if (carry_out != nullptr) {
    carry_out[2 * L.n + k] = cr;
    carry_out[3 * L.n + k] = ci;
  }
}

// Scan pass 4 of the TSM: P_i = normalize(carry_c L_i), Y = |X| P;
// forced-real bins as usual.
__global__ void phase_apply(const float* __restrict__ spec,
                            const float* __restrict__ carry,
                            float* __restrict__ y, Geo g, Lanes L) {
  const int bat = blockIdx.y;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * g.nb) return;
  const int64_t i = idx / g.nb;
  if (i >= row_frames(g, bat)) return;
  const int b = (int)(idx % g.nb);
  const int64_t fr = bat * g.nf + i;
  if (write_real_bin(spec, y, fr, i, b, g)) return;
  const int64_t row = fr * 2 * g.nb;
  float pr, pi;
  carry_apply(carry, bat, i, b - 1, g, L, y[row + b], y[row + g.nb + b], pr,
              pi);
  float mag, ur, ui;
  unit_phasor(spec[row + b], spec[row + g.nb + b], mag, ur, ui);
  y[row + b] = mag * pr;
  y[row + g.nb + b] = mag * pi;
}

// Scan pass 4 of pvoc_terms: P = normalize(carry_c L) in place, a chunk
// pass over the L.n lanes (runs = chunks): a thread loads its lanes'
// carries once; the in-chunk products L come a tile of F rows of both
// planes at a time.
template <int R>
__global__ void __launch_bounds__(1024)
scan_apply_chunks(const float* __restrict__ carry, float* __restrict__ t,
                  Geo g, Lanes L, int F) {
  extern __shared__ float tiles[];
  const int64_t i0 = (int64_t)blockIdx.x * g.chunk;
  const int n = (int)(g.nf - i0 < g.chunk ? g.nf - i0 : g.chunk);
  float* p = t + (blockIdx.y * g.nf + i0) * L.stride + L.b0;
  const int w = F * (int)L.stride;  // floats of a tile of one plane
  const int ntiles = (n + F - 1) / F;
  copy_planes(tiles, w, p, p + L.im_off, (n < F ? n : F) * (int)L.stride);
  int k[R];
  float cr[R], ci[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    k[q] = threadIdx.x + q * blockDim.x;
    cr[q] = ci[q] = 0.f;
    if (k[q] < L.n) {
      const int64_t c = (((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * L.n + k[q]) * 2;
      cr[q] = carry[c];
      ci[q] = carry[c + 1];
    }
  }
  for (int s = 0; s < ntiles; ++s) {
    const int rows = n - s * F < F ? n - s * F : F;
    if (s + 1 < ntiles) {
      const int next = n - (s + 1) * F < F ? n - (s + 1) * F : F;
      const int64_t o = (int64_t)(s + 1) * w;
      copy_planes(tiles + ((s + 1) & 1) * 2 * w, w, p + o, p + L.im_off + o, next * (int)L.stride);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const float* tile = tiles + (s & 1) * 2 * w;
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (k[q] >= L.n) continue;
        const int o = r * (int)L.stride + k[q];
        float pr, pi;
        apply_carry(cr[q], ci[q], tile[o], tile[w + o], pr, pi);
        const int64_t e = (int64_t)s * w + o;
        p[e] = pr;
        p[e + L.im_off] = pi;
      }
    }
    __syncthreads();
  }
}

// The carried phasor of a segment (rows 0-1 of carry_out): integer k keeps
// the anchor u_0, q >= 2 takes the unit phasor of the segment's last frame.
// Integer k carries rows 2-3 through unchanged.
__global__ void carry_phasor(const float* __restrict__ spec,
                             const float* __restrict__ carry_in,
                             float* __restrict__ carry_out, Geo g) {
  const int ng = g.nh - 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ng) return;
  const int b = k + 1;
  float m, ur, ui;
  if (g.q == 1 && g.started) {
    ur = carry_in[k];
    ui = carry_in[ng + k];
  } else if (g.q == 1) {  // the anchor, as phase_anchor makes it
    unit_phasor_rn(spec[b], spec[g.nb + b], m, ur, ui);
  } else {  // as phase_terms makes the previous frame's
    const int64_t row = (g.nf - 1) * 2 * g.nb;
    unit_phasor(spec[row + b], spec[row + g.nb + b], m, ur, ui);
  }
  carry_out[k] = ur;
  carry_out[ng + k] = ui;
  if (g.q == 1) {
    carry_out[2 * ng + k] = carry_in[2 * ng + k];
    carry_out[3 * ng + k] = carry_in[3 * ng + k];
  }
}

// pvoc_phasor_synth pass 1: the packed spectrum Y = |X| P (times the frame
// mask when there is one) from (B, nf, nb) planes; the imaginary parts of
// DC and Nyquist are zero, as an inverse real DFT drops them.
__global__ void phasor_y(const float* __restrict__ mag,
                         const float* __restrict__ pre,
                         const float* __restrict__ pim,
                         const float* __restrict__ mask,
                         float* __restrict__ y, Geo g) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.nf * g.nb) return;
  const int64_t e = blockIdx.y * g.nf * g.nb + idx;
  const int64_t fr = e / g.nb;
  const int b = (int)(idx % g.nb);
  float yr = mag[e] * pre[e];
  float yi = (b == 0 || b == g.nh) ? 0.f : mag[e] * pim[e];
  if (mask != nullptr) {
    yr = yr * mask[fr];
    yi = yi * mask[fr];
  }
  y[fr * 2 * g.nb + b] = yr;
  y[fr * 2 * g.nb + g.nb + b] = yi;
}

// (d) Gather-form overlap-add with the COLA normalization, over n_out
// samples of local rows 0.. of this launch, per batch row (n_out samples
// apart in out). A row's sum starts from the un-normalized partial sum
// tail_in left for it (rows < m-1; none when tail_in is null), then adds
// this launch's frames oldest first. The first n_main samples are
// normalized into out; the rest are the partial sums for the next launch,
// un-normalized, into tail_out. norm_rows holds 2m-1 rows of Rs inverse
// window energies: head rows 0..m-2, tail rows (output rows
// nf_total..nf_total+m-2), then the interior row, chosen by the global row
// goff + r; rows past the recording's output are written 0. In a ragged
// batch (g.nfs set) each batch row has nf_total = its own frame count and
// norm_rows is a stack of such tables, one for each count 1..m-1 (the
// table of a count >= m-1 is the last).
//
// A group of 2^lg lanes (a warp, or for Rs < 32 W a part of one: the
// fewest lanes that cover Rs / W, so that no lane idles) owns output row r
// (Rs samples, r Rs .. r Rs + Rs - 1, the last row of the output cut at
// n_out) of one batch row, and the groups of a resident grid walk over the
// rows of every batch row: what depends on the row (which frames cover
// it, its normalization row, the ragged table, tail or output) is decided
// once per row and is the same for the whole group. Its lanes walk the
// row's samples, W at a time (W = 4, a float4, when Rs, N, n_out and
// n_main are multiples of 4 and every buffer is 16-byte aligned; else 1):
// sample t of the row takes sample
// d Rs + t of frame r - d, d = m-1 .. 0 (oldest first), all but the oldest
// inside the frame since (m-1) Rs < N. Frames and output are read and
// written in runs of contiguous samples; the lane arithmetic is 32-bit
// with no division. Each output is the same float sum, in the same order,
// as one thread a sample made it (tail_in, then the frames oldest first,
// then times the inverse energy), so the result does not depend on W.
// W consecutive floats: a float4 (16-byte aligned) or one float.
template <int W>
__device__ __forceinline__ void load_w(const float* __restrict__ p, float (&a)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  } else {
    a[0] = __ldg(p);
  }
}
template <int W>
__device__ __forceinline__ void store_w(float* p, const float (&a)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    p[0] = a[0];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
ola_rows(const float* __restrict__ frames, const float* __restrict__ norm_rows,
         const float* __restrict__ tail_in, float* __restrict__ out,
         float* __restrict__ tail_out, int64_t n_out, int64_t n_main, Geo g,
         int m, int lg) {
  const int lanes = 1 << lg;  // a row's lanes, a power of two <= 32
  const int lane = threadIdx.x & (lanes - 1);
  const int per_block = kThreads >> lg;  // rows a block holds at once
  const int rs = g.rs, n_fft = g.n_fft;
  const int64_t rows = (n_out + rs - 1) / rs;  // rows per batch row
  const int64_t total = rows * g.batch;
  for (int64_t w = (int64_t)blockIdx.x * per_block + (threadIdx.x >> lg); w < total;
       w += (int64_t)gridDim.x * per_block) {
    const int bat = (int)(w / rows);
    const int64_t r = w - bat * rows;
    const int64_t n_row = row_frames(g, bat);
    const int64_t n0 = r * rs;  // the row's first sample
    const int len = (int)(n_out - n0 < rs ? n_out - n0 : rs);
    // Frames r - d for d in [d_lo, d_hi] cover the row.
    const int d_hi = (int)(r < m - 1 ? r : m - 1);
    const int d_lo = (int)(r - (n_row - 1) > 0 ? r - (n_row - 1) : 0);
    // Frame r - d at sample d Rs: frame r's start, d (N - Rs) back.
    const float* fr = frames + ((int64_t)bat * g.nf + r) * n_fft;
    const float* tin = tail_in != nullptr && r < m - 1 ? tail_in + n0 : nullptr;
    float* dst;
    const float* nrm = nullptr;  // null: un-normalized, into tail_out
    bool zero = false;
    if (n0 >= n_main) {
      dst = tail_out + (n0 - n_main);
    } else {
      dst = out + bat * n_out + n0;
      int64_t nf_total = g.nf_total;
      const float* norm = norm_rows;
      if (g.nfs != nullptr) {
        nf_total = n_row;
        const int64_t key = n_row < m - 1 ? (n_row > 1 ? n_row : 1) : m - 1;
        norm += (key - 1) * (2 * m - 1) * (int64_t)rs;
      }
      const int64_t gr = g.goff + r;
      int64_t nrow;
      if (gr >= nf_total) {
        nrow = m - 1 + (gr - nf_total);
        zero = nrow > 2 * m - 3;
      } else if (gr < m - 1) {
        nrow = gr;
      } else {
        nrow = 2 * m - 2;
      }
      nrm = norm + nrow * rs;
    }
    for (int t = lane * W; t < len; t += lanes * W) {
      float acc[W], v[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.f;
      if (!zero) {
        if (tin != nullptr) load_w<W>(tin + t, acc);
#pragma unroll 4
        for (int d = d_hi; d >= d_lo; --d) {
          const int off = d * rs + t;
          if (d == m - 1 && off >= n_fft) continue;  // past the oldest frame's end
          load_w<W>(fr - (int64_t)d * n_fft + off, v);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] += v[e];
        }
        if (nrm != nullptr) {
          load_w<W>(nrm + t, v);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = acc[e] * v[e];
        }
      }
      store_w<W>(dst + t, acc);
    }
  }
}

// The gather of n_out samples per batch row, in float4 runs where the
// geometry and the buffers' alignment allow.
cudaError_t launch_ola(const float* frames, const float* norm_rows,
                       const float* tail_in, float* out, float* tail_out,
                       int64_t n_out, int64_t n_main, const Geo& g, int m,
                       cudaStream_t stream) {
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = g.rs % 4 == 0 && g.n_fft % 4 == 0 && n_out % 4 == 0 && n_main % 4 == 0 &&
                   a16(frames) && a16(norm_rows) && a16(tail_in) && a16(out) && a16(tail_out);
  const int w = vec ? 4 : 1;
  int lg = 0;  // lanes a row: the least power of two >= Rs / W, at most 32
  while (lg < 5 && (w << lg) < g.rs) ++lg;
  const int64_t rows = (n_out + g.rs - 1) / g.rs * g.batch;
  const int64_t per_block = kThreads >> lg;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks == 0) return cudaSuccess;
  unsigned grid = 0;
  cudaError_t err = vec ? real_fft::grid_for(ola_rows<4>, 0, blocks, &grid)
                        : real_fft::grid_for(ola_rows<1>, 0, blocks, &grid);
  if (err != cudaSuccess) return err;
  if (vec) {
    ola_rows<4><<<grid, kThreads, 0, stream>>>(frames, norm_rows, tail_in, out, tail_out,
                                               n_out, n_main, g, m, lg);
  } else {
    ola_rows<1><<<grid, kThreads, 0, stream>>>(frames, norm_rows, tail_in, out, tail_out,
                                               n_out, n_main, g, m, lg);
  }
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_analysis_real(const float* x, const float* fft, float* spec,
                                 const Geo& g, cudaStream_t stream) {
  using P = real_fft::Plan<LOG2N>;
  const size_t smem = real_fft::analysis_smem<P>(g.ra);
  unsigned grid = 0;
  const cudaError_t err = real_fft::grid_for(
      analysis_real<LOG2N>, smem, (g.nf + P::F - 1) / P::F * g.batch, &grid);
  if (err != cudaSuccess) return err;
  analysis_real<LOG2N><<<grid, real_fft::kThreads, smem, stream>>>(
      x, fft, fft + P::N, fft + P::N + P::M, spec, g);
  return cudaGetLastError();
}

// The analysis over g.nf frames of each batch row (g.nf > 0):
// analysis_real, for the full and the fold request alike, where
// fft_real.cuh serves N; else one block a frame, in the instantiation of
// its plan's body: fft_analysis_fold when fft_half (the table of the
// N/2-point transform) is given, fft_analysis when not.
cudaError_t launch_analysis(const float* x, const float* fft,
                            const float* fft_half, float* spec, const Geo& g,
                            cudaStream_t stream) {
  switch (real_fft::real_log2(g.n_fft)) {
    case 8: return launch_analysis_real<8>(x, fft, spec, g, stream);
    case 9: return launch_analysis_real<9>(x, fft, spec, g, stream);
    case 10: return launch_analysis_real<10>(x, fft, spec, g, stream);
    case 11: return launch_analysis_real<11>(x, fft, spec, g, stream);
    case 12: return launch_analysis_real<12>(x, fft, spec, g, stream);
    default: break;
  }
  const dim3 grid((unsigned)g.nf, (unsigned)g.batch);
  const float* twc = fft + g.n_fft;
  const float* tws = fft + g.n_fft + g.nh;
  const size_t smem = 2 * g.n_fft * sizeof(float);
  if (fft_half != nullptr) {
    const float* hwc = fft_half + g.nh;
    const float* hws = fft_half + g.nh + g.nh / 2;
    if (g.half.log2n > 0) {
      fft_analysis_fold<true><<<grid, kThreads, smem / 2, stream>>>(
          x, fft, twc, tws, hwc, hws, spec, g);
    } else {
      fft_analysis_fold<false><<<grid, kThreads, smem / 2, stream>>>(
          x, fft, twc, tws, hwc, hws, spec, g);
    }
  } else if (g.fft.log2n > 0) {
    fft_analysis<true><<<grid, kThreads, smem, stream>>>(x, fft, twc, tws,
                                                         spec, g);
  } else {
    fft_analysis<false><<<grid, kThreads, smem, stream>>>(x, fft, twc, tws,
                                                          spec, g);
  }
  return cudaGetLastError();
}

// synth_real's inputs: y and u0 (kRows: y; kClosed: y the spectrum rows,
// u0 the anchor table), or the planes mag, pre, pim and mask (kPlanes).
struct SynthIn {
  const float* y;
  const float* u0;
  const float* mag;
  const float* pre;
  const float* pim;
  const float* mask;
};

template <int LOG2N, int SRC>
cudaError_t launch_synth_real(const SynthIn& in, const float* fft, float* frames,
                              const Geo& g, cudaStream_t stream) {
  using P = real_fft::Plan<LOG2N>;
  const size_t smem = sizeof(float) * (2 * P::M + P::F * 2 * P::FS);
  unsigned grid = 0;
  const cudaError_t err = real_fft::grid_for(
      synth_real<LOG2N, SRC>, smem, (g.nf + P::F - 1) / P::F * g.batch, &grid);
  if (err != cudaSuccess) return err;
  synth_real<LOG2N, SRC><<<grid, real_fft::kThreads, smem, stream>>>(
      in.y, in.u0, in.mag, in.pre, in.pim, in.mask, fft, fft + P::N, fft + P::N + P::M,
      frames, g);
  return cudaGetLastError();
}

template <int SRC>
cudaError_t synthesis_real(int log2n, const SynthIn& in, const float* fft, float* frames,
                           const Geo& g, cudaStream_t stream) {
  switch (log2n) {
    case 8: return launch_synth_real<8, SRC>(in, fft, frames, g, stream);
    case 9: return launch_synth_real<9, SRC>(in, fft, frames, g, stream);
    case 10: return launch_synth_real<10, SRC>(in, fft, frames, g, stream);
    case 11: return launch_synth_real<11, SRC>(in, fft, frames, g, stream);
    default: return launch_synth_real<12, SRC>(in, fft, frames, g, stream);
  }
}

// The synthesis of the packed rows y over g.nf frames of each batch row:
// synth_real where fft_real.cuh serves N, else fft_synthesis (one block a
// frame) in the instantiation of its plan's body.
cudaError_t launch_synthesis(const float* y, const float* fft, float* frames,
                             const Geo& g, cudaStream_t stream) {
  if (const int l = real_fft::real_log2(g.n_fft)) {
    return synthesis_real<kRows>(l, {y, nullptr, nullptr, nullptr, nullptr, nullptr}, fft,
                                 frames, g, stream);
  }
  const dim3 grid((unsigned)g.nf, (unsigned)g.batch);
  const float* twc = fft + g.n_fft;
  const float* tws = fft + g.n_fft + g.nh;
  const size_t smem = 2 * g.n_fft * sizeof(float);
  if (g.fft.log2n > 0) {
    fft_synthesis<true><<<grid, kThreads, smem, stream>>>(y, fft, twc, tws,
                                                          frames, g);
  } else {
    fft_synthesis<false><<<grid, kThreads, smem, stream>>>(y, fft, twc, tws,
                                                           frames, g);
  }
  return cudaGetLastError();
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// A grid of blocks over n items per batch row, one row of blocks per batch
// row.
dim3 grid_for(int64_t n, const Geo& g) {
  return dim3(blocks_for(n, kThreads), (unsigned)g.batch);
}

Geo make_geo(long long nf, int n_fft, int ra, int rs, int p, int q, int alg,
             int chunk, float kf) {
  Geo g;
  g.nf = nf;
  g.goff = 0;
  g.nf_total = nf;
  g.started = 0;
  g.n_fft = n_fft;
  g.fft = make_fft_plan(n_fft);
  g.half = make_fft_plan(n_fft % 4 == 0 ? n_fft / 2 : 1);
  g.nh = n_fft / 2;
  g.nb = g.nh + 1;
  g.ra = ra;
  g.rs = rs;
  g.p = p;
  g.q = q;
  g.alg = alg;
  g.kf = kf;
  g.chunk = chunk;
  g.batch = 1;
  g.x_stride = 0;
  g.nfs = nullptr;
  return g;
}

// The chunk passes of pvoc_terms at the plan's lanes a thread.
template <bool kScan, int R>
cudaError_t launch_terms_r(const ChunkPlan& cp, dim3 grid, size_t smem, cudaStream_t stream,
                           const float* spec, const float* consts, float* mag, float* t,
                           float* u, float* tot, const Geo& g, int run) {
  const cudaError_t err = allow_smem(terms_chunks<kScan, R>, smem);
  if (err != cudaSuccess) return err;
  terms_chunks<kScan, R><<<grid, cp.T, smem, stream>>>(spec, consts, mag, t, u, tot, g, run, cp.F);
  return cudaGetLastError();
}

template <bool kScan>
cudaError_t launch_terms(const ChunkPlan& cp, dim3 grid, size_t smem, cudaStream_t stream,
                         const float* spec, const float* consts, float* mag, float* t, float* u,
                         float* tot, const Geo& g, int run) {
  switch (cp.R) {
    case 1: return launch_terms_r<kScan, 1>(cp, grid, smem, stream, spec, consts, mag, t, u, tot, g, run);
    case 2: return launch_terms_r<kScan, 2>(cp, grid, smem, stream, spec, consts, mag, t, u, tot, g, run);
    default: return launch_terms_r<kScan, 3>(cp, grid, smem, stream, spec, consts, mag, t, u, tot, g, run);
  }
}

template <int R>
cudaError_t launch_apply(const ChunkPlan& cp, dim3 grid, size_t smem, cudaStream_t stream,
                         const float* carry, float* t, const Geo& g, const Lanes& L) {
  const cudaError_t err = allow_smem(scan_apply_chunks<R>, smem);
  if (err != cudaSuccess) return err;
  scan_apply_chunks<R><<<grid, cp.T, smem, stream>>>(carry, t, g, L, cp.F);
  return cudaGetLastError();
}

// Scan pass 3 over the lanes L: one warp a block, ceil(L.n/32) blocks a
// batch row.
cudaError_t launch_scan_carry(const float* tot, float* carry,
                              const float* carry_in, float* carry_out,
                              const Geo& g, const Lanes& L,
                              cudaStream_t stream) {
  const dim3 grid((unsigned)((L.n + 31) / 32), (unsigned)g.batch);
  scan_carry_staged<<<grid, 32, 0, stream>>>(tot, carry, carry_in, carry_out, g, L);
  return cudaGetLastError();
}

// Scan passes 2 and 3 (the in-chunk products, the carry scan) over the
// lanes L of y (q >= 2).
cudaError_t run_scan(float* y, float* tot, float* carry,
                     const float* carry_in, float* carry_out, const Geo& g,
                     const Lanes& L, cudaStream_t stream) {
  const int64_t nch = (g.nf + g.chunk - 1) / g.chunk;
  scan_chunks<<<grid_for(nch * L.n, g), kThreads, 0, stream>>>(y, tot, g, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_scan_carry(tot, carry, carry_in, carry_out, g, L, stream);
}

// True where the integer-k phase runs in synth_real's load (kClosed):
// q = 1 and fft_real.cuh serves N. Then no packed Y is made (y may be
// null) and the anchor table is carry_out's rows 0-1 in a stream segment,
// else `anchor` (batch, 2, ng), made by phase_anchor.
bool closed_in_synth(const Geo& g) {
  return g.q == 1 && real_fft::real_log2(g.n_fft) != 0;
}

// The TSM passes over g.nf frames of each batch row of x (any of them may
// be 0), then the gather of n_out samples per row. carry_in/carry_out/
// tail_in/tail_out are null for whole recordings. With fft_half (the table
// of the N/2-point transform) the analysis is the fold pass.
cudaError_t run_tsm(const float* x, float* out, float* tail_out,
                    float* carry_out, float* spec, float* y, float* anchor,
                    float* frames, float* tot, float* carry, const float* fft,
                    const float* fft_half, const float* consts,
                    const float* norm_rows,
                    const float* carry_in, const float* tail_in,
                    int64_t n_out, int64_t n_main, const Geo& g,
                    cudaStream_t stream) {
  const int m = (g.n_fft + g.rs - 1) / g.rs;
  const int ng = g.nh - 1;
  cudaError_t err;

  if (g.nf > 0) {
    if ((err = launch_analysis(x, fft, fft_half, spec, g, stream)) != cudaSuccess) return err;
    if (carry_out != nullptr) {
      carry_phasor<<<blocks_for(ng, kThreads), kThreads, 0, stream>>>(
          spec, carry_in, carry_out, g);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (closed_in_synth(g)) {
      const float* u0 = carry_out;
      if (u0 == nullptr) {
        if (anchor == nullptr) return cudaErrorInvalidValue;
        phase_anchor<<<grid_for(ng, g), kThreads, 0, stream>>>(spec, carry_in, anchor, g);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        u0 = anchor;
      }
      err = synthesis_real<kClosed>(real_fft::real_log2(g.n_fft),
                                    {spec, u0, nullptr, nullptr, nullptr, nullptr}, fft,
                                    frames, g, stream);
      if (err != cudaSuccess) return err;
    } else {
      if (y == nullptr) return cudaErrorInvalidValue;
      if (g.q == 1) {
        phase_closed<<<grid_for(g.nf * g.nb, g), kThreads, 0, stream>>>(
            spec, carry_in, y, g);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      } else {
        const Lanes L = {2 * g.nb, g.nb, 1, ng};
        phase_terms<<<grid_for(g.nf * ng, g), kThreads, 0, stream>>>(
            spec, consts, carry_in, y, g);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        if ((err = run_scan(y, tot, carry, carry_in, carry_out, g, L,
                            stream)) != cudaSuccess)
          return err;
        phase_apply<<<grid_for(g.nf * g.nb, g), kThreads, 0, stream>>>(
            spec, carry, y, g, L);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
      if ((err = launch_synthesis(y, fft, frames, g, stream)) != cudaSuccess) return err;
    }
  } else if (carry_out != nullptr) {  // a segment past the last frame
    err = cudaMemcpyAsync(carry_out, carry_in, 4 * ng * sizeof(float),
                          cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }

  return launch_ola(frames, norm_rows, tail_in, out, tail_out, n_out, n_main, g, m, stream);
}

}  // namespace

extern "C" const char* pvoc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Buffers (all float32, allocated by the caller):
//   x (>= (nf-1)*ra + n_fft), out ((nf-1)*rs + n_fft),
//   spec (nf, 2*(n_fft/2+1)), frames (nf, n_fft);
//   y (nf, 2*(n_fft/2+1)), the packed Y, except where the phase runs in
//   synth_real's load (q == 1 and fft_real.cuh serves n_fft: null there);
//   anchor (2, n_fft/2-1), the anchor table, there only (else null);
//   tot and carry (ceil(nf/chunk), n_fft/2-1, 2), unused when q == 1;
// tables: fft (2*n_fft) = [Hann window (n_fft) | cos (n_fft/2) |
//   sin (n_fft/2)], consts (4, n_fft/2) = hre, him, cre, cim,
//   norm_rows (2m-1, rs).
extern "C" int pvoc_fused(const float* x, float* out, float* spec, float* y,
                          float* anchor, float* frames, float* tot, float* carry,
                          const float* fft, const float* consts,
                          const float* norm_rows, long long nf, int n_fft,
                          int ra, int rs, int p, int q, int alg, int chunk,
                          float kf, cudaStream_t stream) {
  const Geo g = make_geo(nf, n_fft, ra, rs, p, q, alg, chunk, kf);
  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  return run_tsm(x, out, nullptr, nullptr, spec, y, anchor, frames, tot, carry, fft,
                 nullptr, consts, norm_rows, nullptr, nullptr, out_len,
                 out_len, g, stream);
}

// pvoc_fused with the fold analysis: fft_half (n_fft) = [Hann window
// (n_fft/2, unused) | cos (n_fft/4) | sin (n_fft/4)], the table of the
// n_fft/2-point transform. n_fft a multiple of 4. Where fft_real.cuh
// serves n_fft (a power of two from 256 to 4096), pvoc_fused's analysis
// is this fold already (analysis_real), so the output is pvoc_fused's bit
// for bit and fft_half goes unread.
extern "C" int pvoc_fused_zrev(const float* x, float* out, float* spec,
                               float* y, float* anchor, float* frames, float* tot,
                               float* carry, const float* fft,
                               const float* fft_half, const float* consts,
                               const float* norm_rows, long long nf,
                               int n_fft, int ra, int rs, int p, int q,
                               int alg, int chunk, float kf,
                               cudaStream_t stream) {
  if (n_fft % 4 != 0 || fft_half == nullptr) return cudaErrorInvalidValue;
  const Geo g = make_geo(nf, n_fft, ra, rs, p, q, alg, chunk, kf);
  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  return run_tsm(x, out, nullptr, nullptr, spec, y, anchor, frames, tot, carry, fft,
                 fft_half, consts, norm_rows, nullptr, nullptr, out_len,
                 out_len, g, stream);
}

// The TSM of every row of a (batch, x_stride) signal, row b's first
// nfs[b] frames (0 <= nfs[b] <= nf). out (batch, (nf+m-1)*rs): row b's
// output, normalized at its own frame count, then zeros. Scratch as for
// pvoc_fused with batch*nf frames (anchor (batch, 2, n_fft/2-1)), tot
// and carry (batch*ceil(nf/chunk), n_fft/2-1, 2); norm_stack (m-1, 2m-1, rs) holds
// the normalization rows of the frame counts 1..m-1 (m = ceil(n_fft/rs)).
extern "C" int pvoc_fused_batch(
    const float* x, const int* nfs, float* out, float* spec, float* y,
    float* anchor, float* frames, float* tot, float* carry, const float* fft,
    const float* consts, const float* norm_stack, int batch,
    long long x_stride, long long nf, int n_fft, int ra, int rs, int p,
    int q, int alg, int chunk, float kf, cudaStream_t stream) {
  Geo g = make_geo(nf, n_fft, ra, rs, p, q, alg, chunk, kf);
  g.batch = batch;
  g.x_stride = x_stride;
  g.nfs = nfs;
  const int m = (n_fft + rs - 1) / rs;
  const int64_t out_len = (nf + m - 1) * (int64_t)rs;
  return run_tsm(x, out, nullptr, nullptr, spec, y, anchor, frames, tot, carry, fft,
                 nullptr, consts, norm_stack, nullptr, nullptr, out_len,
                 out_len, g, stream);
}

// One segment of F frames starting at global frame goff, of which
// n_valid (0..F) are frames of the recording (nf_total frames in all).
//   x_seg: the signal from sample goff*ra on (>= (n_valid-1)*ra + n_fft);
//   out (F*rs): the segment's output rows, normalized;
//   carry_in/carry_out (4, n_fft/2-1): rows 0-1 the anchor u_0 (integer
//     k) or the previous frame's unit phasor (q >= 2), rows 2-3 the
//     running phasor P;
//   tail_in/tail_out (m-1, rs): un-normalized partial sums of the first
//     m-1 output rows of this / the next segment;
//   spec, y, frames, tot, carry: scratch for F frames, as for pvoc_fused;
//     anchor may be null (the closed-form load reads carry_out's anchor);
//   started: 0 for the recording's first segment.
// Needs F a multiple of chunk and F >= m-1.
extern "C" int pvoc_fused_segment(
    const float* x_seg, float* out, float* tail_out, float* carry_out,
    float* spec, float* y, float* anchor, float* frames, float* tot, float* carry,
    const float* fft, const float* consts, const float* norm_rows,
    const float* carry_in, const float* tail_in, long long n_valid,
    long long seg_frames, long long goff, long long nf_total, int started,
    int n_fft, int ra, int rs, int p, int q, int alg, int chunk, float kf,
    cudaStream_t stream) {
  Geo g = make_geo(n_valid, n_fft, ra, rs, p, q, alg, chunk, kf);
  g.goff = goff;
  g.nf_total = nf_total;
  g.started = started;
  const int m = (n_fft + rs - 1) / rs;
  const int64_t n_main = seg_frames * (int64_t)rs;
  return run_tsm(x_seg, out, tail_out, carry_out, spec, y, anchor, frames, tot,
                 carry, fft, nullptr, consts, norm_rows, carry_in, tail_in,
                 n_main + (int64_t)(m - 1) * rs, n_main, g, stream);
}

// Phasor terms of nf frames (nf >= 1) of each of the batch rows of x
// (x_stride samples apart): mag (batch, nf, nb), t (2, batch, nf, nb) the
// step terms or, with scan, the scanned phasors P; u (2, batch, nf, nb)
// the unit phasors or null. spec (batch*nf, 2*nb) scratch; tot and carry
// (batch*ceil(nf/chunk), nb, 2) scratch when scan. nb = n_fft/2 + 1.
extern "C" int pvoc_terms(const float* x, float* spec, float* mag, float* t,
                          float* u, float* tot, float* carry,
                          const float* fft, const float* consts, long long nf,
                          int n_fft, int ra, int rs, int p, int q, int alg,
                          int chunk, float kf, int scan, int batch,
                          long long x_stride, cudaStream_t stream) {
  Geo g = make_geo(nf, n_fft, ra, rs, p, q, alg, chunk, kf);
  g.batch = batch;
  g.x_stride = x_stride;
  cudaError_t err;
  if ((err = launch_analysis(x, fft, nullptr, spec, g, stream)) != cudaSuccess) return err;
  const int64_t nch = (nf + chunk - 1) / chunk;
  const ChunkPlan cp = chunk_plan(g.nb, n_fft);
  const size_t smem = chunk_smem(cp, g.nb);
  if (!scan) {
    // Runs of a few tiles: the terms chain along nothing.
    const int run = cp.F < 8 ? 8 : cp.F;
    const dim3 grid((unsigned)((nf + run - 1) / run), (unsigned)batch);
    return launch_terms<false>(cp, grid, smem, stream, spec, consts, mag, t, u, nullptr, g, run);
  }
  const dim3 grid((unsigned)nch, (unsigned)batch);
  if ((err = launch_terms<true>(cp, grid, smem, stream, spec, consts, mag, t, u, tot, g, chunk)) !=
      cudaSuccess)
    return err;
  const Lanes L = {g.nb, (int64_t)batch * nf * g.nb, 0, g.nb};
  if ((err = launch_scan_carry(tot, carry, nullptr, nullptr, g, L, stream)) != cudaSuccess)
    return err;
  switch (cp.R) {
    case 1: return launch_apply<1>(cp, grid, smem, stream, carry, t, g, L);
    case 2: return launch_apply<2>(cp, grid, smem, stream, carry, t, g, L);
    default: return launch_apply<3>(cp, grid, smem, stream, carry, t, g, L);
  }
}

// Synthesis from given phasors, for each of the batch rows: Y = |X| P
// (times mask, (batch, nf), when not null), the windowed inverse FFT into
// frames (batch*nf, n_fft) and the gather overlap-add into out (batch,
// (nf-1)*rs + n_fft) with norm_rows (2m-1, rs): the recording's
// normalization rows, or ones for the un-normalized sum. mag, pre, pim
// (batch, nf, nb). Where fft_real.cuh serves n_fft, synth_real forms Y
// from the planes itself and y may be null; for any other n_fft, y
// (batch*nf, 2*nb) is scratch for phasor_y's packed Y. Needs rs | n_fft.
extern "C" int pvoc_phasor_synth(const float* mag, const float* pre,
                                 const float* pim, const float* mask,
                                 float* y, float* frames, float* out,
                                 const float* fft, const float* norm_rows,
                                 int batch, long long nf, int n_fft, int rs,
                                 cudaStream_t stream) {
  Geo g = make_geo(nf, n_fft, 1, rs, 1, 1, 1, 1, 1.f);
  g.batch = batch;
  const int m = n_fft / rs;
  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  cudaError_t err;
  if (const int l = real_fft::real_log2(n_fft)) {
    err = synthesis_real<kPlanes>(l, {nullptr, nullptr, mag, pre, pim, mask}, fft, frames, g,
                                  stream);
  } else if (y == nullptr) {
    err = cudaErrorInvalidValue;
  } else {
    phasor_y<<<grid_for(nf * g.nb, g), kThreads, 0, stream>>>(mag, pre, pim,
                                                              mask, y, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_synthesis(y, fft, frames, g, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_ola(frames, norm_rows, nullptr, out, nullptr, out_len, out_len, g, m, stream);
}

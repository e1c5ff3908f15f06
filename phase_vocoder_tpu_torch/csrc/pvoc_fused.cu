// pvoc_fused — the phase-vocoder time-scale modification on an H100: the
// whole recording, a batch of recordings, one segment of a stream, the
// phasor terms alone, or the synthesis from given phasors.
//
// Replaces: these kernels of phase_vocoder_tpu/ops/pallas/fused.py,
//   * _pvoc_kernel (the single-recording Pallas kernel) and its tile body
//     _pvoc_tile, as wrapped by fused_time_stretch -> pvoc_fused below.
//     Raw samples in, normalized stretched waveform of length
//     (nf-1)*Rs + N out, for Ra | N and any 0 < Rs <= N/2; N even, up to
//     4096. The passes take any Rs > 0 (m = ceil(N/Rs) segments a frame
//     in the overlap-add); at integer k with Rs > N/2, where the phase
//     runs in synth_real's load (closed_in_synth), the same entry is the
//     general-hop route's TSM (phasor_general_closed), whose prefix
//     product of step terms is the closed form there;
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
//     frame mask) not. The same entry at any Rs > 0, as wrapped by
//     phasor_synth_general, replaces the general-hop route's products,
//     _istft_frames_cart_kernel, fold overlap-add and window norm.
//
// What bounds it here: device memory traffic. The TPU kernel spends its
// time in DFT matrix products on the MXU; here each frame's DFT is an FFT
// in FP32 (~2.5-5 N log2 N FLOP per transform, about a hundredth of a
// matrix DFT), so the passes are bound by the spectra (nf x (N+2) floats,
// and a packed Y besides) that go through device memory between launches,
// and, where fft_real.cuh does not serve N, the windowed frames (nf x N
// floats) besides. At integer k where fft_real.cuh serves N none of them
// does: one pass reads the signal and writes the output, and also does
// both transforms of every frame and the closed form's arithmetic (a
// reciprocal square root and a few complex products a bin).
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
//       At integer k the same per-frame transform and split
//       (transform_frame, split_bin) run inside synth_real instead (b, c),
//       and analysis_real over frame 0 of each batch row alone, for the
//       anchor.
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
//       pass (phase_anchor) makes each batch row's anchor table u_0 from
//       its frame 0 (a stream segment has it in its carry already), and
//       synth_real analyses each frame from the signal and forms
//       Y = |X| P = X (u_i conj u_0)^(k-1) from that X and the table (in registers where a frame's
//       threads fit in a warp, else in the frame's shared buffer), so
//       neither the spectra nor a packed Y goes through device memory.
//       Every other N keeps the elementwise phase_closed.
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
//       Hermitian spectrum, scaled by 1/N and windowed. For a power-of-two
//       N from 256 to 4096 (synth_real) a real frame goes through
//       fft_real.cuh's N/2-point body: the pre-twiddle merge
//       Z[k] = (Y[k] + conj Y[N/2-k]) + i W^-k (Y[k] - conj Y[N/2-k]), the
//       inverse N/2-point Stockham FFT in registers (radix 16/8), and
//       Re z[n], Im z[n] to samples 2n, 2n+1; N/32 threads a frame (a warp
//       at N = 1024), 8192/N frames a 256-thread block, stage twiddles in
//       shared memory, each block of a resident grid on a contiguous run
//       of frame groups of one batch row. synth_real reads Y from the
//       packed rows of the q >= 2 phase passes; at integer k it forms Y
//       from the anchor table (b) and the X it makes itself from a span of
//       the signal, read one group ahead, with (a)'s per-frame transform
//       and split; in pvoc_phasor_synth it forms Y from the magnitude
//       and phasor planes as it loads them. In those two no packed copy of
//       Y, and at integer k no spectrum, goes through device memory.
//       Its frames stay in shared memory for (d). Every other N takes
//       fft_synthesis: one block a frame, a complex N-point FFT in shared
//       memory (fft_common.cuh: radix 2 at N = 128, mixed radix for N not
//       a power of two), after phasor_y packs Y, to (nf, N) frames in
//       device memory;
//   (d) overlap-add, in the order of a gather: each output sample sums the
//       <= m frames covering it in increasing frame order, from the
//       partial sum a stream's previous segment left (or 0), then is
//       multiplied by the inverse window energy of its row (head, interior
//       or tail). Where synth_real runs, it is synth_real's epilogue: a
//       block sums the output rows its group of frames ends from the
//       frames in shared memory and the partial sums of the next m-1 rows
//       it carries from group to group, and at a run's start first
//       transforms the m-1 frames before it, so that no frame reaches
//       device memory and no block waits for another. Only where
//       fft_real.cuh does not serve N (fft_synthesis) does a pass of its
//       own (ola_rows) gather the frames: a warp (or, for short rows, a
//       part of one) owns an output row of Rs samples, frames read and the
//       row written in contiguous float4 runs where Rs allows, a resident
//       grid walking over the rows.
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
// frame); the overlap-add starts each of the first m-1 rows from the
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

// e^{i kf arg z} of unit z. zi == -0 counts as +0, so the branch point
// maps to +pi as the golden model's princarg does.
__device__ __forceinline__ void angle_pow(float zr, float zi, float kf, float& wr,
                                          float& wi) {
  const float ang = atan2f(zi == 0.f ? 0.f : zi, zr) * kf;
  wr = cosf(ang);
  wi = sinf(ang);
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
    angle_pow(zr, zi, g.kf, wr, wi);
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
// of the functions from here to closed_bin is its own IEEE operation
// (__fmul_rn, __fadd_rn: nvcc contracts none of them into an FMA), so
// that every kernel that forms the closed form or its anchor rounds it
// alike. nvcc picks which product of a*b + c*d it fuses by the
// surrounding code, so the same expression inlined into two kernels could
// round two ways.
// This is also the plain version's order (ops/fused.py _unit, _closed_y
// on the CPU, where nothing is fused).
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

// closed_bin past k = 8 (the angle domain): |X| u_0 e^{i k arg(u conj
// u_0)}. Out of line, so that each of synth_real's 17 call sites a thread
// carries the algebraic form alone: inlined, this branch nearly doubled
// synth_real<10, 2>'s code (14,664 against 7,648 instructions) and made
// it 3.5% slower on an H100.
__device__ __noinline__ float2 closed_bin_angle(float re, float im, float u0r, float u0i,
                                                float kf) {
  float mag, ur, ui, wr, wi;
  unit_phasor_rn(re, im, mag, ur, ui);
  angle_pow(mul_add(ur, u0r, ui, u0i), mul_sub(ui, u0r, ur, u0i), kf, wr, wi);
  return make_float2(__fmul_rn(mag, mul_sub(wr, u0r, wi, u0i)),
                     __fmul_rn(mag, mul_add(wr, u0i, wi, u0r)));
}

// Y of general bin X = (re, im) at integer k = p: |X| u_0 (u conj u_0)^p,
// u = X/|X|. Where g.alg, with z = u conj u_0 and |u_0| = 1 that is
// X z^(p-1): u = X r with r one correctly rounded reciprocal square root
// of |X|^2 (u = 1 where |X|^2 <= kTiny), z^(p-1) by int_pow's repeated
// squaring less its first product (1 times a power of z), then one
// complex product; p = 1 keeps X. Else the angle domain on u
// (closed_bin_angle). Every operation is its own IEEE rounding, the plain
// version's order (ops/fused.py _closed_y). phase_closed and synth_real's
// closed-form load both call it, so that the two make the same Y.
__device__ __forceinline__ void closed_bin(float re, float im, float u0r,
                                           float u0i, const Geo& g,
                                           float& yr, float& yi) {
  if (!g.alg) {
    const float2 y = closed_bin_angle(re, im, u0r, u0i, g.kf);
    yr = y.x;
    yi = y.y;
    return;
  }
  if (g.p == 1) {
    yr = re;
    yi = im;
    return;
  }
  const float n2 = mul_add(re, re, im, im);
  float ur = 1.f, ui = 0.f;
  if (n2 > kTiny) {
    const float r = __frsqrt_rn(n2);
    ur = __fmul_rn(re, r);
    ui = __fmul_rn(im, r);
  }
  float br = mul_add(ur, u0r, ui, u0i), bi = mul_sub(ui, u0r, ur, u0i);
  auto square = [&] {
    const float t = mul_sub(br, br, bi, bi);
    bi = __fmul_rn(__fmul_rn(2.f, br), bi);
    br = t;
  };
  int e = g.p - 1;
  for (; !(e & 1); e >>= 1) square();
  float wr = br, wi = bi;
  for (e >>= 1; e > 0; e >>= 1) {
    square();
    if (e & 1) {
      const float t = mul_sub(wr, br, wi, bi);
      wi = mul_add(wr, bi, wi, br);
      wr = t;
    }
  }
  yr = mul_sub(re, wr, im, wi);
  yi = mul_add(re, wi, im, wr);
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
// closed form of phase_closed formed from the anchor table u0 and the
// spectrum X that synth_real makes itself from the signal x (kSignal).
enum SynthSource { kRows, kPlanes, kSignal };

// W consecutive floats: a float4 (16-byte aligned) or one float, read
// through the read-only path (device memory only) or written.
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

// load_w's read from shared memory (store_w writes either).
template <int W>
__device__ __forceinline__ void load_s(const float* p, float (&a)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  } else {
    a[0] = p[0];
  }
}

// Where the overlap-add of a launch goes: n_out samples a batch row of out
// (n_out apart), of which the first n_main are normalized by their rows of
// norm (norm_rows, or in a ragged batch the stack of tables) and the rest
// are the un-normalized partial sums for the next launch, into tail_out;
// output rows < m-1 start from the partial sums tail_in left for them
// (none when tail_in is null).
struct OlaOut {
  float* out;
  float* tail_out;
  const float* tail_in;
  const float* norm;
  int64_t n_out, n_main;
};

// The row of inverse window energies that normalizes global output row gr
// of a recording of nf_total frames: head rows 0..m-2, tail rows m-1..2m-3
// (the output rows nf_total..nf_total+m-2), then the interior row 2m-2;
// -1 past the recording's output, where the row is written 0.
__device__ __forceinline__ int norm_index(int64_t gr, int64_t nf_total, int m) {
  if (gr >= nf_total) {
    const int64_t d = gr - nf_total;
    return d > m - 2 ? -1 : (int)(m - 1 + d);
  }
  return gr < m - 1 ? (int)gr : 2 * m - 2;
}

// A batch row's normalization: its table of 2m-1 rows and the frame count
// that places its head and tail rows. In a ragged batch (g.nfs set) that
// count is the row's own (n_row) and o.norm is a stack of tables, one for
// each count 1..m-1 (the table of a count >= m-1 is the last).
struct RowNorm {
  const float* table;
  int64_t nf_total;
};
__device__ __forceinline__ RowNorm row_norm(const Geo& g, const OlaOut& o, int64_t n_row, int m) {
  if (g.nfs == nullptr) return {o.norm, g.nf_total};
  const int64_t key = n_row < m - 1 ? (n_row > 1 ? n_row : 1) : m - 1;
  return {o.norm + (key - 1) * (2 * m - 1) * (int64_t)g.rs, n_row};
}

// Where output row r (Rs samples from r Rs) of batch row bat goes: dst, its
// first sample in out, or in tail_out at and past n_main; nrm, its row of
// inverse window energies (by the global row goff + r), null for tail_out
// and for a row past the recording's output, which is written 0 (zero).
struct RowDst {
  float* dst;
  const float* nrm;
  bool zero;
};
__device__ __forceinline__ RowDst row_dst(const Geo& g, const OlaOut& o, int bat, int64_t r,
                                          int64_t n_row, int m) {
  const int64_t n0 = r * g.rs;
  if (n0 >= o.n_main) return {o.tail_out + (n0 - o.n_main), nullptr, false};
  const RowNorm rn = row_norm(g, o, n_row, m);
  const int nrow = norm_index(g.goff + r, rn.nf_total, m);
  return {o.out + bat * o.n_out + n0, nrow < 0 ? nullptr : rn.table + nrow * (int64_t)g.rs,
          nrow < 0};
}

// True where the overlap-add can read and write its rows in float4
// pieces: Rs, N, n_out and n_main multiples of 4 and o's buffers 16-byte
// aligned.
inline bool ola_vec(const OlaOut& o, const Geo& g) {
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return g.rs % 4 == 0 && g.n_fft % 4 == 0 && o.n_out % 4 == 0 && o.n_main % 4 == 0 &&
         a16(o.norm) && a16(o.tail_in) && a16(o.out) && a16(o.tail_out);
}

// Frame groups of F frames a batch row in synth_real's overlap-add: group
// j ends the output rows j F .. j F + F - 1, the last group also the rows
// after them, up to the batch row's `rows` (= its frames + m - 1).
__host__ __device__ __forceinline__ int ola_groups(int rows, int m, int F) {
  const int lead = rows - (m - 1);
  return lead > F ? (lead + F - 1) / F : 1;
}

// synth_real's overlap-add of one group (i0 = its first frame, live
// frames in slots k_lo .. k_hi-1 of fbuf, FB floats apart) of batch row
// bat (normalized by rn): rows i0 + e for e_begin <= e < e_all, each the
// carried partial sum cur[e] (e < m-1) or 0, plus the group's frames that
// cover it, oldest first; rows e < e_end end here and go where row_dst
// would send them, the rest are carried into nxt[e - F]. What row_dst
// decides per row is set once for the group, so that a piece of W samples
// costs a few 32-bit operations besides its loads and its store.
template <int W>
__device__ __forceinline__ void ola_epilogue(const float* fbuf, int FB, int F, int n_fft,
                                             const float* cur, float* nxt, int64_t i0,
                                             int k_lo, int k_hi, int e_begin, int e_end,
                                             int e_all, int m, const OlaOut& o, const Geo& g,
                                             int bat, const RowNorm& rn) {
  const int rs = g.rs, pw = rs / W;  // pieces a row
  const int de = real_fft::kThreads / pw, dp = real_fft::kThreads % pw;
  const int64_t n0 = i0 * rs;  // row i0's first sample
  float* out_g = o.out + bat * o.n_out + n0;
  const int64_t tail_g = n0 - o.n_main;
  // Rows e < e_main go to out, the rest to tail_out; a sample e Rs + tt
  // past the batch row's output (lim) is not written.
  const int64_t main_rows = (o.n_main - n0 + rs - 1) / rs;
  const int e_main = main_rows < 0 ? 0 : main_rows > e_all ? e_all : (int)main_rows;
  const int64_t lim = o.n_out - n0;
  const int64_t gr0 = g.goff + i0;  // row i0's global row
  int e = e_begin + (int)threadIdx.x / pw, p = (int)threadIdx.x % pw;
  while (e < e_all) {
    const int tt = p * W, off = e * rs + tt;
    float v[W], f[W];
    if (e < m - 1) {
      load_s<W>(cur + off, v);
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u) v[u] = 0.f;
    }
    const int ka = e - (m - 1) > k_lo ? e - (m - 1) : k_lo;
    const int kb = e < k_hi - 1 ? e : k_hi - 1;
    for (int k = ka; k <= kb; ++k) {  // oldest first
      const int s = (e - k) * rs + tt;
      if (s < n_fft) {  // W | N, so a piece is wholly in the frame or past it
        load_s<W>(fbuf + k * FB + s, f);
#pragma unroll
        for (int u = 0; u < W; ++u) v[u] += f[u];
      }
    }
    if (e >= e_end) {
      store_w<W>(nxt + off - F * rs, v);
    } else if (off < lim) {  // W | n_out
      if (e >= e_main) {
        store_w<W>(o.tail_out + (tail_g + off), v);
      } else {
        const int nrow = norm_index(gr0 + e, rn.nf_total, m);
        if (nrow < 0) {
#pragma unroll
          for (int u = 0; u < W; ++u) v[u] = 0.f;
        } else {
          load_w<W>(rn.table + nrow * rs + tt, f);
#pragma unroll
          for (int u = 0; u < W; ++u) v[u] = v[u] * f[u];
        }
        store_w<W>(out_g + off, v);
      }
    }
    e += de;
    p += dp;
    if (p >= pw) {
      p -= pw;
      ++e;
    }
  }
}

// synth_real's merge: the inverse transform's input Z'[n] = (Y[n] +
// conj Y[M-n]) + i W^-n (Y[n] - conj Y[M-n]) from Y[n] = (yr, yi), Y[M-n]
// = (mr, mi) and W^-n = c + i s.
__device__ __forceinline__ void merge_bin(float yr, float yi, float mr, float mi, float c, float s,
                                          float& zr, float& zi) {
  const float cr = mr, ci = -mi;  // conj Y[M-n]
  const float sr = yr + cr, si = yi + ci;
  const float dr = yr - cr, di = yi - ci;
  zr = sr - (c * di + s * dr);
  zi = si + (c * dr - s * di);
}

// synth_real<kSignal>'s frame where its threads are one warp or a part of
// one (T <= 32, N <= 1024), in registers: from the forward transform's
// Z[t + T v] in vr/vi (transform_frame's order) to the inverse transform's
// input Z'[t + T v] in vr/vi (stage 0's order). The split, Y and the merge
// each pair bin k with bin M - k; for k = t + T u (u < 8), M - k = T (15 -
// u) + (T - t) is value 15 - u of the frame's lane (T - t) mod T (for t = 0
// its own value 16 - u, and Z[M] = Z[0]), so round u takes Z[M - k] from
// that lane and hands it Z'[M - k], a shuffle of each part each way. Thread
// 0 also makes bin M/2, its own mirror (v = 8). The arithmetic is
// analyse_frame's split (split_bin), the closed form (closed_bin with the
// row's anchor a_row; DC passed through, Nyquist times nyq) and the merge
// (merge_bin), value for value, so the frame has the bits that the same
// steps through the frame's buffer give; a dead frame (live false) keeps
// X for Y. Each thread's 32 values never leave its registers: no shared
// memory and no barrier between the two transforms.
template <class P>
__device__ __forceinline__ void closed_frame(float (&vr)[real_fft::kV], float (&vi)[real_fft::kV],
                                             int t, const float* __restrict__ a_row,
                                             const float* __restrict__ twc,
                                             const float* __restrict__ tws, float nyq, bool live,
                                             const Geo& g) {
  using real_fft::kV;
  constexpr int M = P::M, T = P::T;
  static_assert(T <= 32, "a frame in one warp");
  constexpr int RL = 1 << P::lr(P::S - 1), R0 = 1 << P::lr(0);
  constexpr int DL = kV / RL, D0 = kV / R0;
  const int partner = (T - t) & (T - 1);
  float zr[kV], zi[kV];  // Z[t + T v], then Z'[t + T v]
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    zr[v] = vr[(v % DL) * RL + v / DL];
    zi[v] = vi[(v % DL) * RL + v / DL];
  }
  // Y of general bin k from X = (xr, xi).
  auto closed = [&](int k, float xr, float xi, float& yr, float& yi) {
    if (live) {
      closed_bin(xr, xi, __ldg(a_row + k - 1), __ldg(a_row + M - 2 + k), g, yr, yi);
    } else {
      yr = xr;
      yi = xi;
    }
  };
#pragma unroll
  for (int u = 0; u < kV / 2; ++u) {
    const int k = t + T * u, m = M - k;  // t = 0, u = 0: bins 0 and M
    const float pr = __shfl_sync(0xffffffffu, zr[kV - 1 - u], partner, T);
    const float pi = __shfl_sync(0xffffffffu, zi[kV - 1 - u], partner, T);
    const float mr = t == 0 ? zr[(kV - u) % kV] : pr;  // Z[M - k]
    const float mi = t == 0 ? zi[(kV - u) % kV] : pi;
    float xr0, xi0, xr1, xi1, yr0, yi0, yr1, yi1, or1 = 0.f, oi1 = 0.f;
    real_fft::split_bin<real_fft::kPacked>(zr[u], zi[u], mr, -mi, __ldg(twc + k), -__ldg(tws + k),
                                           xr0, xi0);
    if (k == 0) {
      real_fft::split_bin<real_fft::kPacked>(zr[u], zi[u], zr[u], -zi[u], -1.f, 0.f, xr1, xi1);
      yr0 = xr0;  // DC passes through
      yi0 = 0.f;
      yr1 = xr1 * nyq;  // Nyquist times (-1)^(Rs (goff + i))
      yi1 = 0.f;
    } else {
      real_fft::split_bin<real_fft::kPacked>(mr, mi, zr[u], -zi[u], __ldg(twc + m), -__ldg(tws + m),
                                             xr1, xi1);
      closed(k, xr0, xi0, yr0, yi0);
      closed(m, xr1, xi1, yr1, yi1);
      merge_bin(yr1, yi1, yr0, yi0, __ldg(twc + m), __ldg(tws + m), or1, oi1);
    }
    merge_bin(yr0, yi0, yr1, yi1, __ldg(twc + k), __ldg(tws + k), zr[u], zi[u]);
    const float qr = __shfl_sync(0xffffffffu, or1, partner, T);
    const float qi = __shfl_sync(0xffffffffu, oi1, partner, T);
    if (t != 0) {
      zr[kV - 1 - u] = qr;
      zi[kV - 1 - u] = qi;
    } else if (u > 0) {
      zr[kV - u] = or1;
      zi[kV - u] = oi1;
    }
  }
  if (t == 0) {  // bin M/2
    constexpr int k = M / 2;
    float xr, xi, yr, yi;
    real_fft::split_bin<real_fft::kPacked>(zr[kV / 2], zi[kV / 2], zr[kV / 2], -zi[kV / 2],
                                           __ldg(twc + k), -__ldg(tws + k), xr, xi);
    closed(k, xr, xi, yr, yi);
    merge_bin(yr, yi, yr, yi, __ldg(twc + k), __ldg(tws + k), zr[kV / 2], zi[kV / 2]);
  }
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    vr[(v % D0) * R0 + v / D0] = zr[v];
    vi[(v % D0) * R0 + v / D0] = zi[v];
  }
}

// (c) and (d) on fft_real.cuh's body, N = 2^LOG2N from 256 to 4096: each
// frame w * irfft(Y_i) with the imaginary parts of DC and Nyquist
// dropped, through the merge Z[k] = (Y[k] + conj Y[M-k]) + i W^-k (Y[k] -
// conj Y[M-k]), W^-k = twc[k] + i tws[k], the inverse M-point FFT z and
// samples 2n, 2n+1 = (Re z[n], Im z[n]) / N * w; then the overlap-add of
// the frames into the normalized output rows of o. Y comes from SRC
// (SynthSource). With kPlanes and kSignal it is formed in the kernel, so
// that no packed copy of Y goes through device memory. kSignal analyses
// the frame itself (a): the group's span of x, read as analysis_real reads
// it, goes through fft_real.cuh's transform_frame, the split (split_bin),
// phase_closed's arithmetic (closed_bin with the row's anchor, DC passed
// through, Nyquist times (-1)^(Rs (goff + i))) and the merge (merge_bin).
// Where a frame's threads are one warp or part of one (T <= 32, N <= 1024)
// that middle runs in registers, with warp shuffles between the two lanes
// that hold bins k and M - k (closed_frame); at N = 2048 and 4096 the
// packed X goes through the frame's buffer as analysis_real's staged rows
// do (analyse_frame), Y in its place. Either way its X is analysis_real's
// bit for bit, its Y phase_closed's, and no spectrum goes through device
// memory.
//
// A group is F consecutive frames of one batch row (ola_groups a row);
// each block takes a contiguous share of the rows' groups, cut into runs
// at batch rows. A group's frames go from registers into their slots'
// buffers in shared memory; then the whole block makes the output rows
// the group's frames end: for each sample, the partial sum carried in from
// the earlier frames (shared memory, (m-1) Rs floats, from tail_in or 0 at
// a run's start), plus the group's frames oldest first, times the row's
// inverse energy (row_dst), to o; the sums of the m-1 rows after the
// group go on to the next group in the other carry buffer. So each output
// is the float sum ola_rows makes, in its order: tail_in or 0, the frames
// r-m+1 .. r that exist, oldest first (a frame's samples past N not
// added), then times the inverse energy. At a run's start the block first
// transforms the m-1 frames before its first group (their group, with
// the frames before them dead), whose sums it writes nowhere: no block
// hands partial rows to another, so the blocks need no order and no
// atomics. A group with no live frame is not transformed; in a group that
// has one, a dead frame (past the row's frames, or before a run's m-1)
// runs the transform with its group where the group's barriers are a
// warp's (T < 32) and else skips it, and is never added. With kSignal the
// block copies the span of the next group with a live frame (its frames
// from the group's first to its last live one, as analysis_real's spans
// end at a row's last frame) into the other span buffer with asynchronous
// copies while it works on this one, so x is read once a group.
// Shared memory: stage twiddles (2 M), F frame buffers (2 FS each, the
// transform's, then the windowed frame), with kSignal two spans
// (span_floats each), and two carry buffers ((m-1) Rs each).
// Registers: fft_real.cuh's cap of 64 (kMinBlocks blocks an SM), but at
// N = 2048 three blocks an SM (80 registers): under the cap of 64 this
// kernel spilled 44-68 bytes there (nvcc -Xptxas -v) and ran slower on an
// H100. kPlanes takes three at every N: under 64, with the overlap-add's
// state, it spilled 8-24 bytes and its 3.0x / 3600 s call took 0.925 ms
// against 0.885 at three blocks an SM, on an H100. kSignal takes the
// blocks its shared memory holds at hop N/4 and Rs N/2 (synth_smem): 4 at
// N = 256 (54 KB a block: 64 registers, 24 bytes spilled), 3 at 512 and
// 1024 (57, 65 KB: 80 registers, 36 bytes spilled at 512, none at 1024),
// 2 at 2048 and 4096 (79, 107 KB: 113 and 119 registers, none spilled);
// nvcc -Xptxas -v; a 32-byte stack frame at every N, as the closed-form
// load from spectra had. At N = 1024, on the buffer path before the
// register path, one span buffer (54 KB, 4 blocks an SM under 64
// registers, 68 bytes spilled) read 4.5% faster to 3.7% slower than two at
// 3 in three builds on an H100, and two blocks an SM (128 registers) 8%
// slower; the register path was not timed with one.
// The indices of groups and frames are 32-bit, so that the overlap-add's
// state live across the transform stays small; still, kRows at N = 1024
// and 2048 (q >= 2) spills 28-44 bytes. The rows go in float4 pieces where
// ola_vec allows.
template <int LOG2N, int SRC>
__global__ void __launch_bounds__(real_fft::kThreads,
                                  SRC == kSignal ? (LOG2N == 8 ? 4 : LOG2N <= 10 ? 3 : 2)
                                  : LOG2N == 11 || SRC == kPlanes ? 3
                                                                  : real_fft::kMinBlocks)
synth_real(const float* __restrict__ y, const float* __restrict__ x,
           const float* __restrict__ u0, const float* __restrict__ mag,
           const float* __restrict__ pre, const float* __restrict__ pim,
           const float* __restrict__ mask, const float* __restrict__ win,
           const float* __restrict__ twc, const float* __restrict__ tws,
           OlaOut o, Geo g, int vec) {
  using P = real_fft::Plan<LOG2N>;
  using real_fft::kV;
  using real_fft::pad;
  constexpr int N = P::N, M = P::M, T = P::T, F = P::F, FB = 2 * P::FS;
  constexpr int R0 = 1 << P::lr(0), RL = 1 << P::lr(P::S - 1);
  extern __shared__ __align__(16) float sm[];
  float* twr = sm;
  float* twi = sm + M;
  float* fbuf = sm + 2 * M;  // slot k's buffer at fbuf + k FB
  const int slot = threadIdx.x / T, t = threadIdx.x % T;
  float* br = fbuf + slot * FB;
  float* bi = br + P::FS;
  const int rs = g.rs, m = (N + rs - 1) / rs;
  const int cw = (m - 1) * rs;  // floats of the carried partial rows
  // kSignal's two span buffers (16-byte aligned: F FB and span_len are
  // multiples of 4), then the two carry buffers.
  const int span_len = SRC == kSignal ? real_fft::span_floats<P>(g.ra) : 0;
  float* spans = fbuf + F * FB;
  real_fft::build_twiddles<P>(twr, twi, twc, tws);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const float scale = 1.f / N;
  // Group and frame indices are 32-bit (the launcher checks that rows x
  // batch fits), so that little state stays live across the transform.
  const int rows = (int)((o.n_out + rs - 1) / rs);  // output rows a batch row
  const int per_row = ola_groups(rows, m, F);
  const int total = per_row * g.batch;
  const int first = (int)((int64_t)total * blockIdx.x / gridDim.x);
  const int last = (int)((int64_t)total * (blockIdx.x + 1) / gridDim.x);
  // kSignal: the first group from group j of batch row b on, in this
  // block's order (its run of row b from the group j; then each later
  // row's run from its group 0), that has a live frame: its row b, its
  // group j and its live frames' end n_hi. False when none is left. The
  // same for every thread of the block.
  auto seek = [&](int& b, int& j, int& n_hi) -> bool {
    for (; b * per_row < last; ++b, j = 0) {
      const int j0 = first - b * per_row > 0 ? first - b * per_row : 0;
      const int j1 = last - b * per_row < per_row ? last - b * per_row : per_row;
      const int hb = j0 * F - (m - 1) > 0 ? j0 * F - (m - 1) : 0;
      const int n_row = (int)row_frames(g, b);
      if (j < hb / F) j = hb / F;
      if (j < j1 && j * F < n_row && hb < n_row) {
        n_hi = n_row - j * F < F ? n_row - j * F : F;
        return true;
      }
    }
    return false;
  };
  // kSignal: starts the copy of the span of group j of row b (live frames
  // up to n_hi) into sp; returns its offset (load_span).
  auto start_span = [&](int b, int j, int n_hi, float* sp) {
    return real_fft::load_span(sp, x + b * g.x_stride + (int64_t)j * F * g.ra,
                               (n_hi - 1) * g.ra + N);
  };
  // kSignal: the next live group (row sb, group sj, sn live frames) and
  // its span's offset and buffer.
  int sb = first / per_row, sj = 0, sn = 0, s_off = 0, s_cur = 0;
  if constexpr (SRC == kSignal) {
    if (seek(sb, sj, sn)) s_off = start_span(sb, sj, sn, spans);
  }
  for (int run = first; run < last;) {
    const int bat = run / per_row;
    const int j0 = run - bat * per_row;  // the run's groups j0 .. j1-1
    const int j1 = last - bat * per_row < per_row ? last - bat * per_row : per_row;
    run = bat * per_row + j1;
    const int n_row = (int)row_frames(g, bat);
    const int hb = j0 * F - (m - 1) > 0 ? j0 * F - (m - 1) : 0;  // its first frame
    float* cur = spans + 2 * span_len;  // partial sums of rows j F .. j F + m - 2
    float* nxt = cur + cw;
    __syncthreads();  // the last run's reads of the carry done
    for (int c = threadIdx.x; c < cw; c += real_fft::kThreads) {
      const int r = hb / F * F + c / rs;
      cur[c] = o.tail_in != nullptr && r < m - 1 ? o.tail_in[r * rs + c % rs] : 0.f;
    }
    for (int j = hb / F; j < j1; ++j) {
      const int i0 = j * F;
      // The group's live frames are slots k_lo .. k_hi-1.
      const int k_lo = (hb > i0 ? hb : i0) - i0;
      const int hi = (n_row < i0 + F ? n_row : i0 + F) - i0;
      const int k_hi = hi > k_lo ? hi : k_lo;
      const bool live = slot >= k_lo && slot < k_hi;
      const int64_t fr = bat * g.nf + i0 + slot;  // the frame's row in the buffers
      // kSignal: this group's span is in (it is the one seek found last).
      const float* xf = nullptr;
      if constexpr (SRC == kSignal) {
        if (k_lo < k_hi) real_fft::async_wait_all();
      }
      __syncthreads();  // the last group's reads of the frame buffers and spans done
      if constexpr (SRC == kSignal) {
        if (k_lo < k_hi) {
          xf = spans + s_cur * span_len + s_off + slot * g.ra;  // past k_hi: stale
          ++sj;
          if (seek(sb, sj, sn)) s_off = start_span(sb, sj, sn, spans + (s_cur ^ 1) * span_len);
          s_cur ^= 1;
        }
      }
      if (k_lo < k_hi && (live || T < 32)) {
        const int i = i0 + slot;
        // kSignal: the row's anchor table (bins 1..M-1, u0 + bat 2 (M-1):
        // [re | im]; the same for every frame of the row, so it stays in
        // L1) and the Nyquist bin's sign (-1)^(Rs (goff + i)).
        const float* a_row = u0 + (int64_t)bat * 2 * (M - 1);
        const float nyq = (g.rs & 1) && ((g.goff + i) & 1) ? -1.f : 1.f;
        float vr[kV], vi[kV];
        if constexpr (SRC == kSignal && T <= 32) {
          real_fft::transform_frame<P>(xf, win2, br, bi, twr, twi, t, slot, vr, vi);
          closed_frame<P>(vr, vi, t, a_row, twc, tws, nyq, live, g);
        } else {
          if constexpr (SRC == kSignal) {
            // X through the frame's buffer: the bins each thread emitted,
            // X -> Y in place (k = t + T u, u < 8, and its mirror, M for
            // k = 0; then M/2, thread 0).
            real_fft::analyse_frame<P, real_fft::kPacked>(
                xf, win2, br, bi, twr, twi, twc, tws, t, slot, [&](int k, float a, float c) {
                  br[pad(k)] = a;
                  bi[pad(k)] = c;
                });
            if (live) {
              auto closed = [&](int k) {
                float yr, yi;
                closed_bin(br[pad(k)], bi[pad(k)], __ldg(a_row + k - 1), __ldg(a_row + M - 2 + k),
                           g, yr, yi);
                br[pad(k)] = yr;
                bi[pad(k)] = yi;
              };
#pragma unroll
              for (int u = 0; u < kV / 2; ++u) {
                const int k = t + T * u;
                if (k == 0) {  // DC passes through, Nyquist times nyq
                  bi[pad(0)] = 0.f;
                  br[pad(M)] = br[pad(M)] * nyq;
                } else {
                  closed(k);
                  closed(M - k);
                }
              }
              if (t == 0) closed(M / 2);
            }
          } else if (live) {
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
          }
          if (live && t == 0) bi[pad(M)] = 0.f;
          real_fft::group_sync<T>(slot);
#pragma unroll
          for (int kk = 0; kk < kV / R0; ++kk) {
#pragma unroll
            for (int r = 0; r < R0; ++r) {
              const int n = real_fft::source<P, 0>(t, kk, r);
              merge_bin(br[pad(n)], bi[pad(n)], br[pad(M - n)], bi[pad(M - n)], __ldg(twc + n),
                        __ldg(tws + n), vr[kk * R0 + r], vi[kk * R0 + r]);
            }
          }
        }
        real_fft::fft<P, false>(vr, vi, br, bi, twr, twi, t, slot);
        real_fft::group_sync<T>(slot);  // the transform's reads of br, bi done
        if (live) {
          float2* f2 = reinterpret_cast<float2*>(br);
#pragma unroll
          for (int kk = 0; kk < kV / RL; ++kk) {
#pragma unroll
            for (int r = 0; r < RL; ++r) {
              const int n = real_fft::dest<P, P::S - 1>(t, kk, r);
              const float2 w = __ldg(win2 + n);
              f2[n] = make_float2(vr[kk * RL + r] * scale * w.x, vi[kk * RL + r] * scale * w.y);
            }
          }
        }
      }
      __syncthreads();  // the group's frames and the carry in
      // Rows i0 + e: ended for e < e_end, and written where the run owns
      // them (j >= j0; a halo group makes only the carry), carried into
      // nxt for e_end <= e < e_all.
      const bool tail_rows = j == per_row - 1;
      const int e_all = tail_rows ? rows - i0 : F + m - 1;
      const int e_end = tail_rows ? e_all : F;
      const int e_begin = j >= j0 ? 0 : e_end;
      if (vec) {
        ola_epilogue<4>(fbuf, FB, F, N, cur, nxt, i0, k_lo, k_hi, e_begin, e_end, e_all, m, o, g,
                        bat, row_norm(g, o, n_row, m));
      } else {
        ola_epilogue<1>(fbuf, FB, F, N, cur, nxt, i0, k_lo, k_hi, e_begin, e_end, e_all, m, o, g,
                        bat, row_norm(g, o, n_row, m));
      }
      float* swap = cur;
      cur = nxt;
      nxt = swap;
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
// frame 0 (spec's row b: run_tsm analyses frame 0 of each row alone) until
// the recording has started, then rows 0-1 of carry_in. A stream segment
// reads carry_phasor's output instead, which holds the same anchor.
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
    const int64_t row = (int64_t)bat * 2 * g.nb;
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

// (d) where fft_real.cuh does not serve N (fft_synthesis' frames):
// gather-form overlap-add with the COLA normalization, over o.n_out
// samples of local rows 0.. of this launch, per batch row. A row's sum
// starts from the un-normalized partial sum o.tail_in left for it (rows <
// m-1), then adds this launch's frames oldest first, then goes where
// row_dst says (normalized into out, un-normalized into tail_out, or 0).
// synth_real's overlap-add makes every sum in this order too.
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
template <int W>
__global__ void __launch_bounds__(kThreads)
ola_rows(const float* __restrict__ frames, OlaOut o, Geo g, int m, int lg) {
  const int lanes = 1 << lg;  // a row's lanes, a power of two <= 32
  const int lane = threadIdx.x & (lanes - 1);
  const int per_block = kThreads >> lg;  // rows a block holds at once
  const int rs = g.rs, n_fft = g.n_fft;
  const int64_t rows = (o.n_out + rs - 1) / rs;  // rows per batch row
  const int64_t total = rows * g.batch;
  for (int64_t w = (int64_t)blockIdx.x * per_block + (threadIdx.x >> lg); w < total;
       w += (int64_t)gridDim.x * per_block) {
    const int bat = (int)(w / rows);
    const int64_t r = w - bat * rows;
    const int64_t n_row = row_frames(g, bat);
    const int64_t n0 = r * rs;  // the row's first sample
    const int len = (int)(o.n_out - n0 < rs ? o.n_out - n0 : rs);
    // Frames r - d for d in [d_lo, d_hi] cover the row.
    const int d_hi = (int)(r < m - 1 ? r : m - 1);
    const int d_lo = (int)(r - (n_row - 1) > 0 ? r - (n_row - 1) : 0);
    // Frame r - d at sample d Rs: frame r's start, d (N - Rs) back.
    const float* fr = frames + ((int64_t)bat * g.nf + r) * n_fft;
    const float* tin = o.tail_in != nullptr && r < m - 1 ? o.tail_in + n0 : nullptr;
    const RowDst d = row_dst(g, o, bat, r, n_row, m);
    for (int t = lane * W; t < len; t += lanes * W) {
      float acc[W], v[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.f;
      if (!d.zero) {
        if (tin != nullptr) load_w<W>(tin + t, acc);
#pragma unroll 4
        for (int k = d_hi; k >= d_lo; --k) {
          const int off = k * rs + t;
          if (k == m - 1 && off >= n_fft) continue;  // past the oldest frame's end
          load_w<W>(fr - (int64_t)k * n_fft + off, v);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] += v[e];
        }
        if (d.nrm != nullptr) {
          load_w<W>(d.nrm + t, v);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = acc[e] * v[e];
        }
      }
      store_w<W>(d.dst + t, acc);
    }
  }
}

// The gather of o.n_out samples per batch row, in float4 runs where the
// geometry and the buffers' alignment allow.
cudaError_t launch_ola(const float* frames, const OlaOut& o, const Geo& g, int m,
                       cudaStream_t stream) {
  const bool vec = ola_vec(o, g) && (reinterpret_cast<uintptr_t>(frames) & 15) == 0;
  const int w = vec ? 4 : 1;
  int lg = 0;  // lanes a row: the least power of two >= Rs / W, at most 32
  while (lg < 5 && (w << lg) < g.rs) ++lg;
  const int64_t rows = (o.n_out + g.rs - 1) / g.rs * g.batch;
  const int64_t per_block = kThreads >> lg;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks == 0) return cudaSuccess;
  unsigned grid = 0;
  cudaError_t err = vec ? real_fft::grid_for(ola_rows<4>, 0, blocks, &grid)
                        : real_fft::grid_for(ola_rows<1>, 0, blocks, &grid);
  if (err != cudaSuccess) return err;
  if (vec) {
    ola_rows<4><<<grid, kThreads, 0, stream>>>(frames, o, g, m, lg);
  } else {
    ola_rows<1><<<grid, kThreads, 0, stream>>>(frames, o, g, m, lg);
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

// synth_real's inputs: y (kRows), the signal x and the anchor table u0
// (kSignal), or the planes mag, pre, pim and mask (kPlanes).
struct SynthIn {
  const float* y;
  const float* x;
  const float* u0;
  const float* mag;
  const float* pre;
  const float* pim;
  const float* mask;
};

// synth_real's shared memory, in bytes: stage twiddles, F frame buffers,
// kSignal's two spans of x at hop ra, two carries of (m-1) rs floats.
template <class P, int SRC>
size_t synth_smem(int ra, int rs) {
  const int m = (P::N + rs - 1) / rs;
  const size_t spans = SRC == kSignal ? 2 * (size_t)real_fft::span_floats<P>(ra) : 0;
  return sizeof(float) * (2 * P::M + P::F * 2 * P::FS + spans + 2 * (size_t)(m - 1) * rs);
}

template <int LOG2N, int SRC>
cudaError_t launch_synth_real(const SynthIn& in, const float* fft, const OlaOut& o,
                              const Geo& g, cudaStream_t stream) {
  using P = real_fft::Plan<LOG2N>;
  const int m = (P::N + g.rs - 1) / g.rs;
  const size_t smem = synth_smem<P, SRC>(g.ra, g.rs);
  const int64_t rows = (o.n_out + g.rs - 1) / g.rs;
  if (rows * g.batch > INT32_MAX) return cudaErrorInvalidValue;  // 32-bit group indices
  const int64_t groups = (int64_t)ola_groups((int)rows, m, P::F) * g.batch;
  unsigned grid = 0;
  const cudaError_t err = real_fft::grid_for(synth_real<LOG2N, SRC>, smem, groups, &grid);
  if (err != cudaSuccess) return err;
  synth_real<LOG2N, SRC><<<grid, real_fft::kThreads, smem, stream>>>(
      in.y, in.x, in.u0, in.mag, in.pre, in.pim, in.mask, fft, fft + P::N, fft + P::N + P::M, o,
      g, (int)ola_vec(o, g));
  return cudaGetLastError();
}

// The synthesis and overlap-add of g.nf frames of each batch row (any of
// them may be 0) on fft_real.cuh's body, N = 2^log2n.
template <int SRC>
cudaError_t synthesis_real(int log2n, const SynthIn& in, const float* fft, const OlaOut& o,
                           const Geo& g, cudaStream_t stream) {
  switch (log2n) {
    case 8: return launch_synth_real<8, SRC>(in, fft, o, g, stream);
    case 9: return launch_synth_real<9, SRC>(in, fft, o, g, stream);
    case 10: return launch_synth_real<10, SRC>(in, fft, o, g, stream);
    case 11: return launch_synth_real<11, SRC>(in, fft, o, g, stream);
    default: return launch_synth_real<12, SRC>(in, fft, o, g, stream);
  }
}

// Where fft_real.cuh does not serve N: fft_synthesis (one block a frame,
// in the instantiation of its plan's body) of the packed rows y into
// frames, over g.nf > 0 frames of each batch row.
cudaError_t launch_fft_synthesis(const float* y, const float* fft, float* frames,
                                 const Geo& g, cudaStream_t stream) {
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

// True where the integer-k phase runs in synth_real's load (kSignal):
// q = 1 and fft_real.cuh serves N. Then synth_real analyses its frames
// itself, spec holds frame 0 of each batch row alone (the anchor's
// source), no packed Y is made (y may be null), and the anchor table is
// carry_out's rows 0-1 in a stream segment, else `anchor` (batch, 2, ng),
// made by phase_anchor.
bool closed_in_synth(const Geo& g) {
  return g.q == 1 && real_fft::real_log2(g.n_fft) != 0;
}

// The TSM passes over g.nf frames of each batch row of x (any of them may
// be 0), then the overlap-add of n_out samples per row. carry_in/
// carry_out/tail_in/tail_out are null for whole recordings. With fft_half
// (the table of the N/2-point transform) the analysis is the fold pass.
// Where the phase runs in synth_real's load (closed_in_synth), the
// analysis covers frame 0 of each row alone, into spec's row per batch
// row (none once a stream has started: its carry holds the anchor), for
// phase_anchor or carry_phasor; synth_real<kSignal> analyses every frame
// again from x. Where fft_real.cuh serves N, synth_real makes the output
// rows itself (frames may be null; it runs even with no frame, for a
// segment past the recording's end); elsewhere fft_synthesis writes frames
// and ola_rows gathers them.
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
  const int log2n = real_fft::real_log2(g.n_fft);
  const bool closed = closed_in_synth(g);
  // The anchor table of the closed form: the segment's carry, else made
  // by phase_anchor.
  const float* u0 = carry_out != nullptr ? carry_out : anchor;
  cudaError_t err;

  if (g.nf > 0) {
    // Frame 0 of each row where the load forms the phase, else every frame.
    Geo ga = g;
    if (closed) {
      ga.nf = 1;
      ga.nfs = nullptr;
    }
    if (!(closed && g.started) &&
        (err = launch_analysis(x, fft, fft_half, spec, ga, stream)) != cudaSuccess)
      return err;
    if (carry_out != nullptr) {
      carry_phasor<<<blocks_for(ng, kThreads), kThreads, 0, stream>>>(
          spec, carry_in, carry_out, g);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (closed) {
      if (carry_out == nullptr) {
        if (anchor == nullptr) return cudaErrorInvalidValue;
        phase_anchor<<<grid_for(ng, g), kThreads, 0, stream>>>(spec, carry_in, anchor, g);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
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
    }
  } else if (carry_out != nullptr) {  // a segment past the last frame
    err = cudaMemcpyAsync(carry_out, carry_in, 4 * ng * sizeof(float),
                          cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }

  const OlaOut o = {out, tail_out, tail_in, norm_rows, n_out, n_main};
  if (log2n != 0) {
    return closed ? synthesis_real<kSignal>(
                        log2n, {nullptr, x, u0, nullptr, nullptr, nullptr, nullptr}, fft, o, g,
                        stream)
                  : synthesis_real<kRows>(
                        log2n, {y, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr}, fft, o,
                        g, stream);
  }
  if (frames == nullptr) return cudaErrorInvalidValue;
  if (g.nf > 0 && (err = launch_fft_synthesis(y, fft, frames, g, stream)) != cudaSuccess) {
    return err;
  }
  return launch_ola(frames, o, g, m, stream);
}

}  // namespace

extern "C" const char* pvoc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Buffers (all float32, allocated by the caller):
//   x (>= (nf-1)*ra + n_fft), out ((nf-1)*rs + n_fft),
//   spec (nf, 2*(n_fft/2+1)), except where the phase runs in synth_real's
//   load (q == 1 and fft_real.cuh serves n_fft: there (1, 2*(n_fft/2+1)),
//   frame 0's spectrum alone, since synth_real analyses its frames itself);
//   frames (nf, n_fft) where fft_real.cuh does not serve n_fft (else null:
//   synth_real overlap-adds its frames in shared memory);
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
// pvoc_fused with batch*nf frames (spec (batch, 2*(n_fft/2+1)) and anchor
// (batch, 2, n_fft/2-1) where the phase runs in synth_real's load), tot
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
//   spec, y, frames, tot, carry: scratch for F frames, as for pvoc_fused
//     (spec one row where the phase runs in synth_real's load); anchor may
//     be null (the closed-form load reads carry_out's anchor);
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
// (times mask, (batch, nf), when not null), the windowed inverse FFT and
// the gather overlap-add into out (batch, (nf-1)*rs + n_fft) with
// norm_rows (2m-1, rs): the recording's normalization rows, or ones for
// the un-normalized sum. mag, pre, pim (batch, nf, nb). Where fft_real.cuh
// serves n_fft, synth_real forms Y from the planes itself and sums its own
// frames into out, in one launch; y and frames may be null. For any other
// n_fft, y (batch*nf, 2*nb) is scratch for phasor_y's packed Y and frames
// (batch*nf, n_fft) for fft_synthesis' frames, which ola_rows gathers. Any
// rs > 0: the overlap-add sums m = ceil(n_fft/rs) segments a frame
// (norm_rows has 2m-1 rows), as pvoc_fused's does; m = n_fft/rs where rs |
// n_fft.
extern "C" int pvoc_phasor_synth(const float* mag, const float* pre,
                                 const float* pim, const float* mask,
                                 float* y, float* frames, float* out,
                                 const float* fft, const float* norm_rows,
                                 int batch, long long nf, int n_fft, int rs,
                                 cudaStream_t stream) {
  Geo g = make_geo(nf, n_fft, 1, rs, 1, 1, 1, 1, 1.f);
  g.batch = batch;
  const int m = (n_fft + rs - 1) / rs;
  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  const OlaOut o = {out, nullptr, nullptr, norm_rows, out_len, out_len};
  if (const int l = real_fft::real_log2(n_fft)) {
    return synthesis_real<kPlanes>(l, {nullptr, nullptr, nullptr, mag, pre, pim, mask}, fft, o, g,
                                    stream);
  }
  if (y == nullptr || frames == nullptr) return cudaErrorInvalidValue;
  phasor_y<<<grid_for(nf * g.nb, g), kThreads, 0, stream>>>(mag, pre, pim, mask, y, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = launch_fft_synthesis(y, fft, frames, g, stream)) != cudaSuccess) return err;
  return launch_ola(frames, o, g, m, stream);
}

// ------------------------------------------------------ test entries
// No wrapper of the package calls these: the card tests do
// (tests/test_torch_closed_rsqrt.py).

namespace {

// Mismatches of __frsqrt_rn(x) against 1 / sqrt(x) in float64 (each step
// an IEEE operation) rounded to float32, over the float32 bit patterns
// lo .. lo + n - 1; the first 16 mismatching patterns into `first`.
__global__ void rsqrt_sweep(uint32_t lo, uint32_t n, unsigned long long* count,
                            uint32_t* first) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t bits = lo + (uint32_t)i;
    const float x = __uint_as_float(bits);
    const float want = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn((double)x)));
    if (__float_as_uint(__frsqrt_rn(x)) != __float_as_uint(want)) {
      const unsigned long long c = atomicAdd(count, 1ull);
      if (c < 16) first[c] = bits;
    }
  }
}

}  // namespace

// rsqrt_sweep over bit patterns lo .. lo + n - 1; count (1) and first
// (16) on the device, count zeroed by the caller.
extern "C" int pvoc_test_rsqrt_sweep(unsigned lo, unsigned n, unsigned long long* count,
                                     unsigned* first, cudaStream_t stream) {
  rsqrt_sweep<<<132 * 16, kThreads, 0, stream>>>(lo, n, count, first);
  return cudaGetLastError();
}

// pvoc_fused at q = 1 where fft_real.cuh serves n_fft, with the phase in
// its own pass: analysis_real over every frame into spec (nf, 2*nb),
// phase_closed into the packed Y y (nf, 2*nb), then synth_real from those
// rows (kRows). pvoc_fused forms the same Y in synth_real's load, so the
// two outputs agree bit for bit.
extern "C" int pvoc_test_closed_rows(const float* x, float* out, float* spec, float* y,
                                     const float* fft, const float* norm_rows, long long nf,
                                     int n_fft, int ra, int rs, int p, int alg, float kf,
                                     cudaStream_t stream) {
  const int log2n = real_fft::real_log2(n_fft);
  if (log2n == 0 || nf <= 0) return cudaErrorInvalidValue;
  const Geo g = make_geo(nf, n_fft, ra, rs, p, 1, alg, 1, kf);
  cudaError_t err = launch_analysis(x, fft, nullptr, spec, g, stream);
  if (err != cudaSuccess) return err;
  phase_closed<<<grid_for(g.nf * g.nb, g), kThreads, 0, stream>>>(spec, nullptr, y, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t out_len = (nf - 1) * (int64_t)rs + n_fft;
  const OlaOut o = {out, nullptr, nullptr, norm_rows, out_len, out_len};
  return synthesis_real<kRows>(log2n, {y, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr},
                               fft, o, g, stream);
}

// fft_real.cuh — the transform body of every kernel of stft.cu and
// pvoc_fused.cu for a power-of-two N from 256 to 4096: a real N-point
// frame through an M = N/2-point complex FFT, a fixed group of threads per
// frame, several frames per block. Besides the transform it holds the
// whole analysis: a frame's (analyse_frame: Hann window, real-input FFT,
// split), which pvoc_fused.cu's synth_real runs on its own frames at
// integer k, and a kernel's (analysis_groups: framing and the groups of
// frames over the grid), which stft.cu's stft_real_kernel and
// pvoc_fused.cu's analysis_real run with different output forms.
//
// The transform. A frame of T = M/16 threads; each thread holds 16
// complex values in registers. The M-point FFT is a Stockham (autosort)
// decimation in time of 2 or 3 stages of radix 16 or 8 (M = 128: 16·8,
// 256: 16·16, 512: 8·8·8, 1024: 16·8·8, 2048: 16·16·8). A stage of
// radix R with Ns the product of the radices before it, for butterfly j
// (thread t holds j = t + T·kk, kk < 16/R):
//   v[r] = in[j + r M/R] · W_M^(r (j mod Ns) M/(Ns R))     r < R
//   v    = the R-point DFT of v, in registers (radix-2 steps on constants)
//   out[(j - j mod Ns) R + j mod Ns + r Ns] = v[r]
// Input and output are in natural order, so there is no bit reversal.
// Between two stages the values cross threads through a per-frame
// buffer in shared memory (two float arrays, index i stored at
// i + i/32, which keeps every stage's accesses at most 2-way
// bank-conflicted but one 4-way write at M = 512), in place: the frame's
// threads synchronise, write, synchronise, read. That barrier is the
// frame's own: __syncwarp when the frame is at most one warp (N <= 1024),
// a named barrier of T threads (bar.sync 1 + slot, T) at N = 2048, 4096.
//
// Twiddles: the stage twiddles are gathered once per block from the
// host-made float32 table of cos and sin of 2 pi k / N (k < N/2, built
// in float64; W_M^e is its entry 2e, negated past the half circle) into
// shared memory, laid out per stage as [(r - 1) Ns + (j mod Ns)] so that
// neighbouring threads read neighbouring words. The R-point DFTs use
// the float32 roundings of cos and sin of multiples of pi/8, with 0 and
// +-1 exact (the table's cos(pi/2) is 6.1e-17, far below a rounding).
// FP32 FMA throughout; no tensor cores, no fast math.
//
// The analysis. A real frame g = x w is packed as z[n] = g[2n] + i g[2n+1]
// (the window read as float2), transformed, and split: with Z = FFT_M(z),
// X[k] = (Z[k] + conj Z[M-k])/2 - i W^k (Z[k] - conj Z[M-k])/2,
// W = e^(-2 pi i / N), Z[M] = Z[0]; one thread makes bins k and M - k
// from the same two loads. DC and Nyquist come out with zero imaginary
// parts. This is also the fold analysis of the TPU package's
// _pvoc_kernel_z: one body serves both. A block transforms a group of F
// consecutive frames of one batch row, read from one contiguous span with
// asynchronous copies one group ahead (two span buffers), so overlapping
// frames are read once; the groups of every batch row are flattened over
// a resident grid (a group never spans two rows; a group wholly past its
// row's frames is skipped by the whole block; a frame past them inside a
// live group keeps its group's barriers and writes nothing). Each frame
// leaves as two runs of M + 1 floats: (|X|, arg X) or (Re X, Im X) in two
// arrays (stft.cu), or the packed row [Re X | Im X] that pvoc_fused.cu's
// phase passes read. Where a frame has a warp or more (N >= 1024) its
// threads store its runs; below, the bins go back into the frame's buffer
// and the block writes the group's contiguous rows in one sweep (a warp
// holds 2-4 frames there and would store 32- or 64-byte pieces of their
// rows). stft.cu's outputs from this body are bitwise those of its own
// earlier copy of it (checked on an H100 at every N and two hops).
//
// Every frame runs the same instructions on its own inputs, whatever its
// slot in the block, its block, its batch row, the span's alignment or
// the launch, so its bits depend on its inputs alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace real_fft {

constexpr int kThreads = 256;  // a block: kThreads / T frames
constexpr int kV = 16;         // complex values a thread holds
// Blocks an SM holds at once: caps a thread at 64 registers (spills of
// at most 20 bytes, at N = 2048; left free, nvcc took 79-133 registers
// and the kernels ran slower on an H100: fewer frames in flight).
constexpr int kMinBlocks = 4;

// The plan of an N-point real transform, N = 2^LOG2N, 256 <= N <= 4096.
template <int LOG2N>
struct Plan {
  static_assert(LOG2N >= 8 && LOG2N <= 12, "fft_real: 256 <= N <= 4096");
  static constexpr int N = 1 << LOG2N;
  static constexpr int M = N / 2;            // complex points
  static constexpr int LOG2M = LOG2N - 1;
  static constexpr int T = M / kV;           // threads per frame
  static constexpr int F = kThreads / T;     // frames per block
  static constexpr int S = (LOG2M + 3) / 4;  // stages
  static constexpr int A = LOG2M - 3 * S;    // of them radix 16, first
  static constexpr int FS = M + M / 32 + 2;  // floats per buffer array
  // log2 of stage s's radix, and of the product of the radices before it
  __host__ __device__ static constexpr int lr(int s) { return s < A ? 4 : 3; }
  __host__ __device__ static constexpr int lns(int s) {
    return s == 0 ? 0 : lns(s - 1) + lr(s - 1);
  }
  // offset of stage s's twiddles in the shared table
  __host__ __device__ static constexpr int toff(int s) {
    return s <= 1 ? 0 : toff(s - 1) + ((1 << lr(s - 1)) - 1) * (1 << lns(s - 1));
  }
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The frame's own barrier.
template <int T>
__device__ __forceinline__ void group_sync(int slot) {
  if constexpr (T <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "n"(T) : "memory");
  }
}

// cos and sin of 2 pi i / 16, i < 8, in float32.
__device__ __forceinline__ constexpr float cos16(int i) {
  return i == 0 ? 1.f : i == 1 ? 0.9238795325112867f : i == 2 ? 0.7071067811865476f
       : i == 3 ? 0.3826834323650898f : i == 4 ? 0.f : i == 5 ? -0.3826834323650898f
       : i == 6 ? -0.7071067811865476f : -0.9238795325112867f;
}
__device__ __forceinline__ constexpr float sin16(int i) {
  return i == 0 ? 0.f : i == 1 ? 0.3826834323650898f : i == 2 ? 0.7071067811865476f
       : i == 3 ? 0.9238795325112867f : i == 4 ? 1.f : i == 5 ? 0.9238795325112867f
       : i == 6 ? 0.7071067811865476f : 0.3826834323650898f;
}

// One radix-2 step of span LEN over a[R] (decimation in time, values in
// bit-reversed order), then the next; templates, so that every index is
// a constant and a, the caller's values, stay in registers.
template <int R, int LEN, bool FWD>
__device__ __forceinline__ void dit_steps(float (&ar)[R], float (&ai)[R]) {
#pragma unroll
  for (int b = 0; b < R; b += LEN) {
#pragma unroll
    for (int p = 0; p < LEN / 2; ++p) {
      constexpr int kStep = 16 / LEN;  // W_LEN^p = W_16^(p kStep)
      const int e = p * kStep;
      const int a = b + p, c = a + LEN / 2;
      float tr, ti;
      if (e == 0) {
        tr = ar[c];
        ti = ai[c];
      } else if (e == 4) {  // W = -i forward, +i inverse
        tr = FWD ? ai[c] : -ai[c];
        ti = FWD ? -ar[c] : ar[c];
      } else {
        const float wc = cos16(e);
        const float ws = FWD ? -sin16(e) : sin16(e);
        tr = ar[c] * wc - ai[c] * ws;
        ti = ar[c] * ws + ai[c] * wc;
      }
      ar[c] = ar[a] - tr;
      ai[c] = ai[a] - ti;
      ar[a] = ar[a] + tr;
      ai[a] = ai[a] + ti;
    }
  }
  if constexpr (2 * LEN <= R) dit_steps<R, 2 * LEN, FWD>(ar, ai);
}

// r < 16 with its low `bits` bits reversed; plain arithmetic, so that it
// folds to a constant in an unrolled loop.
__device__ __forceinline__ constexpr int bitrev_c(int r, int bits) {
  return (((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3)) >> (4 - bits);
}

// In place, natural order in and out: x = the R-point DFT of x[B .. B+R),
// forward (W_R = e^(-2 pi i / R)) or inverse (unscaled).
template <int R, int B, bool FWD>
__device__ __forceinline__ void dft_regs(float (&xr)[kV], float (&xi)[kV]) {
  static_assert(R == 8 || R == 16, "radix 8 or 16");
  constexpr int LR = R == 8 ? 3 : 4;
  float ar[R], ai[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ar[bitrev_c(r, LR)] = xr[B + r];
    ai[bitrev_c(r, LR)] = xi[B + r];
  }
  dit_steps<R, 2, FWD>(ar, ai);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xr[B + r] = ar[r];
    xi[B + r] = ai[r];
  }
}

// The 16 / R DFTs of radix R (8 or 16) a thread holds.
template <int R, bool FWD>
__device__ __forceinline__ void dft_all(float (&xr)[kV], float (&xi)[kV]) {
  dft_regs<R, 0, FWD>(xr, xi);
  if constexpr (R * 2 <= kV) dft_regs<R, R, FWD>(xr, xi);
}

// The stage twiddles of plan P into twr/twi (M floats each), from the
// N-point table twc/tws; the whole block, followed by a barrier of the
// caller's.
template <class P>
__device__ void build_twiddles(float* twr, float* twi,
                               const float* __restrict__ twc,
                               const float* __restrict__ tws) {
#pragma unroll
  for (int s = 1; s < P::S; ++s) {
    const int lr = P::lr(s), lns = P::lns(s);
    const int count = ((1 << lr) - 1) << lns;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
      const int r = (idx >> lns) + 1;
      const int q = idx & ((1 << lns) - 1);
      const int k = 2 * ((r * q) << (P::LOG2M - lns - lr));  // table index of W_M^e
      const bool neg = k >= P::M;
      const int h = neg ? k - P::M : k;
      const float c = __ldg(twc + h), sn = __ldg(tws + h);
      twr[P::toff(s) + idx] = neg ? -c : c;
      twi[P::toff(s) + idx] = neg ? -sn : sn;
    }
  }
}

// Where value r of butterfly kk of stage s goes: its output index.
template <class P, int s>
__device__ __forceinline__ int dest(int t, int kk, int r) {
  constexpr int lr = P::lr(s), lns = P::lns(s);
  const int j = t + P::T * kk;
  const int q = j & ((1 << lns) - 1);
  return ((j - q) << lr) + q + (r << lns);
}

// Where value r of butterfly kk of stage s comes from: its input index.
template <class P, int s>
__device__ __forceinline__ int source(int t, int kk, int r) {
  constexpr int lr = P::lr(s);
  return t + P::T * kk + r * (P::M >> lr);
}

// Stage s >= 1: exchange the values of stage s-1 through the frame's
// buffer, twiddle, and run the radix-R DFTs.
template <class P, int s, bool FWD>
__device__ __forceinline__ void stage(float (&vr)[kV], float (&vi)[kV],
                                      float* br, float* bi,
                                      const float* twr, const float* twi,
                                      int t, int slot) {
  constexpr int RP = 1 << P::lr(s - 1);
  constexpr int R = 1 << P::lr(s);
  constexpr int lns = P::lns(s);
  group_sync<P::T>(slot);
#pragma unroll
  for (int kk = 0; kk < kV / RP; ++kk) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int o = pad(dest<P, s - 1>(t, kk, r));
      br[o] = vr[kk * RP + r];
      bi[o] = vi[kk * RP + r];
    }
  }
  group_sync<P::T>(slot);
#pragma unroll
  for (int kk = 0; kk < kV / R; ++kk) {
    const int q = (t + P::T * kk) & ((1 << lns) - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = pad(source<P, s>(t, kk, r));
      const float xr = br[o], xi = bi[o];
      if (r == 0) {
        vr[kk * R] = xr;
        vi[kk * R] = xi;
      } else {
        const int w = P::toff(s) + ((r - 1) << lns) + q;
        const float wc = twr[w];
        const float ws = FWD ? -twi[w] : twi[w];
        vr[kk * R + r] = xr * wc - xi * ws;
        vi[kk * R + r] = xr * ws + xi * wc;
      }
    }
  }
  dft_all<R, FWD>(vr, vi);
}

// The M-point FFT of a frame whose stage-0 inputs the caller has put in
// vr/vi (value kk*R0 + r = input source<P, 0>(t, kk, r)). Returns with
// the last stage's outputs in vr/vi (value kk*R + r = output
// dest<P, S-1>(t, kk, r)); the buffer br/bi is free again only after the
// frame's next group_sync.
template <class P, bool FWD>
__device__ __forceinline__ void fft(float (&vr)[kV], float (&vi)[kV],
                                    float* br, float* bi, const float* twr,
                                    const float* twi, int t, int slot) {
  dft_all<(1 << P::lr(0)), FWD>(vr, vi);
  if constexpr (P::S > 1) stage<P, 1, FWD>(vr, vi, br, bi, twr, twi, t, slot);
  if constexpr (P::S > 2) stage<P, 2, FWD>(vr, vi, br, bi, twr, twi, t, slot);
}

// ------------------------------------------------------------ the analysis

// Asynchronous copies global -> shared (cp.async; 4 bytes through L1,
// 16 bytes around it), and the wait for all of the thread's copies.
__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void async_copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// Starts the copy of the span src[0 : len) into sp[o : o+len), o being
// src's offset in floats from the 16-byte boundary below it, so that
// aligned 16-byte chunks of src land on aligned shared words; the partial
// chunks at either end go element by element, so src may start at any
// element. The whole block; returns o. The span is in once the block's
// threads have waited and met at a barrier.
__device__ inline int load_span(float* sp, const float* __restrict__ src, int len) {
  const int o = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float* base = src - o;
  const int chunks = (len + o + 3) >> 2;
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const int e0 = 4 * q - o;
    if (e0 >= 0 && e0 + 4 <= len) {
      async_copy16(sp + 4 * q, base + 4 * q);
    } else {
      for (int e = 0; e < 4; ++e) {
        const int t = e0 + e;
        if (t >= 0 && t < len) async_copy4(sp + 4 * q + e, src + t);
      }
    }
  }
  return o;
}

// Floats of an analysis span of F frames at this hop: (F-1) hop + N and
// up to 3 floats of alignment, rounded up to whole 16-byte chunks.
template <class P>
__host__ __device__ constexpr int span_floats(int hop) {
  return ((P::F - 1) * hop + P::N + 7) & ~3;
}

// Shared memory of analysis_groups at this hop, in bytes: stage twiddles
// (2 M), F frame buffers (2 FS each), two spans.
template <class P>
constexpr size_t analysis_smem(int hop) {
  return sizeof(float) * (2 * P::M + P::F * 2 * P::FS + 2 * (size_t)span_floats<P>(hop));
}


// The output forms of the analysis: (|X|, arg X) or (Re X, Im X) in two
// arrays of rows of M + 1 bins, or packed rows [Re X (M + 1) | Im X (M + 1)].
enum Form { kPolar, kCart, kPacked };

// Bin k of a real frame's spectrum from Z = the N/2-point FFT of its
// packed samples: X[k] = (Z[k] + conj Z[M-k])/2 - i W^k (Z[k] - conj
// Z[M-k])/2 with (zr, zi) = Z[k], (mr, mi) = conj Z[M-k], (wr, wi) = W^k;
// (oa, ob) = (|X|, arg X) in the polar form, (Re X, Im X) otherwise.
template <int FORM>
__device__ __forceinline__ void split_bin(float zr, float zi, float mr,
                                          float mi, float wr, float wi,
                                          float& oa, float& ob) {
  const float er = 0.5f * (zr + mr), ei = 0.5f * (zi + mi);
  const float pr = 0.5f * (zi - mi), pi = -0.5f * (zr - mr);
  const float re = er + (pr * wr - pi * wi);
  const float im = ei + (pr * wi + pi * wr);
  oa = FORM == kPolar ? sqrtf(re * re + im * im) : re;
  ob = FORM == kPolar ? atan2f(im, re) : im;
}

// The forward transform of one frame: its samples xf[0 : N) times the
// window (win2, read as float2), packed z[n] = g[2n] + i g[2n+1], through
// the M-point FFT (the frame's buffer br/bi for the exchanges). Returns
// with Z[t + T v] (v < 16) in vr/vi at index (v % (16/RL)) RL + v / (16/RL)
// (the last stage's dest order, RL its radix); br/bi are free again after
// the frame's next group_sync.
template <class P>
__device__ __forceinline__ void transform_frame(const float* xf, const float2* __restrict__ win2,
                                                float* br, float* bi, const float* twr,
                                                const float* twi, int t, int slot,
                                                float (&vr)[kV], float (&vi)[kV]) {
  constexpr int R0 = 1 << P::lr(0);
#pragma unroll
  for (int kk = 0; kk < kV / R0; ++kk) {
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      const int n = source<P, 0>(t, kk, r);
      const float2 w = __ldg(win2 + n);
      vr[kk * R0 + r] = xf[2 * n] * w.x;
      vi[kk * R0 + r] = xf[2 * n + 1] * w.y;
    }
  }
  fft<P, true>(vr, vi, br, bi, twr, twi, t, slot);
}

// The analysis of one frame: transform_frame, then the split. Thread t
// emits bins k = t + T u (u < 8) and M - k (k = 0 gives bins 0 and M)
// from the same two values Z[k], Z[M - k], which only it reads, then
// thread 0 bin M/2 (its own mirror): emit(k, a, b) with (a, b) = (|X|,
// arg X) in the polar form, (Re X, Im X) otherwise. So emit may write
// bin k back into br/bi at pad(k). The frame's threads all run it (its
// barriers are the frame's own); every caller runs these instructions, so
// a frame's bins have the same bits whichever kernel analyses it.
template <class P, int FORM, class Emit>
__device__ __forceinline__ void analyse_frame(const float* xf, const float2* __restrict__ win2,
                                              float* br, float* bi, const float* twr,
                                              const float* twi, const float* __restrict__ twc,
                                              const float* __restrict__ tws, int t, int slot,
                                              Emit&& emit) {
  constexpr int M = P::M, T = P::T;
  constexpr int RL = 1 << P::lr(P::S - 1);
  float vr[kV], vi[kV];
  transform_frame<P>(xf, win2, br, bi, twr, twi, t, slot, vr, vi);
  group_sync<T>(slot);
#pragma unroll
  for (int kk = 0; kk < kV / RL; ++kk) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const int q = pad(dest<P, P::S - 1>(t, kk, r));
      br[q] = vr[kk * RL + r];
      bi[q] = vi[kk * RL + r];
    }
  }
  group_sync<T>(slot);
#pragma unroll
  for (int u = 0; u < kV / 2; ++u) {
    const int k = t + T * u;
    const int m = k == 0 ? 0 : M - k;
    const float zr = br[pad(k)], zi = bi[pad(k)];
    const float yr = br[pad(m)], yi = bi[pad(m)];
    float a0, b0, a1, b1;
    split_bin<FORM>(zr, zi, yr, -yi, __ldg(twc + k), -__ldg(tws + k), a0, b0);
    if (k == 0) {
      split_bin<FORM>(zr, zi, zr, -zi, -1.f, 0.f, a1, b1);
    } else {
      split_bin<FORM>(yr, yi, zr, -zi, __ldg(twc + m), -__ldg(tws + m), a1, b1);
    }
    emit(k, a0, b0);
    emit(k == 0 ? M : m, a1, b1);
  }
  if (t == 0) {
    constexpr int k = M / 2;
    float a0, b0;
    split_bin<FORM>(br[pad(k)], bi[pad(k)], br[pad(k)], -bi[pad(k)], __ldg(twc + k),
                    -__ldg(tws + k), a0, b0);
    emit(k, a0, b0);
  }
}

// The analysis of `batch` rows of x (x_stride samples apart), row b's
// first nfs[b] frames (nfs null: nf each), frame i of row b at
// x[b x_stride + i hop :][: N]: X = rfft(x[...] * w) into the frame's
// output row b nf + i, in the form FORM (oa, ob: the two arrays of rows
// of M + 1; kPacked: oa alone, rows of 2 (M + 1)). The post-twiddle is
// W^k = twc[k] - i tws[k] (W^(N/2) = -1). The whole kernel body: groups
// of F frames flattened over the grid, each frame through analyse_frame;
// shared memory as analysis_smem.
template <class P, int FORM>
__device__ __forceinline__ void analysis_groups(
    const float* __restrict__ x, long long x_stride, long long nf, int batch,
    const int* __restrict__ nfs, int hop, const float* __restrict__ win,
    const float* __restrict__ twc, const float* __restrict__ tws,
    float* __restrict__ oa, float* __restrict__ ob) {
  constexpr int M = P::M, T = P::T, F = P::F;
  constexpr bool kStaged = T < 32;
  constexpr int kRow = FORM == kPacked ? 2 * (M + 1) : M + 1;  // floats a row
  extern __shared__ __align__(16) float sm[];
  float* twr = sm;
  float* twi = sm + M;
  float* bufs = sm + 2 * M;
  const int slot = threadIdx.x / T, t = threadIdx.x % T;
  float* br = bufs + slot * 2 * P::FS;
  float* bi = br + P::FS;
  float* spans = bufs + F * 2 * P::FS;
  const int span_len = span_floats<P>(hop);
  build_twiddles<P>(twr, twi, twc, tws);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const long long per_row = (nf + F - 1) / F;
  const long long groups = per_row * batch;
  auto row_frames = [&](int b) -> long long { return nfs != nullptr ? (long long)nfs[b] : nf; };
  // This block's first group from gi on with a frame to transform, or
  // groups; the same for every thread of the block.
  auto next_live = [&](long long gi) {
    for (; gi < groups; gi += gridDim.x) {
      const int b = (int)(gi / per_row);
      if ((gi - b * per_row) * F < row_frames(b)) break;
    }
    return gi;
  };
  // Frames of group gi: its batch row, first frame, and frame count.
  auto decode = [&](long long gi, int& b, long long& i0) {
    b = (int)(gi / per_row);
    i0 = (gi - b * per_row) * F;
    const long long left = row_frames(b) - i0;
    return (int)(left < F ? left : F);
  };
  auto start_span = [&](long long gi, float* sp) {
    int b;
    long long i0;
    const int fg = decode(gi, b, i0);
    return load_span(sp, x + b * x_stride + i0 * hop, (fg - 1) * hop + P::N);
  };
  long long gi = next_live(blockIdx.x);
  int o_next = gi < groups ? start_span(gi, spans) : 0;
  int cur = 0;
  while (gi < groups) {
    int b;
    long long i0;
    const int fg = decode(gi, b, i0);
    const int o = o_next;
    // The span and the twiddles are in; the last group's buffers and the
    // other span are read.
    async_wait_all();
    __syncthreads();
    const long long gn = next_live(gi + gridDim.x);
    if (gn < groups) o_next = start_span(gn, spans + (cur ^ 1) * span_len);
    const float* xf = spans + cur * span_len + o + slot * hop;  // past fg: stale, not stored
    cur ^= 1;
    const bool live = slot < fg;
    const long long row0 = (long long)b * nf + i0;  // the group's first output row
    float* arow = oa + (row0 + slot) * kRow;
    float* brow = FORM == kPacked ? arow + M + 1 : ob + (row0 + slot) * kRow;
    analyse_frame<P, FORM>(xf, win2, br, bi, twr, twi, twc, tws, t, slot,
                           [&](int k, float a, float c) {
                             if constexpr (kStaged) {
                               br[pad(k)] = a;
                               bi[pad(k)] = c;
                             } else if (live) {
                               arow[k] = a;
                               brow[k] = c;
                             }
                           });
    if constexpr (kStaged) {
      __syncthreads();
      float* ga = oa + row0 * kRow;
      if constexpr (FORM == kPacked) {
        // Rows row0 .. row0 + fg - 1 are contiguous: element e is bin
        // r = e mod 2(M + 1) of frame e / 2(M + 1), its real part below
        // M + 1 and its imaginary part from there.
        for (int e = threadIdx.x; e < fg * kRow; e += kThreads) {
          const int f = e / kRow;
          const int r = e - f * kRow;
          ga[e] = bufs[f * 2 * P::FS + (r <= M ? pad(r) : P::FS + pad(r - (M + 1)))];
        }
      } else {
        // Rows row0 .. row0 + fg - 1 of each array: element e is bin
        // e mod (M + 1) of frame e / (M + 1).
        float* gb = ob + row0 * kRow;
        for (int e = threadIdx.x; e < fg * (M + 1); e += kThreads) {
          const int f = e / (M + 1);
          const int q = f * 2 * P::FS + pad(e - f * (M + 1));
          ga[e] = bufs[q];
          gb[e] = bufs[q + P::FS];
        }
      }
    }
    gi = gn;
  }
}

// log2 N when this body serves N (a power of two from 256 to 4096), else 0.
inline int real_log2(int n) {
  for (int l = 8; l <= 12; ++l) {
    if (n == 1 << l) return l;
  }
  return 0;
}

// As many blocks of `kernel` (kThreads threads each) as run on the card at
// once with `smem` bytes each, at most `groups`; raises the kernel's
// shared-memory limit past 48 KB when it needs to (N = 4096).
template <class K>
cudaError_t grid_for(K kernel, size_t smem, long long groups, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(groups < most ? groups : most);
  return cudaSuccess;
}

}  // namespace real_fft

// phase_scan — the synthesis phase of one segment of the branch-faithful
// polar stream on an H100 (the segment_phase entry).
//
// Replaces: phase_vocoder_tpu/streaming.py:115-128, the phase chain of
// segment_step (residual_terms_c, the valid-term mask, blocked_scan of
// wrap_add_c, the carry combine, finalize_phase, pin_real_bins), which XLA
// compiles into the body of the jitted lax.scan over segments; the JAX
// package has no Pallas kernel there. Its plain version is
// phase_vocoder_tpu_torch/ops/phase.py segment_phase_reference, some 900
// eager torch launches for a 1024-frame segment.
//
// Contract: bit for bit the plain version, signed zeros included. Every
// addition, subtraction and multiplication is spelled __fadd_rn /
// __fsub_rn / __fmul_rn, so nvcc contracts none of them into an FMA (the
// build has no -fmad=false, and a contracted TwoSum or Dekker product
// loses the error word it exists to keep); the constants are the Python
// doubles rounded to float32 on the host (ops/phase.py _segment_consts),
// as torch rounds a scalar operand; the scan combines the same operands
// in the same tree as ops/phase.py blocked_scan (below); the linear phase
// is integer arithmetic. No atomics: two runs give the same bits.
//
// What bounds it: per segment it reads phi (F, nb) and writes psi (F, nb),
// 2 * 4 * F * nb bytes (4.2 MB at F = 1024, N = 1024: 1.26 us at
// 3.35 TB/s), and does ~200 FP32 operations per (frame, bin) (87 for the
// term, 35 per wrap_add_c combine, ~2 combines in the tree and one with
// the carry, 11 to finalize): ~106 M operations, 1.58 us at 67 TFLOP/s.
// So operations, on paper; in practice the latency of the tree's 2 log2 F
// levels, each a chain of ~35 dependent operations ended by a block
// barrier, and few warps a block to hide it.
//
// Design. A block of 256 threads owns kBins consecutive bins over all F
// frames, so no state crosses blocks and the grid is ceil(nb / kBins)
// blocks. Threads run over (row, bin) items with the bin fastest, so a
// warp's loads and stores of phi and psi fall on consecutive addresses
// of a few rows. The block
//   1. forms the masked terms of up to 1024 rows into shared memory
//      (2 * 1024 * kBins floats), +0.0 past F (the identity padding);
//   2. scans them in place, level by level (a barrier between levels);
//   3. combines each row with the carry, finalizes and pins it, and
//      writes psi (and, at row F-1, the carry out).
// F <= 1024: one tree over F padded to a power of two. F > 1024:
// blocked_scan's two levels: a first sweep forms each 1024-row block's
// terms and its total (the up-sweep's root is the tree's last row), the
// block totals are scanned with the same tree in a global scratch of the
// wrapper's, and a second sweep re-forms each block's terms, scans them
// and combines the block's exclusive prefix (+0.0 for the first) before
// the carry.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 4;          // bins a block owns
constexpr int kScanBlock = 1024;  // ops/phase.py blocked_scan's block

// ops/phase.py _segment_consts, in this order.
struct PhaseConsts {
  float inv_two_pi, two_pi_hi, two_pi_lo, hi12a, hi12b, lin_scale;
  float k, kh, kl, k_err;  // _scale_pair's scale, its halves, its residue
};
static_assert(sizeof(PhaseConsts) == 10 * sizeof(float), "PhaseConsts layout");

struct Pair {
  float h, l;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// ops/phase.py _two_sum.
__device__ __forceinline__ Pair two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float bb = fsub(s, a);
  return {s, fadd(fsub(a, fsub(s, bb)), fsub(b, bb))};
}

// ops/phase.py _wrap_pair.
__device__ __forceinline__ Pair wrap_pair(float h, float l, const PhaseConsts& c) {
  const float n = ceilf(fsub(fmul(h, c.inv_two_pi), 0.5f));
  const Pair a = two_sum(h, fmul(-n, c.hi12a));
  const Pair b = two_sum(a.h, fmul(-n, c.hi12b));
  return two_sum(b.h, fsub(fadd(l, fadd(a.l, b.l)), fmul(n, c.two_pi_lo)));
}

// ops/phase.py wrap_add_c.
__device__ __forceinline__ Pair wrap_add_c(Pair a, Pair b, const PhaseConsts& c) {
  const Pair s = two_sum(a.h, b.h);
  return wrap_pair(s.h, fadd(fadd(a.l, b.l), s.l), c);
}

// ops/phase.py princarg.
__device__ __forceinline__ float princarg(float x, const PhaseConsts& c) {
  const float n = ceilf(fsub(fmul(x, c.inv_two_pi), 0.5f));
  return fsub(fsub(x, fmul(n, c.two_pi_hi)), fmul(n, c.two_pi_lo));
}

// ops/phase.py residual_terms_c for one (frame, bin): the step from phase
// `prev` to `cur`, then _scale_pair and the wrap.
__device__ __forceinline__ Pair residual_term(float cur, float prev, float het_hi,
                                              float het_lo, const PhaseConsts& c) {
  const Pair d1 = two_sum(cur, -prev);
  const Pair d2 = two_sum(d1.h, -het_hi);
  const Pair w = wrap_pair(d2.h, fsub(fadd(d1.l, d2.l), het_lo), c);
  const float p = fmul(c.k, w.h);
  const float cc = fmul(4097.0f, w.h);
  const float h_hi = fsub(cc, fsub(cc, w.h));
  const float h_lo = fsub(w.h, h_hi);
  const float err = fadd(fadd(fadd(fsub(fmul(c.kh, h_hi), p), fmul(c.kh, h_lo)),
                              fmul(c.kl, h_hi)),
                         fmul(c.kl, h_lo));
  return wrap_pair(p, fadd(fadd(fmul(c.k, w.l), err), fmul(c.k_err, w.h)), c);
}

// The inclusive scan of ops/phase.py _associative_scan (jax.lax's odd/even
// recursion) in place over n rows of `cols` columns, row i of column b at
// i * stride + b. Level s = 1, 2, 4, ... while n / s >= 2 holds the
// previous level's elements at rows (m + 1) s - 1; the up-sweep combines
// element pairs (2i, 2i+1) into row (2i + 2) s - 1, the reduced elements
// the recursion scans; the down-sweep, from the top level down, forms the
// even outputs 2i >= 2 at row (2i + 1) s - 1 from the prefix at row
// 2i s - 1 (the recursion's odd output i - 1), for 2i < n / s. The odd
// outputs are already in place. Each level ends in a block barrier.
__device__ void tree_up(float* h, float* l, int stride, int n, int cols,
                        const PhaseConsts& c) {
  for (int s = 1; n / s >= 2; s *= 2) {
    const int items = (n / s / 2) * cols;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int i = it / cols, b = it % cols;
      const int a = ((2 * i + 1) * s - 1) * stride + b;
      const int r = ((2 * i + 2) * s - 1) * stride + b;
      const Pair v = wrap_add_c({h[a], l[a]}, {h[r], l[r]}, c);
      h[r] = v.h;
      l[r] = v.l;
    }
    __syncthreads();
  }
}

__device__ void tree_down(float* h, float* l, int stride, int n, int cols,
                          const PhaseConsts& c) {
  int top = 1;
  while (n / (2 * top) >= 2) top *= 2;
  for (int s = top; s >= 1 && n / s >= 2; s /= 2) {
    const int items = ((n / s - 1) / 2) * cols;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int i = it / cols + 1, b = it % cols;
      const int a = (2 * i * s - 1) * stride + b;
      const int r = ((2 * i + 1) * s - 1) * stride + b;
      const Pair v = wrap_add_c({h[a], l[a]}, {h[r], l[r]}, c);
      h[r] = v.h;
      l[r] = v.l;
    }
    __syncthreads();
  }
}

struct Segment {
  const float* phi;       // (F, nb)
  const float* phi_prev;  // (nb,)
  const float* carry_hi;  // (nb,)
  const float* carry_lo;  // (nb,)
  const float* phi0;      // (nb,): the state's, or phi's row 0
  const float* het_hi;    // (nb,) ops/phase.py _het_split
  const float* het_lo;
  float* psi;             // (F, nb)
  float* carry_out;       // (2, nb): hi, lo
  float* totals;          // (2, blocks, nb) when F > kScanBlock
  int F, nb, n_fft, rs_mod, gmod, n_valid;
  long long g;            // global index of frame 0
};

// The masked terms of rows r0 .. r0 + rows - 1 of bins k0 .. k0 + kBins - 1
// into the shared tree (row r, bin b at r * kBins + b); +0.0 past F and
// past the last bin.
__device__ void load_terms(const Segment& sg, int k0, int r0, int rows, float* sh,
                           float* sl, const PhaseConsts& c) {
  for (int it = threadIdx.x; it < rows * kBins; it += blockDim.x) {
    const int j = r0 + it / kBins, k = k0 + it % kBins;
    Pair t = {0.0f, 0.0f};
    if (j < sg.F && k < sg.nb) {
      const float cur = sg.phi[(size_t)j * sg.nb + k];
      const float prev = j == 0 ? sg.phi_prev[k] : sg.phi[(size_t)(j - 1) * sg.nb + k];
      t = residual_term(cur, prev, sg.het_hi[k], sg.het_lo[k], c);
      const float v = (j < sg.n_valid && sg.g + j > 0) ? 1.0f : 0.0f;
      t = {fmul(t.h, v), fmul(t.l, v)};
    }
    sh[it] = t.h;
    sl[it] = t.l;
  }
}

// Rows r0 .. of the scanned tree: the block's exclusive prefix (blocked
// scans), the carry, the residual, finalize_phase and pin_real_bins.
__device__ void emit_rows(const Segment& sg, int k0, int r0, int rows, int blk,
                          int blocks, const float* sh, const float* sl,
                          const PhaseConsts& c) {
  const int nb = sg.nb, n = sg.n_fft;
  for (int it = threadIdx.x; it < rows * kBins; it += blockDim.x) {
    const int j = r0 + it / kBins, k = k0 + it % kBins;
    if (j >= sg.F || k >= nb) continue;
    Pair incl = {sh[it], sl[it]};
    if (blocks > 1) {
      const Pair pre = blk == 0 ? Pair{0.0f, 0.0f}
                                : Pair{sg.totals[(size_t)(blk - 1) * nb + k],
                                       sg.totals[((size_t)blocks + blk - 1) * nb + k]};
      incl = wrap_add_c(pre, incl, c);
    }
    const Pair res = wrap_add_c({sg.carry_hi[k], sg.carry_lo[k]}, incl, c);
    if (j == sg.F - 1) {
      sg.carry_out[k] = res.h;
      sg.carry_out[nb + k] = res.l;
    }
    const long long i = ((long long)j + sg.gmod) % n;  // frame index mod N
    const float ph = sg.phi[(size_t)j * nb + k];
    float out;
    if (k == 0) {
      out = ph;
    } else if (k == nb - 1) {
      const long long kr = ((long long)sg.rs_mod * (n / 2)) % n;
      out = fadd(ph, fmul(c.lin_scale, (float)((i * kr) % n)));
    } else {
      const long long kr = ((long long)k * sg.rs_mod) % n;
      const float lin = fmul(c.lin_scale, (float)((i * kr) % n));
      out = princarg(fadd(fadd(sg.phi0[k], lin), fadd(res.h, res.l)), c);
    }
    sg.psi[(size_t)j * nb + k] = out;
  }
}

__global__ void __launch_bounds__(kThreads)
    segment_phase_kernel(Segment sg, int rows, PhaseConsts c) {
  extern __shared__ float smem[];
  float* sh = smem;
  float* sl = smem + rows * kBins;
  const int k0 = blockIdx.x * kBins;
  const int cols = min(kBins, sg.nb - k0);
  const int blocks = (sg.F + rows - 1) / rows;
  if (blocks > 1) {
    float* tot_h = sg.totals;
    float* tot_l = sg.totals + (size_t)blocks * sg.nb;
    for (int blk = 0; blk < blocks; ++blk) {
      load_terms(sg, k0, blk * rows, rows, sh, sl, c);
      __syncthreads();
      tree_up(sh, sl, kBins, rows, kBins, c);
      if ((int)threadIdx.x < cols) {
        tot_h[(size_t)blk * sg.nb + k0 + threadIdx.x] = sh[(rows - 1) * kBins + threadIdx.x];
        tot_l[(size_t)blk * sg.nb + k0 + threadIdx.x] = sl[(rows - 1) * kBins + threadIdx.x];
      }
      __syncthreads();
    }
    tree_up(tot_h + k0, tot_l + k0, sg.nb, blocks, cols, c);
    tree_down(tot_h + k0, tot_l + k0, sg.nb, blocks, cols, c);
  }
  for (int blk = 0; blk < blocks; ++blk) {
    load_terms(sg, k0, blk * rows, rows, sh, sl, c);
    __syncthreads();
    tree_up(sh, sl, kBins, rows, kBins, c);
    tree_down(sh, sl, kBins, rows, kBins, c);
    emit_rows(sg, k0, blk * rows, rows, blk, blocks, sh, sl, c);
    __syncthreads();
  }
}

}  // namespace

// phi (F, nb) float32, nb = n_fft/2 + 1; phi_prev, carry_hi, carry_lo,
// phi0, het_hi, het_lo (nb,); psi (F, nb) and carry_out (2, nb) receive
// the outputs; totals (2, ceil(F/1024), nb) is scratch when F > 1024 (else
// null). rs_mod = rs mod n_fft, g the segment's global frame offset, gmod
// = g mod n_fft, n_valid in [0, F]; consts points to the host's 10 floats
// of PhaseConsts.
extern "C" int segment_phase(const float* phi, const float* phi_prev,
                             const float* carry_hi, const float* carry_lo,
                             const float* phi0, const float* het_hi,
                             const float* het_lo, float* psi, float* carry_out,
                             float* totals, int F, int nb, int n_fft, int rs_mod,
                             long long g, int gmod, int n_valid,
                             const float* consts, cudaStream_t stream) {
  if (F < 1 || nb < 2 || (F > kScanBlock && totals == nullptr)) return cudaErrorInvalidValue;
  PhaseConsts c;
  std::memcpy(&c, consts, sizeof c);
  // Rows of one tree: F padded to a power of two, or a 1024-row block.
  int rows = 1;
  while (rows < F && rows < kScanBlock) rows *= 2;
  const Segment sg = {phi, phi_prev, carry_hi, carry_lo, phi0, het_hi, het_lo, psi,
                      carry_out, totals, F, nb, n_fft, rs_mod, gmod, n_valid, g};
  const size_t smem = 2 * (size_t)rows * kBins * sizeof(float);
  const unsigned grid = (unsigned)((nb + kBins - 1) / kBins);
  segment_phase_kernel<<<grid, kThreads, smem, stream>>>(sg, rows, c);
  return cudaGetLastError();
}

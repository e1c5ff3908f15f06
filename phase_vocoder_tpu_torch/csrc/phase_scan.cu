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
// the carry, 11 to finalize): ~106 M operations, 1.58 us at 67 TFLOP/s,
// which counts an FMA as two; none of these can be an FMA, so at one
// operation a lane a clock the instruction-issue bound is ~3.2 us.
// Operations, then, and the latency of the tree's levels, each a chain of
// ~35 dependent operations.
//
// Design. The tree is fixed by row indices, not by which thread combines,
// so the levels go where they are cheapest. Each thread owns R = kRows
// aligned consecutive rows of one bin, in registers; L = rows / R threads
// serve a bin, a block serves kb bins (L * kb threads). Over a tree of
// `rows` rows (F padded to a power of two, at least R; or a 1024-row
// block of blocked_scan) the up-sweep level s (pairs (2i+1)s-1 ->
// (2i+2)s-1) and the down-sweep level s ((2i)s-1 -> (2i+1)s-1, i >= 1)
// run
//   * for s < R inside the thread (thread_up, thread_down): both rows of a
//     pair lie in the thread's aligned R rows, except the down-sweep's
//     left row R*t-1, the previous thread's last row, which is final by
//     then (one shuffle);
//   * for R <= s < 32R across a warp's lanes, each lane holding its last
//     row (group_up, group_down: __shfl_up_sync by s/R, the left operand
//     first);
//   * for s >= 32R (1024 rows at R = 8: two levels up, one down) across
//     the bin's warps: their last rows go through shared memory and one
//     warp runs the same shuffle tree over them, a block barrier either
//     side.
// A tree padded to more rows than F combines the same operands on rows
// < F (the pairs of the first rows do not depend on the padding), so
// every tree has at least R rows. phi comes in and psi goes out through
// a shared tile of the block's rows x kb bins, filled and drained with
// the bin fastest (a warp reads 32 consecutive floats of a row when kb
// >= 32, kb * 4 bytes of 32 / kb rows otherwise); in the tile each
// thread's R rows are consecutive with one float of padding, so that a
// warp reading its lanes' rows hits 32 banks. The previous frame of a
// thread's first row is the previous thread's last row in the tile. The
// linear phase (i * kr) mod N steps by kr mod N from row to row with one
// conditional subtraction (the same integer; no 64-bit modulo).
// F <= 1024: one tree. F > 1024: blocked_scan's two levels: a first sweep
// forms each 1024-row block's terms and up-sweep, whose root (the block's
// last row) is its total, into the wrapper's global scratch; one thread a
// bin scans the block totals with _associative_scan's tree over their
// unpadded count; a second sweep re-forms each block's terms, scans them
// and combines the block's exclusive prefix (+0.0 for the first) before
// the carry.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kScanBlock = 1024;  // ops/phase.py blocked_scan's block
constexpr int kRows = 8;          // R: rows a thread owns
constexpr int kMaxThreads = 512;

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

// The tree of ops/phase.py _associative_scan (jax.lax's odd/even
// recursion) over n rows, n a power of two: the up-sweep level s = 1, 2,
// 4, ... (while n / s >= 2) combines rows (2i+1)s-1 and (2i+2)s-1 into
// the latter, the recursion's reduced elements; the down-sweep, from the
// top level down, combines row 2is-1 (the recursion's odd output i-1)
// with row (2i+1)s-1 into the latter, for i >= 1, the even outputs. The
// functions below run its levels s < R inside a thread, over its rows
// v[0..R-1] (rows R*t .. R*t+R-1 of the tree), and the levels s >= R
// across `group` consecutive threads t (a power of two, at most 32: the
// lanes of a warp, or the first lanes of one), each holding its last
// row x.
template <int R>
__device__ __forceinline__ void thread_up(Pair (&v)[R], const PhaseConsts& c) {
#pragma unroll
  for (int s = 1; s < R; s *= 2) {
#pragma unroll
    for (int r = 2 * s - 1; r < R; r += 2 * s) v[r] = wrap_add_c(v[r - s], v[r], c);
  }
}

// `prev` is the previous thread's last row, final by now (has_prev: the
// thread is not the tree's first).
template <int R>
__device__ __forceinline__ void thread_down(Pair (&v)[R], Pair prev, bool has_prev,
                                            const PhaseConsts& c) {
#pragma unroll
  for (int s = R / 2; s >= 1; s /= 2) {
    if (has_prev) v[s - 1] = wrap_add_c(prev, v[s - 1], c);
#pragma unroll
    for (int r = 3 * s - 1; r < R; r += 2 * s) v[r] = wrap_add_c(v[r - s], v[r], c);
  }
}

__device__ __forceinline__ Pair shfl_up(Pair v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.h, d), __shfl_up_sync(0xffffffffu, v.l, d)};
}

// Up-sweep levels s = R d, d = 1 .. group/2: thread t = (2i+2)d-1 takes
// thread t-d's last row as the left operand.
__device__ __forceinline__ Pair group_up(Pair x, int t, int group, const PhaseConsts& c) {
  for (int d = 1; d < group; d *= 2) {
    const Pair y = shfl_up(x, d);
    if (((t + 1) & (2 * d - 1)) == 0) x = wrap_add_c(y, x, c);
  }
  return x;
}

// Down-sweep levels s = R d, d = group/2 .. 1: thread t = (2i+1)d-1 takes
// thread t-d's last row; for t = d-1 that is the previous group's last
// thread, `prev` (has_prev: there is one in the tree).
__device__ __forceinline__ Pair group_down(Pair x, Pair prev, bool has_prev, int t, int group,
                                           const PhaseConsts& c) {
  for (int d = group / 2; d >= 1; d /= 2) {
    Pair y = shfl_up(x, d);
    if (t < d) y = prev;
    if (((t + 1) & (2 * d - 1)) == d && (t + 1 > d || has_prev)) x = wrap_add_c(y, x, c);
  }
  return x;
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

// The block's shape: a tree of `rows` rows, L = rows / R threads a bin,
// kb bins a block, a bin's stride S in the tile (L * (R + 1) floats and
// padding).
struct Layout {
  int rows, L, kb, S;
};

// The shared tile of rows r0 .. r0 + rows - 1 and bins k0 .. k0 + kb - 1:
// row `row` of bin b at b * S + (row / R) * (R + 1) + row % R. Filled and
// drained with the bin fastest, +0.0 past F and past the last bin.
template <int R>
__device__ __forceinline__ int tile_at(const Layout& lay, int b, int row) {
  return b * lay.S + (row / R) * (R + 1) + row % R;
}

// The tile holds rows * kb = R * blockDim.x floats: each thread moves R of
// them, all its loads issued before the first store.
template <int R>
__device__ __forceinline__ void load_tile(const Segment& sg, const Layout& lay, int r0, int k0,
                                          float* tile) {
  float v[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int it = threadIdx.x + u * blockDim.x;
    const int row = it / lay.kb, b = it - row * lay.kb;
    const int j = r0 + row, k = k0 + b;
    v[u] = j < sg.F && k < sg.nb ? sg.phi[(size_t)j * sg.nb + k] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int it = threadIdx.x + u * blockDim.x;
    const int row = it / lay.kb;
    tile[tile_at<R>(lay, it - row * lay.kb, row)] = v[u];
  }
}

template <int R>
__device__ __forceinline__ void store_tile(const Segment& sg, const Layout& lay, int r0, int k0,
                                           const float* tile) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int it = threadIdx.x + u * blockDim.x;
    const int row = it / lay.kb, b = it - row * lay.kb;
    const int j = r0 + row, k = k0 + b;
    if (j < sg.F && k < sg.nb) sg.psi[(size_t)j * sg.nb + k] = tile[tile_at<R>(lay, b, row)];
  }
}

// The masked terms of the thread's rows j0 .. j0 + R - 1 (+0.0 past F)
// from its rows of the tile; `prev` is the phase of frame j0 - 1.
template <int R>
__device__ __forceinline__ void load_terms(const Segment& sg, int j0, float het_hi, float het_lo,
                                           const float* mine, float prev, Pair (&v)[R],
                                           const PhaseConsts& c) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    const float cur = mine[r];
    Pair t = {0.0f, 0.0f};
    if (j < sg.F) {
      t = residual_term(cur, prev, het_hi, het_lo, c);
      const float on = (j < sg.n_valid && sg.g + j > 0) ? 1.0f : 0.0f;
      t = {fmul(t.h, on), fmul(t.l, on)};
    }
    v[r] = t;
    prev = cur;
  }
}

// (a * b) mod n for a, b < n, in 32-bit integers: the product where it
// fits (n * n < 2^31), else by doubling (r < n < 2^31 keeps 2r and r + a
// below 2^32).
__device__ __forceinline__ unsigned mulmod(unsigned a, unsigned b, unsigned n) {
  if (n <= 46340u) return a * b % n;
  unsigned r = 0;
  for (int bit = 31; bit >= 0; --bit) {
    r = 2 * r >= n ? 2 * r - n : 2 * r;
    if ((b >> bit) & 1u) r = r + a >= n ? r + a - n : r + a;
  }
  return r;
}

// One tree over the block's tile rows, for the thread's rows v (a tree
// of lay.rows rows, this thread its T-th of the bin's L): the up-sweep,
// and unless `up_only` the down-sweep. Returns the thread's last row
// after the up-sweep levels it takes part in; with `up_only` the tree's
// root (its total) is in the return value of thread L - 1 when the bin
// has one warp or less, else in top[b * W + W - 1].
template <int R>
__device__ __forceinline__ Pair tree_block(Pair (&v)[R], const Layout& lay, Pair* top, int b,
                                           int T, bool up_only, const PhaseConsts& c) {
  const int t = T & 31, w = T >> 5;
  const int group = min(lay.L, 32), W = lay.L >> 5;
  thread_up<R>(v, c);
  Pair last = group_up(v[R - 1], t, group, c);
  Pair prev = {0.0f, 0.0f};
  if (W > 1) {
    // The levels across the bin's warps: the warps' last rows in shared
    // memory, one warp a bin runs their tree.
    if (t == 31) top[b * W + w] = last;
    __syncthreads();
    if (w == 0) {
      Pair x = t < W ? top[b * W + t] : Pair{0.0f, 0.0f};
      x = group_up(x, t, W, c);
      if (!up_only) x = group_down(x, prev, false, t, W, c);
      if (t < W) top[b * W + t] = x;
    }
    __syncthreads();
    if (up_only) return last;
    if (t == 31) last = top[b * W + w];
    if (w > 0) prev = top[b * W + w - 1];
  }
  if (up_only) return last;
  last = group_down(last, prev, w > 0, t, group, c);
  Pair before = shfl_up(last, 1);  // the previous thread's last row, final
  if (t == 0) before = prev;
  v[R - 1] = last;
  thread_down<R>(v, before, T > 0, c);
  return last;
}

// ops/phase.py _associative_scan over n rows of one column (row i at
// i * stride), by one thread, in the up- and down-sweep order above;
// n need not be a power of two.
__device__ void serial_scan(float* h, float* l, int stride, int n, const PhaseConsts& c) {
  for (int s = 1; n / s >= 2; s *= 2) {
    for (int i = 0; i < n / s / 2; ++i) {
      const size_t a = (size_t)((2 * i + 1) * s - 1) * stride;
      const size_t r = (size_t)((2 * i + 2) * s - 1) * stride;
      const Pair v = wrap_add_c({h[a], l[a]}, {h[r], l[r]}, c);
      h[r] = v.h;
      l[r] = v.l;
    }
  }
  int top = 1;
  while (n / (2 * top) >= 2) top *= 2;
  for (int s = top; s >= 1; s /= 2) {
    for (int i = 1; 2 * i < n / s; ++i) {
      const size_t a = (size_t)(2 * i * s - 1) * stride;
      const size_t r = (size_t)((2 * i + 1) * s - 1) * stride;
      const Pair v = wrap_add_c({h[a], l[a]}, {h[r], l[r]}, c);
      h[r] = v.h;
      l[r] = v.l;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    segment_phase_kernel(Segment sg, Layout lay, PhaseConsts c) {
  extern __shared__ float smem[];
  float* tile = smem;
  Pair* top = reinterpret_cast<Pair*>(smem + ((lay.kb * lay.S + 1) & ~1));
  const int L = lay.L, b = threadIdx.x / L, T = threadIdx.x - b * L;
  const int k0 = blockIdx.x * lay.kb, k_raw = k0 + b;
  const bool live = k_raw < sg.nb;
  const int k = live ? k_raw : sg.nb - 1;  // dead bins read bin nb-1, store nothing
  const int W = L >> 5;
  const int blocks = (sg.F + lay.rows - 1) / lay.rows;
  float* mine = tile + tile_at<R>(lay, b, R * T);
  const float het_hi = sg.het_hi[k], het_lo = sg.het_lo[k];
  Pair v[R];
  // The thread's first frame's previous phase: the tile's previous row,
  // or phi_prev / the previous block's last row for the bin's first.
  auto prev_phase = [&](int r0) {
    if (T > 0) return mine[-2];
    return r0 == 0 ? sg.phi_prev[k] : sg.phi[(size_t)(r0 - 1) * sg.nb + k];
  };
  if (blocks > 1) {
    float* tot_h = sg.totals;
    float* tot_l = sg.totals + (size_t)blocks * sg.nb;
    for (int blk = 0; blk < blocks; ++blk) {
      const int r0 = blk * lay.rows;
      load_tile<R>(sg, lay, r0, k0, tile);
      __syncthreads();
      load_terms<R>(sg, r0 + R * T, het_hi, het_lo, mine, prev_phase(r0), v, c);
      const Pair last = tree_block<R>(v, lay, top, b, T, true, c);
      const Pair root = W > 1 ? top[b * W + W - 1] : last;
      if (live && T == L - 1) {
        tot_h[(size_t)blk * sg.nb + k] = root.h;
        tot_l[(size_t)blk * sg.nb + k] = root.l;
      }
      __syncthreads();
    }
    if (live && T == 0) serial_scan(tot_h + k, tot_l + k, sg.nb, blocks, c);
    __syncthreads();
  }
  const unsigned n = (unsigned)sg.n_fft;
  const unsigned kr = mulmod((unsigned)k, (unsigned)sg.rs_mod, n);
  const Pair carry = {sg.carry_hi[k], sg.carry_lo[k]};
  const float phi0 = sg.phi0[k];
  for (int blk = 0; blk < blocks; ++blk) {
    const int r0 = blk * lay.rows, j0 = r0 + R * T;
    load_tile<R>(sg, lay, r0, k0, tile);
    __syncthreads();
    load_terms<R>(sg, j0, het_hi, het_lo, mine, prev_phase(r0), v, c);
    tree_block<R>(v, lay, top, b, T, false, c);
    // Every thread has read its previous row from the tile before psi
    // overwrites it (tree_block has barriers only across warps).
    if (W <= 1) __syncthreads();
    Pair pre = {0.0f, 0.0f};  // the block's exclusive prefix (blocked scans)
    if (blocks > 1 && blk > 0) {
      pre = {sg.totals[(size_t)(blk - 1) * sg.nb + k],
             sg.totals[((size_t)blocks + blk - 1) * sg.nb + k]};
    }
    // The frame index mod N of row j0, and (i * kr) mod N stepped by kr.
    unsigned lin = mulmod(((unsigned)j0 + (unsigned)sg.gmod) % n, kr, n);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + r;
      if (live && j < sg.F) {
        const Pair incl = blocks > 1 ? wrap_add_c(pre, v[r], c) : v[r];
        const Pair res = wrap_add_c(carry, incl, c);
        if (j == sg.F - 1) {
          sg.carry_out[k] = res.h;
          sg.carry_out[sg.nb + k] = res.l;
        }
        const float ph = mine[r];
        const float lin_ph = fmul(c.lin_scale, (float)lin);
        float o;
        if (k == 0) {
          o = ph;
        } else if (k == sg.nb - 1) {
          o = fadd(ph, lin_ph);
        } else {
          o = princarg(fadd(fadd(phi0, lin_ph), fadd(res.h, res.l)), c);
        }
        mine[r] = o;
      }
      lin += kr;
      if (lin >= n) lin -= n;
    }
    __syncthreads();
    store_tile<R>(sg, lay, r0, k0, tile);
    __syncthreads();
  }
}

// The layout of a call: rows of one tree (F padded to a power of two, at
// least R, or a 1024-row block), and bins a block: kMaxThreads / L when a
// bin takes under a warp (partial segments), else the most of 4, 2, 1
// that leaves about half the SMs a block or more. A
// wider tile row moves phi and psi in fewer, fuller sectors (rows of nb
// floats are not 16-byte aligned): on an H100, 1024 frames take 12.1 us at
// N = 1024 with 4 bins a block, 13.4 with 2, 18.7 with 1, and at N = 256
// (129 bins) 8.2 us with 2 against 11.4 with 4 (33 blocks).
template <int R>
Layout make_layout(int F, int nb, int sms) {
  int rows = R;
  while (rows < F && rows < kScanBlock) rows *= 2;
  const int L = rows / R;
  int kb = kMaxThreads / L;
  if (L >= 32) {
    kb = 4;
    while (kb > 1 && (nb + kb - 1) / kb < sms / 2 - 2) kb /= 2;
  }
  // A bin's tile stride: 8 floats of padding past whole warps, so that the
  // fill's 8-row runs of kb bins fall on distinct banks.
  const int S = L * (R + 1) + (L >= 32 ? 8 : 0);
  return {rows, L, kb, S};
}

size_t smem_bytes(const Layout& lay) {
  const int W = lay.L >> 5;
  return (size_t)((lay.kb * lay.S + 1) & ~1) * sizeof(float) +
         (size_t)lay.kb * (W > 1 ? W : 0) * sizeof(Pair);
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
  const Segment sg = {phi, phi_prev, carry_hi, carry_lo, phi0, het_hi, het_lo, psi,
                      carry_out, totals, F, nb, n_fft, rs_mod, gmod, n_valid, g};
  static int sms = 0;  // the card's SMs, read once
  if (sms == 0) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
  }
  const Layout lay = make_layout<kRows>(F, nb, sms);
  const unsigned grid = (unsigned)((nb + lay.kb - 1) / lay.kb);
  segment_phase_kernel<kRows><<<grid, lay.L * lay.kb, smem_bytes(lay), stream>>>(sg, lay, c);
  return cudaGetLastError();
}

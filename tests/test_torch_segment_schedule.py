"""The schedule of csrc/phase_scan.cu's segment_phase kernel, replayed on
the CPU.

The kernel runs only on the card, and it is held bitwise to
ops/phase.py segment_phase_reference there (chip_smoke.py, phase 2f).
What decides its bits besides the arithmetic is which operands each
combine takes, and in which order. Here the kernel's own index formulas
(make_layout, thread_up / thread_down, group_up / group_down over a
warp's lanes with __shfl_up_sync's semantics, the tree across a bin's
warps through shared memory, blocked_scan's block totals and
serial_scan) are replayed thread by thread over a combine that records
its operands as the string "(a,b)", and every output row's expression is
held equal to the one that ops/phase.py blocked_scan (and so
_associative_scan) builds with the same combine.

Also here: the linear phase's (i * kr) mod N, which the kernel steps by
kr from row to row (one conditional subtraction; the products in 32-bit
integers, or by doubling past N = 46340), against the direct product.
"""

import numpy as np
import pytest
import torch

from phase_vocoder_tpu_torch.ops import phase as T

R = 8  # csrc/phase_scan.cu kRows
MAX_THREADS = 512  # kMaxThreads
SCAN_BLOCK = 1024  # kScanBlock
SMS = 132  # an H100's SMs, as make_layout reads them


class Exprs:
    """Interned expressions: 0 is the identity's "0", then the leaves,
    then each combine's "(a,b)"."""

    def __init__(self):
        self.ids = {"0": 0}

    def leaf(self, name: str) -> int:
        return self.ids.setdefault(name, len(self.ids))

    def comb(self, a: int, b: int) -> int:
        return self.ids.setdefault(f"({a},{b})", len(self.ids))


def make_layout(F: int, nb: int, sms: int = SMS, kb: int = 0):
    """csrc/phase_scan.cu make_layout: (rows, L, kb)."""
    rows = R
    while rows < F and rows < SCAN_BLOCK:
        rows *= 2
    L = rows // R
    if kb <= 0:
        if L < 32:
            kb = MAX_THREADS // L
        else:
            kb = 4
            while kb > 1 and -(-nb // kb) < sms // 2 - 2:
                kb //= 2
    while kb * L > MAX_THREADS:
        kb //= 2
    return rows, L, kb


class Block:
    """One thread block of the kernel, its threads as lists indexed by
    threadIdx.x, the tree of thread_up ... thread_down over rows of ids."""

    def __init__(self, ex: Exprs, L: int, kb: int):
        self.ex, self.L, self.kb = ex, L, kb
        self.nt = L * kb
        self.b = [tid // L for tid in range(self.nt)]
        self.T = [tid % L for tid in range(self.nt)]
        self.t = [T & 31 for T in self.T]
        self.w = [T >> 5 for T in self.T]

    def comb(self, a, b):
        # Lanes whose value the kernel never reads hold None.
        return None if a is None or b is None else self.ex.comb(a, b)

    def shfl_up(self, x, d):
        """__shfl_up_sync over each warp: lane l reads lane l - d, or keeps
        its own value below d."""
        return [x[tid - d] if tid % 32 >= d else x[tid] for tid in range(self.nt)]

    def group_up(self, x, t, group):
        d = 1
        while d < group:
            y = self.shfl_up(x, d)
            x = [self.comb(y[i], x[i]) if ((t[i] + 1) & (2 * d - 1)) == 0 else x[i] for i in range(self.nt)]
            d *= 2
        return x

    def group_down(self, x, prev, has_prev, t, group):
        d = group // 2
        while d >= 1:
            y = self.shfl_up(x, d)
            y = [prev[i] if t[i] < d else y[i] for i in range(self.nt)]
            x = [self.comb(y[i], x[i])
                 if ((t[i] + 1) & (2 * d - 1)) == d and (t[i] + 1 > d or has_prev[i]) else x[i]
                 for i in range(self.nt)]
            d //= 2
        return x

    def tree(self, v, up_only):
        """tree_block: v[tid] is the thread's R rows. Returns (last, top)."""
        nt, L = self.nt, self.L
        for vi in v:  # thread_up
            s = 1
            while s < R:
                for r in range(2 * s - 1, R, 2 * s):
                    vi[r] = self.comb(vi[r - s], vi[r])
                s *= 2
        group, W = min(L, 32), L >> 5
        last = self.group_up([vi[R - 1] for vi in v], self.t, group)
        prev = [0] * nt
        top = None
        if W > 1:
            top = [None] * (self.kb * W)
            for i in range(nt):
                if self.t[i] == 31:
                    top[self.b[i] * W + self.w[i]] = last[i]
            # one warp a bin (w == 0) runs the tree of its warps' last rows
            x = [top[self.b[i] * W + self.t[i]] if self.w[i] == 0 and self.t[i] < W else
                 (0 if self.w[i] == 0 else None) for i in range(nt)]
            x = self.group_up(x, self.t, W)
            if not up_only:
                x = self.group_down(x, [0] * nt, [False] * nt, self.t, W)
            for i in range(nt):
                if self.w[i] == 0 and self.t[i] < W:
                    top[self.b[i] * W + self.t[i]] = x[i]
            if up_only:
                return last, top
            last = [top[self.b[i] * W + self.w[i]] if self.t[i] == 31 else last[i] for i in range(nt)]
            prev = [top[self.b[i] * W + self.w[i] - 1] if self.w[i] > 0 else 0 for i in range(nt)]
        if up_only:
            return last, top
        last = self.group_down(last, prev, [w > 0 for w in self.w], self.t, group)
        before = self.shfl_up(last, 1)
        before = [prev[i] if self.t[i] == 0 else before[i] for i in range(nt)]
        for i, vi in enumerate(v):  # thread_down
            vi[R - 1] = last[i]
            s = R // 2
            while s >= 1:
                if self.T[i] > 0:
                    vi[s - 1] = self.comb(before[i], vi[s - 1])
                for r in range(3 * s - 1, R, 2 * s):
                    vi[r] = self.comb(vi[r - s], vi[r])
                s //= 2
        return last, top


def serial_scan(ex: Exprs, col: list) -> None:
    """csrc/phase_scan.cu serial_scan over one bin's block totals."""
    n = len(col)
    s = 1
    while n // s >= 2:
        for i in range(n // s // 2):
            a, r = (2 * i + 1) * s - 1, (2 * i + 2) * s - 1
            col[r] = ex.comb(col[a], col[r])
        s *= 2
    top = 1
    while n // (2 * top) >= 2:
        top *= 2
    s = top
    while s >= 1:
        i = 1
        while 2 * i < n // s:
            a, r = 2 * i * s - 1, (2 * i + 1) * s - 1
            col[r] = ex.comb(col[a], col[r])
            i += 1
        s //= 2


def kernel_scan(ex: Exprs, leaves, nb: int):
    """The scanned rows (before the carry) of block 0's bins, as the kernel
    combines them: leaves[j][b] is row j's term of bin b (F rows, kb
    columns), rows past F are +0.0 (the identity)."""
    F = len(leaves)
    rows, L, kb = make_layout(F, nb)
    blk = Block(ex, L, kb)
    W = L >> 5
    blocks = -(-F // rows)

    def terms(r0):
        return [[leaves[r0 + R * blk.T[i] + r][blk.b[i]] if r0 + R * blk.T[i] + r < F else 0 for r in range(R)]
                for i in range(blk.nt)]

    totals = [[None] * kb for _ in range(blocks)]
    if blocks > 1:
        for q in range(blocks):
            last, top = blk.tree(terms(q * rows), up_only=True)
            for i in range(blk.nt):
                if blk.T[i] == L - 1:
                    totals[q][blk.b[i]] = top[blk.b[i] * W + W - 1] if W > 1 else last[i]
        for b in range(kb):
            col = [totals[q][b] for q in range(blocks)]
            serial_scan(ex, col)
            for q in range(blocks):
                totals[q][b] = col[q]
    out = [[None] * kb for _ in range(F)]
    for q in range(blocks):
        r0 = q * rows
        v = terms(r0)
        blk.tree(v, up_only=False)
        for i in range(blk.nt):
            b = blk.b[i]
            pre = totals[q - 1][b] if q > 0 else 0
            for r in range(R):
                j = r0 + R * blk.T[i] + r
                if j < F:
                    out[j][b] = ex.comb(pre, v[i][r]) if blocks > 1 else v[i][r]
    return out, kb


def reference_scan(ex: Exprs, leaves):
    """ops/phase.py blocked_scan with the recording combine, column-wise."""

    def fn(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.tensor([ex.comb(x, y) for x, y in zip(a.reshape(-1).tolist(), b.reshape(-1).tolist())],
                            dtype=torch.int64).reshape(a.shape)

    return T.blocked_scan(fn, torch.tensor(leaves, dtype=torch.int64)).tolist()


# The edges of the schedule: F below R, at and around powers of two (a
# thread's R rows, a warp's 32R, two and four warps), a partial segment,
# the 1024-row block and blocked_scan's two levels past it.
FRAMES = [1, 2, 3, 7, 8, 9, 31, 32, 33, 63, 64, 65, 255, 256, 257, 511, 512, 513,
          1000, 1023, 1024, 1025, 2500, 4096, 5121]


@pytest.mark.parametrize("F", FRAMES)
def test_kernel_schedule_combines_blocked_scans_operands(F):
    ex = Exprs()
    nb = 513
    kb = make_layout(F, nb)[2]
    leaves = [[ex.leaf(f"t{j}_{b}") for b in range(kb)] for j in range(F)]
    got, _ = kernel_scan(ex, leaves, nb)
    want = reference_scan(ex, leaves)
    assert got == want


@pytest.mark.parametrize("nb", [129, 2049])
def test_kernel_schedule_at_other_bin_counts(nb):
    # N = 256 and 4096: two and four bins a block at 1024 frames.
    ex = Exprs()
    kb = make_layout(1024, nb)[2]
    assert kb == {129: 2, 2049: 4}[nb]
    leaves = [[ex.leaf(f"t{j}_{b}") for b in range(kb)] for j in range(1024)]
    assert kernel_scan(ex, leaves, nb)[0] == reference_scan(ex, leaves)


def test_layout_fills_the_card():
    # 1024 frames at N = 256, 1024, 4096: four bins a block where that
    # leaves about half the SMs a block or more, at most kMaxThreads a
    # block.
    for nb, want in ((129, 2), (513, 4), (2049, 4)):
        rows, L, kb = make_layout(1024, nb)
        assert (rows, L, kb) == (1024, 128, want)
        assert -(-nb // kb) >= SMS // 2 - 2 and L * kb <= MAX_THREADS
    # Partial segments with bins of under a warp: kMaxThreads a block.
    for F in (1, 9, 100):
        rows, L, kb = make_layout(F, 513)
        assert rows >= F and L * kb == MAX_THREADS


def _mulmod(a, b, n):
    """csrc/phase_scan.cu mulmod in 32-bit unsigned integers."""
    if n <= 46340:
        assert a * b < 2 ** 32
        return a * b % n
    r = 0
    for bit in range(31, -1, -1):
        r = 2 * r - n if 2 * r >= n else 2 * r
        assert 2 * r < 2 ** 32 and r + a < 2 ** 32
        if (b >> bit) & 1:
            r = r + a - n if r + a >= n else r + a
    return r


def test_stepped_linear_phase_is_the_direct_product():
    # Every even N from 256 to 4096, a few Rs; each thread's R rows from
    # j0 (first rows, rows across the wrap of i at N, the last block's
    # rows), for every bin: lin steps by kr with one conditional
    # subtraction from mulmod((j0 + gmod) % N, kr, N), as the kernel does.
    rng = np.random.default_rng(0)
    for n in range(256, 4097, 2):
        nb = n // 2 + 1
        k = np.arange(nb, dtype=np.int64)
        gmod = int(rng.integers(0, n))
        j0s = np.array([0, R, (n - gmod) // R * R, 1016, 4088], dtype=np.int64)
        for rs in (1, 128, 171, n // 4 * 3, n - 1):
            rs_mod = rs % n
            kr = (k * rs_mod) % n
            assert kr.max() * (n - 1) < 2 ** 31  # 32-bit products: N * N < 2^31
            lin = (((j0s + gmod) % n)[:, None] * kr[None, :]) % n
            for r in range(R):
                i = (j0s + r + gmod) % n
                direct = (i[:, None] * kr[None, :]) % n
                assert np.array_equal(lin, direct), (n, rs, r)
                lin = lin + kr[None, :]
                lin = np.where(lin >= n, lin - n, lin)
    # The bin N/2's kr is pin_real_bins' (rs * (N/2)) mod N.
    for n in (256, 1000, 4096):
        for rs in (171, 384, 5000):
            assert (n // 2) * (rs % n) % n == rs * (n // 2) % n


@pytest.mark.parametrize("n", [46340, 46342, 65536, 1 << 20, (1 << 30) + 2])
def test_mulmod_past_32_bit_products(n):
    rng = np.random.default_rng(n)
    for a, b in [(n - 1, n - 1), (0, n - 1), (1, n - 1)] + [tuple(rng.integers(0, n, 2)) for _ in range(200)]:
        assert _mulmod(int(a), int(b), n) == int(a) * int(b) % n

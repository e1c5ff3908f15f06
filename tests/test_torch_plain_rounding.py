"""The plain phasor algebra of ops/fused.py rounds as IEEE arithmetic does,
so that its results (and the branch choices of q >= 2, which turn on the
last bits of a unit phasor) depend on its inputs alone: not on the host's
math library, the thread count or what the process ran before.

torch.sqrt of a CPU tensor is not correctly rounded (torch 2.13's CPU
build: about 0.7% of float32 results one ulp off), and now and then, in a
loaded process, a few of its results come out far less accurate (2 of
32,832 float64 results 2.4e-10 off, right when recomputed). The plain
versions take the square root from numpy on the CPU (ops/fused.py
_sqrt_rn), the processor's correctly rounded one, which the kernels'
sqrtf also gives. Bounds: bitwise (numpy's float32 sqrt and division are
IEEE).

The angle domain of the power z^k (general q, and q in {2, 4} under
set_q_algebraic(False)) takes atan2, cos and sin from numpy in float64,
rounded once to float32 (ops/fused.py _f64_rn): torch's CPU routines round
2-5% of float32 results otherwise, by the host's instruction set and by
an element's place in a thread's range. Bounds: bitwise against Python's
math module, element by element, and a slice against the whole.

test_single_route_at_half_is_a_fresh_processes holds the single route at
stretch 0.5 (q = 2, where a flipped branch in a quiet bin is a permanent
pi) to what a fresh one-thread process computes, after the in-process work
the chunked tests do before it (the chunked route on a world of one, other
thread counts): tests/test_torch_chunked.py compares against that route in
its pytest worker and its gloo workers compute in one-thread processes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.parallel import chunked
from tests.torch_dist import make_test_signal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def planes():
    """Float32 re/im planes over the magnitudes the phasor algebra sees:
    loud bins, quiet bins and bins at the 1e-30 floor (the first 16 of
    each row). Every product stays a normal float: a subnormal one would
    depend on the flush-to-zero mode of the thread that computes it, which
    is not what these tests hold."""
    g = np.random.default_rng(7)
    scale = 10.0 ** g.uniform(-14, 3, (64, 513))
    re = (g.standard_normal((64, 513)) * scale).astype(np.float32)
    im = (g.standard_normal((64, 513)) * scale).astype(np.float32)
    re[:, :8], im[:, :8] = 1e-16, -1e-16
    re[:, 8:16], im[:, 8:16] = 7e-16, 7e-16
    for v in (re, im):
        assert (v * v >= np.finfo(np.float32).tiny).all()
    return re, im


def test_plain_unit_phasor_is_correctly_rounded(planes):
    re, im = planes
    mag, ur, ui = fused._unit(torch.as_tensor(re), torch.as_tensor(im))
    n2 = re * re + im * im
    want = np.sqrt(n2)
    assert np.array_equal(mag.numpy(), want)
    safe = n2 > np.float32(1e-30)
    assert np.array_equal(ur.numpy()[safe], (re / want)[safe])
    assert np.array_equal(ui.numpy()[safe], (im / want)[safe])
    assert (ur.numpy()[~safe] == 1).all() and (ui.numpy()[~safe] == 0).all()


def test_plain_normalize_and_principal_sqrt_are_correctly_rounded(planes):
    re, im = planes
    r = np.sqrt(np.maximum(re * re + im * im, np.float32(1e-30)))
    nr, ni = fused._normalize(torch.as_tensor(re), torch.as_tensor(im))
    assert np.array_equal(nr.numpy(), re / r) and np.array_equal(ni.numpy(), im / r)
    zr, zi = (v.numpy() for v in fused._normalize(torch.as_tensor(re), torch.as_tensor(im)))
    wr, wi = fused._principal_sqrt(torch.as_tensor(zr), torch.as_tensor(zi))
    pos = np.sqrt(np.maximum(np.float32(0.5) * (np.float32(1) + zr), np.float32(0.25)))
    neg = np.sqrt(np.maximum(np.float32(0.5) * (np.float32(1) - zr), np.float32(0.25)))
    want_r = np.where(zr >= 0, pos, np.abs(zi) / (np.float32(2) * neg))
    want_i = np.where(zr >= 0, zi / (np.float32(2) * pos), np.where(zi >= 0, neg, -neg))
    assert np.array_equal(wr.numpy(), want_r) and np.array_equal(wi.numpy(), want_i)


@pytest.mark.parametrize("k", [0.5, 0.75, 2.5, float(np.float32(171 / 256))])
def test_plain_angle_domain_is_correctly_rounded(k, planes):
    """_angle_pow against math.atan2, math.cos and math.sin in float64,
    each rounded to float32, the product by k a float32 one; unit phasors
    of the planes, and the branch point (-1, +-0), which maps to +pi."""
    import math

    zr, zi = (v.numpy() for v in fused._normalize(*(torch.as_tensor(a) for a in planes)))
    zr, zi = zr[:, :129].copy(), zi[:, :129].copy()
    zr[0, :2], zi[0, :2] = -1.0, (0.0, -0.0)
    wr, wi = (v.numpy() for v in fused._angle_pow(torch.as_tensor(zr), torch.as_tensor(zi), k))
    k32 = np.float32(k)
    for (i, j) in np.ndindex(zr.shape):
        y = 0.0 if zi[i, j] == 0 else float(zi[i, j])
        ang = float(np.float32(math.atan2(y, float(zr[i, j]))) * k32)
        assert wr[i, j] == np.float32(math.cos(ang)) and wi[i, j] == np.float32(math.sin(ang)), (i, j)
    assert wr[0, 0] == wr[0, 1] and wi[0, 0] == wi[0, 1]
    # A result depends on its value alone, not on its place in the call.
    for sl in (np.s_[3:17, 5:100], np.s_[1:2, 7:8], np.s_[40:, :]):
        part = fused._angle_pow(torch.as_tensor(zr[sl]), torch.as_tensor(zi[sl]), k)
        assert np.array_equal(part[0].numpy(), wr[sl]) and np.array_equal(part[1].numpy(), wi[sl])


_FRESH = """
import sys, numpy as np, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
import phase_vocoder_tpu_torch as tpv
from tests.torch_dist import make_test_signal
np.save({out!r}, tpv.time_stretch(make_test_signal(4.0), 0.5, device="cpu").numpy())
"""


def test_single_route_at_half_is_a_fresh_processes(tmp_path):
    out = str(tmp_path / "fresh.npy")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", _FRESH.format(root=ROOT, out=out)], check=True,
                   env=env, cwd=ROOT, timeout=300)
    fresh = np.load(out)
    x4 = make_test_signal(4.0)
    threads = torch.get_num_threads()
    try:
        chunked.chunked_time_stretch(x4, 0.5, force=True, device="cpu")
        got = {}
        for n in (threads, 3, 1):
            torch.set_num_threads(n)
            got[n] = tpv.time_stretch(x4, 0.5, device="cpu").numpy()
    finally:
        torch.set_num_threads(threads)
    for n, y in got.items():
        diff = np.abs(y.astype(np.float64) - fresh).max()
        assert np.array_equal(y, fresh), json.dumps({"threads": n, "max_abs_diff": diff})


_FRESH_ANGLE = """
import sys, numpy as np, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch.ops import fused
from tests.torch_dist import make_test_signal
fused.set_q_algebraic(False)
np.save({out!r}, tpv.time_stretch(make_test_signal(4.0), 0.5, device="cpu").numpy())
"""


def test_angle_domain_at_half_is_a_fresh_process(tmp_path):
    """The single route at 0.5 under set_q_algebraic(False), in this
    process at several thread counts, against a fresh one-thread process."""
    out = str(tmp_path / "fresh.npy")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", _FRESH_ANGLE.format(root=ROOT, out=out)], check=True,
                   env=env, cwd=ROOT, timeout=300)
    fresh = np.load(out)
    x4 = make_test_signal(4.0)
    threads = torch.get_num_threads()
    fused.set_q_algebraic(False)
    try:
        got = {}
        for n in (threads, 3, 1):
            torch.set_num_threads(n)
            got[n] = tpv.time_stretch(x4, 0.5, device="cpu").numpy()
    finally:
        torch.set_num_threads(threads)
        fused.set_q_algebraic(True)
    for n, y in got.items():
        assert np.array_equal(y, fresh), json.dumps({"threads": n})

"""The port's phase ops (phase_vocoder_tpu_torch/ops/phase.py) against the
JAX package's (phase_vocoder_tpu/ops/phase.py) on the same float32 inputs.

Held bitwise (sign of zero included): both sides are the same sequence of
IEEE float32 additions, subtractions, multiplications and ceil, each
rounded once, and blocked_scan mirrors jax.lax.associative_scan's tree.
The one exception is the "cumsum" accumulation: torch's CPU cumsum
accumulates in float64 and rounds once, JAX's sums in float32, so the two
differ by a few float32 ulps of the running phase (bound stated there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase_vocoder_tpu.ops import phase as J
from phase_vocoder_tpu_torch.ops import phase as T

N = 1024


def assert_bitwise(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.view(np.int32), b.view(np.int32)), np.max(
        np.abs(a.astype(np.float64) - b)
    )


def _phases(rows, seed=0, bins=N // 2 + 1):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (rows, bins)).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    return (
        fn_j(*[jnp.asarray(a) for a in arrays], **kw),
        fn_t(*[torch.as_tensor(a) for a in arrays], **kw),
    )


def test_princarg_bitwise():
    g = np.random.default_rng(1)
    x = np.concatenate([
        (g.standard_normal(4000) * 30).astype(np.float32),
        np.float32([np.pi, -np.pi, 3 * np.pi, 0.0, -0.0, 2 * np.pi, 1e-30]),
    ])
    assert_bitwise(*_both(J.princarg, T.princarg, x))


@pytest.mark.parametrize("ra", [256, 200, 300, 64])
def test_het_split_bitwise(ra):
    jh, jl = J._het_split(ra, N, N // 2 + 1)
    th, tl = T._het_split(ra, N, N // 2 + 1)
    assert_bitwise(jh, th)
    assert_bitwise(jl, tl)


def test_heterodyne_increment_bitwise():
    phi = _phases(300)
    assert_bitwise(*_both(lambda p: J.heterodyne_increment(p, 256, N),
                          lambda p: T.heterodyne_increment(p, 256, N), phi))


def test_instantaneous_frequency_bitwise():
    dphi = _phases(50, seed=3)
    assert_bitwise(*_both(lambda d: J.instantaneous_frequency(d, 256, N),
                          lambda d: T.instantaneous_frequency(d, 256, N), dphi))


# (ra, rs): stretch 0.5 / -7 st / 2.0 / 1.5, and hops that are not powers
# of two (the Dekker split's k_err residue is nonzero there).
RATIOS = [(256, 128), (256, 171), (256, 512), (256, 384), (200, 137), (300, 451)]


@pytest.mark.parametrize("ra,rs", RATIOS)
def test_residual_terms_c_bitwise(ra, rs):
    phi = _phases(400, seed=ra + rs)
    jh, jl = J.residual_terms_c(jnp.asarray(phi), ra, rs, N)
    th, tl = T.residual_terms_c(torch.as_tensor(phi), ra, rs, N)
    assert_bitwise(jh, th)
    assert_bitwise(jl, tl)


@pytest.mark.parametrize("ra,rs", RATIOS)
def test_scale_pair_bitwise(ra, rs):
    g = np.random.default_rng(7)
    h = g.uniform(-np.pi, np.pi, 5000).astype(np.float32)
    l = (g.standard_normal(5000) * 1e-8).astype(np.float32)
    jp, jl = J._scale_pair(rs, ra, jnp.asarray(h), jnp.asarray(l))
    tp, tl = T._scale_pair(rs, ra, torch.as_tensor(h), torch.as_tensor(l))
    assert_bitwise(jp, tp)
    assert_bitwise(jl, tl)


def test_wrap_add_c_bitwise():
    g = np.random.default_rng(5)
    a = (g.uniform(-np.pi, np.pi, 4000).astype(np.float32),
         (g.standard_normal(4000) * 1e-7).astype(np.float32))
    b = (g.uniform(-np.pi, np.pi, 4000).astype(np.float32),
         (g.standard_normal(4000) * 1e-7).astype(np.float32))
    j = J.wrap_add_c(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    t = T.wrap_add_c(tuple(map(torch.as_tensor, a)), tuple(map(torch.as_tensor, b)))
    assert_bitwise(j[0], t[0])
    assert_bitwise(j[1], t[1])


@pytest.mark.parametrize("offset", [0, 5, 1023, 41_249])
def test_linear_phase_term_bitwise(offset):
    j = J.linear_phase_term(37, N // 2 + 1, 171, N, frame_offset=offset)
    t = T.linear_phase_term(37, N // 2 + 1, 171, N, frame_offset=offset)
    assert_bitwise(j, t)


def test_finalize_phase_bitwise():
    phi0 = _phases(1, seed=8)[0]
    residual = _phases(64, seed=9)
    assert_bitwise(*_both(lambda p, r: J.finalize_phase(p, r, 128, N, frame_offset=77),
                          lambda p, r: T.finalize_phase(p, r, 128, N, frame_offset=77),
                          phi0, residual))


@pytest.mark.parametrize("rs,offset", [(128, 0), (171, 3), (171, 1021), (384, 9)])
def test_pin_real_bins_bitwise(rs, offset):
    psi, phi = _phases(40, seed=10), _phases(40, seed=11)
    assert_bitwise(*_both(lambda a, b: J.pin_real_bins(a, b, rs, N, offset),
                          lambda a, b: T.pin_real_bins(a, b, rs, N, offset), psi, phi))


@pytest.mark.parametrize("n", [1, 7, 1024, 1500])
def test_blocked_scan_bitwise(n):
    """The compensated pair scan over both block levels (<= 1024 rows: one
    power-of-two scan; 1500: two blocks, the totals' scan and the prefix)."""
    phi = _phases(n + 1, seed=n)
    jh, jl = J.residual_terms_c(jnp.asarray(phi), 256, 171, N)
    th, tl = T.residual_terms_c(torch.as_tensor(phi), 256, 171, N)
    j = J.blocked_scan(J.wrap_add_c, (jh, jl))
    t = T.blocked_scan(T.wrap_add_c, (th, tl))
    assert_bitwise(j[0], t[0])
    assert_bitwise(j[1], t[1])


@pytest.mark.parametrize("n", [7, 1500])
def test_blocked_scan_single_tensor_bitwise(n):
    terms = _phases(n, seed=20)
    j = J.blocked_scan(J.wrap_add, jnp.asarray(terms))
    t = T.blocked_scan(T.wrap_add, torch.as_tensor(terms))
    assert_bitwise(j, t)


def test_accumulate_phase_residual_bitwise():
    dphi = _phases(300, seed=21)
    assert_bitwise(*_both(lambda d: J.accumulate_phase_residual(d, 256, 128),
                          lambda d: T.accumulate_phase_residual(d, 256, 128), dphi))


@pytest.mark.parametrize("method", ["wrapped_scan", "cumsum"])
@pytest.mark.parametrize("n", [1, 7, 1024, 1500])
def test_accumulate_phase(method, n):
    """n terms (n+1 frames; the shapes of test_blocked_scan_bitwise, whose
    JAX primitives are then compiled already). wrapped_scan bitwise.
    cumsum: JAX sums in float32, torch's CPU cumsum in float64, so they
    differ by the float32 rounding of the running sum; bound 16 ulps of the
    largest |psi| (2 ulps measured at 1501 frames)."""
    phi = _phases(n + 1, seed=30 + n)
    j = J.accumulate_phase(jnp.asarray(phi), J.heterodyne_increment(jnp.asarray(phi), 256, N),
                           256, 171, N, method=method, frame_offset=5)
    t = T.accumulate_phase(torch.as_tensor(phi), T.heterodyne_increment(torch.as_tensor(phi), 256, N),
                           256, 171, N, method=method, frame_offset=5)
    if method == "wrapped_scan":
        assert_bitwise(j, t)
    else:
        j, t = np.asarray(j, np.float64), t.numpy().astype(np.float64)
        ulp = np.spacing(np.float32(np.max(np.abs(j))))
        assert np.max(np.abs(j - t)) <= 16 * ulp


def test_accumulate_phase_unknown_method():
    phi = torch.zeros((4, N // 2 + 1))
    with pytest.raises(ValueError):
        T.accumulate_phase(phi, phi[1:], 256, 128, N, method="bogus")


def test_pair_helpers():
    h, l = T.zero_pair(5)
    assert torch.equal(h, torch.zeros(5)) and torch.equal(l, torch.zeros(5))
    assert torch.equal(T.pair_value((torch.ones(3), torch.full((3,), 0.5))), torch.full((3,), 1.5))

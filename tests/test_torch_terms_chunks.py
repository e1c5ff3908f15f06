"""The phasor terms at the edges of the 64-frame chunks that the port's
pvoc_terms passes walk (csrc/pvoc_fused.cu: terms_chunks makes the terms
and their in-chunk products, scan_carry_staged chains the chunk totals,
scan_apply_chunks applies the carries), on the CPU through the plain
versions, against the JAX package's stft_phasor_terms and
stft_phasor_terms_batch (their Pallas kernels in interpret mode), and the
carry contract of the plain prefix product that the carry scan keeps.

Inputs are made with numpy from a seed. Bounds, as
tests/test_torch_general_hop.py holds the same functions:
  * |X| within 2e-6 of JAX's max |X| (torch.fft against the JAX kernel's
    matrix DFT);
  * the phasors (u, the step terms, the scanned P) within 1e-4 once
    weighted by |X| / max |X| (the phase of a near-silent bin is
    ill-conditioned in both packages; the synthesis sees |X| P);
  * the scanned P of unit modulus within 1e-6;
  * the prefix product split at a chunk boundary with its carry passed on:
    bitwise the one call (every operation is the same, in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase_vocoder_tpu.ops.pallas import fused as jfused
from phase_vocoder_tpu_torch.ops import fused
from tests.conftest import make_test_signal

N, RA = 1024, 256
NB = N // 2 + 1
CHUNK = fused.SCAN_CHUNK


def _signal(frames: int, seed: int = 0) -> np.ndarray:
    """float32 chirp + tone + noise holding exactly `frames` frames."""
    n = (frames - 1) * RA + N
    return make_test_signal(n / 16000 + 0.01, seed=seed)[:n].astype(np.float32)


def _check_planes(t_planes, j_planes, scan: bool) -> None:
    """(mag, pre, pim, ure, uim) of the port against JAX's, both (nf, NB)."""
    tm, tpre, tpim, ture, tuim = t_planes
    jm, jpre, jpim, jure, juim = j_planes
    top = np.abs(jm).max()
    assert np.abs(tm - jm).max() / top <= 2e-6
    weight = jm / top
    for (ar, ai), (br, bi) in (((tpre, tpim), (jpre, jpim)), ((ture, tuim), (jure, juim))):
        assert (np.abs((ar + 1j * ai) - (br + 1j * bi)) * weight).max() <= 1e-4
    if scan:
        assert np.abs(np.hypot(tpre, tpim) - 1).max() < 1e-6


@pytest.mark.parametrize("frames", [1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1])
@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("rs", [768, 640])  # k = 3; k = 5/2 (q = 2)
def test_terms_at_chunk_edges_vs_jax(rs, scan, frames):
    x = _signal(frames)
    j = jfused.stft_phasor_terms(jnp.asarray(x), N, RA, rs, scan=scan, return_u=True)
    assert j[-1] == frames
    t = fused.stft_phasor_terms(torch.as_tensor(x), N, RA, rs, scan=scan, return_u=True)
    assert t[-1] == frames
    assert all(a.shape == (frames, NB) for a in t[:5])
    _check_planes([a.numpy() for a in t[:5]], [np.asarray(a)[:frames, :NB] for a in j[:5]], scan)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("rs", [768, 640])
def test_terms_batch_of_three_vs_jax(rs, scan):
    """Three rows of unequal content (seeds 1-3), 2 chunks and a part:
    each row against JAX's batched kernel, and bitwise the port's
    single-recording call on that row."""
    frames = 2 * CHUNK + 7
    xs = np.stack([_signal(frames, seed=s) for s in (1, 2, 3)])
    j = jfused.stft_phasor_terms_batch(jnp.asarray(xs), N, RA, rs, scan=scan, return_u=True)
    t = fused.stft_phasor_terms_batch(torch.as_tensor(xs), N, RA, rs, scan=scan, return_u=True)
    assert t[-1] == frames and j[-1] == frames
    for b in range(3):
        _check_planes([a[b].numpy() for a in t[:5]], [np.asarray(a)[b, :frames, :NB] for a in j[:5]], scan)
        one = fused.stft_phasor_terms(torch.as_tensor(xs[b]), N, RA, rs, scan=scan, return_u=True)
        assert all(torch.equal(a[b], o) for a, o in zip(t[:5], one[:5]))


@pytest.mark.parametrize("split", [CHUNK, 2 * CHUNK])
@pytest.mark.parametrize("frames", [2 * CHUNK + 1, 200, 5 * CHUNK])
def test_prefix_product_carry_split(frames, split):
    """_chunked_prefix_product over frames [0, split) and then
    [split, frames) from the first call's running carry equals one call
    over [0, frames), bit for bit, running carry included: the contract
    that scan_carry_staged keeps (the chain of chunk totals in order, from
    the carry passed in)."""
    g = np.random.default_rng(frames + split)
    ang = g.uniform(-np.pi, np.pi, (frames, NB))
    amp = g.uniform(0.5, 1.5, (frames, NB))  # the chunk totals renormalize
    tre = torch.as_tensor((amp * np.cos(ang)).astype(np.float32))
    tim = torch.as_tensor((amp * np.sin(ang)).astype(np.float32))
    pre, pim, (cre, cim) = fused._chunked_prefix_product(tre, tim)
    pre0, pim0, carry0 = fused._chunked_prefix_product(tre[:split], tim[:split])
    pre1, pim1, (cre1, cim1) = fused._chunked_prefix_product(tre[split:], tim[split:], carry=carry0)
    assert torch.equal(torch.cat([pre0, pre1]), pre)
    assert torch.equal(torch.cat([pim0, pim1]), pim)
    assert torch.equal(cre1, cre) and torch.equal(cim1, cim)

"""The port's static tables, phasor algebra and framing against the JAX
package's.

The phase vocoder has no learned weights; its parameters are the tables
both packages build in float64 and cast to float32. Equal formulas give
bitwise-equal tables, which is how the parameters carry across.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from golden import pv_ref
from phase_vocoder_tpu.ops import framing as jframing
from phase_vocoder_tpu.ops.pallas import fused as jfused
from phase_vocoder_tpu.ops.window import hann_window as jax_hann
from phase_vocoder_tpu_torch.ops import framing as tframing
from phase_vocoder_tpu_torch.ops import fused as tfused
from phase_vocoder_tpu_torch.ops.window import hann_window

ULP1 = float(np.spacing(np.float32(1.0)))  # 2^-23


@pytest.mark.parametrize("n", [512, 1024, 2048])
def test_hann_bitwise(n):
    assert np.array_equal(hann_window(n).numpy(), np.asarray(jax_hann(n)))


@pytest.mark.parametrize("n", [512, 1024])
def test_fft_table_window_is_the_hann_window(n):
    tab = tfused._fft_tables(n)
    assert tab.shape == (2 * n,)
    assert np.array_equal(tab[:n], hann_window(n).numpy())


@pytest.mark.parametrize("rs", [128, 171, 256, 384, 512])
def test_ola_norm_rows_bitwise(rs):
    """Head rows, tail rows and the interior row equal _ola_norm_tables."""
    n_fft = 1024
    m = -(-n_fft // rs)
    head, tail_inv = jfused._ola_norm_tables(n_fft, rs)
    rows = tfused._norm_rows(n_fft, rs, nf=1000)
    assert rows.shape == (2 * m - 1, rs)
    assert np.array_equal(rows[: m - 1], head[: m - 1])
    assert np.array_equal(rows[m - 1 : 2 * m - 2], tail_inv)
    assert np.array_equal(rows[2 * m - 2], head[m - 1])


@pytest.mark.parametrize("nf", [1, 2, 3, 6])
def test_ola_norm_rows_short_input_exact(nf):
    """With fewer frames than the overlap, each output row gets the window
    energy of the frames that really cover it (the golden model's norm)."""
    n_fft, rs = 1024, 128
    m = n_fft // rs
    w = pv_ref.hann_window(n_fft)
    energy = pv_ref.overlap_add(np.broadcast_to(w * w, (nf, n_fft)).copy(), rs)
    want = 1.0 / np.maximum(energy, 1e-8)
    rows = tfused._norm_rows(n_fft, rs, nf)
    idx = np.full(nf + m - 1, 2 * m - 2)
    idx[: min(m - 1, nf)] = np.arange(min(m - 1, nf))
    idx[nf:] = np.arange(m - 1, 2 * m - 2)
    got = rows[idx].reshape(-1)[: len(want)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("rs", [128, 171, 256, 384, 512])
def test_phasor_consts_bitwise(rs):
    n_fft, ra = 1024, 256
    want = np.concatenate(jfused._phasor_consts_packed(n_fft, ra, rs))[:, : n_fft // 2]
    assert np.array_equal(tfused._phasor_consts(n_fft, ra, rs), want)


@pytest.fixture(scope="module")
def unit_phasors():
    """Random unit phasors plus the branch points zre = +-1 with zim = +-0."""
    g = np.random.default_rng(0)
    th = g.uniform(-np.pi, np.pi, 20000)
    zre = np.concatenate([np.cos(th), [-1, -1, 1, 1, 0, 0]]).astype(np.float32)
    zim = np.concatenate([np.sin(th), [0.0, -0.0, 0.0, -0.0, 1, -1]]).astype(np.float32)
    return zre, zim


def _max_diff(jax_pair, torch_pair):
    return max(
        float(np.max(np.abs(np.asarray(a, np.float64) - b.numpy().astype(np.float64))))
        for a, b in zip(jax_pair, torch_pair)
    )


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_int_pow_matches_jax(k, unit_phasors):
    zre, zim = unit_phasors
    d = _max_diff(
        jfused._int_pow(jnp.asarray(zre), jnp.asarray(zim), k),
        tfused._int_pow(torch.as_tensor(zre), torch.as_tensor(zim), k),
    )
    assert d <= 2 * ULP1, d


def test_principal_sqrt_matches_jax(unit_phasors):
    zre, zim = unit_phasors
    d = _max_diff(
        jfused._principal_sqrt(jnp.asarray(zre), jnp.asarray(zim)),
        tfused._principal_sqrt(torch.as_tensor(zre), torch.as_tensor(zim)),
    )
    assert d <= 2 * ULP1, d
    # zre = -1 with zim = +-0 is princarg = +pi either way: the root is +i.
    wre, wim = tfused._principal_sqrt(torch.tensor([-1.0, -1.0]), torch.tensor([0.0, -0.0]))
    assert wre.abs().max() == 0 and wim.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("rs", [512, 1024, 128, 64, 192, 384, 171, 342, 121, 2304])
def test_pow_k_matches_jax(rs, unit_phasors):
    """2 ulp where the result is one rounding from the input (integer k,
    a single principal root). A p-th power of a root multiplies the root's
    difference by p; the angle domain multiplies the ~2 ulp(pi) difference
    between torch.atan2 and the JAX package's Cephes _atan2 by k."""
    zre, zim = unit_phasors
    p, q = tfused._rational_k(rs, 256)
    if tfused._pow_alg(p, q):
        tol = 2 * ULP1 * p
    else:
        tol = 2 * ULP1 * (1 + 2 * p / q)
    d = _max_diff(
        jfused._pow_k(jnp.asarray(zre), jnp.asarray(zim), rs, 256),
        tfused._pow_k(torch.as_tensor(zre), torch.as_tensor(zim), rs, 256),
    )
    assert d <= tol, (d, tol)


def test_pow_k_branch_point_maps_to_plus_pi():
    """Angle domain: zim = -0 at zre = -1 counts as princarg = +pi."""
    k = 171 / 256
    wre, wim = tfused._pow_k(torch.tensor([-1.0, -1.0]), torch.tensor([0.0, -0.0]), 171, 256)
    want = np.float32(np.pi) * np.float32(k)
    np.testing.assert_allclose(wre.numpy(), np.cos([want, want]), atol=2 * ULP1)
    np.testing.assert_allclose(wim.numpy(), np.sin([want, want]), atol=2 * ULP1)


# ------------------------------------------------------------------ framing


@pytest.mark.parametrize("hop", [128, 171, 256, 512])
def test_framing_matches_jax(hop):
    """frame_signal exactly, fold overlap_add and ola_window_norm to f32
    rounding (the two sum the same terms in a different order)."""
    n_fft = 1024
    x = np.random.default_rng(hop).standard_normal(9000).astype(np.float32)
    nf = tframing.num_frames(len(x), n_fft, hop)
    assert nf == jframing.num_frames(len(x), n_fft, hop)
    assert tframing.output_length(nf, n_fft, hop) == jframing.output_length(nf, n_fft, hop)
    frames = tframing.frame_signal(torch.as_tensor(x), n_fft, hop)
    assert np.array_equal(frames.numpy(), np.asarray(jframing.frame_signal(jnp.asarray(x), n_fft, hop)))
    ola = tframing.overlap_add(frames, hop).numpy()
    want = np.asarray(jframing.overlap_add(jnp.asarray(frames.numpy()), hop, method="fold"))
    np.testing.assert_allclose(ola, want, rtol=1e-6, atol=1e-5)
    norm = tframing.ola_window_norm(hann_window(n_fft), nf, hop).numpy()
    want = np.asarray(jframing.ola_window_norm(jax_hann(n_fft), nf, hop))
    np.testing.assert_allclose(norm, want, rtol=1e-6, atol=0)


def test_framing_empty():
    x = torch.zeros(100)
    assert tframing.num_frames(100, 1024, 256) == 0
    assert tframing.frame_signal(x, 1024, 256).shape == (0, 1024)
    assert tframing.overlap_add(torch.zeros(0, 1024), 256).shape == (0,)

"""The general-hop route at integer k (ops.fused.phasor_general_closed): at
q = 1 and Rs > N/2, where closed_in_synth holds, the step terms
c (u_i conj u_{i-1} h)^k are (u_i conj u_{i-1})^k (c h^k = 1), so the
renormalized prefix product telescopes to the closed form
P_i = u_0 (u_i conj u_0)^k, and the fused TSM's passes run the route.

On the CPU, through the plain versions:
  * identity: the wrapper against the terms-plus-scan chain it replaces
    (stft_phasor_terms_reference, then phasor_synth_general_reference),
    at N = 1024, Ra = 256, Rs = 768, 1024, 1280 (k = 3, 4, 5; m = 2, 1, 1)
    and N = 512, Ra = 128, Rs = 384, within 1e-5 interior relative
    (measured 1.2e-6 to 2.2e-6 on 2 s);
  * parity: against the float64 golden model within 1e-4 and against the
    JAX package's phasor_general_stretch (its kernels in interpret mode)
    within 5e-5, on the samples whose window energy is at least 1e-2. At
    Rs >= N a sample near a frame's edge has one frame's tiny w^2 as its
    energy, and 1/energy lifts both packages' rounding there (5.4e-5 on
    the whole interior at Rs = 1024, for the old chain as for this one);
  * dispatch: pipeline.phasor_general_stretch takes the wrapper exactly
    where closed_in_synth(n_fft, q) holds, and stft_phasor_terms
    everywhere else (q >= 2, an N outside real_body); the route choice
    and phasor_supported do not move.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu as jpv
from phase_vocoder_tpu import pipeline as jpipeline
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import pipeline
from phase_vocoder_tpu_torch.ops import framing, fused
from phase_vocoder_tpu_torch.ops.window import hann_window
from tests.conftest import make_test_signal

# (n_fft, hop, rs): k = 3, 4, 5 at N = 1024 (m = 2, 1, 1), k = 3 at N = 512.
CLOSED = [(1024, 256, 768), (1024, 256, 1024), (1024, 256, 1280), (512, 128, 384)]


@pytest.fixture(scope="module")
def x2():
    return make_test_signal(2.0).astype(np.float32)


def _rel(a, b, edge, held=None):
    """Interior max |a - b| / max |b|, over the samples `held` marks."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d, r = np.abs(a - b), np.abs(b)
    if held is not None:
        d, r = np.where(held, d, 0.0), np.where(held, r, 0.0)
    sl = slice(edge, len(a) - edge)
    return d[sl].max() / r[sl].max()


def _held(n_fft: int, rs: int, nf: int, length: int) -> np.ndarray:
    """The samples whose window energy (the fold of w^2, float64) is at
    least 1e-2."""
    w = hann_window(n_fft, "cpu", torch.float64)
    energy = framing.ola_window_norm(w, nf, rs, eps=0.0, method="fold").numpy()
    return energy[:length] >= 1e-2


@pytest.mark.parametrize("n_fft,hop,rs", CLOSED)
def test_closed_form_is_the_terms_chain(n_fft, hop, rs, x2):
    x = torch.as_tensor(x2)
    y = fused.phasor_general_closed(x, n_fft, hop, rs)
    assert torch.equal(y, fused.phasor_general_closed_reference(x, n_fft, hop, rs))
    mag, pre, pim, nf = fused.stft_phasor_terms_reference(x, n_fft, hop, rs)
    chain = fused.phasor_synth_general_reference(mag, pre, pim, n_fft, rs, nf)
    assert y.shape == chain.shape == ((nf - 1) * rs + n_fft,)
    assert _rel(y, chain, n_fft) <= 1e-5
    if rs > n_fft:  # the gaps between frames stay silent
        assert not y[n_fft:rs].any()


@pytest.mark.parametrize("n_fft,hop,rs", CLOSED)
def test_closed_route_vs_golden_and_jax(n_fft, hop, rs, x2):
    cfg = tpv.PvocConfig(n_fft=n_fft, hop=hop)
    y = pipeline.phasor_general_stretch(torch.as_tensor(x2), cfg, rs).numpy()
    nf = framing.num_frames(len(x2), n_fft, hop)
    held = _held(n_fft, rs, nf, len(y))
    ref = pv_ref.phase_vocoder(x2, rs / hop, n_fft, hop)
    assert _rel(y, ref, n_fft, held) < 1e-4
    jcfg = jpv.PvocConfig(n_fft=n_fft, hop=hop, fft_backend="pallas")
    j = np.asarray(jpipeline.phasor_general_stretch(jnp.asarray(x2), jcfg, rs))
    assert _rel(y, j, n_fft, held) <= 5e-5


@pytest.fixture
def entries(monkeypatch):
    """Record which entry phasor_general_stretch calls, computing nothing."""
    calls = []

    def closed(x, n_fft, hop, rs):
        calls.append("closed")
        return x

    def terms(x, n_fft, hop, rs, scan=True):
        calls.append("terms")
        return x, x, x, 1

    monkeypatch.setattr(pipeline, "phasor_general_closed", closed)
    monkeypatch.setattr(pipeline, "stft_phasor_terms", terms)
    monkeypatch.setattr(pipeline, "phasor_synth_general", lambda *a: a[0])
    return calls


@pytest.mark.parametrize(
    "n_fft,hop,rs",
    CLOSED + [
        (1024, 256, 640),  # 2.5x, q = 2
        (1024, 256, 767),  # +19 st, q = 256
        (4096, 1024, 3072),  # k = 3 at the largest real_body N
        (256, 64, 512),  # k = 8, m = 1
        (768, 192, 576),  # k = 3, N not a power of two
        (128, 32, 96),  # k = 3, N below real_body
    ],
)
def test_general_route_takes_the_closed_form_where_it_holds(entries, n_fft, hop, rs):
    cfg = tpv.PvocConfig(n_fft=n_fft, hop=hop)
    assert pipeline.phasor_general_ok(cfg, rs)
    pipeline.phasor_general_stretch(torch.zeros(4 * n_fft), cfg, rs)
    q = fused._rational_k(rs, hop)[1]
    assert entries == ["closed" if fused.closed_in_synth(n_fft, q) else "terms"]


def test_routing_above_half_n_is_unchanged(entries):
    """3.0x is still the general route, as in the JAX package; the fused
    kernel's geometry still ends at N/2; time_stretch at 3.0x reaches the
    closed form through that route, at 2.5x the terms."""
    cfg = tpv.PvocConfig()
    assert pipeline._route(cfg, 768, 1000, "auto") == "general"
    jcfg = jpv.PvocConfig(fft_backend="pallas")
    assert not jpipeline.fused_ok(jcfg, 768) and jpipeline.phasor_general_ok(jcfg, 768)
    assert not fused.phasor_supported(1024, 256, 768) and not pipeline.fused_ok(cfg, 768)
    assert fused.phasor_supported(1024, 256, 512)
    x = torch.zeros(16000)
    tpv.time_stretch(x, 3.0, device="cpu")
    tpv.time_stretch(x, 2.5, device="cpu")
    assert entries == ["closed", "terms"]


@pytest.mark.parametrize("n_fft,hop,rs", [(1024, 256, 512), (1024, 256, 640), (768, 192, 576),
                                          (1024, 300, 900), (8192, 2048, 6144)])
def test_rejects_what_it_does_not_take(n_fft, hop, rs):
    """Rs <= N/2 is the fused route's; q >= 2, an N outside real_body and
    hop not dividing N take the terms."""
    with pytest.raises(ValueError, match="phasor_general_closed requires"):
        fused.phasor_general_closed(torch.zeros(4 * n_fft), n_fft, hop, rs)

"""The branch-faithful stream's segment phase (ops/phase.py
segment_phase_reference, the plain version of csrc/phase_scan.cu's
segment_phase kernel) and segment_step's cached window norm, on the CPU.

Held bitwise through an int32 view, so that signed zeros count:
  * segment_phase_reference against the composition that segment_step
    ran inline before it (kept here as the oracle), at F = 1 to 2500
    frames (both sides of blocked_scan's 1024-row block), full and
    partial segments, first and mid-stream;
  * against the JAX package's phase functions composed as
    phase_vocoder_tpu/streaming.py:115-127 composes them, called eagerly
    (tests/test_torch_phase.py holds each piece bitwise);
  * whole CPU streams through segment_step against streams through the
    oracle step, at 0.5x and -7 st;
  * the cached all-valid window norm against ola_window_norm.
The kernel itself runs on the card only (chip_smoke.py, phase 2f).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase_vocoder_tpu.ops import phase as J
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import pipeline, streaming
from phase_vocoder_tpu_torch.ops import fft as fft_ops
from phase_vocoder_tpu_torch.ops import framing
from phase_vocoder_tpu_torch.ops import phase as T
from phase_vocoder_tpu_torch.ops.stft import istft_ola
from phase_vocoder_tpu_torch.ops.window import hann_window
from phase_vocoder_tpu_torch.utils import profiling
from tests.conftest import make_test_signal

CFG = tpv.PvocConfig()


def assert_bitwise(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = a.view(np.int32) != b.view(np.int32)
    assert not diff.any(), (int(diff.sum()), np.argwhere(diff)[:5])


def _inline_oracle(phi, phi_prev, carry_hi, carry_lo, phi0, *, ra, rs, n_fft,
                   frame_offset, n_valid, started):
    """The phase chain segment_step ran inline before segment_phase
    existed, verbatim."""
    F, g, dtype, dev = phi.shape[0], frame_offset, phi.dtype, phi.device
    phi_ext = torch.cat([phi_prev[None, :], phi])  # (F+1, nb)
    th, tl = T.residual_terms_c(phi_ext, ra, rs, n_fft)
    j = torch.arange(F, device=dev)
    valid_term = ((j < n_valid) & ((g + j) > 0))[:, None].to(dtype)
    th, tl = th * valid_term, tl * valid_term
    incl = T.blocked_scan(T.wrap_add_c, (th, tl))
    res_h, res_l = T.wrap_add_c((carry_hi[None, :], carry_lo[None, :]), incl)
    residual = res_h + res_l
    phi0 = phi0 if started else phi[0]
    psi = T.finalize_phase(phi0, residual, rs, n_fft, frame_offset=g)
    psi = T.pin_real_bins(psi, phi, rs, n_fft, frame_offset=g)
    return psi, res_h[-1], res_l[-1]


def _inputs(n_fft, F, mid, seed=0):
    """Seeded phases (F, nb) and a state: zeros for the first segment, a
    wrapped carry with a small lo word mid-stream."""
    g = np.random.default_rng(seed)
    nb = n_fft // 2 + 1
    u = lambda *s: g.uniform(-np.pi, np.pi, s).astype(np.float32)  # noqa: E731
    phi, phi_prev, phi0 = u(F, nb), u(nb), u(nb)
    if mid:
        carry_hi, carry_lo = u(nb), (g.standard_normal(nb) * 1e-7).astype(np.float32)
    else:
        carry_hi = carry_lo = np.zeros(nb, np.float32)
    return phi, phi_prev, carry_hi, carry_lo, phi0


def _kw(n_fft, rs, F, mid):
    # Mid-stream: a partial segment (the stream's last) at an offset past
    # a few FFT periods; first: frame 0, nothing started, all frames real.
    return dict(ra=n_fft // 4, rs=rs, n_fft=n_fft, frame_offset=3 * n_fft + 5 if mid else 0,
                n_valid=max(F - 3, 1) if mid else F, started=mid)


GEOMS = [(256, 128), (256, 171), (1024, 128), (1024, 171), (1024, 384)]


@pytest.mark.parametrize("F", [1, 7, 1000, 1024, 1025, 2500])
@pytest.mark.parametrize("n_fft,rs", GEOMS)
def test_reference_is_the_inline_chain_bitwise(n_fft, rs, F):
    for mid in (False, True):
        arrays = [torch.as_tensor(a) for a in _inputs(n_fft, F, mid, seed=F + rs)]
        kw = _kw(n_fft, rs, F, mid)
        for got, want in zip(T.segment_phase_reference(*arrays, **kw), _inline_oracle(*arrays, **kw)):
            assert_bitwise(got, want)


def test_reference_segment_of_padding_frames():
    """n_valid = 0 (every term masked: a negative term multiplied by 0.0
    is -0.0, as in the inline chain) from a zero carry."""
    n_fft, F = 256, 5
    phi, phi_prev, _, _, phi0 = (torch.as_tensor(a) for a in _inputs(n_fft, F, True, seed=3))
    z = torch.zeros(n_fft // 2 + 1)
    kw = dict(ra=64, rs=128, n_fft=n_fft, frame_offset=40, n_valid=0, started=True)
    got = T.segment_phase_reference(phi, phi_prev, z, z, phi0, **kw)
    for a, b in zip(got, _inline_oracle(phi, phi_prev, z, z, phi0, **kw)):
        assert_bitwise(a, b)


def _jax_chain(phi, phi_prev, carry_hi, carry_lo, phi0, *, ra, rs, n_fft, frame_offset,
               n_valid, started):
    """phase_vocoder_tpu/streaming.py:115-127, eagerly, on numpy inputs."""
    F, g = phi.shape[0], frame_offset
    phi_ext = jnp.concatenate([jnp.asarray(phi_prev)[None, :], jnp.asarray(phi)])
    th, tl = J.residual_terms_c(phi_ext, ra, rs, n_fft)
    j = jnp.arange(F)
    valid_term = ((j < n_valid) & ((g + j) > 0))[:, None].astype(jnp.float32)
    th, tl = th * valid_term, tl * valid_term
    incl = J.blocked_scan(J.wrap_add_c, (th, tl))
    res_h, res_l = J.wrap_add_c((jnp.asarray(carry_hi)[None, :], jnp.asarray(carry_lo)[None, :]), incl)
    residual = res_h + res_l
    phi0 = jnp.asarray(phi0) if started else jnp.asarray(phi)[0]
    psi = J.finalize_phase(phi0, residual, rs, n_fft, frame_offset=g)
    psi = J.pin_real_bins(psi, jnp.asarray(phi), rs, n_fft, frame_offset=g)
    return psi, res_h[-1], res_l[-1]


@pytest.mark.parametrize("rs,F,mid", [(171, 7, False), (128, 37, True), (171, 37, True)])
def test_reference_matches_jax_bitwise(rs, F, mid):
    n_fft = 256
    arrays = _inputs(n_fft, F, mid, seed=11)
    kw = _kw(n_fft, rs, F, mid)
    got = T.segment_phase_reference(*[torch.as_tensor(a) for a in arrays], **kw)
    for a, b in zip(got, _jax_chain(*arrays, **kw)):
        assert_bitwise(a, b)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    arrays = [torch.as_tensor(a) for a in _inputs(256, 9, True)]
    kw = _kw(256, 171, 9, True)
    before = profiling.counters().get("launches.segment_phase", 0)
    got = T.segment_phase(*arrays, **kw)
    assert profiling.counters().get("launches.segment_phase", 0) == before
    for a, b in zip(got, T.segment_phase_reference(*arrays, **kw)):
        assert_bitwise(a, b)


@pytest.mark.parametrize("shape", [(9, 128), (0, 129), (9,)])
def test_segment_phase_rejects_bad_phi(shape):
    z = torch.zeros(129)
    with pytest.raises(ValueError):
        T.segment_phase(torch.zeros(shape), z, z, z, z, **_kw(256, 128, 9, True))


def _oracle_step(x_seg, n_valid, state, cfg, rs, *, spec=None, frame_offset=None, started=None):
    """segment_step as it was before segment_phase and the norm cache."""
    n, ra = cfg.n_fft, cfg.hop
    mag, phi = pipeline.analyze(x_seg, cfg) if spec is None else spec
    F = mag.shape[0]
    dtype, dev = mag.dtype, mag.device
    g = int(state.frame_offset) if frame_offset is None else frame_offset
    started = bool(state.started) if started is None else started
    psi, carry_hi, carry_lo = _inline_oracle(
        phi, state.phi_prev, state.psi_carry, state.psi_carry_lo, state.phi0,
        ra=ra, rs=rs, n_fft=n, frame_offset=g, n_valid=n_valid, started=started)
    phi0 = state.phi0 if started else phi[0]
    j = torch.arange(F, device=dev)
    mask = (j < n_valid).to(dtype)
    w = hann_window(n, dev, dtype)
    if pipeline.fused_synthesis_ok(cfg, rs):
        ola = istft_ola(mag, psi, n, rs, frame_mask=mask)
    else:
        y_re, y_im = mag * torch.cos(psi), mag * torch.sin(psi)
        if cfg.fft_backend == "xla":
            y_frames = fft_ops.irfft(y_re, y_im, n, backend="xla") * w
        else:
            y_frames = fft_ops.irfft(y_re, y_im, n, backend="matmul", fused_window=True)
        ola = framing.overlap_add(y_frames * mask[:, None], rs, method=cfg.ola_method)
    norm = framing.ola_window_norm(w, F, rs, eps=0.0, method=cfg.ola_method, frame_mask=mask)
    pad = (0, F * rs - (n - rs))
    main = ola[: F * rs] + torch.nn.functional.pad(state.ola_tail, pad)
    main_norm = norm[: F * rs] + torch.nn.functional.pad(state.norm_tail, pad)
    advance = min(n_valid, F)
    return main / torch.clamp_min(main_norm, streaming._EPS), streaming.StreamState(
        phi_prev=phi[advance - 1], psi_carry=carry_hi, psi_carry_lo=carry_lo, phi0=phi0,
        ola_tail=ola[F * rs:], norm_tail=norm[F * rs:], started=torch.ones_like(state.started),
        frame_offset=state.frame_offset + advance)


@pytest.fixture(scope="module")
def x6():
    return torch.as_tensor(make_test_signal(6.0, seed=4).astype(np.float32))


@pytest.mark.parametrize("segment_frames", [40, 1024])
@pytest.mark.parametrize("stretch", [0.5, 2.0 ** (-7 / 12)])
def test_stream_bitwise_the_oracle_step(stretch, segment_frames, x6, monkeypatch):
    # One analysis serves both streams (torch's CPU sqrt can round a few
    # values differently from run to run in a loaded process), so the
    # comparison sees the steps alone.
    analyze, spec = pipeline.analyze, []

    def analyze_once(x, cfg):
        if not spec:
            spec.append(analyze(x, cfg))
        return spec[0]

    monkeypatch.setattr(pipeline, "analyze", analyze_once)
    got = streaming.stream_time_stretch(x6, stretch, CFG, segment_frames, device="cpu")
    monkeypatch.setattr(streaming, "segment_step", _oracle_step)
    want = streaming.stream_time_stretch(x6, stretch, CFG, segment_frames, device="cpu")
    assert len(spec) == 1
    assert_bitwise(got, want)


def test_segment_step_state_bitwise_the_oracle_step(x6):
    """One partial segment from a mid-stream state: output and every
    state field."""
    rs, F = 171, 40
    nf = framing.num_frames(len(x6), CFG.n_fft, CFG.hop)
    _, S = streaming.plan_segments(nf, CFG, rs, F)
    x_pad = streaming.pad_for_segments(x6, CFG, F, S)
    _, mid = streaming._stream_scan_from(x_pad, streaming.init_state(CFG, rs), nf, CFG, rs, F, S - 1)
    g = int(mid.frame_offset)
    seg = x_pad[g * CFG.hop: (g + F) * CFG.hop + CFG.n_fft - CFG.hop]
    spec = pipeline.analyze(seg, CFG)
    a, sa = streaming.segment_step(None, nf - g, mid, CFG, rs, spec=spec)
    b, sb = _oracle_step(None, nf - g, mid, CFG, rs, spec=spec)
    assert nf - g < F
    assert_bitwise(a, b)
    for field in ("phi_prev", "psi_carry", "psi_carry_lo", "phi0", "ola_tail", "norm_tail"):
        assert_bitwise(getattr(sa, field), getattr(sb, field))
    assert int(sa.frame_offset) == int(sb.frame_offset) == nf


@pytest.mark.parametrize("method", ["fold", "scatter"])
@pytest.mark.parametrize("n_fft,rs,F", [(1024, 128, 1024), (1024, 171, 40), (256, 64, 7)])
def test_cached_full_norm_is_ola_window_norm(n_fft, rs, F, method):
    mask, norm = streaming._mask_and_norm(F, F, n_fft, rs, method, torch.float32, "cpu")
    w = hann_window(n_fft, "cpu")
    assert_bitwise(mask, torch.ones(F))
    assert_bitwise(norm, framing.ola_window_norm(w, F, rs, eps=0.0, method=method,
                                                 frame_mask=torch.ones(F)))
    # Cached: the same tensors again; a partial segment is computed anew.
    again = streaming._mask_and_norm(F, F, n_fft, rs, method, torch.float32, torch.device("cpu"))
    assert again[0] is mask and again[1] is norm
    part_mask, part = streaming._mask_and_norm(F, F - 1 if F > 1 else 0, n_fft, rs, method,
                                               torch.float32, "cpu")
    want_mask = (torch.arange(F) < F - 1).to(torch.float32)
    assert_bitwise(part_mask, want_mask)
    assert_bitwise(part, framing.ola_window_norm(w, F, rs, eps=0.0, method=method, frame_mask=want_mask))


def test_norm_cache_is_keyed_by_geometry_method_and_device():
    key = dict(F=40, n_valid=40, n_fft=1024, rs=128, method="fold", dtype=torch.float32, device="cpu")
    base = streaming._mask_and_norm(**key)[1]
    for change in (dict(rs=171), dict(F=41, n_valid=41), dict(method="scatter"), dict(n_fft=512)):
        other = streaming._mask_and_norm(**{**key, **change})[1]
        assert other is not base
    info = streaming._full_mask_and_norm.cache_info()
    streaming._mask_and_norm(**{**key, "device": torch.device("meta")})
    assert streaming._full_mask_and_norm.cache_info().misses == info.misses + 1

"""The q in {2, 4} term-algebra switch (ops/fused.py set_q_algebraic) and
the package's top-level analyze / synthesize, on the CPU, where the kernel
wrappers run their plain torch versions, against the JAX package (its
Pallas kernels in interpret mode) and the float64 golden model.

set_q_algebraic(False) sends the q in {2, 4} hop ratios (stretch 0.5x and
1.5x here: k = 1/2, 3/2) through the angle domain (atan2, times k,
cos/sin) instead of principal square roots and the integer power; q = 1
stays algebraic whatever the switch says. Every JAX call of the switch
lives in this file: JAX's setter clears its compile caches. The fixture
restores both packages' switches.

Bounds:
  * the port's plain fused TSM against JAX's fused kernel, both with the
    switch False: < 5e-5 interior rel (tests/test_torch_fused.py's bound
    for two f32 fused TSMs); against golden < 1e-4, the stretch gate;
  * q = 1 (Rs = 512, 256): the same bits under both settings; q = 2
    (Rs = 128): not the same bits;
  * the fused stream against the monolithic plain route, and a ragged
    batch row against the single plain route: torch.equal;
  * analyze against JAX's, as tests/test_torch_stft.py holds stft_polar:
    magnitude < 1e-5 of max |X|, phase weighted by |X| <= 5e-6 of max
    |X|; synthesize < 1e-5 interior rel (two f32 matrix DFTs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu as jpv
from phase_vocoder_tpu.ops.pallas import fused as jfused
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import streaming
from phase_vocoder_tpu_torch.ops import fused
from tests.conftest import make_test_signal

N, RA = 1024, 256
CFG = tpv.PvocConfig()
JAX_CFG = jpv.PvocConfig(fft_backend="pallas")


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture
def algebra():
    """set(flag) sets both packages' switch; the fixture restores both."""
    before = fused._Q_ALGEBRAIC, jfused._Q_ALGEBRAIC

    def set_both(flag: bool) -> None:
        fused.set_q_algebraic(flag)
        jfused.set_q_algebraic(flag)

    try:
        yield set_both
    finally:
        fused.set_q_algebraic(before[0])
        jfused.set_q_algebraic(before[1])


@pytest.fixture(scope="module")
def x2():
    return make_test_signal(2.0).astype(np.float32)


def _plain(x, rs):
    return fused.fused_time_stretch(torch.as_tensor(x), N, RA, rs)


def test_default_is_algebraic():
    assert fused._Q_ALGEBRAIC is True and jfused._Q_ALGEBRAIC is True
    assert "set_q_algebraic" in fused.__all__


@pytest.mark.parametrize("rs", [128, 384])
def test_angle_domain_vs_jax_and_golden(rs, x2, algebra):
    algebra(False)
    y = _plain(x2, rs).numpy()
    j = np.asarray(jfused.fused_time_stretch(x2, N, RA, rs))
    assert rel_err(y, j) < 5e-5
    ref = pv_ref.phase_vocoder(x2.astype(np.float64), rs / RA, N, RA)
    assert rel_err(y, ref) < 1e-4


@pytest.mark.parametrize("rs,same", [(512, True), (256, True), (128, False)])
def test_switch_reaches_only_q_ge_2(rs, same, x2, algebra):
    """q = 1 stays algebraic under both settings; k = 1/2 changes path."""
    algebra(True)
    alg = _plain(x2, rs)
    algebra(False)
    ang = _plain(x2, rs)
    assert torch.equal(alg.view(torch.int32), ang.view(torch.int32)) is same


def test_angle_domain_stream_and_batch_bitwise(x2, algebra):
    algebra(False)
    x = torch.as_tensor(x2)
    mono = fused.fused_time_stretch_reference(x, N, RA, 128)
    for sf in (64, 8192):
        assert torch.equal(streaming.fused_stream_time_stretch(x, 0.5, CFG, segment_frames=sf), mono)
    # A ragged batch: the whole signal, 1.3 s, and 3 frames (fewer than
    # the overlap m - 1 = 7 at Rs = 128).
    lens = [len(x2), int(1.3 * 16000), N + 2 * RA]
    xs = torch.zeros((3, len(x2)))
    for b, n in enumerate(lens):
        xs[b, :n] = x[:n] if b != 1 else x[len(x2) - n :]
    nfs = [(n - N) // RA + 1 for n in lens]
    for rs in (128, 384):
        out = fused.fused_time_stretch_batch(xs, N, RA, rs, nfs)
        for b, n in enumerate(lens):
            one = fused.fused_time_stretch(xs[b, :n].contiguous(), N, RA, rs)
            assert torch.equal(out[b, : len(one)], one)
            assert not out[b, len(one) :].any()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _jax_took_algebra(zre, zim, p: int, q: int) -> bool:
    """Which path JAX's _pow_k took for k = p/q: its output against its
    own root-and-power and angle-domain forms of the same z."""
    pp, qq = jfused._rational_k(p, q)
    got = jfused._pow_k(zre, zim, p, q)
    wre, wim = zre, zim
    for _ in range(qq.bit_length() - 1):
        wre, wim = jfused._principal_sqrt(wre, wim)
    alg = (wre, wim) if pp == 1 else jfused._int_pow(wre, wim, pp)
    ang = jfused._atan2(zim, zre) * jnp.float32(pp / qq)
    ang = (jnp.cos(ang), jnp.sin(ang))
    is_alg = all(np.array_equal(_bits(g), _bits(a)) for g, a in zip(got, alg))
    is_ang = all(np.array_equal(_bits(g), _bits(a)) for g, a in zip(got, ang))
    assert is_alg != is_ang, (p, q)
    return is_alg


@pytest.mark.parametrize("flag", [True, False])
def test_pow_alg_is_jax_condition(flag, algebra):
    """_pow_alg picks JAX's path for every p <= 16, q in {1, 2, 4, 8, 256}
    (reduced as the callers reduce Rs/Ra), and the port's plain _pow_k
    takes the path _pow_alg names."""
    algebra(flag)
    rng = np.random.default_rng(14)
    ang = rng.uniform(-np.pi, np.pi, 64)
    zre, zim = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    tre, tim = torch.as_tensor(zre), torch.as_tensor(zim)
    for q in (1, 2, 4, 8, 256):
        for p in range(1, 17):
            pp, qq = fused._rational_k(p, q)
            want = _jax_took_algebra(jnp.asarray(zre), jnp.asarray(zim), p, q)
            assert fused._pow_alg(pp, qq) is want, (p, q, flag)
            assert want == (qq == 1 and pp <= 8 or qq in (2, 4) and pp <= 8 and flag), (p, q)
            wre, wim = tre, tim
            for _ in range(qq.bit_length() - 1):
                wre, wim = fused._principal_sqrt(wre, wim)
            alg = (wre, wim) if pp == 1 else fused._int_pow(wre, wim, pp)
            got = fused._pow_k(tre, tim, p, q)
            assert all(torch.equal(g, a) for g, a in zip(got, alg)) is want, (p, q, flag)


def test_analyze_and_synthesize_at_top_level(x2):
    assert {"analyze", "synthesize"} <= set(tpv.__all__)
    assert {"analyze", "synthesize"} <= set(jpv.__all__)
    mag, phi = tpv.analyze(x2, CFG, device="cpu")
    jm, jp = (np.asarray(a) for a in jpv.analyze(jnp.asarray(x2), JAX_CFG))
    assert mag.device.type == "cpu" and mag.shape == jm.shape
    top = jm.max()
    assert np.max(np.abs(mag.numpy() - jm)) / top < 1e-5
    dphi = np.abs(np.angle(np.exp(1j * (phi.numpy().astype(np.float64) - jp))))
    assert np.max(dphi * jm) <= 5e-6 * top
    re, im = jm * np.cos(jp), jm * np.sin(jp)
    mask = np.ones(jm.shape[0], np.float32)
    mask[-20:] = 0.0
    for rs, fm in ((256, None), (128, mask)):
        y = tpv.synthesize(re, im, CFG, rs, frame_mask=fm, device="cpu")
        j = np.asarray(jpv.synthesize(jnp.asarray(re), jnp.asarray(im), JAX_CFG, rs,
                                      frame_mask=None if fm is None else jnp.asarray(fm)))
        assert y.device.type == "cpu" and y.dtype == torch.float32
        assert rel_err(y.numpy(), j) < 1e-5


def test_numpy_input_defaults_to_cuda(x2):
    """Non-tensor input goes to "cuda" unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only build")
    with pytest.raises((RuntimeError, AssertionError)):
        tpv.analyze(x2, CFG)
    with pytest.raises((RuntimeError, AssertionError)):
        tpv.synthesize(np.ones((9, N // 2 + 1), np.float32), np.zeros((9, N // 2 + 1), np.float32), CFG, 256)

"""The port's sequence-parallel chunked TSM (parallel/chunked.py) on the CPU:
twins of tests/test_parallel.py's sequence-parallel tests, run over gloo
process groups of 2, 4 and 8 ranks (tests/torch_dist.py; one group per
world size, shared by the tests through module fixtures), and the plain
versions of the chunked bodies' kernels and helpers against the JAX
package's functions (JAX imported inside the tests: the workers run this
file and must not import it).

Bounds, the JAX suite's own: chunked against the single-device route
<= 5e-5 interior relative (the chunks regroup the phase products and the
carry), < 1e-4 against the golden model; against JAX's chunked program
on as many virtual devices <= 5e-5 (two f32 routes, each ~1e-5 from
golden); the short-input fallback bitwise; the plain kernels against
JAX's Pallas kernels in interpret mode within 2e-6 of the largest
magnitude (|X|), 1e-4 once weighted by |X| (the phasors), 1e-5 of the
largest output sample (the synthesis; JAX's inverse DFT is a bf16 split).
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.parallel import chunked
from phase_vocoder_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from tests.torch_dist import make_test_signal, run_group, worker_main

N, RA = 1024, 256
NB = N // 2 + 1
STRETCHES = (0.5, 1.0, 2.0)


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


# ------------------------------------------------------------ the workers


def _seq_case(rank, world, out):
    """chunked_time_stretch over a 1-D "seq" mesh of every rank."""
    mesh = make_mesh(axis="seq")
    x4 = make_test_signal(4.0)
    res = {f"s{s}": chunked.chunked_time_stretch(x4, s, mesh=mesh, device="cpu") for s in STRETCHES}
    res["nondiv"] = chunked.chunked_time_stretch(make_test_signal(1.9), 2.0, mesh=mesh, device="cpu")
    x02 = make_test_signal(0.2)
    res["short_polar"] = chunked.chunked_time_stretch(
        x02, 2.0, tpv.PvocConfig(fft_backend="matmul"), mesh=mesh, device="cpu")
    res["short_split"] = chunked.chunked_time_stretch(x02, 0.5, mesh=mesh, device="cpu")
    res["polar_1.5"] = chunked.chunked_time_stretch(x4, 1.5, mesh=mesh, device="cpu")
    res["facade"] = tpv.PhaseVocoder(device="cpu").chunked_time_stretch(x4, 2.0, mesh=mesh)
    if world == 8:
        res["long"] = chunked.chunked_time_stretch(make_test_signal(60.0), 2.0, mesh=mesh, device="cpu")
    np.savez(out / f"seq.{rank}.npz", **{k: v.numpy() for k, v in res.items()})


def _mesh2d_case(rank, world, out):
    """batched_chunked_time_stretch over a (2, 2) mesh: fused split body at
    0.5 (q = 2) and 2.0 (closed form), the polar body at 1.5."""
    mesh = make_mesh_2d(2, 2)
    xs = np.stack([make_test_signal(2.0, seed=i) for i in range(4)])
    res = {f"s{s}": chunked.batched_chunked_time_stretch(xs, s, mesh=mesh, device="cpu")
           for s in (0.5, 2.0, 1.5)}
    np.savez(out / f"mesh2d.{rank}.npz", **{k: v.numpy() for k, v in res.items()})


CASES = {"seq": _seq_case, "mesh2d": _mesh2d_case}


def _group(tmp_path_factory, case, world):
    out = tmp_path_factory.mktemp(f"{case}{world}")
    run_group(__file__, case, world, out, timeout=420)
    return [dict(np.load(out / f"{case}.{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def seq2(tmp_path_factory):
    return _group(tmp_path_factory, "seq", 2)


@pytest.fixture(scope="module")
def seq8(tmp_path_factory):
    return _group(tmp_path_factory, "seq", 8)


@pytest.fixture(scope="module")
def mesh2d(tmp_path_factory):
    return _group(tmp_path_factory, "mesh2d", 4)


@pytest.fixture
def seq(request, seq2, seq8):
    return {2: seq2, 8: seq8}[request.param]


@pytest.fixture(scope="module")
def x4():
    return make_test_signal(4.0)


@pytest.fixture(scope="module")
def singles(x4):
    return {s: tpv.time_stretch(x4, s, device="cpu").numpy() for s in STRETCHES}


# --------------------------------------------------------- sequence parallel


@pytest.mark.parametrize("stretch", STRETCHES)
@pytest.mark.parametrize("seq", [2, 8], indirect=True)
def test_chunked_matches_single(stretch, seq, singles):
    y = seq[0][f"s{stretch}"]
    assert len(y) == len(singles[stretch])
    assert rel_err(y, singles[stretch]) < 5e-5


@pytest.mark.parametrize("stretch", STRETCHES)
@pytest.mark.parametrize("seq", [2, 8], indirect=True)
def test_chunked_vs_jax(stretch, seq, x4):
    """JAX's chunked program on as many virtual devices (its fused bodies,
    Pallas in interpret mode)."""
    import phase_vocoder_tpu as jpv
    from phase_vocoder_tpu.parallel.mesh import make_mesh as jmake_mesh

    world = len(seq)
    j = np.asarray(jpv.chunked_time_stretch(
        x4, stretch, jpv.PvocConfig(fft_backend="pallas"), mesh=jmake_mesh(world, axis="seq")))
    assert rel_err(seq[0][f"s{stretch}"], j) < 5e-5


@pytest.mark.parametrize("seq", [2, 8], indirect=True)
def test_every_rank_returns_the_whole_output(seq):
    for other in seq[1:]:
        assert other.keys() == seq[0].keys()
        for key, y in seq[0].items():
            assert np.array_equal(other[key], y), key


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_chunked_matches_golden(stretch, seq8, x4):
    y = seq8[0][f"s{stretch}"]
    ref = pv_ref.phase_vocoder(x4, stretch, N, RA)
    assert len(y) == len(ref)
    assert rel_err(y, ref) < 1e-4


def test_chunked_polar_body(seq8, x4):
    """Rs = 384 does not divide N: the polar body (stft_polar, the
    compensated pair scan and carry) over 8 ranks."""
    assert not chunked._fused_chunk_ok(tpv.PvocConfig(), 384)
    y = seq8[0]["polar_1.5"]
    assert rel_err(y, tpv.time_stretch(x4, 1.5, device="cpu").numpy()) < 5e-5
    assert rel_err(y, pv_ref.phase_vocoder(x4, 1.5, N, RA)) < 1e-4


def test_chunked_non_divisible_frames(seq8):
    x = make_test_signal(1.9)
    single = tpv.time_stretch(x, 2.0, device="cpu").numpy()
    assert len(seq8[0]["nondiv"]) == len(single)
    assert rel_err(seq8[0]["nondiv"], single) < 5e-5


@pytest.mark.parametrize("key,stretch,backend", [
    ("short_polar", 2.0, "matmul"), ("short_split", 0.5, "fused")])
def test_chunked_short_input_falls_back(seq8, key, stretch, backend):
    """0.2 s (9 frames) over 8 ranks leaves F = 2 < 3 frames a rank: the
    single-device route, bit for bit."""
    x = make_test_signal(0.2)
    cfg = tpv.PvocConfig(fft_backend=backend)
    assert -(-9 // 8) < chunked.min_frames_per_device(cfg, cfg.synthesis_hop(stretch))
    assert np.array_equal(seq8[0][key], tpv.time_stretch(x, stretch, cfg, device="cpu").numpy())


def test_chunked_long_audio_phase_stability(seq8):
    x = make_test_signal(60.0)
    assert rel_err(seq8[0]["long"], tpv.time_stretch(x, 2.0, device="cpu").numpy()) < 5e-5


def test_model_facade(seq8, singles):
    assert rel_err(seq8[0]["facade"], singles[2.0]) < 5e-5
    y = tpv.PhaseVocoder(device="cpu").chunked_time_stretch(make_test_signal(1.0), 1.0)
    assert len(y) == len(pv_ref.phase_vocoder(make_test_signal(1.0), 1.0, N, RA))


@pytest.mark.parametrize("stretch", STRETCHES)
def test_force_on_a_world_of_one(stretch, x4, singles):
    """force=True runs the chunked program on one rank: at integer k the
    single segment is the fused stream, bit for bit the single route."""
    y = chunked.chunked_time_stretch(x4, stretch, force=True, device="cpu").numpy()
    assert rel_err(y, singles[stretch]) < 5e-5
    if stretch != 0.5:
        assert np.array_equal(y, singles[stretch])
    assert np.array_equal(chunked.chunked_time_stretch(x4, stretch, device="cpu").numpy(),
                          singles[stretch])  # no force: the single route


def test_min_frames_per_device():
    cfg = tpv.PvocConfig()
    assert chunked.min_frames_per_device(cfg, 512) == 3
    assert chunked.min_frames_per_device(cfg, 128) == 7
    assert chunked.min_frames_per_device(tpv.PvocConfig(hop=128), 512) == 7


# ---------------------------------------------------------------- DP x SP


@pytest.mark.parametrize("stretch", [0.5, 2.0, 1.5])
def test_batched_chunked_on_a_2x2_mesh(stretch, mesh2d):
    xs = np.stack([make_test_signal(2.0, seed=i) for i in range(4)])
    ys = mesh2d[0][f"s{stretch}"]
    assert ys.shape[0] == 4
    for i in range(4):
        single = tpv.time_stretch(xs[i], stretch, device="cpu").numpy()
        assert ys.shape[1] == len(single)
        assert rel_err(ys[i], single) < 5e-5
    for other in mesh2d[1:]:
        assert np.array_equal(other[f"s{stretch}"], ys)


def test_batched_chunked_vs_jax(mesh2d):
    """JAX's DP x SP program on a (2, 2) mesh of virtual devices."""
    import phase_vocoder_tpu as jpv
    from phase_vocoder_tpu.parallel.chunked import batched_chunked_time_stretch
    from phase_vocoder_tpu.parallel.mesh import make_mesh_2d as jmake_mesh_2d

    xs = np.stack([make_test_signal(2.0, seed=i) for i in range(4)])
    for stretch in (0.5, 2.0):
        j = np.asarray(batched_chunked_time_stretch(
            xs, stretch, jpv.PvocConfig(fft_backend="pallas"), mesh=jmake_mesh_2d(2, 2)))
        for i in range(4):
            assert rel_err(mesh2d[0][f"s{stretch}"][i], j[i]) < 5e-5


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_batched_chunked_on_a_world_of_one(stretch):
    xs = np.stack([make_test_signal(1.0, seed=i) for i in range(3)])
    ys = chunked.batched_chunked_time_stretch(xs, stretch, mesh=make_mesh_2d(1, 1), device="cpu")
    for i in range(3):
        assert rel_err(ys[i], tpv.time_stretch(xs[i], stretch, device="cpu")) < 5e-5


def test_batched_chunked_rejects():
    xs = np.zeros((2, 16000))
    with pytest.raises(ValueError, match="mesh"):
        chunked.batched_chunked_time_stretch(xs, 2.0, mesh=make_mesh(), device="cpu")
    with pytest.raises(ValueError, match="too short"):
        chunked.batched_chunked_time_stretch(np.zeros((2, 1024)), 2.0, mesh=make_mesh_2d(1, 1),
                                             device="cpu")


def test_mesh_of_one():
    """No process group: a world of one, where all-gather is the identity
    and a shift gives the zeros of a rank with no neighbour."""
    mesh = make_mesh_2d(1, 1)
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.size() == 1
    x = torch.arange(4.0)
    assert mesh.all_gather(x, "seq")[0] is x
    assert not mesh.shift(x, "seq", 1).any()
    with pytest.raises(ValueError, match="processes"):
        make_mesh(2)


# --------------------------------------- the kernels' plain versions vs JAX


def _jax_planes(arrs, nf, lead=()):
    return [np.asarray(a)[(*[slice(None)] * len(lead), slice(0, nf), slice(0, NB))] for a in arrs]


@pytest.fixture(scope="module")
def xb():
    return np.stack([make_test_signal(1.0, seed=i) for i in range(3)]).astype(np.float32)


@pytest.mark.parametrize("scan", [False, True])
def test_phasor_terms_batch_vs_jax(scan, xb):
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas import fused as jfused

    j = jfused.stft_phasor_terms_batch(jnp.asarray(xb), N, RA, 128, scan=scan, return_u=True)
    t = fused.stft_phasor_terms_batch(torch.as_tensor(xb), N, RA, 128, scan=scan, return_u=True)
    nf = t[-1]
    assert nf == j[-1] and t[0].shape == (3, nf, NB)
    jm, jpre, jpim, jure, juim = _jax_planes(j[:5], nf, lead=(0,))
    top = np.abs(jm).max()
    assert np.abs(t[0].numpy() - jm).max() / top <= 2e-6
    for (ar, ai), (br, bi) in (((t[1], t[2]), (jpre, jpim)), ((t[3], t[4]), (jure, juim))):
        assert (np.abs((ar.numpy() + 1j * ai.numpy()) - (br + 1j * bi)) * jm / top).max() <= 1e-4
    one = fused.stft_phasor_terms(torch.as_tensor(xb[1]), N, RA, 128, scan=scan, return_u=True)
    for a, b in zip(t[:5], one[:5]):
        assert torch.equal(a[1], b)  # each row is the single-recording version


@pytest.fixture(scope="module")
def spectra():
    g = np.random.default_rng(3)
    nf = 70
    mag = g.random((2, nf, NB)).astype(np.float32)
    ang = g.random((2, nf, NB)) * 2 * np.pi
    return mag, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _jax_padded(a, nf):
    """a (..., nf, NB) into JAX's lane-padded (..., nf_pad, nbp) layout."""
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas.fused import _TILE_F, _pad_bins

    nf_pad = -(-(nf + 8) // _TILE_F) * _TILE_F
    out = np.zeros(a.shape[:-2] + (nf_pad, _pad_bins(NB)), np.float32)
    out[..., :nf, :NB] = a
    return jnp.asarray(out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rs", [128, 256, 512])
def test_phasor_istft_ola_vs_jax(rs, masked, spectra):
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas import fused as jfused

    mag, pre, pim = (a[0] for a in spectra)
    nf = mag.shape[0]
    mask = np.ones(60, np.float32)  # shorter than nf: frames past it are off
    mask[-10:] = 0.0
    j = np.asarray(jfused.phasor_istft_ola(
        *(_jax_padded(a, nf) for a in (mag, pre, pim)), N, rs, nf,
        frame_mask=jnp.asarray(mask) if masked else None))
    t = fused.phasor_istft_ola(
        *(torch.as_tensor(a) for a in (mag, pre, pim)), N, rs, nf,
        frame_mask=torch.as_tensor(mask) if masked else None).numpy()
    assert t.shape == ((nf - 1) * rs + N,)
    assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max()
    if masked:  # nothing past the last unmasked frame
        assert not t[(50 - 1) * rs + N :].any()


@pytest.mark.parametrize("masked", [False, True])
def test_phasor_istft_ola_batch_vs_jax(masked, spectra):
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas import fused as jfused

    mag, pre, pim = spectra
    nf, rs = mag.shape[1], 256
    mask = np.ones((2, nf), np.float32)
    mask[0, -30:] = 0.0
    j = np.asarray(jfused.phasor_istft_ola_batch(
        *(_jax_padded(a, nf) for a in spectra), N, rs, nf,
        frame_mask=jnp.asarray(mask) if masked else None))
    t = fused.phasor_istft_ola_batch(
        *(torch.as_tensor(a) for a in spectra), N, rs, nf,
        frame_mask=torch.as_tensor(mask) if masked else None)
    assert t.shape == (2, (nf - 1) * rs + N)
    assert np.abs(t.numpy() - j).max() <= 1e-5 * np.abs(j).max()
    one = fused.phasor_istft_ola(*(torch.as_tensor(a[1]) for a in spectra), N, rs, nf,
                                 frame_mask=torch.as_tensor(mask[1]) if masked else None)
    assert torch.equal(t[1], one)


def test_phasor_istft_ola_rejects(spectra):
    mag, pre, pim = (torch.as_tensor(a[0]) for a in spectra)
    with pytest.raises(ValueError, match="rs"):
        fused.phasor_istft_ola(mag, pre, pim, N, 384, 70)
    with pytest.raises(ValueError, match="nf"):
        fused.phasor_istft_ola(mag, pre, pim, N, 256, 71)


@pytest.fixture(scope="module")
def phasors():
    g = np.random.default_rng(5)
    ang = g.random((300, NB)) * 2 * np.pi
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _serial_product(tre, tim):
    """float64 running product of unit phasors, the scans' exact value."""
    return np.cumprod(tre.astype(np.float64) + 1j * tim.astype(np.float64), axis=0)


@pytest.mark.parametrize("exclusive", [False, True])
def test_phasor_scans_vs_jax(exclusive, phasors):
    """phasor_scan and phasor_prefix_exclusive (300 rows: one level of the
    blocked tree) against the JAX helpers and the serial product."""
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas import fused as jfused

    tre, tim = (a[:, :16] for a in phasors)
    jfn, tfn = ((jfused.phasor_prefix_exclusive, fused.phasor_prefix_exclusive) if exclusive
                else (jfused.phasor_scan, fused.phasor_scan))
    jre, jim = (np.asarray(a) for a in jfn(jnp.asarray(tre), jnp.asarray(tim)))
    pre, pim = (a.numpy() for a in tfn(torch.as_tensor(tre), torch.as_tensor(tim)))
    assert np.abs((pre + 1j * pim) - (jre + 1j * jim)).max() < 1e-5
    exact = _serial_product(tre, tim)
    if exclusive:
        assert pre[0].tolist() == [1.0] * 16 and not pim[0].any()
        exact = exact[:-1]
        pre, pim = pre[1:], pim[1:]
    assert np.abs((pre + 1j * pim) - exact).max() < 1e-5
    assert np.abs(np.hypot(pre, pim) - 1).max() < 1e-6


def test_phasor_scan_past_one_block(phasors):
    """1,500 rows take the two-level tree, whose block prefix the port
    seeds with the phasor 1. (The JAX helper seeds it with 0, its
    blocked_scan's identity for sums, so its first 1,024 rows come out 0;
    ROADMAP.md queue 3.)"""
    tre, tim = (np.tile(a[:, :16], (5, 1)) for a in phasors)
    pre, pim = (a.numpy() for a in fused.phasor_scan(torch.as_tensor(tre), torch.as_tensor(tim)))
    assert np.abs((pre + 1j * pim) - _serial_product(tre, tim)).max() < 1e-5


@pytest.mark.parametrize("rs", [128, 171, 512])
def test_boundary_step_term_vs_jax(rs, phasors):
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas import fused as jfused
    from phase_vocoder_tpu.ops.pallas.fused import _pad_bins

    re, im = phasors

    def pad(a):
        out = np.zeros((a.shape[0], _pad_bins(NB)), np.float32)
        out[:, :NB] = a
        return jnp.asarray(out)

    j = jfused.boundary_step_term(pad(re[1:]), pad(im[1:]), pad(re[:-1]), pad(im[:-1]), N, RA, rs)
    t = fused.boundary_step_term(*(torch.as_tensor(a) for a in (re[1:], im[1:], re[:-1], im[:-1])),
                                 N, RA, rs)
    jz = np.asarray(j[0])[:, :NB] + 1j * np.asarray(j[1])[:, :NB]
    assert np.abs((t[0].numpy() + 1j * t[1].numpy()) - jz).max() < 1e-5


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(sys.argv, CASES)

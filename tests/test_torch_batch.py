"""The port's data-parallel batches (parallel/batch.py) and the batched
fused TSM (ops/fused.py fused_time_stretch_batch, its plain version on the
CPU): twins of tests/test_parallel.py's data-parallel tests, against the
port's single route, the JAX package (PvocConfig(fft_backend="pallas"),
its kernels in interpret mode) and the float64 golden model, and a "data"
mesh over a gloo process group of 4 ranks (tests/torch_dist.py; JAX is
imported inside the tests, since the workers run this file).

Bounds: the batch against the single route <= 1e-5 interior relative (the
plain batch runs each row through the single-recording plain version, so
it is exact here); varied ratios, the 64-utterance batch and the fused
against the polar batch <= 5e-5 (two f32 routes); against golden < 1e-4.
A row shorter than the overlap (n < m-1 frames) has no interior: it is
held whole against golden at 1e-4, where the JAX kernel, which fixes the
tail rows after normalizing the head rows of the same samples, reads
~1e-4 (ROADMAP.md queue 3).
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.parallel import batch
from phase_vocoder_tpu_torch.parallel.mesh import make_mesh
from tests.torch_dist import make_test_signal, run_group, worker_main

N, RA = 1024, 256
JAX_CFG = dict(fft_backend="pallas")


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


def _four(x):
    return np.stack([x, x[::-1], -x, 0.5 * x])


VARIED = ([1.0, 0.7, 1.3, 0.5], [0.5, 1.0, 2.0, 2.0])


def _varied_inputs():
    return [make_test_signal(s, seed=i) for i, s in enumerate(VARIED[0])]


# ------------------------------------------------------------ the workers


def _dp_case(rank, world, out):
    """A "data" mesh of every rank: 6 equal rows (not a multiple of 4) and
    the ragged varied batch."""
    mesh = make_mesh(axis="data")
    xs = np.concatenate([_four(make_test_signal(1.0)), _four(make_test_signal(1.0, seed=9))[:2]])
    res = {"equal": batch.batch_time_stretch(xs, 2.0, mesh=mesh, device="cpu")}
    ys = batch.batch_time_stretch_varied(_varied_inputs(), VARIED[1], mesh=mesh, device="cpu")
    res.update({f"varied{i}": y for i, y in enumerate(ys)})
    np.savez(out / f"dp.{rank}.npz", **{k: v.numpy() for k, v in res.items()})


CASES = {"dp": _dp_case}


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp4")
    run_group(__file__, "dp", 4, out, timeout=300)
    return [dict(np.load(out / f"dp.{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def x1():
    return make_test_signal(1.0)


# ------------------------------------------------------------- data parallel


def test_batch_matches_single(x1):
    xs = _four(x1)
    ys = batch.batch_time_stretch(xs, 2.0, device="cpu").numpy()
    for i in range(4):
        assert rel_err(ys[i], tpv.time_stretch(xs[i], 2.0, device="cpu").numpy()) < 1e-5


def test_batch_varied_ratios_and_lengths():
    import phase_vocoder_tpu as jpv

    xs = _varied_inputs()
    ys = batch.batch_time_stretch_varied(xs, VARIED[1], device="cpu")
    js = jpv.batch_time_stretch_varied(xs, VARIED[1], jpv.PvocConfig(**JAX_CFG))
    for x, r, y, j in zip(xs, VARIED[1], ys, js):
        single = tpv.time_stretch(x, r, device="cpu").numpy()
        assert len(y) == len(single) == len(j)
        assert rel_err(y, single) < 5e-5
        assert rel_err(y, j) < 5e-5


def test_batch_fused_64_utterances():
    """BASELINE config 4 at its canonical size: 64 ragged utterances
    (0.4-0.9 s) in one batched fused launch, against JAX's batch and the
    golden model."""
    import phase_vocoder_tpu as jpv

    rng = np.random.default_rng(7)
    xs = [make_test_signal(float(rng.uniform(0.4, 0.9)), seed=100 + i) for i in range(64)]
    ys = batch.batch_time_stretch_varied(xs, [2.0] * 64, device="cpu")
    js = jpv.batch_time_stretch_varied(xs, [2.0] * 64, jpv.PvocConfig(**JAX_CFG))
    for i in (0, 13, 37, 63):
        assert len(ys[i]) == len(js[i])
        assert rel_err(ys[i], js[i]) < 5e-5
        assert rel_err(ys[i], tpv.time_stretch(xs[i], 2.0, device="cpu").numpy()) < 1e-5
    assert rel_err(ys[5], pv_ref.phase_vocoder(xs[5], 2.0, N, RA)) < 1e-4


def test_varied_runs_one_batch_per_hop(monkeypatch):
    """Six ratios, six synthesis hops: six calls of the batched kernel,
    each with the two rows of its hop."""
    calls = []
    real = batch.fused_time_stretch_batch
    monkeypatch.setattr(batch, "fused_time_stretch_batch",
                        lambda xs, *a, **k: calls.append(xs.shape) or real(xs, *a, **k))
    ratios = [0.5, 0.75, 1.0, 1.25, 1.5, 2.0] * 2
    xs = [make_test_signal(0.3 + 0.05 * i, seed=i) for i in range(12)]
    ys = batch.batch_time_stretch_varied(xs, ratios, device="cpu")
    assert len(calls) == 6 and all(shape[0] == 2 for shape in calls)
    assert rel_err(ys[11], tpv.time_stretch(xs[11], 2.0, device="cpu").numpy(), edge=0) == 0


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_batch_fused_matches_polar_batch(stretch, x1):
    xs = _four(x1)
    a = batch.batch_time_stretch(xs, stretch, device="cpu").numpy()
    b = batch.batch_time_stretch(xs, stretch, tpv.PvocConfig(fft_backend="matmul"), device="cpu").numpy()
    for i in range(4):
        assert rel_err(a[i], b[i]) < 5e-5


def test_batch_past_half_n_takes_the_polar_batch(x1):
    """Rs = 768 > N/2: no fused batch; the polar stages row by row, against
    JAX's vmapped polar batch and golden."""
    import phase_vocoder_tpu as jpv

    xs = _four(x1)
    ys = batch.batch_time_stretch(xs, 3.0, device="cpu").numpy()
    js = np.asarray(jpv.batch_time_stretch(xs, 3.0, jpv.PvocConfig(**JAX_CFG)))
    for i in range(4):
        assert rel_err(ys[i], js[i]) < 5e-5
    assert rel_err(ys[0], pv_ref.phase_vocoder(xs[0], 3.0, N, RA)) < 1e-4


def test_batch_ragged_is_varied_with_one_ratio():
    xs = _varied_inputs()
    a = batch.batch_time_stretch_ragged(xs, 2.0, device="cpu")
    b = batch.batch_time_stretch_varied(xs, [2.0] * 4, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="equal length"):
        batch.batch_time_stretch_varied(xs, [2.0], device="cpu")


def test_batch_facade_and_package_exports(x1):
    xs = _four(x1)
    ys = tpv.PhaseVocoder(device="cpu").batch_time_stretch(xs, 2.0)
    assert torch.equal(ys, tpv.batch_time_stretch(xs, 2.0, device="cpu"))


# ----------------------------------------------------- the batched fused TSM


@pytest.fixture(scope="module")
def ragged():
    """Four rows padded to 1 s: full, 9000 samples, 1800 samples (4 frames,
    fewer than m-1 = 7 at Rs = 128) and 12000 samples."""
    lens = [16000, 9000, 1800, 12000]
    xs = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        xs[i, :n] = make_test_signal(n / 16000, seed=i)[:n]
    return xs, lens, [(n - N) // RA + 1 for n in lens]


@pytest.mark.parametrize("rs", [128, 171, 512])
def test_fused_batch_reference_vs_jax(rs, ragged):
    import jax.numpy as jnp
    from phase_vocoder_tpu.ops.pallas import fused as jfused

    xs, lens, nfs = ragged
    t = fused.fused_time_stretch_batch(torch.as_tensor(xs), N, RA, rs, nfs).numpy()
    j = np.asarray(jfused.fused_time_stretch_batch(jnp.asarray(xs), N, RA, rs,
                                                   n_valid_frames=jnp.asarray(nfs)))
    m = -(-N // rs)
    for b, nf_b in enumerate(nfs):
        n_out = (nf_b - 1) * rs + N
        ref = pv_ref.phase_vocoder(xs[b, : lens[b]].astype(np.float64), rs / RA, N, RA)
        assert len(ref) == n_out
        if nf_b >= m - 1:
            assert rel_err(t[b, :n_out], j[b, :n_out]) < 5e-5
            assert rel_err(t[b, :n_out], ref) < 1e-4
        else:  # no interior: the whole row against golden
            assert rel_err(t[b, :n_out], ref, edge=0) < 1e-4


def test_fused_batch_layout(ragged):
    """(B, (nf+m-1)*rs); each row its own single-recording output, zeros
    after; a row of 0 frames (mesh padding) all zeros."""
    xs, lens, nfs = ragged
    rs = 128
    nf = (16000 - N) // RA + 1
    counts = nfs[:3] + [0]
    t = fused.fused_time_stretch_batch(torch.as_tensor(xs), N, RA, rs, torch.tensor(counts))
    assert t.shape == (4, (nf + N // rs - 1) * rs)
    for b, nf_b in enumerate(counts[:3]):
        n_out = (nf_b - 1) * rs + N
        single = fused.fused_time_stretch(torch.as_tensor(xs[b, : lens[b]]), N, RA, rs)
        assert torch.equal(t[b, :n_out], single)
        assert not t[b, n_out:].any()
    assert not t[3].any()


def test_fused_batch_rejects(ragged):
    xs = torch.as_tensor(ragged[0])
    with pytest.raises(ValueError, match="n_valid_frames"):
        fused.fused_time_stretch_batch(xs, N, RA, 512, [60, 1, 1, 1])
    with pytest.raises(ValueError, match="n_valid_frames"):
        fused.fused_time_stretch_batch(xs, N, RA, 512, [1, 1])
    with pytest.raises(ValueError, match="rs <= n_fft/2"):
        fused.fused_time_stretch_batch(xs, N, RA, 768)
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        fused.fused_time_stretch_batch(xs[0], N, RA, 512)


# ----------------------------------------------------------- the data mesh


def test_dp_mesh_matches_single(dp4):
    xs = np.concatenate([_four(make_test_signal(1.0)), _four(make_test_signal(1.0, seed=9))[:2]])
    ys = dp4[0]["equal"]
    assert ys.shape[0] == 6
    for i in range(6):
        assert rel_err(ys[i], tpv.time_stretch(xs[i], 2.0, device="cpu").numpy()) < 1e-5


def test_dp_mesh_varied(dp4):
    for i, (x, r) in enumerate(zip(_varied_inputs(), VARIED[1])):
        single = tpv.time_stretch(x, r, device="cpu").numpy()
        assert len(dp4[0][f"varied{i}"]) == len(single)
        assert rel_err(dp4[0][f"varied{i}"], single) < 5e-5


def test_dp_mesh_every_rank_returns_the_whole_batch(dp4):
    for other in dp4[1:]:
        for key, y in dp4[0].items():
            assert np.array_equal(other[key], y), key


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(sys.argv, CASES)

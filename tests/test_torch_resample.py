"""The port's resampler (ops/resample.py) on CPU tensors against the
float64 golden model and the JAX package's resample_linear.

Bounds: < 2e-6 abs to the golden model (one f32 rounding of the lerp on
|x| <= 1); < 1e-6 abs to the JAX package, whose block-split positions
agree with float64 to ~6e-8 samples.

The select variants (`_SEL_IMPL` = "mxu", "fused", "roll2", "roll",
"matmul", set in both packages at once) are held to the same two bounds
through _resample_strided_select, the JAX kernels in interpret mode. The
plain versions of the explicit kernels are also fed the JAX package's own
tensors: select_lerp_reference the (k, fr) and chunk bases that
_select_kernel_call receives and makes, resample_blocked_reference the
(S, F) block scalars of _fused_sel_consts. The port's own tables equal the
JAX ones exactly, and the outputs agree with the JAX kernels' to one
rounding of the lerp (<= 1.2e-7 abs on |x| <= 1): the positions are the
same, but XLA on the CPU contracts lo*(1-w) + hi*w into a fused
multiply-add where torch rounds both products.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from golden import pv_ref
import phase_vocoder_tpu.ops.resample as jres
import phase_vocoder_tpu_torch.ops.resample as tres
from phase_vocoder_tpu.ops.resample import resample_linear as jax_resample
from phase_vocoder_tpu_torch.ops.resample import (
    resample_linear,
    resample_linear_reference,
)
from tests.conftest import make_test_signal

SEMITONES = [-13, -12, -7, -5, 0, 5, 7, 12, 3.5]


@pytest.fixture(scope="module")
def x():
    return make_test_signal(2.0).astype(np.float32)


def _port(x, factor, out_len):
    return resample_linear(torch.as_tensor(x), factor, out_len).numpy()


@pytest.mark.parametrize("st", SEMITONES)
def test_resample_vs_golden(st, x):
    fac = 1.0 / (2.0 ** (st / 12.0))  # what pitch_shift passes
    out_len = int(round(len(x) * fac))
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert np.max(np.abs(_port(x, fac, out_len) - ref)) < 2e-6


@pytest.mark.parametrize("st", SEMITONES)
def test_resample_vs_jax(st, x):
    fac = 1.0 / (2.0 ** (st / 12.0))
    out_len = int(round(len(x) * fac))
    j = np.asarray(jax_resample(jnp.asarray(x), fac, out_len))
    assert np.max(np.abs(_port(x, fac, out_len) - j)) < 1e-6


@pytest.mark.parametrize(
    "n,fac,out_len",
    [(10, 0.37, 31), (5, 3.0, 2), (1, 0.5, 3), (128, 1.0, 128), (64, 0.5, 4000), (1, 0.8, 50)],
)
def test_resample_edge_shapes(n, fac, out_len):
    """Tiny inputs and outputs far past the input's end (edge clamp)."""
    g = np.random.default_rng(n)
    x = g.uniform(-1, 1, n).astype(np.float32)
    y = _port(x, fac, out_len)
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert y.shape == (out_len,)
    assert np.max(np.abs(y - ref)) < 2e-6
    if fac >= 0.5:  # the JAX step > 2 kernel takes ~30 s in interpret mode
        j = np.asarray(jax_resample(jnp.asarray(x), fac, out_len))
        assert np.max(np.abs(y - j)) < 1e-6


def test_resample_degenerate_sizes():
    x = torch.ones(4)
    assert resample_linear(x, 2.0, 0).shape == (0,)
    assert torch.equal(resample_linear(torch.ones(0), 2.0, 3), torch.zeros(3))


def test_resample_wrapper_checks():
    x = torch.ones(16)
    assert torch.equal(resample_linear(x, 1.5, 24), resample_linear_reference(x, 1.5, 24))
    with pytest.raises(ValueError):
        resample_linear(x.double(), 1.5, 24)
    with pytest.raises(ValueError):
        resample_linear(torch.ones(2, 8), 1.5, 24)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        resample_linear(x.to("meta"), 1.5, 24)


# ------------------------------------------------- the select variants

IMPLS = ["mxu", "fused", "roll2", "roll", "matmul"]
SELECT_ST = [-7, -5, 5, 7, 3.5]
EDGE_SHAPES = [(10, 0.37, 31), (5, 3.0, 2), (1, 0.5, 3), (64, 0.5, 4000), (1, 0.8, 50)]


@pytest.fixture
def impl(request, monkeypatch):
    monkeypatch.setattr(jres, "_SEL_IMPL", request.param)
    monkeypatch.setattr(tres, "_SEL_IMPL", request.param)
    return request.param


def _select(x, factor, out_len):
    return tres._resample_strided_select(torch.as_tensor(x), factor, out_len).numpy()


@pytest.mark.parametrize("st", SELECT_ST)
@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_select_impl_vs_jax_and_golden(impl, st, x):
    fac = 1.0 / (2.0 ** (st / 12.0))
    out_len = int(round(len(x) * fac))
    y = _select(x, fac, out_len)
    j = np.asarray(jres._resample_strided_select(jnp.asarray(x), fac, out_len))
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert y.shape == (out_len,)
    assert np.max(np.abs(y - j)) <= 1e-6
    assert np.max(np.abs(y - ref)) < 2e-6
    # The public entry takes the same route under this setting.
    assert np.array_equal(_port(x, fac, out_len), y)


@pytest.mark.parametrize("n,fac,out_len", EDGE_SHAPES)
@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_select_impl_edge_shapes(impl, n, fac, out_len):
    """Tiny inputs, steps outside [0.5, 2) and outputs far past the
    input's end (the edge clamp) under every select."""
    g = np.random.default_rng(n)
    x = g.uniform(-1, 1, n).astype(np.float32)
    y = _select(x, fac, out_len)
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert y.shape == (out_len,)
    assert np.max(np.abs(y - ref)) < 2e-6
    if fac >= 0.5:  # the JAX step > 2 path takes ~30 s in interpret mode
        j = np.asarray(jres._resample_strided_select(jnp.asarray(x), fac, out_len))
        assert np.max(np.abs(y - j)) <= 1e-6


@pytest.mark.parametrize("st", [-7, 5])
@pytest.mark.parametrize("impl", ["roll2", "roll", "matmul"], indirect=True)
def test_select_reference_on_jax_tensors(impl, st, x, monkeypatch):
    """select_lerp_reference fed the (k, fr) that the JAX kernel call
    receives (and, for "roll2", bases made as it makes them) gives the JAX
    kernel's output to one rounding of the lerp; the port's own tables are
    the same tensors."""
    fac = 1.0 / (2.0 ** (st / 12.0))
    out_len = int(round(len(x) * fac))
    seen = {}
    real_call = jres._select_kernel_call

    def recorder(spans, k, fr, K, c, step=1.0, valid=None):
        out = real_call(spans, k, fr, K=K, c=c, step=step, valid=valid)
        seen.update(k=np.asarray(k), fr=np.asarray(fr), K=K, c=c, step=step,
                    valid=np.asarray(valid), out=np.asarray(out))
        return out

    monkeypatch.setattr(jres, "_select_kernel_call", recorder)
    jres._resample_strided_select(jnp.asarray(x), fac, out_len)
    t = tres.select_tables(fac, out_len, len(x), impl)
    k, fr = torch.as_tensor(seen["k"].copy()), torch.as_tensor(seen["fr"].copy())
    assert t["c"] == seen["c"]
    assert torch.equal(t["fr"], fr)
    xt = torch.as_tensor(x)
    if impl == "roll2":
        nb, B = k.shape
        k3 = seen["k"].reshape(nb, B // 128, 128)
        v3 = seen["valid"].reshape(nb, B // 128, 128)
        bases = np.minimum(np.where(v3, k3, 1 << 20).min(axis=2), seen["K"] - 1).astype(np.int32)
        K2 = int(np.ceil(128 * abs(seen["step"] - seen["c"]))) + 4
        k2 = np.clip(k3 - bases[:, :, None], 0, K2 - 1).reshape(nb, B).astype(np.int32)
        assert torch.equal(t["bases"], torch.as_tensor(bases))
        assert torch.equal(t["k"], torch.as_tensor(k2))
        y = tres.select_lerp_reference(xt, t["origin"], torch.as_tensor(k2), fr, seen["c"],
                                       torch.as_tensor(bases))
        assert torch.equal(y, tres.select_lerp_two_level(xt, t["origin"], t["bases"], t["k"], fr, t["c"]))
    else:
        assert torch.equal(t["k"], k)
        y = tres.select_lerp_reference(xt, t["origin"], k, fr, seen["c"])
        assert torch.equal(y, tres.select_lerp(xt, t["origin"], t["k"], fr, t["c"]))
    assert np.max(np.abs(y.numpy() - seen["out"])) <= 1.2e-7


@pytest.mark.parametrize("st", [-7, 5, 3.5])
def test_blocked_reference_on_jax_scalars(st, x):
    """resample_blocked_reference fed the (S, F) block scalars of the JAX
    _fused_sel_consts (S taken back to x's coordinates) agrees with the JAX
    "fused" kernel to one rounding of the lerp, and the port's own block
    tables are those scalars."""
    fac = 1.0 / (2.0 ** (st / 12.0))
    out_len = int(round(len(x) * fac))
    cst = jres._fused_sel_consts(fac, out_len, len(x))
    q = np.arange(cst["nb"])
    used = cst["anchors"].astype(np.int64)[q // cst["G"]] + cst["stride"] * (q % cst["G"])
    start_int = torch.as_tensor(cst["S"][:, 0].astype(np.int64) + used - cst["OFF"])
    start_frac = torch.as_tensor(cst["F"][:, 0])
    mine = tres.block_tables(fac, out_len)
    assert torch.equal(mine[0], start_int) and torch.equal(mine[1], start_frac)
    assert np.array_equal(mine[2].numpy() - np.arange(512), cst["V"].reshape(-1))
    assert np.array_equal(mine[3].numpy(), cst["JF"].reshape(-1))
    xt = torch.as_tensor(x)
    y = tres.resample_blocked_reference(xt, start_int, start_frac, mine[2], mine[3], out_len)
    assert torch.equal(y, tres.resample_blocked(xt, *mine, out_len))
    # The same positions in blocks of 512 instead of _positions' 1024: the
    # f32 sum start_frac + jo_frac may round another way, so one ulp of the
    # position (6e-8 samples) rather than bitwise.
    gather = np.asarray(jres._resample_gather(jnp.asarray(x), fac, out_len))
    assert np.max(np.abs(y.numpy() - gather)) <= 2e-7
    fused = np.asarray(jres._resample_fused(jnp.asarray(x), fac, out_len))
    assert np.max(np.abs(y.numpy() - fused)) <= 1.2e-7


def test_select_wrapper_checks():
    x = torch.ones(16)
    org = torch.zeros(1, dtype=torch.int64)
    k = torch.zeros((1, 512), dtype=torch.int32)
    fr = torch.zeros((1, 512))
    assert torch.equal(tres.select_lerp(x, org, k, fr, 1), torch.ones((1, 512)))
    with pytest.raises(ValueError):
        tres.select_lerp(x, org, k.long(), fr, 1)
    with pytest.raises(ValueError):
        tres.select_lerp(x, org.int(), k, fr, 1)
    with pytest.raises(ValueError):
        tres.select_lerp_two_level(x, org, torch.zeros((1, 3), dtype=torch.int32), k, fr, 1)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        tres.select_lerp(x.to("meta"), org.to("meta"), k.to("meta"), fr.to("meta"), 1)
    with pytest.raises(ValueError):
        tres.resample_blocked(x, *tres.block_tables(1.3, 600), 20)  # tables of another length
    with pytest.raises(ValueError):
        tres.resample_blocked(x.to("meta"), *tres.block_tables(1.3, 20, "meta"), 20)


def test_unknown_select_raises(monkeypatch):
    monkeypatch.setattr(tres, "_SEL_IMPL", "vpu")
    with pytest.raises(ValueError):
        tres._resample_strided_select(torch.ones(64), 1.3, 80)


# ------------- the select kernel's block edges (one block per 512 outputs)

# (n, step, out_len): an input shorter than one block; a partial last
# block; c = 0 (step < 0.5); c = 2 (step >= 2, small K so that the JAX
# path compiles fast).
BLOCK_EDGES = {
    "n_below_block": (300, 0.83, 361),
    "partial_last_block": (2000, 0.749, 3 * 512 + 77),
    "c0": (400, 0.3, 1300),
    "c2": (3000, 2.004, 1400),
}


def _edge_input(n):
    return np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)


@pytest.mark.parametrize("case", sorted(BLOCK_EDGES))
@pytest.mark.parametrize("impl", ["roll2", "roll", "matmul"], indirect=True)
def test_select_block_edges_vs_jax(impl, case):
    """The explicit selects' plain versions at the block edges the kernel
    handles (a row shorter than its block, the partial last row, strides
    0 and 2) against the JAX package's (its kernels in interpret mode) to
    1e-6 and golden to 2e-6, the bounds above; the port's tables have
    the stride the case names."""
    n, step, out_len = BLOCK_EDGES[case]
    x = _edge_input(n)
    fac = 1.0 / step
    t = tres.select_tables(fac, out_len, n, impl)
    assert t["c"] == {"c0": 0, "c2": 2}.get(case, 1)
    assert t["k"].shape == (-(-out_len // 512), 512)
    y = _select(x, fac, out_len)
    j = np.asarray(jres._resample_strided_select(jnp.asarray(x), fac, out_len))
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert y.shape == (out_len,)
    assert np.max(np.abs(y - j)) <= 1e-6
    assert np.max(np.abs(y - ref)) < 2e-6


@pytest.mark.parametrize("case", ["n_below_block", "partial_last_block", "c0"])
@pytest.mark.parametrize("impl", ["roll2", "roll", "matmul"], indirect=True)
def test_select_reference_on_jax_tensors_at_block_edges(impl, case, monkeypatch):
    """select_lerp_reference fed the (k, fr) that the JAX select kernel
    receives at the block edges (c <= 1: steps of 2 and more take no JAX
    kernel) gives that kernel's output to one rounding of the lerp
    (1.2e-7, as above), and the port's tables are those tensors."""
    n, step, out_len = BLOCK_EDGES[case]
    x = _edge_input(n)
    fac = 1.0 / step
    seen = {}
    real_call = jres._select_kernel_call

    def recorder(spans, k, fr, K, c, step=1.0, valid=None):
        out = real_call(spans, k, fr, K=K, c=c, step=step, valid=valid)
        seen.update(k=np.asarray(k), fr=np.asarray(fr), c=c, out=np.asarray(out))
        return out

    monkeypatch.setattr(jres, "_select_kernel_call", recorder)
    jres._resample_strided_select(jnp.asarray(x), fac, out_len)
    t = tres.select_tables(fac, out_len, n, impl)
    assert t["c"] == seen["c"] and torch.equal(t["fr"], torch.as_tensor(seen["fr"].copy()))
    xt = torch.as_tensor(x)
    if impl == "roll2":
        y = tres.select_lerp_reference(xt, t["origin"], t["k"], t["fr"], t["c"], t["bases"])
    else:
        assert torch.equal(t["k"], torch.as_tensor(seen["k"].copy()))
        y = tres.select_lerp_reference(xt, t["origin"], t["k"], t["fr"], t["c"])
    assert np.max(np.abs(y.numpy() - seen["out"])) <= 1.2e-7

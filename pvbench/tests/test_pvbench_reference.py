"""The frozen float64 reference against golden/pv_ref.py at small sizes,
its TF32 rounding, the comparison, and the seeded signal."""

import math

import numpy as np
import pytest
import torch

from golden import pv_ref
from pvbench import signals
from pvbench.reference import pv64

RATIOS = (0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0)


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("block", [7, 64, pv64.BLOCK_FRAMES])
def test_reference_equals_golden(ratio, block):
    x = signals.recording(1.5, 11, "cpu")
    ours = pv64.time_stretch(x, ratio, block=block).numpy()
    gold = pv_ref.phase_vocoder(x.double().numpy(), ratio)
    assert ours.shape == gold.shape
    # the interior, as it is judged: at the edges the window norm tends to
    # zero and its quotient magnifies round-off
    sl = slice(1024, len(gold) - 1024)
    assert np.max(np.abs(ours[sl] - gold[sl])) <= 1e-10 * np.max(np.abs(gold[sl]))


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256), (2048, 512)])
def test_reference_equals_golden_other_geometries(n_fft, hop):
    x = signals.recording(1.0, 12, "cpu")
    ours = pv64.time_stretch(x, 1.5, n_fft, hop, block=5).numpy()
    gold = pv_ref.phase_vocoder(x.double().numpy(), 1.5, n_fft, hop)
    sl = slice(n_fft, len(gold) - n_fft)
    assert np.max(np.abs(ours[sl] - gold[sl])) <= 1e-10 * np.max(np.abs(gold[sl]))


def test_short_input_gives_nothing():
    assert pv64.time_stretch(torch.zeros(1000), 2.0).numel() == 0


def test_tf32_rounds_to_ten_mantissa_bits():
    a = torch.randn(10_000) * 1e3
    t = pv64.tf32(a)
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((t - a).abs() <= a.abs() * 2.0**-11)
    assert torch.equal(pv64.tf32(t), t)


def test_max_rel_err():
    ref = torch.linspace(-1, 1, 5000, dtype=torch.float64)
    ours = ref.clone().float()
    ours[2500] += 0.5
    peak = float(ref[100:-100].abs().max())
    assert pv64.max_rel_err(ours, ref, 100) == pytest.approx(0.5 / peak, rel=1e-6)
    ours[2500] = math.nan
    assert pv64.max_rel_err(ours, ref, 100) == math.inf
    assert pv64.max_rel_err(ours[:-1], ref, 100) == math.inf
    # the edges are left out
    ours = ref.clone()
    ours[:100] += 1.0
    assert pv64.max_rel_err(ours, ref, 100) == 0.0


def test_signal_is_seeded_and_bounded():
    a, b = signals.recording(2.0, 21, "cpu"), signals.recording(2.0, 21, "cpu")
    c = signals.recording(2.0, 22, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == (32000,) and float(a.abs().max()) < 1.0
    assert signals.stream_seed(2**40 + 3, 1) != signals.stream_seed(3, 1)

"""Packaging of the PyTorch/CUDA port: no jax at import, the CLI, the
kernel sources and their build."""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tomllib

import numpy as np
import pytest
from scipy.io import wavfile

from golden import pv_ref
from tests.conftest import make_test_signal

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "phase_vocoder_tpu_torch"


def _run(*args, timeout=120):
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=timeout, cwd=REPO
    )


def test_import_does_not_pull_in_jax():
    code = (
        "import sys, phase_vocoder_tpu_torch, phase_vocoder_tpu_torch.cli; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'phase_vocoder_tpu.'))"
        " or m == 'phase_vocoder_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "phase_vocoder_tpu_torch.streaming",
    "phase_vocoder_tpu_torch.utils.checkpoint",
    "phase_vocoder_tpu_torch.utils.profiling",
    "phase_vocoder_tpu_torch.models.phase_vocoder",
    "phase_vocoder_tpu_torch.ops.fused",
    "phase_vocoder_tpu_torch.ops.stft",
    "phase_vocoder_tpu_torch.parallel",
    "phase_vocoder_tpu_torch.parallel.batch",
    "phase_vocoder_tpu_torch.parallel.chunked",
    "phase_vocoder_tpu_torch.parallel.mesh",
    "phase_vocoder_tpu_torch.parallel.distributed",
])
def test_module_imports_no_jax_orbax_or_ml_dtypes(module):
    """Neither jax, orbax nor ml_dtypes exists on the card's machine: the
    checkpoints use numpy files and the bfloat16 parts torch's own type."""
    code = (
        f"import sys, {module}; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orbax', 'ml_dtypes', 'phase_vocoder_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_orbax_or_ml_dtypes():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "orbax", "ml_dtypes"), (path, line)


def test_cli_help_lists_subcommands():
    proc = _run("-m", "phase_vocoder_tpu_torch.cli", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "stretch" in proc.stdout and "pitch" in proc.stdout


@pytest.fixture(scope="module")
def in_wav(tmp_path_factory):
    x = make_test_signal(1.0).astype(np.float32)
    path = tmp_path_factory.mktemp("wav") / "in.wav"
    wavfile.write(path, 16000, x)
    return path, x


def test_cli_stretch_matches_golden(in_wav, tmp_path):
    path, x = in_wav
    out = tmp_path / "out.wav"
    proc = _run(
        "-m", "phase_vocoder_tpu_torch.cli", "stretch", str(path), str(out),
        "--ratio", "2", "--float32", "--device", "cpu",
    )
    assert proc.returncode == 0, proc.stderr
    assert '"audio_seconds_per_second"' in proc.stdout
    sr, y = wavfile.read(out)
    ref = pv_ref.phase_vocoder(x.astype(np.float64), 2.0)
    assert sr == 16000 and y.dtype == np.float32 and len(y) == len(ref)
    sl = slice(1024, len(ref) - 1024)
    assert np.max(np.abs(y[sl] - ref[sl])) / np.max(np.abs(ref[sl])) < 1e-4


def test_cli_pitch_matches_golden(in_wav, tmp_path):
    path, x = in_wav
    out = tmp_path / "out.wav"
    proc = _run(
        "-m", "phase_vocoder_tpu_torch.cli", "pitch", str(path), str(out),
        "--semitones", "-5", "--float32", "--device", "cpu",
    )
    assert proc.returncode == 0, proc.stderr
    _, y = wavfile.read(out)
    ref = pv_ref.pitch_shift(x.astype(np.float64), -5.0)
    n = min(len(y), len(ref))
    sl = slice(1024, n - 1024)
    assert abs(len(y) - len(ref)) <= 1
    assert np.max(np.abs(y[sl] - ref[sl])) / np.max(np.abs(ref[sl])) < 1e-3


def test_pyproject_ships_the_port():
    with open(REPO / "pyproject.toml", "rb") as f:
        meta = tomllib.load(f)
    assert any(
        "phase_vocoder_tpu_torch".startswith(p.rstrip("*"))
        for p in meta["tool"]["setuptools"]["packages"]["find"]["include"]
    )
    assert "csrc/*.cu" in meta["tool"]["setuptools"]["package-data"]["phase_vocoder_tpu_torch"]
    assert meta["project"]["scripts"]["pvoc-torch"] == "phase_vocoder_tpu_torch.cli:main"


@pytest.mark.parametrize("name", ["pvoc_fused.cu", "resample.cu", "stft.cu"])
def test_kernel_sources_use_no_kernel_library(name):
    """The kernels are written by hand: they include only the CUDA runtime
    and the package's FFT headers (no cuFFT, cuBLAS or PyTorch headers)
    and start with their note."""
    src = (PKG / "csrc" / name).read_text()
    assert src.startswith("//") and "Replaces:" in src
    includes = {ln.split()[1] for ln in src.splitlines() if ln.startswith("#include")}
    assert "<cuda_runtime.h>" in includes
    assert includes <= {"<cuda_runtime.h>", "<stdint.h>", '"fft_common.cuh"', '"fft_real.cuh"'}, includes
    assert "cufft" not in src.lower() and "cublas" not in src.lower()


def test_shared_fft_header_is_plain_cuda():
    """fft_common.cuh holds the radix-2 FFT both per-frame kernel files
    include, and includes nothing but the CUDA runtime."""
    src = (PKG / "csrc" / "fft_common.cuh").read_text()
    includes = {ln.split()[1] for ln in src.splitlines() if ln.startswith("#include")}
    assert includes == {"<cuda_runtime.h>"}
    assert "fft_shared" in src
    for name in ("pvoc_fused.cu", "stft.cu"):
        cu = (PKG / "csrc" / name).read_text()
        assert '#include "fft_common.cuh"' in cu and "void fft_shared" not in cu


def test_real_fft_header_is_plain_cuda_and_stft_only():
    """fft_real.cuh, the N/2-point body of the stft.cu kernels and of
    pvoc_fused.cu's synthesis, includes only the CUDA runtime and stdint,
    and exactly stft.cu and pvoc_fused.cu include it (resample.cu, which
    transforms nothing, does not)."""
    src = (PKG / "csrc" / "fft_real.cuh").read_text()
    includes = {ln.split()[1] for ln in src.splitlines() if ln.startswith("#include")}
    assert includes == {"<cuda_runtime.h>", "<stdint.h>"}
    users = sorted(p.name for p in (PKG / "csrc").glob("*.cu") if '#include "fft_real.cuh"' in p.read_text())
    assert users == ["pvoc_fused.cu", "stft.cu"]


def test_build_stamp_covers_headers(tmp_path):
    """The rebuild stamp hashes every file under csrc/, so editing the
    shared header alone triggers a rebuild."""
    import shutil

    from phase_vocoder_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    before = _build._digest(csrc)
    assert _build._digest(csrc) == before
    header = csrc / "fft_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._digest(csrc) != before
    assert {f.name for f in _build._csrc_files(csrc)} >= {"fft_common.cuh", "stft.cu"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler: the build raises, naming nvcc, instead of falling back."""
    from phase_vocoder_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "build" / "libpvoc_kernels.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()

"""PyTorch/CUDA phase vocoder: the port of phase_vocoder_tpu to an H100.

time_stretch and pitch_shift run on hand-written CUDA kernels
(csrc/pvoc_fused.cu, csrc/resample.cu, and csrc/stft.cu on the
branch-faithful polar and general-hop routes) for CUDA tensors, and on
their plain torch versions for CPU tensors; the streaming executors
(streaming.py) and their checkpointed forms (utils/checkpoint.py) run on
the same kernels, and so does the parallel layer (parallel/: utterance
batches, and one recording split over the ranks of a torch.distributed
process group). This package never imports jax.

Quick start:
    import phase_vocoder_tpu_torch as pv
    y = pv.time_stretch(x, 2.0)              # numpy in -> "cuda" by default
    y = pv.pitch_shift(x, semitones=7)
    y = pv.time_stretch(x, 2.0, device="cpu")
    mag, phi = pv.analyze(x, pv.PvocConfig(), device="cpu")
    ys = pv.batch_time_stretch_varied(xs, [0.5, 2.0, ...])  # one batch per Rs
    y = pv.chunked_time_stretch(x, 2.0, pv.make_mesh())     # over all ranks

Importing the package is the set-up span pv.setup.import
(utils/profiling.py), from the import of utils/profiling.py on.
"""

from .utils import profiling as _profiling

with _profiling.setup("import"):
    from .config import PvocConfig
    from .models import PhaseVocoder
    from .parallel import (
        batch_time_stretch,
        batch_time_stretch_ragged,
        batch_time_stretch_varied,
        chunked_time_stretch,
        make_mesh,
        make_mesh_2d,
    )
    from .pipeline import analyze, pitch_shift, stretch_output_length, synthesize, time_stretch
    from .streaming import fused_stream_time_stretch, stream_time_stretch

__version__ = "0.1.0"

__all__ = [
    "PvocConfig",
    "PhaseVocoder",
    "analyze",
    "synthesize",
    "time_stretch",
    "pitch_shift",
    "stretch_output_length",
    "stream_time_stretch",
    "fused_stream_time_stretch",
    "batch_time_stretch",
    "batch_time_stretch_ragged",
    "batch_time_stretch_varied",
    "chunked_time_stretch",
    "make_mesh",
    "make_mesh_2d",
    "__version__",
]

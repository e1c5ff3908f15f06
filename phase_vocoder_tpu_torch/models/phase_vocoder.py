"""PhaseVocoder — the model facade (counterpart of
phase_vocoder_tpu/models/phase_vocoder.py).

The phase vocoder has no learned weights; its "parameters" are static
tables (window, DFT matrices, phasor constants, normalization rows) that
the ops build per geometry and device. The module is therefore a
stateless nn.Module whose forward step is the time stretch.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import pipeline, streaming
from ..config import PvocConfig


class PhaseVocoder(nn.Module):
    """Configured phase vocoder.

    Example:
        pv = PhaseVocoder(PvocConfig(n_fft=1024, hop=256))
        y = pv(torch.as_tensor(x, device="cuda"), 2.0)
        y = pv.pitch_shift(x, semitones=-5)
    """

    def __init__(self, config: PvocConfig = PvocConfig(), device="cuda"):
        super().__init__()
        self.config = config
        self.device = device  # where non-tensor input goes

    def forward(self, x, stretch: float = 1.0) -> torch.Tensor:
        return self.time_stretch(x, stretch)

    def time_stretch(self, x, stretch: float) -> torch.Tensor:
        return pipeline.time_stretch(x, stretch, self.config, device=self.device)

    def pitch_shift(self, x, semitones: float) -> torch.Tensor:
        return pipeline.pitch_shift(x, semitones, self.config, device=self.device)

    def batch_time_stretch(self, xs, stretch: float, mesh=None) -> torch.Tensor:
        """Data-parallel TSM of a (B, T) batch of equal-length utterances
        (parallel.batch.batch_time_stretch)."""
        from ..parallel.batch import batch_time_stretch

        return batch_time_stretch(xs, stretch, self.config, mesh=mesh, device=self.device)

    def chunked_time_stretch(self, x, stretch: float, mesh=None, **kw) -> torch.Tensor:
        """Sequence-parallel TSM of one long recording over the ranks of a
        mesh (parallel.chunked.chunked_time_stretch; kw: force)."""
        from ..parallel.chunked import chunked_time_stretch

        return chunked_time_stretch(x, stretch, self.config, mesh=mesh, device=self.device, **kw)

    def stream_time_stretch(self, x, stretch: float, **kw) -> torch.Tensor:
        """Segmented polar TSM for recordings of any length
        (streaming.stream_time_stretch; kw: segment_frames)."""
        return streaming.stream_time_stretch(x, stretch, self.config, device=self.device, **kw)

    def checkpointed_time_stretch(self, x, stretch: float, checkpoint_dir: str, **kw) -> torch.Tensor:
        """Segmented polar TSM with crash recovery at segment-batch
        granularity (utils.checkpoint.checkpointed_stream_time_stretch)."""
        from ..utils.checkpoint import checkpointed_stream_time_stretch

        return checkpointed_stream_time_stretch(
            x, stretch, self.config, checkpoint_dir=checkpoint_dir, device=self.device, **kw
        )

    def output_length(self, in_len: int, stretch: float) -> int:
        return pipeline.stretch_output_length(in_len, self.config, stretch)

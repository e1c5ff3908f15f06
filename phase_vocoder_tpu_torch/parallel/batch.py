"""Data-parallel batched TSM (counterpart of phase_vocoder_tpu/parallel/batch.py;
BASELINE config 4: 64 utterances, varied ratios).

Utterances are independent, so a batch runs as one launch of the batched
fused kernel (ops/fused.py fused_time_stretch_batch) where it covers the
geometry; with a mesh, each rank of the "data" axis stretches its own
rows and an all-gather gives every rank the whole batch. Rs is a shape
parameter of the kernel, so varied ratios are grouped by Rs and each group
runs as one zero-padded batch with per-row frame counts (padded-length
bucketing). Geometries the fused kernel does not take (Rs > N/2, the
"matmul"/"xla" backends) run the polar stages row by row: analyze,
stretch_frames, synthesize with the row's frame mask. As in the JAX
package, no batch route reroutes to the branch-faithful executor.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .. import pipeline
from ..config import PvocConfig
from ..ops import framing
from ..ops.fused import fused_time_stretch_batch
from ..utils import profiling
from .mesh import Mesh

__all__ = [
    "batch_time_stretch",
    "batch_time_stretch_ragged",
    "batch_time_stretch_varied",
    "batch_time_stretch_rs",
]


def _as_batch(xs, device) -> torch.Tensor:
    if isinstance(xs, torch.Tensor):
        return xs.to(torch.float32).contiguous()
    return torch.as_tensor(np.asarray(xs, dtype=np.float32), device=device)


def _polar_batch(xs: torch.Tensor, nfs: list, cfg: PvocConfig, rs: int) -> torch.Tensor:
    """The JAX package's vmapped polar program, row by row: analysis, phase
    accumulation and synthesis with the row's valid-frame mask."""
    nf = framing.num_frames(xs.shape[-1], cfg.n_fft, cfg.hop)
    frame = torch.arange(nf, device=xs.device)
    rows = []
    for x, nf_b in zip(xs, nfs):
        mag, phi = pipeline.analyze(x, cfg)
        re, im = pipeline.stretch_frames(mag, phi, cfg, rs)
        mask = (frame < nf_b).to(x.dtype)
        rows.append(pipeline.synthesize(re, im, cfg, rs, frame_mask=mask))
    return torch.stack(rows)


def batch_time_stretch_rs(
    xs,
    rs: int,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
    n_valid_frames=None,
    device="cuda",
) -> torch.Tensor:
    """Batched stretch of (B, T) rows parameterized by the synthesis hop Rs.

    n_valid_frames: each row's frame count (default all num_frames(T)).
    Returns (B, (nf-1)*Rs + N), nf = num_frames(T); row b holds its own
    (n_b-1)*Rs + N samples first. With a mesh, B is padded to a multiple of
    its "data" size with all-masked zero rows, each rank stretches its B/D
    rows and all ranks get the whole batch. Tensors stay on their device;
    anything else goes to `device` as float32.
    """
    xs = _as_batch(xs, device)
    nf = framing.num_frames(xs.shape[-1], cfg.n_fft, cfg.hop)
    if n_valid_frames is None:
        nfs = [nf] * xs.shape[0]
    else:
        if isinstance(n_valid_frames, torch.Tensor):
            n_valid_frames = n_valid_frames.tolist()
        nfs = [int(v) for v in n_valid_frames]
    B = xs.shape[0]
    if mesh is not None:
        d, i = mesh.size("data"), mesh.index("data")
        pad_rows = (-B) % d
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad_rows))
        nfs = nfs + [0] * pad_rows
        local = (B + pad_rows) // d
        xs, nfs = xs[i * local : (i + 1) * local], nfs[i * local : (i + 1) * local]
    if pipeline.fused_ok(cfg, rs):
        ys = fused_time_stretch_batch(xs, cfg.n_fft, cfg.hop, rs, nfs)
        ys = ys[:, : framing.output_length(nf, cfg.n_fft, rs)]
    else:
        ys = _polar_batch(xs, nfs, cfg, rs)
    if mesh is not None:
        ys = torch.cat(mesh.all_gather(ys, "data"))[:B]
    return ys


def batch_time_stretch(
    xs, stretch: float, cfg: PvocConfig = PvocConfig(), mesh: Mesh | None = None,
    device="cuda",
) -> torch.Tensor:
    """Stretch a (B, T) batch of equal-length utterances by one ratio; with
    a mesh, each rank of its "data" axis takes B/D of them."""
    with profiling.span("pv.batch_time_stretch"):
        return batch_time_stretch_rs(xs, cfg.synthesis_hop(stretch), cfg, mesh=mesh, device=device)


def batch_time_stretch_ragged(
    xs: list, stretch: float, cfg: PvocConfig = PvocConfig(), mesh: Mesh | None = None,
    device="cuda",
) -> list:
    """Stretch a list of variable-length utterances by one ratio: one padded
    batch, each output cut to its own stretched length."""
    with profiling.span("pv.batch_time_stretch_ragged"):
        return batch_time_stretch_varied(xs, [stretch] * len(xs), cfg, mesh=mesh, device=device)


def batch_time_stretch_varied(
    xs: list,
    stretches: list,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
    device="cuda",
) -> list:
    """Stretch utterances (1-D arrays or tensors) by per-utterance ratios:
    one padded batch per synthesis hop. Returns a list of 1-D tensors, the
    i-th of length (n_i-1)*Rs_i + N. The grouping, and each group's pad and
    stack, are the span pv.batch_group."""
    with profiling.span("pv.batch_time_stretch_varied"):
        if len(xs) != len(stretches):
            raise ValueError("xs and stretches must have equal length")
        with profiling.span("pv.batch_group"):
            groups: dict[int, list[int]] = defaultdict(list)
            for i, s in enumerate(stretches):
                groups[cfg.synthesis_hop(s)].append(i)

        out: list = [None] * len(xs)
        for rs, idxs in groups.items():
            with profiling.span("pv.batch_group"):
                rows = [pipeline._as_signal(xs[i], device) for i in idxs]
                max_len = max(len(r) for r in rows)
                batch = torch.stack([torch.nn.functional.pad(r, (0, max_len - len(r))) for r in rows])
                nfs = [framing.num_frames(len(r), cfg.n_fft, cfg.hop) for r in rows]
            ys = batch_time_stretch_rs(batch, rs, cfg, mesh=mesh, n_valid_frames=nfs)
            for row, i in enumerate(idxs):
                out[i] = ys[row, : framing.output_length(nfs[row], cfg.n_fft, rs)]
        return out

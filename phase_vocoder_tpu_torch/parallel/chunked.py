"""Sequence-parallel chunked TSM (counterpart of
phase_vocoder_tpu/parallel/chunked.py).

One long recording is split by frames over the ranks of a mesh's "seq"
axis: rank d owns the F analysis frames d*F .. d*F+F-1 and the samples
that start them, and the ranks stitch their parts exactly:

  * input halo   - each rank sends the first N-Ra samples of its span to
    its left neighbour, so every frame is analysed from the true samples;
  * phase state  - integer k = Rs/Ra: P_i = u_0 (u_i conj u_0)^k needs only
    the global anchor u_0, one all-gather of rank 0's first frame. q >= 2:
    the previous rank's last unit phasor makes the first step term exact
    (boundary_step_term), each rank takes the prefix product of its own
    terms, and an exclusive prefix product of the all-gathered per-rank
    totals (phasor_prefix_exclusive) is its carry (the polar body: the same
    with compensated wrapped-phase pairs);
  * OLA tails    - the last N-Rs output samples of each rank's overlap-add
    go to its right neighbour and add into its head.

Every rank returns the whole output: an all-gather of the ranks' parts and
the last rank's tail, what process_allgather gives the JAX CLI.

Bodies, chosen as the JAX package chooses them:
  * integer k on the fused kernels' exact-fold layout (Rs | N): the whole
    TSM of the rank's frames in one fused_stream_segment launch. The
    segment normalizes its rows by their global row and returns the sums
    it leaves for the next rank's first m-1 rows un-normalized, so the
    receiving rank scales them by the rows they land on (interior rows
    for d > 0) and adds them. F is a multiple of the segment's 64-frame
    scan chunk, and F*D >= nf + m - 1, so the last rank's rows take the
    recording's last OLA sums. Rank 0 analyses its anchor in the kernel
    (a world of one is the fused stream of one segment, bit for bit); the
    others take the u_0 rank 0 computed with a full-precision DFT of its
    first frame, which matches the kernel's FFT to float32 round-off;
  * other Rs | N on the fused backend (q >= 2): stft_phasor_terms (its
    scanned product and the unit phasors), the phasor carry above in plain
    torch, then phasor_istft_ola with the valid-frame mask and the
    window-energy normalization after the tail exchange;
  * everything else: the polar body (analyze, the compensated pair scan,
    istft_ola or the backend's inverse DFT).

batched_chunked_time_stretch runs the split body over a (data, seq) mesh
with a batch axis: stft_phasor_terms_batch and phasor_istft_ola_batch, one
launch each per rank.
"""

from __future__ import annotations

import torch

from .. import pipeline
from ..config import PvocConfig
from ..ops import fft as fft_ops
from ..ops import framing, phase
from ..ops.fused import (
    SCAN_CHUNK,
    _normalize_rows,
    _pow_k,
    _unit,
    boundary_step_term,
    fused_stream_segment,
    init_carry,
    phasor_istft_ola,
    phasor_istft_ola_batch,
    phasor_prefix_exclusive,
    stft_phasor_terms,
    stft_phasor_terms_batch,
    synth_supported,
)
from ..ops.stft import istft_ola
from ..ops.window import hann_window
from ..utils import profiling
from .mesh import Mesh, make_mesh

__all__ = ["chunked_time_stretch", "batched_chunked_time_stretch", "min_frames_per_device"]

_EPS = 1e-8


def min_frames_per_device(cfg: PvocConfig, rs: int) -> int:
    """Smallest F for which halos only touch the immediate neighbour."""
    n, ra = cfg.n_fft, cfg.hop
    f_halo = -(-(n - ra) // ra)  # input halo fits in the neighbour's span
    f_tail = -(-(n - rs) // rs)  # OLA tail fits in the neighbour's main span
    return max(f_halo, f_tail, 1)


def _fused_chunk_ok(cfg: PvocConfig, rs: int) -> bool:
    """The split body's synthesis (phasor_istft_ola) keeps the exact-fold
    Rs | N layout."""
    return pipeline.fused_ok(cfg, rs) and synth_supported(cfg.n_fft, rs)


def _fused1_ok(cfg: PvocConfig, rs: int) -> bool:
    """The single-kernel body: integer k on the exact-fold layout."""
    return _fused_chunk_ok(cfg, rs) and rs % cfg.hop == 0


def _local_signal(x_sh: torch.Tensor, x_tail: torch.Tensor, n_halo: int, mesh: Mesh) -> torch.Tensor:
    """The rank's span and the first n_halo samples after it: the right
    neighbour's head, or the recording's tail on the last rank."""
    halo = mesh.shift(x_sh[..., :n_halo], "seq", -1)
    if mesh.index("seq") == mesh.size("seq") - 1:
        halo = x_tail
    return torch.cat([x_sh, halo], dim=-1)


def _exchange_tails(ola: torch.Tensor, norm: torch.Tensor, F: int, rs: int, mesh: Mesh):
    """Add the left neighbour's OLA tail (and its window energy) into this
    rank's head and normalize. ola (..., F*rs + tail), norm (F*rs + tail,).
    Returns (main (..., F*rs), normalized tail (..., tail))."""
    tail_len = ola.shape[-1] - F * rs
    recv_y = mesh.shift(ola[..., F * rs :], "seq", +1)
    recv_n = mesh.shift(norm[F * rs :], "seq", +1)
    main = ola[..., : F * rs].clone()
    main[..., :tail_len] += recv_y
    main_norm = norm[: F * rs].clone()
    main_norm[:tail_len] += recv_n
    main_out = main / torch.clamp_min(main_norm, _EPS)
    tail_out = ola[..., F * rs :] / torch.clamp_min(norm[F * rs :], _EPS)
    return main_out, tail_out


def _chunked_body(x_sh, x_tail, nf: int, cfg: PvocConfig, rs: int, F: int, mesh: Mesh):
    """The polar chunk body on one rank: x_sh (F*Ra,) its span, x_tail
    (N-Ra,) the samples after the last span. Returns (main (F*rs,),
    normalized tail (N-rs,))."""
    n, ra = cfg.n_fft, cfg.hop
    d = mesh.index("seq")
    mag, phi = pipeline.analyze(_local_signal(x_sh, x_tail, n - ra, mesh), cfg)  # (F, nb)

    # Phase halo: the right neighbour's first phase row for the boundary
    # increment (zeros on the last rank).
    phi_ext = torch.cat([phi, mesh.shift(phi[0:1], "seq", -1)])
    th, tl = phase.residual_terms_c(phi_ext, ra, rs, n)  # (F, nb) pairs
    g = d * F + torch.arange(F, device=phi.device)  # global frame indices
    vm = (g < nf - 1)[:, None].to(th.dtype)  # no increment past the last frame
    th, tl = th * vm, tl * vm
    incl_h, incl_l = phase.blocked_scan(phase.wrap_add_c, (th, tl))
    local_excl = tuple(torch.cat([torch.zeros_like(a[:1]), a[:-1]]) for a in (incl_h, incl_l))
    totals = torch.stack(mesh.all_gather(torch.stack([incl_h[-1], incl_l[-1]]), "seq"))
    pref_h, pref_l = phase.blocked_scan(phase.wrap_add_c, (totals[:, 0], totals[:, 1]))
    carry = tuple(
        torch.cat([torch.zeros_like(a[:1]), a[:-1]])[d][None, :] for a in (pref_h, pref_l)
    )
    res_h, res_l = phase.wrap_add_c(carry, local_excl)
    phi0 = mesh.all_gather(phi[0], "seq")[0]  # the global phi[0]
    psi = phase.finalize_phase(phi0, res_h + res_l, rs, n, frame_offset=d * F)
    psi = phase.pin_real_bins(psi, phi, rs, n, frame_offset=d * F)

    mask = (g < nf).to(mag.dtype)
    w = hann_window(n, mag.device)
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
    return _exchange_tails(ola, norm, F, rs, mesh)


def _closed_form_phasors(ure, uim, F: int, rs: int, ra: int, n_fft: int, mesh: Mesh):
    """P = u_0 (u conj(u_0))^k with u_0 the first frame of seq rank 0
    (integer k). ure, uim (B, F, nb). The forced-real bins take
    P = u spin^g, g the global frame index (the telescoped pass-through)."""
    u0 = mesh.all_gather(torch.stack([ure[:, 0], uim[:, 0]], dim=1), "seq")[0]
    u0re, u0im = u0[:, 0:1], u0[:, 1:2]  # (B, 1, nb)
    zre = ure * u0re + uim * u0im
    zim = uim * u0re - ure * u0im
    wre, wim = _pow_k(zre, zim, rs, ra)
    pre = wre * u0re - wim * u0im
    pim = wre * u0im + wim * u0re
    nh = n_fft // 2
    g = mesh.index("seq") * F + torch.arange(F, device=ure.device)
    spin = 1.0 - 2.0 * ((g % 2 == 1) & bool(rs % 2)).to(ure.dtype)  # (F,)
    pre[..., 0], pim[..., 0] = ure[..., 0], uim[..., 0]
    pre[..., nh], pim[..., nh] = ure[..., nh] * spin, uim[..., nh] * spin
    return pre, pim


def _scanned_phasors(ure, uim, pre, pim, nf: int, F: int, rs: int, ra: int, n_fft: int, mesh: Mesh):
    """q >= 2: P of the rank's frames from its local scan (pre, pim: the
    kernel's renormalized prefix product of the rank's own terms, whose
    first is the rank's first unit phasor u_0), the boundary step term b
    from the left neighbour's last unit phasor, and the exclusive product
    of the all-gathered per-rank totals. All (B, F, nb).

    The JAX body replaces the first term by b before a scan of its own;
    here the scanned product is re-based instead, P' = P b conj(u_0) (the
    same product with b first), so the local product keeps the grouping of
    the single-recording kernel's scan: a tree-ordered scan drifts away
    from it linearly with length on stationary tones (PERF.md, PR 4).
    Frames past the recording do not enter the totals."""
    d = mesh.index("seq")
    u_prev = mesh.shift(torch.stack([ure[:, F - 1], uim[:, F - 1]], dim=1), "seq", +1)
    if d > 0:  # rank 0 keeps the anchor term u_0
        bre, bim = boundary_step_term(ure[:, 0], uim[:, 0], u_prev[:, 0], u_prev[:, 1], n_fft, ra, rs)
        fre = (bre * ure[:, 0] + bim * uim[:, 0])[:, None]  # b conj(u_0)
        fim = (bim * ure[:, 0] - bre * uim[:, 0])[:, None]
        pre, pim = pre * fre - pim * fim, pre * fim + pim * fre
    last = min(F, nf - d * F) - 1  # the rank's last frame of the recording
    if last >= 0:
        total = torch.stack([pre[:, last], pim[:, last]])
    else:
        total = torch.stack([torch.ones_like(pre[:, 0]), torch.zeros_like(pim[:, 0])])
    totals = torch.stack(mesh.all_gather(total, "seq"))  # (D, 2, B, nb)
    cre, cim = phasor_prefix_exclusive(totals[:, 0], totals[:, 1])  # (D, B, nb)
    cre, cim = cre[d][:, None], cim[d][:, None]
    pre, pim = pre * cre - pim * cim, pre * cim + pim * cre
    inv = torch.rsqrt(torch.clamp_min(pre * pre + pim * pim, 1e-30))
    return pre * inv, pim * inv


def _chunked_body_fused(x_sh, x_tail, nf: int, cfg: PvocConfig, rs: int, F: int, mesh: Mesh,
                        batched: bool):
    """The split phasor body on one rank: x_sh (B, F*Ra) rows of its span
    (batched) or (F*Ra,), x_tail the samples after the last span. Returns
    (main (..., F*rs), normalized tail (..., N-rs))."""
    n, ra = cfg.n_fft, cfg.hop
    x_loc = _local_signal(x_sh, x_tail, n - ra, mesh)
    scan = rs % ra != 0  # integer k needs only the unit phasors
    if batched:
        mag, pre, pim, ure, uim, _ = stft_phasor_terms_batch(x_loc, n, ra, rs, scan=scan, return_u=True)
    else:
        mag, pre, pim, ure, uim = (
            p[None] for p in stft_phasor_terms(x_loc, n, ra, rs, scan=scan, return_u=True)[:5]
        )
    if scan:
        pre, pim = _scanned_phasors(ure, uim, pre, pim, nf, F, rs, ra, n, mesh)
    else:
        pre, pim = _closed_form_phasors(ure, uim, F, rs, ra, n, mesh)

    mask = (mesh.index("seq") * F + torch.arange(F, device=mag.device) < nf).to(mag.dtype)
    if batched:
        ola = phasor_istft_ola_batch(mag, pre, pim, n, rs, F, frame_mask=mask.expand(mag.shape[0], F))
    else:
        ola = phasor_istft_ola(mag[0], pre[0], pim[0], n, rs, F, frame_mask=mask)
    norm = framing.ola_window_norm(hann_window(n, mag.device), F, rs, eps=0.0, method="fold",
                                   frame_mask=mask)
    return _exchange_tails(ola, norm, F, rs, mesh)


def _anchor(frame: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(2, N/2-1) unit phasor of the general bins of one frame, from the
    Hann-windowed DFT as FP32 matrix products (the JAX body's anchor)."""
    re, im = fft_ops.rfft(frame[None], backend="matmul", fused_window=True)
    _, ure, uim = _unit(re[0, 1 : n_fft // 2], im[0, 1 : n_fft // 2])
    return torch.stack([ure, uim])


def _chunked_body_fused1(x_sh, x_tail, nf: int, cfg: PvocConfig, rs: int, F: int, mesh: Mesh):
    """The single-kernel body on one rank (integer k): returns its F output
    rows (F*rs,), normalized, the left neighbour's spill added."""
    n, ra = cfg.n_fft, cfg.hop
    m = n // rs
    d, D = mesh.index("seq"), mesh.size("seq")
    x_loc = _local_signal(x_sh, x_tail, n - ra, mesh)
    carry = init_carry(n, x_loc.device)
    if D > 1:
        carry[:2] = mesh.all_gather(_anchor(x_loc[:n], n), "seq")[0]
    out, _, tail = fused_stream_segment(
        x_loc, carry, x_loc.new_zeros((m - 1, rs)), d > 0, d * F, nf, n, ra, rs, F,
        x_frame0=d * F,
    )
    recv = mesh.shift(tail, "seq", +1)  # zeros on rank 0
    rows = out.view(F, rs)
    rows[: m - 1] += _normalize_rows(recv, d * F, nf, n, rs)
    return out


def _split(x: torch.Tensor, F: int, D: int, cfg: PvocConfig, d: int):
    """(rank d's span of F*Ra samples, the N-Ra samples after the last
    span) of x (..., T), zero-padded."""
    n, ra = cfg.n_fft, cfg.hop
    span = F * D * ra
    full = torch.nn.functional.pad(x, (0, max(0, span + (n - ra) - x.shape[-1])))
    return full[..., d * F * ra : (d + 1) * F * ra], full[..., span : span + n - ra]


def _gather_parts(main: torch.Tensor, tail: torch.Tensor | None, mesh: Mesh) -> torch.Tensor:
    """Every rank's main part in order along "seq", then the last rank's
    tail: the whole output on every rank."""
    width = main.shape[-1]
    part = main if tail is None else torch.cat([main, tail], dim=-1)
    parts = mesh.all_gather(part, "seq")
    out = [p[..., :width] for p in parts]
    if tail is not None:
        out.append(parts[-1][..., width:])
    return torch.cat(out, dim=-1)


def chunked_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
    force: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Time-stretch ONE recording split over the mesh's "seq" axis; every
    rank calls it with the whole recording and gets the whole output.

    The same math as pipeline.time_stretch (within f32 round-off: the
    phase carry factorizes exactly across chunks); falls back to it when
    the recording is too short to split, or on a world of one unless
    force=True (the chunked program itself on one device, the scaling
    denominator). Tensors stay on their device; anything else goes to
    `device` as float32.
    """
    with profiling.span("pv.chunked_time_stretch"):
        x = pipeline._as_signal(x, device)
        rs = cfg.synthesis_hop(stretch)
        n, ra = cfg.n_fft, cfg.hop
        nf = framing.num_frames(x.shape[-1], n, ra)
        if nf <= 0:
            return x.new_zeros((0,))
        if mesh is None:
            mesh = make_mesh(axis="seq")
        D, d = mesh.size("seq"), mesh.index("seq")
        out_len = framing.output_length(nf, n, rs)

        if _fused1_ok(cfg, rs):
            # F a multiple of the segment's scan chunk, sized so that the OLA
            # spill rows nf..nf+m-2 land inside the last rank's span.
            per_rank = -(-(nf + n // rs - 1) // D)
            F = -(-per_rank // SCAN_CHUNK) * SCAN_CHUNK
            if (D == 1 and not force) or F < min_frames_per_device(cfg, rs):
                return pipeline.time_stretch(x, stretch, cfg)
            x_sh, x_tail = _split(x, F, D, cfg, d)
            main = _chunked_body_fused1(x_sh, x_tail, nf, cfg, rs, F, mesh)
            return _gather_parts(main, None, mesh)[:out_len]

        F = -(-nf // D)
        if (D == 1 and not force) or F < min_frames_per_device(cfg, rs):
            return pipeline.time_stretch(x, stretch, cfg)
        x_sh, x_tail = _split(x, F, D, cfg, d)
        if _fused_chunk_ok(cfg, rs):
            main, tail = _chunked_body_fused(x_sh, x_tail, nf, cfg, rs, F, mesh, batched=False)
        else:
            main, tail = _chunked_body(x_sh, x_tail, nf, cfg, rs, F, mesh)
        return _gather_parts(main, tail, mesh)[:out_len]


def batched_chunked_time_stretch(
    xs,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
    device="cuda",
) -> torch.Tensor:
    """Stretch a (B, T) batch data-parallel over the mesh's "data" axis AND
    sequence-parallel over its "seq" axis (B divisible by the "data" size).
    Every rank gets the whole (B, (nf-1)*Rs + N) output."""
    with profiling.span("pv.batched_chunked_time_stretch"):
        xs = xs.to(torch.float32).contiguous() if isinstance(xs, torch.Tensor) else (
            torch.as_tensor(xs, dtype=torch.float32, device=device))
        if xs.dim() != 2:
            raise ValueError(f"expected (B, T) batch, got shape {tuple(xs.shape)}")
        rs = cfg.synthesis_hop(stretch)
        n, ra = cfg.n_fft, cfg.hop
        nf = framing.num_frames(xs.shape[-1], n, ra)
        if nf <= 0:
            return xs.new_zeros((xs.shape[0], 0))
        if mesh is None or "seq" not in mesh.shape or "data" not in mesh.shape:
            raise ValueError("batched_chunked_time_stretch needs a ('data', 'seq') mesh")
        D = mesh.size("seq")
        F = -(-nf // D)
        if F < min_frames_per_device(cfg, rs):
            raise ValueError(
                f"recording too short to chunk over {D} devices "
                f"(need >= {min_frames_per_device(cfg, rs) * D} frames, have {nf})"
            )
        B, data = xs.shape[0], mesh.size("data")
        if B % data:
            raise ValueError(f"batch of {B} rows does not split over {data} data ranks")
        local = B // data
        i = mesh.index("data")
        x_sh, x_tail = _split(xs[i * local : (i + 1) * local], F, D, cfg, mesh.index("seq"))
        if _fused_chunk_ok(cfg, rs):
            main, tail = _chunked_body_fused(x_sh, x_tail, nf, cfg, rs, F, mesh, batched=True)
        else:
            parts = [_chunked_body(a, b, nf, cfg, rs, F, mesh) for a, b in zip(x_sh, x_tail)]
            main, tail = (torch.stack(p) for p in zip(*parts))
        rows = _gather_parts(main, tail, mesh)
        return torch.cat(mesh.all_gather(rows, "data"))[:, : framing.output_length(nf, n, rs)]

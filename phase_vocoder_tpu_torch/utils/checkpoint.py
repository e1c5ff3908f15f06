"""Segment-batch checkpoint/resume for long streaming runs (counterpart of
phase_vocoder_tpu/utils/checkpoint.py).

The only cross-segment state of either streaming executor is a few KB
(streaming.StreamState for the polar one, streaming.FusedStreamState for
the fused one), so hour-long jobs checkpoint at segment-batch granularity:
each batch's output lands in a numbered part_{b:06d}.npy and the state in
state_{b:06d}.npz (np.savez of its fields, host ints included), both
written to a temporary file and renamed into place. The state file is the
commit point: a killed job resumes after the last batch whose state was
saved. A resumed fused run is bitwise equal to an uninterrupted one, and so
is a polar run on the fused backend's kernels.

The JAX package stores its state with orbax; a state tree it saved (numpy
arrays, as its _state_to_tree gives them) continues here through
stream_state_from_jax_tree and fused_stream_state_from_jax_tree.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os

import numpy as np
import torch

from .. import pipeline, streaming
from ..config import PvocConfig
from ..ops import framing
from ..ops.fused import stream_norm_tables

__all__ = [
    "StreamCheckpointer",
    "checkpointed_stream_time_stretch",
    "checkpointed_fused_stream_time_stretch",
    "stream_state_from_jax_tree",
    "fused_stream_state_from_jax_tree",
]

_PART_DTYPES = ("float32", "bfloat16", "int16")


def _encode_part_device(out: torch.Tensor, part_dtype: str) -> torch.Tensor:
    """Encode a batch's output on its device before the host copy.
    'bfloat16' and 'int16' halve the bytes copied and written; both are
    lossy (bf16: 8-bit mantissa; int16: PCM quantization, half to even as
    jnp.round, and a clip at +-1), so 'float32' stays the default, which
    keeps resume bitwise equal to the uninterrupted f32 run."""
    if part_dtype == "float32":
        return out
    if part_dtype == "bfloat16":
        return out.to(torch.bfloat16)
    if part_dtype == "int16":
        return torch.clamp(torch.round(out * 32767.0), -32768.0, 32767.0).to(torch.int16)
    raise ValueError(f"unknown part_dtype {part_dtype!r}")


def _part_to_numpy(enc: torch.Tensor) -> np.ndarray:
    """The device->host copy of an encoded part; bfloat16 travels as its
    uint16 bits (numpy has no bfloat16)."""
    if enc.dtype == torch.bfloat16:
        return enc.view(torch.int16).cpu().numpy().view(np.uint16)
    return enc.cpu().numpy()


def _decode_part(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.int16:
        return arr.astype(np.float32) / 32767.0
    if arr.dtype == np.uint16:  # bfloat16 bits: the high half of a float32
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr, np.float32)


def _state_to_tree(state) -> dict:
    """The state's fields as numpy arrays (tensors copied to the host)."""
    if isinstance(state, dict):
        return state
    tree = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        tree[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return tree


def _tree_to_state(tree: dict, device=None) -> streaming.StreamState:
    """A polar StreamState from a tree of numpy arrays (this package's or the
    JAX package's: same field names)."""
    tree = dict(tree)
    # Migration: checkpoints written before the compensated-pair carry lack
    # psi_carry_lo. lo = 0 is a valid, merely uncompensated, state.
    if "psi_carry_lo" not in tree and "psi_carry" in tree:
        tree["psi_carry_lo"] = np.zeros_like(np.asarray(tree["psi_carry"]))

    def t(name, dtype):
        return torch.as_tensor(np.array(tree[name]), device=device).to(dtype)

    return streaming.StreamState(
        phi_prev=t("phi_prev", torch.float32),
        psi_carry=t("psi_carry", torch.float32),
        psi_carry_lo=t("psi_carry_lo", torch.float32),
        phi0=t("phi0", torch.float32),
        ola_tail=t("ola_tail", torch.float32),
        norm_tail=t("norm_tail", torch.float32),
        started=t("started", torch.bool),
        frame_offset=t("frame_offset", torch.int64),
    )


def _tree_to_fused_state(tree: dict, device=None) -> streaming.FusedStreamState:
    return streaming.FusedStreamState(
        carry=torch.as_tensor(np.asarray(tree["carry"], np.float32), device=device),
        tail=torch.as_tensor(np.asarray(tree["tail"], np.float32), device=device),
        started=int(tree["started"]),
        frame_offset=int(tree["frame_offset"]),
    )


def stream_state_from_jax_tree(tree: dict, device=None) -> streaming.StreamState:
    """The JAX package's polar StreamState tree (numpy arrays) as this
    package's StreamState; the legacy tree without psi_carry_lo migrates."""
    return _tree_to_state(tree, device)


def fused_stream_state_from_jax_tree(
    tree: dict, n_fft: int, rs: int, device=None
) -> streaming.FusedStreamState:
    """The JAX package's FusedStreamState tree (numpy arrays) as this
    package's FusedStreamState.

    Its (4, nbq) carry is lane-padded: lanes 1..N/2-1 hold bins 1..N/2-1
    and lane 0 is unused; the port keeps the general bins only. Where the
    JAX kernel folds the interior COLA normalization into its synthesis
    rows (its default path: N/2 a multiple of 128 lanes, Rs <= N/2), its
    OLA tail comes out interior-normalized; the port's tail is the
    un-normalized sum, so the interior row is divided back out.
    """
    nh = n_fft // 2
    carry = np.asarray(tree["carry"], np.float32)[:, 1:nh]
    tail = np.asarray(tree["tail"], np.float32)
    if nh % 128 == 0 and 2 * rs <= n_fft:
        m = -(-n_fft // rs)
        interior = stream_norm_tables(n_fft, rs, m - 1)[2 * m - 2]
        tail = (tail.astype(np.float64) / interior.astype(np.float64)).astype(np.float32)
    return streaming.FusedStreamState(
        carry=torch.as_tensor(np.ascontiguousarray(carry), device=device),
        tail=torch.as_tensor(tail, device=device),
        started=int(tree["started"]),
        frame_offset=int(tree["frame_offset"]),
    )


def _pipelined_batches(ck, run_batch, state, next_batch, n_batches, fail_after):
    """Drive batches with a one-deep fetch/save pipeline.

    Per batch: the device work of batch b is queued, its encoded output is
    copied to the host (which waits for it), and then the save of batch b
    goes to a single worker thread while the loop queues batch b+1; the
    save of b-1 is awaited first, so saves stay strictly ordered and the
    state save remains the commit point. `fail_after` raises after that
    many saves have completed, mimicking a preemption.
    """
    done = 0
    prev = None
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        for batch in range(next_batch, n_batches):
            enc, state = run_batch(state, batch)
            arr = _part_to_numpy(enc)
            tree = _state_to_tree(state)
            if prev is not None:
                prev.result()
                done += 1
                if fail_after is not None and done >= fail_after:
                    raise RuntimeError(f"injected failure after {done} batches")
            prev = ex.submit(ck.save_batch, batch, arr, tree)
        if prev is not None:
            prev.result()
            done += 1
            if fail_after is not None and done >= fail_after:
                raise RuntimeError(f"injected failure after {done} batches")
    return state


class StreamCheckpointer:
    """Persists (batch index, state, output parts) under a directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def write_manifest(self, meta: dict) -> None:
        with open(self._manifest_path(), "w") as f:
            json.dump(meta, f)

    def read_manifest(self) -> dict | None:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def check_manifest(self, meta: dict) -> None:
        """Raise if the directory holds another run; then record `meta`."""
        existing = self.read_manifest()
        if existing is not None:
            old = dict(existing)
            old.setdefault("part_dtype", "float32")  # written before part dtypes
            if old != meta:
                raise ValueError(
                    f"checkpoint dir {self.directory!r} holds a different run: "
                    f"{existing} != {meta}"
                )
        self.write_manifest(meta)

    # -- parts + state -----------------------------------------------------
    def _state_path(self, batch: int) -> str:
        return os.path.join(self.directory, f"state_{batch:06d}.npz")

    def _part_path(self, batch: int) -> str:
        return os.path.join(self.directory, f"part_{batch:06d}.npy")

    def save_batch(self, batch: int, out: np.ndarray, state) -> None:
        """Write batch `batch`'s output part, then its state (the commit
        point), each through a temporary file and a rename; older states
        are pruned."""
        part = self._part_path(batch)
        tmp = part + ".tmp.npy"
        np.save(tmp, np.asarray(out))
        os.replace(tmp, part)
        path = self._state_path(batch)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **_state_to_tree(state))
        os.replace(tmp, path)
        for old in self.completed_batches()[:-1]:
            try:
                os.remove(self._state_path(old))
            except FileNotFoundError:
                pass

    def completed_batches(self) -> list[int]:
        done = []
        for name in os.listdir(self.directory):
            if name.startswith("state_") and name.endswith(".npz"):
                try:
                    done.append(int(name[len("state_") : -len(".npz")]))
                except ValueError:
                    continue
        return sorted(done)

    def latest_tree(self) -> tuple[int, dict] | None:
        """(batch, state tree of numpy arrays) of the newest checkpoint."""
        done = self.completed_batches()
        if not done:
            return None
        batch = done[-1]
        with np.load(self._state_path(batch)) as z:
            return batch, {k: z[k] for k in z.files}

    def latest(self, device=None) -> tuple[int, streaming.StreamState] | None:
        """(batch, polar StreamState on `device`) of the newest checkpoint."""
        found = self.latest_tree()
        if found is None:
            return None
        batch, tree = found
        return batch, _tree_to_state(tree, device)

    def load_parts(self, up_to_batch: int) -> list[np.ndarray]:
        return [_decode_part(np.load(self._part_path(b))) for b in range(up_to_batch + 1)]


def _check_part_dtype(part_dtype: str) -> None:
    if part_dtype not in _PART_DTYPES:
        raise ValueError(f"unknown part_dtype {part_dtype!r}")


def _checkpointed(ck, meta, init_state, load_state, scan, S, batch_segments, part_dtype,
                  fail_after):
    """Run the S segments of a stream in batches of `batch_segments` under
    `ck`, resuming after its newest saved state (load_state(tree)) or
    starting from init_state(). scan(state, count) runs `count` segments
    from `state` and returns (their output, the new state). Returns the
    final state and every part's output, concatenated on the host."""
    ck.check_manifest(meta)
    found = ck.latest_tree()
    if found is None:
        next_batch, state = 0, init_state()
    else:
        next_batch, state = found[0] + 1, load_state(found[1])
    n_batches = -(-S // batch_segments)

    def run_batch(state, batch):
        out, state = scan(state, min(batch_segments, S - batch * batch_segments))
        return _encode_part_device(out, part_dtype), state

    state = _pipelined_batches(ck, run_batch, state, next_batch, n_batches, fail_after)
    return state, np.concatenate(ck.load_parts(n_batches - 1))


def checkpointed_stream_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    checkpoint_dir: str = "pvoc_ckpt",
    segment_frames: int = streaming.DEFAULT_SEGMENT_FRAMES,
    batch_segments: int = 8,
    part_dtype: str = "float32",
    device="cuda",
    _fail_after_batches: int | None = None,
) -> torch.Tensor:
    """stream_time_stretch with segment-batch checkpointing.

    Re-running after a crash resumes after the last completed batch and
    returns the same waveform. `_fail_after_batches` is a fault-injection
    hook for tests (raises after N saved batches, mimicking preemption).
    part_dtype: 'float32' (default), 'bfloat16' or 'int16' for the output
    parts (see _encode_part_device). Tensors stay on their device;
    anything else goes to `device`.
    """
    _check_part_dtype(part_dtype)
    x = pipeline._as_signal(x, device)
    rs = cfg.synthesis_hop(stretch)
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    if nf <= 0:
        return x.new_zeros((0,))
    F, S = streaming.plan_segments(nf, cfg, rs, segment_frames)
    x_pad = streaming.pad_for_segments(x, cfg, F, S)
    meta = {
        "nf": nf, "F": F, "S": S, "rs": rs, "stretch": stretch,
        "n_fft": cfg.n_fft, "hop": cfg.hop,
        "batch_segments": batch_segments, "part_dtype": part_dtype,
    }
    state, main = _checkpointed(
        StreamCheckpointer(checkpoint_dir), meta,
        lambda: streaming.init_state(cfg, rs, dtype=x.dtype, device=x.device),
        lambda tree: _tree_to_state(tree, x.device),
        lambda state, count: streaming._stream_scan_from(x_pad, state, nf, cfg, rs, F, count),
        S, batch_segments, part_dtype, _fail_after_batches,
    )
    out = torch.cat([torch.as_tensor(main, device=x.device), streaming.flush_tail(state)])
    return out[: framing.output_length(nf, cfg.n_fft, rs)]


def checkpointed_fused_stream_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    checkpoint_dir: str = "pvoc_ckpt",
    segment_frames: int = streaming.DEFAULT_FUSED_SEGMENT_FRAMES,
    batch_segments: int = 8,
    part_dtype: str = "float32",
    device="cuda",
    _fail_after_batches: int | None = None,
) -> torch.Tensor:
    """fused_stream_time_stretch with segment-batch checkpointing.

    Same contract as checkpointed_stream_time_stretch, riding the fused
    segment kernel: with float32 parts, an interrupted and resumed run
    returns the waveform of fused_stream_time_stretch bit for bit (and so
    of the single-recording fused kernel). Requires the fused_ok geometry.
    """
    _check_part_dtype(part_dtype)
    x = pipeline._as_signal(x, device)
    rs = cfg.synthesis_hop(stretch)
    if not pipeline.fused_ok(cfg, rs):
        raise ValueError("checkpointed fused stream requires the fused-kernel geometry")
    n, ra = cfg.n_fft, cfg.hop
    nf = framing.num_frames(x.shape[-1], n, ra)
    if nf <= 0:
        return x.new_zeros((0,))
    F, S = streaming.fused_plan_segments(nf, n, rs, segment_frames)
    meta = {
        "nf": nf, "F": F, "S": S, "rs": rs, "stretch": stretch,
        "n_fft": n, "hop": ra, "batch_segments": batch_segments,
        "kind": "fused", "part_dtype": part_dtype,
    }
    _, out = _checkpointed(
        StreamCheckpointer(checkpoint_dir), meta,
        lambda: streaming.fused_init_state(n, rs, x.device),
        lambda tree: _tree_to_fused_state(tree, x.device),
        lambda state, count: streaming._fused_scan_from(x, state, nf, n, ra, rs, F, count),
        S, batch_segments, part_dtype, _fail_after_batches,
    )
    return torch.as_tensor(out, device=x.device)[: framing.output_length(nf, n, rs)]

"""Rank meshes over torch.distributed (counterpart of
phase_vocoder_tpu/parallel/mesh.py).

The JAX package lays its devices out as a jax.sharding.Mesh with axes
"data" (utterance batches) and "seq" (time chunks of one recording), and
XLA inserts the collectives. Here one process drives one device, so a mesh
is a grid of the ranks of the default process group, with one process
group per row and column, and the parallel bodies call the few
collectives they need themselves: an all-gather and a shift to the next
or previous rank along an axis (a ppermute).

Without a process group a mesh is a world of one: every axis has size 1,
an all-gather returns its input and a shift returns zeros, what ppermute
gives a rank with no neighbour. Tensors go through the group's backend as
they are (NCCL for CUDA tensors); a gloo group, which cannot take them,
gets CUDA tensors staged through host memory. That is the case of several
processes sharing one card, where NCCL refuses to run.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_mesh_2d"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks with named axes, row-major: the rank at coordinates
    (i, j) of a ("data", "seq") mesh is i * seq + j.

    shape: {axis: size}, in axis order; coords: {axis: this rank's index};
    ranks: {axis: global ranks of this rank's group along the axis, in
    order}; groups: {axis: its process group, or None for an axis of size
    1}.
    """

    shape: dict
    coords: dict
    ranks: dict
    groups: dict

    def size(self, axis: str | None = None) -> int:
        """Ranks along `axis`, or in the whole mesh."""
        return self.shape[axis] if axis is not None else math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def all_gather(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """Every rank's x along `axis`, in index order (x has one shape on
        all of them)."""
        if self.shape[axis] == 1:
            return [x]
        group = self.groups[axis]
        xs = _staged(x.contiguous(), group)
        parts = [torch.empty_like(xs) for _ in range(self.shape[axis])]
        dist.all_gather(parts, xs, group=group)
        return [p.to(x.device) for p in parts]

    def shift(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """x of the rank `step` places before this one along `axis` (step
        +1: every rank sends to its right neighbour; -1: to its left);
        zeros where there is none."""
        n, i = self.shape[axis], self.coords[axis]
        if n == 1:
            return torch.zeros_like(x)
        group = self.groups[axis]
        xs = _staged(x.contiguous(), group)
        buf = torch.zeros_like(xs)
        ops = []
        if 0 <= i + step < n:
            ops.append(dist.P2POp(dist.isend, xs, self.ranks[axis][i + step], group))
        if 0 <= i - step < n:
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[axis][i - step], group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf.to(x.device)


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's backend takes it: a host copy for gloo."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _build(axes: tuple, sizes: tuple) -> Mesh:
    """The mesh of `sizes` over every rank of the default group. Each
    process builds every axis group (new_group is collective), keeping
    those it belongs to."""
    world, rank = _world()
    if math.prod(sizes) != world:
        raise ValueError(
            f"mesh {dict(zip(axes, sizes))} needs {math.prod(sizes)} processes, "
            f"the process group has {world} (one process per device)"
        )
    strides = [math.prod(sizes[a + 1 :]) for a in range(len(axes))]
    coords = {ax: (rank // st) % n for ax, st, n in zip(axes, strides, sizes)}
    ranks, groups = {}, {}
    for a, (ax, st, n) in enumerate(zip(axes, strides, sizes)):
        # The lines of axis a: ranks that agree on every other coordinate.
        base = rank - coords[ax] * st
        ranks[ax] = [base + k * st for k in range(n)]
        if n == 1:
            groups[ax] = None
        elif n == world:
            groups[ax] = dist.group.WORLD
        else:
            for start in range(world):
                if (start // st) % n:
                    continue  # not the first rank of its line
                line = [start + k * st for k in range(n)]
                g = dist.new_group(line)
                if rank in line:
                    groups[ax] = g
    return Mesh(shape=dict(zip(axes, sizes)), coords=coords, ranks=ranks, groups=groups)


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    """1-D mesh over every rank (one device each; default: the world size,
    1 without a process group)."""
    world, _ = _world()
    return _build((axis,), (world if n_devices is None else n_devices,))


def make_mesh_2d(data: int, seq: int) -> Mesh:
    """2-D (data, seq) mesh: DP over utterances x SP over time chunks;
    data * seq must be the world size."""
    return _build(("data", "seq"), (data, seq))

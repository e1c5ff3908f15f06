"""Parallel layer: rank meshes over torch.distributed, data-parallel
batches, sequence-parallel chunking with halo exchange and collective
phase-state carry."""

from .mesh import Mesh, make_mesh, make_mesh_2d  # noqa: F401
from .batch import (  # noqa: F401
    batch_time_stretch,
    batch_time_stretch_ragged,
    batch_time_stretch_varied,
)
from .chunked import batched_chunked_time_stretch, chunked_time_stretch  # noqa: F401

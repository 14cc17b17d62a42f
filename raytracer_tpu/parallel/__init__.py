"""Parallel / distributed layer: device meshes, sharded rendering, multi-process.

See SURVEY.md §2.4 — the reference is single-threaded; these components are
derived from its loop structure, not its code.
"""

from .mesh import RAYS_AXIS, make_mesh, pad_to_multiple, ray_sharded, replicated
from .sharding import (render_linear_sharded, render_linear_sharded_fast,
                       ray_trace_sharded)
from .distributed import initialize_distributed, is_multi_host, host_local_mesh

__all__ = [
    "RAYS_AXIS", "make_mesh", "pad_to_multiple", "ray_sharded", "replicated",
    "render_linear_sharded", "render_linear_sharded_fast",
    "ray_trace_sharded",
    "initialize_distributed", "is_multi_host", "host_local_mesh",
]

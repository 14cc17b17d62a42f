"""Device-mesh construction.

The reference has zero parallelism (one thread, SURVEY.md §2.4); the
scale-out axis here is the ray wavefront.  The mesh follows the algorithm:
one 1-D ``rays`` axis — the scene is tiny and replicated, pixels are the
sharded dimension, and the only collectives are the gradient psum and the
stats reduction.  Cards joined all to all (NVLink) need no other shape.

In multi-process runs, build the mesh AFTER ``jax.distributed.initialize()``;
``make_mesh`` uses all visible devices by default.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAYS_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = RAYS_AXIS
              ) -> Mesh:
    """1-D mesh over the first ``n_devices`` visible devices."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} visible")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh, axis_name: str = RAYS_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m

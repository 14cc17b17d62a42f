"""Multi-host runtime glue.

The reference has no communication backend at all (SURVEY.md §2.4); the
equivalent here is JAX's built-in distributed runtime: process coordination
via ``jax.distributed.initialize`` and collectives inside compiled programs
(NCCL between GPUs).  No custom transport is written — this module owns
process bootstrap and mesh construction policy only.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh

from .mesh import RAYS_AXIS

_INITIALIZED = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    Multi-process runs pass the coordinator (``host:port``), the process
    count and this process's id explicitly; a ``COORDINATOR_ADDRESS``
    environment variable supplies the first.  Safe to call on single-process
    setups: with no coordinator it is a no-op.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _INITIALIZED = True


def is_multi_host() -> bool:
    return jax.process_count() > 1


def host_local_mesh(axis_name: str = RAYS_AXIS) -> Mesh:
    """Mesh over this process's addressable devices only (for host-local
    work like debugging; global meshes come from parallel.mesh.make_mesh)."""
    return Mesh(np.asarray(jax.local_devices()), (axis_name,))

"""Device mesh construction and multi-host runtime helpers.

The reference is single-process (SURVEY.md §2.3) — this module is the
framework's scaling substrate. One canonical 1-D mesh axis, ``"frames"``,
carries the sequence/frame-parallel dimension (long recordings sharded by
contiguous frame blocks); an optional leading ``"batch"`` axis carries data
parallelism over independent signals. On a GPU host the collectives ride
NVLink; ``initialize_distributed`` brings up the multi-host runtime.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frames"
BATCH_AXIS = "batch"


def make_mesh(n_devices: int | None = None, axis_name: str = FRAME_AXIS,
              devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(batch: int, frames: int, devices=None) -> Mesh:
    """``(batch, frames)`` mesh: data parallel x frame/sequence parallel."""
    if devices is None:
        devices = jax.devices()
    if batch * frames > len(devices):
        raise ValueError(
            f"mesh {batch}x{frames} needs {batch * frames} devices, "
            f"have {len(devices)}")
    grid = np.asarray(devices[:batch * frames]).reshape(batch, frames)
    return Mesh(grid, (BATCH_AXIS, FRAME_AXIS))


def initialize_distributed(**kwargs) -> None:
    """Bring up the JAX multi-host runtime (no-op if already initialized).

    Call this once per process before building meshes; the kwargs go to
    ``jax.distributed.initialize`` (``coordinator_address``,
    ``num_processes``, ``process_id`` — required where no cluster manager
    tells JAX of the cluster).
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def shard_along(x, mesh: Mesh, axis_name: str = FRAME_AXIS, dim: int = 0):
    """Place ``x`` with dimension ``dim`` sharded over ``axis_name``."""
    spec = [None] * np.ndim(x)
    spec[dim] = axis_name
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))

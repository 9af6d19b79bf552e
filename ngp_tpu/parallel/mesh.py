"""Device-mesh helpers for SPMD training/rendering.

The reference's only multi-device mechanism is CUDA peer-to-peer memcpy of
inference params for multi-GPU *rendering* (``sync_device``,
``src/testbed.cu:5063-5102``); training is single-GPU. This framework
replaces that wholesale with a ``jax.sharding.Mesh`` + ``shard_map`` SPMD
design (SURVEY.md §2.8): rays are the batch axis to shard (DP), the
hash-table + MLP params are replicated and their gradients ``psum``-ed across
devices, occupancy-grid updates are combined with a ``pmax`` collective.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices (all by
    default). Rays/samples shard over this axis; params replicate."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} present"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_rows(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))

"""Multi-host (multi-process) distribution scaffolding.

The reference has no cross-host story at all — its only multi-device code
is CUDA peer-to-peer memcpy for rendering (``src/testbed.cu:5063-5149``).
The framework scales past one host the JAX-native way (SURVEY §5.8):

* every process calls :func:`initialize` once (coordinator rendezvous —
  ``jax.distributed.initialize``), after which ``jax.devices()`` is the
  *global* device list;
* :func:`make_global_mesh` builds a 1-D DP mesh over all global devices,
  host-major, so the ray batch shards across hosts over the network and across a
  host's devices over its local links (NVLink);
* the DP train step (``ngp_tpu/parallel/nerf_dp.py``) is mesh-agnostic:
  gradient ``psum`` and occupancy ``pmax`` ride whatever links the mesh
  spans. Dataset pixels are replicated per host (they are read-only);
  each shard draws its own rays.

Env-variable driven so a pod launcher (GKE/SLURM/gcloud) can configure it
without code: ``NGP_COORDINATOR`` (host:port), ``NGP_NUM_PROCESSES``,
``NGP_PROCESS_ID`` — falling back to JAX's own autodetection (cluster
schedulers JAX knows populate these natively).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from ngp_tpu.parallel.mesh import DATA_AXIS

_initialized = False


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-process cluster. Call once per process before any
    device computation. No-ops for single-process runs (the common case)
    and when already initialized."""
    global _initialized
    if _initialized:
        return
    coordinator = coordinator or os.environ.get("NGP_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("NGP_NUM_PROCESSES", 0)) or None
    process_id = (
        process_id
        if process_id is not None
        else (int(os.environ["NGP_PROCESS_ID"]) if "NGP_PROCESS_ID" in os.environ else None)
    )
    if coordinator is None and num_processes is None:
        # Single process, or a cluster where JAX autodetects everything.
        if os.environ.get("NGP_AUTO_DISTRIBUTED"):
            jax.distributed.initialize()
            _initialized = True
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True


def make_global_mesh(axis: str = DATA_AXIS) -> Mesh:
    """1-D DP mesh over every device in the cluster, host-major (each
    host's local devices are contiguous, so intra-host traffic stays on
    the local links and only the gradient ``psum``'s tree crosses the network)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (axis,))


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that should write logs/snapshots."""
    return jax.process_index() == 0

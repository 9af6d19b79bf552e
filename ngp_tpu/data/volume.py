"""Volume-density sources for the volume engine.

The reference streams a NanoVDB FloatGrid and accesses it through the
device-side tree accessor (``src/testbed_volume.cu:573-651``). The
representation here is a **dense index-space density array** —
random access becomes a plain gather, which is what the hardware can do —
plus the same derived quantities the reference computes at load time: a
unit-cube AABB fitted around the index bounding box, the world→index
transform, the 128³ occupancy bitgrid (density > 0.001), and the global
majorant for Woodcock/delta tracking.

``load_nanovdb`` parses the reference's file framing (header + metadata,
``testbed_volume.cu:546-571``) and decodes uncompressed FloatGrids into the
dense array via ``ngp_tpu.data.nanovdb_codec``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

BITGRID_RES = 128


@dataclass
class DenseVolume:
    density: jnp.ndarray  # (X, Y, Z) float32, index space
    world2index_scale: float
    world2index_offset: np.ndarray  # (3,)
    aabb_min: np.ndarray  # (3,) unit-cube world space
    aabb_max: np.ndarray
    bitgrid: jnp.ndarray  # (128, 128, 128) uint8
    global_majorant: float

    @classmethod
    def from_dense(cls, density: np.ndarray) -> "DenseVolume":
        """Derive load-time quantities exactly like ``load_volume``: the
        index bbox [0, shape) is scaled by its max extent and centered at
        (0.5,)³."""
        density = np.asarray(density, np.float32)
        shape = np.asarray(density.shape, np.float32)
        maxsize = float(shape.max())
        scale = 1.0 / maxsize
        half = shape * scale * 0.5
        aabb_min = 0.5 - half
        aabb_max = 0.5 + half
        offset = shape * 0.5 - 0.5 * maxsize

        # Bitgrid: evaluate occupancy at every 128³ bit-cell center (the
        # reference point-splats source voxels instead, which under-fills
        # when the source grid is coarser than 128³ — sampling the cell
        # centers covers both directions).
        ss = 2 * BITGRID_RES  # 2× supersampling then max-pool
        cs = (np.arange(ss) + 0.5) / ss
        ix = np.clip((cs * maxsize + offset[0]).astype(int), 0, density.shape[0] - 1)
        iy = np.clip((cs * maxsize + offset[1]).astype(int), 0, density.shape[1] - 1)
        iz = np.clip((cs * maxsize + offset[2]).astype(int), 0, density.shape[2] - 1)
        inside_x = (cs >= aabb_min[0]) & (cs <= aabb_max[0])
        inside_y = (cs >= aabb_min[1]) & (cs <= aabb_max[1])
        inside_z = (cs >= aabb_min[2]) & (cs <= aabb_max[2])
        occ = (
            (density[np.ix_(ix, iy, iz)] > 0.001)
            & inside_x[:, None, None]
            & inside_y[None, :, None]
            & inside_z[None, None, :]
        )
        bit = (
            occ.reshape(BITGRID_RES, 2, BITGRID_RES, 2, BITGRID_RES, 2)
            .any(axis=(1, 3, 5))
            .astype(np.uint8)
        )
        return cls(
            density=jnp.asarray(density),
            world2index_scale=maxsize,
            world2index_offset=offset.astype(np.float32),
            aabb_min=aabb_min.astype(np.float32),
            aabb_max=aabb_max.astype(np.float32),
            bitgrid=jnp.asarray(bit),
            global_majorant=float(density.max()),
        )


def procedural_cloud(res: int = 64, seed: int = 0) -> DenseVolume:
    """Fluffy test volume: a fuzzy ellipsoid with low-frequency noise —
    stands in for wdas_cloud when no .nvdb asset is available."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:res, 0:res, 0:res].astype(np.float32) / res - 0.5
    r = np.sqrt((g[0] / 0.4) ** 2 + (g[1] / 0.3) ** 2 + (g[2] / 0.35) ** 2)
    base = np.clip(1.0 - r, 0.0, 1.0)
    k = 4
    noise = rng.uniform(0.3, 1.0, size=(k, k, k)).astype(np.float32)
    up = np.kron(noise, np.ones((res // k, res // k, res // k), np.float32))
    density = (base * up * 4.0).astype(np.float32)
    density[density < 0.05] = 0.0
    return DenseVolume.from_dense(density)


def load_volume(path: str) -> DenseVolume:
    """Load a density volume: ``.nvdb`` (uncompressed FloatGrid) or ``.npy``
    dense array."""
    if path.endswith(".npy"):
        return DenseVolume.from_dense(np.load(path))
    if path.endswith(".nvdb"):
        from ngp_tpu.data.nanovdb_codec import read_nanovdb_dense

        return DenseVolume.from_dense(read_nanovdb_dense(path))
    raise ValueError("volume path must be .nvdb or .npy")

"""Takikawa (NGLOD-style) octree feature encoding, static-shape.

Semantics follow the reference's ``takikawa_encoding.cuh:28-468``: for an
input position, walk the triangle octree from ``starting_level``; at each
occupied level trilinearly interpolate the 8 dual-vertex feature vectors of
the containing voxel; levels whose voxel is unoccupied output zeros (and,
by the octree property, so do all deeper levels).

The reference's per-thread ``TriangleOctree::traverse`` pointer walk is
replaced by per-level batched ``searchsorted`` lookups on the sparse voxel
pyramid (``ngp_tpu.geometry.triangle_octree``), and the parameter-gradient
scatter (``kernel_takikawa_backward``'s atomicAdd) by the scatter-free
sorted segment sum shared with the hash grid (``grid_gather_blend``).
Parameters are one flat (n_vertices, F) table over the deduplicated dual
vertices, exactly the reference's parameter topology.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ngp_tpu.geometry.triangle_octree import TriangleOctree
from ngp_tpu.models.encodings import Encoding, grid_gather_blend


@dataclass(frozen=True)
class TakikawaEncoding(Encoding):
    """``otype: "Takikawa"`` — config keys ``n_features_per_level`` and
    ``starting_level`` as in the reference (``testbed.cu`` reset_network
    builds it over the SDF mesh's octree). ``n_levels`` output levels are
    octree depths ``starting_level .. octree.max_depth-1``."""

    octree: TriangleOctree = None
    starting_level: int = 0
    n_features_per_level: int = 2
    sum_instead_of_concat: bool = False
    n_input_dims: int = 3

    def __post_init__(self):
        assert self.octree is not None, "TakikawaEncoding needs a TriangleOctree"
        assert 0 <= self.starting_level < self.octree.max_depth

    @property
    def n_levels(self) -> int:
        return self.octree.max_depth - self.starting_level

    @property
    def n_output_dims(self) -> int:
        if self.sum_instead_of_concat:
            return self.n_features_per_level
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return self.octree.n_vertices * self.n_features_per_level

    def init(self, key: jax.Array):
        # Same init scale as the grid encodings (tcnn grids: U(-1e-4, 1e-4)).
        table = jax.random.uniform(
            key,
            (self.octree.n_vertices, self.n_features_per_level),
            jnp.float32,
            minval=-1e-4,
            maxval=1e-4,
        )
        return {"table": table}

    def _gather_plan(self, x: jax.Array):
        """Per level: vertex ids (N, 8) and masked trilinear weights."""
        ids, ws = [], []
        for d in range(self.starting_level, self.octree.max_depth):
            found, vid, frac = self.octree.lookup_level(d, x)
            # corner weight: prod over dims of (frac if corner bit else 1-frac)
            w = jnp.ones((x.shape[0], 8), jnp.float32)
            for dim in range(3):
                bit = jnp.asarray(
                    [(c >> dim) & 1 for c in range(8)], jnp.float32
                )
                w = w * (
                    bit[None, :] * frac[:, dim : dim + 1]
                    + (1.0 - bit[None, :]) * (1.0 - frac[:, dim : dim + 1])
                )
            ids.append(vid)
            ws.append(jnp.where(found[:, None], w, 0.0))
        return jnp.stack(ids, 0), jnp.stack(ws, 0)  # (L, N, 8)

    def __call__(
        self,
        params,
        x: jax.Array,
        max_level: int | None = None,
        differentiable_inputs: bool = False,
    ) -> jax.Array:
        table = params["table"]  # (V, F)
        L = self.n_levels
        N = x.shape[0]
        idx, w = self._gather_plan(x)
        if max_level is not None:
            lvl = jnp.arange(L)
            w = jnp.where((lvl <= max_level)[:, None, None], w, 0.0)
        if differentiable_inputs:
            feats = jnp.take(table, idx.reshape(-1), axis=0, mode="clip")
            feats = feats.reshape(L, N, 8, self.n_features_per_level)
            out = jnp.sum(feats * w[..., None], axis=2)  # (L, N, F)
        else:
            # fold levels into the batch: one global vertex table, L=1
            out = grid_gather_blend(
                table[None], idx.reshape(1, L * N, 8), w.reshape(1, L * N, 8)
            ).reshape(L, N, self.n_features_per_level)
        if self.sum_instead_of_concat:
            return jnp.sum(out, axis=0)  # (N, F)
        # level-major per-sample layout like the reference's data_out
        return jnp.transpose(out, (1, 0, 2)).reshape(N, -1)

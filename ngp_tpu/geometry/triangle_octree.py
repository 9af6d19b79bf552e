"""Triangle octree — static-shape sparse voxel pyramid.

The reference builds a pointer-based octree over the SDF mesh
(``triangle_octree.cuh:46-382``: ``TriangleOctreeNode`` with 8 child
pointers, ``TriangleOctreeDualNode`` with 8 deduplicated vertex indices)
and traverses it per thread with data-dependent loops (``traverse``,
``contains``, stack-based ``ray_intersect``).

Pointer chasing is hostile to batched static-shape code, so this module
re-designs the same structure as a **sparse voxel pyramid**: per depth, a
*sorted* array of occupied-voxel linear codes plus a parallel table of the
8 dual-vertex ids of each voxel. Every reference query becomes a batched, fixed-depth
primitive:

- ``traverse``  → per-level ``searchsorted`` on the code array (the octree
  property "child occupied ⇒ parent occupied" makes each level's lookup
  independent — no serial descent needed);
- ``contains``  → ``searchsorted`` at the finest level;
- ``ray_intersect`` (used by the reference tracer only to *skip empty
  space*) → a precomputed chessboard distance field of the finest level:
  one gather yields a conservative Euclidean lower bound on the distance
  to the octree, which is exactly what a sphere tracer needs
  (``testbed_sdf.cu:183-186``).

The host build replaces the reference's BVH ``touches_triangle`` recursion
with level-synchronous vectorized triangle/box SAT tests (Akenine-Möller),
and replicates the dual-vertex dedup of ``triangle_octree.cuh:170-209``
(vertices keyed by ``(x, y, z, depth)``) so the Takikawa encoding sees the
same parameter topology.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_CORNERS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)


def tri_box_overlap(center: np.ndarray, half: float, tri: np.ndarray) -> np.ndarray:
    """Vectorized triangle/AABB separating-axis test.

    ``center`` (M, 3) box centers, ``half`` scalar half-extent (cubes),
    ``tri`` (M, 3, 3) triangle vertices. Returns (M,) bool. Standard
    13-axis SAT (3 box axes, 1 triangle plane, 9 edge cross products).
    """
    v = tri - center[:, None, :]  # (M, 3, 3)
    e = v[:, [1, 2, 0], :] - v  # edges e0, e1, e2

    ok = np.ones(center.shape[0], bool)
    # 1. box-axis tests
    for a in range(3):
        ok &= v[:, :, a].min(1) <= half
        ok &= v[:, :, a].max(1) >= -half

    # 2. triangle plane test
    n = np.cross(e[:, 0], e[:, 1])
    d = np.einsum("md,md->m", n, v[:, 0])
    r = half * np.abs(n).sum(1)
    ok &= np.abs(d) <= r

    # 3. nine edge-cross-axis tests: axis = cross(unit_j, edge_i)
    for i in range(3):
        ex, ey, ez = e[:, i, 0], e[:, i, 1], e[:, i, 2]
        fex, fey, fez = np.abs(ex), np.abs(ey), np.abs(ez)
        for j in range(3):
            if j == 0:  # axis (0, -ez, ey)
                p = -ez[:, None] * v[:, :, 1] + ey[:, None] * v[:, :, 2]
                rad = half * (fez + fey)
            elif j == 1:  # axis (ez, 0, -ex)
                p = ez[:, None] * v[:, :, 0] - ex[:, None] * v[:, :, 2]
                rad = half * (fez + fex)
            else:  # axis (-ey, ex, 0)
                p = -ey[:, None] * v[:, :, 0] + ex[:, None] * v[:, :, 1]
                rad = half * (fey + fex)
            ok &= (p.min(1) <= rad) & (p.max(1) >= -rad)
    return ok


def _chessboard_distance(occ: np.ndarray) -> np.ndarray:
    """Exact L∞ (chessboard) distance transform of a bool grid. One unit
    step of L∞ dilation is a 3³ min-pool (computed separably), so
    iterating ``d ← min(d, minpool3(d) + 1)`` to a fixed point yields the
    exact chessboard DT. Returns int32 voxels; occupied cells are 0."""
    G = occ.shape[0]
    INF = np.int32(3 * G)
    d = np.where(occ, np.int32(0), INF)

    def minpool3(a):
        for ax in range(3):
            lo = np.roll(a, 1, axis=ax)
            hi = np.roll(a, -1, axis=ax)
            # clamp edges: rolled-in wraparound values must not propagate
            idx_lo = [slice(None)] * 3
            idx_lo[ax] = 0
            idx_hi = [slice(None)] * 3
            idx_hi[ax] = G - 1
            lo[tuple(idx_lo)] = INF
            hi[tuple(idx_hi)] = INF
            a = np.minimum(a, np.minimum(lo, hi))
        return a

    for _ in range(3 * G):
        nd = np.minimum(d, minpool3(d) + 1)
        if np.array_equal(nd, d):
            break
        d = nd
    return d


@dataclass(frozen=True)
class TriangleOctree:
    """Sparse voxel pyramid over a triangle soup in [0,1]³.

    ``codes[d]`` — sorted int32 linear codes ``x + y·2^d + z·4^d`` of the
    occupied voxels at depth ``d`` (depth 0 is the root, always occupied).
    ``verts[d]`` — (n_d, 8) int32 global dual-vertex ids (corner order
    matches ``_CORNERS``: bit0→x, bit1→y, bit2→z, like the reference's
    ``i&1/i&2/i&4``). ``n_vertices`` — total deduplicated vertices.
    """

    max_depth: int
    codes: tuple  # of np.ndarray int32, len == max_depth
    verts: tuple  # of np.ndarray (n, 8) int32
    n_vertices: int
    distance_field: np.ndarray  # (G, G, G) int32 chessboard DT, finest level
    dt_depth: int

    @staticmethod
    def build(triangles: np.ndarray, max_depth: int, dt_max_res: int = 128) -> "TriangleOctree":
        """``triangles`` (T, 3, 3) float in [0,1]³ (callers normalize like
        the reference's ``load_mesh``); ``max_depth`` ≥ 2 — dual vertices
        reach resolution ``2^(max_depth-1)+1`` like the reference (dual
        nodes are "one layer deeper" than regular nodes)."""
        assert max_depth >= 2 and max_depth <= 11
        tris = np.asarray(triangles, np.float64)

        # Prefer the native C++ refinement (native/ngp_host.cpp — same SAT
        # tests and dedup order, identical output, threaded).
        from ngp_tpu import native

        nat = native.octree_build(tris, max_depth)
        if nat is not None:
            codes_nat, verts_nat, n_vertices = nat
            return TriangleOctree._finish(
                max_depth, [c.astype(np.int64) for c in codes_nat],
                verts_nat, n_vertices, dt_max_res,
            )

        tmin = tris.min(1)
        tmax = tris.max(1)

        codes_per_depth = [np.zeros((1,), np.int64)]  # root
        for d in range(1, max_depth):
            R = 1 << d
            size = 1.0 / R
            lo = np.clip(np.floor(tmin / size).astype(np.int64), 0, R - 1)
            hi = np.clip(np.floor(tmax / size).astype(np.int64), 0, R - 1)
            ext = hi - lo + 1  # (T, 3)
            cnt = ext.prod(1)
            tot = int(cnt.sum())
            tri_id = np.repeat(np.arange(len(tris)), cnt)
            off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            ex = ext[tri_id]
            dx = off % ex[:, 0]
            rem = off // ex[:, 0]
            dy = rem % ex[:, 1]
            dz = rem // ex[:, 1]
            vox = lo[tri_id] + np.stack([dx, dy, dz], 1)  # (P, 3)
            code = vox[:, 0] + (vox[:, 1] << d) + (vox[:, 2] << (2 * d))

            # keep only children of occupied parents (octree nesting)
            parent = (
                (vox[:, 0] >> 1)
                + ((vox[:, 1] >> 1) << (d - 1))
                + ((vox[:, 2] >> 1) << (2 * (d - 1)))
            )
            pc = codes_per_depth[d - 1]
            j = np.searchsorted(pc, parent)
            keep = (j < len(pc)) & (pc[np.minimum(j, len(pc) - 1)] == parent)
            vox, code, tri_id = vox[keep], code[keep], tri_id[keep]

            center = (vox.astype(np.float64) + 0.5) * size
            hit = tri_box_overlap(center, 0.5 * size, tris[tri_id])
            codes_per_depth.append(np.unique(code[hit]))

        # Dual vertices: dedup corners (x, y, z, depth) per level; ids are
        # assigned level-major (root level first), like the reference's
        # insertion order up to permutation.
        verts_per_depth = []
        n_vertices = 0
        for d, codes in enumerate(codes_per_depth):
            R = 1 << d
            x = codes & (R - 1)
            y = (codes >> d) & (R - 1)
            z = codes >> (2 * d)
            cx = x[:, None] + _CORNERS[None, :, 0]  # (n, 8) in [0, R]
            cy = y[:, None] + _CORNERS[None, :, 1]
            cz = z[:, None] + _CORNERS[None, :, 2]
            ckey = cx + cy * (R + 1) + cz * (R + 1) * (R + 1)
            uniq, inv = np.unique(ckey, return_inverse=True)
            verts_per_depth.append(
                (inv.reshape(-1, 8) + n_vertices).astype(np.int32)
            )
            n_vertices += len(uniq)

        return TriangleOctree._finish(
            max_depth, codes_per_depth, verts_per_depth, n_vertices, dt_max_res
        )

    @staticmethod
    def _finish(max_depth, codes_per_depth, verts_per_depth, n_vertices,
                dt_max_res) -> "TriangleOctree":
        from ngp_tpu import native

        dt_depth = min(max_depth - 1, int(np.log2(dt_max_res)))
        G = 1 << dt_depth
        occ = np.zeros((G, G, G), bool)
        c = np.asarray(codes_per_depth[dt_depth], np.int64)
        occ[c >> (2 * dt_depth), (c >> dt_depth) & (G - 1), c & (G - 1)] = True  # [z,y,x]
        dist = native.chessboard_dt(occ)
        if dist is None:
            dist = _chessboard_distance(occ)

        return TriangleOctree(
            max_depth=max_depth,
            codes=tuple(np.asarray(c, np.int32) for c in codes_per_depth),
            verts=tuple(verts_per_depth),
            n_vertices=n_vertices,
            distance_field=dist.astype(np.int32),
            dt_depth=dt_depth,
        )

    @property
    def n_nodes(self) -> int:
        return sum(len(c) for c in self.codes)

    # ---- device-side queries (all batched, fixed depth) ----

    def lookup_level(self, d: int, pos: jax.Array):
        """At depth ``d``: (found (N,), vert_ids (N, 8), frac (N, 3)) for
        query positions (N, 3) in [0,1]³."""
        R = 1 << d
        codes = jnp.asarray(self.codes[d])
        verts = jnp.asarray(self.verts[d])
        cell_f = jnp.clip(pos * R, 0.0, R - 1e-4)
        cell = cell_f.astype(jnp.int32)
        frac = cell_f - cell.astype(jnp.float32)
        code = cell[:, 0] + (cell[:, 1] << d) + (cell[:, 2] << (2 * d))
        j = jnp.clip(
            jnp.searchsorted(codes, code, side="left").astype(jnp.int32),
            0,
            len(self.codes[d]) - 1,
        )
        found = codes[j] == code
        return found, verts[j], frac

    def contains(self, pos: jax.Array) -> jax.Array:
        """Finest-level membership — ``TriangleOctree::contains``."""
        found, _, _ = self.lookup_level(self.max_depth - 1, pos)
        return found

    def skip_distance(self, pos: jax.Array) -> jax.Array:
        """Conservative Euclidean lower bound on the distance from ``pos``
        to the octree region (0 inside), from the chessboard DT — the
        sphere tracer's safe empty-space skip, replacing the reference's
        per-ray stack ``ray_intersect`` (``testbed_sdf.cu:183-186``)."""
        G = 1 << self.dt_depth
        cell = jnp.clip((pos * G).astype(jnp.int32), 0, G - 1)
        d = jnp.asarray(self.distance_field)[cell[:, 2], cell[:, 1], cell[:, 0]]
        return jnp.maximum(d.astype(jnp.float32) - 1.0, 0.0) / G

    def sample_uniform(self, key: jax.Array, n: int) -> jax.Array:
        """Uniform positions inside random finest-level occupied voxels —
        ``uniform_octree_sample_kernel`` (``testbed_sdf.cu:436-471``)."""
        d = self.max_depth - 1
        R = 1 << d
        codes = jnp.asarray(self.codes[d])
        k1, k2 = jax.random.split(key)
        pick = jax.random.randint(k1, (n,), 0, len(self.codes[d]))
        c = codes[pick]
        cell = jnp.stack([c & (R - 1), (c >> d) & (R - 1), c >> (2 * d)], -1)
        u = jax.random.uniform(k2, (n, 3))
        return (cell.astype(jnp.float32) + u) / R

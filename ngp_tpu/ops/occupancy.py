"""Cascaded occupancy grid — static-shape re-design of the reference's
density-grid machinery (``src/testbed_nerf.cu:433-812, 3412-3567``).

The reference keeps a Morton-indexed float grid plus a packed bitfield with
max-pooled mips, updated by atomic scatter-max. Here the grid is a dense
``(C, G, G, G)`` float32 array in plain row-major order (Morton buys nothing
here — gathers are gathers), the "bitfield" is a uint8 0/1 array of the
same shape, and every update step is a vectorized scatter-max / EMA /
reduce-window — no atomics, fully deterministic.

Cascade semantics match the reference exactly: cascade ``c`` covers the cube
of half-extent ``2^(c-1)`` around (0.5,)³; a position's canonical cascade is
``mip_from_pos``; marching queries ``mip_from_dt``; coarser cascades OR in
the max-pool of the finer cascade over their central half
(``bitfield_max_pool``, ``testbed_nerf.cu:788``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Reference constants (src/testbed_nerf.cu:55-100, nerf.h:24-30).
NERF_GRIDSIZE = 128
NERF_CASCADES = 8
SQRT3 = 1.73205080757
NERF_STEPS = 1024
MIN_CONE_STEPSIZE = SQRT3 / NERF_STEPS
MAX_CONE_STEPSIZE = MIN_CONE_STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE
NERF_MIN_OPTICAL_THICKNESS = 0.01
MAX_DEPTH = 16384.0


@dataclass(frozen=True)
class OccupancyGridConfig:
    grid_size: int = NERF_GRIDSIZE
    n_cascades: int = 1  # max_cascade + 1 (static; reference allocates 8, uses this many)
    decay: float = 0.95  # density_grid_decay (testbed.h:741)

    @property
    def n_cells(self) -> int:
        return self.grid_size ** 3

    @property
    def max_mip(self) -> int:
        return self.n_cascades - 1


class OccupancyGridState(NamedTuple):
    """density: (C, G, G, G) f32, -1 marks camera-culled cells
    (``mark_untrained_density_grid``); bitfield: same shape uint8 0/1;
    mean_density: scalar f32 over cascade 0; ema_step: int32 counter."""

    density: jax.Array
    bitfield: jax.Array
    mean_density: jax.Array
    ema_step: jax.Array


def init_grid_state(cfg: OccupancyGridConfig) -> OccupancyGridState:
    G, C = cfg.grid_size, cfg.n_cascades
    return OccupancyGridState(
        density=jnp.zeros((C, G, G, G), jnp.float32),
        bitfield=jnp.zeros((C, G, G, G), jnp.uint8),
        mean_density=jnp.zeros([], jnp.float32),
        ema_step=jnp.zeros([], jnp.int32),
    )


def _floor_log2(x: jax.Array) -> jax.Array:
    """Exact ``floor(log2(x))`` for positive normal floats via the IEEE
    exponent field — the integer-math counterpart of the reference's
    ``frexpf`` (``testbed_nerf.cu:614-633``). Two VPU ops instead of a
    transcendental; exact at power-of-two boundaries where a rounded
    ``log2`` could be off by one."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    return ((bits >> 23) & 0xFF) - 127


def mip_from_pos(pos: jax.Array, max_mip: int) -> jax.Array:
    """Canonical cascade of a scene-space position: the smallest cascade cube
    containing it (``mip_from_pos``, ``testbed_nerf.cu:614-621``). ``pos``
    is (..., 3); returns (...,) int32."""
    maxval = jnp.max(jnp.abs(pos - 0.5), axis=-1)
    # frexp exponent: maxval = f * 2^e with f in [0.5, 1).
    e = _floor_log2(jnp.maximum(maxval, 1e-10)) + 1
    return jnp.clip(e + 1, 0, max_mip)


def mip_from_dt(dt: jax.Array, pos: jax.Array, max_mip: int, grid_size: int = NERF_GRIDSIZE) -> jax.Array:
    """Cascade used while marching: at least the canonical cascade, coarser
    if the step dt spans more than one fine cell
    (``mip_from_dt``, ``testbed_nerf.cu:623-633``)."""
    mip = mip_from_pos(pos, max_mip)
    dtx = dt * (2 * grid_size)
    e = _floor_log2(jnp.maximum(dtx, 1e-10)) + 1
    return jnp.where(dtx < 1.0, mip, jnp.clip(jnp.maximum(mip, e), 0, max_mip))


def cell_index_at(pos: jax.Array, mip: jax.Array, grid_size: int):
    """(cell xyz int32 (...,3), valid (...,)) for scene positions at cascade
    ``mip`` — ``cascaded_grid_idx_at`` (``testbed_nerf.cu:433-447``) minus
    the Morton packing."""
    mip_scale = jnp.exp2(-mip.astype(jnp.float32))[..., None]
    p = (pos - 0.5) * mip_scale + 0.5
    cell = jnp.floor(p * grid_size).astype(jnp.int32)
    valid = jnp.all((cell >= 0) & (cell < grid_size), axis=-1)
    return cell, valid


def occupied_at(bitfield: jax.Array, pos: jax.Array, mip: jax.Array) -> jax.Array:
    """Occupancy lookup (``density_grid_occupied_at``,
    ``testbed_nerf.cu:449-457``): one flat gather from the uint8 grid."""
    C, G = bitfield.shape[0], bitfield.shape[1]
    cell, valid = cell_index_at(pos, mip, G)
    flat = ((mip * G + cell[..., 0]) * G + cell[..., 1]) * G + cell[..., 2]
    flat = jnp.where(valid, flat, 0)
    occ = jnp.take(bitfield.reshape(-1), flat, mode="clip") > 0
    return occ & valid


def density_grid_cell_positions(cfg: OccupancyGridConfig, cell_xyz: jax.Array, mip: jax.Array, jitter: jax.Array) -> jax.Array:
    """Scene-space position of ``cell_xyz`` + ``jitter``∈[0,1)³ at cascade
    ``mip`` (inverse of ``cell_index_at``; matches
    ``generate_grid_samples_nerf_nonuniform``, ``testbed_nerf.cu:635-676``)."""
    G = cfg.grid_size
    p = (cell_xyz.astype(jnp.float32) + jitter) / G
    return (p - 0.5) * jnp.exp2(mip.astype(jnp.float32))[..., None] + 0.5


def build_bitfield(
    density: jax.Array, mean_density: jax.Array, thresh_scale: float = 1.0
) -> jax.Array:
    """Threshold the float grid and OR each cascade's max-pool into the next
    coarser cascade's central half (``grid_to_bitfield`` +
    ``bitfield_max_pool``, ``testbed_nerf.cu:762-812``).

    ``thresh_scale`` (optional, default off) compensates refresh schedules
    that let cells decay between re-queries: ``decay^(n_strides/2)`` lets
    a cell halfway through its stride-refresh period (mean-case decay)
    still clear the threshold its freshly queried value would clear —
    without it, occupied cells within ~1/scale of the threshold flicker
    out until their residue class recurs (ADVICE r4). The engine keeps it
    at 1.0: the slower pruning measurably stalls training on the sphere
    fixture (see the stride-update note in ``engines/nerf.py``)."""
    C, G = density.shape[0], density.shape[1]
    thresh = jnp.minimum(NERF_MIN_OPTICAL_THICKNESS, mean_density) * thresh_scale
    bits = density > thresh  # (C, G, G, G) bool
    levels = [bits[0]]
    q = G // 4
    for c in range(1, C):
        pooled = levels[-1].reshape(G // 2, 2, G // 2, 2, G // 2, 2).any(axis=(1, 3, 5))
        merged = bits[c].at[q : 3 * q, q : 3 * q, q : 3 * q].max(pooled)
        levels.append(merged)
    return jnp.stack(levels).astype(jnp.uint8)


def ema_update_density(density: jax.Array, splat: jax.Array, decay: float) -> jax.Array:
    """``grid = max(grid·decay, new)``, preserving the -1 culled marker
    (``ema_grid_samples_nerf``, ``testbed_nerf.cu:731-745``)."""
    return jnp.where(density < 0.0, density, jnp.maximum(density * decay, splat))


def splat_max(cfg: OccupancyGridConfig, flat_idx: jax.Array, values: jax.Array) -> jax.Array:
    """Max-splat sampled optical thicknesses into a zeroed temp grid
    (``splat_grid_samples_nerf_max_nearest_neighbor``,
    ``testbed_nerf.cu:678-707``) — scatter-free segment-max instead of the
    reference's atomicMax."""
    from ngp_tpu.ops.scatter_free import dense_segment_max

    G, C = cfg.grid_size, cfg.n_cascades
    tmp = dense_segment_max(flat_idx, values, C * G * G * G, initial=0.0)
    return tmp.reshape(C, G, G, G)


def sample_update_cells(
    cfg: OccupancyGridConfig,
    key: jax.Array,
    density: jax.Array,
    n_uniform: int,
    n_nonuniform: int,
):
    """Pick grid cells to re-query this update: ``n_uniform`` cells uniform
    over all trained cells, ``n_nonuniform`` biased to currently-occupied
    cells via up-to-10 probes (``generate_grid_samples_nerf_nonuniform``,
    ``testbed_nerf.cu:635-676``). Returns (flat_idx (N,), positions (N,3))
    in scene space; positions are jittered within the cell."""
    G, C = cfg.grid_size, cfg.n_cascades
    n_cells = G * G * G
    n = n_uniform + n_nonuniform
    k1, k2, k3, k4 = jax.random.split(key, 4)
    mip = jax.random.randint(k1, (n,), 0, C)

    # 10 probe candidates each; uniform samples accept any non-culled cell
    # (thresh -0.01), nonuniform ones require density > threshold.
    probes = jax.random.randint(k2, (n, 10), 0, n_cells)
    flat_probes = mip[:, None] * n_cells + probes
    vals = jnp.take(density.reshape(-1), flat_probes, mode="clip")
    thresh = jnp.where(
        jnp.arange(n) < n_uniform, -0.01, NERF_MIN_OPTICAL_THICKNESS
    )
    ok = vals > thresh[:, None]
    # First passing probe, else the last one — like the reference's loop.
    first = jnp.argmax(ok, axis=1)
    pick = jnp.where(jnp.any(ok, axis=1), first, 9)
    cell_flat = jnp.take_along_axis(probes, pick[:, None], axis=1)[:, 0]
    flat_idx = mip * n_cells + cell_flat

    cx = cell_flat // (G * G)
    cy = (cell_flat // G) % G
    cz = cell_flat % G
    cell_xyz = jnp.stack([cx, cy, cz], axis=-1)
    jitter = jax.random.uniform(k3, (n, 3))
    pos = density_grid_cell_positions(cfg, cell_xyz, mip, jitter)
    return flat_idx, pos


def all_cells(cfg: OccupancyGridConfig, key: jax.Array):
    """Every cell of every cascade once (the reference's warmup updates use
    ``n_uniform = G³·n_cascades``); jittered positions."""
    G, C = cfg.grid_size, cfg.n_cascades
    n_cells = G * G * G
    flat_idx = jnp.arange(C * n_cells, dtype=jnp.int32)
    cell_flat = flat_idx % n_cells
    mip = flat_idx // n_cells
    cx = cell_flat // (G * G)
    cy = (cell_flat // G) % G
    cz = cell_flat % G
    cell_xyz = jnp.stack([cx, cy, cz], axis=-1)
    jitter = jax.random.uniform(key, (C * n_cells, 3))
    pos = density_grid_cell_positions(cfg, cell_xyz, mip, jitter)
    return flat_idx, pos


def stride_cells(
    cfg: OccupancyGridConfig,
    key: jax.Array,
    phase: jax.Array,  # scalar int32 — which residue class this update hits
    n_strides: int,
):
    """Deterministic round-robin coverage for the regular (non-warmup)
    occupancy refresh: residue class ``phase % n_strides`` of every
    cascade's flat cell index, jittered within the cell.

    Replacement for the reference's probe sampling
    (``generate_grid_samples_nerf_nonuniform``, ``testbed_nerf.cu:635-676``):
    the reference draws random cells with up-to-10 occupancy-biased probe
    gathers per sample, and the scattered splat needs a segment-max
    sort. A strided residue
    class needs NO gathers to choose cells and its splat is a dense lane
    select (see :func:`place_stride`). Every cell of every cascade is
    re-queried exactly once per ``n_strides`` updates — lower variance than
    the reference's probabilistic coverage. Dynamics caveat vs the
    reference: a cell decays ``decay^(n_strides-1)`` (~0.46 at 16 strides)
    between its refreshes, so *marginal* occupied cells (within ~2x of the
    bitfield threshold) would flicker out mid-period where the reference's
    occupancy-biased resampling re-queries them nearly every update;
    :func:`build_bitfield`'s ``thresh_scale`` knob can compensate, but it
    is OFF by default — measured on the sphere fixture the slower pruning
    it causes stalls training outright (see the engine's stride-update
    note). Cells far above threshold survive ~90 decays regardless.

    Returns ``pos`` ((C·n_cells/n_strides), 3) scene-space jittered
    positions, ordered cascade-major then by stride index ``j`` (flat cell
    = j·n_strides + phase).
    """
    G, C = cfg.grid_size, cfg.n_cascades
    if cfg.n_cells % n_strides:
        raise ValueError(
            f"n_strides={n_strides} must divide n_cells={cfg.n_cells} "
            "(use a power of two for power-of-two grid sizes)"
        )
    n_per = cfg.n_cells // n_strides
    j = jnp.arange(n_per, dtype=jnp.int32)
    cell_flat = j * n_strides + phase.astype(jnp.int32)  # (n_per,)
    cx = cell_flat // (G * G)
    cy = (cell_flat // G) % G
    cz = cell_flat % G
    cell_xyz = jnp.stack([cx, cy, cz], axis=-1)  # (n_per, 3)
    cell_xyz = jnp.broadcast_to(cell_xyz[None], (C, n_per, 3)).reshape(-1, 3)
    mip = jnp.repeat(jnp.arange(C, dtype=jnp.int32), n_per)
    jitter = jax.random.uniform(key, (C * n_per, 3))
    return density_grid_cell_positions(cfg, cell_xyz, mip, jitter)


def place_stride(
    cfg: OccupancyGridConfig,
    values: jax.Array,  # (C·n_cells/n_strides,) from stride_cells' order
    phase: jax.Array,
    n_strides: int,
) -> jax.Array:
    """Dense splat of :func:`stride_cells` values: (C, G, G, G) with the
    residue class' cells set and everything else 0 — one elementwise lane
    select, no scatter, no sort."""
    G, C = cfg.grid_size, cfg.n_cascades
    if cfg.n_cells % n_strides:
        raise ValueError(
            f"n_strides={n_strides} must divide n_cells={cfg.n_cells} "
            "(use a power of two for power-of-two grid sizes)"
        )
    n_per = cfg.n_cells // n_strides
    v = values.reshape(C, n_per, 1)
    lanes = jnp.arange(n_strides, dtype=jnp.int32)[None, None, :]
    full = jnp.where(lanes == phase.astype(jnp.int32), v, 0.0)
    return full.reshape(C, G, G, G)


def update_grid_state_dense(
    cfg: OccupancyGridConfig,
    state: OccupancyGridState,
    sampled_density_dense: jax.Array,  # (C, G, G, G) activated density, 0 = unsampled
    thresh_scale: float = 1.0,
) -> OccupancyGridState:
    """:func:`update_grid_state` for updates whose splat is already dense
    (stride-residue refresh, all-cells warmup sweeps) — skips the
    segment-max entirely. ``thresh_scale``: see :func:`build_bitfield`."""
    tmp = sampled_density_dense * MIN_CONE_STEPSIZE
    density = ema_update_density(state.density, tmp, cfg.decay)
    mean_density = jnp.mean(jnp.maximum(density[0], 0.0))
    bitfield = build_bitfield(density, mean_density, thresh_scale)
    return OccupancyGridState(density, bitfield, mean_density, state.ema_step + 1)


def update_grid_state(
    cfg: OccupancyGridConfig,
    state: OccupancyGridState,
    flat_idx: jax.Array,
    sampled_density: jax.Array,
) -> OccupancyGridState:
    """Merge freshly queried MLP densities into the grid and rebuild the
    bitfield (``update_density_grid_nerf`` tail +
    ``update_density_grid_mean_and_bitfield``,
    ``testbed_nerf.cu:3500-3567``). ``sampled_density`` is the *activated*
    density; optical thickness uses the finest step size (level 0), like the
    reference."""
    optical_thickness = sampled_density * MIN_CONE_STEPSIZE
    tmp = splat_max(cfg, flat_idx, optical_thickness)
    density = ema_update_density(state.density, tmp, cfg.decay)
    mean_density = jnp.mean(jnp.maximum(density[0], 0.0))
    bitfield = build_bitfield(density, mean_density)
    return OccupancyGridState(density, bitfield, mean_density, state.ema_step + 1)


def mark_untrained_cells(
    cfg: OccupancyGridConfig,
    density: jax.Array,
    xforms: jax.Array,  # (I, 3, 4) camera-to-world (start)
    focal_lengths: jax.Array,  # (I, 2)
    principal_points: jax.Array,  # (I, 2) uv-space
    resolution: tuple,  # (W, H) static
    chunk: int = 1 << 18,
    visible_init: float = 0.0,
) -> jax.Array:
    """Set cells seen by no training camera to -1, visible cells to
    ``visible_init`` (``mark_untrained_density_grid``,
    ``testbed_nerf.cu:503-592``).

    ``visible_init`` defaults to 0.0 like upstream instant-ngp (visible
    cells earn occupancy from the first all-cells density sweep). The
    yblin fork initializes them to 1.0 instead (everything-occupied
    start) — pass 1.0 for exact fork behavior; it delays pruning by the
    ~90 decays it takes 1.0 to fall below the 0.01 threshold.

    Redesign: instead of projecting 8 corners of every cell into
    every camera (a memory-bound (cells × cams × corners) tensor), each
    camera becomes 5 frustum half-spaces and cell *centers* are tested with
    a bounding-radius margin — one (points × 3) · (3 × 5·I) matmul plus
    fused compares. Conservative (a margin-visible cell may be slightly
    outside the true frustum), like the reference's own undistorted
    projection test is approximate under distortion."""
    G, C = cfg.grid_size, cfg.n_cascades
    W, H = resolution
    n_cells = G * G * G

    # Build frustum planes per camera: inward normals + plane offsets.
    fwd = xforms[:, :, 2]
    right = xforms[:, :, 0]
    down = xforms[:, :, 1]
    cam_o = xforms[:, :, 3]
    # uv∈(0,1) ⇒ camera-space x/z ∈ (-pp_x·W/f_x, (1-pp_x)·W/f_x), same in y.
    tx0 = (principal_points[:, 0] * W / focal_lengths[:, 0])[:, None]
    tx1 = ((1.0 - principal_points[:, 0]) * W / focal_lengths[:, 0])[:, None]
    ty0 = (principal_points[:, 1] * H / focal_lengths[:, 1])[:, None]
    ty1 = ((1.0 - principal_points[:, 1]) * H / focal_lengths[:, 1])[:, None]

    def norm(v):
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    normals = jnp.stack(
        [
            norm(fwd * tx0 + right),   # left plane
            norm(fwd * tx1 - right),   # right plane
            norm(fwd * ty0 + down),    # top plane
            norm(fwd * ty1 - down),    # bottom plane
            fwd,                        # front plane
        ],
        axis=1,
    )  # (I, 5, 3)
    n_flat = normals.reshape(-1, 3)  # (5I, 3)
    offsets = jnp.sum(n_flat * jnp.repeat(cam_o, 5, axis=0), axis=-1)  # (5I,)
    n_images = xforms.shape[0]

    @jax.jit
    def visible_chunk(idx, n_flat, offsets):
        cell_flat = idx % n_cells
        mip = idx // n_cells
        cx = cell_flat // (G * G)
        cy = (cell_flat // G) % G
        cz = cell_flat % G
        cell_xyz = jnp.stack([cx, cy, cz], axis=-1).astype(jnp.float32)
        voxel = jnp.exp2(mip.astype(jnp.float32)) / G
        center = ((cell_xyz + 0.5) / G - 0.5) * jnp.exp2(
            mip.astype(jnp.float32)
        )[:, None] + 0.5
        margin = voxel * (0.5 * 1.7320508)  # cell bounding radius
        # HIGHEST: the default (TF32) dot is off by ~3e-4 relative
        d = jnp.matmul(
            center, n_flat.T, precision=jax.lax.Precision.HIGHEST
        ) - offsets[None, :]  # (B, 5I)
        inside = (d > -margin[:, None]).reshape(-1, n_images, 5)
        return jnp.any(jnp.all(inside, axis=2), axis=1)

    flat = jnp.arange(((C * n_cells + chunk - 1) // chunk) * chunk, dtype=jnp.int32)
    flat = jnp.minimum(flat, C * n_cells - 1)
    out = [
        visible_chunk(flat[s : s + chunk], n_flat, offsets)
        for s in range(0, flat.shape[0], chunk)
    ]
    vis = jnp.concatenate(out)[: C * n_cells].reshape(C, G, G, G)
    return jnp.where(vis, visible_init, -1.0)


# -- fork extras: geometry-seeded occupancy priors (host-side, one-time)


def seed_grid_from_mesh(
    cfg: OccupancyGridConfig,
    triangles: np.ndarray,  # (T, 3, 3) NGP-space vertices
) -> np.ndarray:
    """Precomputed density prior from a mesh: every cell stays culled (-1)
    except cells a triangle passes through, which become trainable (0) —
    ``Testbed::load_mesh_for_density_grid``
    (``src/testbed_nerf.cu:3176-3300``; that code voxelizes with exact
    box-triangle tests per cascade). Here each triangle is rasterized by
    barycentric point sampling at half-voxel spacing — conservative enough
    for a prior that the density MLP refines, and fully vectorized.

    Returns a host (C, G, G, G) float32 array to pass to
    ``NerfEngine.init_grid(precomputed_density=...)``."""
    G = cfg.grid_size
    tris = np.asarray(triangles, np.float32)
    density = np.full((cfg.n_cascades, G, G, G), -1.0, np.float32)

    # sampling resolution per triangle: half the finest voxel
    spacing = 0.5 / G
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    longest = np.maximum(
        np.linalg.norm(e1, axis=-1),
        np.maximum(np.linalg.norm(e2, axis=-1),
                   np.linalg.norm(e2 - e1, axis=-1)),
    )
    n_sub = np.clip(np.ceil(longest / spacing).astype(np.int64), 1, 256)

    for n in np.unique(n_sub):
        sel = tris[n_sub == n]
        # barycentric lattice (a, b), a+b <= n
        a, b = np.meshgrid(np.arange(n + 1), np.arange(n + 1))
        keep = (a + b) <= n
        u = (a[keep] / max(n, 1)).astype(np.float32)
        v = (b[keep] / max(n, 1)).astype(np.float32)
        pts = (
            sel[:, None, 0]
            + u[None, :, None] * (sel[:, None, 1] - sel[:, None, 0])
            + v[None, :, None] * (sel[:, None, 2] - sel[:, None, 0])
        ).reshape(-1, 3)
        for c in range(cfg.n_cascades):
            # cell coords at cascade c (cell_index_at semantics)
            p = (pts - 0.5) * (2.0 ** -c) + 0.5
            cell = np.floor(p * G).astype(np.int64)
            ok = np.all((cell >= 0) & (cell < G), axis=-1)
            cell = cell[ok]
            density[c, cell[:, 0], cell[:, 1], cell[:, 2]] = 0.0
    return density


def seed_grid_from_point_cloud(
    cfg: OccupancyGridConfig,
    points: np.ndarray,  # (N, 3) NGP-space points
    dilation: int = 1,
    mark_ground_sky: bool = True,
) -> np.ndarray:
    """Precomputed density prior from a point cloud: cells within
    ``dilation`` (r=1 → 3³ neighborhood) of a point become trainable, plus
    boundary ground/sky planes at the coarsest cascade —
    ``Testbed::build_density_grid_from_point_cloud``
    (``src/testbed_nerf.cu:3302-3407``)."""
    G = cfg.grid_size
    pts = np.asarray(points, np.float32)
    density = np.full((cfg.n_cascades, G, G, G), -1.0, np.float32)
    r = int(dilation)
    offs = np.stack(
        np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"), -1
    ).reshape(-1, 3)
    for c in range(cfg.n_cascades):
        p = (pts - 0.5) * (2.0 ** -c) + 0.5
        cell = np.floor(p * G).astype(np.int64)
        ok = np.all((cell >= 0) & (cell < G), axis=-1)
        cell = (cell[ok, None, :] + offs[None, :, :]).reshape(-1, 3)
        ok2 = np.all((cell >= 0) & (cell < G), axis=-1)
        cell = cell[ok2]
        density[c, cell[:, 0], cell[:, 1], cell[:, 2]] = 0.0
    if mark_ground_sky:
        # reference: planes (x, y, 0), (0, x, y) and their far siblings at
        # the last cascade (testbed_nerf.cu:3366-3386)
        last = cfg.n_cascades - 1
        density[last, :, :, 0] = 0.0
        density[last, 0, :, :] = 0.0
        density[last, :, :, G - 1] = 0.0
        density[last, G - 1, :, :] = 0.0
    return density


def build_coarse_gate(bitfield: jax.Array, pool: int = 4) -> jax.Array:
    """(C, G/pool, …) uint8 coarse occupancy gate: per-cascade max-pool of
    the bitfield, then a 3³ dilation — the hierarchical march's segment
    test (``ops/marching.march_rays`` ``gate=``). Conservative by
    construction: a pooled-dilated cell is 0 only if EVERY fine cell
    within one pooled cell of it is empty, so a march segment whose
    midpoint tests 0 at the segment's coarsest mip cannot contain any
    occupied fine lattice point (segment span ≤ 4 fine cells at that mip
    = half a pooled cell; finer-mip occupancy is covered because
    ``build_bitfield`` max-pools every cascade into the next coarser
    cascade's central half, and a point's cascade cubes are nested).
    Cost: one max-pool + 6 shifted maxes over the pooled array — ~0.1 ms
    per train step, paid inside the jitted step."""
    C, G = bitfield.shape[0], bitfield.shape[1]
    Gp = G // pool
    b = bitfield.reshape(C, Gp, pool, Gp, pool, Gp, pool).max(
        axis=(2, 4, 6)
    )

    def shift(x, ax, d):
        pad = [(0, 0)] * 4
        pad[ax] = (max(d, 0), max(-d, 0))
        sl = [slice(None)] * 4
        sl[ax] = slice(None, Gp) if d > 0 else slice(-Gp, None)
        return jnp.pad(x, pad)[tuple(sl)]

    for ax in (1, 2, 3):
        b = jnp.maximum(b, jnp.maximum(shift(b, ax, 1), shift(b, ax, -1)))
    return b

"""Ray marching — static-shape "exponential-lattice" parallel formulation.

The reference marches rays sequentially (``generate_training_samples_nerf``,
``src/testbed_nerf.cu:1382-1658``): take a cone-angle-dependent step ``dt``
when the occupancy grid is occupied, else DDA-skip to the next voxel
boundary *rounded up to an integer number of steps in "stepping space"*
(``advance_to_next_voxel``, ``testbed_nerf.cu:298-316``).

Key observation that makes this embarrassingly parallel: because both
the step (+1) and every skip (+ceil(·)) advance by an **integer** amount in
stepping space, every position a ray can ever visit lies on the fixed
lattice ``t_k = from_stepping_space(n0 + k)``, ``k ∈ ℕ``, where ``n0`` is
the (jittered) start. Moreover the bitfield's max-pool construction
guarantees "empty at a coarse mip ⟹ empty at all finer mips in its
footprint", so a lattice point is sampled by the sequential march **iff**
its own occupancy test passes. Sequential DDA therefore reduces to: evaluate
occupancy at all lattice points in parallel, keep the occupied ones. No
wavefront loop, no compaction atomics, no host syncs — one gather, one
cumsum, one scatter.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ngp_tpu.ops.occupancy import (
    MAX_CONE_STEPSIZE,
    MIN_CONE_STEPSIZE,
    mip_from_dt,
    occupied_at,
)


class SteppingSpace(NamedTuple):
    """Closed-form t ↔ step-count transform (``to/from_stepping_space``,
    ``testbed_nerf.cu:125-167``): linear at ``MIN_CONE_STEPSIZE`` near the
    camera, exponential (factor ``1+cone_angle`` per step) in between,
    linear at ``MAX_CONE_STEPSIZE`` far away. ``cone_angle`` is static
    per scene (0 for unit scenes, 1/256 otherwise, ``load_nerf_post``)."""

    cone_angle: float
    min_step: float
    max_step: float
    a: float
    b: float
    at: float
    bt: float
    log1p_c: float

    @staticmethod
    def make(
        cone_angle: float,
        min_step: float = MIN_CONE_STEPSIZE,
        max_step: float = MAX_CONE_STEPSIZE,
    ) -> "SteppingSpace":
        if cone_angle <= 1e-5:
            return SteppingSpace(cone_angle, min_step, max_step, 0.0, 0.0, 0.0, 0.0, 0.0)
        log1p_c = math.log(1.0 + cone_angle)
        a = (math.log(min_step) - math.log(log1p_c)) / log1p_c
        b = (math.log(max_step) - math.log(log1p_c)) / log1p_c
        return SteppingSpace(
            cone_angle, min_step, max_step,
            a, b, math.exp(a * log1p_c), math.exp(b * log1p_c), log1p_c,
        )

    def to_steps(self, t: jax.Array) -> jax.Array:
        if self.cone_angle <= 1e-5:
            return t / self.min_step
        mid = jnp.log(jnp.maximum(t, 1e-20)) / self.log1p_c
        lo = (t - self.at) / self.min_step + self.a
        hi = (t - self.bt) / self.max_step + self.b
        return jnp.where(t <= self.at, lo, jnp.where(t <= self.bt, mid, hi))

    def from_steps(self, n: jax.Array) -> jax.Array:
        if self.cone_angle <= 1e-5:
            return n * self.min_step
        mid = jnp.exp(n * self.log1p_c)
        lo = (n - self.a) * self.min_step + self.at
        hi = (n - self.b) * self.max_step + self.bt
        return jnp.where(n <= self.a, lo, jnp.where(n <= self.b, mid, hi))

    def to_steps_scalar(self, t: float) -> float:
        """Host-side scalar version (no device dispatch) for static sizing."""
        if self.cone_angle <= 1e-5:
            return t / self.min_step
        if t <= self.at:
            return (t - self.at) / self.min_step + self.a
        if t <= self.bt:
            return math.log(max(t, 1e-20)) / self.log1p_c
        return (t - self.bt) / self.max_step + self.b


def warp_dt(dt: jax.Array) -> jax.Array:
    """dt → [0,1] network input (``warp_dt``, ``testbed_nerf.cu:412-417``)."""
    max_step = MIN_CONE_STEPSIZE * 128.0
    return (dt - MIN_CONE_STEPSIZE) / (max_step - MIN_CONE_STEPSIZE)


def unwarp_dt(dt: jax.Array) -> jax.Array:
    max_step = MIN_CONE_STEPSIZE * 128.0
    return dt * (max_step - MIN_CONE_STEPSIZE) + MIN_CONE_STEPSIZE


def warp_direction(d: jax.Array) -> jax.Array:
    """Unit direction → [0,1]³ (``warp_direction``)."""
    return (d + 1.0) * 0.5


class MarchedRays(NamedTuple):
    """Per-ray compacted samples with static shapes (N rays × K slots)."""

    t: jax.Array  # (N, K) sample distances along the (normalized) ray
    dt: jax.Array  # (N, K) step sizes
    valid: jax.Array  # (N, K) bool — slot holds a real sample
    n_samples: jax.Array  # (N,) int32 — occupied lattice points kept (≤ K)
    total: jax.Array  # (N,) int32 — occupied lattice points, uncapped
    # (drives the adaptive n_rays×K bucket schedule, the static-shape
    # counterpart of the reference's rays_per_batch adaptation,
    # NerfCounters::update_after_training testbed_nerf.cu:3583-3609)
    complete: jax.Array  # (N,) bool — ray left the AABB within the lattice
    # and all its occupied points fit in K (reference: compacted == numsteps
    # gates background compositing, testbed_nerf.cu:1822-1825)
    exited: jax.Array | None = None  # (N,) bool — ray left the AABB within
    # the lattice span (regardless of the K cap); drives the staged
    # renderer's ray-liveness (None from march stubs that predate it)
    gate_total: jax.Array | None = None  # scalar int32 — coarse-gate
    # passing segments this batch (hierarchical march; sizes the
    # adaptive segment budget)


def march_rays(
    origins: jax.Array,  # (N, 3)
    dirs: jax.Array,  # (N, 3) normalized
    bitfield: jax.Array,  # (C, G, G, G) uint8
    aabb_min: jax.Array,  # (3,)
    aabb_max: jax.Array,  # (3,)
    stepping: SteppingSpace,
    n0: jax.Array,  # (N,) stepping-space start (jittered)
    n_lattice: int,  # M — lattice points examined per ray (static)
    n_samples: int,  # K — max samples kept per ray (static)
    max_mip: int,
    gate: jax.Array | None = None,  # (C, G/8, …) coarse gate (see below)
    seg_budget: int | None = None,  # max gate-passing segments per batch
) -> MarchedRays:
    """Evaluate occupancy at all exponential-lattice points in parallel and
    compact the first K occupied ones per ray. Exactly reproduces the
    sequential DDA march of the reference (see module docstring).

    Hierarchical mode (``gate`` + ``seg_budget``): the N·M occupancy
    gathers are the march's dominant cost (~5 ns each, issue-bound). With
    a dilated coarse-pooled bitfield (``occupancy.build_coarse_gate``),
    each 8-point lattice segment is first tested with ONE gather at the
    segment's coarsest mip — provably conservative (see the gate's
    docstring) — and fine occupancy is gathered only for the first
    ``seg_budget`` passing segments (batch-global, march-order /
    k-major). Budget overflow drops the deepest segments — the same
    truncation class as the K sample cap; callers adapt the budget from
    the returned totals with headroom so steady-state overflow is zero.
    Positions/mips stay exact full-lattice math (cheap VPU work)."""
    N = origins.shape[0]
    G = bitfield.shape[1]
    k = jnp.arange(n_lattice, dtype=jnp.float32)
    n = n0[:, None] + k[None, :]  # (N, M)
    t = stepping.from_steps(n)
    dt = stepping.from_steps(n + 1.0) - t
    pos = origins[:, None, :] + dirs[:, None, :] * t[..., None]  # (N, M, 3)

    inside = jnp.all((pos >= aabb_min) & (pos <= aabb_max), axis=-1)
    # Stop at the first exit (the AABB is convex; this also guards numerics).
    before_exit = jnp.cumprod(inside.astype(jnp.int32), axis=1).astype(bool)
    exited = ~jnp.all(inside, axis=1)

    mip = mip_from_dt(dt, pos, max_mip, G)
    SEG = 8
    gate_total = None
    if gate is not None and n_lattice % SEG == 0:
        Msg = n_lattice // SEG
        mip_seg = mip.reshape(N, Msg, SEG).max(axis=2)  # (N, Msg)
        mid = pos.reshape(N, Msg, SEG, 3)[:, :, SEG // 2, :]
        # Clamp the probe into the cascade-m_seg cube: a segment whose
        # midpoint has stepped past the AABB face (or outside the cube)
        # would read invalid even though its leading points are inside.
        # Per-axis clamping only moves the probe TOWARD any in-cube
        # point, so the ≤ half-pooled-cell distance bound (and hence the
        # 1-cell dilation coverage) is preserved.
        halfw = 0.5 * jnp.exp2(mip_seg.astype(jnp.float32))[..., None]
        mid = jnp.clip(mid, 0.5 - halfw + 1e-6, 0.5 + halfw - 1e-6)
        g = occupied_at(gate, mid, mip_seg)
        g = g & jnp.any(before_exit.reshape(N, Msg, SEG), axis=2)
        gate_total = jnp.sum(g.astype(jnp.int32))
    if (
        gate is not None
        and seg_budget is not None
        and n_lattice % SEG == 0
        and seg_budget < N * (n_lattice // SEG)
    ):
        from ngp_tpu.ops.compaction import (
            compact_rows,
            compaction_plan,
            expand_rows,
        )

        # k-major (segment-major) plan: overflow drops DEEPEST segments
        plan = compaction_plan(jnp.transpose(g).reshape(-1), seg_budget)
        pos_sm = jnp.transpose(
            pos.reshape(N, Msg, SEG * 3), (1, 0, 2)
        ).reshape(Msg * N, SEG * 3)
        mip_sm = jnp.transpose(mip.reshape(N, Msg, SEG), (1, 0, 2)).reshape(
            Msg * N, SEG
        ).astype(jnp.float32)
        pos_c = compact_rows(pos_sm, plan).reshape(-1, SEG, 3)
        mip_c = compact_rows(mip_sm, plan).astype(jnp.int32)
        occ_c = occupied_at(bitfield, pos_c, mip_c).astype(jnp.float32)
        occ = expand_rows(occ_c, plan).reshape(Msg, N, SEG)
        occ = jnp.transpose(occ, (1, 0, 2)).reshape(N, n_lattice) > 0.5
        occ = occ & before_exit
    else:
        occ = occupied_at(bitfield, pos, mip) & before_exit

    # Compact the first K occupied lattice points per ray with ONE
    # unstable per-row sort of self-indexing keys (occupied points keep
    # their lattice index, empty ones are pushed past n_lattice), then two
    # row gathers for (t, dt). Replaces an 11-round binary search whose
    # serialized take_along_axis gathers dominated march time (XLA scatter
    # AND repeated small gathers; one sort is a single pass).
    lat = jnp.broadcast_to(
        jnp.arange(n_lattice, dtype=jnp.int32)[None, :], occ.shape
    )
    keys = jnp.where(occ, lat, lat + n_lattice)  # (N, M)
    if n_samples > n_lattice:  # tiny scenes: fewer lattice points than slots
        keys = jnp.pad(
            keys, ((0, 0), (0, n_samples - n_lattice)),
            constant_values=2 * n_lattice,
        )
    (keys_sorted,) = jax.lax.sort((keys,), num_keys=1, is_stable=False)
    head = keys_sorted[:, :n_samples]  # first K occupied, in march order
    sel = jnp.minimum(head, n_lattice - 1)

    # Recompute t/dt from the compacted lattice indices (bit-identical to
    # the (N, M) tables above) — two exps instead of two row gathers.
    n_sel = n0[:, None] + sel.astype(jnp.float32)
    t_c = stepping.from_steps(n_sel)
    dt_c = stepping.from_steps(n_sel + 1.0) - t_c
    total = jnp.sum(occ.astype(jnp.int32), axis=1)
    kept = jnp.minimum(total, n_samples)
    valid = jnp.arange(n_samples)[None, :] < kept[:, None]
    complete = exited & (total <= n_samples)
    return MarchedRays(t_c, dt_c, valid, kept, total, complete, exited,
                       gate_total)


def ray_aabb_range(origins, dirs, aabb_min, aabb_max):
    """Slab test returning (tmin ≥ 0, tmax); misses have tmin > tmax
    (``BoundingBox::ray_intersect`` semantics)."""
    inv = 1.0 / dirs
    t0 = (aabb_min - origins) * inv
    t1 = (aabb_max - origins) * inv
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return jnp.maximum(tmin, 0.0), tmax

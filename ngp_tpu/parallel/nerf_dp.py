"""Data-parallel NeRF training over a device mesh.

SPMD design (the multi-device extension of the reference's single-GPU
training, SURVEY.md §2.8 / BASELINE north star):

* **Train step**: each device samples its own ray sub-batch (fold the step
  key with ``axis_index``), marches and backprops locally, then gradients
  are ``pmean``-ed across devices (NCCL over NVLink on a GPU host). The
  optimizer update runs replicated, so parameters stay bitwise identical
  on every device with no broadcast.
* **Occupancy update**: the cell re-query (the expensive density-MLP
  sweep) is sharded over devices; the per-device scatter-max grids are
  combined with ``pmax`` (max is the associative combine the reference's
  ``atomicMax`` splat implies), then the EMA/bitfield rebuild runs
  replicated.
* **Render**: rays shard trivially over the mesh (pure map, no
  collectives) — the counterpart of ``sync_device``/``use_device`` render
  fan-out, minus the peer-copies since params are already everywhere.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ngp_tpu.engines.nerf import DatasetArrays, NerfEngine
from ngp_tpu.ops import occupancy as occ
from ngp_tpu.ops.composite import density_activation
from ngp_tpu.parallel.mesh import DATA_AXIS


def build_dp_train_step(
    engine: NerfEngine, mesh: Mesh, axis: str = DATA_AXIS,
    return_grads: bool = False,
):
    """Returns ``step(state, grid, key) -> (state, metrics)`` jitted over
    the mesh. The global batch (``engine.batch_size`` sample slots) is
    split evenly: each device runs ``n_rays/n_dev`` rays.

    ``return_grads`` adds the pmean-ed gradient tree to the metrics — for
    the DP-vs-single-chip equivalence test only (it defeats gradient-buffer
    donation, so never enable it in production loops)."""
    n_dev = mesh.shape[axis]

    def make(k: int, n_rays: int):
        # follow the engine's adaptive ray count (NerfCounters semantics,
        # engine.adapt_batch_geometry) so each shard fills the compact
        # budget with real samples instead of the ~50% padding the old
        # batch_size//k pin left (round-3 advisor finding)
        n_rays_local = max(n_rays // n_dev, 1)

        def shard_core(state, bitfield, mean_density, key, data):
            key = jax.random.fold_in(key, jax.lax.axis_index(axis))
            _, metrics, grads = engine.batch_loss_and_grads(
                state.params, bitfield, mean_density, key, data, k, n_rays_local
            )
            grads = jax.lax.pmean(grads, axis)
            metrics = {
                "loss": jax.lax.pmean(metrics["loss"], axis),
                "measured_samples": jax.lax.psum(
                    metrics["measured_samples"], axis
                ),
                "mean_total": jax.lax.pmean(metrics["mean_total"], axis),
            }
            if return_grads:
                metrics["grads"] = grads
            new_state = engine.apply_grads(state, grads)
            return new_state, metrics

        fn = jax.shard_map(
            shard_core,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(fn, donate_argnums=0)

    cache: dict[int, object] = {}

    def step(state, grid: occ.OccupancyGridState, key):
        k = engine._k
        n_rays = engine._n_rays
        if (k, n_rays) not in cache:
            cache[(k, n_rays)] = make(k, n_rays)
        return cache[(k, n_rays)](
            state, grid.bitfield, grid.mean_density, key, engine.data
        )

    return step


def build_dp_grid_update(engine: NerfEngine, mesh: Mesh, axis: str = DATA_AXIS):
    """Returns ``update(state, grid, key, warmup) -> grid`` with the
    density re-query sharded over devices and a ``pmax`` combine."""
    n_dev = mesh.shape[axis]
    cfg = engine.grid_cfg

    def make(warmup: bool):
        def shard_core(params, grid_density, grid_ema_step, key):
            idx = jax.lax.axis_index(axis)
            key = jax.random.fold_in(key, idx)
            if warmup:
                # Partition the all-cells sweep: device i handles cells
                # [i::n_dev] (total count is divisible by n_dev only when
                # the grid is; pad-free strided split).
                n_total = cfg.n_cells * cfg.n_cascades
                n_local = (n_total + n_dev - 1) // n_dev
                flat = idx + jnp.arange(n_local, dtype=jnp.int32) * n_dev
                flat = jnp.minimum(flat, n_total - 1)
                cell_flat = flat % cfg.n_cells
                mip = flat // cfg.n_cells
                G = cfg.grid_size
                cx = cell_flat // (G * G)
                cy = (cell_flat // G) % G
                cz = cell_flat % G
                cell_xyz = jnp.stack([cx, cy, cz], axis=-1)
                jitter = jax.random.uniform(key, (n_local, 3))
                pos = occ.density_grid_cell_positions(cfg, cell_xyz, mip, jitter)
                flat_idx = flat
            else:
                n_quarter = cfg.n_cells // 4 * cfg.n_cascades
                flat_idx, pos = occ.sample_update_cells(
                    cfg, key, grid_density,
                    max(n_quarter // n_dev, 1), max(n_quarter // n_dev, 1),
                )
            pos_w = engine.aabb.relative_pos(pos)
            raw = engine.chunked_density(params["model"], pos_w)
            sigma = density_activation(engine.density_act)(raw)
            tmp_local = occ.splat_max(cfg, flat_idx, sigma * occ.MIN_CONE_STEPSIZE)
            tmp = jax.lax.pmax(tmp_local, axis)
            density = occ.ema_update_density(grid_density, tmp, cfg.decay)
            mean_density = jnp.mean(jnp.maximum(density[0], 0.0))
            bitfield = occ.build_bitfield(density, mean_density)
            return occ.OccupancyGridState(
                density, bitfield, mean_density, grid_ema_step + 1
            )

        fn = jax.shard_map(
            shard_core,
            mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
        return jax.jit(fn)

    cache: dict[bool, object] = {}

    def update(state, grid: occ.OccupancyGridState, key, warmup: bool):
        if warmup not in cache:
            cache[warmup] = make(warmup)
        return cache[warmup](state.params, grid.density, grid.ema_step, key)

    return update


def build_dp_render(engine: NerfEngine, mesh: Mesh, axis: str = DATA_AXIS):
    """Returns ``render(params, bitfield, origins, dirs) -> (rgb, depth,
    opacity)`` with rays sharded over the mesh (pure map)."""

    def core(params, bitfield, origins, dirs):
        crop = getattr(engine, "render_aabb", None)
        cmin = jnp.asarray(
            crop[0] if crop is not None else engine.aabb.min, jnp.float32
        )
        cmax = jnp.asarray(
            crop[1] if crop is not None else engine.aabb.max, jnp.float32
        )
        return engine._render_chunk(params, bitfield, origins, dirs, cmin, cmax)

    fn = jax.shard_map(
        core,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def dp_train(engine: NerfEngine, mesh: Mesh, state, grid, n_steps: int, log_every: int = 0):
    """Data-parallel outer loop mirroring ``NerfEngine.train`` (prep
    cadence, adaptive batch geometry)."""
    step_fn = build_dp_train_step(engine, mesh)
    update_fn = build_dp_grid_update(engine, mesh)
    base_key = jax.random.PRNGKey(engine.seed ^ 0x5EED)
    metrics = {}
    step0 = int(state.step)
    for step in range(step0, step0 + n_steps):
        if engine.reference_prep_cadence:
            interval = min(max(step // 16, 1), 16)
            if step % interval == 0:
                gkey = jax.random.fold_in(base_key, 2 * step + 1)
                grid = update_fn(state, grid, gkey, warmup=step < 256)
        elif step % engine.grid_update_interval == 0:
            gkey = jax.random.fold_in(base_key, 2 * step + 1)
            grid = update_fn(
                state, grid, gkey, warmup=step < engine.warmup_all_cells_steps
            )
        elif step % engine.grid_decay_interval == 0:
            grid = engine.decay_grid(grid)
        key = jax.random.fold_in(base_key, 2 * step)
        state, metrics = step_fn(state, grid, key)
        if (step + 1) % engine.adapt_every == 0:
            engine.adapt_batch_geometry(metrics)
        if log_every and step % log_every == 0:
            print(
                f"step {step}: loss={float(metrics['loss']):.5f} k={engine._k}"
            )
    return state, grid, metrics

"""Scatter-free sample compaction for static-shape training.

The reference compacts ray-march samples with atomicAdd reservations
(``compute_loss_kernel_train_nerf``'s compaction pass,
``src/testbed_nerf.cu:1660-2012``) so the expensive network forward/backward
runs only on real samples. The counterpart here keeps static shapes:
the (N·K,) slot array (valid mask from ``march_rays``) is compacted to a
fixed ``budget`` of rows via one stable flag-sort, and expanded back with a
rank gather. Both primitives carry custom VJPs whose backward passes are
*gathers* (compaction is a bijection onto the valid slots), so no XLA
scatter appears in either direction.

Typical use (see ``NerfEngine._network_on_samples``):

    plan = compaction_plan(valid.reshape(-1), budget)
    x_c   = compact_rows(x.reshape(-1, C), plan)      # (budget, C)
    y_c   = network(x_c)
    y     = expand_rows(y_c, plan).reshape(N, K, -1)  # zeros at invalid slots
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CompactionPlan(NamedTuple):
    """Precomputed index maps (all non-differentiable integers/bools)."""

    cidx: jax.Array  # (B,) slot index of the j-th valid sample (stable order)
    rank: jax.Array  # (NK,) rank of each slot among valid slots (clamped)
    keep: jax.Array  # (NK,) bool — slot is valid AND its rank fits the budget
    live: jax.Array  # (B,) bool — compact row j is backed by a valid slot
    n_valid: jax.Array  # () int32 — total valid slots (may exceed budget)


def compaction_plan(valid: jax.Array, budget: int) -> CompactionPlan:
    """Build the index maps for compacting ``valid`` (NK,) bool slots into
    ``budget`` rows. Stable: compact order preserves slot order, so samples
    of one ray stay contiguous and ordered."""
    nk = valid.shape[0]
    iota = jnp.arange(nk, dtype=jnp.int32)
    # Stable flag sort: valid slots (flag 0) first, in original order.
    _, cidx_full = jax.lax.sort(
        (jnp.logical_not(valid).astype(jnp.int32), iota), num_keys=1, is_stable=True
    )
    cidx = cidx_full[:budget]
    rank_raw = jnp.cumsum(valid.astype(jnp.int32)) - 1  # (NK,)
    keep = valid & (rank_raw < budget)
    rank = jnp.clip(rank_raw, 0, budget - 1)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    live = jnp.arange(budget, dtype=jnp.int32) < n_valid
    return CompactionPlan(cidx, rank, keep, live, n_valid)


@jax.custom_vjp
def compact_rows(x: jax.Array, plan: CompactionPlan) -> jax.Array:
    """(NK, C) → (budget, C): row j = x[cidx[j]]; rows past the last valid
    sample are zeroed."""
    out = jnp.take(x, plan.cidx, axis=0, mode="clip")
    return jnp.where(plan.live[:, None], out, 0.0)


def _compact_fwd(x, plan):
    return compact_rows(x, plan), plan


def _compact_bwd(plan, g):
    # dx[s] = g[rank[s]] if slot s was kept, else 0 — a gather.
    dx = jnp.take(g, plan.rank, axis=0, mode="clip")
    dx = jnp.where(plan.keep[:, None], dx, 0.0)
    return dx, None


compact_rows.defvjp(_compact_fwd, _compact_bwd)


@jax.custom_vjp
def expand_rows(y: jax.Array, plan: CompactionPlan) -> jax.Array:
    """(budget, C) → (NK, C): slot s = y[rank[s]] if kept, else 0."""
    out = jnp.take(y, plan.rank, axis=0, mode="clip")
    return jnp.where(plan.keep[:, None], out, 0.0)


def _expand_fwd(y, plan):
    return expand_rows(y, plan), plan


def _expand_bwd(plan, g):
    # dy[j] = g[cidx[j]] for live rows — a gather (bijection inverse).
    dy = jnp.take(g, plan.cidx, axis=0, mode="clip")
    dy = jnp.where(plan.live[:, None], dy, 0.0)
    return dy, None


expand_rows.defvjp(_expand_fwd, _expand_bwd)

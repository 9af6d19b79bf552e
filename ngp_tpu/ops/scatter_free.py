"""Dense segment reductions.

:func:`batched_segment_sum` is the hash-grid table gradient: one float32
scatter-add over all levels, the mechanism of tiny-cuda-nn's grid
backward (atomic adds). On the GPU XLA lowers it to atomics, so the sum
order changes from run to run; the result agrees with an exact sum to
float32 rounding of a few hundred addends per row.

:func:`dense_segment_sum` and :func:`dense_segment_max` (occupancy splats,
mesh optimisation) are scatter-free: sorts, cumsums and gathers only.
``segment_max`` reduces to ``segment_sum``: sort (key asc, value desc),
zero all but each run's first row, then sum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def blocked_cumsum(x: jax.Array, block: int = 128) -> jax.Array:
    """Inclusive cumsum along the last axis with O(n) memory traffic.

    One in-block prefix as a triangular matmul, a tiny recursive scan over
    the block totals, and one broadcast add: ~3 linear passes total.

    ``x`` (..., N) float32; returns the same shape/dtype.
    """
    *lead, n = x.shape
    if n <= block * 4:
        return jnp.cumsum(x, axis=-1)
    pad = (-n) % block
    if pad:
        x = jnp.pad(x, [(0, 0)] * len(lead) + [(0, pad)])
    nb = (n + pad) // block
    xb = x.reshape(*lead, nb, block)
    # in-block inclusive prefix: xb @ upper-triangular ones
    tri = jnp.triu(jnp.ones((block, block), x.dtype))
    # HIGHEST: a reduced-precision fp32 dot (bf16 passes, or TF32 on the
    # GPU) would poison the later diff-of-cumsums (catastrophic
    # cancellation against the running total).
    pre = jax.lax.dot_general(
        xb, tri, (((xb.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(x.dtype)
    # block offsets: exclusive scan of the block totals (nb ≈ n/128 —
    # small enough that XLA's ladder is cheap; recurse for huge n)
    totals = pre[..., -1]
    off = blocked_cumsum(totals, block) - totals
    out = pre + off[..., None]
    return out.reshape(*lead, n + pad)[..., :n] if pad else out.reshape(*lead, n)


def dense_segment_sum(keys: jax.Array, vals: jax.Array, n_segments: int) -> jax.Array:
    """Sum ``vals`` (M,) or (M, F) into a dense (n_segments,)/(n_segments, F)
    array by ``keys`` (M,) int32 ∈ [0, n_segments). Scatter-free
    (slot-sentinel construction — used at modest sizes; the table gradient
    goes through :func:`batched_segment_sum`)."""
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    M, F = vals.shape
    T = n_segments

    comb_keys = jnp.concatenate([keys.astype(jnp.int32), jnp.arange(T, dtype=jnp.int32)])
    comb_flag = jnp.concatenate(
        [jnp.zeros((M,), jnp.int32), jnp.ones((T,), jnp.int32)]
    )
    comb_vals = [
        jnp.concatenate([vals[:, f], jnp.zeros((T,), vals.dtype)]) for f in range(F)
    ]

    s = jax.lax.sort((comb_keys, comb_flag, *comb_vals), num_keys=2, is_stable=True)
    flag_sorted = s[1]
    cs = [blocked_cumsum(v) for v in s[2:]]

    # Compact slot rows (in key order) to the front; stable keeps order.
    s2 = jax.lax.sort((1 - flag_sorted, *cs), num_keys=1, is_stable=True)
    slot_cs = jnp.stack([c[:T] for c in s2[1:]], axis=-1)  # (T, F)
    dense = jnp.diff(slot_cs, axis=0, prepend=jnp.zeros((1, F), slot_cs.dtype))
    return dense[:, 0] if squeeze else dense


def batched_segment_sum(
    keys: jax.Array, vals: jax.Array, n_segments: int
) -> jax.Array:
    """Per-level segment sum: ``keys`` (L, M) int32 ∈ [0, n_segments),
    ``vals`` (L, M, F) → (L, n_segments, F) float32, with
    ``out[l, k] = Σ_{m: keys[l, m] = k} vals[l, m]``."""
    L = keys.shape[0]
    lvl = jnp.arange(L, dtype=jnp.int32)[:, None]
    return (
        jnp.zeros((L, n_segments, vals.shape[-1]), jnp.float32)
        .at[lvl, keys]
        .add(vals.astype(jnp.float32))
    )


def dense_segment_max(
    keys: jax.Array, vals: jax.Array, n_segments: int, initial: float = 0.0
) -> jax.Array:
    """Max of ``vals`` (M,) into a dense (n_segments,) array by ``keys``;
    untouched segments get ``initial``. Scatter-free: sort (key asc, val
    desc), keep each run's head, then segment-sum the heads."""
    ks, negv = jax.lax.sort(
        (keys.astype(jnp.int32), -vals), num_keys=2, is_stable=False
    )
    v = -negv
    is_head = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    head_vals = jnp.where(is_head, v - initial, 0.0)
    return dense_segment_sum(ks, head_vals, n_segments) + initial

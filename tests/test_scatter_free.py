"""Direct tests for the dense segment reductions: the hash-grid table
gradient (``batched_segment_sum``) and the scatter-free occupancy and mesh
reductions. Oracle: numpy add.at / bincount / maximum.at."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ngp_tpu.ops.scatter_free import (
    batched_segment_sum,
    dense_segment_max,
    dense_segment_sum,
)


@pytest.mark.parametrize("m,t,f", [(1000, 64, 2), (257, 16, 1), (64, 512, 4)])
def test_dense_segment_sum_matches_numpy(m, t, f):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, t, size=m).astype(np.int32)
    vals = rng.normal(size=(m, f)).astype(np.float32)
    ref = np.zeros((t, f), np.float32)
    np.add.at(ref, keys, vals)
    out = np.asarray(dense_segment_sum(jnp.asarray(keys), jnp.asarray(vals), t))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _bincount_ref(keys, vals, t):
    """float64 host reference: per level and feature, np.bincount."""
    l, _, f = vals.shape
    ref = np.zeros((l, t, f), np.float64)
    for i in range(l):
        for j in range(f):
            ref[i, :, j] = np.bincount(
                keys[i], weights=vals[i, :, j].astype(np.float64), minlength=t
            )
    return ref


@pytest.mark.parametrize("l,m,t,f", [(3, 500, 64, 2), (1, 64, 256, 4), (5, 130, 8, 1)])
@pytest.mark.parametrize("sizes", ["full", "mixed"])
def test_batched_segment_sum_matches_numpy(l, m, t, f, sizes):
    """Every level keyed over the whole table ("full"), or each level over
    a prefix of its own size, as dense levels of a hash grid are
    ("mixed": rows past a level's size stay zero)."""
    rng = np.random.default_rng(1)
    level_sizes = (
        [t] * l if sizes == "full"
        else [max(1, t >> (l - 1 - i)) for i in range(l)]
    )
    keys = np.stack(
        [rng.integers(0, s, size=m) for s in level_sizes]
    ).astype(np.int32)
    vals = rng.normal(size=(l, m, f)).astype(np.float32)
    ref = _bincount_ref(keys, vals, t)
    out = np.asarray(
        batched_segment_sum(jnp.asarray(keys), jnp.asarray(vals), t)
    )
    assert out.shape == (l, t, f) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    for i, s in enumerate(level_sizes):
        assert np.all(out[i, s:] == 0.0)


@pytest.mark.parametrize("n_keys", [1, 7])
def test_batched_segment_sum_duplicate_heavy(n_keys):
    """Thousands of addends per row (coarse hash-grid levels): the float32
    sum stays within 1e-5 of the float64 reference, relative to the
    level's largest sum."""
    rng = np.random.default_rng(9)
    l, m, t, f = 2, 20000, 16, 2
    keys = rng.integers(0, n_keys, size=(l, m)).astype(np.int32)
    vals = rng.uniform(-1.0, 1.0, size=(l, m, f)).astype(np.float32) + 0.25
    ref = _bincount_ref(keys, vals, t)
    out = np.asarray(
        batched_segment_sum(jnp.asarray(keys), jnp.asarray(vals), t)
    )
    for i in range(l):
        err = np.abs(out[i] - ref[i]).max()
        assert err <= 1e-5 * np.abs(ref[i]).max(), err


def test_blocked_cumsum_matches_numpy():
    from ngp_tpu.ops.scatter_free import blocked_cumsum

    rng = np.random.default_rng(7)
    for shape in [(5, 2000), (1, 127), (2, 4096), (3, 130)]:
        x = rng.normal(size=shape).astype(np.float32)
        got = np.asarray(blocked_cumsum(jnp.asarray(x)))
        want = np.cumsum(x, axis=-1, dtype=np.float64).astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_batched_segment_sum_empty_segments():
    # keys leave most segments untouched -> exact zeros there
    keys = jnp.asarray([[3, 3, 7]], jnp.int32)
    vals = jnp.asarray([[[1.0], [2.0], [4.0]]])
    out = np.asarray(batched_segment_sum(keys, vals, 16))
    assert out[0, 3, 0] == 3.0 and out[0, 7, 0] == 4.0
    assert np.all(out[0, [0, 1, 2, 4, 5, 6] + list(range(8, 16)), 0] == 0.0)


def test_batched_matches_global():
    rng = np.random.default_rng(2)
    l, m, t, f = 4, 300, 32, 2
    keys = rng.integers(0, t, size=(l, m)).astype(np.int32)
    vals = rng.normal(size=(l, m, f)).astype(np.float32)
    glob_keys = (keys + np.arange(l)[:, None] * t).reshape(-1)
    glob = np.asarray(
        dense_segment_sum(jnp.asarray(glob_keys), jnp.asarray(vals.reshape(-1, f)), l * t)
    ).reshape(l, t, f)
    bat = np.asarray(
        batched_segment_sum(jnp.asarray(keys), jnp.asarray(vals), t)
    )
    np.testing.assert_allclose(bat, glob, rtol=1e-5, atol=1e-5)


def test_dense_segment_max_matches_numpy():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, size=500).astype(np.int32)
    # all values above `initial` so the numpy maximum.at oracle agrees
    # (touched segments report their true max even below initial)
    vals = rng.uniform(0.6, 3.0, size=500).astype(np.float32)
    ref = np.full((40,), 0.5, np.float32)
    np.maximum.at(ref, keys, vals)
    out = np.asarray(
        dense_segment_max(jnp.asarray(keys), jnp.asarray(vals), 40, initial=0.5)
    )
    # the max rides through a cumsum, so allow ~eps·log(n) rounding
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

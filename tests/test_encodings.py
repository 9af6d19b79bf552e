import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ngp_tpu.models.encodings import (
    CompositeEncoding,
    FrequencyEncoding,
    GridEncoding,
    IdentityEncoding,
    OneBlobEncoding,
    SphericalHarmonicsEncoding,
    TriangleWaveEncoding,
)


def test_grid_geometry_matches_tcnn_convention():
    enc = GridEncoding(n_levels=16, base_resolution=16, per_level_scale=2.0)
    scales, res, sizes, hashed = enc._level_geometry()
    assert res[0] == 16  # ceil(16-1)+1
    assert res[1] == 32
    assert not hashed[0]  # 16^3 = 4096 < 2^19
    assert hashed[-1]  # 2^18^3 >> 2^19
    assert enc.n_output_dims == 32


def test_hashgrid_forward_shape_and_interp():
    enc = GridEncoding(n_levels=4, n_features_per_level=2, base_resolution=4,
                       log2_hashmap_size=10, per_level_scale=2.0)
    params = enc.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (128, 3))
    y = enc(params, x)
    assert y.shape == (128, 8)
    assert jnp.all(jnp.isfinite(y))


def test_hashgrid_trilinear_exactness():
    """At exact grid vertices the encoding must equal the stored feature."""
    enc = GridEncoding(n_levels=1, n_features_per_level=2, base_resolution=4,
                       log2_hashmap_size=12, per_level_scale=2.0)
    params = enc.init(jax.random.PRNGKey(0))
    scales, res, sizes, hashed = enc._level_geometry()
    scale, r = float(scales[0]), int(res[0])
    # Choose positions that land exactly on integer grid coords:
    # pos*scale + 0.5 = k  =>  pos = (k - 0.5)/scale
    ks = np.array([[1, 2, 3], [0, 1, 2]], np.float32)
    pos = (ks - 0.5) / scale
    y = enc(params, jnp.asarray(pos))
    table = params["table"][0]
    for row, k in zip(np.asarray(y), ks):
        idx = int(k[0] + k[1] * r + k[2] * r * r) % int(sizes[0])
        np.testing.assert_allclose(row, np.asarray(table[idx]), rtol=1e-5)


def test_hashgrid_grad_scatter():
    """Gradients w.r.t. the table must be nonzero only for touched corners,
    and match finite differences."""
    enc = GridEncoding(n_levels=2, n_features_per_level=1, base_resolution=4,
                       log2_hashmap_size=8, per_level_scale=2.0)
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray([[0.3, 0.6, 0.1]])

    def f(table):
        return jnp.sum(enc({"table": table}, x) ** 2)

    g = jax.grad(f)(params["table"])
    assert jnp.sum(g != 0) <= 2 * 8  # at most 8 corners per level
    # finite differences on one touched entry
    nz = np.argwhere(np.asarray(g) != 0)[0]
    eps = 1e-3
    t0 = params["table"]
    tp = t0.at[tuple(nz)].add(eps)
    tm = t0.at[tuple(nz)].add(-eps)
    fd = (f(tp) - f(tm)) / (2 * eps)
    np.testing.assert_allclose(float(g[tuple(nz)]), float(fd), rtol=1e-2)


def test_grid_max_level_masking():
    enc = GridEncoding(n_levels=4, n_features_per_level=2, base_resolution=4,
                       log2_hashmap_size=10)
    params = enc.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (8, 3))
    y = enc(params, x, max_level=1)
    y_full = enc(params, x)
    np.testing.assert_allclose(y[:, :4], y_full[:, :4], rtol=1e-6)
    assert jnp.all(y[:, 4:] == 0)


def test_dense_vs_hash_grid_types():
    for gt in ["Dense", "Tiled", "Hash"]:
        enc = GridEncoding(n_levels=2, base_resolution=4, grid_type=gt,
                           log2_hashmap_size=6)
        params = enc.init(jax.random.PRNGKey(0))
        y = enc(params, jax.random.uniform(jax.random.PRNGKey(1), (16, 3)))
        assert y.shape == (16, 4)


def test_grid_2d():
    enc = GridEncoding(n_input_dims=2, n_levels=8, base_resolution=16,
                       log2_hashmap_size=15, per_level_scale=1.5)
    params = enc.init(jax.random.PRNGKey(0))
    y = enc(params, jax.random.uniform(jax.random.PRNGKey(1), (32, 2)))
    assert y.shape == (32, 16)
    assert jnp.all(jnp.isfinite(y))


def test_sh_encoding_orthonormality():
    """SH basis functions should be orthonormal under the sphere measure."""
    enc = SphericalHarmonicsEncoding(degree=4)
    key = jax.random.PRNGKey(0)
    d = jax.random.normal(key, (200000, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    basis = enc({}, (d + 1.0) * 0.5)
    gram = (basis.T @ basis) / d.shape[0] * (4 * jnp.pi)
    np.testing.assert_allclose(np.asarray(gram), np.eye(16), atol=0.15)


def test_frequency_encoding():
    enc = FrequencyEncoding(n_input_dims=2, n_frequencies=3)
    y = enc({}, jnp.asarray([[0.25, 0.5]]))
    assert y.shape == (1, 12)
    # first pair is sin/cos of pi*x
    np.testing.assert_allclose(float(y[0, 0]), np.sin(np.pi * 0.25), rtol=1e-5)
    np.testing.assert_allclose(float(y[0, 1]), np.cos(np.pi * 0.25), rtol=1e-5)


def test_oneblob_partition_of_unity():
    enc = OneBlobEncoding(n_input_dims=1, n_bins=16)
    x = jnp.linspace(0.2, 0.8, 7)[:, None]
    y = enc({}, x)
    np.testing.assert_allclose(np.asarray(jnp.sum(y, axis=-1)), 1.0, atol=1e-3)


def test_composite_encoding():
    comp = CompositeEncoding(nested=[
        (SphericalHarmonicsEncoding(degree=4), 3),
        (IdentityEncoding(n_input_dims=2), 2),
    ])
    assert comp.n_input_dims == 5
    assert comp.n_output_dims == 18
    x = jax.random.uniform(jax.random.PRNGKey(0), (4, 5))
    y = comp(comp.init(jax.random.PRNGKey(1)), x)
    assert y.shape == (4, 18)
    np.testing.assert_allclose(np.asarray(y[:, 16:]), np.asarray(x[:, 3:]), rtol=1e-6)


def test_trianglewave():
    enc = TriangleWaveEncoding(n_input_dims=1, n_frequencies=2)
    y = enc({}, jnp.asarray([[0.5]]))
    assert y.shape == (1, 2)


def test_grid_gather_blend_backward_matches_scatter_add():
    """The custom backward (one batched float32 scatter-add) must equal
    autodiff of the plain gather."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ngp_tpu.models.encodings import grid_gather_blend

    rng = np.random.default_rng(5)
    L, T, F, N, C = 3, 64, 2, 200, 8
    table = jnp.asarray(rng.normal(size=(L, T, F)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, T, size=(L, N, C)).astype(np.int32))
    w = jnp.asarray(rng.uniform(0, 1, size=(L, N, C)).astype(np.float32))
    g = jnp.asarray(rng.normal(size=(L, N, F)).astype(np.float32))

    def loss_custom(t):
        return jnp.sum(grid_gather_blend(t, idx, w) * g)

    def loss_ref(t):
        feats = jnp.take_along_axis(t, idx.reshape(L, -1, 1), axis=1)
        feats = feats.reshape(L, N, C, F)
        out = jnp.sum(feats * w[..., None], axis=2)
        return jnp.sum(out * g)

    got = jax.grad(loss_custom)(table)
    want = jax.grad(loss_ref)(table)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=1e-5)
    # forwards agree too
    np.testing.assert_allclose(
        np.asarray(grid_gather_blend(table, idx, w)),
        np.asarray(
            jnp.sum(
                jnp.take_along_axis(t := table, idx.reshape(L, -1, 1), axis=1)
                .reshape(L, N, C, F) * w[..., None], axis=2)
        ),
        rtol=1e-5, atol=1e-6,
    )


def test_hashgrid_bf16_gather_matches_f32():
    """gather_dtype='bfloat16' forward/backward ≈ fp32 path (the fp32
    master / low-precision gather split, SURVEY §2.10)."""
    kw = dict(n_levels=4, n_features_per_level=2, base_resolution=4,
              log2_hashmap_size=10, per_level_scale=1.5)
    enc32 = GridEncoding(**kw)
    enc16 = GridEncoding(gather_dtype="bfloat16", **kw)
    params = enc32.init(jax.random.PRNGKey(3))
    # bump magnitudes so bf16 quantization is visible but small
    params = {"table": params["table"] * 1e4}
    x = jax.random.uniform(jax.random.PRNGKey(4), (64, 3))
    o32 = enc32(params, x)
    o16 = enc16(params, x)
    np.testing.assert_allclose(np.asarray(o16), np.asarray(o32),
                               rtol=1e-2, atol=1e-2)
    g32 = jax.grad(lambda t: jnp.sum(enc32({"table": t}, x) ** 2))(
        params["table"]
    )
    g16 = jax.grad(lambda t: jnp.sum(enc16({"table": t}, x) ** 2))(
        params["table"]
    )
    assert g16.dtype == jnp.float32  # cast back through the astype
    np.testing.assert_allclose(np.asarray(g16), np.asarray(g32),
                               rtol=0.05, atol=0.05)


def test_simplex_interpolation_properties():
    """Simplex (Kuhn tetrahedral) interpolation: 4 corners, weights are a
    partition of unity, and affine functions are reproduced exactly on a
    dense level (linear interpolation on the Kuhn triangulation)."""
    enc = GridEncoding(
        n_levels=1, n_features_per_level=1, base_resolution=8,
        log2_hashmap_size=16, grid_type="Dense", interpolation="Simplex",
    )
    # keep pos = x·scale+0.5 below r-1 so the dense boundary clamp (the
    # top grid plane's +1 corner) stays out of play
    x = jax.random.uniform(jax.random.PRNGKey(0), (512, 3), maxval=0.9)
    idx, w = enc.indices_and_weights(x)
    assert idx.shape == (1, 512, 4) and w.shape == (1, 512, 4)
    np.testing.assert_allclose(np.asarray(jnp.sum(w, axis=-1)), 1.0, atol=1e-5)
    assert float(jnp.min(w)) >= -1e-6
    # affine reproduction: table[v] = a·pos(v) + b on the dense level
    scales, res, _, _ = enc._level_geometry()
    r = int(res[0])
    grid = np.stack(np.meshgrid(*[np.arange(r)] * 3, indexing="ij"), -1)
    lin = (grid * np.array([1, r, r * r])).sum(-1).reshape(-1)
    posv = grid.reshape(-1, 3).astype(np.float32)
    a, b = np.array([0.3, -0.7, 0.2], np.float32), 0.11
    tbl = np.zeros((1, enc.max_table_rows, 1), np.float32)
    tbl[0, lin, 0] = posv @ a + b
    got = np.asarray(enc({"table": jnp.asarray(tbl)}, x))[:, 0]
    pos = np.asarray(x) * float(scales[0]) + 0.5
    want = pos @ a + b
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_simplex_continuity_across_cell_planes():
    """The encoding must be C0 across lattice planes (the property the
    windowed-gather designs break; simplex keeps it)."""
    enc = GridEncoding(
        n_levels=4, n_features_per_level=2, base_resolution=4,
        log2_hashmap_size=10, per_level_scale=1.7, interpolation="Simplex",
    )
    params = enc.init(jax.random.PRNGKey(1))
    params = {"table": params["table"] * 1e4}
    scales, _, _, _ = enc._level_geometry()
    # points straddling an exact lattice plane of the finest level
    k = jnp.arange(1, 5, dtype=jnp.float32)
    xplane = (k - 0.5) / float(scales[-1])  # pos = x*scale+0.5 = k
    eps = 1e-6
    lo = jnp.stack([xplane - eps, jnp.full_like(xplane, 0.33),
                    jnp.full_like(xplane, 0.71)], -1)
    hi = jnp.stack([xplane + eps, lo[:, 1], lo[:, 2]], -1)
    dlt = np.abs(np.asarray(enc(params, lo)) - np.asarray(enc(params, hi)))
    assert dlt.max() < 0.1  # continuous up to eps·scale·|df|


def test_simplex_gradients_flow():
    enc = GridEncoding(
        n_levels=2, n_features_per_level=2, base_resolution=4,
        log2_hashmap_size=8, interpolation="Simplex",
    )
    params = enc.init(jax.random.PRNGKey(2))
    x = jax.random.uniform(jax.random.PRNGKey(3), (64, 3))
    g = jax.grad(lambda t: jnp.sum(enc({"table": t}, x) ** 2))(params["table"])
    assert np.isfinite(np.asarray(g)).all() and float(jnp.sum(g * g)) > 0
    # input gradients via the differentiable path
    gx = jax.grad(
        lambda xx: jnp.sum(enc(params, xx, differentiable_inputs=True))
    )(x)
    assert np.isfinite(np.asarray(gx)).all()


def test_level_histograms():
    """gather_histograms counterpart (testbed.cu:4826-4871): per-level
    |weight| histograms over live rows only."""
    enc = GridEncoding(n_levels=3, n_features_per_level=2, base_resolution=4,
                       log2_hashmap_size=8, per_level_scale=2.0)
    params = enc.init(jax.random.PRNGKey(0))
    counts, means = enc.level_histograms(params, n_bins=16, vmax=1e-3)
    _, _, sizes, _ = enc._level_geometry()
    assert counts.shape == (3, 16) and means.shape == (3,)
    # every live row lands in some bin
    for l in range(3):
        assert int(counts[l].sum()) == int(sizes[l])
    assert np.all(np.asarray(means) >= 0)


@pytest.mark.parametrize("grid_type,log2T", [("Hash", 19), ("Hash", 12), ("Dense", 12)])
def test_pair_gather_matches_classic_path(grid_type, log2T):
    """The pair-gather fast path (additive hash, Linear) must reproduce the
    classic 8-corner gather exactly in the forward and to bf16-payload
    precision in the table gradient."""
    from ngp_tpu.models.encodings import grid_gather_blend

    enc = GridEncoding(
        n_input_dims=3, n_levels=4, n_features_per_level=4,
        log2_hashmap_size=log2T, base_resolution=16, per_level_scale=2.0,
        grid_type=grid_type, hash_variant="additive",
    )
    assert enc.pairs_eligible
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.clip(
        jax.random.uniform(jax.random.PRNGKey(1), (257, 3), minval=-0.05,
                           maxval=1.05),
        0.0, 1.0 - 1e-6,
    )
    idx, w = enc.indices_and_weights(x)
    out_classic = jnp.transpose(
        grid_gather_blend(params["table"], idx, w), (1, 0, 2)
    ).reshape(x.shape[0], -1)
    out_pairs = enc(params, x)
    np.testing.assert_allclose(
        np.asarray(out_pairs), np.asarray(out_classic), atol=1e-5
    )

    g = jax.random.normal(jax.random.PRNGKey(2), out_pairs.shape)
    gp = jax.grad(lambda t: jnp.sum(enc({"table": t}, x) * g))(params["table"])
    gc = jax.grad(
        lambda t: jnp.sum(
            jnp.transpose(grid_gather_blend(t, idx, w), (1, 0, 2)).reshape(
                x.shape[0], -1
            )
            * g
        )
    )(params["table"])
    rel = float(jnp.max(jnp.abs(gp - gc))) / (float(jnp.max(jnp.abs(gc))) + 1e-12)
    assert rel < 2e-2, rel


def test_pair_gather_boundary_exact():
    """Top-plane clamp trick: x = 1.0 must match the classic clamped read."""
    from ngp_tpu.models.encodings import grid_gather_blend

    enc = GridEncoding(
        n_input_dims=3, n_levels=2, n_features_per_level=2,
        log2_hashmap_size=10, base_resolution=4, per_level_scale=1.5,
        grid_type="Hash", hash_variant="additive",
    )
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.asarray([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [0.999999, 0.5, 0.0]])
    idx, w = enc.indices_and_weights(x)
    oc = jnp.transpose(
        grid_gather_blend(params["table"], idx, w), (1, 0, 2)
    ).reshape(3, -1)
    np.testing.assert_allclose(np.asarray(enc(params, x)), np.asarray(oc),
                               atol=1e-6)


def test_dup_backward_corners_matches_pairs():
    """The P=1 corner-fold backward (one segment-sum key per sample, 2^D·F
    payload, static-shift fold) must match the round-3 pair construction
    on the same inputs — both reduce the same per-corner contributions."""
    import os

    from ngp_tpu.models.encodings import GridEncoding

    enc = GridEncoding(
        n_input_dims=3, n_levels=3, n_features_per_level=2,
        log2_hashmap_size=12, base_resolution=8, per_level_scale=1.7,
        grid_type="Hash", hash_variant="additive",
    )
    assert enc.pairs_eligible
    params = enc.init(jax.random.PRNGKey(3))
    x = jnp.clip(jax.random.uniform(jax.random.PRNGKey(4), (513, 3)), 0, 1 - 1e-6)
    g = jax.random.normal(jax.random.PRNGKey(5), (513, enc.n_output_dims))

    def table_grad():
        return jax.grad(lambda t: jnp.sum(enc({"table": t}, x) * g))(
            params["table"]
        )

    try:
        os.environ["NGP_TPU_DUP_BWD"] = "corners"
        gc = table_grad()
        os.environ["NGP_TPU_DUP_BWD"] = "pairs"
        gp = table_grad()
        os.environ["NGP_TPU_DUP_BWD"] = "quads"
        gq = table_grad()
    finally:
        os.environ.pop("NGP_TPU_DUP_BWD", None)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(gp), rtol=1e-4,
                               atol=1e-5)
    # quad grouping (the round-5 default): same gradient
    np.testing.assert_allclose(np.asarray(gq), np.asarray(gp), rtol=1e-4,
                               atol=1e-5)


_VJP_CASES = {
    # the upstream tier's path: XOR hash, classic gather + scatter-add
    "hash_xor": dict(grid_type="Hash", log2_hashmap_size=10),
    # the compact tier's path: additive hash, corner-dup gather, quads
    "hash_additive_quads": dict(grid_type="Hash", log2_hashmap_size=10,
                                hash_variant="additive"),
    "dense": dict(grid_type="Dense", log2_hashmap_size=10),
    "tiled": dict(grid_type="Tiled", log2_hashmap_size=8),
    "2d_additive_pairs": dict(n_input_dims=2, grid_type="Hash",
                              log2_hashmap_size=8, hash_variant="additive"),
    "2d_xor": dict(n_input_dims=2, grid_type="Hash", log2_hashmap_size=8),
}


@pytest.mark.parametrize("case", sorted(_VJP_CASES))
def test_table_gradient_matches_plain_autodiff(case):
    """Each grid VJP's table gradient equals jax.grad of the plain
    ``differentiable_inputs=True`` path (take_along_axis + blend, whose
    transpose is XLA's own scatter-add), under HIGHEST precision."""
    kw = dict(n_levels=4, n_features_per_level=2, base_resolution=4,
              per_level_scale=1.8)
    kw.update(_VJP_CASES[case])
    enc = GridEncoding(**kw)
    D = enc.n_input_dims
    params = enc.init(jax.random.PRNGKey(0))
    x = jnp.clip(jax.random.uniform(jax.random.PRNGKey(1), (300, D)),
                 0.0, 1.0 - 1e-6)
    g = jax.random.normal(jax.random.PRNGKey(2), (300, enc.n_output_dims))

    def grad(plain):
        return jax.grad(lambda t: jnp.sum(
            enc({"table": t}, x, differentiable_inputs=plain) * g))(
            params["table"])

    with jax.default_matmul_precision("highest"):
        got, want = grad(False), grad(True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert float(jnp.max(jnp.abs(want))) > 0

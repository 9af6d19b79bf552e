"""Input encodings, re-implemented in pure JAX.

These reproduce the *semantics* of the tcnn encodings the reference uses
(HashGrid/DenseGrid/TiledGrid, SphericalHarmonics, OneBlob, Frequency,
TriangleWave, Identity, Composite — see reference ``configs/*/*.json`` and
SURVEY.md §2.10), but the implementation is batched, static-shape JAX: the
hash-grid forward is a vectorized 8-corner gather + trilinear blend over all
levels at once, and the table gradient is a float32 scatter-add
(``ops/scatter_free.batched_segment_sum``), tcnn's own mechanism.

Encoding protocol: ``enc.init(key) -> params`` (a pytree, possibly empty) and
``enc(params, x) -> (N, n_output_dims)`` where ``x`` is ``(N, n_input_dims)``
float32 in the encoding's expected domain ([0,1] for grids/SH, matching the
reference's warped inputs).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# The three per-dimension hashing primes of the multiresolution hash encoding
# (Müller et al. 2022, eq. 4 — dim 0 is intentionally 1 for cache coherence).
_HASH_PRIMES = (1, 2654435761, 805459861)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def grid_dup_gather_blend(
    enc: "GridEncoding", table: jax.Array, base: jax.Array, wc: jax.Array
) -> jax.Array:
    """Corner-dup grid blend: all 2^D corners of each cell ride ONE
    gathered row of width 2^D·F from a corner-duplicated table view
    ``dup[i] = [t[i], t[i+1], t[i+S2], t[i+S2+1], t[i+S3], …]`` (mod the
    level size).

    Fast path for Linear interpolation with the *additive* hash: the
    additive hash ``h = x + y·P2 + z·P3 (mod size)`` makes every corner of
    a cell an affine shift of the cell's base address — corner (dx,dy,dz)
    lives at ``base + dx + dy·S2 + dz·S3 (mod size)`` with static
    per-level shifts (dense levels: S2 = r, S3 = r²; hashed: the primes
    mod the table size), so the duplicated view is built per step with D
    concat+roll passes — linear, ~0.3 ms, master params stay (L, T, F).

    The backward (3D default: "quads") keys the two z-plane group bases
    per cell (4F-wide payloads — a quarter of the rows of a per-corner
    segment sum) and folds with three shifted adds;
    ``NGP_TPU_DUP_BWD`` selects "pairs" (P x-adjacent pair rows, 2F
    payloads) or the experimental "corners" instead — see ``_gdgb_bwd``.

    Exactness: identical arithmetic to the classic per-corner path with
    the additive hash, including the dense top-plane behavior (per-dim
    clamp with the fraction pushed to 1 reads the same clamped corner
    value). Gradients flow to ``table`` only.

    Row format: by default feature pairs ride the gather as bf16 packed in
    int32 lanes, halving the row from 64 B to 32 B. bf16 features are the
    same precision class as the reference's fp16 inference params (tcnn
    Trainer keeps fp16 inference weights — SURVEY §2.10); the master
    table and all gradient accumulation stay fp32.
    ``enc.dup_gather_dtype = "float32"`` keeps full-precision rows.
    """
    L, T, F = table.shape
    D = enc.n_input_dims
    C = 1 << D
    N = base.shape[1]
    packed = enc.dup_gather_dtype == "packed_bf16" and F % 2 == 0
    if packed:
        # (L, T, F) f32 -> (L, T, F/2) int32 of adjacent-feature bf16 pairs
        u = jax.lax.bitcast_convert_type(
            table.astype(jnp.bfloat16), jnp.uint16
        ).astype(jnp.uint32)
        tbl = (u[..., 0::2] | (u[..., 1::2] << 16)).astype(jnp.int32)
    else:
        tbl = table
    Fp = tbl.shape[-1]  # columns per corner in the dup view
    # Full-corner duplication: each sample-level gathers ONE row of C·Fp
    # columns (one row of 2^D corners beats 2^(D-1) pair-rows in the
    # compiled step: the row-issue floor dominates, so fewer/wider wins).
    s2, s3 = enc._dup_shifts()
    dups = []
    for l in range(L):
        d = jnp.concatenate([tbl[l], jnp.roll(tbl[l], -1, axis=0)], -1)
        if D >= 2:
            d = jnp.concatenate([d, jnp.roll(d, -int(s2[l]), axis=0)], -1)
        if D >= 3:
            d = jnp.concatenate([d, jnp.roll(d, -int(s3[l]), axis=0)], -1)
        dups.append(d)
    flat = jnp.stack(dups).reshape(L * T, C * Fp)
    off = (jnp.arange(L, dtype=jnp.int32) * T)[:, None]
    rows = jnp.take(flat, (base + off).reshape(-1), axis=0, mode="clip")
    if packed:
        u = rows.reshape(L, N, C * Fp).astype(jnp.uint32)
        lo = jax.lax.bitcast_convert_type(
            (u & 0xFFFF).astype(jnp.uint16), jnp.bfloat16
        )
        hi = jax.lax.bitcast_convert_type(
            (u >> 16).astype(jnp.uint16), jnp.bfloat16
        )
        # (L, N, C·F/2, 2) -> (L, N, C·F) restores feature-minor order
        rows = jnp.stack([lo, hi], axis=-1).reshape(L, N, C * F)
        rows = rows.astype(jnp.float32)
    # Blend as an elementwise multiply and a sum over corners (fused by
    # XLA). A 0/1 selection matmul would run in TF32 on the GPU and round
    # every product to 10 mantissa bits.
    rows = rows.reshape(L, N, C, F)
    return jnp.sum(rows * wc[..., None], axis=2)


def _pair_keys(enc: "GridEncoding", base: jax.Array) -> jax.Array:
    """(L, N, P) table rows of each x-adjacent corner pair's even corner:
    ``(base + pair_shift) mod size`` with static per-level shifts."""
    _, _, sizes, _ = enc._level_geometry()
    pshifts = jnp.asarray(enc._pair_shifts(), jnp.int32)  # (L, P)
    sz = jnp.asarray(sizes, jnp.int32)
    k = base[..., None] + pshifts[:, None, :]
    return jnp.where(k >= sz[:, None, None], k - sz[:, None, None], k)


def _gdgb_fwd(enc, table, base, wc):
    proto = jnp.zeros((0,), table.dtype)
    return grid_dup_gather_blend(enc, table, base, wc), (proto, base, wc)


def _gdgb_bwd(enc, res, g):
    from ngp_tpu.ops.scatter_free import batched_segment_sum

    proto, base, wc = res
    L, T, F = enc.n_levels, enc.max_table_rows, enc.n_features_per_level
    D = enc.n_input_dims
    _, _, sizes, _ = enc._level_geometry()
    N = base.shape[1]
    strategy = os.environ.get("NGP_TPU_DUP_BWD", "quads")
    if strategy == "corners":
        # EXPERIMENTAL (NGP_TPU_DUP_BWD=corners): ONE segment-sum key
        # per (level, sample) — the cell's base row — with all 2^D corner
        # contributions as a C·F-wide payload, then a static-shift fold
        # dtable[t] = Σ_c q_c[(t − δ_c) mod size]. 4× fewer keys than the
        # pair construction, with 4× wider rows.
        C = 1 << D
        vals = (wc[..., None] * g[:, :, None, :]).reshape(L, N, C * F)
        q = batched_segment_sum(
            base, vals, T
        )
        shifts = enc._corner_shifts()  # (L, C) static
        # Fold in a T-minor layout: rolls of (F, T) slabs move contiguous
        # rows; the natural (T, C·F) orientation rolls narrow strided
        # columns.
        qT = jnp.transpose(q, (0, 2, 1))  # (L, C·F, T)
        folded = []
        for l in range(L):
            size = int(sizes[l])
            ql = qT[l][:, :size]  # (C·F, size)
            acc = ql[0:F]
            for c in range(1, C):
                acc = acc + jnp.roll(
                    ql[c * F:(c + 1) * F], int(shifts[l, c]), axis=1
                )
            folded.append(
                jnp.pad(acc, ((0, 0), (0, T - size))) if size < T else acc
            )
        return (
            jnp.transpose(jnp.stack(folded), (0, 2, 1)).astype(proto.dtype),
            None,
            None,
        )

    if D == 3 and strategy == "quads":
        # z-adjacent QUAD grouping: 2 segment-sum keys per (level, sample)
        # — the two z-plane group bases ``base + {0, s3} mod size`` — with
        # the 4 in-plane corner contributions as a 4F-wide payload, then a
        # 4-piece static-shift fold. Half the keys of the pair
        # construction.
        s2np, s3np = enc._dup_shifts()
        sz = jnp.asarray(sizes, jnp.int32)
        k2 = jnp.stack(
            [base, base + jnp.asarray(s3np % sizes.astype(np.int64),
                                      jnp.int32)[:, None]],
            axis=-1,
        )  # (L, N, 2)
        k2 = jnp.where(k2 >= sz[:, None, None], k2 - sz[:, None, None], k2)
        # payload order per quad: (dx,dy) = (0,0),(1,0),(0,1),(1,1) —
        # corner index c = dx + 2·dy + 4·dz, so wc reshaped (dz, dx+2dy)
        # already has the quad corners minor
        w4 = wc.reshape(L, -1, 2, 4)  # (L, N, dz, quad-corner)
        vals = (
            w4[..., None] * g[:, :, None, None, :]
        ).reshape(L, base.shape[1], 2, 4 * F)  # (L, N, dz, 4F)
        quad = batched_segment_sum(
            jnp.transpose(k2, (0, 2, 1)).reshape(L, -1),
            jnp.transpose(vals, (0, 2, 1, 3)).reshape(L, -1, 4 * F),
            T,
        )  # (L, T, 4F)
        # fold: dtable[t] = Σ_{(dx,dy)} piece[(t − dx − dy·s2) mod size]
        # in a T-minor layout (full-lane rolls; see the corners branch)
        qT = jnp.transpose(quad, (0, 2, 1))  # (L, 4F, T)
        folded = []
        for l in range(L):
            size = int(sizes[l])
            ql = qT[l][:, :size]
            s2l = int(s2np[l] % size)
            acc = ql[0:F]
            for j, sh in ((1, 1), (2, s2l), (3, (s2l + 1) % size)):
                acc = acc + jnp.roll(ql[j * F:(j + 1) * F], sh, axis=1)
            folded.append(
                jnp.pad(acc, ((0, 0), (0, T - size))) if size < T else acc
            )
        return (
            jnp.transpose(jnp.stack(folded), (0, 2, 1)).astype(proto.dtype),
            None,
            None,
        )

    P = 1 << (D - 1)
    keys = _pair_keys(enc, base)  # (L, N, P)
    # (L, N, P, 2F): [w_even·g, w_odd·g] per x-adjacent corner pair
    w2 = wc.reshape(L, -1, P, 2)
    vals = jnp.concatenate(
        [w2[..., 0:1] * g[:, :, None, :], w2[..., 1:2] * g[:, :, None, :]],
        axis=-1,
    ).reshape(L, base.shape[1] * P, 2 * F)
    pair = batched_segment_sum(
        keys.reshape(L, -1), vals, T
    )
    dtable = pair[..., :F] + jnp.roll(pair[..., F:], 1, axis=1)
    return dtable.astype(proto.dtype), None, None


grid_dup_gather_blend.defvjp(_gdgb_fwd, _gdgb_bwd)


@jax.custom_vjp
def grid_gather_blend(table: jax.Array, idx: jax.Array, w: jax.Array) -> jax.Array:
    """Blend 2^D table rows per (level, sample): ``out[l,n,f] = Σ_c
    w[l,n,c]·table[l, idx[l,n,c], f]``.

    The forward is one flat row gather. The backward is a float32
    scatter-add of the per-corner contributions
    (``ops/scatter_free.batched_segment_sum``); the reference accumulates
    the same gradients in fp16 atomics with a 128× loss scale
    (``tiny-cuda-nn`` grid backward, SURVEY.md §2.10), so this is
    strictly tighter.

    Gradients flow to ``table`` only: ``w`` (and hence positions) are
    treated as non-differentiable here, matching the reference training
    path, which never backprops into sample positions. Use plain autodiff
    (``GridEncoding.__call__`` with ``differentiable_inputs=True``) where
    d(out)/d(x) is required (SDF analytic normals, camera refinement).
    """
    L, T, F = table.shape
    flat = (jnp.arange(L, dtype=jnp.uint32)[:, None, None] * jnp.uint32(T)
            + idx.astype(jnp.uint32)).reshape(-1)
    feats = jnp.take(
        table.reshape(L * T, F), flat.astype(jnp.int32), axis=0, mode="clip"
    ).reshape(idx.shape + (F,))
    return jnp.sum(feats * w[..., None], axis=2)  # (L, N, F)


def _ggb_fwd(table, idx, w):
    # dtype carried as a zero-size array (residual leaves must be arrays)
    proto = jnp.zeros((0,), table.dtype)
    return grid_gather_blend(table, idx, w), (table.shape, proto, idx, w)


def _ggb_bwd(res, g):
    from ngp_tpu.ops.scatter_free import batched_segment_sum

    (L, T, F), proto, idx, w = res
    tdtype = proto.dtype
    keys = idx.reshape(L, -1)  # (L, N·C), already per-level row indices
    # per (l, n, c): value vector w·g[l,n,:]  -> (L, N·C, F), summed in
    # fp32
    vals = (w[..., None] * g[:, :, None, :]).astype(jnp.float32).reshape(L, -1, F)
    return batched_segment_sum(keys, vals, T).astype(tdtype), None, None


grid_gather_blend.defvjp(_ggb_fwd, _ggb_bwd)


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Encoding:
    n_input_dims: int
    n_output_dims: int

    def init(self, key: jax.Array):
        return {}

    def __call__(self, params, x: jax.Array) -> jax.Array:  # pragma: no cover
        raise NotImplementedError

    @property
    def n_params(self) -> int:
        return 0


@dataclass(frozen=True)
class GridEncoding(Encoding):
    """Multiresolution {hash,dense,tiled} grid encoding.

    Level geometry follows the tcnn convention the reference relies on
    (SURVEY.md §2.10): ``scale_l = 2^(l·log2(b))·N_min − 1``,
    ``res_l = ceil(scale_l) + 1``, position ``x·scale + 0.5`` then
    floor/fract for the 8-corner trilinear blend. A level stores
    ``min(next_multiple(res³, 8), 2^log2_hashmap_size)`` features; levels that
    don't fit hash with the XOR-of-primes spatial hash. Parameters are one
    ``(L, T, F)`` fp32 table (dense levels simply use a prefix of their row).
    """

    n_input_dims: int = 3
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    grid_type: str = "Hash"  # "Hash" | "Dense" | "Tiled"
    interpolation: str = "Linear"
    # Gather the table rows at this dtype (classic path only); fp32 unless
    # memory is short.
    gather_dtype: str = "float32"
    # Spatial hash for over-full levels: "tcnn" is the reference's
    # XOR-of-primes (bit-exact .ingp interop); "additive" replaces the XOR
    # with ADDITION mod 2^k, which makes the two x-corners of every cell
    # adjacent table rows (dim-0 prime is 1) and unlocks the corner-dup
    # gather fast path (grid_dup_gather_blend) — the default for the
    # "compact" training tier.
    hash_variant: str = "tcnn"  # "tcnn" | "additive"
    # Dup-gather row format (additive-hash fast path only): "packed_bf16"
    # gathers 32 B rows of bf16 feature pairs packed in int32 lanes (half
    # the bytes of f32 rows; see grid_dup_gather_blend). Same precision
    # class as tcnn's fp16 inference params; master table + gradients stay
    # fp32.
    dup_gather_dtype: str = "packed_bf16"  # "packed_bf16" | "float32"

    def __post_init__(self):
        assert self.n_input_dims in (2, 3), "grid encoding supports 2D/3D"
        if self.interpolation not in ("Linear", "Simplex"):
            raise ValueError(
                f"unsupported interpolation {self.interpolation!r} "
                "(Linear | Simplex)"
            )
        if self.hash_variant not in ("tcnn", "additive"):
            raise ValueError(
                f"unsupported hash_variant {self.hash_variant!r} "
                "(tcnn | additive)"
            )

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    def _level_geometry(self):
        """Per-level (scale, resolution, params_in_level, use_hash)."""
        ls = math.log2(self.per_level_scale)
        scales, res, sizes, hashed = [], [], [], []
        for l in range(self.n_levels):
            s = 2.0 ** (l * ls) * self.base_resolution - 1.0
            r = int(math.ceil(s)) + 1
            dense = r ** self.n_input_dims
            if self.grid_type == "Dense":
                size, h = dense, False
            else:
                size = min(_next_multiple(dense, 8), self.table_size)
                # Tiled wraps the linear index; Hash switches to spatial hash.
                h = (self.grid_type == "Hash") and (dense > size)
            scales.append(s)
            res.append(r)
            sizes.append(size)
            hashed.append(h)
        return (
            np.asarray(scales, np.float32),
            np.asarray(res, np.int32),
            np.asarray(sizes, np.int32),
            np.asarray(hashed, np.bool_),
        )

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        _, _, sizes, _ = self._level_geometry()
        return int(sizes.sum()) * self.n_features_per_level

    @property
    def max_table_rows(self) -> int:
        _, _, sizes, _ = self._level_geometry()
        return int(sizes.max())

    def level_param_slices(self) -> list[tuple[int, int]]:
        """(offset, count) of each level's live params within a flattened
        level-major view — the analogue of tcnn's ``level_params_offset`` used
        by the reference's GUI histograms (``testbed.cu:4848-4856``)."""
        _, _, sizes, _ = self._level_geometry()
        out, off = [], 0
        for s in sizes:
            out.append((off, int(s) * self.n_features_per_level))
            off += int(s) * self.n_features_per_level
        return out

    def level_histograms(self, params, n_bins: int = 128,
                         vmax: float = 1.0):
        """Per-level histograms of |weight| over each level's live rows —
        the data behind the reference GUI's hash-level histograms
        (``gather_histograms``, ``testbed.cu:4826-4871``). Returns
        (counts (L, n_bins) int32, mean |w| per level (L,))."""
        table = params["table"]  # (L, T, F)
        _, _, sizes, _ = self._level_geometry()
        rows = jnp.arange(table.shape[1])
        counts, means = [], []
        for l in range(self.n_levels):
            live = rows < int(sizes[l])
            w = jnp.abs(table[l]).max(axis=-1)
            w = jnp.where(live, w, -1.0)  # dead rows fall below bin 0
            b = jnp.clip(
                (w / vmax * n_bins).astype(jnp.int32), -1, n_bins - 1
            )
            counts.append(
                jnp.sum(
                    b[:, None] == jnp.arange(n_bins)[None, :], axis=0
                ).astype(jnp.int32)
            )
            means.append(
                jnp.sum(jnp.where(live, w, 0.0)) / jnp.maximum(int(sizes[l]), 1)
            )
        return jnp.stack(counts), jnp.stack(means)

    def init(self, key: jax.Array):
        # tcnn initializes grid features ~ U(-1e-4, 1e-4).
        T = self.max_table_rows
        table = jax.random.uniform(
            key,
            (self.n_levels, T, self.n_features_per_level),
            jnp.float32,
            minval=-1e-4,
            maxval=1e-4,
        )
        return {"table": table}

    def _corner_offsets(self) -> np.ndarray:
        D = self.n_input_dims
        n = 1 << D
        out = np.zeros((n, D), np.int32)
        for c in range(n):
            for d in range(D):
                out[c, d] = (c >> d) & 1
        return out

    def _simplex_corners_weights(self, frac: jax.Array):
        """Freudenthal/Kuhn simplex interpolation: the containing
        tetrahedron's D+1 vertex offsets and barycentric weights from the
        in-cell fraction ``frac`` (N, D).

        Alternative to trilinear: 4 table rows per sample
        instead of 8 (halving both the forward's HBM row gathers and the
        backward's segment-sum rows), C0-continuous across cells and
        simplices (it is linear interpolation on the Kuhn triangulation).
        Not in tcnn — enabled via ``interpolation: "Simplex"``.
        """
        D = frac.shape[-1]
        # rank_d = position of dim d in descending-frac order (index ties
        # broken toward lower d)
        gt = (frac[:, :, None] > frac[:, None, :]) | (
            (frac[:, :, None] == frac[:, None, :])
            & (jnp.arange(D)[:, None] < jnp.arange(D)[None, :])[None]
        )  # gt[n, d', d] — d' ranks above d
        rank = jnp.sum(gt, axis=1).astype(jnp.int32)  # (N, D), 0 = largest
        # corner k (k = 0..D) includes e_d iff rank_d < k
        ks = jnp.arange(D + 1, dtype=jnp.int32)
        corners = (rank[:, None, :] < ks[None, :, None]).astype(jnp.int32)
        # weights: sorted-descending fracs g (N, D) via one small sort
        g = -jax.lax.sort(-frac, dimension=-1)  # descending
        ones = jnp.ones_like(g[:, :1])
        w = jnp.concatenate([ones, g], axis=1) - jnp.concatenate(
            [g, jnp.zeros_like(ones)], axis=1
        )  # (N, D+1): [1-g0, g0-g1, ..., g_{D-1}]
        return corners, w

    def indices_and_weights(self, x: jax.Array):
        """Compute gather indices and blend weights for all levels.

        Returns ``idx`` (L, N, C) int32 into the level's table row and
        ``w`` (L, N, C) float32 blend weights, where C = 2^D for Linear
        interpolation and D+1 for Simplex. Exposed separately so a custom
        VJP can reuse the addressing math.
        """
        D = self.n_input_dims
        scales, res, sizes, hashed = self._level_geometry()
        corners = jnp.asarray(self._corner_offsets())  # (C, D)
        simplex = self.interpolation == "Simplex"

        def per_level(scale, r, size, use_hash):
            pos = x * scale + 0.5
            pos0 = jnp.floor(pos)
            frac = pos - pos0
            pos0 = pos0.astype(jnp.int32)
            if simplex:
                scorners, w_simplex = self._simplex_corners_weights(frac)
                cpos = pos0[:, None, :] + scorners  # (N, D+1, D)
            else:
                cpos = pos0[:, None, :] + corners[None, :, :]  # (N, C, D)
            # Linear (tiled/dense) index with per-dim stride = resolution^d.
            # Dense levels clamp boundary corners (the top grid plane's
            # "+1" corner) instead of wrapping — keeps lin < size with no
            # integer mod. Tiled levels genuinely wrap.
            stride = r.astype(jnp.uint32) ** jnp.arange(D, dtype=jnp.uint32)
            cpos_c = jnp.clip(cpos, 0, r - 1)
            lin = jnp.sum(cpos_c.astype(jnp.uint32) * stride, axis=-1)
            if self.grid_type == "Tiled":
                lin = lin % size.astype(jnp.uint32)
            # Spatial hash for levels that exceed the table. The additive
            # variant (XOR -> +) keeps x-neighbors adjacent mod the table
            # size, enabling the pair-gather fast path; collision quality
            # is equivalent in practice (both are jumbled linear maps).
            h = cpos[..., 0].astype(jnp.uint32) * jnp.uint32(_HASH_PRIMES[0])
            for d in range(1, D):
                term = cpos[..., d].astype(jnp.uint32) * jnp.uint32(_HASH_PRIMES[d])
                h = (h + term) if self.hash_variant == "additive" else (h ^ term)
            idx = jnp.where(use_hash, h % size.astype(jnp.uint32), lin)
            if simplex:
                return idx.astype(jnp.int32), w_simplex
            # Blend weight: prod over dims of (frac if corner else 1-frac).
            cw = jnp.where(
                corners[None, :, :] == 1, frac[:, None, :], 1.0 - frac[:, None, :]
            )
            w = jnp.prod(cw, axis=-1)
            return idx.astype(jnp.int32), w

        idx, w = jax.vmap(per_level)(
            jnp.asarray(scales), jnp.asarray(res), jnp.asarray(sizes), jnp.asarray(hashed)
        )
        return idx, w

    @property
    def pairs_eligible(self) -> bool:
        """The pair-gather fast path applies to Linear interpolation with
        the additive hash (Tiled levels can wrap mid-table, so they keep
        the classic path)."""
        return (
            self.interpolation == "Linear"
            and self.hash_variant == "additive"
            and self.grid_type in ("Hash", "Dense")
        )

    def _dup_shifts(self):
        """Static per-level (S2, S3) row shifts of the y/z corner offsets
        in the corner-duplicated table view: dense levels use the linear
        strides (r, r²); hashed levels the additive-hash primes mod the
        table size."""
        _, res, sizes, hashed = self._level_geometry()
        s2 = np.where(
            hashed, _HASH_PRIMES[1] % sizes.astype(np.uint32),
            res.astype(np.uint32),
        ).astype(np.int64)
        s3 = np.where(
            hashed, _HASH_PRIMES[2] % sizes.astype(np.uint32),
            (res.astype(np.uint32) * res.astype(np.uint32)),
        ).astype(np.int64)
        return s2, s3

    def _corner_shifts(self):
        """(L, 2^D) static row shifts of every cell corner relative to the
        cell base row (mod the level size): corner c (bit d = +1 along dim
        d) lives at ``base + (c&1)·1 + ((c>>1)&1)·S2 + ((c>>2)&1)·S3``."""
        s2, s3 = self._dup_shifts()
        _, _, sizes, _ = self._level_geometry()
        D = self.n_input_dims
        C = 1 << D
        sh = np.zeros((self.n_levels, C), np.int64)
        for c in range(C):
            sh[:, c] = (c & 1) * 1 + ((c >> 1) & 1) * s2
            if D >= 3:
                sh[:, c] += ((c >> 2) & 1) * s3
        return (sh % sizes[:, None].astype(np.int64)).astype(np.int64)

    def _pair_shifts(self):
        """(L, 2^(D−1)) shifts of each x-adjacent corner pair's base row
        relative to the cell base row (mod the level size)."""
        s2, s3 = self._dup_shifts()
        _, _, sizes, _ = self._level_geometry()
        if self.n_input_dims == 2:
            sh = np.stack([np.zeros_like(s2), s2], axis=1)
        else:
            sh = np.stack(
                [np.zeros_like(s2), s2, s3, s2 + s3], axis=1
            )
        return (sh % sizes[:, None].astype(np.int64)).astype(np.int32)

    def corner_base_and_weights(self, x: jax.Array):
        """Dup-gather addressing: returns ``base`` (L, N) int32 — the table
        row of each cell's (0,…,0) corner — and ``wc`` (L, N, 2^D), the
        multilinear corner weights in bit order (bit d of the corner index
        = +1 along dim d).

        Dense levels clamp per dimension at the top plane: when the floor
        coordinate is r−1 (the scale is fractional, so the fraction can
        still be > 0 there), the base shifts down one cell with the
        fraction pushed to 1 — reading exactly the clamped corner value
        the classic path would."""
        D = self.n_input_dims
        scales, res, sizes, hashed = self._level_geometry()
        C = 1 << D
        bits = np.zeros((C, D), np.float32)
        for c in range(C):
            for d in range(D):
                bits[c, d] = (c >> d) & 1
        bits = jnp.asarray(bits)  # (C, D)
        s2np, s3np = self._dup_shifts()
        strides = np.stack(
            [np.ones_like(s2np), s2np, s3np], axis=1
        )[:, :D]  # (L, D)

        def per_level(scale, r, size, use_hash, stride):
            pos = x * scale + 0.5
            pos0 = jnp.floor(pos)
            frac = pos - pos0
            pos0 = pos0.astype(jnp.int32)
            cd = jnp.clip(pos0, 0, r - 2)
            fd = jnp.clip(frac + (pos0 - cd).astype(jnp.float32), 0.0, 1.0)
            ce = jnp.where(use_hash, pos0, cd)
            fe = jnp.where(use_hash, frac, fd)
            base = jnp.sum(
                ce.astype(jnp.uint32) * stride.astype(jnp.uint32), axis=-1
            )
            base = jnp.where(use_hash, base % size.astype(jnp.uint32), base)
            wc = jnp.prod(
                jnp.where(bits[None, :, :] == 1.0, fe[:, None, :],
                          1.0 - fe[:, None, :]),
                axis=-1,
            )  # (N, C)
            return base.astype(jnp.int32), wc

        return jax.vmap(per_level)(
            jnp.asarray(scales), jnp.asarray(res), jnp.asarray(sizes),
            jnp.asarray(hashed), jnp.asarray(strides.astype(np.uint32)),
        )

    def __call__(
        self,
        params,
        x: jax.Array,
        max_level: int | None = None,
        differentiable_inputs: bool = False,
    ) -> jax.Array:
        """Encode positions ``x`` (N, D) in [0,1] → (N, L·F) features.

        ``max_level`` implements the reference's coarse-to-fine
        ``set_max_level`` (levels above are zeroed, gradients included).
        The default table-gradient path is the ``grid_gather_blend``
        custom VJP (a scatter-add into the table; positions are
        non-differentiable, like the reference's training path). Pass
        ``differentiable_inputs=True`` where d(out)/dx is needed (SDF
        analytic normals, camera refinement) — plain autodiff, slower
        backward."""
        table = params["table"]
        if not differentiable_inputs and self.pairs_eligible:
            base, wc = self.corner_base_and_weights(x)
            out = grid_dup_gather_blend(self, table, base, wc)
            if max_level is not None:
                level_ids = jnp.arange(self.n_levels)
                out = jnp.where((level_ids <= max_level)[:, None, None], out, 0.0)
            return jnp.transpose(out, (1, 0, 2)).reshape(x.shape[0], -1)
        if self.gather_dtype == "bfloat16" and not differentiable_inputs:
            table = table.astype(jnp.bfloat16)
        idx, w = self.indices_and_weights(x)
        if differentiable_inputs:
            # mode="clip": the default out-of-bounds fill is NaN, and
            # samples outside the AABB legitimately index out of range
            feats = jnp.take_along_axis(
                table, idx.reshape(self.n_levels, -1, 1), axis=1, mode="clip"
            )  # (L, N*C, F)
            C = idx.shape[-1]
            feats = feats.reshape(
                self.n_levels, x.shape[0], C, self.n_features_per_level
            )
            out = jnp.sum(feats * w[..., None], axis=2)  # (L, N, F)
        else:
            out = grid_gather_blend(table, idx, w)
        if max_level is not None:
            level_ids = jnp.arange(self.n_levels)
            out = jnp.where((level_ids <= max_level)[:, None, None], out, 0.0)
        # level-major feature layout, matching tcnn's output ordering
        return jnp.transpose(out, (1, 0, 2)).reshape(x.shape[0], -1)


def _sh_basis_deg4(d: jax.Array) -> jax.Array:
    """Real spherical-harmonics basis, degrees 0..3 (16 coefficients), on
    unit directions ``d`` (N, 3). Hardcoded-polynomial form as used by tcnn's
    SphericalHarmonics encoding (standard public SH constants)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    cols = [
        jnp.full_like(x, 0.28209479177387814),            # l=0
        -0.48860251190291987 * y,                          # l=1
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,                           # l=2
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),        # l=3
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return jnp.stack(cols, axis=-1)


@dataclass(frozen=True)
class SphericalHarmonicsEncoding(Encoding):
    """SH encoding of directions given in the reference's warped [0,1]³ form
    (``warp_direction`` in ``testbed_nerf.cu:389-431``): internally mapped to
    [-1,1] before basis evaluation, like tcnn."""

    n_input_dims: int = 3
    degree: int = 4

    @property
    def n_output_dims(self) -> int:
        return self.degree * self.degree

    def __call__(self, params, x: jax.Array) -> jax.Array:
        d = x * 2.0 - 1.0
        basis = _sh_basis_deg4(d)
        return basis[:, : self.n_output_dims]


@dataclass(frozen=True)
class IdentityEncoding(Encoding):
    n_input_dims: int = 3
    scale: float = 1.0
    offset: float = 0.0

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims

    def __call__(self, params, x: jax.Array) -> jax.Array:
        return x * self.scale + self.offset


@dataclass(frozen=True)
class FrequencyEncoding(Encoding):
    """NeRF-style frequency encoding: per dim, (sin, cos) of ``x·π·2^f``."""

    n_input_dims: int = 3
    n_frequencies: int = 12

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims * self.n_frequencies * 2

    def __call__(self, params, x: jax.Array) -> jax.Array:
        freqs = jnp.asarray(
            [2.0 ** f for f in range(self.n_frequencies)], jnp.float32
        )
        ang = x[:, :, None] * freqs[None, None, :] * jnp.pi  # (N, D, F)
        out = jnp.stack([jnp.sin(ang), jnp.cos(ang)], axis=-1)  # (N, D, F, 2)
        return out.reshape(x.shape[0], -1)


@dataclass(frozen=True)
class TriangleWaveEncoding(Encoding):
    """Triangle-wave encoding (cheap frequency alternative used by tcnn)."""

    n_input_dims: int = 3
    n_frequencies: int = 12

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims * self.n_frequencies

    def __call__(self, params, x: jax.Array) -> jax.Array:
        freqs = jnp.asarray(
            [2.0 ** f for f in range(self.n_frequencies)], jnp.float32
        )
        v = x[:, :, None] * freqs[None, None, :] / 2.0
        frac = v - jnp.floor(v)
        tri = jnp.abs(frac * 2.0 - 1.0) * 2.0 - 1.0
        return tri.reshape(x.shape[0], -1)


@dataclass(frozen=True)
class OneBlobEncoding(Encoding):
    """OneBlob encoding (Müller et al., Neural Importance Sampling): each
    input in [0,1] is splatted as a gaussian-ish blob integrated over
    ``n_bins`` uniform bins. We use the quartic kernel CDF like tcnn."""

    n_input_dims: int = 3
    n_bins: int = 16

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims * self.n_bins

    def __call__(self, params, x: jax.Array) -> jax.Array:
        n = self.n_bins
        edges = jnp.arange(n + 1, dtype=jnp.float32) / n  # (n+1,)
        # Quartic kernel with radius 1/n centered at x; CDF evaluated at edges.
        def cdf(t):
            # t in kernel-local coords, kernel support [-1, 1]
            u = jnp.clip(t, -1.0, 1.0)
            return 0.5 + u * (15.0 / 16.0 + u * u * (-10.0 / 16.0 + u * u * 3.0 / 16.0))

        scale = n / 2.0  # kernel radius = 2 bins, like tcnn's ONE_BLOB radius
        t = (edges[None, None, :] - x[:, :, None]) * scale
        c = cdf(t)
        out = c[:, :, 1:] - c[:, :, :-1]  # (N, D, n)
        return out.reshape(x.shape[0], -1)


@dataclass
class CompositeEncoding(Encoding):
    """Concatenation of nested encodings over disjoint input slices, matching
    tcnn's Composite (used for the reference's dir encoding: SH on the first
    3 dims + Identity on the latent extras, ``configs/nerf/base.json``)."""

    nested: Sequence[tuple[Encoding, int]] = field(default_factory=list)
    # each entry: (encoding, n_dims_to_encode)

    @property
    def n_input_dims(self) -> int:
        return sum(n for _, n in self.nested)

    @property
    def n_output_dims(self) -> int:
        return sum(e.n_output_dims for e, _ in self.nested)

    @property
    def n_params(self) -> int:
        return sum(e.n_params for e, _ in self.nested)

    def init(self, key: jax.Array):
        keys = jax.random.split(key, max(len(self.nested), 1))
        return {f"nested_{i}": e.init(keys[i]) for i, (e, _) in enumerate(self.nested)}

    def __call__(self, params, x: jax.Array) -> jax.Array:
        outs, off = [], 0
        for i, (enc, ndims) in enumerate(self.nested):
            outs.append(enc(params[f"nested_{i}"], x[:, off : off + ndims]))
            off += ndims
        return jnp.concatenate(outs, axis=-1)

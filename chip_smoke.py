#!/usr/bin/env python3
"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: device, parity, NeRF, image
    python chip_smoke.py --devices 4   # four cards: DP and FSDP steps only

One card, in order (each phase raises on failure; nothing is caught):

1. device: JAX's backend must be ``gpu`` (never the CPU).
2. parity at upstream width (L=16, F=2, T=2^19, 2^18 samples): the table
   gradient of both grid VJPs against a float64 host ``np.bincount``, and
   the encoding forward against the plain ``differentiable_inputs=True``
   path.
3. NeRF: ``NerfEngine`` with the upstream config on the deterministic
   sphere scene of ``__graft_entry__._tiny_sphere_dataset`` (24 views at
   256²), 512 steps, then train-view PSNR and a full render.
4. image: ``ImageEngine`` with the reference image config on a seeded
   1024² procedural image, 256 steps.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np

# float32 atomics sum a few hundred addends per table row in an order
# that changes from run to run
GRAD_TOL = 1e-5  # max |Δ| / max |ref|, per level
FWD_TOL_F32 = 1e-6  # relative, float32 rows (XOR hash)
FWD_TOL_BF16 = 1e-2  # relative, packed-bf16 rows (dup-gather)
PSNR_MIN_DB = 20.0
# DP gradients vs single-card math: same arithmetic up to the order of
# atomic and all-reduce summation
DP_RTOL, DP_ATOL = 1e-3, 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    if not shutil.which("nvidia-smi"):
        return "nvidia-smi: not found"
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip() or f"nvidia-smi: rc={r.returncode}"


# ---------------------------------------------------------------- phases


def phase_device(n_devices: int) -> dict:
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"{n_devices} cards requested, {len(devs)} present")
    log(f"card: {card_line()}")
    log(f"device: {devs[0].device_kind} x{len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _level_bincount(keys, vals, n_rows: int) -> np.ndarray:
    """float64 host segment sum: keys (L, M), vals (L, M, F) -> (L, T, F)."""
    L, _, F = vals.shape
    out = np.zeros((L, n_rows, F), np.float64)
    for l in range(L):
        for f in range(F):
            out[l, :, f] = np.bincount(
                keys[l], weights=vals[l, :, f].astype(np.float64),
                minlength=n_rows)
    return out


def _worst_level_err(got, ref) -> float:
    """max over levels of max|Δ| / max|ref|."""
    worst = 0.0
    for l in range(ref.shape[0]):
        scale = float(np.abs(ref[l]).max())
        err = float(np.abs(got[l].astype(np.float64) - ref[l]).max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def phase_parity(n_levels: int = 16, log2_table: int = 19,
                 n_samples: int = 1 << 18, seed: int = 0) -> dict:
    """Table gradient and forward of both grid VJPs against plain
    references."""
    import jax
    import jax.numpy as jnp

    from ngp_tpu.models.encodings import (
        GridEncoding, grid_dup_gather_blend, grid_gather_blend,
    )

    kw = dict(n_levels=n_levels, n_features_per_level=2,
              log2_hashmap_size=log2_table, base_resolution=16,
              per_level_scale=2.0)
    key = jax.random.PRNGKey(seed)
    kx, kt, kg = jax.random.split(key, 3)
    x = jax.random.uniform(kx, (n_samples, 3), maxval=1.0 - 1e-6)
    res = {}
    for name, hash_variant in (("xor", "tcnn"), ("additive", "additive")):
        enc = GridEncoding(hash_variant=hash_variant, **kw)
        L, F = enc.n_levels, enc.n_features_per_level
        T = enc.max_table_rows
        table = jax.random.uniform(kt, (L, T, F), minval=-1.0, maxval=1.0)
        g = jax.random.normal(kg, (L, n_samples, F))
        if hash_variant == "tcnn":
            idx, w = jax.jit(enc.indices_and_weights)(x)
            fn = grid_gather_blend
            args = (idx, w)
            keys, wts = idx, w
        else:
            base, wc = jax.jit(enc.corner_base_and_weights)(x)
            fn = functools.partial(grid_dup_gather_blend, enc)
            args = (base, wc)
            shifts = enc._corner_shifts()  # (L, C) static
            _, _, sizes, _ = enc._level_geometry()
            keys = (np.asarray(base)[:, :, None] + shifts[:, None, :]) % (
                sizes.astype(np.int64)[:, None, None])
            wts = wc

        def loss(t, *a, fn=fn, g=g):
            return jnp.sum(fn(t, *a) * g)

        t0 = time.perf_counter()
        dtable = np.asarray(jax.jit(jax.grad(loss))(table, *args))
        t_grad = time.perf_counter() - t0
        vals = np.asarray(wts)[..., None] * np.asarray(g)[:, :, None, :]
        ref = _level_bincount(
            np.asarray(keys).reshape(L, -1).astype(np.int64),
            vals.reshape(L, -1, F), T)
        gerr = _worst_level_err(dtable, ref)
        log(f"parity {name}: table gradient max|Δ|/max|ref| = {gerr:.3e} "
            f"(tol {GRAD_TOL:g}; first call incl. compile {t_grad:.1f} s)")
        check(gerr <= GRAD_TOL, f"{name} table gradient error {gerr:.3e}")

        with jax.default_matmul_precision("highest"):
            out = np.asarray(jax.jit(enc.__call__)({"table": table}, x))
            plain = np.asarray(jax.jit(
                lambda p, x: enc(p, x, differentiable_inputs=True))(
                    {"table": table}, x))
        ferr = float(np.abs(out - plain).max() / np.abs(plain).max())
        tol = FWD_TOL_F32 if hash_variant == "tcnn" else FWD_TOL_BF16
        log(f"parity {name}: forward max|Δ|/max|ref| = {ferr:.3e} "
            f"(tol {tol:g})")
        check(np.all(np.isfinite(out)), f"{name} forward not finite")
        check(ferr <= tol, f"{name} forward error {ferr:.3e}")
        res[name] = {"grad_err": gerr, "fwd_err": ferr}
    return res


def _psnr(pred, target) -> float:
    mse = float(np.mean((np.asarray(pred, np.float64) - target) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))


def phase_nerf(n_steps: int = 512, timed_steps: int = 128,
               batch_size: int = 1 << 18, n_views: int = 24, res: int = 256,
               config: dict | None = None, engine_kw: dict | None = None
               ) -> dict:
    """Train NerfEngine on the sphere scene, then check PSNR of a training
    view and of a full render against its ground truth."""
    import jax

    from __graft_entry__ import _default_config, _tiny_sphere_dataset
    from ngp_tpu.engines.nerf import NerfEngine

    cfg = config or _default_config("upstream")
    ds = _tiny_sphere_dataset(n_views=n_views, res=res)
    engine = NerfEngine(cfg, ds, batch_size=batch_size, **(engine_kw or {}))
    state, grid = engine.init_state(), engine.init_grid()
    losses = []
    t0 = time.perf_counter()
    done = 0
    while done < n_steps - timed_steps:
        chunk = min(32, n_steps - timed_steps - done)
        state, grid, m = engine.train(state, grid, chunk)
        losses.append(float(m["loss"]))
        done += chunk
    t_warm = time.perf_counter() - t0
    jax.block_until_ready(state.params)
    t0 = time.perf_counter()
    state, grid, m = engine.train(state, grid, timed_steps)
    jax.block_until_ready(state.params)
    dt = time.perf_counter() - t0
    losses.append(float(m["loss"]))
    steps_per_s = timed_steps / dt
    log(f"nerf: loss {losses[0]:.5f} -> {losses[-1]:.5f} over {n_steps} "
        f"steps (first {n_steps - timed_steps} incl. compile: {t_warm:.1f} s)")
    log(f"nerf: {steps_per_s:.2f} steps/s over the last {timed_steps} steps "
        f"(batch {batch_size} samples; card: {card_line()})")
    check(all(math.isfinite(l) for l in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    train_psnr = float(engine.psnr(state, grid, 0, stride=1))
    img = np.asarray(engine.render_image(state, grid, 0))
    gt = ds.images[0].astype(np.float32) / 255.0
    a = gt[..., 3:4]
    target = gt[..., :3] * a + (1.0 - a) * np.asarray(
        engine.background_color, np.float32)
    render_psnr = _psnr(img, target)
    log(f"nerf: train-view PSNR {train_psnr:.2f} dB, render {img.shape} "
        f"PSNR {render_psnr:.2f} dB (min {PSNR_MIN_DB:g})")
    check(img.shape == (res, res, 3), f"render shape {img.shape}")
    check(bool(np.all(np.isfinite(img))), "render not finite")
    check(train_psnr >= PSNR_MIN_DB, f"train PSNR {train_psnr:.2f}")
    check(render_psnr >= PSNR_MIN_DB, f"render PSNR {render_psnr:.2f}")
    return {"loss": losses, "steps_per_s": steps_per_s,
            "train_psnr": train_psnr, "render_psnr": render_psnr}


def procedural_image(side: int, seed: int = 0) -> np.ndarray:
    """Seeded (side, side, 4) float32 image: smooth sinusoids plus a few
    hard-edged discs, opaque."""
    rng = np.random.default_rng(seed)
    u = (np.arange(side, dtype=np.float32) + 0.5) / side
    X, Y = np.meshgrid(u, u)
    img = np.zeros((side, side, 4), np.float32)
    img[..., 3] = 1.0
    for c in range(3):
        acc = np.full_like(X, 0.5)
        for _ in range(4):
            fx, fy = rng.uniform(1.0, 6.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += 0.1 * np.sin(2 * np.pi * (fx * X + fy * Y) + ph)
        img[..., c] = acc
    for _ in range(6):
        cx, cy, r = rng.uniform(0.15, 0.85), rng.uniform(0.15, 0.85), \
            rng.uniform(0.04, 0.12)
        inside = (X - cx) ** 2 + (Y - cy) ** 2 < r * r
        img[inside, :3] = rng.uniform(0.0, 1.0, 3)
    return np.clip(img, 0.0, 1.0)


def phase_image(n_steps: int = 256, side: int = 1024,
                batch_size: int = 1 << 18, config: dict | None = None
                ) -> dict:
    """Fit ImageEngine to the procedural image; check its PSNR."""
    import jax

    from ngp_tpu.engines.image import ImageEngine
    from ngp_tpu.testbed import default_config

    cfg = config or default_config("image")
    engine = ImageEngine(cfg, procedural_image(side), batch_size=batch_size)
    state = engine.init_state()
    t0 = time.perf_counter()
    state, losses = engine.train(state, n_steps)
    jax.block_until_ready(state.params)
    dt = time.perf_counter() - t0
    losses = np.asarray(losses)
    mse = engine.compute_mse(state)
    psnr = -10.0 * math.log10(max(mse, 1e-12))
    log(f"image: {side}² fit, {n_steps} steps in {dt:.1f} s incl. compile, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, PSNR {psnr:.2f} dB "
        f"(min {PSNR_MIN_DB:g})")
    check(bool(np.all(np.isfinite(losses))), "non-finite image loss")
    check(psnr >= PSNR_MIN_DB, f"image PSNR {psnr:.2f}")
    return {"psnr": psnr}


def phase_multi(n_devices: int = 4, batch_size: int = 1 << 18,
                n_views: int = 24, res: int = 256,
                config: dict | None = None, engine_kw: dict | None = None,
                fsdp_min_size: int = 1 << 14) -> dict:
    """DP train step on ``n_devices`` cards against the mean of per-shard
    single-card gradients, then one FSDP step."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _default_config, _tiny_sphere_dataset
    from ngp_tpu.engines.nerf import NerfEngine
    from ngp_tpu.parallel.mesh import make_mesh
    from ngp_tpu.parallel.nerf_dp import build_dp_train_step
    from ngp_tpu.parallel.nerf_fsdp import build_fsdp_train_step, shard_state

    cfg = config or _default_config("upstream")
    engine = NerfEngine(cfg, _tiny_sphere_dataset(n_views=n_views, res=res),
                        batch_size=batch_size, **(engine_kw or {}))
    mesh = make_mesh(n_devices)
    state, grid = engine.init_state(), engine.init_grid()
    grid = engine.update_grid(state, grid, jax.random.PRNGKey(3), warmup=True)
    key = jax.random.PRNGKey(42)

    step = build_dp_train_step(engine, mesh, return_grads=True)
    _, dp_metrics = step(state, grid, key)
    dp_grads = jax.device_get(dp_metrics["grads"])
    check(math.isfinite(float(dp_metrics["loss"])), "DP loss not finite")

    n_local = max(engine._n_rays // n_devices, 1)
    ref_state = engine.init_state()
    loss_and_grads = jax.jit(engine.batch_loss_and_grads,
                             static_argnames=("k", "n_rays"))
    acc = None
    for i in range(n_devices):
        _, _, g = loss_and_grads(
            ref_state.params, grid.bitfield, grid.mean_density,
            jax.random.fold_in(key, i), engine.data, k=engine._k,
            n_rays=n_local)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    ref = jax.device_get(jax.tree.map(lambda a: a / n_devices, acc))

    worst, worst_leaf = 0.0, ""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(dp_grads),
                            jax.tree.leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.size == 0:
            continue
        r = float(np.max(np.abs(a - b) / (DP_ATOL + DP_RTOL * np.abs(b))))
        if r > worst:
            worst, worst_leaf = r, jax.tree_util.keystr(path)
    log(f"dp x{n_devices}: loss {float(dp_metrics['loss']):.5f}, gradients "
        f"vs single-card mean: max |Δ|/(atol+rtol·|ref|) = {worst:.3e} "
        f"(rtol {DP_RTOL:g}, atol {DP_ATOL:g}; worst leaf {worst_leaf})")
    check(worst <= 1.0, f"DP gradients off single-card math ({worst:.3f})")

    sstate = shard_state(engine.init_state(), mesh, min_size=fsdp_min_size)
    fsdp = build_fsdp_train_step(engine, mesh, min_size=fsdp_min_size)
    sstate, fm = fsdp(sstate, grid, jax.random.PRNGKey(14))
    jax.block_until_ready(sstate.params)
    floss = float(fm["loss"])
    log(f"fsdp x{n_devices}: loss {floss:.5f}")
    check(math.isfinite(floss), "FSDP loss not finite")

    in_use = []
    for d in jax.devices()[:n_devices]:
        stats = d.memory_stats() or {}
        in_use.append((stats.get("bytes_in_use", 0),
                       stats.get("peak_bytes_in_use", 0)))
    log("memory in use / peak per card (GiB): " + ", ".join(
        f"{i}: {u / 2**30:.2f} / {p / 2**30:.2f}"
        for i, (u, p) in enumerate(in_use)))
    return {"dp_ratio": worst, "fsdp_loss": floss, "memory": in_use}


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card DP and FSDP phase")
    args = ap.parse_args(argv)

    device = phase_device(args.devices)
    from ngp_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.devices == 1:
        phase_parity()
        phase_nerf()
        phase_image()
    else:
        phase_multi(args.devices)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

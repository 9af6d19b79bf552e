"""Benchmark: fox NeRF training throughput + quality on the available
accelerator.

Prints ONE JSON line:
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}``

Baseline estimate: the reference trains "a fox NeRF in under 5 seconds" on
an RTX 3090 (``/root/reference/README.md:5``) at batch 2^18 samples/step —
roughly 1000 steps in ~5 s ≈ **5.2e7 training samples/s**. ``vs_baseline``
is measured samples/s against that estimate.

The whole run is wall-clock budgeted (``BENCH_BUDGET_S``, default 1500 s —
first compiles on a cold cache eat minutes; a persistent compile cache makes
later invocations cheap). Every phase checks the deadline and degrades
gracefully; the JSON line is printed even on error/timeout, with whatever
was measured so far.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

FOX = "/root/reference/data/nerf/fox"
BASELINE_SAMPLES_PER_S = 5.2e7
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 1500))
NO_GPU_RC = 3  # child exit code: no GPU backend, nothing was measured
T_START = time.time()
PARTIAL = os.environ.get(
    "BENCH_PARTIAL_FILE", f"/tmp/ngp_bench_partial_{os.getpid()}.json"
)

RESULT = {
    "metric": "nerf_train_samples_per_s",
    "value": 0.0,
    "unit": "samples/s",
    "vs_baseline": 0.0,
    "extra": {"phase": "init"},
}


def checkpoint_result():
    """Persist the current RESULT so the supervisor can emit it even if
    this process dies inside a native call (where Python signal handlers
    never run — the exact way round 1's bench produced no datum)."""
    RESULT["extra"]["total_wall_s"] = round(time.time() - T_START, 1)
    try:
        with open(PARTIAL, "w") as f:
            json.dump(RESULT, f)
    except OSError:
        pass


def emit_and_exit(signum=None, frame=None):
    RESULT["extra"]["total_wall_s"] = round(time.time() - T_START, 1)
    checkpoint_result()
    print(json.dumps(RESULT), flush=True)
    sys.exit(0)


def remaining() -> float:
    return BUDGET_S - (time.time() - T_START)


def supervise() -> None:
    """Run the measurement in a child process; guarantee ONE JSON line on
    stdout no matter where the child blocks or how it dies — including
    the round-1 failure mode where an OUTER driver `timeout` SIGTERMs this
    supervisor itself before the internal budget elapses."""
    partial = f"/tmp/ngp_bench_partial_{os.getpid()}.json"
    env = {**os.environ, "BENCH_CHILD": "1", "BENCH_PARTIAL_FILE": partial}

    def emit_partial(note: str) -> None:
        try:
            with open(partial) as f:
                snap = json.load(f)
            snap["extra"]["supervisor_note"] = note
            print(json.dumps(snap), flush=True)
            return
        except (OSError, ValueError):
            pass
        RESULT["extra"]["error"] = note
        RESULT["extra"]["total_wall_s"] = round(time.time() - T_START, 1)
        print(json.dumps(RESULT), flush=True)

    child_holder = {}

    def on_signal(signum, frame):
        proc = child_holder.get("proc")
        if proc is not None:
            try:
                proc.kill()
            except OSError:
                pass
        emit_partial(f"supervisor got signal {signum}")
        os._exit(0)  # bypass atexit/buffers: the outer timeout is imminent

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        child_holder["proc"] = proc
        out, err = proc.communicate(timeout=max(BUDGET_S - 5, 30))
        if proc.returncode == NO_GPU_RC:
            sys.stderr.write(err[-2000:])
            sys.exit(NO_GPU_RC)
        lines = [l for l in out.splitlines() if l.startswith("{")]
        if lines:
            print(lines[-1], flush=True)
            return
        RESULT["extra"]["error"] = (
            f"child rc={proc.returncode}, no JSON; stderr tail: " + err[-300:]
        )
    except subprocess.TimeoutExpired:
        child_holder["proc"].kill()
        RESULT["extra"]["error"] = "supervisor timeout"
    # fall back to the child's last phase checkpoint
    emit_partial(RESULT["extra"].get("error", "recovered from partial"))


def main():
    # A hard alarm slightly inside the budget guarantees the JSON line is
    # printed even if a compile or a device call hangs; SIGTERM/SIGINT
    # handlers do the same if an outer driver timeout fires first
    # (an outer `timeout` would otherwise leave nothing printed).
    signal.signal(signal.SIGALRM, emit_and_exit)
    signal.signal(signal.SIGTERM, emit_and_exit)
    signal.signal(signal.SIGINT, emit_and_exit)
    signal.alarm(max(int(BUDGET_S) - 5, 30))

    import jax

    from ngp_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        # a CPU timing is no device number: stop instead of reporting one
        sys.stderr.write(
            f"bench.py: no GPU backend (found {jax.default_backend()!r})\n"
        )
        sys.exit(NO_GPU_RC)
    enable_compile_cache()

    from ngp_tpu.engines.nerf import NerfEngine

    holdout_ds = None
    if os.path.isdir(FOX):
        from ngp_tpu.data.nerf_loader import load_nerf

        full = load_nerf(os.path.join(FOX, "transforms.json"))
        # Held-out eval split (BASELINE: generalization, not train-view):
        # every 8th view is excluded from training.
        test_idx = list(range(0, full.n_images, 8))
        train_idx = [i for i in range(full.n_images) if i not in set(test_idx)]
        dataset = full.subset(train_idx)
        holdout_ds = full.subset(test_idx)
        scene = "fox"
    else:
        from __graft_entry__ import _tiny_sphere_dataset

        dataset = _tiny_sphere_dataset(n_views=12, res=128)
        scene = "synthetic-sphere"

    from __graft_entry__ import _default_config

    cfg = _default_config()
    # NGP_TPU_BENCH_INTERP=Simplex: tetrahedral grid lookups (4 rows per
    # sample instead of 8 — see docs/PERF.md).
    if os.environ.get("NGP_TPU_BENCH_INTERP"):
        cfg["encoding"]["interpolation"] = os.environ["NGP_TPU_BENCH_INTERP"]
    engine = NerfEngine(cfg, dataset, batch_size=1 << 18)
    state = engine.init_state()
    grid = engine.init_grid()
    RESULT["extra"] = {
        "scene": scene,
        "backend": jax.default_backend(),
        "n_devices": jax.device_count(),
        "interpolation": cfg["encoding"].get("interpolation", "Linear"),
        "n_train_views": int(dataset.n_images),
        "phase": "train",
    }
    checkpoint_result()

    # Train toward the north-star quality targets (BASELINE.json:
    # time-to-PSNR on fox), probing train-view PSNR every 128 steps.
    # ``train_wall_s`` counts training time only (PSNR probes excluded);
    # ``*_wall`` marks include them, both exclude process startup.
    #
    # Budget-proofing (round-3 verdict task 5): training may use at most
    # 65% of the budget, guaranteeing the holdout/render/microbench
    # phases always run in the same invocation. Compile stalls are
    # tracked separately: a chunk whose wall time exceeds 4x the trailing
    # median carries a fresh (k, n_rays) program compile —
    # time_to_psnr_* is reported raw AND compile-excluded.
    t_train0 = time.time()
    train_wall = 0.0
    compile_stall = 0.0
    steps = 0
    psnr_probe = 0.0
    # 35% reserve for the non-train phases (holdout 8 views + render +
    # microbench).
    t_reserve = max(0.35 * BUDGET_S, 270.0)
    max_steps = int(os.environ.get("BENCH_MAX_STEPS", 12288))
    thr_window = []  # (steps, train-seconds) chunks for trailing throughput
    import statistics

    while steps < max_steps and remaining() > t_reserve:
        t0 = time.time()
        state, grid, m = engine.train(state, grid, 32)
        dt = time.time() - t0
        train_wall += dt
        steps += 32
        clean = [c[1] for c in thr_window[-12:]]
        if len(clean) >= 4 and dt > 4.0 * statistics.median(clean):
            compile_stall += dt - statistics.median(clean)
        thr_window.append((32, dt, engine.samples_per_step, engine._n_rays))
        if steps % 128 == 0:
            try:
                psnr_probe = float(engine.psnr(state, grid, 0, stride=12))
            except Exception:  # noqa: BLE001
                psnr_probe = float("nan")
            for tgt in (25, 30):
                kname = f"time_to_psnr_{tgt}"
                if psnr_probe >= tgt and kname not in RESULT["extra"]:
                    RESULT["extra"][kname] = round(train_wall, 1)
                    RESULT["extra"][kname + "_step"] = steps
                    RESULT["extra"][kname + "_excl_compile"] = round(
                        train_wall - compile_stall, 1
                    )
            RESULT["extra"]["train_view_psnr"] = round(psnr_probe, 2)
            RESULT["extra"]["steps"] = steps
            RESULT["extra"]["final_k"] = engine._k
            RESULT["extra"]["compile_stall_s"] = round(compile_stall, 1)
            checkpoint_result()
            if "time_to_psnr_30" in RESULT["extra"] and steps >= 1024:
                break
    for tgt in (25, 30):
        RESULT["extra"].setdefault(f"time_to_psnr_{tgt}", "not reached")

    # Throughput over the trailing third of training (post-pruning steady
    # state; compiles for early K buckets land in the leading chunks).
    tail = thr_window[-max(len(thr_window) // 3, 1):]
    t_steps = sum(c[0] for c in tail)
    t_secs = sum(c[1] for c in tail)
    t_samples = sum(c[0] * c[2] for c in tail)
    t_rays = sum(c[0] * c[3] for c in tail)
    samples_per_s = t_samples / max(t_secs, 1e-9)
    RESULT["value"] = round(samples_per_s, 1)
    RESULT["vs_baseline"] = round(samples_per_s / BASELINE_SAMPLES_PER_S, 4)
    RESULT["extra"].update(
        steps_per_s=round(t_steps / max(t_secs, 1e-9), 2),
        measured_steps=t_steps,
        measure_wall_s=round(t_secs, 2),
        rays_per_s=round(t_rays / max(t_secs, 1e-9), 1),
        final_k=engine._k,
        step_at_measure_end=int(state.step),
        train_wall_s=round(train_wall, 1),
        phase="eval",
    )
    checkpoint_result()

    # Held-out PSNR (generalization — BASELINE eval protocol,
    # reference scripts/run.py:208-266).
    if holdout_ds is not None and remaining() > 90:
        try:
            res = engine.eval_test_transforms(
                state, grid, holdout_ds, stride=4,
                max_views=min(8, holdout_ds.n_images),
            )
            RESULT["extra"]["holdout_psnr"] = round(float(res["psnr"]), 2)
            RESULT["extra"]["holdout_views"] = int(res["n_views"])
        except Exception as e:  # noqa: BLE001
            RESULT["extra"]["holdout_error"] = repr(e)[:200]
        checkpoint_result()

    # Render-path benchmark (VERDICT r4 missing #3): wall-time a full
    # camera view at half resolution (fox: 960x540 = 518k rays), warm.
    # Each frame is fetched to host (np.asarray) — this measures the
    # user-visible frame latency including the chunked dispatch loop.
    if remaining() > 90:
        try:
            import numpy as _np

            t0 = time.perf_counter()
            img = _np.asarray(engine.render_image(state, grid, 0, stride=2))
            RESULT["extra"]["render_first_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 1
            )
            n_frames = 3
            t0 = time.perf_counter()
            for _ in range(n_frames):
                img = _np.asarray(
                    engine.render_image(state, grid, 0, stride=2)
                )
            dt = (time.perf_counter() - t0) / n_frames
            n_rays = img.shape[0] * img.shape[1]
            RESULT["extra"]["render_ms_per_frame"] = round(dt * 1e3, 1)
            RESULT["extra"]["render_rays_per_s"] = round(n_rays / dt, 1)
            RESULT["extra"]["render_resolution"] = [img.shape[1], img.shape[0]]
        except Exception as e:  # noqa: BLE001
            RESULT["extra"]["render_bench_error"] = repr(e)[:200]
        checkpoint_result()

    # hash+MLP forward / backward microbench at a 2^18 batch (BASELINE
    # metric "hash+MLP fwd/bwd us/batch"). DISTINCT closures per variant
    # (jax.jit of one function object shares one trace cache); iterations
    # chain through a data dependence and end in ONE host fetch.
    if remaining() > 60:
        try:
            import jax.numpy as jnp

            net = engine.network
            params = engine.inference_params(state).get("model", state.params["model"])
            n = 1 << 18
            key = jax.random.PRNGKey(0)
            pos = jax.random.uniform(key, (n, 3))
            dirs = jax.random.uniform(jax.random.fold_in(key, 1), (n, 3))

            def fwd_fn(p, pos, dirs, t):
                return jnp.sum(net(p, (pos + t * 1e-30) % 1.0, dirs)[::4097])

            def loss(p, pos, dirs, t):
                return jnp.sum(net(p, (pos + t * 1e-30) % 1.0, dirs) ** 2)

            def bwd_fn(p, pos, dirs, t):
                # consume EVERY gradient leaf — reducing only one leaf
                # lets XLA dead-code-eliminate the rest (notably the
                # hash-table segment sum), which made rounds 3-5 report
                # bwd ~= fwd
                g = jax.grad(loss)(p, pos, dirs, t)
                return sum(
                    jnp.sum(x[..., ::257]) for x in jax.tree.leaves(g)
                )

            R_ = 12
            for name, fn in (("hash_mlp_fwd_us", fwd_fn), ("hash_mlp_bwd_us", bwd_fn)):
                jf = jax.jit(fn)
                acc = jnp.float32(0)
                for w in range(4):
                    acc = acc + jf(params, pos, dirs, acc * 1e-30 - w)
                float(acc)
                settled = 0.0
                for win in range(2):
                    t0 = time.perf_counter()
                    for r in range(R_):
                        acc = acc + jf(params, pos, dirs, acc * 1e-30 + r + win * R_)
                    float(acc)
                    settled = (time.perf_counter() - t0) / R_ * 1e6
                RESULT["extra"][name] = round(settled, 1)
            f_us = RESULT["extra"].get("hash_mlp_fwd_us", 0)
            b_us = RESULT["extra"].get("hash_mlp_bwd_us", 0)
            if f_us and b_us:
                # bwd = grad of (encode+MLPs): fwd replay + table segment
                # sum + MLP grads; expect bwd/fwd >= ~1.5
                RESULT["extra"]["hash_mlp_bwd_over_fwd"] = round(b_us / f_us, 2)
                RESULT["extra"]["hash_mlp_fwd_samples_per_s"] = round(n / (f_us * 1e-6), 1)
        except Exception as e:  # noqa: BLE001
            RESULT["extra"]["kernel_bench_error"] = repr(e)[:200]
        checkpoint_result()

    RESULT["extra"]["phase"] = "done"
    emit_and_exit()


if __name__ == "__main__":
    if os.environ.get("BENCH_CHILD") != "1":
        supervise()
        sys.exit(0)
    try:
        main()
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001
        RESULT["extra"]["error"] = repr(e)[:500]
        emit_and_exit()

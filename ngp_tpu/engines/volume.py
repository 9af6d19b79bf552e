"""Volume engine — JAX counterpart of ``src/testbed_volume.cu``.

A hash-encoded MLP learns ``pos → (radiance rgb, density)`` supervised by a
Woodcock/delta-tracking path tracer over a reference density volume
(NanoVDB in the reference, a dense index-space array here — see
``ngp_tpu/data/volume.py``). Rendering delta-tracks the learned field.

Static-shape reshaping of the reference kernels:

* ``volume_generate_training_data_kernel`` (``testbed_volume.cu:87-156``)
  runs one CUDA thread per episode with an unbounded retry loop; here a
  fixed-length masked ``fori`` walks all episodes in lockstep, recording up
  to 4 interaction vertices via one-hot cursor writes, and the loss masks
  unfilled slots (the reference retries until 4 fill — a stochastic batch
  size in exchange for static shapes).
* the render loop (``volume_render_kernel_step``) wavefront-compacts with
  atomics per step; here all pixels march in lockstep under an alive mask
  inside one ``while_loop`` — no host syncs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ngp_tpu.data.volume import BITGRID_RES, DenseVolume
from ngp_tpu.models.factory import create_loss, create_network_with_input_encoding
from ngp_tpu.train import Trainer, TrainState

MAX_TRAIN_VERTICES = 4  # testbed_volume.cu:85
MAX_WALK_ITERS = 512  # flat jump loop: events + empty skips + null collisions


def proc_envmap(dirs, up_dir, sun_dir, sky_col):
    """Procedural sun/sky (``proc_envmap``, ``testbed_volume.cu:46-60``)."""
    skyam = jnp.sum(dirs * up_dir, -1) * 0.5 + 0.5
    sunam = jnp.maximum(0.0, jnp.sum(dirs * sun_dir, -1)) ** 64
    sun_col = jnp.asarray([255.0, 215.0, 195.0]) / 255.0
    return sky_col[None, :] * skyam[:, None] + sun_col[None, :] * (20.0 * sunam)[:, None]


@dataclass
class VolumeEngine:
    config: dict
    volume: DenseVolume
    batch_size: int = 1 << 16
    albedo: float = 0.95  # testbed.h:885
    scattering: float = 0.0
    inv_distance_scale: float = 100.0  # testbed.h:887
    sky_color: tuple = (0.0, 0.0, 0.0)  # m_background_color.rgb
    sun_dir: tuple = (0.57735, 0.57735, 0.57735)
    up_dir: tuple = (0.0, 1.0, 0.0)
    seed: int = 1337

    def __post_init__(self):
        self.model = create_network_with_input_encoding(3, 4, self.config)
        self.trainer = Trainer(
            model_fn=self.model.__call__,
            loss_fn=create_loss(self.config.get("loss", {"otype": "L2"})),
            optimizer_cfg=self.config["optimizer"],
        )
        v = self.volume
        self.aabb_min = jnp.asarray(v.aabb_min)
        self.aabb_max = jnp.asarray(v.aabb_max)
        self.distance_scale = 1.0 / max(self.inv_distance_scale, 0.01)
        self._jit: dict[Any, Any] = {}

    def init_state(self) -> TrainState:
        return self.trainer.init(self.model.init(jax.random.PRNGKey(self.seed)))

    # -- volume access helpers

    def _bit_occupied(self, pos):
        """Unit-cube position → 128³ bitgrid lookup (walk_to_next_event's
        early-out, ``testbed_volume.cu:72-83``)."""
        idx = jnp.floor(pos * BITGRID_RES + 0.5).astype(jnp.int32)
        ok = jnp.all((idx >= 0) & (idx < BITGRID_RES), axis=-1)
        idx = jnp.clip(idx, 0, BITGRID_RES - 1)
        return ok & (self.volume.bitgrid[idx[:, 0], idx[:, 1], idx[:, 2]] > 0)

    def _density_at(self, pos, key):
        """Stochastically jittered nearest-neighbor density lookup in index
        space (the reference jitters the integer cast)."""
        v = self.volume
        ip = pos * v.world2index_scale + jnp.asarray(v.world2index_offset)
        u = jax.random.uniform(key, pos.shape)
        idx = jnp.floor(ip + u).astype(jnp.int32)
        shape = jnp.asarray(v.density.shape)
        ok = jnp.all((idx >= 0) & (idx < shape), axis=-1)
        idx = jnp.clip(idx, 0, shape - 1)
        return jnp.where(ok, v.density[idx[:, 0], idx[:, 1], idx[:, 2]], 0.0)

    def _jump(self, pos, dirs, alive, u):
        """One delta-tracking advance per ray: a Woodcock free flight when
        the current bit cell is occupied, else a deterministic skip to the
        next bitgrid cell (free flight through zero-density space is
        unattenuated, so skipping it is statistically exact — the
        "spatially varying majorant" optimization the reference's
        ``walk_to_next_event`` TODO mentions). Returns (pos, at_event,
        alive) — ``at_event`` marks rays landing in occupied cells."""
        scale = self.distance_scale / self.volume.global_majorant
        occupied_here = self._bit_occupied(pos)
        dt_w = -jnp.log(jnp.maximum(1.0 - u, 1e-12)) * scale
        # DDA distance to the next bitgrid cell boundary
        res = float(BITGRID_RES)
        p = pos * res
        step = jnp.sign(dirs)
        # bit cells are centered on integers (idx = floor(p + 0.5)), so
        # boundaries sit at half-integers
        boundary = jnp.floor(p + 0.5) + 0.5 * step
        t_axis = (boundary - p) / jnp.where(jnp.abs(dirs) > 1e-12, dirs, 1e-12)
        t_axis = jnp.where(t_axis > 0, t_axis, jnp.inf)
        dt_skip = jnp.clip(jnp.min(t_axis, axis=-1), 1e-3, res) / res + 1e-5
        dt = jnp.where(occupied_here, dt_w, dt_skip)
        newpos = jnp.where(alive[:, None], pos + dirs * dt[:, None], pos)
        inside = jnp.all((newpos >= self.aabb_min) & (newpos <= self.aabb_max), axis=-1)
        alive = alive & inside
        at_event = alive & occupied_here & self._bit_occupied(newpos)
        return newpos, at_event, alive

    # -- training data (volume_generate_training_data_kernel)

    def generate_training_data(self, key, n_episodes: int):
        """Path-trace episodes; returns (positions (E·4, 3), targets
        (E·4, 4) [rgb, density], valid (E·4,))."""
        k1, k2, k3 = jax.random.split(key, 3)
        E = n_episodes
        d1 = jax.random.normal(k1, (E, 3))
        start = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True) * 2.0 + 0.5
        target = self.aabb_min + jax.random.uniform(k2, (E, 3)) * (
            self.aabb_max - self.aabb_min
        )
        dirs = target - start
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)

        from ngp_tpu.ops.marching import ray_aabb_range

        tmin, tmax = ray_aabb_range(start, dirs, self.aabb_min, self.aabb_max)
        pos = start + dirs * (tmin[:, None] + 1e-6)

        out_pos = jnp.zeros((E, MAX_TRAIN_VERTICES, 3))
        out_den = jnp.zeros((E, MAX_TRAIN_VERTICES))
        cursor = jnp.zeros((E,), jnp.int32)
        throughput = jnp.ones((E,))
        alive = tmin <= tmax

        def body(it, carry):
            pos, dirs, cursor, out_pos, out_den, throughput, alive = carry
            kw = jax.random.fold_in(k3, it)
            u = jax.random.uniform(kw, (E,))
            pos, at_event, alive = self._jump(pos, dirs, alive, u)
            density = jnp.where(
                at_event, self._density_at(pos, jax.random.fold_in(kw, 1)), 0.0
            )

            record = at_event & (cursor < MAX_TRAIN_VERTICES)
            onehot = jax.nn.one_hot(cursor, MAX_TRAIN_VERTICES) * record[:, None]
            out_pos = out_pos + onehot[..., None] * pos[:, None, :]
            out_den = out_den + onehot * density[:, None]
            cursor = cursor + record.astype(jnp.int32)

            extinction = density / self.volume.global_majorant
            scatter_p = extinction * self.albedo
            z = jax.random.uniform(jax.random.fold_in(kw, 2), (E,))
            real = at_event & (z < extinction)
            scatter = real & (z < scatter_p)
            absorb = real & ~scatter
            nd = jax.random.normal(jax.random.fold_in(kw, 3), (E, 3))
            nd = nd / jnp.linalg.norm(nd, axis=-1, keepdims=True)
            new_dir = dirs * self.scattering + nd
            new_dir = new_dir / jnp.linalg.norm(new_dir, axis=-1, keepdims=True)
            dirs = jnp.where(scatter[:, None], new_dir, dirs)
            throughput = jnp.where(absorb, 0.0, throughput)
            alive = alive & ~absorb
            return pos, dirs, cursor, out_pos, out_den, throughput, alive

        pos, dirs, cursor, out_pos, out_den, throughput, alive = jax.lax.fori_loop(
            0, MAX_WALK_ITERS, body,
            (pos, dirs, cursor, out_pos, out_den, throughput, alive),
        )

        sky = proc_envmap(
            dirs,
            jnp.asarray(self.up_dir),
            jnp.asarray(self.sun_dir),
            jnp.asarray(self.sky_color),
        ) * throughput[:, None]

        valid = (
            jnp.arange(MAX_TRAIN_VERTICES)[None, :] < cursor[:, None]
        ).reshape(-1)
        positions = out_pos.reshape(-1, 3)
        targets = jnp.concatenate(
            [
                jnp.broadcast_to(sky[:, None, :], (E, MAX_TRAIN_VERTICES, 3)).reshape(-1, 3),
                out_den.reshape(-1, 1),
            ],
            axis=-1,
        )
        return positions, targets, valid

    # -- training

    def _train_step(self, state, key):
        E = self.batch_size // MAX_TRAIN_VERTICES
        pos, targets, valid = self.generate_training_data(key, E)

        def loss_of(params):
            pred = self.model(params, pos)
            per = self.trainer.loss_fn(targets, pred)
            per = per * valid[:, None]
            return jnp.sum(per) / jnp.maximum(jnp.sum(valid), 1) / per.shape[-1]

        import optax

        from ngp_tpu.optim import ema_update
        from ngp_tpu.train import TrainState

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        updates, opt_state = self.trainer.tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        ema = ema_update(state.ema, params, self.trainer.ema_decay, state.step)
        return TrainState(state.step + 1, params, opt_state, ema), loss

    def train(self, state, n_steps: int, log_every: int = 0):
        fn = self._jit.get("train_step")
        if fn is None:
            fn = jax.jit(self._train_step, donate_argnums=0)
            self._jit["train_step"] = fn
        import time as _time

        from ngp_tpu.utils.meters import TrainMeters

        if not hasattr(self, "meters") or self.meters is None:
            self.meters = TrainMeters()
        key = jax.random.PRNGKey(self.seed ^ 0x701)
        loss = None
        step0 = int(state.step)
        t0 = _time.monotonic()
        for step in range(step0, step0 + n_steps):
            state, loss = fn(state, jax.random.fold_in(key, step))
            if log_every and step % log_every == 0:
                print(f"volume step {step}: loss={float(loss):.5f}")
        if loss is not None and n_steps > 0:
            self.meters.update_loss(float(loss))  # one sync per call
            self.meters.update_window(
                n_steps, float(self.batch_size) * n_steps, 0.0,
                _time.monotonic() - t0,
            )
        return state, loss

    # -- rendering

    def _render_rays(self, params, origins, dirs, key, gt: bool):
        from ngp_tpu.ops.marching import ray_aabb_range

        B = origins.shape[0]
        tmin, tmax = ray_aabb_range(origins, dirs, self.aabb_min, self.aabb_max)
        pos = origins + dirs * (tmin[:, None] + 1e-6)
        alive = tmin <= tmax
        col = jnp.zeros((B, 3))
        opa = jnp.zeros((B,))

        def body(it, carry):
            pos, col, opa, alive = carry
            kw = jax.random.fold_in(key, it)
            u = jax.random.uniform(kw, (B,))
            pos, at_event, alive = self._jump(pos, dirs, alive, u)
            if gt:
                density = self._density_at(pos, jax.random.fold_in(kw, 1))
                rgb = jnp.broadcast_to(jnp.asarray([1.0, 1.0, 1.0]), pos.shape)
            else:
                out = self.model(params, pos)
                rgb, density = out[:, :3], out[:, 3]
            ext = jnp.clip(density / self.volume.global_majorant, 0.0, 1.0)
            T = 1.0 - opa
            a = jnp.where(at_event, ext * T, 0.0)
            col = col + rgb * a[:, None]
            opa = opa + a
            alive = alive & (opa <= 0.99)
            return pos, col, opa, alive

        pos, col, opa, alive = jax.lax.fori_loop(
            0, MAX_WALK_ITERS, body, (pos, col, opa, alive)
        )
        sky = proc_envmap(
            dirs,
            jnp.asarray(self.up_dir),
            jnp.asarray(self.sun_dir),
            jnp.asarray(self.sky_color),
        )
        col = col + (1.0 - opa)[:, None] * sky
        return col, opa

    def render_rays(self, state, origins, dirs, gt: bool = False, key=None):
        key = key if key is not None else jax.random.PRNGKey(7)
        fn = self._jit.get(("render", gt))
        if fn is None:
            fn = jax.jit(lambda p, o, d, k: self._render_rays(p, o, d, k, gt))
            self._jit[("render", gt)] = fn
        return fn(self.trainer.inference_params(state), origins, dirs, key)

    def render_image(self, state, eye, lookat, resolution=(128, 128), fov_deg=45.0, gt=False):
        W, H = resolution
        eye = np.asarray(eye, np.float32)
        fwd = np.asarray(lookat, np.float32) - eye
        fwd /= np.linalg.norm(fwd)
        up = np.asarray([0, 1, 0], np.float32)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        f = 0.5 / math.tan(0.5 * math.radians(fov_deg))
        xs = (np.arange(W) + 0.5) / W - 0.5
        ys = (np.arange(H) + 0.5) / H - 0.5
        px, py = np.meshgrid(xs, ys)
        d = (px[..., None] * right + py[..., None] * down + f * fwd).reshape(-1, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(eye, d.shape).astype(np.float32)
        col, opa = self.render_rays(state, jnp.asarray(o), jnp.asarray(d.astype(np.float32)), gt)
        return np.asarray(col).reshape(H, W, 3), np.asarray(opa).reshape(H, W)

    # -- snapshots

    def save_snapshot(self, path: str, state: TrainState):
        from ngp_tpu.utils.snapshot import save_snapshot

        save_snapshot(
            path,
            {
                "mode": "volume",
                "network_config": self.config,
                "snapshot": {
                    "training_step": np.asarray(state.step),
                    "params": jax.tree.map(np.asarray, state.params),
                    "ema_params": jax.tree.map(np.asarray, state.ema.params),
                    "global_majorant": self.volume.global_majorant,
                },
            },
        )

    def load_snapshot(self, path: str):
        from ngp_tpu.optim import EmaState
        from ngp_tpu.utils.snapshot import load_snapshot

        snap = load_snapshot(path)["snapshot"]
        params = jax.tree.map(jnp.asarray, snap["params"])
        return TrainState(
            step=jnp.asarray(snap["training_step"], jnp.int32),
            params=params,
            opt_state=self.trainer.tx.init(params),
            ema=EmaState(jax.tree.map(jnp.asarray, snap["ema_params"])),
        )

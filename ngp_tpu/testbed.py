"""Unified Testbed orchestrator — the counterpart of the reference's
``Testbed`` class and the ``pyngp`` Python API surface
(``src/testbed.cu``, ``src/python_api.cu:266-696``).

Mode is detected from the scene path like ``mode_from_scene``
(``src/common.cu:144-173``): directory or ``transforms.json`` → NeRF,
``.obj``/``.stl`` → SDF, ``.nvdb``/``.npy`` → Volume, image files → Image.
The heavy lifting lives in the per-mode engines; this class provides the
single programmatic entry point: load data, train, render, evaluate,
snapshot, export meshes.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ngp_tpu.config import load_config

MODES = ("nerf", "sdf", "image", "volume")

_DEFAULT_CONFIGS = {
    "nerf": {
        "loss": {"otype": "Huber"},
        "optimizer": {
            "otype": "Ema", "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 20000,
                "decay_interval": 10000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 1},
        "dir_encoding": {"otype": "Composite", "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity"},
        ]},
        "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": 64,
                        "n_hidden_layers": 2},
    },
    "sdf": {
        "loss": {"otype": "MAPE"},
        "optimizer": {
            "otype": "Ema", "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 10000,
                "decay_interval": 5000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-4, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
    },
    "image": {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {
            "otype": "Ema", "decay": 0.99,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 10000,
                "decay_interval": 5000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-8, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 24,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
    },
    "volume": {
        "loss": {"otype": "L2"},
        "optimizer": {
            "otype": "Ema", "decay": 0.95,
            "nested": {
                "otype": "ExponentialDecay", "decay_start": 10000,
                "decay_interval": 5000, "decay_base": 0.33,
                "nested": {"otype": "Adam", "learning_rate": 1e-4, "beta1": 0.9,
                           "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
            },
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "ReLU", "n_neurons": 64,
                    "n_hidden_layers": 2},
    },
}


def mode_from_scene(path: str) -> str | None:
    """``mode_from_scene`` (``src/common.cu:144-173``)."""
    if os.path.isdir(path):
        return "nerf"
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "json":
        return "nerf"
    if ext in ("obj", "stl"):
        return "sdf"
    if ext in ("nvdb", "npy"):
        return "volume"
    if ext in ("exr", "bin", "png", "jpg", "jpeg", "bmp", "tga", "hdr"):
        return "image"
    return None


def default_config(mode: str) -> dict:
    import copy

    return copy.deepcopy(_DEFAULT_CONFIGS[mode])


class Testbed:
    """``Testbed(mode=None, scene=None, config=None, **engine_kwargs)``.

    Properties/methods mirror the pyngp surface: ``load_training_data``,
    ``reload_network_from_json``, ``train``, ``render``, ``save_snapshot``
    / ``load_snapshot``, ``compute_marching_cubes_mesh``,
    ``calculate_iou``, ``compute_image_mse``, ``training_step``, ``loss``.
    """

    def __init__(self, mode: str | None = None, scene: str | None = None,
                 config: str | dict | None = None, **engine_kwargs):
        self.mode = mode
        self.engine: Any = None
        self.state = None
        self.grid = None  # NeRF occupancy state
        self.loss = float("nan")
        self._engine_kwargs = engine_kwargs
        self.network_config: dict | None = None
        if config is not None:
            self.reload_network_from_json(config, rebuild=False)
        if scene is not None:
            self.load_training_data(scene)

    # -- data / config loading

    def load_training_data(self, path: str) -> None:
        mode = self.mode or mode_from_scene(path)
        if mode is None:
            raise ValueError(f"cannot infer mode from scene path {path!r}")
        self.mode = mode
        self.scene = path
        cfg = self.network_config or default_config(mode)
        self.network_config = cfg
        self._build_engine(cfg)

    def reload_network_from_json(self, config: str | dict, rebuild: bool = True) -> None:
        if isinstance(config, str):
            config = load_config(config)
        self.network_config = config
        if rebuild and self.mode is not None and getattr(self, "scene", None):
            self._build_engine(config)

    def _nerf_geometry_prior(self, ds):
        """The fork's geometry-seeded occupancy: next to the dataset, a
        ``<name>.obj`` mesh or ``<name>.xyz`` point cloud pre-seeds the
        density grid (``Testbed::load_nerf``,
        ``src/testbed_nerf.cu:3115-3159``). Returns a (C, G, G, G) prior or
        None."""
        import numpy as np

        from ngp_tpu.ops import occupancy as occ

        scene = self.scene
        base = scene if os.path.isdir(scene) else os.path.dirname(scene)
        name = os.path.basename(os.path.normpath(base))
        eng = self.engine
        obj = os.path.join(base, name + ".obj")
        xyz = os.path.join(base, name + ".xyz")
        if os.path.exists(obj):
            from ngp_tpu.geometry.mesh import load_mesh_file

            tris = load_mesh_file(obj)  # (T, 3, 3) raw
            # raw -> NGP space: the fork cycles axes (x,y,z)->(-z,y,x) then
            # scale/offset (load_mesh_for_density_grid,
            # src/testbed_nerf.cu:3205-3212)
            v = tris.reshape(-1, 3)
            v = np.stack([-v[:, 2], v[:, 1], v[:, 0]], -1)
            v = ds.scale * v + np.asarray(ds.offset, np.float32)
            return occ.seed_grid_from_mesh(eng.grid_cfg, v.reshape(-1, 3, 3))
        if os.path.exists(xyz):
            from ngp_tpu.geometry.mesh import load_xyz

            pts = load_xyz(xyz)
            # scale/offset then cycle x<-y<-z (build_density_grid_from_
            # point_cloud, src/testbed_nerf.cu:3322-3327)
            pts = ds.scale * pts + np.asarray(ds.offset, np.float32)
            pts = pts[:, [1, 2, 0]]
            return occ.seed_grid_from_point_cloud(eng.grid_cfg, pts)
        return None

    def _build_engine(self, cfg: dict) -> None:
        import copy
        import dataclasses

        cfg = copy.deepcopy(cfg)

        def fields_of(engine_cls):
            return {f.name for f in dataclasses.fields(engine_cls)}

        kw = self._engine_kwargs
        if self.mode == "nerf":
            from ngp_tpu.data.nerf_loader import load_nerf
            from ngp_tpu.engines.nerf import NerfEngine

            ds = load_nerf(self.scene)
            # frame_subset: train on a subset of views (holdout eval)
            subset = kw.get("frame_subset")
            if subset is not None:
                ds = ds.subset(subset)
            self.engine = NerfEngine(
                cfg, ds, **{k: v for k, v in kw.items() if k in fields_of(NerfEngine)}
            )
            self.state = self.engine.init_state()
            self.grid = self.engine.init_grid(
                precomputed_density=self._nerf_geometry_prior(ds)
            )
        elif self.mode == "sdf":
            from ngp_tpu.engines.sdf import SdfEngine

            self.engine = SdfEngine.from_file(
                cfg, self.scene,
                **{k: v for k, v in kw.items() if k in fields_of(SdfEngine)},
            )
            self.state = self.engine.init_state()
        elif self.mode == "volume":
            from ngp_tpu.data.volume import load_volume
            from ngp_tpu.engines.volume import VolumeEngine

            self.engine = VolumeEngine(
                cfg, load_volume(self.scene),
                **{k: v for k, v in kw.items() if k in fields_of(VolumeEngine)},
            )
            self.state = self.engine.init_state()
        elif self.mode == "image":
            from ngp_tpu.data.image_loader import load_image
            from ngp_tpu.engines.image import ImageEngine

            img = load_image(self.scene)
            self.engine = ImageEngine(
                cfg, img, **{k: v for k, v in kw.items() if k in fields_of(ImageEngine)}
            )
            self.state = self.engine.init_state()
        else:
            raise ValueError(f"unknown mode {self.mode!r}")

    # -- training

    @property
    def training_step(self) -> int:
        return int(self.state.step) if self.state is not None else 0

    def train(self, n_steps: int) -> None:
        if self.mode == "nerf":
            self.state, self.grid, metrics = self.engine.train(
                self.state, self.grid, n_steps
            )
            self.loss = float(metrics["loss"])
        elif self.mode == "image":
            self.state, losses = self.engine.train(self.state, n_steps)
            self.loss = float(losses[-1])
        else:
            self.state, loss = self.engine.train(self.state, n_steps)
            self.loss = float(loss)

    # -- interactive heartbeat (Testbed::frame / train_and_render,
    #    testbed.cu:3595-3759; dynamic resolution 3010-3089)

    def frame(self, width: int = 512, height: int = 512,
              target_fps: float = 20.0, n_train_steps: int = 16,
              render: bool = True, **render_kw) -> dict:
        """One headless heartbeat: a training chunk plus a render at
        dynamic resolution targeting ``target_fps`` (the reference's
        ``m_dynamic_res_target_fps``, ``testbed.h:578``).

        Difference from the reference's continuous resolution
        scale: the scale factor is quantized to powers of two, so each
        resolution bucket is one compiled program — a continuously varying
        render shape would recompile every frame. Returns a dict with the
        image (when rendered), the resolution used, per-phase times, and
        the loss EMA — everything the reference's GUI overlay reads.
        """
        import time as _time

        t0 = _time.monotonic()
        train_ms = render_ms = 0.0
        if (getattr(self, "shall_train", True) and self.state is not None
                and n_train_steps > 0):
            ts = _time.monotonic()
            self.train(n_train_steps)
            train_ms = (_time.monotonic() - ts) * 1e3

        img, res = None, (0, 0)
        if render:
            if not hasattr(self, "_dyn_res_log2"):
                self._dyn_res_log2 = 2  # start at 1/4 res like a cold GUI
            f = 1 << self._dyn_res_log2
            w = max(width // f, 32)
            h = max(height // f, 32)
            rs = _time.monotonic()
            img = self.render(w, h, **render_kw)
            render_ms = (_time.monotonic() - rs) * 1e3
            res = (w, h)
            # adapt: a bucket step is a 4× pixel-count change, so switch
            # only past a 4× margin (hysteresis keeps buckets stable)
            budget_ms = 1000.0 / max(target_fps, 1e-3)
            if render_ms > 2.0 * budget_ms and (w > 32 or h > 32):
                self._dyn_res_log2 += 1
            elif render_ms < 0.25 * budget_ms and self._dyn_res_log2 > 0:
                self._dyn_res_log2 -= 1

        frame_ms = (_time.monotonic() - t0) * 1e3
        if not hasattr(self, "_frame_meters"):
            from ngp_tpu.utils.meters import Ema

            self._frame_meters = {
                "frame_ms": Ema(0.5), "train_ms": Ema(0.5),
                "render_ms": Ema(0.5),
            }
        for k, v in (("frame_ms", frame_ms), ("train_ms", train_ms),
                     ("render_ms", render_ms)):
            self._frame_meters[k].update(v)
        loss_ema = None
        m = getattr(self.engine, "meters", None)
        if m is not None:
            loss_ema = m.loss_ema
        return {
            "image": img, "resolution": res, "frame_ms": frame_ms,
            "train_ms": train_ms, "render_ms": render_ms,
            "frame_ms_ema": self._frame_meters["frame_ms"].value,
            "training_step": self.training_step, "loss": self.loss,
            "loss_ema": loss_ema,
        }

    # -- dynamic dataset building (pyngp nerf.training surface,
    #    python_api.cu:set_camera_extrinsics/set_camera_intrinsics/set_image)

    @property
    def n_images(self) -> int:
        assert self.mode == "nerf"
        return int(self.engine.data.images.shape[0])

    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True) -> None:
        """Overwrite one training camera's pose. ``camera_to_world`` (3,4)
        or (4,4); ``convert_to_ngp`` applies the dataset's nerf→ngp
        transform (scale 0.33/offset/yzx cycle) like the reference
        (``python_api.cu`` → ``NerfDataset::nerf_matrix_to_ngp``)."""
        assert self.mode == "nerf"
        import jax.numpy as jnp

        from ngp_tpu.data.nerf_loader import nerf_matrix_to_ngp

        m = np.asarray(camera_to_world, np.float32)[:3, :4]
        ds = self.engine.dataset
        if convert_to_ngp:
            m = nerf_matrix_to_ngp(m, ds.scale, np.asarray(ds.offset))
        data = self.engine.data
        self.engine.data = data._replace(
            xforms=data.xforms.at[frame_idx].set(jnp.asarray(m))
        )

    def get_camera_extrinsics(self, frame_idx: int,
                              convert_to_nerf: bool = True) -> np.ndarray:
        assert self.mode == "nerf"
        from ngp_tpu.data.nerf_loader import ngp_matrix_to_nerf

        m = np.asarray(self.engine.data.xforms[frame_idx])
        ds = self.engine.dataset
        if convert_to_nerf:
            m = ngp_matrix_to_nerf(m, ds.scale, np.asarray(ds.offset))
        return m

    def set_camera_intrinsics(self, frame_idx: int, fx: float | None = None,
                              fy: float | None = None, cx: float | None = None,
                              cy: float | None = None) -> None:
        """Overwrite one training camera's focal/principal point (pixels)."""
        assert self.mode == "nerf"
        import jax.numpy as jnp

        data = self.engine.data
        W, H = self.engine.resolution
        f = np.array(data.focals[frame_idx], np.float32)
        p = np.array(data.pps[frame_idx], np.float32)
        if fx is not None:
            f[0] = fx
        if fy is not None:
            f[1] = fy
        if cx is not None:
            p[0] = cx / W
        if cy is not None:
            p[1] = cy / H
        self.engine.data = data._replace(
            focals=data.focals.at[frame_idx].set(jnp.asarray(f)),
            pps=data.pps.at[frame_idx].set(jnp.asarray(p)),
        )

    def set_image(self, frame_idx: int, img: np.ndarray,
                  depth: np.ndarray | None = None) -> None:
        """Replace one training image ((H, W, 3|4), float [0,1] or uint8)
        and optionally its depth map — ``pyngp``'s dynamic dataset path."""
        assert self.mode == "nerf"
        import jax.numpy as jnp

        data = self.engine.data
        img = np.asarray(img)
        if img.shape[-1] == 3:
            alpha = np.ones_like(img[..., :1])
            if img.dtype == np.uint8:
                alpha = np.full_like(img[..., :1], 255)
            img = np.concatenate([img, alpha], -1)
        if data.images.dtype == jnp.uint8 and img.dtype != np.uint8:
            img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        new = data._replace(images=data.images.at[frame_idx].set(jnp.asarray(img)))
        if depth is not None and data.depths is not None:
            new = new._replace(
                depths=data.depths.at[frame_idx].set(jnp.asarray(depth))
            )
        self.engine.data = new

    def override_sdf_training_data(self, points: np.ndarray,
                                   distances: np.ndarray) -> None:
        """Train the SDF on user-provided (points, distances) instead of
        BVH-generated samples (``python_api.cu:69-99``)."""
        assert self.mode == "sdf"
        import jax.numpy as jnp

        self.engine.override_training_data = (
            jnp.asarray(points, jnp.float32),
            jnp.asarray(distances, jnp.float32),
        )

    # -- rendering

    def render(self, width: int, height: int, spp: int = 1,
               camera_matrix=None, eye=None, lookat=None, fov_deg: float = 50.0,
               training_view: int | None = None, start_matrix=None,
               end_matrix=None, shutter_fraction: float = 0.0) -> np.ndarray:
        """Render an image as (H, W, 3) float32 — ``pyngp.Testbed.render``."""
        if self.mode == "nerf":
            if training_view is not None:
                img = self.engine.render_image(self.state, self.grid, training_view)
                return np.asarray(img)
            if camera_matrix is None:
                camera_matrix = (
                    start_matrix
                    if start_matrix is not None
                    else np.asarray(self.engine.data.xforms[0])
                )
            import jax.numpy as jnp

            W, H = width, height
            f = 0.5 * H / np.tan(0.5 * np.radians(fov_deg))
            xs = (np.arange(W) + 0.5) / W
            ys = (np.arange(H) + 0.5) / H
            px, py = np.meshgrid(xs, ys)
            x = (px - 0.5) * W / f
            y = (py - 0.5) * H / f
            dc = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)
            m = np.asarray(camera_matrix, np.float32)[:3, :4]
            if end_matrix is not None:
                # Rolling-shutter camera lerp per pixel row between the
                # start and end poses (pyngp render's start/end/shutter
                # args; camera slerp like get_xform_given_rolling_shutter).
                from ngp_tpu.engines.nerf import _lerp_xforms

                me = np.asarray(end_matrix, np.float32)[:3, :4]
                tpix = jnp.asarray(
                    (py.reshape(-1) * float(shutter_fraction)).astype(np.float32)
                )
                n = dc.shape[0]
                xf = _lerp_xforms(
                    jnp.broadcast_to(jnp.asarray(m), (n, 3, 4)),
                    jnp.broadcast_to(jnp.asarray(me), (n, 3, 4)),
                    tpix,
                )
                from ngp_tpu.geometry.camera import matvec

                d = matvec(xf[:, :, :3], jnp.asarray(dc, jnp.float32))
                d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
                o = xf[:, :, 3]
            else:
                d = dc @ m[:, :3].T
                d /= np.linalg.norm(d, axis=-1, keepdims=True)
                o = np.broadcast_to(m[:, 3], d.shape)
                o = jnp.asarray(o.astype(np.float32))
                d = jnp.asarray(d.astype(np.float32))
            rgb, _, _ = self.engine.render_rays(self.state, self.grid, o, d)
            return np.asarray(rgb).reshape(H, W, 3)
        if self.mode == "sdf":
            eye = eye if eye is not None else [0.5, 0.5, 2.0]
            lookat = lookat if lookat is not None else [0.5, 0.5, 0.5]
            img, _ = self.engine.render_image(
                self.state, eye, lookat, resolution=(width, height), fov_deg=fov_deg
            )
            return img
        if self.mode == "volume":
            eye = eye if eye is not None else [0.5, 0.5, 2.2]
            lookat = lookat if lookat is not None else [0.5, 0.5, 0.5]
            img, _ = self.engine.render_image(
                self.state, eye, lookat, resolution=(width, height), fov_deg=fov_deg
            )
            return img
        if self.mode == "image":
            return np.asarray(self.engine.render(self.state, width, height))
        raise ValueError(self.mode)

    # -- render crop box (pyngp render_aabb / the GUI crop gizmo)

    @property
    def render_aabb(self):
        """(min, max) crop box in NGP space, or None for the scene AABB
        (``m_render_aabb``; pyngp ``render_aabb`` property)."""
        assert self.mode == "nerf"
        return self.engine.render_aabb

    @render_aabb.setter
    def render_aabb(self, box) -> None:
        assert self.mode == "nerf"
        if box is None:
            self.engine.render_aabb = None
        else:
            mn, mx = box
            self.engine.render_aabb = (
                np.asarray(mn, np.float32), np.asarray(mx, np.float32)
            )

    # -- evaluation

    def psnr(self, view: int = 0, stride: int = 1) -> float:
        assert self.mode == "nerf"
        return self.engine.psnr(self.state, self.grid, view, stride)

    def calculate_iou(self, n_samples: int = 1 << 17) -> float:
        assert self.mode == "sdf"
        return self.engine.calculate_iou(self.state, n_samples)

    def compute_image_mse(self) -> float:
        assert self.mode == "image"
        return float(self.engine.compute_mse(self.state))

    # -- products

    def compute_marching_cubes_mesh(self, resolution: int = 256, thresh: float = 2.5):
        if self.mode == "nerf":
            return self.engine.compute_marching_cubes_mesh(
                self.state, resolution, thresh
            )
        if self.mode == "sdf":
            return self.engine.compute_marching_cubes_mesh(self.state, resolution)
        raise ValueError("mesh export needs nerf or sdf mode")

    def save_snapshot(self, path: str) -> None:
        if self.mode == "nerf":
            self.engine.save_snapshot(path, self.state, self.grid)
        else:
            self.engine.save_snapshot(path, self.state)

    def load_snapshot(self, path: str) -> None:
        if self.mode == "nerf":
            self.state, self.grid = self.engine.load_snapshot(path)
        else:
            self.state = self.engine.load_snapshot(path)

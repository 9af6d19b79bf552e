"""NeRF dataset loading: ``transforms.json`` in the NGP dialect.

Reproduces the reference loader's semantics (``src/nerf_loader.cu:259-730``):

* scene scale default 0.33 and offset (0.5,0.5,0.5) — the "fit the unit cube"
  convention (``nerf_loader.h:27``, ``nerf_loader.cu:388-389``);
* axis conversion NeRF→NGP: negate the Y/Z basis columns and cycle rows
  xyz←yzx (``nerf_loader.h:120-140``);
* intrinsics from ``fl_x``/``camera_angle_x``/``x_fov`` (+ _y variants),
  principal point ``cx``/``cy``, OpenCV ``k1,k2,p1,p2`` or fisheye ``k1..k4``;
* ``aabb_scale`` (power of two ≤ 128), ``scale``, ``offset``, ``aabb``,
  ``up``, ``n_extra_learnable_dims``, ``sharpness`` frame culling;
* per-frame ``transform_matrix`` (optionally ``_start``/``_end`` for rolling
  shutter / motion blur).

Images load in a thread pool and are kept as uint8 sRGB (+alpha) host
arrays; conversion to linear happens on-device at sample time (the device has
bandwidth to spare for that and it keeps HBM footprint 4x smaller).
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ngp_tpu.geometry.camera import (
    LENS_OPENCV,
    LENS_OPENCV_FISHEYE,
    LENS_PINHOLE,
    Lens,
)

NERF_SCALE = 0.33  # nerf_loader.h:27


def nerf_matrix_to_ngp(m: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    """(3,4) NeRF camera-to-world → NGP convention (nerf_loader.h:120-140)."""
    out = m.astype(np.float32).copy()
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    out[:, 3] = out[:, 3] * scale + offset
    # cycle rows: new row0 = old row1, row1 = old row2, row2 = old row0
    out = out[[1, 2, 0], :]
    return out


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray) -> np.ndarray:
    out = m.astype(np.float32).copy()
    out = out[[2, 0, 1], :]
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    out[:, 3] = (out[:, 3] - offset) / scale
    return out


@dataclass
class NerfDataset:
    """Host-side dataset; all images share a resolution (padded otherwise)."""

    images: np.ndarray  # (N, H, W, 4) uint8 sRGB+A  (or float16 if HDR)
    xforms: np.ndarray  # (N, 2, 3, 4) float32 — start/end camera matrices
    focal_lengths: np.ndarray  # (N, 2)
    principal_points: np.ndarray  # (N, 2)
    lens: Lens
    resolution: tuple  # (W, H)
    scale: float = NERF_SCALE
    offset: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    aabb_scale: int = 1
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    paths: list = field(default_factory=list)
    is_hdr: bool = False
    n_extra_learnable_dims: int = 0
    wants_importance_sampling: bool = True
    render_aabb: tuple | None = None  # ((3,), (3,)) in NGP space
    depths: np.ndarray | None = None  # (N, H, W) float32 — 0 where absent;
    # values are NGP-scale z-depths (raw * integer_depth_scale * scale),
    # matching set_training_image's depth_scale * scale
    # (src/nerf_loader.cu:711, copy_depth kernel :81-89)
    sharpness: np.ndarray | None = None
    rolling_shutter: tuple = (0.0, 0.0, 0.0, 0.0)  # (offset, sx, sy, duration)
    envmap: np.ndarray | None = None  # (He, We, 4) float32 latlong HDR
    rays: np.ndarray | None = None  # (N, H, W, 6) NGP-space per-pixel o+d
    # (light-field datasets, rays_<name>.dat — src/nerf_loader.cu:623-645)

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    def subset(self, indices) -> "NerfDataset":
        """A view of the dataset restricted to ``indices`` (train/holdout
        splits — the upstream workflow's separate test_transforms.json,
        without needing a second file)."""
        import dataclasses

        idx = np.asarray(indices, np.int64)
        return dataclasses.replace(
            self,
            images=self.images[idx],
            xforms=self.xforms[idx],
            focal_lengths=self.focal_lengths[idx],
            principal_points=self.principal_points[idx],
            paths=[self.paths[i] for i in idx] if self.paths else [],
            depths=self.depths[idx] if self.depths is not None else None,
            sharpness=(
                self.sharpness[idx] if self.sharpness is not None else None
            ),
            rays=self.rays[idx] if self.rays is not None else None,
        )

    def nerf_direction_to_ngp(self, d: np.ndarray) -> np.ndarray:
        return d[..., [1, 2, 0]]

    def nerf_position_to_ngp(self, p: np.ndarray) -> np.ndarray:
        return (p * self.scale + self.offset)[..., [1, 2, 0]]

    def ngp_position_to_nerf(self, p: np.ndarray) -> np.ndarray:
        return (p[..., [2, 0, 1]] - self.offset) / self.scale


def _resolve_path(base: str, rel: str) -> str:
    p = rel if os.path.isabs(rel) else os.path.join(base, rel)
    if os.path.exists(p):
        return p
    for ext in (".png", ".jpg", ".jpeg", ".exr"):
        if os.path.exists(p + ext):
            return p + ext
    return p


def _load_frame_image(path: str) -> np.ndarray:
    if path.lower().endswith(".exr"):
        from ngp_tpu.data.exr import read_exr

        img = read_exr(path)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        return img.astype(np.float16)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def _focal_from_json(j: dict, axis: str, res: float, other: float | None) -> float | None:
    if f"fl_{axis}" in j:
        return float(j[f"fl_{axis}"])
    if f"camera_angle_{axis}" in j:
        return 0.5 * res / math.tan(0.5 * float(j[f"camera_angle_{axis}"]))
    if f"{axis}_fov" in j:
        return 0.5 * res / math.tan(0.5 * math.radians(float(j[f"{axis}_fov"])))
    return other


def load_nerf(path: str, sharpen: float = 0.0) -> NerfDataset:
    """Load a dataset given a ``transforms.json`` path or a directory
    containing json files (the reference unions several jsons; we support a
    list too)."""
    if os.path.isdir(path):
        jsons = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".json")
        )
        if not jsons:
            raise FileNotFoundError(f"no transforms json in {path}")
    else:
        jsons = [path]

    frames_all, base_paths = [], []
    top = None
    for jp in jsons:
        with open(jp) as f:
            j = json.load(f)
        if top is None:
            top = j
        base = os.path.dirname(jp)
        frames = j.get("frames", [])
        # sharpness culling (nerf_loader.cu:335-372): drop frames whose
        # sharpness is below threshold * mean of a sliding window
        thresh = float(j.get("sharpness_discard_threshold", 0.0))
        if frames and "sharpness" in frames[0] and thresh > 0:
            sh = np.array([float(fr.get("sharpness", 1.0)) for fr in frames])
            keep = []
            n = len(frames)
            for i, fr in enumerate(frames):
                lo, hi = max(0, i - 10), min(n, i + 10)
                if sh[i] > thresh * sh[lo:hi].mean():
                    keep.append(fr)
            frames = keep
        for fr in frames:
            # Skip frames whose image is missing, like the reference
            # (nerf_loader.cu:365 requires resolve_path(...).exists()).
            if os.path.exists(_resolve_path(base, fr["file_path"])):
                frames_all.append((j, base, fr))

    assert top is not None
    scale = float(top.get("scale", NERF_SCALE))
    offset = np.asarray(top.get("offset", [0.5, 0.5, 0.5]), np.float32)
    if offset.ndim == 0:
        offset = np.full(3, float(offset), np.float32)
    aabb_scale = int(top.get("aabb_scale", 1))
    # Fail at load time like load_nerf_post (testbed_nerf.cu:3080-3092).
    if aabb_scale < 1 or aabb_scale & (aabb_scale - 1):
        raise ValueError(
            f"NeRF dataset's `aabb_scale` must be a power of two, but is "
            f"{aabb_scale}."
        )
    if aabb_scale > 128:
        raise ValueError(
            f"NeRF dataset must have `aabb_scale <= 128`, but is {aabb_scale}."
        )
    if "aabb" in top:
        # Fit the given aabb into the unit cube (nerf_loader.cu:489-494).
        aabb = np.asarray(top["aabb"], np.float32)
        length = max(1e-6, float(np.abs(aabb[1] - aabb[0]).max()))
        scale = 1.0 / length
        offset = ((aabb[1] + aabb[0]) * 0.5) * -scale + 0.5

    # Load images in parallel.
    paths = [_resolve_path(base, fr["file_path"]) for (_, base, fr) in frames_all]
    with ThreadPoolExecutor(max_workers=16) as pool:
        images = list(pool.map(_load_frame_image, paths))

    H, W = images[0].shape[:2]
    for im in images:
        if im.shape[:2] != (H, W):
            raise NotImplementedError(
                "mixed image resolutions not supported yet (pad to max)"
            )
    is_hdr = images[0].dtype == np.float16
    images = np.stack(images)

    n = len(frames_all)
    xforms = np.zeros((n, 2, 3, 4), np.float32)
    focals = np.zeros((n, 2), np.float32)
    pps = np.zeros((n, 2), np.float32)
    lens_mode = LENS_PINHOLE
    lens_params = [0.0] * 7

    for i, (j, _base, fr) in enumerate(frames_all):
        def get(key, default=None):
            return fr.get(key, j.get(key, default))

        fx = _focal_from_json({**j, **fr}, "x", W, None)
        fy = _focal_from_json({**j, **fr}, "y", H, fx)
        if fx is None and fy is not None:
            fx = fy
        if fx is None:
            raise ValueError("no focal length in transforms.json")
        focals[i] = (fx, fy)
        pps[i] = (float(get("cx", W / 2)) / W, float(get("cy", H / 2)) / H)

        if any(get(k) for k in ("k1", "k2", "p1", "p2", "k3", "k4")):
            if get("is_fisheye", False):
                lens_mode = LENS_OPENCV_FISHEYE
                lens_params = [
                    float(get("k1", 0)), float(get("k2", 0)),
                    float(get("k3", 0)), float(get("k4", 0)), 0.0, 0.0, 0.0,
                ]
            else:
                lens_mode = LENS_OPENCV
                lens_params = [
                    float(get("k1", 0)), float(get("k2", 0)),
                    float(get("p1", 0)), float(get("p2", 0)), 0.0, 0.0, 0.0,
                ]

        def mat(key):
            m = np.asarray(fr[key], np.float32)
            return m[:3, :4]

        if "transform_matrix_start" in fr:
            ms, me = mat("transform_matrix_start"), mat("transform_matrix_end")
        else:
            ms = me = mat("transform_matrix")
        xforms[i, 0] = nerf_matrix_to_ngp(ms, scale, offset)
        xforms[i, 1] = nerf_matrix_to_ngp(me, scale, offset)

    render_aabb = None
    if "render_aabb" in top:
        ra = np.asarray(top["render_aabb"], np.float32)
        render_aabb = (ra[0] * scale + offset, ra[1] * scale + offset)

    up = np.asarray(top.get("up", [0, 0, 1]), np.float32)
    up = up[[1, 2, 0]]  # nerf→ngp axis cycle (nerf_loader.cu:509-513)

    sharpness = None
    if frames_all and "sharpness" in frames_all[0][2]:
        sharpness = np.array(
            [float(fr.get("sharpness", 1.0)) for (_, _, fr) in frames_all],
            np.float32,
        )

    # Depth maps (16-bit pngs scaled by integer_depth_scale then scene
    # scale — src/nerf_loader.cu:471-472, 609-619, copy_depth :81-89).
    depths = None
    depth_scale = float(top.get("integer_depth_scale", -1.0))
    if depth_scale > 0 and bool(top.get("enable_depth_loading", True)):
        from PIL import Image

        maps = np.zeros((n, H, W), np.float32)
        any_depth = False
        for i, (j, base, fr) in enumerate(frames_all):
            if "depth_path" not in fr:
                continue
            dp = _resolve_path(base, fr["depth_path"])
            if not os.path.exists(dp):
                continue
            with Image.open(dp) as im:
                d = np.asarray(im, np.float32)
            if d.ndim == 3:
                d = d[..., 0]
            if d.shape != (H, W):
                raise ValueError(f"depth image {dp} has wrong resolution")
            maps[i] = d * depth_scale * scale
            any_depth = True
        if any_depth:
            depths = maps

    # Rolling shutter / motion blur (per-dataset vec4, lerping each frame's
    # transform_matrix_start/_end per ray — src/testbed_nerf.cu:2270-2273).
    rs = top.get("rolling_shutter", [0.0, 0.0, 0.0, 0.0])
    rolling_shutter = tuple(float(v) for v in (list(rs) + [0.0] * 4)[:4])

    # Sharpening (the "sharpen" key): a 5-point unsharp filter applied to
    # HDR training images at load, with the reference's exact weights and
    # flat-index edge handling (``sharpen`` kernel nerf_loader.cu:93-113,
    # center_w = 4 + 1/amount :977). The edge handling is deliberately
    # bug-compatible: the reference clamps up/left to flat index 0 but
    # WRAPS down/right modulo the image — kept verbatim for parity.
    sharpen_amount = float(top.get("sharpen", 0.0))
    if sharpen_amount > 0 and is_hdr:
        center_w = 4.0 + 1.0 / sharpen_amount
        inv_totalw = 1.0 / (center_w - 4.0)
        n_pix = H * W
        flat = images.reshape(n, n_pix, 4).astype(np.float32)
        idx = np.arange(n_pix)
        left = np.maximum(idx - 1, 0)
        up = np.maximum(idx - W, 0)
        right = np.where(idx + 1 >= n_pix, idx + 1 - n_pix, idx + 1)
        down = np.where(idx + W >= n_pix, idx + W - n_pix, idx + W)
        out = (
            flat * center_w
            - flat[:, left] - flat[:, up] - flat[:, right] - flat[:, down]
        ) * inv_totalw
        images = np.maximum(out, 0.0).reshape(images.shape).astype(images.dtype)

    # Per-pixel ray files: ``rays_<imagename>.dat`` next to each image —
    # n_pixels × (o vec3, d vec3) float32, light-field datasets
    # (src/nerf_loader.cu:623-645). Converted NeRF→NGP like
    # ``nerf_ray_to_ngp`` (nerf_loader.h:173-189): o·scale+offset, yzx
    # cycle on both o and d. Enabled only when every frame has one (the
    # reference keeps per-image nullptrs; batched arrays can't).
    rays = None
    if bool(top.get("enable_ray_loading", True)):
        ray_paths = []
        for j, base, fr in frames_all:
            img_path = _resolve_path(base, fr["file_path"])
            stem = os.path.splitext(os.path.basename(img_path))[0]
            rp = os.path.join(os.path.dirname(img_path), f"rays_{stem}.dat")
            ray_paths.append(rp if os.path.exists(rp) else None)
        if any(ray_paths) and all(ray_paths):
            rays = np.zeros((n, H, W, 6), np.float32)
            for i, rp in enumerate(ray_paths):
                raw = np.fromfile(rp, np.float32)
                if raw.size < H * W * 6:
                    raise ValueError(f"rays file {rp} too short")
                r = raw[: H * W * 6].reshape(H, W, 6)
                o = r[..., :3] * scale + offset
                rays[i, ..., :3] = o[..., [1, 2, 0]]
                rays[i, ..., 3:] = r[..., 3:][..., [1, 2, 0]]
        elif any(ray_paths):
            import warnings

            warnings.warn(
                "some frames have rays_*.dat files but not all — "
                "ignoring supplied rays"
            )

    # Environment map (latlong exr/image, src/nerf_loader.cu:516-528).
    envmap = None
    if "envmap" in top:
        ep = _resolve_path(os.path.dirname(jsons[0]), top["envmap"])
        if os.path.exists(ep):
            if ep.lower().endswith(".exr"):
                from ngp_tpu.data.exr import read_exr

                envmap = read_exr(ep).astype(np.float32)
            else:
                from PIL import Image

                with Image.open(ep) as im:
                    envmap = np.asarray(im.convert("RGBA"), np.float32) / 255.0
            if envmap.shape[-1] == 3:
                envmap = np.concatenate(
                    [envmap, np.ones_like(envmap[..., :1])], -1
                )

    return NerfDataset(
        images=images,
        xforms=xforms,
        focal_lengths=focals,
        principal_points=pps,
        lens=Lens(mode=lens_mode, params=tuple(lens_params)),
        resolution=(W, H),
        scale=scale,
        offset=offset,
        aabb_scale=aabb_scale,
        up=up,
        paths=paths,
        is_hdr=is_hdr,
        n_extra_learnable_dims=int(top.get("n_extra_learnable_dims", 0)),
        render_aabb=render_aabb,
        depths=depths,
        sharpness=sharpness,
        rolling_shutter=rolling_shutter,
        envmap=envmap,
        rays=rays,
    )

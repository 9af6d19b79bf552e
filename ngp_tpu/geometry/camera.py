"""Camera models and ray generation, batched over pixels.

Reproduces the reference's camera stack (``common_device.cuh:290-560``):
pinhole, OpenCV Brown and OpenCV-fisheye distortion with iterative
undistortion, F-theta, lat-long and equirectangular lenses, screen-center
offsets, aperture depth-of-field, and the NGP camera-matrix convention
(3x4, columns = [right, down?, forward, origin] — OpenGL-style with the
axis flips applied at dataset-load time).

All functions are pure and vmappable; undistortion is a fixed-count Newton
iteration with an autodiff Jacobian (the reference uses 100 numeric-diff
Newton steps; 10 analytic steps reach the same fixed point)."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Lens modes, mirroring ELensMode (common.h)
LENS_PINHOLE = 0
LENS_OPENCV = 1
LENS_OPENCV_FISHEYE = 2
LENS_FTHETA = 3
LENS_LATLONG = 4
LENS_EQUIRECT = 5


class Lens(NamedTuple):
    mode: int = LENS_PINHOLE
    params: tuple = (0.0,) * 7


class Camera(NamedTuple):
    """Static camera description for one image / render view."""

    resolution: tuple  # (W, H) python ints — static for XLA
    focal_length: jnp.ndarray  # (2,)
    principal_point: jnp.ndarray  # (2,) in uv units ("screen_center")
    lens: Lens = Lens()


def matvec(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``m @ v`` over the last axes (m (..., R, C), v (..., C)), as an
    elementwise multiply and sum: exact float32, where a GPU dot of
    float32 operands may run in TF32 (10 mantissa bits)."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def fov_to_focal_length(resolution_px: float, degrees: float) -> float:
    return 0.5 * resolution_px / np.tan(0.5 * np.radians(degrees))


def focal_length_to_fov(resolution_px: float, focal: float) -> float:
    return float(2.0 * np.degrees(np.arctan(0.5 * resolution_px / focal)))


def opencv_lens_distortion_delta(params, u, v):
    """Brown radial/tangential distortion delta (k1,k2,p1,p2) —
    ``opencv_lens_distortion_delta`` (common_device.cuh:290-303)."""
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
    return du, dv


def opencv_fisheye_lens_distortion_delta(params, u, v):
    k1, k2, k3, k4 = params[0], params[1], params[2], params[3]
    r = jnp.sqrt(u * u + v * v)
    safe_r = jnp.maximum(r, 1e-12)
    theta = jnp.arctan(safe_r)
    t2 = theta * theta
    thetad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = jnp.where(r > 1e-12, thetad / safe_r - 1.0, 0.0)
    return u * scale, v * scale


def iterative_undistortion(delta_fn, params, u, v, iters: int = 10):
    """Invert ``x ↦ x + delta(x)`` by Newton with an autodiff Jacobian."""
    x0 = jnp.stack([u, v], axis=-1)

    def residual(x):
        du, dv = delta_fn(params, x[..., 0], x[..., 1])
        return x + jnp.stack([du, dv], axis=-1) - x0

    def body(_, x):
        # Per-point 2x2 Newton step.
        r = residual(x)
        J = jax.vmap(jax.jacfwd(lambda p: p + jnp.stack(
            delta_fn(params, p[0], p[1]), axis=-1
        )))(x.reshape(-1, 2)).reshape(x.shape[:-1] + (2, 2))
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        inv = (
            jnp.stack(
                [
                    jnp.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                    jnp.stack([-J[..., 1, 0], J[..., 0, 0]], -1),
                ],
                -2,
            )
            / det[..., None, None]
        )
        step = matvec(inv, r)
        return x - step

    x = jax.lax.fori_loop(0, iters, body, x0)
    return x[..., 0], x[..., 1]


def latlong_to_dir(uv):
    theta = (uv[..., 1] - 0.5) * jnp.pi
    phi = (uv[..., 0] - 0.5) * 2.0 * jnp.pi
    ct, st = jnp.cos(theta), jnp.sin(theta)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    return jnp.stack([sp * ct, st, cp * ct], axis=-1)


def equirectangular_to_dir(uv):
    ct = (uv[..., 1] - 0.5) * 2.0
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = (uv[..., 0] - 0.5) * 2.0 * jnp.pi
    return jnp.stack([jnp.sin(phi) * st, ct, jnp.cos(phi) * st], axis=-1)


def f_theta_undistortion(uv_centered, params):
    """F-theta lens: polynomial angle model (r0..r4, resx, resy)."""
    xpix = uv_centered[..., 0] * params[5]
    ypix = uv_centered[..., 1] * params[6]
    norm = jnp.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[0] + norm * (
        params[1] + norm * (params[2] + norm * (params[3] + norm * params[4]))
    )
    sin_a, cos_a = jnp.sin(alpha), jnp.cos(alpha)
    safe = jnp.maximum(norm, 1e-12)
    return jnp.stack(
        [sin_a / safe * xpix, sin_a / safe * ypix, cos_a], axis=-1
    )


def square2disk_shirley(uv):
    """Shirley's concentric square→disk map, for aperture sampling."""
    a, b = uv[..., 0], uv[..., 1]
    cond = jnp.abs(a) > jnp.abs(b)
    r = jnp.where(cond, a, b)
    phi = jnp.where(
        cond,
        (jnp.pi / 4.0) * jnp.where(jnp.abs(a) > 1e-12, b / jnp.where(a == 0, 1.0, a), 0.0),
        (jnp.pi / 2.0)
        - (jnp.pi / 4.0) * jnp.where(jnp.abs(b) > 1e-12, a / jnp.where(b == 0, 1.0, b), 0.0),
    )
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def grid_at_lerp(grid: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear lookup of a (H, W, C) uv-grid at uv∈[0,1]², matching
    ``Buffer2DView::at_lerp`` (common.h:384-399): sample position is
    ``uv · resolution`` (no half-texel offset), corners clamped. Plain
    differentiable JAX — autodiff's transpose reproduces the reference's
    bilinear gradient deposit (``deposit_image_gradient``,
    common_device.cuh:124-156). Used for the trainable distortion map
    (``trainable_buffer.cuh``)."""
    H, W = grid.shape[:2]
    fx = uv[..., 0] * W
    fy = uv[..., 1] * H
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    def at(xi, yi):
        return grid[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]

    return (
        (1 - wx) * (1 - wy) * at(x0, y0)
        + wx * (1 - wy) * at(x0 + 1, y0)
        + (1 - wx) * wy * at(x0, y0 + 1)
        + wx * wy * at(x0 + 1, y0 + 1)
    )


def uv_to_ray(
    uv: jnp.ndarray,  # (..., 2)
    resolution,  # (W, H) static
    focal_length: jnp.ndarray,  # (2,)
    camera_matrix: jnp.ndarray,  # (..., 3, 4) or (3, 4): columns x,y,z,origin
    screen_center: jnp.ndarray,  # (2,)
    lens: Lens = Lens(),
    aperture_size: float = 0.0,
    focus_z: float = 1.0,
    aperture_uv: jnp.ndarray | None = None,  # (...,2) in [0,1), for DoF
    near_distance: float = 0.0,
    distortion_grid=None,  # optional callable uv -> (...,2) extra dir offset
):
    """Generate world-space rays from uv in [0,1]² — the JAX counterpart of
    ``uv_to_ray`` (common_device.cuh:443-510). Returns (origin, direction);
    direction is *not* normalized (z=1 in camera space), like the reference."""
    W, H = resolution
    params = jnp.asarray(lens.params, jnp.float32)
    if lens.mode == LENS_FTHETA:
        dir_cam = f_theta_undistortion(uv - screen_center, params)
    elif lens.mode == LENS_LATLONG:
        dir_cam = latlong_to_dir(uv)
    elif lens.mode == LENS_EQUIRECT:
        dir_cam = equirectangular_to_dir(uv)
    else:
        x = (uv[..., 0] - screen_center[0]) * W / focal_length[0]
        y = (uv[..., 1] - screen_center[1]) * H / focal_length[1]
        if lens.mode == LENS_OPENCV:
            x, y = iterative_undistortion(opencv_lens_distortion_delta, params, x, y)
        elif lens.mode == LENS_OPENCV_FISHEYE:
            x, y = iterative_undistortion(
                opencv_fisheye_lens_distortion_delta, params, x, y
            )
        dir_cam = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)

    if distortion_grid is not None:
        dir_cam = dir_cam.at[..., :2].add(distortion_grid(uv))

    rot = camera_matrix[..., :3, :3]
    origin = jnp.broadcast_to(
        camera_matrix[..., :3, 3], dir_cam.shape[:-1] + (3,)
    )
    direction = matvec(rot, dir_cam)

    if aperture_size > 0.0 and aperture_uv is not None:
        lookat = origin + direction * focus_z
        blur = aperture_size * square2disk_shirley(aperture_uv * 2.0 - 1.0)
        offset = matvec(rot[..., :, :2], blur)
        origin = origin + offset
        direction = (lookat - origin) / focus_z

    origin = origin + direction * near_distance
    return origin, direction


def pixel_to_uv(pixel_xy: jnp.ndarray, resolution, jitter: jnp.ndarray | None = None):
    """Pixel index → uv; with ``jitter=None`` snaps to pixel centers."""
    W, H = resolution
    off = 0.5 if jitter is None else jitter
    return (pixel_xy.astype(jnp.float32) + off) / jnp.asarray(
        [W, H], jnp.float32
    )


def camera_rays_for_image(
    camera: Camera,
    camera_matrix: jnp.ndarray,
    snap_to_pixel_centers: bool = True,
    key: jax.Array | None = None,
):
    """All rays for a full-resolution view: returns ((H, W, 3) origins,
    (H, W, 3) dirs)."""
    W, H = camera.resolution
    px = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    )
    jitter = None
    if not snap_to_pixel_centers and key is not None:
        jitter = jax.random.uniform(key, (H, W, 2))
    uv = pixel_to_uv(px, camera.resolution, jitter)
    return uv_to_ray(
        uv,
        camera.resolution,
        camera.focal_length,
        camera_matrix,
        camera.principal_point,
        camera.lens,
    )

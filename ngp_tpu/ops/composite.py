"""Volume compositing and the NeRF training loss, fully vectorized.

The reference computes per-ray compositing and hand-written gradients in one
CUDA kernel (``compute_loss_kernel_train_nerf``,
``src/testbed_nerf.cu:1660-2012``), using the "suffix trick" for
d(composite)/d(alpha). Here compositing is an exclusive cumprod over the
sample axis and JAX autodiff reproduces those gradients exactly (the suffix
trick *is* the transpose of cumprod-compositing); the explicit regularizer
gradients become explicit loss terms with matching derivatives.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


# --- Activations with the reference's clamping rules
# (``network_to_rgb`` / ``network_to_density``, ``testbed_nerf.cu:317-388``).


@jax.custom_jvp
def density_activation_exp(x):
    """Forward: exp clamped at e^30 (the reference leaves the fp32 exp
    unclamped — an overflow hazard its fp16 pipeline saturates away; e^30
    is opaque within 1e-13 of a step). Backward: derivative of exp clamped
    to e^±15 — the reference's asymmetric clamp."""
    return jnp.exp(jnp.minimum(x, 30.0))


@density_activation_exp.defjvp
def _density_exp_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    return jnp.exp(x), jnp.exp(jnp.clip(x, -15.0, 15.0)) * dx


def rgb_activation_exp(x):
    """exp clamped to ±10 in both forward and derivative."""
    return jnp.exp(jnp.clip(x, -10.0, 10.0))


_ACTIVATIONS_RGB = {
    "none": lambda x: x,
    "relu": jax.nn.relu,
    "logistic": jax.nn.sigmoid,
    "exponential": rgb_activation_exp,
}

_ACTIVATIONS_DENSITY = {
    "none": lambda x: x,
    "relu": jax.nn.relu,
    "logistic": jax.nn.sigmoid,
    "exponential": density_activation_exp,
}


def rgb_activation(name: str):
    return _ACTIVATIONS_RGB[name.lower()]


def density_activation(name: str):
    return _ACTIVATIONS_DENSITY[name.lower()]


class CompositedRays(NamedTuple):
    rgb: jax.Array  # (N, 3) accumulated color (no background)
    depth: jax.Array  # (N,) weighted depth
    opacity: jax.Array  # (N,) 1 - final transmittance
    transmittance: jax.Array  # (N,) T after the last used sample
    weights: jax.Array  # (N, K) per-sample compositing weights
    used: jax.Array  # (N, K) samples actually composited (T ≥ eps cut)


def composite(
    rgb_samples: jax.Array,  # (N, K, 3) activated colors
    sigma: jax.Array,  # (N, K) activated densities
    dt: jax.Array,  # (N, K)
    t_mid: jax.Array,  # (N, K) sample depths along the ray
    valid: jax.Array,  # (N, K) bool
    min_transmittance: float = 1e-4,
) -> CompositedRays:
    """Front-to-back alpha compositing: ``alpha = 1 - exp(-sigma·dt)``,
    ``T`` the exclusive product of ``1-alpha``; samples after ``T`` drops
    below ``min_transmittance`` are cut, matching the reference's early-out
    (``testbed_nerf.cu:1729-1731`` training, ``min_transmittance`` render)."""
    # Transmittance in log space: cumprod's VJP divides by its inputs, so a
    # saturated alpha (exactly 1 when σ·dt ≳ 17 in fp32) would NaN the
    # backward. log1p+cumsum+exp has no divisions; alpha is clamped a hair
    # below 1 so log1p stays finite (grad then cleanly multiplies by T=0).
    alpha = jnp.where(
        valid, jnp.clip(1.0 - jnp.exp(-sigma * dt), 0.0, 1.0 - 1e-7), 0.0
    )
    log_one_minus = jnp.log1p(-alpha)
    logT = jnp.concatenate(
        [jnp.zeros_like(alpha[:, :1]), jnp.cumsum(log_one_minus[:, :-1], axis=1)],
        axis=1,
    )
    T = jnp.exp(logT)
    used = valid & (T >= min_transmittance)
    w = jnp.where(used, alpha * T, 0.0)
    # elementwise + sum, not a dot: a float32 GPU dot may run in TF32
    rgb = jnp.sum(w[..., None] * rgb_samples, axis=1)
    depth = jnp.sum(w * t_mid, axis=1)
    T_final = jnp.exp(jnp.sum(jnp.where(used, log_one_minus, 0.0), axis=1))
    return CompositedRays(rgb, depth, 1.0 - T_final, T_final, w, used)


def nerf_training_loss(
    raw: jax.Array,  # (N, K, 4) raw network output [r, g, b, sigma]
    dt: jax.Array,  # (N, K)
    t_mid: jax.Array,  # (N, K)
    valid: jax.Array,  # (N, K)
    complete: jax.Array,  # (N,) add background iff ray marched to completion
    background: jax.Array,  # (N, 3) background color (loss color space)
    target: jax.Array,  # (N, 3) target color pre-composited over background
    loss_fn,
    rgb_act: str,
    density_act: str,
    mean_density: jax.Array,
    depth_sample: jax.Array | None = None,  # (N, K) distance for near-cam reg
    near_distance: float = 0.0,
    target_depth: jax.Array | None = None,  # (N,) GT ray distance, ≤0 = none
    depth_lambda: float = 0.0,
) -> tuple[jax.Array, dict]:
    """Scalar training loss whose gradient matches the reference kernel:

    * per-ray color loss summed over channels, averaged over rays
      (the reference scales gradients by ``1/n_rays`` and does *not*
      divide by 3 — ``testbed_nerf.cu:1903``);
    * rgb output L2 penalty ``max(0, 1e-4·raw)`` only for Exponential rgb
      activation (``output_l2_reg``);
    * density L1 bootstrap ``-1e-4`` per negative raw density while the
      grid's mean density is below the occupancy threshold
      (``output_l1_reg_density``);
    * near-camera density penalty ``+1e-4`` for samples closer than
      ``near_distance`` (``testbed_nerf.cu:1962-1966``).
    """
    n_rays = raw.shape[0]
    rgb = rgb_activation(rgb_act)(raw[..., :3])
    sigma = density_activation(density_act)(raw[..., 3])
    comp = composite(rgb, sigma, dt, t_mid, valid)

    add_bg = complete & (comp.transmittance > 0.0)
    rgb_ray = comp.rgb + jnp.where(add_bg, comp.transmittance, 0.0)[:, None] * background

    color_loss = jnp.sum(loss_fn(target, rgb_ray), axis=-1)  # (N,)
    loss = jnp.mean(color_loss)

    raw_sigma = raw[..., 3]
    used = comp.used

    if rgb_act.lower() == "exponential":
        reg = 0.5e-4 * jnp.sum(
            jnp.where(used[..., None], jax.nn.relu(raw[..., :3]) ** 2, 0.0)
        )
        loss = loss + reg / n_rays

    l1_active = mean_density < 0.01
    density_l1 = 1e-4 * jnp.sum(jnp.where(used, jax.nn.relu(-raw_sigma), 0.0))
    loss = loss + jnp.where(l1_active, density_l1, 0.0) / n_rays

    if depth_lambda > 0.0 and target_depth is not None:
        # Depth supervision (testbed_nerf.cu:1848-1856, 1953): L1 between
        # the composited ray depth and the GT distance, λ-scaled, only for
        # rays that have a depth record (target > 0). Autodiff through
        # comp.depth = Σ wᵢ·tᵢ reproduces the reference's analytic
        # density-channel term t·depth − depth_suffix exactly.
        has_d = target_depth > 0.0
        depth_err = jnp.abs(target_depth - comp.depth)
        loss = loss + depth_lambda * jnp.sum(
            jnp.where(has_d, depth_err, 0.0)
        ) / n_rays

    if near_distance > 0.0 and depth_sample is not None:
        near = used & (depth_sample < near_distance) & (raw_sigma > -10.0)
        loss = loss + 1e-4 * jnp.sum(
            jnp.where(near, raw_sigma, 0.0)
        ) / n_rays

    aux = {
        "loss_display": jnp.mean(color_loss) / 3.0,
        "per_ray_loss": jax.lax.stop_gradient(color_loss) / 3.0,
        "rgb_ray": rgb_ray,
        "depth_ray": comp.depth,
        "measured_samples": jnp.sum(used),
    }
    return loss, aux

"""Optimizer stacks: the JAX counterpart of tcnn's nested
``Ema{ExponentialDecay{Adam}}`` optimizers (reference ``configs/*/base.json``,
SURVEY.md §2.10).

Built on optax. Two reference-specific behaviors are reproduced:

* **Sparse-Adam for grid params**: the instant-ngp paper skips the Adam step
  for hash-table entries whose gradient is exactly zero (only a tiny fraction
  of the table is touched per batch). ``scale_by_adam_skip_zero`` implements
  this; it's applied to encoding tables, plain Adam to MLP weights.
* **L2 regularization on matrix params only**: tcnn's ``l2_reg`` applies to
  MLP weight matrices, not grid features.
* **EMA parameter averaging**: tcnn's ``Ema`` optimizer keeps an exponential
  moving average of the params and serves *those* as inference params. Here
  ``EmaState``/``ema_update`` maintain the averaged copy in the train state.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax


def exponential_decay_schedule(cfg: dict, base_lr: float) -> Callable:
    """tcnn ``ExponentialDecay``: lr is constant until ``decay_start``, then
    multiplied by ``decay_base`` every ``decay_interval`` steps (continuous
    exponent), clamped at ``decay_end`` if present."""
    decay_start = cfg.get("decay_start", 0)
    decay_interval = cfg.get("decay_interval", 10000)
    decay_base = cfg.get("decay_base", 1.0)
    decay_end = cfg.get("decay_end", None)

    def schedule(step):
        step = jnp.asarray(step, jnp.float32)
        t = jnp.maximum(step - decay_start, 0.0)
        if decay_end is not None:
            t = jnp.minimum(t, float(decay_end - decay_start))
        return base_lr * decay_base ** (t / decay_interval)

    return schedule


class _AdamSkipZeroState(NamedTuple):
    count: jax.Array
    mu: Any
    nu: Any


def scale_by_adam_skip_zero(
    b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15
) -> optax.GradientTransformation:
    """Adam whose moment/param updates are skipped where grad == 0 exactly
    (the hash-grid sparse-update rule from the instant-ngp paper §4)."""

    def init_fn(params):
        mu = jax.tree.map(jnp.zeros_like, params)
        nu = jax.tree.map(jnp.zeros_like, params)
        return _AdamSkipZeroState(jnp.zeros([], jnp.int32), mu, nu)

    def update_fn(updates, state, params=None):
        count = state.count + 1
        c = count.astype(jnp.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c

        mu = jax.tree.map(
            lambda g, m: jnp.where(g != 0.0, b1 * m + (1 - b1) * g, m),
            updates,
            state.mu,
        )
        nu = jax.tree.map(
            lambda g, v: jnp.where(g != 0.0, b2 * v + (1 - b2) * g * g, v),
            updates,
            state.nu,
        )
        steps = jax.tree.map(
            lambda g, m, v: jnp.where(
                g != 0.0, (m / bc1) / (jnp.sqrt(v / bc2) + eps), 0.0
            ),
            updates,
            mu,
            nu,
        )
        return steps, _AdamSkipZeroState(count, mu, nu)

    return optax.GradientTransformation(init_fn, update_fn)


def _unwrap_ema(opt_cfg: dict) -> tuple[dict, float | None]:
    """Peel tcnn's outermost ``Ema`` wrapper; returns (inner config, decay)."""
    if opt_cfg.get("otype", "").lower() == "ema":
        return opt_cfg["nested"], float(opt_cfg.get("decay", 0.99))
    return opt_cfg, None


def _unwrap_schedule(opt_cfg: dict) -> tuple[dict, Callable]:
    """Peel ``ExponentialDecay`` wrappers into an optax schedule."""
    sched_cfgs = []
    while opt_cfg.get("otype", "").lower() in ("exponentialdecay",):
        sched_cfgs.append(opt_cfg)
        opt_cfg = opt_cfg["nested"]
    base_lr = float(opt_cfg.get("learning_rate", 1e-3))
    schedule: Callable = lambda step: jnp.asarray(base_lr, jnp.float32)
    for c in reversed(sched_cfgs):
        schedule = exponential_decay_schedule(c, base_lr)
    return opt_cfg, schedule


def make_optimizer(
    opt_cfg: dict, grid_label_fn: Callable[[Any], Any] | None = None
) -> tuple[optax.GradientTransformation, float | None, Callable]:
    """Build the optax stack for a tcnn optimizer config.

    ``grid_label_fn(params) -> pytree of {"grid","dense"}`` routes encoding
    tables to sparse-Adam and everything else to dense Adam + l2. Returns
    ``(transformation, ema_decay_or_None, lr_schedule)``.
    """
    inner, ema_decay = _unwrap_ema(opt_cfg)
    inner, schedule = _unwrap_schedule(inner)
    otype = inner.get("otype", "Adam").lower()
    if otype not in ("adam", "shampoo"):
        raise ValueError(f"unsupported optimizer {otype!r}")
    # Shampoo configs in the reference (envmap block) carry Adam-compatible
    # hyperparams; we run them as Adam (documented deviation).
    b1 = float(inner.get("beta1", 0.9))
    b2 = float(inner.get("beta2", 0.999))
    eps = float(inner.get("epsilon", 1e-8))
    l2_reg = float(inner.get("l2_reg", 0.0))

    dense = optax.chain(
        optax.scale_by_adam(b1=b1, b2=b2, eps=eps),
        optax.add_decayed_weights(l2_reg) if l2_reg else optax.identity(),
        optax.scale_by_learning_rate(schedule),
    )
    if grid_label_fn is None:
        return dense, ema_decay, schedule

    sparse = optax.chain(
        scale_by_adam_skip_zero(b1=b1, b2=b2, eps=eps),
        optax.scale_by_learning_rate(schedule),
    )
    tx = optax.multi_transform(
        {"dense": dense, "grid": sparse}, grid_label_fn
    )
    return tx, ema_decay, schedule


class EmaState(NamedTuple):
    params: Any


def ema_init(params) -> EmaState:
    return EmaState(jax.tree.map(jnp.copy, params))


def ema_update(state: EmaState, params, decay: float | None, step) -> EmaState:
    if decay is None:
        return EmaState(params)
    # tcnn's Ema warms up: effective decay = min(decay, (1+step)/(10+step)).
    d = jnp.minimum(decay, (1.0 + step) / (10.0 + step))
    new = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), state.params, params)
    return EmaState(new)

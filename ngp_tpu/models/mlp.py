"""Tiny bias-free MLPs, the JAX counterpart of tcnn's FullyFusedMLP.

The reference's networks are 64-wide, 1-3 hidden layer, bias-free fp16
matmul stacks (SURVEY.md §2.10). Here the same computation is a chain of
(N, 64)x(64, 64) matmuls — we keep fp32 master params, cast to bf16 for the
tensor cores, and accumulate in fp32 via ``preferred_element_type``. XLA fuses the
ReLUs into the matmuls, so a hand-fused megakernel buys little here; the
hot-path work instead goes into the hash-grid gather/scatter formulations
(``models/encodings.py``, ``ops/scatter_free.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def _activation_fn(name: str):
    name = name.lower()
    if name == "none":
        return lambda x: x
    if name == "relu":
        return jax.nn.relu
    if name == "leakyrelu":
        return lambda x: jax.nn.leaky_relu(x, 0.01)
    if name == "exponential":
        return jnp.exp
    if name in ("sigmoid", "logistic"):
        return jax.nn.sigmoid
    if name == "sine":
        return jnp.sin
    if name == "squareplus":
        return lambda x: 0.5 * (x + jnp.sqrt(x * x + 4.0))
    if name == "softplus":
        return jax.nn.softplus
    if name == "tanh":
        return jnp.tanh
    raise ValueError(f"unknown activation {name!r}")


@dataclass(frozen=True)
class MLP:
    """Bias-free MLP: ``n_hidden_layers`` hidden matmuls of width
    ``n_neurons`` with ``activation``, then an output matmul with
    ``output_activation``. ``n_hidden_layers == 0`` degenerates to a single
    linear layer, matching tcnn's behavior for the reference's
    ``base_0layer.json`` ablation."""

    n_input_dims: int
    n_output_dims: int
    n_neurons: int = 64
    n_hidden_layers: int = 2
    activation: str = "ReLU"
    output_activation: str = "None"
    compute_dtype: jnp.dtype = jnp.bfloat16

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        if self.n_hidden_layers == 0:
            return [(self.n_input_dims, self.n_output_dims)]
        dims = [(self.n_input_dims, self.n_neurons)]
        dims += [(self.n_neurons, self.n_neurons)] * (self.n_hidden_layers - 1)
        dims += [(self.n_neurons, self.n_output_dims)]
        return dims

    @property
    def n_params(self) -> int:
        return sum(a * b for a, b in self.layer_dims)

    def init(self, key: jax.Array):
        ws = []
        for i, (fan_in, fan_out) in enumerate(self.layer_dims):
            key, sub = jax.random.split(key)
            # He-uniform, appropriate for the ReLU stacks the reference uses.
            bound = float(np.sqrt(6.0 / fan_in))
            ws.append(
                jax.random.uniform(
                    sub, (fan_in, fan_out), jnp.float32, minval=-bound, maxval=bound
                )
            )
        return {"weights": ws}

    def __call__(self, params, x: jax.Array) -> jax.Array:
        act = _activation_fn(self.activation)
        out_act = _activation_fn(self.output_activation)
        ws = params["weights"]
        h = x.astype(self.compute_dtype)
        for w in ws[:-1]:
            h = jnp.dot(
                h, w.astype(self.compute_dtype), preferred_element_type=jnp.float32
            )
            h = act(h).astype(self.compute_dtype)
        out = jnp.dot(
            h, ws[-1].astype(self.compute_dtype), preferred_element_type=jnp.float32
        )
        return out_act(out)

"""2D image-fitting engine — the JAX counterpart of ``src/testbed_image.cu``.

One hash-encoded MLP regresses pixel position → color. Training samples are
drawn by a low-discrepancy or uniform sampler, snapped to texel centers, and
targets are served in sRGB space unless ``linear_colors`` (matching
``eval_image_kernel_and_snap``, ``testbed_image.cu:167-213``). The train step
is one jitted function; multi-step training runs under ``lax.scan`` so the
whole fit is a single XLA program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ngp_tpu.models.factory import (
    create_loss,
    create_network_with_input_encoding,
)
from ngp_tpu.ops.image_sampler import sample_positions
from ngp_tpu.ops.tonemap import linear_to_srgb, srgb_to_linear
from ngp_tpu.train import Trainer, TrainState


def eval_image_and_snap(
    image: jax.Array,
    positions: jax.Array,
    snap_to_pixel_centers: bool = True,
    linear_colors: bool = False,
):
    """Fetch training targets; returns (positions', targets).

    ``image`` is (H, W, 4) linear float32. With snapping, positions move to
    the texel center and targets are the exact texel; otherwise bilinear.
    Colors are converted to sRGB unless ``linear_colors``, matching the
    reference (the network is trained in sRGB space by default)."""
    H, W = image.shape[:2]
    res = jnp.asarray([W, H], jnp.float32)
    if snap_to_pixel_centers:
        pos_int = jnp.floor(positions * res).astype(jnp.int32)
        positions = (pos_int.astype(jnp.float32) + 0.5) / res
        pos_int = jnp.clip(pos_int, 0, jnp.asarray([W - 1, H - 1]))
        val = image[pos_int[:, 1], pos_int[:, 0]]
    else:
        p = jnp.clip(positions * res - 0.5, 0.0, res - (1.0 + 1e-4))
        p0 = p.astype(jnp.int32)
        w = p - p0.astype(jnp.float32)
        i0 = jnp.clip(p0, 0, jnp.asarray([W - 2, H - 2]))
        x0, y0 = i0[:, 0], i0[:, 1]
        val = (
            (1 - w[:, :1]) * (1 - w[:, 1:]) * image[y0, x0]
            + w[:, :1] * (1 - w[:, 1:]) * image[y0, x0 + 1]
            + (1 - w[:, :1]) * w[:, 1:] * image[y0 + 1, x0]
            + w[:, :1] * w[:, 1:] * image[y0 + 1, x0 + 1]
        )
    rgb = val[:, :3]
    if not linear_colors:
        rgb = linear_to_srgb(rgb)
    return positions, rgb


@dataclass
class ImageEngine:
    config: dict
    image: np.ndarray  # (H, W, 4) float32 linear
    batch_size: int = 1 << 18
    random_mode: str = "Stratified"
    snap_to_pixel_centers: bool = True
    linear_colors: bool = False
    seed: int = 1337

    def __post_init__(self):
        self.model = create_network_with_input_encoding(2, 3, self.config)
        self.trainer = Trainer(
            model_fn=self.model.__call__,
            loss_fn=create_loss(self.config.get("loss", {"otype": "RelativeL2"})),
            optimizer_cfg=self.config["optimizer"],
        )
        self.image_dev = jnp.asarray(self.image)

    def init_state(self) -> TrainState:
        params = self.model.init(jax.random.PRNGKey(self.seed))
        return self.trainer.init(params)

    def _make_batch(self, key, step, batch_size: int, image=None):
        pos = sample_positions(self.random_mode, key, step, batch_size, self.seed)
        return eval_image_and_snap(
            self.image_dev if image is None else image, pos,
            self.snap_to_pixel_centers, self.linear_colors,
        )

    def train(
        self, state: TrainState, n_steps: int, batch_size: int | None = None
    ) -> tuple[TrainState, jax.Array]:
        """Run ``n_steps`` training steps as one compiled scan; returns the
        new state and the per-step loss history.

        The image rides into the jitted scan as an ARGUMENT, not a
        closure constant — a closed-over gigapixel texture would be
        embedded in the program as a constant and handed to the
        compiler."""

        batch_size = batch_size or self.batch_size

        @jax.jit
        def run(state, image):
            def body(state, step):
                key = jax.random.fold_in(jax.random.PRNGKey(self.seed), step)
                pos, targets = self._make_batch(key, step, batch_size, image)
                state, loss = self.trainer._training_step(state, pos, targets)
                return state, loss

            return jax.lax.scan(body, state, state.step + jnp.arange(n_steps))

        return run(state, self.image_dev)

    def render(
        self, state: TrainState, width: int | None = None, height: int | None = None
    ) -> jax.Array:
        """Evaluate the model at texel centers → (H, W, 3) linear RGB,
        matching the reference's render path (network output is sRGB unless
        linear_colors, then converted to linear for display)."""
        H = height or self.image.shape[0]
        W = width or self.image.shape[1]
        x = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
        y = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
        pos = jnp.stack(jnp.meshgrid(x, y, indexing="xy"), axis=-1).reshape(-1, 2)
        params = self.trainer.inference_params(state)

        @jax.jit
        def infer(params, pos):
            return self.model(params, pos)

        out = []
        chunk = 1 << 18
        for i in range(0, pos.shape[0], chunk):
            out.append(infer(params, pos[i : i + chunk]))
        rgb = jnp.concatenate(out, axis=0).reshape(H, W, 3)
        if not self.linear_colors:
            rgb = srgb_to_linear(rgb)
        return rgb

    def save_snapshot(self, path: str, state: TrainState) -> None:
        from ngp_tpu.utils.snapshot import save_snapshot

        save_snapshot(
            path,
            {
                "mode": "image",
                "network_config": self.config,
                "snapshot": {
                    "training_step": np.asarray(state.step),
                    "params": jax.tree.map(np.asarray, state.params),
                    "ema_params": jax.tree.map(np.asarray, state.ema.params),
                },
            },
        )

    def load_snapshot(self, path: str) -> TrainState:
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

    def compute_mse(self, state: TrainState, quantize_to_byte: bool = False) -> float:
        """Full-image MSE vs texels in the training (sRGB) color space —
        the reference's ``compute_image_mse`` (``testbed_image.cu:465-528``).
        PSNR = -10·log10(mse)."""
        H, W = self.image.shape[:2]
        x = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
        y = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
        pos = jnp.stack(jnp.meshgrid(x, y, indexing="xy"), axis=-1).reshape(-1, 2)
        params = self.trainer.inference_params(state)

        @jax.jit
        def chunk_se(params, pos, image):
            p, targets = eval_image_and_snap(
                image, pos, True, self.linear_colors
            )
            pred = self.model(params, p)[:, :3]
            if quantize_to_byte:
                pred = jnp.round(jnp.clip(pred, 0, 1) * 255.0) / 255.0
            d = targets - pred
            return jnp.sum(d * d) / 3.0

        total, chunk = 0.0, 1 << 18
        for i in range(0, pos.shape[0], chunk):
            total += float(chunk_se(params, pos[i : i + chunk], self.image_dev))
        return total / (H * W)

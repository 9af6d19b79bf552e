"""Gigapixel image-fitting datum (BASELINE configs #5, tokyo-class).

Synthesizes a >=100 MP image (procedural, multi-scale — not trivially
compressible), round-trips it through the raw ``.bin`` gigapixel codec
(``data/image_loader.py``, the reference's ``testbed_image.cu:420-438``
format), fits it with the reference image config geometry (HashGrid
L=16/F=2, ``configs/image/base.json`` — table size scaled by
``--log2_hashmap``), and reports samples/s + PSNR as one JSON line.

The image is held on device in float16 (a 100 MP RGBA f32 copy is 1.6 GB;
f16 halves it — the reference stores gigapixel data as half too).

Usage: python scripts/bench_gigapixel.py [--side 10240] [--steps 2048]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_image(side: int) -> np.ndarray:
    """(side, side, 4) float16 linear RGBA with structure at many scales
    (radial waves + anisotropic stripes + smooth color field), generated
    row-block-wise to bound host memory."""
    img = np.empty((side, side, 4), np.float16)
    xs = (np.arange(side, dtype=np.float32) + 0.5) / side
    for y0 in range(0, side, 1024):
        y1 = min(y0 + 1024, side)
        ys = (np.arange(y0, y1, dtype=np.float32) + 0.5) / side
        X, Y = np.meshgrid(xs, ys)
        r = np.hypot(X - 0.5, Y - 0.5)
        v1 = 0.5 + 0.5 * np.sin(640.0 * np.pi * r) * np.exp(-3.0 * r)
        v2 = 0.5 + 0.5 * np.sin(220.0 * np.pi * (X + 0.35 * np.sin(6 * np.pi * Y)))
        v3 = 0.5 + 0.5 * np.cos(14.0 * np.pi * X) * np.sin(10.0 * np.pi * Y)
        blk = np.stack(
            [v1, 0.6 * v2 + 0.4 * v3, 0.5 * v1 + 0.5 * v3,
             np.ones_like(v1)], axis=-1
        )
        img[y0:y1] = blk.astype(np.float16)
    return img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=10240)  # 104.8 MP
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--log2_hashmap", type=int, default=22)
    ap.add_argument("--batch", type=int, default=1 << 18)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ngp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ngp_tpu.data.image_loader import load_binary_image
    from ngp_tpu.engines.image import ImageEngine

    out = {"side": args.side, "megapixels": round(args.side**2 / 1e6, 1),
           "backend": jax.default_backend(),
           "log2_hashmap_size": args.log2_hashmap}

    t0 = time.time()
    # Synthesize ON DEVICE: the procedural formula is cheap device math
    # and avoids an 800 MB host->device upload. The host codec round trip
    # runs on a small crop (same formula).
    def synth_rows(y0f):
        ys = (y0f + jnp.arange(256, dtype=jnp.float32)[:, None] + 0.5) / args.side
        xs = (jnp.arange(args.side, dtype=jnp.float32)[None, :] + 0.5) / args.side
        X = jnp.broadcast_to(xs, (256, args.side))
        Y = jnp.broadcast_to(ys, (256, args.side))
        r = jnp.hypot(X - 0.5, Y - 0.5)
        v1 = 0.5 + 0.5 * jnp.sin(640.0 * jnp.pi * r) * jnp.exp(-3.0 * r)
        v2 = 0.5 + 0.5 * jnp.sin(
            220.0 * jnp.pi * (X + 0.35 * jnp.sin(6 * jnp.pi * Y))
        )
        v3 = 0.5 + 0.5 * jnp.cos(14.0 * jnp.pi * X) * jnp.sin(10.0 * jnp.pi * Y)
        return jnp.stack(
            [v1, 0.6 * v2 + 0.4 * v3, 0.5 * v1 + 0.5 * v3,
             jnp.ones_like(v1)], axis=-1
        ).astype(jnp.float16)

    img = jax.jit(lambda y0s: jax.lax.map(synth_rows, y0s))(
        jnp.arange(0, args.side, 256, dtype=jnp.float32)
    ).reshape(args.side, args.side, 4)
    img = jax.block_until_ready(img)
    out["synth_wall_s"] = round(time.time() - t0, 1)

    crop = synth_image(512)[:256, :256]
    binp = "/tmp/giga_crop.bin"
    with open(binp, "wb") as f:
        f.write(struct.pack("<ii", crop.shape[0], crop.shape[1]))
        f.write(crop.astype(np.float16).tobytes())
    back = load_binary_image(binp)
    assert back.shape == (256, 256, 4)
    assert np.allclose(back, crop.astype(np.float32), atol=1e-3)
    out["bin_codec_roundtrip"] = "ok"

    cfg = {
        "loss": {"otype": "L2"},
        "optimizer": {
            "otype": "ExponentialDecay",
            "decay_start": 20000, "decay_interval": 10000, "decay_base": 0.33,
            "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                       "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
        },
        "encoding": {"otype": "HashGrid", "n_levels": 16,
                     "n_features_per_level": 2,
                     "log2_hashmap_size": args.log2_hashmap,
                     "base_resolution": 16,
                     # additive hash -> dup-gather fast path (one wide
                     # row per sample-level instead of 8)
                     "hash_variant": "additive"},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
    }
    print(json.dumps({"progress": "image synthesized"}), file=sys.stderr,
          flush=True)
    eng = ImageEngine(cfg, img, batch_size=args.batch)
    state = eng.init_state()
    print(json.dumps({"progress": "engine built"}), file=sys.stderr,
          flush=True)

    # uniform 128-step scans: ONE compiled program reused for the whole
    # run (mixing scan lengths would compile one program per length)
    t0 = time.time()
    state, loss = eng.train(state, 128)
    print(json.dumps({"progress": "first scan dispatched"}),
          file=sys.stderr, flush=True)
    float(loss[-1])  # compile + settle
    compile_s = time.time() - t0
    out["compile_s"] = round(compile_s, 1)
    print(json.dumps({"progress": "compiled", "compile_s": out["compile_s"]}),
          file=sys.stderr, flush=True)

    t0 = time.time()
    done = 128
    while done < args.steps:
        state, loss = eng.train(state, 128)
        done += 128
        print(json.dumps({"progress": f"steps {done}"}), file=sys.stderr,
              flush=True)
    final_loss = float(loss[-1])
    dt = time.time() - t0
    out["steps"] = int(done)
    out["train_wall_s"] = round(dt, 1)
    out["samples_per_s"] = round((done - 128) * args.batch / dt, 1)
    out["final_loss"] = final_loss

    # PSNR over a deterministic subsample of texels (full 105 MP MSE costs
    # ~400 chunks; a 1/64 stride subsample is a tight estimator)
    H, W = img.shape[:2]
    xs = (jnp.arange(0, W, 16, dtype=jnp.float32) + 0.5) / W
    ys = (jnp.arange(0, H, 16, dtype=jnp.float32) + 0.5) / H
    pos = jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    params = eng.trainer.inference_params(state)
    from ngp_tpu.engines.image import eval_image_and_snap

    @jax.jit
    def chunk_se(params, pos, image):
        p, targets = eval_image_and_snap(image, pos, True, False)
        pred = eng.model(params, p)[:, :3]
        d = targets - pred
        return jnp.sum(d * d) / 3.0

    total = 0.0
    n = pos.shape[0]
    for i in range(0, n, 1 << 18):
        total += float(chunk_se(params, pos[i : i + (1 << 18)], eng.image_dev))
    mse = total / n
    out["psnr_subsampled"] = round(-10.0 * np.log10(max(mse, 1e-12)), 2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""Block-NeRF street-view batch CLI — the fork's ``--train/--render``
entry point (``src/main.cu:63-155``): train one NeRF per city block, then
play back a drive-through along the recorded poses by hot-swapping block
models (``Testbed::train_street_view_nerf`` ``testbed.cu:377-418``,
playback ``:3606-3675``).

    python scripts/blocknerf.py --data <root> --train
    python scripts/blocknerf.py --data <root> --render --out frames/

Fleet-parallel training runs one process per card, each with
``--block_shard I/N``. A JAX process reserves most of the memory of every
card it can see, so on a multi-card host each shard pins itself to card
``I mod n_cards`` (``CUDA_VISIBLE_DEVICES``) before JAX starts, unless
``CUDA_VISIBLE_DEVICES`` is already set:

    for i in 0 1 2 3; do python scripts/blocknerf.py --data <root> --train \
        --block_shard $i/4 & done; wait
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pin_to_one_card(shard_index: int) -> str | None:
    """Restrict this process to card ``shard_index mod n_cards`` on a host
    with several NVIDIA cards. Must run before JAX initializes. Returns the
    card index it pinned, or None (already pinned, one card, or no
    ``nvidia-smi``)."""
    if "CUDA_VISIBLE_DEVICES" in os.environ or not shutil.which("nvidia-smi"):
        return None
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    n_cards = sum(l.startswith("GPU ") for l in r.stdout.splitlines())
    if n_cards <= 1:
        return None
    card = str(shard_index % n_cards)
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="root with blocks/b*/")
    p.add_argument("--train", action="store_true")
    p.add_argument("--render", action="store_true")
    p.add_argument("--n_steps", type=int, default=None,
                   help="override setting.json training_steps")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--out", default="blocknerf_frames",
                   help="render output directory (png sequence)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--block_shard", default=None, metavar="I/N",
                   help="train only every Nth block starting at I "
                        "(fleet-parallel city training, e.g. 0/4)")
    args = p.parse_args(argv)
    if not (args.train or args.render):
        p.error("pass --train and/or --render (like the fork's main.cu)")

    shard = None
    if args.block_shard:
        i, nsh = args.block_shard.split("/")
        shard = (int(i), int(nsh))
        pin_to_one_card(shard[0])

    from ngp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    kw = {}
    if args.batch_size:
        kw["batch_size"] = args.batch_size

    if args.train:
        from ngp_tpu.blocknerf import train_street_view_nerf

        snaps = train_street_view_nerf(
            args.data, n_steps_override=args.n_steps, block_shard=shard, **kw
        )
        print(f"trained {len(snaps)} blocks")

    if args.render:
        import numpy as np
        from PIL import Image

        from ngp_tpu.blocknerf import BlockNerfRenderer, playback_world_poses

        r = BlockNerfRenderer(args.data, **kw)
        os.makedirs(args.out, exist_ok=True)
        for i, xform in enumerate(playback_world_poses(args.data, args.n_frames)):
            img, _ = r.render_at(xform, args.width, args.height)
            arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(
                os.path.join(args.out, f"frame_{i:04d}.png")
            )
        print(f"rendered {args.n_frames} frames to {args.out}")


if __name__ == "__main__":
    main()

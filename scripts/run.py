#!/usr/bin/env python3
"""Training/eval driver — the counterpart of the reference's
``scripts/run.py`` (``run.py:80-318``): train any of the four primitives
from the command line, evaluate PSNR/IoU/MSE, take screenshots, export
meshes, save/load snapshots.

Examples:
    python scripts/run.py data/nerf/fox --n_steps 2000 \\
        --screenshot out/fox.png --save_snapshot out/fox.ingp
    python scripts/run.py data/sdf/armadillo.obj --n_steps 1000 \\
        --save_mesh out/armadillo.obj
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def apply_tonemap(img, curve: str = "identity", exposure_ev: float = 0.0):
    """Render epilogue: sRGB frame → linear → exposure → tonemap → sRGB
    (``render_frame_epilogue``'s tonemap stage, ``src/render_buffer.cu``)."""
    import numpy as np

    if curve == "identity" and exposure_ev == 0.0:
        return img
    from ngp_tpu.ops.tonemap import TONEMAPS, linear_to_srgb, srgb_to_linear

    lin = np.asarray(srgb_to_linear(np.clip(img, 0.0, 1.0)))
    lin = lin * (2.0 ** exposure_ev)
    if curve != "identity":
        mapped = np.asarray(TONEMAPS[curve](lin))
        return np.clip(mapped, 0.0, 1.0)
    return np.clip(np.asarray(linear_to_srgb(lin)), 0.0, 1.0)


def write_image(path: str, img) -> None:
    import numpy as np

    img = np.asarray(img)
    if path.endswith(".exr"):
        from ngp_tpu.data.exr import write_exr

        write_exr(path, img.astype(np.float32))
        return
    from PIL import Image

    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", nargs="?", default="",
                   help="scene path: transforms.json/dir (NeRF), obj/stl (SDF), "
                        "nvdb/npy (volume), image file (image)")
    p.add_argument("--mode", default=None, choices=["nerf", "sdf", "image", "volume"])
    p.add_argument("--network", default=None, help="network config json")
    p.add_argument("--n_steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--load_snapshot", default=None)
    p.add_argument("--save_snapshot", default=None)
    p.add_argument("--screenshot", default=None, help="render a view to this path")
    p.add_argument("--screenshot_w", type=int, default=512)
    p.add_argument("--screenshot_h", type=int, default=512)
    p.add_argument("--save_mesh", default=None, help="marching-cubes export (obj/ply)")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--marching_cubes_density_thresh", type=float, default=2.5)
    p.add_argument("--test_view", type=int, default=0,
                   help="training view index for NeRF PSNR eval / screenshot")
    p.add_argument("--eval_stride", type=int, default=2)
    p.add_argument("--holdout_every", type=int, default=0,
                   help="exclude every Nth view from training and report "
                        "held-out PSNR/SSIM on them (no separate "
                        "test_transforms.json needed)")
    p.add_argument("--test_transforms", default=None,
                   help="held-out transforms.json: render every view and "
                        "report PSNR/SSIM (reference run.py:208-266)")
    p.add_argument("--test_spp", type=int, default=1)
    p.add_argument("--test_max_views", type=int, default=None)
    p.add_argument("--flip", action="store_true",
                   help="also compute the FLIP perceptual metric per view")
    p.add_argument("--video_camera_path", default=None,
                   help="camera-path json to render as a flythrough video")
    p.add_argument("--video_n_seconds", type=float, default=4.0)
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_output", default="video.mp4",
                   help="output mp4 (needs ffmpeg) or a directory for pngs")
    p.add_argument("--video_w", type=int, default=640)
    p.add_argument("--video_h", type=int, default=360)
    p.add_argument("--video_spp", type=int, default=1)
    p.add_argument("--render_mode", default="shade",
                   choices=["shade", "depth", "normals", "positions",
                            "cost", "ao", "encoding"],
                   help="NeRF screenshot render mode (ERenderMode)")
    p.add_argument("--tonemap", default="identity",
                   choices=["identity", "aces", "hable", "reinhard"],
                   help="tonemap curve for screenshots/video frames")
    p.add_argument("--exposure", type=float, default=0.0,
                   help="EV offset applied before tonemapping")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace of a few train steps here")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--no_compile_cache", action="store_true",
                   help="do not use the persistent compile cache "
                        "(JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache)")
    args = p.parse_args(argv)

    if not args.no_compile_cache:
        from ngp_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    # Multi-process rendezvous when launched as part of a pod job (env
    # NGP_COORDINATOR/NGP_NUM_PROCESSES/NGP_PROCESS_ID, or JAX's own
    # autodetect via NGP_AUTO_DISTRIBUTED; no-op single-process).
    from ngp_tpu.parallel import multihost

    multihost.initialize()

    from ngp_tpu.testbed import Testbed

    kw = {"seed": args.seed}
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    holdout_ds = None
    if args.holdout_every and args.holdout_every > 1:
        from ngp_tpu.data.nerf_loader import load_nerf

        # load exactly like Testbed does (a directory unions all jsons) so
        # the frame indices refer to the same frame list
        full_ds = load_nerf(args.scene)
        all_idx = list(range(full_ds.n_images))
        test_idx = all_idx[:: args.holdout_every]
        train_idx = [i for i in all_idx if i not in set(test_idx)]
        holdout_ds = full_ds.subset(test_idx)
        kw["frame_subset"] = train_idx
        print(f"holdout: training on {len(train_idx)} views, "
              f"evaluating on {len(test_idx)}")
    tb = Testbed(mode=args.mode, scene=args.scene or None,
                 config=args.network, **kw)

    if args.load_snapshot:
        tb.load_snapshot(args.load_snapshot)
        print(f"loaded snapshot at step {tb.training_step}")

    if args.n_steps > 0 and tb.engine is not None:
        t0 = time.time()
        done_steps = args.n_steps
        if args.profile:
            import jax

            warm = min(args.n_steps, 16)
            traced = min(max(args.n_steps - warm, 0), 8)
            tb.train(warm)  # compile outside the trace
            if traced:
                with jax.profiler.trace(args.profile):
                    tb.train(traced)
                print(f"profiler trace written to {args.profile}")
            rest = args.n_steps - warm - traced
            if rest > 0:
                tb.train(rest)
        else:
            tb.train(args.n_steps)
        dt = time.time() - t0
        print(f"trained {done_steps} steps in {dt:.1f}s "
              f"({done_steps / dt:.2f} steps/s), loss={tb.loss:.6f}")

    # evaluation
    if tb.mode == "nerf":
        psnr = tb.psnr(args.test_view, stride=args.eval_stride)
        print(f"PSNR (train view {args.test_view}): {psnr:.2f} dB")
    elif tb.mode == "sdf":
        iou = tb.calculate_iou()
        print(f"IoU: {iou:.4f}")
    elif tb.mode == "image":
        mse = tb.compute_image_mse()
        print(f"MSE: {mse:.6f}  PSNR: {-10 * __import__('math').log10(max(mse, 1e-12)):.2f} dB")

    if args.test_transforms or holdout_ds is not None:
        if args.test_transforms:
            from ngp_tpu.data.nerf_loader import load_nerf

            test_ds = load_nerf(args.test_transforms)
            label = "test_transforms"
        else:
            test_ds = holdout_ds
            label = f"holdout(every {args.holdout_every})"
        res = tb.engine.eval_test_transforms(
            tb.state, tb.grid, test_ds,
            spp=args.test_spp, stride=args.eval_stride,
            max_views=args.test_max_views, compute_flip=args.flip,
        )
        flip_str = f" FLIP={res['flip']:.4f}" if args.flip else ""
        print(f"{label}: PSNR={res['psnr']:.2f} "
              f"[min={res['min_psnr']:.2f} max={res['max_psnr']:.2f}] "
              f"SSIM={res['ssim']:.4f}{flip_str} over {res['n_views']} views")

    if args.video_camera_path:
        import numpy as np

        from ngp_tpu.utils.camera_path import CameraPath

        path = CameraPath.load(args.video_camera_path)
        n_frames = max(int(args.video_n_seconds * args.video_fps), 1)
        out = args.video_output
        is_dir = not out.lower().endswith((".mp4", ".avi", ".mkv"))
        frames_dir = out if is_dir else out + "_frames"
        os.makedirs(frames_dir, exist_ok=True)
        t0 = time.time()
        for i in range(n_frames):
            t = i / max(n_frames - (0 if path.loop else 1), 1)
            kf = path.eval_camera_path(t)
            m = kf.matrix()
            H = args.video_h
            f = 0.5 * H / np.tan(0.5 * np.radians(kf.fov))
            rgb, _, _ = tb.engine.render_view(
                tb.state, tb.grid, m, (f, f),
                width=args.video_w, height=H, spp=args.video_spp,
                snap_to_pixel_centers=args.video_spp <= 1, seed=i,
            )
            img = apply_tonemap(np.asarray(rgb), args.tonemap, args.exposure)
            write_image(os.path.join(frames_dir, f"frame_{i:04d}.png"), img)
        print(f"rendered {n_frames} frames in {time.time()-t0:.1f}s")
        if not is_dir:
            import shutil
            import subprocess

            if shutil.which("ffmpeg"):
                subprocess.run(
                    ["ffmpeg", "-y", "-loglevel", "error",
                     "-framerate", str(args.video_fps),
                     "-i", os.path.join(frames_dir, "frame_%04d.png"),
                     "-pix_fmt", "yuv420p", out],
                    check=True,
                )
                print(f"wrote {out}")
            else:
                print(f"ffmpeg not found; frames left in {frames_dir}")

    if args.save_snapshot:
        os.makedirs(os.path.dirname(args.save_snapshot) or ".", exist_ok=True)
        tb.save_snapshot(args.save_snapshot)
        print(f"saved snapshot to {args.save_snapshot}")

    if args.screenshot:
        os.makedirs(os.path.dirname(args.screenshot) or ".", exist_ok=True)
        if tb.mode == "nerf" and args.render_mode != "shade":
            import numpy as _np

            img = _np.asarray(tb.engine.render_image(
                tb.state, tb.grid, args.test_view, mode=args.render_mode
            ))
        elif tb.mode == "nerf":
            img = tb.render(args.screenshot_w, args.screenshot_h,
                            training_view=args.test_view)
        else:
            img = tb.render(args.screenshot_w, args.screenshot_h)
        img = apply_tonemap(img, args.tonemap, args.exposure)
        write_image(args.screenshot, img)
        print(f"wrote {args.screenshot}")

    if args.save_mesh:
        from ngp_tpu.ops.marching_cubes import save_obj, save_ply

        verts, faces = tb.compute_marching_cubes_mesh(
            args.marching_cubes_res, args.marching_cubes_density_thresh
        )
        os.makedirs(os.path.dirname(args.save_mesh) or ".", exist_ok=True)
        if args.save_mesh.endswith(".ply"):
            save_ply(args.save_mesh, verts, faces)
        else:
            save_obj(args.save_mesh, verts, faces)
        print(f"wrote {args.save_mesh} ({len(verts)} verts, {len(faces)} faces)")


if __name__ == "__main__":
    main()

"""Testbed orchestrator + CLI tests: mode detection, the pyngp-style
programmatic surface, and scripts/run.py end-to-end via subprocess."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ngp_tpu.testbed import Testbed, default_config, mode_from_scene


def test_mode_from_scene(tmp_path):
    assert mode_from_scene(str(tmp_path)) == "nerf"
    assert mode_from_scene("a/transforms.json") == "nerf"
    assert mode_from_scene("m.obj") == "sdf"
    assert mode_from_scene("m.STL") == "sdf"
    assert mode_from_scene("v.nvdb") == "volume"
    assert mode_from_scene("i.exr") == "image"
    assert mode_from_scene("i.png") == "image"
    assert mode_from_scene("x.docx") is None


def _small_image(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    # smooth it so the fit converges fast
    for _ in range(4):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    from ngp_tpu.data.exr import write_exr

    p = str(tmp_path / "img.exr")
    write_exr(p, img)
    return p


def test_testbed_image_roundtrip(tmp_path):
    p = _small_image(tmp_path)
    cfg = default_config("image")
    cfg["encoding"].update({"n_levels": 6, "log2_hashmap_size": 12})
    tb = Testbed(scene=p, config=cfg, batch_size=1 << 12)
    assert tb.mode == "image"
    tb.train(100)
    mse = tb.compute_image_mse()
    assert mse < 0.01, mse
    out = tb.render(32, 32)
    assert out.shape == (32, 32, 3)

    snap = str(tmp_path / "img.ingp")
    tb.save_snapshot(snap)
    tb2 = Testbed(scene=p, config=cfg, batch_size=1 << 12)
    tb2.load_snapshot(snap)
    assert abs(tb2.compute_image_mse() - mse) < 1e-4
    assert tb2.training_step == tb.training_step


@pytest.mark.slow
def test_cli_sdf_end_to_end(tmp_path):
    """Drive scripts/run.py as a subprocess on a generated cube mesh."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_sdf import _cube_triangles
    from ngp_tpu.ops.marching_cubes import save_obj

    tris = _cube_triangles([0.0, 0.0, 0.0], 1.0)
    verts = tris.reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3)
    mesh_path = str(tmp_path / "cube.obj")
    save_obj(mesh_path, verts, faces)

    cfg = default_config("sdf")
    cfg["encoding"].update({"n_levels": 6, "log2_hashmap_size": 12,
                            "base_resolution": 8, "per_level_scale": 1.6})
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-3
    cfg_path = str(tmp_path / "net.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out_mesh = str(tmp_path / "out.obj")
    snap = str(tmp_path / "cube.ingp")
    r = subprocess.run(
        [
            sys.executable, os.path.join(os.path.dirname(__file__), "..", "scripts", "run.py"),
            mesh_path, "--network", cfg_path, "--n_steps", "120",
            "--batch_size", str(1 << 12),
            "--save_mesh", out_mesh, "--marching_cubes_res", "40",
            "--save_snapshot", snap, "--no_compile_cache",
        ],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "IoU:" in r.stdout
    iou = float(r.stdout.split("IoU:")[1].split()[0])
    assert iou > 0.75, r.stdout
    assert os.path.exists(out_mesh) and os.path.getsize(out_mesh) > 1000
    assert os.path.exists(snap)


def test_frame_heartbeat(tmp_path):
    """Headless frame(): train chunk + dynamic-res render + meters
    (Testbed::frame / train_and_render, testbed.cu:3595-3759)."""
    p = _small_image(tmp_path)
    cfg = default_config("image")
    cfg["encoding"].update({"n_levels": 4, "log2_hashmap_size": 10})
    tb = Testbed(scene=p, config=cfg, batch_size=1 << 10)
    out = tb.frame(width=64, height=64, n_train_steps=4)
    assert out["image"] is not None
    assert out["resolution"][0] >= 16 and out["frame_ms"] > 0
    assert out["training_step"] >= 4
    out2 = tb.frame(width=64, height=64, n_train_steps=4, render=False)
    assert out2["image"] is None and out2["training_step"] >= 8

"""chip_smoke.py off the card: it must refuse the CPU, and each of its
phases must run (and pass) at toy size on the CPU backend."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from __graft_entry__ import _default_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout, r.stdout
    assert "not 'gpu'" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout, r.stdout


def _toy_nerf_config():
    cfg = _default_config("upstream")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    return cfg


def test_chip_smoke_parity_phase_toy():
    res = cs.phase_parity(n_levels=4, log2_table=10, n_samples=2048)
    assert res["xor"]["grad_err"] <= cs.GRAD_TOL
    assert res["additive"]["grad_err"] <= cs.GRAD_TOL
    assert res["xor"]["fwd_err"] <= cs.FWD_TOL_F32
    assert 0 < res["additive"]["fwd_err"] <= cs.FWD_TOL_BF16  # bf16 rows


def test_chip_smoke_nerf_phase_toy():
    res = cs.phase_nerf(
        n_steps=96, timed_steps=32, batch_size=1 << 13, n_views=6, res=32,
        config=_toy_nerf_config(),
        engine_kw=dict(grid_size=16, n_steps_per_unit=128),
    )
    assert res["loss"][-1] < res["loss"][0]
    assert res["render_psnr"] >= cs.PSNR_MIN_DB
    assert res["steps_per_s"] > 0


def test_chip_smoke_image_phase_toy():
    from ngp_tpu.testbed import default_config

    cfg = default_config("image")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    res = cs.phase_image(n_steps=256, side=64, batch_size=1 << 12,
                         config=cfg)
    assert res["psnr"] >= cs.PSNR_MIN_DB


def test_chip_smoke_multi_phase_toy():
    """The --devices 4 phase on 4 of the 8 virtual CPU devices."""
    res = cs.phase_multi(
        4, batch_size=4 * 256, n_views=6, res=32, config=_toy_nerf_config(),
        engine_kw=dict(grid_size=16, n_steps_per_unit=64,
                       min_rays_per_batch=4),
        fsdp_min_size=1 << 10,
    )
    assert res["dp_ratio"] <= 1.0
    assert len(res["memory"]) == 4


def test_chip_smoke_phase_failure_raises():
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.phase_device(1)


def test_procedural_image_seeded():
    a, b = cs.procedural_image(32, seed=3), cs.procedural_image(32, seed=3)
    assert a.shape == (32, 32, 4) and (a == b).all()
    assert (a[..., 3] == 1.0).all() and 0.0 <= a.min() and a.max() <= 1.0
    assert not (a == cs.procedural_image(32, seed=4)).all()

"""The persistent compile cache helper, and per-shard card pinning of the
Block-NeRF CLI. Each case runs in a fresh interpreter, so the test
process's own JAX configuration is left alone."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
from ngp_tpu.utils.compile_cache import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_compile_cache(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = str(tmp_path / "cache")
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        want = os.path.join(REPO, ".jax_cache")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO)], env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    returned, configured = r.stdout.split()[-2:]
    # with the variable set, JAX's own setting is the only one
    assert returned == want and configured == want
    assert os.path.isdir(want) or env_dir


def _load_blocknerf_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "blocknerf_cli", os.path.join(REPO, "scripts", "blocknerf.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "preset,n_cards,shard,want",
    [(None, 4, 6, "2"), (None, 1, 3, None), ("1", 4, 0, None)],
)
def test_block_shard_pins_one_card(monkeypatch, preset, n_cards, shard,
                                   want):
    cli = _load_blocknerf_cli()
    if preset is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", preset)
    monkeypatch.setattr(cli.shutil, "which", lambda name: "/bin/" + name)
    listing = "".join(f"GPU {i}: NVIDIA H100 (UUID: x)\n"
                      for i in range(n_cards))
    monkeypatch.setattr(
        cli.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, listing, ""),
    )
    assert cli.pin_to_one_card(shard) == want
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == (want or preset)

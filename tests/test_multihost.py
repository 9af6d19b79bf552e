"""Multi-host scaffolding test: two real OS processes rendezvous through
``jax.distributed`` on the CPU backend (4 virtual devices each = 8 global)
and run a psum + one DP NeRF train step over the global mesh. This is the
standard JAX pod-simulation trick (SURVEY §4): the collective path it
exercises (gradient psum crossing the process boundary) is exactly what a
2-host run uses, minus the physical network."""

import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["NGP_REPO"])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax

# jax.config wins over any platform an installed plug-in pins (as in
# tests/conftest.py)
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from ngp_tpu.parallel import multihost

multihost.initialize()
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

mesh = multihost.make_global_mesh()
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

@jax.jit
def global_sum():
    def f():
        me = jax.lax.axis_index("data").astype(jnp.float32)
        return jax.lax.psum(me[None], "data")
    return shard_map(f, mesh=mesh, in_specs=(), out_specs=P("data"))()

s = global_sum()
total = float(jax.device_get(s.addressable_shards[0].data)[0])
assert total == sum(range(8)), total

# one tiny DP train step over the global mesh
from __graft_entry__ import _default_config, _tiny_sphere_dataset
from ngp_tpu.engines.nerf import NerfEngine
from ngp_tpu.parallel.nerf_dp import build_dp_train_step

cfg = _default_config()
cfg["encoding"].update({"n_levels": 2, "log2_hashmap_size": 10})
eng = NerfEngine(
    cfg, _tiny_sphere_dataset(n_views=4, res=16), batch_size=8 * 128,
    min_rays_per_batch=8, grid_size=16, n_steps_per_unit=32, seed=5,
)
state, grid = eng.init_state(), eng.init_grid()
step = build_dp_train_step(eng, mesh)
state, metrics = step(state, grid, jax.random.PRNGKey(3))
loss = float(jax.device_get(metrics["loss"]))
assert loss == loss, "NaN loss"
if jax.process_index() == 0:
    print(json.dumps({"ok": True, "psum": total, "loss": loss}))
"""


@pytest.mark.slow
def test_two_process_dp_step(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    env_base = {
        **os.environ,
        "NGP_REPO": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "NGP_COORDINATOR": addr,
        "NGP_NUM_PROCESSES": "2",
    }
    # strip the single-process test harness device forcing
    env_base.pop("XLA_FLAGS", None)

    procs = []
    for pid in range(2):
        env = {**env_base, "NGP_PROCESS_ID": str(pid)}
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    line = [l for l in outs[0][0].splitlines() if l.startswith("{")][-1]
    res = json.loads(line)
    assert res["ok"] and res["psum"] == 28.0

"""Two-process `jax.distributed` test (SURVEY section 5.8).

Spawns two REAL processes with a local coordinator; each initializes
the distributed runtime through parallel.multihost.initialize_distributed,
forms the global ray mesh (2 processes x 4 virtual CPU devices), and
renders its shard of a sharded computation. Verifies:
  * the multi-process branch of initialize_distributed actually runs
    (process_count == 2, 8 global devices),
  * a psum across the global mesh sees every process's contribution,
  * a sharded render over the global mesh matches the local unsharded
    render (replicated checksum),
  * a GEOMETRY-sharded render over a 2-D (rays, geo) cross-process
    mesh matches too (fused chunk tables split over 'geo', the
    pmin/psum hit combines riding the inter-process backend).

The subprocesses run the module below with a fresh JAX (cpu, 4 fake
devices each); results are exchanged via JSON files. Skipped when the
port can't be bound (sandboxed CI).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["RT_REPO"])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

from rendering_jax.parallel.multihost import (
    initialize_distributed, make_global_ray_mesh, process_topology,
)

ok = initialize_distributed(
    coordinator_address=os.environ["RT_COORD"],
    num_processes=2,
    process_id=int(os.environ["RT_PID"]),
)
assert ok, "multi-process init did not take the explicit branch"
topo = process_topology()
assert topo["process_count"] == 2, topo
assert topo["global_devices"] == 8, topo

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map as shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

mesh = make_global_ray_mesh()

# Each process contributes its local shard; the psum must see all 8
# device shards across BOTH processes.
x = jnp.arange(16.0)

def local(xl):
    return jax.lax.psum(jnp.sum(xl), "rays")

total = jax.jit(
    shard_map(local, mesh=mesh, in_specs=P("rays"), out_specs=P())
)(x)

# A real sharded render over the global (2-process) mesh must agree
# with this process's local unsharded render. The frame comes back as
# a global Array whose shards live on both processes, so compare via a
# replicated checksum (jnp.sum is a single-controller SPMD reduction).
from rendering_jax.flagship import build_tiny_scene
from rendering_jax.parallel.shard import render_scene_sharded
from rendering_jax.render.pipeline import render_scene

scene = build_tiny_scene(width=64, height=32, n_tris=96)
ref_sum = float(jnp.sum(render_scene(scene)[0]))
g_sum = float(jnp.sum(render_scene_sharded(scene, mesh)[0]))

# Geometry sharding across PROCESSES: a 2-D (rays=4, geo=2) global
# mesh — the fused chunk tables physically sharded over 'geo' with
# cross-shard pmin/psum combines riding the inter-process backend.
import dataclasses
from rendering_jax.flagship import build_multimesh_scene
from rendering_jax.parallel.geoshard import (
    make_geo_mesh, render_scene_geo_sharded,
)

ms = build_multimesh_scene(64, 32, n_meshes=2, tris_per_mesh=48)
ms_ref_sum = float(jnp.sum(render_scene(ms)[0]))
st = ms.static
ms_g = dataclasses.replace(
    ms,
    static=dataclasses.replace(
        st,
        settings=st.settings.replace(
            geo_shard_axis="geo", pallas_interpret=True,
        ),
    ),
)
gmesh = make_geo_mesh(jax.devices(), n_geo=2)
geo_sum = float(jnp.sum(render_scene_geo_sharded(ms_g, gmesh)[0]))

result = {"topo": topo, "psum": float(total), "ref_sum": ref_sum,
          "g_sum": g_sum, "ms_ref_sum": ms_ref_sum, "geo_sum": geo_sum}

if int(os.environ["RT_PID"]) == 0:
    with open(os.environ["RT_OUT"], "w") as f:
        json.dump(result, f)
print("WORKER_OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("cannot bind local port")
    out = tmp_path / "p0.json"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    # The workers set their own device count and platform.
    env_base = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = []
    for pid in (0, 1):
        env = dict(
            env_base,
            RT_REPO=REPO,
            RT_COORD=f"127.0.0.1:{port}",
            RT_PID=str(pid),
            RT_OUT=str(out),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(o)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
        assert "WORKER_OK" in o

    result = json.loads(out.read_text())
    assert result["topo"]["process_count"] == 2
    assert result["topo"]["global_devices"] == 8
    # psum over all shards of arange(16) = 120, seen identically by
    # every process.
    np.testing.assert_allclose(result["psum"], 120.0)
    # Sharded render over the 2-process global mesh == local unsharded
    # render (checksum; f32 add-order differs across shard boundaries).
    np.testing.assert_allclose(
        result["g_sum"], result["ref_sum"], rtol=1e-4
    )
    # Geometry-sharded render over the 2-D (rays, geo) cross-process
    # mesh == local unsharded multimesh render.
    np.testing.assert_allclose(
        result["geo_sum"], result["ms_ref_sum"], rtol=1e-4
    )

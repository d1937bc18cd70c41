"""Multi-host distributed runtime — the framework's communication
backend layer.

The reference has NO distributed backend: its only "communication" is a
shared-memory framebuffer plus two atomics between threads of one
process (src/scene.cpp:470-506, include/scene.h:83-84). The first-class
equivalent here (SURVEY section 5.8) is:

  * `jax.distributed.initialize` to form the multi-process runtime
    (coordinator + N processes, one per host),
  * one global `Mesh` over every chip of every host with the ray axis
    sharded across all of them (parallel/shard.py runs unchanged on
    it — shard_map is multi-host-transparent),
  * gradient/psum reductions ride NVLink within a host and the
    network across hosts; the scene is replicated (shotgun-class scenes are well
    under a GB), so no parameter sharding collective is needed.

Environment conventions follow the standard JAX cluster bootstrap: on
clusters JAX knows (e.g. SLURM) `initialize()` autodetects everything;
elsewhere set COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID (or pass
explicitly).

Single-host multi-chip needs none of this — `jax.devices()` already
sees all local chips and `make_global_ray_mesh()` spans them.
"""

from __future__ import annotations

import os

import jax
from jax.sharding import Mesh

# NOTE: no rendering_jax imports at module level — importing the wider
# package materializes jnp constants, which initializes the XLA backend,
# and jax.distributed.initialize() must run BEFORE any backend init.
# Callers do `from rendering_jax.parallel import multihost` first, call
# initialize_distributed(), then import the renderer.


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up the multi-process JAX runtime. Returns True if a
    multi-process runtime was initialized, False for the single-process
    fallback (no coordinator configured — the common 1-host case).

    On clusters JAX knows, `jax.distributed.initialize()` autodetects
    all three values; env vars COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID override, explicit args win.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        try:
            # Cluster autodetection path; harmless no-op failure on
            # single hosts without cluster metadata.
            jax.distributed.initialize()
            return jax.process_count() > 1
        except Exception:
            return False
    # Explicit path: all three values are required together —
    # jax.distributed.initialize raises opaquely on a partial set
    # unless cluster autodetection happens to fill the rest.
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "explicit distributed init needs coordinator_address, "
            "num_processes AND process_id (args or COORDINATOR_ADDRESS/"
            f"NUM_PROCESSES/PROCESS_ID env); got address={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_global_ray_mesh() -> Mesh:
    """1-D mesh with the ray axis spanning EVERY chip of every process
    (NVLink within a host, the network across hosts). The sharded renderer
    (parallel.shard.render_scene_sharded) runs on it unchanged."""
    from rendering_jax.parallel.shard import make_ray_mesh

    return make_ray_mesh(jax.devices())


def make_host_ray_mesh() -> Mesh:
    """1-D mesh over this process's local devices only
    (intra-host collectives) — for per-host rendering with host-level work
    splitting managed outside JAX."""
    from rendering_jax.parallel.shard import make_ray_mesh

    return make_ray_mesh(jax.local_devices())


def process_topology() -> dict:
    """Host-side observability: the distributed topology as a dict
    (process index/count, local/global device counts, platform)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.default_backend(),
    }


def scaling_report(rays_per_sec_1chip: float, rays_per_sec_n: float,
                   n_chips: int) -> dict:
    """Scaling-efficiency record for the north-star metric
    (BASELINE.json: >= 80% efficiency 1 chip -> 1 host -> >= 2 hosts)."""
    ideal = rays_per_sec_1chip * n_chips
    return {
        "n_chips": n_chips,
        "rays_per_sec": rays_per_sec_n,
        "ideal": ideal,
        "efficiency": rays_per_sec_n / ideal if ideal else 0.0,
    }

"""Overlap-vs-bulk psum schedule A/B (SURVEY section 5.8): times the sharded flagship train step under both
gradient-aggregation schedules of parallel.overlap.make_sharded_grad_fn

  * overlap=True  — per-bounce psums inside the backward scan
    (cotangent all-reduces ride the interconnect while the next backward bounce
    computes; this renderer's default AD schedule), vs
  * overlap=False — device-local partials + ONE bulk psum per leaf
    after the whole backward pass (the classic DDP-style schedule).

Gradient equality is pinned by tests/test_overlap.py; this measures
which schedule a REAL multi-device interconnect prefers. On one device (or the
virtual CPU mesh) both degenerate to the same local math — the numbers
then only smoke-test the plumbing.

Prints ONE JSON line. Env knobs: AB_WIDTH/AB_HEIGHT/AB_TRIS/AB_REPS.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def time_schedule(grad_fn, params, scene, target3, reps: int) -> float:
    import jax

    loss, grads = grad_fn(params, scene, target3)  # warmup/compile
    jax.block_until_ready(grads)
    t0 = time.perf_counter()
    for _ in range(reps):
        loss, grads = grad_fn(params, scene, target3)
    jax.block_until_ready(grads)
    return (time.perf_counter() - t0) / reps


def main() -> int:
    from rendering_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from rendering_jax.diff.inverse import extract_params
    from rendering_jax.flagship import build_flagship_scene
    from rendering_jax.parallel.overlap import make_sharded_grad_fn
    from rendering_jax.parallel.shard import make_ray_mesh

    width = int(os.environ.get("AB_WIDTH", 1920))
    height = int(os.environ.get("AB_HEIGHT", 1080))
    n_tris = int(os.environ.get("AB_TRIS", 250_000))
    reps = int(os.environ.get("AB_REPS", 3))

    scene = build_flagship_scene(width=width, height=height,
                                 n_tris=n_tris, enable_ssaa=False)
    mesh = make_ray_mesh()
    paths = (("lights", 0, "intensity"), ("obj_color",),
             ("meshes", 0, "v"))
    params = extract_params(scene, paths)
    target3 = jnp.zeros((3, height, width), jnp.float32)

    t_overlap = time_schedule(
        jax.jit(make_sharded_grad_fn(paths, mesh, overlap=True)),
        params, scene, target3, reps,
    )
    t_bulk = time_schedule(
        jax.jit(make_sharded_grad_fn(paths, mesh, overlap=False)),
        params, scene, target3, reps,
    )
    print(json.dumps({
        "metric": "overlap_vs_bulk_psum_step_seconds",
        "value": round(t_overlap, 4),
        "unit": "s",
        "vs_baseline": round(t_bulk / t_overlap, 3),
        "bulk_seconds": round(t_bulk, 4),
        "devices": jax.device_count(),
        "platform": jax.default_backend(),
        "tris": n_tris,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Scaling-efficiency benchmark — the BASELINE.json north star's
">= 80% scaling efficiency 1 chip -> 1 host -> >= 2 hosts" axis.

Runs the flagship fwd+bwd step (same loss as bench.py) sharded over
prefix subsets of the visible devices (1, 2, 4, ..., N) and reports
rays/s at each count plus parallel efficiency vs linear scaling from
the 1-device run:

  {"metric": "scaling_efficiency_8dev", "value": 0.93, "unit": "x",
   "rays_per_sec": {"1": ..., "2": ..., ...}, ...}

On one device this degenerates to the 1-device number; on the virtual
8-device CPU mesh "efficiency" only checks plumbing, not the
interconnect.

Env knobs: SCALE_WIDTH/SCALE_HEIGHT/SCALE_TRIS/SCALE_REPS,
SCALE_DEVICES (comma list of device counts to test, default powers of
two up to all).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_at(devices, scene, paths, reps: int, force_sharded=False) -> float:
    import jax
    import jax.numpy as jnp

    from rendering_jax.diff.inverse import apply_params, extract_params
    from rendering_jax.parallel.shard import make_ray_mesh, render_scene_sharded
    from rendering_jax.render.pipeline import render_scene

    st = scene.static.settings
    params = extract_params(scene, paths)
    mesh = (
        make_ray_mesh(devices)
        if (len(devices) > 1 or force_sharded) else None
    )

    def loss_fn(params, scene):
        s = apply_params(scene, params, paths)
        if mesh is not None:
            frame, _ = render_scene_sharded(s, mesh)
        else:
            frame, _ = render_scene(s)
        return jnp.mean(frame)

    step = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = step(params, scene)
    jax.block_until_ready(grads)
    t0 = time.perf_counter()
    for _ in range(reps):
        loss, grads = step(params, scene)
    jax.block_until_ready(grads)
    dt = (time.perf_counter() - t0) / reps
    return (st.width * st.height) / dt


def main() -> int:
    from rendering_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from rendering_jax.flagship import build_flagship_scene

    width = int(os.environ.get("SCALE_WIDTH", 3840))
    height = int(os.environ.get("SCALE_HEIGHT", 1080))
    n_tris = int(os.environ.get("SCALE_TRIS", 250_000))
    reps = int(os.environ.get("SCALE_REPS", 3))

    devs = jax.devices()
    if os.environ.get("SCALE_DEVICES"):
        counts = [int(c) for c in os.environ["SCALE_DEVICES"].split(",")]
    else:
        counts, c = [], 1
        while c <= len(devs):
            counts.append(c)
            c *= 2
    counts = [c for c in counts if c <= len(devs)]

    scene = build_flagship_scene(
        width=width, height=height, n_tris=n_tris, enable_ssaa=False
    )
    paths = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))

    rates = {}
    for c in counts:
        rates[str(c)] = round(run_at(devs[:c], scene, paths, reps), 1)
    if "1" in rates:
        # The production multi-chip path on ONE chip: shard_map + the
        # Pallas kernel composed on real hardware. The
        # gap vs the unsharded "1" number is the pure sharding
        # overhead (layout permutation + shard_map wrapping).
        rates["1_sharded"] = round(
            run_at(devs[:1], scene, paths, reps, force_sharded=True), 1
        )

    n_max = str(counts[-1])
    eff = (
        rates[n_max] / (rates["1"] * counts[-1]) if "1" in rates else None
    )
    print(json.dumps({
        "metric": f"scaling_efficiency_{n_max}dev",
        "value": round(eff, 3) if eff is not None else None,
        "unit": "x",
        "vs_baseline": (round(eff / 0.8, 3) if eff is not None else None),
        "rays_per_sec": rates,
        "platform": jax.default_backend(),
        "tris": n_tris,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

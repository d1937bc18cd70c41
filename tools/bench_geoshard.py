"""Geometry-sharded render throughput (parallel.geoshard): primary rays/s with the fused chunk tables physically
sharded over a 'geo' mesh axis, in both table-sharded and full
beyond-HBM (shade_sharded) modes.

On real multi-chip this measures what the cross-shard hit combines
(pmin/psum per bounce) cost on the interconnect vs the replicated-geometry
renderer at the same device count; on one device / the virtual CPU
mesh it smoke-tests the plumbing.

Prints ONE JSON line. Env knobs: GEO_WIDTH/GEO_HEIGHT/GEO_TRIS/
GEO_REPS/GEO_G (geo-axis size, default 2; must divide device count).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def time_render(scene, mesh, shade_sharded, reps: int):
    """(rays/s with tables resident, one-time staging seconds)."""
    import jax

    from rendering_jax.parallel.geoshard import (
        prepare_geo_scene,
        render_scene_geo_sharded,
        stage_geo_prepared,
    )

    st = scene.static.settings
    g = dict(zip(mesh.axis_names, mesh.devices.shape))["geo"]
    t0 = time.perf_counter()
    prep = stage_geo_prepared(
        *prepare_geo_scene(scene, g, shade_sharded), mesh
    )
    jax.block_until_ready(prep[2])
    stage_s = time.perf_counter() - t0

    def once():
        frame3, _aux = render_scene_geo_sharded(
            scene, mesh, shade_sharded=shade_sharded, _prepared=prep
        )
        return frame3

    jax.block_until_ready(once())  # warmup/compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = once()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return (st.width * st.height) / dt, stage_s


def main() -> int:
    from rendering_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from rendering_jax.flagship import build_flagship_scene
    from rendering_jax.parallel.geoshard import make_geo_mesh

    width = int(os.environ.get("GEO_WIDTH", 1920))
    height = int(os.environ.get("GEO_HEIGHT", 1080))
    n_tris = int(os.environ.get("GEO_TRIS", 250_000))
    reps = int(os.environ.get("GEO_REPS", 3))
    ndev = jax.device_count()
    g = int(os.environ.get("GEO_G", 2 if ndev % 2 == 0 else 1))
    assert ndev % g == 0, f"GEO_G={g} must divide {ndev} devices"

    scene = build_flagship_scene(
        width=width, height=height, n_tris=n_tris, enable_ssaa=False,
        settings_overrides=dict(
            geo_shard_axis="geo",
        ),
    )
    mesh = make_geo_mesh(n_geo=g)
    table_sharded, stage_t = time_render(scene, mesh, False, reps)
    shade_sharded, stage_s = time_render(scene, mesh, True, reps)
    print(json.dumps({
        "metric": f"geoshard_fwd_primary_rays_per_sec_g{g}",
        "value": round(shade_sharded, 1),
        "unit": "rays/s",
        "vs_baseline": None,
        "table_sharded_rays_per_sec": round(table_sharded, 1),
        "one_time_staging_seconds": round(stage_s, 3),
        "geo_axis": g,
        "rays_axis": ndev // g,
        "devices": ndev,
        "platform": jax.default_backend(),
        "tris": n_tris,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

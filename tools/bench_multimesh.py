"""On-chip A/B: fused multi-mesh intersection vs the per-mesh
dispatch loop.

Renders the N-mesh bunny-grid stress scene
(flagship.build_multimesh_scene) twice per size — once with the baked
FusedTables (ONE kernel dispatch + one shared pre-cull per ray block)
and once with fusion disabled (fused_itables stripped -> the per-mesh
loop pays N pre-culls + N kernel dispatches per bounce and per batched
shadow query) — and prints one JSON line per configuration.

Usage: python tools/bench_multimesh.py [--sizes 1,4,16] [--reps 3]
       [--width 1920] [--height 1080]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def time_render(scene, reps: int) -> float:
    import jax

    from rendering_jax.render.pipeline import render_scene

    frame, aux = render_scene(scene)  # compile + warmup
    jax.block_until_ready(frame)
    t0 = time.perf_counter()
    for _ in range(reps):
        frame, aux = render_scene(scene)
    jax.block_until_ready(frame)
    return (time.perf_counter() - t0) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,4,16")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tris-per-mesh", type=int, default=None,
                    help="force procedural meshes at this size "
                    "(default: real bunny.obj when assets exist)")
    args = ap.parse_args()

    from rendering_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    from rendering_jax.flagship import build_multimesh_scene

    rays = args.width * args.height
    for n in (int(s) for s in args.sizes.split(",")):
        scene = build_multimesh_scene(
            args.width, args.height, n_meshes=n,
            tris_per_mesh=args.tris_per_mesh,
        )
        tris = sum(ms.n_tris for ms in scene.static.meshes)
        dt_fused = time_render(scene, args.reps)
        out = {
            "n_meshes": n,
            "total_tris": tris,
            "fused": scene.fused_itables is not None,
            "fused_s_per_frame": round(dt_fused, 4),
            "fused_rays_per_sec": round(rays / dt_fused, 1),
        }
        if scene.fused_itables is not None:
            # The per-mesh lane needs the per-mesh kernel tables that
            # multi-mesh builds skip by default (dead weight on the
            # fused path) — rebuild with baking forced, then strip the
            # fused tables so the per-mesh loop runs.
            per_mesh = dataclasses.replace(
                build_multimesh_scene(
                    args.width, args.height, n_meshes=n,
                    tris_per_mesh=args.tris_per_mesh,
                    bake_per_mesh_tables=True,
                ),
                fused_itables=None, fused_shadow_itables=None,
            )
            dt_pm = time_render(per_mesh, args.reps)
            out["per_mesh_s_per_frame"] = round(dt_pm, 4)
            out["per_mesh_rays_per_sec"] = round(rays / dt_pm, 1)
            out["fused_speedup"] = round(dt_pm / dt_fused, 2)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

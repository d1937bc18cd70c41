"""CLI entry — `python -m rendering_jax [scene.scene]`.

Mirrors the reference's `main` (src/main.cpp:5-16): default scene is
`input/simple_shapes.scene`, output is `<image_name>.bmp`. Phase timers
match the reference's Timer names: Total time / Render scene / OBJ
loading (per mesh, models/parser.py), and on the outputProgress strip
path also MSAA / Sobel filter (scene.cpp:544,553 — in the default
render those two phases are deliberately FUSED into the single jitted
render program, one device program per frame; the strip path runs
SSAA as its own program and reports them).
The reference's xdg-open auto-launch is intentionally NOT replicated.
"""

from __future__ import annotations

import argparse
import sys

from rendering_jax.models.scene import load_scene
from rendering_jax.render.pipeline import render
from rendering_jax.utils.bmp import save_bmp
from rendering_jax.utils.compile_cache import enable_compilation_cache
from rendering_jax.utils.stats import RenderStats
from rendering_jax.utils.timer import Timer


def main(argv=None) -> int:
    # Repeat renders of the same scene shapes skip XLA recompiles
    # entirely (persistent on-disk executable cache).
    enable_compilation_cache()
    p = argparse.ArgumentParser(description="Differentiable raytracer")
    p.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    p.add_argument("--output", default=None, help="override output path")
    p.add_argument(
        "--trace-dir", default=None,
        help="capture a jax.profiler device trace of the render phase "
             "into this directory (SURVEY §5.1 device profiling)",
    )
    p.add_argument(
        "--no-shard", action="store_true",
        help="force a single-device render even when multiple "
             "accelerator devices are visible",
    )
    p.add_argument(
        "--geo-shard", type=int, default=0, metavar="G",
        help="shard the GEOMETRY over G devices (scenes beyond one "
             "device's memory): rays shard over the remaining ndev/G "
             "axis; requires G to divide the visible device count. "
             "Nothing O(triangles) is replicated (tables + shading data "
             "each device holds 1/G). Needs the intersection kernel, "
             "which runs on a GPU",
    )
    args = p.parse_args(argv)

    total = Timer("Total time")
    t_load = Timer("Scene loading")
    # Build-time settings: under --geo-shard the cross-shard combines
    # are traced into the bounce loop and every O(T) array stays
    # host-side numpy until shard_map stages each device's shard.
    base_settings = None
    if args.geo_shard:
        from rendering_jax.models.settings import RenderSettings

        base_settings = RenderSettings(geo_shard_axis="geo")
    scene = load_scene(args.scene, base_settings)
    settings = scene.static.settings
    if args.geo_shard:
        from rendering_jax.render.integrator import _pallas_backend

        if not _pallas_backend(settings)[0]:
            p.error("--geo-shard needs the intersection kernel, which "
                    "runs on a GPU")
    t_load.enable_output = settings.enable_output
    total.enable_output = settings.enable_output
    t_load.stop()

    t_render = Timer("Render scene", settings.enable_output)

    def _render():
        # Multiple visible devices: shard rays across all of them — the
        # analogue of the reference defaulting nWorkers to
        # hardware_concurrency (src/scene.cpp:68-70). Output is bitwise
        # identical to the single-device render (tests/test_parallel.py,
        # test_determinism.py). outputProgress keeps working: strips
        # render sharded with the same once-per-second % prints.
        import jax

        if args.geo_shard:
            from rendering_jax.parallel.geoshard import (
                make_geo_mesh,
                render_geo_sharded,
            )

            assert jax.device_count() % args.geo_shard == 0, (
                f"--geo-shard {args.geo_shard} must divide the "
                f"{jax.device_count()} visible devices"
            )
            gmesh = make_geo_mesh(n_geo=args.geo_shard)
            if settings.output_progress and not settings.show_ac:
                from rendering_jax.render.pipeline import (
                    render_with_progress,
                )

                return render_with_progress(scene, mesh=gmesh,
                                             out_u8=True)
            return render_geo_sharded(scene, gmesh, out_u8=True)
        if jax.device_count() > 1 and not args.no_shard:
            from rendering_jax.parallel.shard import (
                make_ray_mesh,
                render_sharded,
            )

            mesh = make_ray_mesh()
            if settings.output_progress and not settings.show_ac:
                from rendering_jax.render.pipeline import (
                    render_with_progress,
                )

                return render_with_progress(scene, mesh=mesh,
                                             out_u8=True)
            # The CLI only writes the frame out: quantize to the BMP
            # writer's u8 codes on device (4x smaller host pull).
            return render_sharded(scene, mesh, out_u8=True)
        if settings.output_progress and not settings.show_ac:
            # outputProgress (src/scene.cpp:486-492): strip-rendered
            # frame with once-per-second percentage prints; the final
            # frame quantizes on device (bit-identical BMP bytes, 4x
            # smaller pull).
            from rendering_jax.render.pipeline import render_with_progress

            return render_with_progress(scene, out_u8=True)
        return render(scene, out_u8=True)

    if args.trace_dir:
        import jax

        from rendering_jax.utils.profiling import trace

        with trace(args.trace_dir):
            frame, aux = _render()
            jax.block_until_ready(aux)
    else:
        frame, aux = _render()
    t_render.stop()

    if settings.collect_statistics:
        rs = RenderStats()
        rs.add_device_counts({k: int(v) for k, v in aux["stats"].items()})
        rs.mesh_count = sum(m.n_tris for m in scene.static.meshes)
        rs.tri_copies_count = sum(m.tri_copies for m in scene.static.meshes)
        rs.ac_count = sum(m.n_real_nodes for m in scene.static.meshes)
        rs.print_stats()

    if settings.image_output:
        out = args.output or (settings.image_name + ".bmp")
        save_bmp(out, frame)
        if settings.enable_output:
            print(f"Successfully wrote to output file {out}")

    total.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

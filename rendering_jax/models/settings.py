"""Render settings — the trace-time (static) configuration.

Replaces the reference's two-tier config (per-scene `Options` object +
11 process-global bools in `namespace options`, include/options.h:9-37)
with ONE frozen dataclass. Every field here is static under jit: it
either changes array shapes (width/height, max_ray_depth) or selects a
different traced program (show_normals, use_ac, ...), so a settings
change triggers a deliberate recompile.

Scene-file keys map onto these fields exactly as the reference parser
dispatches them (src/scene.cpp:146-197).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    # Options class fields (include/options.h:12-19)
    width: int = 800
    height: int = 600
    bias: float = 0.0001
    max_ray_depth: int = 10
    n_workers: int = 32          # parity field (devices are the workers)
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ac_penalty: int = 1
    skybox_names: tuple[str, ...] = ()
    image_name: str = "out"

    # namespace options globals (include/options.h:23-37)
    output_progress: bool = True
    use_backface_culling: bool = True
    collect_statistics: bool = False
    enable_output: bool = True
    image_output: bool = True
    use_ac: bool = True
    show_ac: bool = False
    use_skybox: bool = False
    use_textures: bool = True
    show_normals: bool = False
    enable_ssaa: bool = True

    # Camera (include/scene.h:58)
    fov: float = 60.0

    # --- Extensions (no reference counterpart) ---
    # Max triangles tested per traversal step; BVH leaves are chunked to
    # this size at flatten time so the lockstep traversal is shape-static.
    leaf_chunk: int = 8
    # Paths with throughput below this weight are terminated early.
    # 0.0 = exact Whitted tree to max_ray_depth (reference behaviour).
    min_weight: float = 0.0
    # Without the intersection kernel, meshes up to this many
    # triangles use the dense chunked Moller-Trumbore path
    # (ops/bruteforce*.py) and larger ones the lockstep BVH walk. Same
    # hit results either way.
    bruteforce_threshold: int = 8192
    # Triangles tested per scan step in the dense path.
    tri_chunk: int = 256
    # Evaluate the dense intersection as a bilinear-form matmul
    # (ops/bruteforce_mxu.py) instead of direct Moller-Trumbore.
    use_mxu_intersect: bool = True
    # Use the intersection kernel (ops/pallas_intersect.py: per-tile
    # chunk culling, per-ray running best in registers). Compiled on a
    # GPU; on the CPU only with pallas_interpret, else the jnp paths
    # above.
    use_pallas_intersect: bool = True
    # Run the kernel in Pallas interpret mode on the CPU — a test hook
    # that lets the CPU suite exercise the exact kernel code paths
    # (including the fused multi-mesh oracle). Slow; an error on a GPU.
    pallas_interpret: bool = False
    # By-primitive GEOMETRY sharding (SURVEY section 5.8 stretch goal):
    # when set to a mesh-axis name, the fused chunk tables arrive
    # sharded along the super-chunk axis (each device owns a slice of
    # the scene's triangles), the intersection oracle runs on the
    # local shard, and trace_closest/trace_occlusion combine per-ray
    # results across the axis (all_gather argmin / psum-any). Set only
    # inside parallel.geoshard's shard_map wrapper — scenes render
    # replicated-geometry by default (shotgun-class scenes are << 1GB;
    # this is the beyond-HBM path).
    geo_shard_axis: "str | None" = None
    # Static capacity of the SSAA refinement queue as a fraction of the
    # pixel count. Edge pixels are compacted to this many slots; if the
    # Sobel mask exceeds it, the overflow count is reported host-side.
    ssaa_capacity_fraction: float = 0.25
    # Texture-map filtering: "nearest" reproduces the reference exactly
    # (objects.cpp:144-172 truncating index math); "bilinear" blends the
    # 4 surrounding texels — smooth in-texture gradients for inverse
    # rendering (nearest's UV-space gradient is zero a.e.), at 4x the
    # gather volume. Applies to diffuse/normal/specular maps; the
    # skybox keeps the reference's nearest lookup either way.
    texture_filter: str = "nearest"

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


# scene-file key -> settings field for the [options] block (bool globals
# and scalar options). Handled specially: skyboxes, background_color,
# position, rotation (camera), image_name.
OPTION_KEY_MAP = {
    "outputProgress": ("output_progress", "bool"),
    "useBackfaceCulling": ("use_backface_culling", "bool"),
    "collectStatistics": ("collect_statistics", "bool"),
    "enableOutput": ("enable_output", "bool"),
    "imageOutput": ("image_output", "bool"),
    "useAC": ("use_ac", "bool"),
    "showAC": ("show_ac", "bool"),
    "useSkybox": ("use_skybox", "bool"),
    "useTextures": ("use_textures", "bool"),
    "showNormals": ("show_normals", "bool"),
    "width": ("width", "int"),
    "height": ("height", "int"),
    "fov": ("fov", "float"),
    "n_workers": ("n_workers", "int"),
    "max_ray_depth": ("max_ray_depth", "int"),
    "ac_penalty": ("ac_penalty", "int"),
    "image_name": ("image_name", "str"),
}

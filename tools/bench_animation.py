"""Animation throughput benchmark — frames/s for a camera orbit of the
flagship mesh, sequential vs pipelined (render_frames vs
render_frames_pipelined), f32 vs device-quantized u8 frame pulls.

The reference renders one frame per process (src/main.cpp:5-16), so
there is no reference baseline here; this quantifies the framework's
multi-frame serving capabilities (one compile for the whole orbit,
compute/transfer overlap, 4x smaller u8 pulls).

Prints ONE JSON line:
  {"metric": "animation_fps_<tris>k_<WxH>", "value": <pipelined u8
   fps>, "unit": "frames/s", "seq_f32_fps": ..., "seq_u8_fps": ...,
   "pipelined_u8_fps": ...}

Env knobs: ANIM_TRIS (default 250000), ANIM_WIDTH/ANIM_HEIGHT
(default 1920x1080), ANIM_FRAMES (default 8).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def time_frames(gen_factory, n_frames: int) -> float:
    """Seconds per frame, compile excluded. The warmup pass runs ALL
    frames (not just the first): with SSAA enabled a mid-orbit
    capacity escalation recompiles, and breaking after frame 0 would
    push that recompile into the timed pass and skew the fps."""
    for _ in gen_factory():  # warmup: compiles every shape the orbit hits
        pass
    t0 = time.perf_counter()
    n = 0
    for _frame, _aux in gen_factory():
        n += 1
    dt = time.perf_counter() - t0
    assert n == n_frames
    return dt / n


def main() -> int:
    from rendering_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    width = int(os.environ.get("ANIM_WIDTH", 1920))
    height = int(os.environ.get("ANIM_HEIGHT", 1080))
    n_tris = int(os.environ.get("ANIM_TRIS", 250_000))
    n_frames = int(os.environ.get("ANIM_FRAMES", 8))

    from rendering_jax.flagship import build_flagship_scene
    from rendering_jax.render.animation import (
        orbit_cameras,
        render_frames,
        render_frames_pipelined,
    )

    scene = build_flagship_scene(width=width, height=height,
                                 n_tris=n_tris, enable_ssaa=False)
    cams = orbit_cameras((-0.1, 0.0, -0.6), 3.0, n_frames,
                         elevation_deg=15.0)

    seq_f32 = time_frames(lambda: render_frames(scene, cams), n_frames)
    seq_u8 = time_frames(
        lambda: render_frames(scene, cams, out_u8=True), n_frames
    )
    pip_u8 = time_frames(
        lambda: render_frames_pipelined(scene, cams, out_u8=True), n_frames
    )

    print(json.dumps({
        "metric": f"animation_fps_{n_tris // 1000}k_{width}x{height}",
        "value": round(1.0 / pip_u8, 3),
        "unit": "frames/s",
        "seq_f32_fps": round(1.0 / seq_f32, 3),
        "seq_u8_fps": round(1.0 / seq_u8, 3),
        "pipelined_u8_fps": round(1.0 / pip_u8, 3),
        "n_frames": n_frames,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

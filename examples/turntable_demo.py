"""Turntable animation demo: orbit the camera around a scene and write
one BMP per frame, all frames served by a single compiled render.

Usage:
    python examples/turntable_demo.py [scene.scene] [--frames N]
        [--radius R] [--center x,y,z] [--elevation DEG] [--out DIR]

Defaults orbit the reference's simple_shapes.scene. The first frame
pays the jit compile; every further frame is pure device compute
(the camera is pytree-leaf data — see rendering_jax/render/animation.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--center", default="0,0,-4")
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--out", default="turntable")
    ns = p.parse_args(argv)

    from rendering_jax.models.scene import load_scene
    from rendering_jax.render.animation import orbit_cameras, render_frames
    from rendering_jax.utils.bmp import save_bmp

    scene = load_scene(ns.scene)
    center = tuple(float(v) for v in ns.center.split(","))
    cams = orbit_cameras(center, ns.radius, ns.frames,
                         elevation_deg=ns.elevation)
    os.makedirs(ns.out, exist_ok=True)
    t0 = time.perf_counter()
    for i, (frame, _aux) in enumerate(render_frames(scene, cams)):
        path = os.path.join(ns.out, f"frame_{i:04d}.bmp")
        save_bmp(path, frame)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        print(f"{path}  ({dt:.3f}s{' incl. compile' if i == 0 else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

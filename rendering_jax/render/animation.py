"""Multi-frame rendering: animations and batch serving.

The reference renders exactly one frame per process (src/main.cpp:5-16
constructs a Scene and renders once). Here the camera is two pytree
leaves of SceneData (`cam_pos` (3,), `cam_rmat` (3,3)), so ONE compiled
render serves every frame of an animation: moving the camera changes
array *values*, never trace shapes, and the jit cache is keyed on
structure. Per-frame cost is pure device compute — no retrace, no
recompile (pinned by tests/test_animation.py).

Euler conventions match the reference camera (src/scene.cpp:16-54):
rotation matrix mz*my*mx in degrees, applied to row vectors (v @ R),
forward = (0, 0, -1) @ R.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from rendering_jax.models.objloader import euler_matrix
from rendering_jax.render.integrator import DEFAULT_RAY_BLOCK


def look_at_rotation(pos, target) -> np.ndarray:
    """Euler angles (degrees, roll-free) that aim the reference camera
    at `target` from `pos`: forward (0,0,-1) @ euler_matrix(result)
    equals normalize(target - pos), with the camera kept upright
    (up_y >= 0) wherever that is possible without roll.

    Derivation under the mz*my*mx row-vector convention with rz=0:
    forward = (sin ry, -cos ry * sin rx, -cos ry * cos rx).
    """
    d = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    n = np.linalg.norm(d)
    if n == 0:
        raise ValueError("look_at target coincides with camera position")
    dx, dy, dz = d / n
    h = math.hypot(dy, dz)  # |cos ry|
    if h == 0.0:
        # Looking straight along +-x: pitch is degenerate (gimbal);
        # pick rx = 0.
        return np.array([0.0, math.copysign(90.0, dx), 0.0], np.float64)
    cy = -h if dz > 0 else h  # upright choice: up_y = cos rx >= 0
    rx = math.degrees(math.atan2(-dy / cy, -dz / cy))
    ry = math.degrees(math.atan2(dx, cy))
    return np.array([rx, ry, 0.0], np.float64)


def set_camera(scene, pos, rot_deg=None, *, look_at=None):
    """New SceneData with the camera moved (host-side, cheap). Exactly
    one of `rot_deg` (Euler degrees, reference convention) or `look_at`
    (world-space target point) must be given."""
    if (rot_deg is None) == (look_at is None):
        raise ValueError("pass exactly one of rot_deg / look_at")
    if look_at is not None:
        rot_deg = look_at_rotation(pos, look_at)
    return dataclasses.replace(
        scene,
        cam_pos=jnp.asarray(pos, jnp.float32),
        cam_rmat=jnp.asarray(euler_matrix(rot_deg)),
    )


def orbit_cameras(center, radius: float, n_frames: int, *,
                  elevation_deg: float = 0.0, start_deg: float = 0.0):
    """Turntable path: `n_frames` (pos, rot_deg) pairs on a circle of
    `radius` around `center` at `elevation_deg` above its horizon, each
    aimed at `center`. Feed to `render_frames`."""
    center = np.asarray(center, np.float64)
    el = math.radians(elevation_deg)
    out = []
    for k in range(n_frames):
        th = math.radians(start_deg + 360.0 * k / n_frames)
        pos = center + radius * np.array(
            [math.sin(th) * math.cos(el), math.sin(el),
             math.cos(th) * math.cos(el)]
        )
        out.append((pos, look_at_rotation(pos, center)))
    return out


def render_frames(scene, cameras, *, mesh=None,
                  ray_block: int = DEFAULT_RAY_BLOCK,
                  out_u8: bool = False):
    """Render one frame per (pos, rot_deg) camera. Yields
    ((H, W, 3) numpy frame, aux) lazily so callers can stream frames to
    disk/encoder without holding the whole animation. With `mesh`, each
    frame renders sharded over the device mesh. With `out_u8` frames
    come back as the BMP writer's u8 codes quantized on device (4x
    smaller device->host transfer per frame — the right mode when the
    consumer is a BMP/video encoder).

    Frames reuse one compiled executable — with one caveat: SSAA
    overflow auto-escalation compiles a new refinement capacity the
    first time a frame's Sobel edge count crosses a power-of-two
    boundary above the fraction-derived queue size (bounded, and
    cached for later frames). Animations that must never recompile
    mid-sequence should set ssaa_capacity_fraction=1.0 (exact, no
    escalation) or enable_ssaa=False."""
    from rendering_jax.parallel.shard import render_sharded
    from rendering_jax.render.pipeline import render

    for pos, rot in cameras:
        s = set_camera(scene, pos, rot_deg=rot)
        if mesh is not None:
            yield render_sharded(s, mesh, ray_block=ray_block,
                                 out_u8=out_u8)
        else:
            yield render(s, ray_block=ray_block, out_u8=out_u8)


def render_frames_pipelined(scene, cameras, *, mesh=None,
                            ray_block: int = DEFAULT_RAY_BLOCK,
                            out_u8: bool = False, depth: int = 2):
    """render_frames with up to `depth` frames in flight: frame k+1's
    render is dispatched (JAX dispatch is asynchronous) BEFORE frame
    k's device->host pull, so the chip computes the next frame while
    the host drains the previous one (and the caller encodes/writes
    it). Same outputs as render_frames — when a frame's aux reports an
    SSAA-capacity overflow or dropped transparent paths, that frame is
    redone synchronously through the escalating host wrapper (rare,
    bounded, identical result).

    Per-frame wall-clock becomes max(compute, pull + encode) instead
    of their sum; pair with out_u8=True to shrink the pull itself
    4x."""
    from collections import deque

    from rendering_jax.render.pipeline import render, render_scene

    if mesh is not None:
        from rendering_jax.parallel.shard import _cached_sharded_fn

        def dispatch(s):
            return _cached_sharded_fn(mesh, ray_block, None, 1, out_u8)(s)
    else:
        def dispatch(s):
            return render_scene(s, ray_block=ray_block, out_u8=out_u8)

    st = scene.static.settings
    cap = max(1, int(st.width * st.height * st.ssaa_capacity_fraction))
    if mesh is not None:
        # The sharded SSAA pass pads its refinement capacity up to a
        # multiple of ndev; compare against what it actually refined
        # (an unpadded compare would redo identical frames whenever
        # n_masked lands inside the padding window).
        from rendering_jax.parallel.shard import _pad_to

        cap = _pad_to(cap, mesh.devices.size)

    def finish(s, frame_dev, aux):
        # First host sync for this frame: read the escalation scalars.
        n_masked = int(aux["ssaa_masked"])
        dropped = float(aux["stats"].get("paths_dropped", 0.0))
        overflow = (st.enable_ssaa and not st.show_ac and n_masked > cap)
        if overflow or dropped > 0:
            # Redo through the escalating wrapper (recompiles anyway,
            # so the pipeline gain is lost for this frame only).
            if mesh is not None:
                from rendering_jax.parallel.shard import render_sharded

                return render_sharded(s, mesh, ray_block=ray_block,
                                      out_u8=out_u8)
            return render(s, ray_block=ray_block, out_u8=out_u8)
        frame = np.asarray(frame_dev)
        if not out_u8:
            frame = frame.transpose(1, 2, 0)
        return frame, aux

    pending = deque()
    for pos, rot in cameras:
        # Drain before dispatching so at most `depth` frames are in
        # flight (dispatch-then-pop held depth+1 frames on device,
        # which matters for device-memory budgeting at large frames).
        # depth <= 1 degenerates to fully synchronous (the deque never
        # holds a frame across iterations; popleft only when nonempty).
        if pending and len(pending) >= depth:
            yield finish(*pending.popleft())
        s = set_camera(scene, pos, rot_deg=rot)
        pending.append((s, *dispatch(s)))
    while pending:
        yield finish(*pending.popleft())

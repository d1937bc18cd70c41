"""Multi-frame rendering (render/animation.py): look-at math under the
reference camera convention, frame correctness vs single renders, and
the one-compile-for-all-frames property."""

from __future__ import annotations

import numpy as np
import pytest

from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
from rendering_jax.models.scene import build_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.models.objloader import euler_matrix
from rendering_jax.render.animation import (
    look_at_rotation,
    orbit_cameras,
    render_frames,
    set_camera,
)


def _forward(rot_deg):
    return np.array([0.0, 0.0, -1.0]) @ euler_matrix(rot_deg)


def test_look_at_rotation_points_at_target():
    rng = np.random.default_rng(7)
    pos = np.array([0.3, -0.2, 1.5])
    targets = list(rng.normal(size=(20, 3)) * 3.0) + [
        pos + np.array([0, 0, -2.0]),   # default forward
        pos + np.array([0, 0, 2.0]),    # behind (yaw 180)
        pos + np.array([0, 2.0, 0.01]), # nearly straight up
        pos + np.array([2.0, 0, 0]),    # gimbal case (along +x)
    ]
    for t in targets:
        d = t - pos
        d = d / np.linalg.norm(d)
        rot = look_at_rotation(pos, t)
        f = _forward(rot)
        np.testing.assert_allclose(f, d, atol=1e-5)
        assert rot[2] == 0.0  # roll-free


def test_look_at_keeps_camera_upright():
    # up_y = cos(rx) must be >= 0 for lateral targets (no upside-down
    # frames on a turntable orbit).
    for pos, rot in orbit_cameras((0, 0, -4), 3.0, 12, elevation_deg=25.0):
        up = np.array([0.0, 1.0, 0.0]) @ euler_matrix(rot)
        assert up[1] > 0.0


def _tiny_scene():
    sd = SceneDef(settings=RenderSettings(
        width=48, height=32, enable_ssaa=False, enable_output=False,
        output_progress=False, image_output=False,
    ))
    sd.lights = [LightDef("distant", color=(1, 1, 1), intensity=0.6,
                          dir=(0, -1, -0.3))]
    sphere = ObjectDef("sphere", pos=(0.0, 0.0, -4.0), color=(1, 0.2, 0.2))
    sphere.radius = 1.0
    plane = ObjectDef("plane", pos=(0.0, -1.5, 0.0), color=(1, 1, 1))
    plane.normal = (0, 1, 0)
    sd.objects = [sphere, plane]
    return build_scene(sd)


def test_render_frames_matches_single_renders_and_compiles_once():
    from rendering_jax.render.pipeline import render, render_scene

    scene = _tiny_scene()
    cams = orbit_cameras((0, 0, -4), 3.5, 3, elevation_deg=10.0)

    frames = [f for f, _aux in render_frames(scene, cams)]
    assert len(frames) == 3
    # Each frame equals an independent single render at that camera.
    for (pos, rot), frame in zip(cams, frames):
        ref, _ = render(set_camera(scene, pos, rot_deg=rot))
        np.testing.assert_array_equal(frame, ref)
    # Frames genuinely differ (the orbit moves the sphere highlight).
    assert not np.array_equal(frames[0], frames[1])
    # One compile serves all frames: the camera is pytree-leaf data,
    # so the jit cache must not grow while the animation renders.
    n0 = render_scene._cache_size()
    for _ in render_frames(scene, cams):
        pass
    assert render_scene._cache_size() == n0


def test_render_frames_sharded_matches():
    import jax

    from rendering_jax.parallel.shard import make_ray_mesh

    scene = _tiny_scene()
    cams = orbit_cameras((0, 0, -4), 3.5, 2)
    mesh = make_ray_mesh(jax.devices())
    single = [f for f, _ in render_frames(scene, cams)]
    sharded = [f for f, _ in render_frames(scene, cams, mesh=mesh)]
    for a, b in zip(single, sharded):
        np.testing.assert_array_equal(a, b)


def test_render_frames_out_u8_matches_quantized():
    from rendering_jax.utils.bmp import quantize_reference

    scene = _tiny_scene()
    cams = orbit_cameras((0, 0, -4), 3.5, 2)
    f32_frames = [f for f, _ in render_frames(scene, cams)]
    u8_frames = [f for f, _ in render_frames(scene, cams, out_u8=True)]
    for f32, u8 in zip(f32_frames, u8_frames):
        assert u8.dtype == np.uint8
        np.testing.assert_array_equal(u8, quantize_reference(f32))


def test_render_frames_pipelined_matches():
    """Pipelined frames == sequential frames (single-device and
    sharded), including the u8 mode."""
    import jax

    from rendering_jax.parallel.shard import make_ray_mesh
    from rendering_jax.render.animation import render_frames_pipelined

    scene = _tiny_scene()
    cams = orbit_cameras((0, 0, -4), 3.5, 4)
    seq = [f for f, _ in render_frames(scene, cams)]
    pip = [f for f, _ in render_frames_pipelined(scene, cams)]
    for a, b in zip(seq, pip):
        np.testing.assert_array_equal(a, b)

    mesh = make_ray_mesh(jax.devices())
    pip_sh = [f for f, _ in
              render_frames_pipelined(scene, cams, mesh=mesh, out_u8=True)]
    seq_u8 = [f for f, _ in render_frames(scene, cams, out_u8=True)]
    for a, b in zip(seq_u8, pip_sh):
        np.testing.assert_array_equal(a, b)

    # depth<=1 degenerates to fully synchronous — must not crash on the
    # first frame (the drain-before-dispatch check pops an empty deque
    # unless guarded) and must produce identical frames.
    for depth in (0, 1):
        pip_d = [f for f, _ in
                 render_frames_pipelined(scene, cams, depth=depth)]
        for a, b in zip(seq, pip_d):
            np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_render_frames_pipelined_escalates_ssaa_overflow():
    """A frame whose Sobel mask outgrows the fraction-derived capacity
    must be redone exactly (same pixels as the escalating wrapper)."""
    import dataclasses

    from rendering_jax.render.animation import render_frames_pipelined
    from rendering_jax.render.pipeline import render

    scene = _tiny_scene()
    st = scene.static
    scene = dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(
                enable_ssaa=True, ssaa_capacity_fraction=0.01
            )
        ),
    )
    cams = orbit_cameras((0, 0, -4), 3.5, 2)
    pip = [f for f, _ in render_frames_pipelined(scene, cams)]
    for (pos, rot), frame in zip(cams, pip):
        ref, _ = render(set_camera(scene, pos, rot_deg=rot))
        np.testing.assert_array_equal(frame, ref)

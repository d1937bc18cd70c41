"""Transparent-queue headroom auto-escalation: the reference's
recursion never drops paths (scene.cpp:892-941 recurses unboundedly),
so when the 2^depth continuation tree outgrows one queue slot per
input ray the host wrappers must redo with a bigger queue instead of
weight-dropping."""

from __future__ import annotations

import numpy as np

from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
from rendering_jax.models.scene import build_scene
from rendering_jax.models.settings import RenderSettings


def _glass_heavy_scene(w=32, h=24):
    """A transparent sphere covering most of the small frame: active
    continuation children exceed w*h within a bounce or two."""
    sd = SceneDef(settings=RenderSettings(
        width=w, height=h, enable_ssaa=False, enable_output=False,
        output_progress=False, image_output=False,
        background_color=(0.2, 0.3, 0.4),
    ))
    sd.lights = [LightDef("distant", color=(1, 1, 1), intensity=0.5,
                          dir=(0, -1, -0.3))]
    glass = ObjectDef("sphere", pos=(0.0, 0.0, -3.0), color=(1, 1, 1))
    glass.radius = 1.8
    glass.material = "transparent"
    glass.ior = 1.4
    plane = ObjectDef("plane", pos=(0.0, -2.5, 0.0), color=(1, 0.5, 0.5))
    plane.normal = (0, 1, 0)
    sd.objects = [glass, plane]
    return build_scene(sd)


def test_render_escalates_headroom_until_no_drops():
    from rendering_jax.render.pipeline import render, render_scene

    scene = _glass_heavy_scene()
    # The scene genuinely overflows a headroom-1 queue...
    f1, aux1 = render_scene(scene, queue_headroom=1)
    assert float(aux1["stats"]["paths_dropped"]) > 0
    # ...and the host wrapper escalates until nothing is dropped.
    frame, aux = render(scene)
    assert float(aux["stats"]["paths_dropped"]) == 0.0
    # The escalated result differs from the dropping one: the dropped
    # paths carried radiance.
    assert not np.array_equal(frame.transpose(2, 0, 1), np.asarray(f1))


def test_render_sharded_escalates_headroom(in_workspace):
    import jax

    from rendering_jax.parallel.shard import make_ray_mesh, render_sharded
    from rendering_jax.render.pipeline import render

    scene = _glass_heavy_scene()
    mesh = make_ray_mesh(jax.devices())
    f_single, aux_s = render(scene)
    f_shard, aux = render_sharded(scene, mesh)
    assert float(aux["stats"]["paths_dropped"]) == 0.0
    assert float(aux_s["stats"]["paths_dropped"]) == 0.0
    # Same surviving path set on both sides -> equal up to f32
    # reassociation from the different queue orders.
    np.testing.assert_allclose(f_single, f_shard, atol=2e-6, rtol=3e-4)


def test_progress_and_resumable_escalate(tmp_path):
    from rendering_jax.render.pipeline import (
        render,
        render_resumable,
        render_with_progress,
    )

    scene = _glass_heavy_scene()
    f_ref, _ = render(scene)
    f_prog, aux = render_with_progress(scene, strip_rows=8)
    assert float(aux["stats"]["paths_dropped"]) == 0.0
    np.testing.assert_allclose(f_ref, f_prog, atol=2e-6, rtol=3e-4)
    f_res, _ = render_resumable(
        scene, str(tmp_path / "hr.npz"), strip_rows=8
    )
    np.testing.assert_allclose(f_ref, f_res, atol=2e-6, rtol=3e-4)

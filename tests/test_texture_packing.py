"""Packed map-table sampling (one (7, N) gather for diffuse/normal/
specular sharing texel indices) must match the per-map sample_map path
to a few ULP — it is a gather-batching layout change only
(ops/texture.py::sample_packed, integrator surface_data/object_color/
specular_coefficient). The two paths are separate XLA programs, so
fusion reassociation can flip the last mantissa bits of the shaded
radiance (measured: ~20 of 18k pixels by 1-2 ULP of ~0.5-scale values,
i.e. <= ~1.2e-6); anything beyond that is a real bug."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest


@pytest.mark.golden
@pytest.mark.slow
def test_packed_maps_bitwise_equal_per_map_path(in_workspace):
    import jax.numpy as jnp

    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.render.pipeline import render_scene

    if not os.path.exists("input/objects/cow.obj"):
        pytest.skip("reference assets not mounted")
    scene = load_scene("t03_cow_textured.scene", RenderSettings())
    st = scene.static
    assert st.meshes[0].has_packed_maps, "t03 maps should share dims"
    # Shrink the frame (the equality is per-pixel; 1/8 the rays).
    small = dataclasses.replace(st.settings, width=96, height=64)
    scene = dataclasses.replace(
        scene, static=dataclasses.replace(st, settings=small)
    )

    packed, _ = render_scene(scene)

    unpacked_static = dataclasses.replace(
        scene.static,
        meshes=tuple(
            dataclasses.replace(m, pmap_wh=(0, 0))
            for m in scene.static.meshes
        ),
    )
    unpacked, _ = render_scene(
        dataclasses.replace(scene, static=unpacked_static)
    )
    np.testing.assert_allclose(
        np.asarray(packed), np.asarray(unpacked), rtol=0, atol=1.2e-6
    )
    assert float(jnp.abs(packed).sum()) > 0.0  # non-trivial frame

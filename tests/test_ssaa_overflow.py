"""SSAA capacity overflow auto-escalation: a render whose Sobel edge
mask exceeds the fraction-derived queue capacity must transparently
re-run with a large-enough queue and match the fraction=1.0 result
exactly (capacity used to silently degrade parity on edge-heavy
frames)."""

import dataclasses

import numpy as np
import pytest

from rendering_jax.models.scene import load_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render


def _with(scene, **kw):
    st = scene.static
    return dataclasses.replace(
        scene,
        static=dataclasses.replace(st, settings=st.settings.replace(**kw)),
    )


@pytest.mark.slow
def test_overflow_escalates_to_exact(in_workspace):
    # t01 at low resolution is edge-dense (every sphere silhouette,
    # shadow edge and highlight flips the Sobel mask).
    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _with(scene, width=96, height=64)

    f_exact, aux_exact = render(_with(scene, ssaa_capacity_fraction=1.0))
    n_masked = int(aux_exact["ssaa_masked"])
    cap_small = int(96 * 64 * 0.05)
    assert n_masked > cap_small, "test needs an overflowing mask"

    f_small, aux_small = render(_with(scene, ssaa_capacity_fraction=0.05))
    np.testing.assert_array_equal(f_exact, f_small)


@pytest.mark.slow
def test_sharded_overflow_escalates(in_workspace):
    """render_sharded must auto-escalate like render(): without it, the
    where(mask, refined, frame) select blackens masked pixels past the
    queue capacity (review-found round-2 bug)."""
    import jax

    from rendering_jax.parallel.shard import make_ray_mesh, render_sharded

    mesh = make_ray_mesh(jax.devices())
    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _with(scene, width=96, height=64)

    f_exact, _ = render_sharded(_with(scene, ssaa_capacity_fraction=1.0), mesh)
    f_small, aux = render_sharded(
        _with(scene, ssaa_capacity_fraction=0.05), mesh
    )
    assert int(aux["ssaa_masked"]) > int(96 * 64 * 0.05)
    # <= 1 ulp: the escalated queue capacity changes ray padding/block
    # partitioning, which reorders f32 scatter-add accumulation.
    np.testing.assert_allclose(f_exact, f_small, atol=2.4e-7)

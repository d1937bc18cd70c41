"""Fused multi-mesh intersection (ops.pallas_intersect.FusedTables).

The reference's closest-hit loop visits every object per ray at no
per-object launch cost (src/scene.cpp:724-756); this build fuses
all meshes' chunk tables into ONE kernel dispatch per ray block so
mesh count never multiplies pre-culls or kernel launches
(render.integrator.trace_closest / trace_occlusion fused branches).

These tests run the REAL kernel code path in Pallas interpreter mode
on CPU (RenderSettings.pallas_interpret) and pin it u8-exact against
the default jnp per-mesh path, including the shadow-table exclusion of
transparent meshes (scene.cpp:733-734) and vertex gradients through
the fused geometry gather.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.flagship import build_multimesh_scene, procedural_mesh
from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
from rendering_jax.models.scene import build_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render_scene
from rendering_jax.utils.bmp import quantize_reference


def _two_mesh_scene(transparent_second=False, interpret=False):
    st = RenderSettings(
        width=64, height=48, enable_ssaa=False, enable_output=False,
        output_progress=False, background_color=(0.2, 0.2, 0.25),
        max_ray_depth=3, pallas_interpret=interpret,
    )
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("point", color=(1, 0.9, 0.8), intensity=0.7,
                 pos=(0, 2, -1)),
        LightDef("distant", color=(1, 1, 1), intensity=0.3,
                 dir=(0.2, -1, -0.4)),
    ]
    mesh_a = ObjectDef(
        "mesh", pos=(-0.8, 0.0, -3.0), size=(1.4, 1.4, 1.4),
        color=(0.9, 0.5, 0.3), material="phong", ambient=0.3, diffuse=0.4,
        specular=0.3, n_specular=10.0,
    )
    mesh_a.mesh = procedural_mesh(150, pos=(-0.8, 0.0, -3.0),
                                  size=(1.4, 1.4, 1.4), seed=1)
    mesh_b = ObjectDef(
        "mesh", pos=(0.9, 0.2, -3.5), size=(1.2, 1.2, 1.2),
        color=(1, 1, 1) if transparent_second else (0.3, 0.5, 0.9),
        material="transparent" if transparent_second else "diffuse",
        ior=1.4,
    )
    mesh_b.mesh = procedural_mesh(90, pos=(0.9, 0.2, -3.5),
                                  size=(1.2, 1.2, 1.2), seed=2)
    sd.objects = [
        ObjectDef("plane", pos=(0, -1.5, 0), normal=(0, 1, 0),
                  color=(0.85, 0.85, 0.85)),
        mesh_a,
        mesh_b,
        ObjectDef("sphere", pos=(0.1, 1.0, -4.5), radius=0.6,
                  color=(0.9, 0.3, 0.3)),
    ]
    return build_scene(sd)


def test_fused_tables_baked():
    scene = _two_mesh_scene()
    ft = scene.fused_itables
    assert ft is not None
    # No transparent mesh: the shadow tables alias the closest tables.
    assert scene.fused_shadow_itables is ft
    t_total = sum(ms.n_tris for ms in scene.static.meshes)
    assert ft.t_total == t_total
    assert ft.n_meshes == 2
    # idmap invariants: mesh ids in range, columns within each mesh's
    # global vgeoT range.
    idmap = np.asarray(ft.idmap)
    assert idmap.shape[0] == 2
    t0 = scene.static.meshes[0].n_tris
    for sub, (lo, hi) in enumerate([(0, t0), (t0, t_total)]):
        cols = idmap[1][idmap[0] == sub]
        assert cols.min() >= lo and cols.max() < hi

    s2 = _two_mesh_scene(transparent_second=True)
    # Transparent meshes cast no shadows (scene.cpp:733-734): the
    # shadow tables exclude mesh B.
    assert s2.fused_shadow_itables is not None
    assert s2.fused_shadow_itables is not s2.fused_itables
    assert int(np.asarray(s2.fused_shadow_itables.idmap)[0].max()) == 0


def test_single_mesh_scene_not_fused():
    st = RenderSettings(width=16, height=12, enable_ssaa=False,
                        enable_output=False, output_progress=False)
    sd = SceneDef(settings=st)
    sd.lights = [LightDef("distant", color=(1, 1, 1), intensity=0.5,
                          dir=(0, -1, -1))]
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(1, 1, 1))
    obj.mesh = procedural_mesh(60, pos=(0, 0, -3), size=(1, 1, 1))
    sd.objects = [obj]
    scene = build_scene(sd)
    assert scene.fused_itables is None  # 1-mesh scenes keep the
    # per-mesh path bit-for-bit (zero flagship regression)


@pytest.mark.parametrize("transparent_second", [False, True])
def test_fused_render_matches_per_mesh(transparent_second):
    """Fused interpret-mode kernel render == default jnp per-mesh
    render, u8-exact (covers closest-hit remap, shadow exclusion, and
    with transparent_second the bounce loop + queue compaction over
    fused hits)."""
    ref = _two_mesh_scene(transparent_second)
    fused = _two_mesh_scene(transparent_second, interpret=True)
    f0, _ = render_scene(ref)
    f1, _ = render_scene(fused)
    a = quantize_reference(np.asarray(f0).transpose(1, 2, 0))
    b = quantize_reference(np.asarray(f1).transpose(1, 2, 0))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_fused_render_matches_per_mesh_16():
    """16-mesh grid (the stress shape): fused == per-mesh, u8-exact."""
    ref = build_multimesh_scene(48, 32, n_meshes=16, tris_per_mesh=60)
    st = ref.static
    fused = dataclasses.replace(
        ref,
        static=dataclasses.replace(
            st, settings=st.settings.replace(pallas_interpret=True)
        ),
    )
    assert ref.fused_itables is not None
    f0, _ = render_scene(ref)
    f1, _ = render_scene(fused)
    a = quantize_reference(np.asarray(f0).transpose(1, 2, 0))
    b = quantize_reference(np.asarray(f1).transpose(1, 2, 0))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_fused_grad_matches_per_mesh():
    """Vertex gradients through the fused geometry gather (the
    in-graph vgeoT concatenation) == per-mesh path gradients, for BOTH
    meshes' vertex arrays."""
    ref = _two_mesh_scene()
    fused = _two_mesh_scene(interpret=True)

    def loss(scene, v0, v1):
        m0 = dataclasses.replace(scene.meshes[0], v=v0)
        m1 = dataclasses.replace(scene.meshes[1], v=v1)
        frame3, _ = render_scene(dataclasses.replace(scene, meshes=(m0, m1)))
        wgt = (jnp.arange(frame3.size, dtype=jnp.float32)
               .reshape(frame3.shape) % 7 + 1) / 7.0
        return jnp.sum(frame3 * wgt)

    g_ref = jax.grad(loss, argnums=(1, 2))(
        ref, ref.meshes[0].v, ref.meshes[1].v
    )
    g_fused = jax.grad(loss, argnums=(1, 2))(
        fused, fused.meshes[0].v, fused.meshes[1].v
    )
    for gr, gf in zip(g_ref, g_fused):
        gr = np.asarray(gr)
        gf = np.asarray(gf)
        assert np.all(np.isfinite(gr)) and np.all(np.isfinite(gf))
        assert np.abs(gr).sum() > 0  # connected
        np.testing.assert_allclose(gf, gr, rtol=1e-4, atol=1e-6)

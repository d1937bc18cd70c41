"""Gradient correctness: jax.grad of the rendered image vs central
finite differences of our own forward (BASELINE.json metric: "pixel +
grad allclose"). Hit topology is held fixed by construction
(stop_gradient oracles), so FD at small eps agrees wherever no
silhouette crosses a pixel — we use interior-lit configurations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
from rendering_jax.models.scene import build_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render_scene


def _small_scene(**settings_kw):
    st = RenderSettings(
        width=24, height=18, enable_ssaa=False, enable_output=False,
        output_progress=False, background_color=(0.2, 0.2, 0.25),
        **settings_kw,
    )
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("point", color=(1, 0.9, 0.8), intensity=0.6, pos=(0, 2, -1)),
        LightDef("distant", color=(1, 1, 1), intensity=0.3, dir=(0.2, -1, -0.5)),
    ]
    sd.objects = [
        ObjectDef("plane", pos=(0, -1.5, 0), normal=(0, 1, 0), color=(0.9, 0.9, 0.9)),
        ObjectDef("sphere", pos=(-0.6, 0, -3), radius=0.8, color=(1, 0.2, 0.2),
                  material="phong", ambient=0.4, diffuse=0.1, specular=0.7,
                  n_specular=10.0),
        ObjectDef("sphere", pos=(0.9, 0.2, -4), radius=0.9, color=(1, 1, 1),
                  material="reflective"),
        ObjectDef("sphere", pos=(0.2, -0.4, -2), radius=0.4, color=(1, 1, 1),
                  material="transparent", ior=1.4),
    ]
    return build_scene(sd)


def _loss(scene):
    frame3, _ = render_scene(scene)
    # weighted pixel sum -> scalar (deterministic spatial weighting)
    wgt = (jnp.arange(frame3.size, dtype=jnp.float32).reshape(frame3.shape) % 7 + 1) / 7.0
    return jnp.sum(frame3 * wgt)


def _fd(scene, get, set_, eps):
    base = get(scene)
    lo = set_(scene, base - eps)
    hi = set_(scene, base + eps)
    return (float(_loss(hi)) - float(_loss(lo))) / (2 * eps)


@pytest.mark.parametrize(
    "field,idx,eps",
    [
        ("light_intensity", 0, 1e-3),
        ("obj_color", (1, 0), 1e-3),
        ("sph_pos", (0, 1), 1e-4),
        ("sph_r", 0, 1e-4),
        ("obj_ambient", 1, 1e-3),
        ("bg_color", 1, 1e-3),
    ],
)
def test_grad_matches_fd(field, idx, eps):
    scene = _small_scene()

    if field == "light_intensity":
        def get(s):
            return float(s.lights[idx].intensity)

        def set_(s, v):
            lights = list(s.lights)
            lights[idx] = dataclasses.replace(
                lights[idx], intensity=jnp.asarray(v, jnp.float32)
            )
            return dataclasses.replace(s, lights=tuple(lights))

        def grad_fn(s):
            g = jax.grad(
                lambda li: _loss(set_(s, li))
            )(jnp.asarray(get(s), jnp.float32))
            return float(g)
    else:
        def get(s):
            return float(getattr(s, field)[idx] if idx is not None else getattr(s, field))

        def set_(s, v):
            arr = getattr(s, field)
            arr = arr.at[idx].set(v)
            return dataclasses.replace(s, **{field: arr})

        def grad_fn(s):
            g = jax.grad(lambda v: _loss(set_(s, v)))(
                jnp.asarray(get(s), jnp.float32)
            )
            return float(g)

    g_ad = grad_fn(scene)
    g_fd = _fd(scene, get, set_, eps)
    assert np.isfinite(g_ad)
    # FD through f32 forward is noisy; require agreement to ~2% + abs slack
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.05, atol=0.5)


def test_grad_no_nans_full_tree():
    scene = _small_scene()
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    g = jax.grad(
        lambda s: _loss(s),
        allow_int=True,
    )(scene)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f":
            assert np.all(np.isfinite(arr)), f"non-finite grad at {path}"


def test_grad_mesh_vertex_matches_fd():
    """d(loss)/d(vertex coordinate) via jax.grad vs central FD — guards
    the vT/nT re-derivation in render_scene (pipeline.derive_mesh_tables):
    the build-time transposed tables are unconnected constants, so
    without the in-graph derivation this gradient is silently zero."""
    from rendering_jax.flagship import procedural_mesh

    st = RenderSettings(
        width=24, height=18, enable_ssaa=False, enable_output=False,
        output_progress=False, background_color=(0.2, 0.2, 0.25),
    )
    sd = SceneDef(settings=st)
    # Distant light travelling into the scene: shadow rays leave the
    # mesh toward the camera, so the coarse bumpy test mesh cannot
    # fully self-shadow (which would clamp every lighting term and
    # legitimately zero these gradients).
    sd.lights = [
        LightDef("distant", color=(1, 1, 1), intensity=0.8,
                 dir=(0.1, -0.2, -1.0)),
    ]
    obj = ObjectDef(
        "mesh", pos=(0, 0, -3), size=(1.6, 1.6, 1.6), color=(0.9, 0.5, 0.3),
        material="phong", ambient=0.2, diffuse=0.6, specular=0.3,
        n_specular=10.0,
    )
    obj.mesh = procedural_mesh(200, pos=(0, 0, -3), size=(1.6, 1.6, 1.6))
    sd.objects = [obj]
    scene = build_scene(sd)

    # full-gradient must be connected and finite, then FD-check the
    # single coordinate with the largest magnitude (guaranteed visible)
    def loss_v(v):
        m2 = dataclasses.replace(scene.meshes[0], v=v)
        return _loss(dataclasses.replace(scene, meshes=(m2,)))

    g_full = jax.grad(loss_v)(scene.meshes[0].v)
    assert np.all(np.isfinite(np.asarray(g_full)))
    assert float(jnp.abs(g_full).sum()) > 0.1
    idx = np.unravel_index(int(jnp.argmax(jnp.abs(g_full))), g_full.shape)

    def get(s):
        return float(s.meshes[0].v[idx])

    def set_(s, val):
        m = s.meshes[0]
        m2 = dataclasses.replace(m, v=m.v.at[idx].set(val))
        return dataclasses.replace(s, meshes=(m2,) + s.meshes[1:])

    g_ad = float(g_full[idx])
    g_fd = _fd(scene, get, set_, 2e-4)
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.05, atol=0.05)


def test_grad_mesh_normal_nonzero():
    """Normals are trainable leaves: d(loss)/d(n) must be connected."""
    from rendering_jax.flagship import procedural_mesh

    st = RenderSettings(
        width=16, height=12, enable_ssaa=False, enable_output=False,
        output_progress=False,
    )
    sd = SceneDef(settings=st)
    sd.lights = [LightDef("distant", color=(1, 1, 1), intensity=0.8,
                          dir=(0.1, -0.2, -1.0))]
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(1.6, 1.6, 1.6),
                    color=(1, 1, 1))
    obj.mesh = procedural_mesh(128, pos=(0, 0, -3), size=(1.6, 1.6, 1.6))
    sd.objects = [obj]
    scene = build_scene(sd)

    def loss_n(n):
        m2 = dataclasses.replace(scene.meshes[0], n=n)
        return _loss(dataclasses.replace(scene, meshes=(m2,)))

    g = jax.grad(loss_n)(scene.meshes[0].n)
    assert float(jnp.sum(jnp.abs(g))) > 0.0


def test_euler_matrix_j_has_no_default_precision_matmul():
    """A default-precision f32 matmul may run in TF32 on a GPU; the
    camera-gradient rotation must ask for full f32 explicitly."""
    import jax
    import jax.numpy as jnp

    from rendering_jax.ops.geometry import euler_matrix_j

    jaxpr = jax.make_jaxpr(euler_matrix_j)(jnp.zeros((3,), jnp.float32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "expected the composition as dot_general"
    hi = jax.lax.Precision.HIGHEST
    for e in dots:
        assert e.params["precision"] == (hi, hi), e.params["precision"]


def test_euler_matrix_j_matches_parity_build():
    """ops.geometry.euler_matrix_j (the differentiable rotation used
    for camera/object angle gradients) must agree with the f32-exact
    parity euler_matrix to ~1 ulp and differentiate."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.models.objloader import euler_matrix
    from rendering_jax.ops.geometry import euler_matrix_j

    for rot in [(0, 0, 0), (10, -30, 77), (-50, 0, 0), (123, 45, -9)]:
        np.testing.assert_allclose(
            np.asarray(euler_matrix_j(jnp.asarray(rot, jnp.float32))),
            euler_matrix(rot), atol=2.5e-7,
        )
    g = jax.grad(
        lambda a: jnp.sum(euler_matrix_j(a) * jnp.arange(9.0).reshape(3, 3))
    )(jnp.asarray((10.0, 20.0, 30.0), jnp.float32))
    assert np.isfinite(np.asarray(g)).all() and float(jnp.abs(g).sum()) > 0


def test_sphere_tangency_gradient_finite():
    """A ray EXACTLY tangent to a sphere (d2 == r2, live lane) must
    not feed sqrt'(0) = inf into reverse mode — this killed camera
    pose optimization on t01 (compiled fusion produced exact
    tangencies mid-trajectory that eager rounding never hit). The
    primal is unchanged (thc = 0, grazing hit at t = tca); the
    tangency gradient is treated as 0 like the other measure-zero
    guards."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.ops.geometry import FLT_MAX
    from rendering_jax.ops.intersect import (
        intersect_spheres,
        intersect_spheres_r,
    )

    pos = jnp.asarray([[0.0, 0.0, -3.0]])
    radius = jnp.asarray([1.0])

    def loss_r(ro3):
        rd3 = jnp.asarray([[0.0], [0.0], [-1.0]])
        t = intersect_spheres_r(ro3, rd3, pos, radius)
        return jnp.sum(jnp.where(t < FLT_MAX, t, 0.0))

    ro_tangent = jnp.asarray([[0.0], [1.0], [0.0]])  # d2 == r2 exactly
    t = intersect_spheres_r(ro_tangent,
                            jnp.asarray([[0.0], [0.0], [-1.0]]),
                            pos, radius)
    assert float(t[0, 0]) == 3.0  # grazing hit at t = tca (primal kept)
    g = jax.grad(loss_r)(ro_tangent)
    assert np.isfinite(np.asarray(g)).all(), g

    def loss(ro):
        rd = jnp.asarray([[0.0, 0.0, -1.0]])
        t = intersect_spheres(ro, rd, pos, radius)
        return jnp.sum(jnp.where(t < FLT_MAX, t, 0.0))

    g2 = jax.grad(loss)(jnp.asarray([[0.0, 1.0, 0.0]]))
    assert np.isfinite(np.asarray(g2)).all(), g2


@pytest.mark.parametrize("n_objects", [2, 8, 9])
def test_per_object_lookup_matches_gather(n_objects):
    """Per-object tables read by selects (up to _SELECT_MAX_OBJECTS) give
    the gather's values, misses (obj = -1) included, and its gradients;
    their backward pass holds no scatter-add (a GPU scatter-add sums in
    no fixed order). Past the limit the gather stays."""
    from rendering_jax.render.integrator import (
        _SELECT_MAX_OBJECTS,
        _per_obj,
        _per_obj3,
    )

    rng = np.random.default_rng(n_objects)
    obj = jnp.asarray(rng.integers(-1, n_objects, 257), jnp.int32)
    t1 = jnp.asarray(rng.normal(size=(n_objects,)), jnp.float32)
    t3 = jnp.asarray(rng.normal(size=(n_objects, 3)), jnp.float32)
    w1 = jnp.asarray(rng.normal(size=(257,)), jnp.float32)
    w3 = jnp.asarray(rng.normal(size=(3, 257)), jnp.float32)

    def loss(t1, t3):
        return (jnp.sum(_per_obj(t1, obj, n_objects) * w1)
                + jnp.sum(_per_obj3(t3, obj, n_objects) * w3))

    def loss_gather(t1, t3):
        return jnp.sum(t1[obj] * w1) + jnp.sum(t3.T[:, obj] * w3)

    np.testing.assert_array_equal(_per_obj(t1, obj, n_objects), t1[obj])
    np.testing.assert_array_equal(_per_obj3(t3, obj, n_objects),
                                  t3.T[:, obj])
    got = jax.grad(loss, argnums=(0, 1))(t1, t3)
    want = jax.grad(loss_gather, argnums=(0, 1))(t1, t3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    jaxpr = str(jax.make_jaxpr(jax.grad(loss, argnums=(0, 1)))(t1, t3))
    assert ("scatter-add" in jaxpr) == (n_objects > _SELECT_MAX_OBJECTS)

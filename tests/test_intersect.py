import jax.numpy as jnp
import numpy as np

from rendering_jax.ops.geometry import FLT_MAX
from rendering_jax.ops.intersect import (
    intersect_planes,
    intersect_spheres,
    ray_triangle,
    slab_test,
)


def test_sphere_basic():
    ro = jnp.array([[0.0, 0, 0], [0, 0, 0], [0, 0, 0]])
    rd = jnp.array([[0.0, 0, -1], [0, 0, 1], [0, 1, 0]])
    t = intersect_spheres(ro, rd, jnp.array([[0.0, 0, -5]]), jnp.array([1.0]))
    assert np.isclose(t[0, 0], 4.0)
    assert t[1, 0] == FLT_MAX and t[2, 0] == FLT_MAX


def test_sphere_inside_takes_t1():
    # origin inside the sphere: t0 < 0 -> t1 (objects.cpp:782-785)
    t = intersect_spheres(
        jnp.zeros((1, 3)), jnp.array([[0.0, 0, -1]]),
        jnp.array([[0.0, 0, 0]]), jnp.array([2.0]),
    )
    assert np.isclose(t[0, 0], 2.0)


def test_plane_behind_and_parallel():
    ro = jnp.zeros((2, 3))
    rd = jnp.array([[0.0, -1, 0], [1.0, 0, 0]])
    t = intersect_planes(
        ro, rd, jnp.array([[0.0, -2, 0], [0.0, -2, 0]]),
        jnp.array([[0.0, 1, 0], [0.0, 1, 0]]),
    )
    assert np.isclose(t[0, 0], 2.0)
    assert t[1, 1] == FLT_MAX  # parallel: |denom| < 1e-8


def test_triangle_barycentrics_and_culling():
    v0 = jnp.array([[0.0, 0, -1]])
    v1 = jnp.array([[1.0, 0, -1]])
    v2 = jnp.array([[0.0, 1, -1]])
    ro = jnp.array([[0.2, 0.3, 0.0]])
    rd = jnp.array([[0.0, 0, -1.0]])
    t, u, v, ok = ray_triangle(ro, rd, v0, v1, v2, backface_culling=True)
    assert bool(ok[0]) and np.isclose(t[0], 1.0)
    assert np.isclose(u[0], 0.2) and np.isclose(v[0], 0.3)
    # flip winding -> culled when enabled, hit when disabled
    t2, _, _, ok2 = ray_triangle(ro, rd, v0, v2, v1, backface_culling=True)
    assert not bool(ok2[0])
    t3, _, _, ok3 = ray_triangle(ro, rd, v0, v2, v1, backface_culling=False)
    assert bool(ok3[0])


def test_triangle_outside_bounds():
    v0 = jnp.array([[0.0, 0, -1]])
    v1 = jnp.array([[1.0, 0, -1]])
    v2 = jnp.array([[0.0, 1, -1]])
    rd = jnp.array([[0.0, 0, -1.0]])
    for orig in ([1.2, 0.3, 0], [0.2, -0.1, 0], [0.9, 0.9, 0]):
        _, _, _, ok = ray_triangle(
            jnp.array([orig]), rd, v0, v1, v2, backface_culling=False
        )
        assert not bool(ok[0])


def test_slab_behind_origin_still_hits():
    # Reference intersectBox has no tmax >= 0 check (objects.cpp:534-570):
    # a box entirely behind the ray origin reports HIT.
    ro = jnp.array([[0.0, 0, 0]])
    rd = jnp.array([[0.0, 0, -1]])
    hit, tmin, tmax = slab_test(
        ro, rd, jnp.array([[-1.0, -1, 5]]), jnp.array([[1.0, 1, 6]])
    )
    assert bool(hit[0]) and float(tmax[0]) < 0


def test_slab_miss():
    ro = jnp.array([[0.0, 0, 0]])
    rd = jnp.array([[0.0, 0, -1]])
    hit, _, _ = slab_test(
        ro, rd, jnp.array([[2.0, 2, -6]]), jnp.array([[3.0, 3, -5]])
    )
    assert not bool(hit[0])

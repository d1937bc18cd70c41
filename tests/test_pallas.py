"""Intersection kernel vs the jnp dense oracle.

The kernel (ops/pallas_intersect.py) must return the exact same
discrete hit (triangle id) as ops/bruteforce.bruteforce_mesh in every
configuration: both culling modes, root filter on/off, with/without a
t-limit. Runs in Pallas interpret mode on the CPU; the compiled kernel
is checked on the GPU by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.flagship import build_flagship_scene, procedural_mesh
from rendering_jax.models.parser import ObjectDef, SceneDef
from rendering_jax.models.scene import build_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.ops.bruteforce import bruteforce_mesh
from rendering_jax.ops.pallas_intersect import bruteforce_mesh_pallas


def _rays(r, aim=None, seed=0):
    rng = np.random.default_rng(seed)
    ro = jnp.asarray(rng.normal(0, 2, (r, 3)), jnp.float32)
    rd = jnp.asarray(rng.normal(0, 1, (r, 3)), jnp.float32)
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)
    if aim is not None:
        c = jnp.asarray(aim, jnp.float32)
        at = (c - ro[: r // 2]) / jnp.linalg.norm(
            c - ro[: r // 2], axis=1, keepdims=True
        )
        rd = rd.at[: r // 2].set(at)
    return ro, rd


@pytest.mark.parametrize("backface_culling", [True, False])
@pytest.mark.parametrize("use_root_filter", [True, False])
@pytest.mark.parametrize("with_limit", [True, False])
def test_pallas_matches_dense_oracle(
    backface_culling, use_root_filter, with_limit
):
    scene = build_flagship_scene(width=64, height=32, enable_ssaa=False)
    mesh = scene.meshes[0]
    ro, rd = _rays(777, aim=(-0.1, 0, -0.6))
    t_limit = (
        jnp.asarray(
            np.random.default_rng(1).uniform(0.5, 50, (777,)), jnp.float32
        )
        if with_limit
        else None
    )
    t1, tri1, _, _ = bruteforce_mesh(
        mesh, ro, rd, t_limit,
        backface_culling=backface_culling, use_root_filter=use_root_filter,
    )
    t2, tri2, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, t_limit,
        backface_culling=backface_culling, use_root_filter=use_root_filter,
        interpret=True,
    )
    assert int(jnp.sum(tri1 >= 0)) > 50  # the workload actually hits
    np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))
    both = np.asarray((tri1 >= 0) & (tri2 >= 0))
    np.testing.assert_allclose(
        np.asarray(t1)[both], np.asarray(t2)[both], rtol=2e-5, atol=2e-6
    )


def test_pallas_odd_sizes_and_multi_chunk():
    """Ray counts that don't divide the tile, triangle counts that
    don't divide the chunk, and >1 chunk all round-trip correctly."""
    mesh_arrays = procedural_mesh(700, pos=(0, 0, -3), size=(2, 2, 2))
    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2), color=(1, 1, 1))
    obj.mesh = mesh_arrays
    sd.objects = [obj]
    scene = build_scene(sd)
    mesh = scene.meshes[0]
    ro, rd = _rays(333, aim=(0, 0, -3), seed=7)
    t1, tri1, _, _ = bruteforce_mesh(mesh, ro, rd, tri_chunk=256)
    t2, tri2, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, tri_chunk=256, ray_tile=128, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))


def test_pallas_many_chunks():
    """tri_chunk=16 with 700 tris -> 44 chunks: multi-chunk streaming
    must agree with the jnp dense oracle."""
    mesh_arrays = procedural_mesh(700, pos=(0, 0, -3), size=(2, 2, 2))
    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2), color=(1, 1, 1))
    obj.mesh = mesh_arrays
    sd.objects = [obj]
    scene = build_scene(sd)
    mesh = scene.meshes[0]
    ro, rd = _rays(300, aim=(0, 0, -3), seed=9)
    t1, tri1, _, _ = bruteforce_mesh(mesh, ro, rd, tri_chunk=16)
    t2, tri2, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, tri_chunk=16, ray_tile=128, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))


def test_pallas_anyhit_mode():
    """mode="any" must return occluded (tri >= 0) exactly where the
    closest-hit oracle finds a hit strictly below t_limit — including
    surface-origin rays (the shadow-ray workload it exists for)."""
    scene = build_flagship_scene(width=64, height=32, enable_ssaa=False)
    mesh = scene.meshes[0]
    rng = np.random.default_rng(3)
    # half random rays, half rays from points on the mesh surface
    ro, rd = _rays(400, aim=(-0.1, 0, -0.6), seed=3)
    v = np.asarray(mesh.v)
    idx = rng.integers(0, len(v), 200)
    surf = v[idx].mean(1)
    ro = ro.at[:200].set(jnp.asarray(surf + 1e-4))
    t_limit = jnp.asarray(rng.uniform(0.1, 10.0, (400,)), jnp.float32)

    t_ref, tri_ref, _, _ = bruteforce_mesh(mesh, ro, rd, t_limit)
    _, occ, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, t_limit, mode="any", interpret=True
    )
    np.testing.assert_array_equal(
        np.asarray(tri_ref >= 0), np.asarray(occ >= 0)
    )


def test_pallas_prebuilt_tables_match():
    """Prebuilt tables (scene build) vs in-graph construction: same."""
    from rendering_jax.ops.pallas_intersect import build_intersect_tables

    scene = build_flagship_scene(width=64, height=32, enable_ssaa=False)
    mesh = scene.meshes[0]
    ro, rd = _rays(300, aim=(-0.1, 0, -0.6), seed=5)
    tbl = build_intersect_tables(mesh, tri_chunk=256)
    t1, tri1, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, tri_chunk=256, interpret=True
    )
    t2, tri2, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, tri_chunk=256, tables=tbl, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))
    assert mesh.itables is not None  # scene build bakes tables


def test_pallas_empty_mesh():
    class Empty:
        v = jnp.zeros((0, 3, 3), jnp.float32)

    ro, rd = _rays(64)
    t, tri, bt, tt = bruteforce_mesh_pallas(Empty(), ro, rd)
    assert int(jnp.sum(tri >= 0)) == 0


def test_pallas_rays_row_matches():
    """rays_row=True ((3, R) row inputs — the integrator's bounce-body
    layout) must bit-match the (R, 3) interface in both modes,
    including a ray count that doesn't divide the tile (padding)."""
    scene = build_flagship_scene(width=64, height=32, enable_ssaa=False)
    mesh = scene.meshes[0]
    ro, rd = _rays(333, aim=(-0.1, 0, -0.6), seed=13)
    t_limit = jnp.asarray(
        np.random.default_rng(13).uniform(0.5, 50, (333,)), jnp.float32
    )
    for mode in ("closest", "any"):
        t1, tri1, _, _ = bruteforce_mesh_pallas(
            mesh, ro, rd, t_limit, mode=mode, interpret=True
        )
        t2, tri2, _, _ = bruteforce_mesh_pallas(
            mesh, ro.T, rd.T, t_limit, mode=mode, interpret=True,
            rays_row=True,
        )
        np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


def test_pallas_honest_stats():
    """collect_stats=True returns HONEST device-side counters: far
    fewer Moller-Trumbore evaluations than the dense R*T (a kernel that
    reported R*T unconditionally would pass a weaker check), and
    nothing when the counters are off."""
    scene = build_flagship_scene(width=64, height=32, enable_ssaa=False)
    mesh = scene.meshes[0]
    ro, rd = _rays(512, aim=(-0.1, 0, -0.6), seed=11)
    t, tri, bt, tt = bruteforce_mesh_pallas(
        mesh, ro, rd, interpret=True, collect_stats=True
    )
    R, T = 512, int(mesh.v.shape[0])
    assert int(tt) > 0, "rays hit the mesh, tests must be counted"
    assert int(tt) < R * T // 2, (int(tt), R * T)
    assert int(bt) > 0
    # default: counters off (compiled out)
    _, _, bt0, tt0 = bruteforce_mesh_pallas(mesh, ro, rd, interpret=True)
    assert int(tt0) == 0 and int(bt0) == 0


def test_inverted_pad_boxes_are_culled():
    """Padded cull chunks / supers carry INVERTED boxes [+FMAX, -FMAX].
    The per-axis min/max swap of the slab test would turn an inverted
    box into an everything-box (always live), so both cull sites carry
    an explicit validity test — without it, a small mesh fused at a
    forced n_sub pays n_sub-minus-real zero-triangle Moller-Trumbore
    batches per live super per tile (pure wasted work), and geo-shard
    padding supers add dead grid steps to every tile."""
    from rendering_jax.ops.pallas_intersect import (
        _FMAX, _tile_live_exact, build_intersect_tables,
    )

    # 1. Pre-cull: one real box around the ray path, one inverted box.
    cbox = jnp.asarray(
        [[-1, -1, -5, 1, 1, -3, 0, 0],
         [_FMAX, _FMAX, _FMAX, -_FMAX, -_FMAX, -_FMAX, 0, 0]],
        jnp.float32,
    )
    ro_t = jnp.zeros((1, 3, 4), jnp.float32)
    rd = jnp.tile(jnp.asarray([[0.0], [0.0], [-1.0]], jnp.float32), (1, 4))
    inv_t = (1.0 / rd)[None]
    t0_t = jnp.full((1, 4), _FMAX, jnp.float32)
    live = np.asarray(_tile_live_exact(ro_t, inv_t, t0_t, cbox))
    assert live[0, 0] and not live[0, 1], live

    # 2. In-kernel cull, via the honest stats counters: 20 tris at
    # tri_chunk=16 with a forced n_sub=8 super -> 2 real chunks + 6
    # fully-padded inverted chunks. tri_tests must count the real
    # chunks only (<= R * 2 * tc), not all 8 (= R * 8 * tc).
    mesh_arrays = procedural_mesh(20, pos=(0, 0, -3), size=(2, 2, 2))
    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2), color=(1, 1, 1))
    obj.mesh = mesh_arrays
    sd.objects = [obj]
    scene = build_scene(sd)
    mesh = scene.meshes[0]
    tbl = build_intersect_tables(mesh, tri_chunk=16, n_sub=8)
    assert tbl.cbox.shape[0] == 8 and tbl.sbox.shape[0] == 1
    R = 128
    ro, rd = _rays(R, aim=(0, 0, -3), seed=13)
    t1, tri1, _, _ = bruteforce_mesh(mesh, ro, rd, tri_chunk=16)
    t2, tri2, bt, tt = bruteforce_mesh_pallas(
        mesh, ro, rd, tables=tbl, interpret=True, collect_stats=True
    )
    np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))
    assert 0 < int(tt) <= R * 2 * 16, int(tt)


def test_ray_tile_validation():
    """A ray tile is one Triton block of rays: a power of two of at
    least one warp (32) and at most 4096. Anything else is rejected
    loudly instead of compiling a kernel that drops rays."""
    import pytest

    from rendering_jax.ops.pallas_intersect import check_ray_tile

    scene = build_flagship_scene(width=16, height=8, enable_ssaa=False)
    mesh = scene.meshes[0]
    ro, rd = _rays(64, aim=(-0.1, 0, -0.6), seed=5)
    for bad in (1536, 0, 8192, 96, 16):
        with pytest.raises(ValueError, match="ray_tile"):
            bruteforce_mesh_pallas(
                mesh, ro, rd, interpret=True, ray_tile=bad
            )
    for good in (32, 64, 128, 4096):
        check_ray_tile(good)


def test_root_filter_nan_corner_matches_reference_slab():
    """A ray lying exactly on a reach-box plane with a zero direction
    component makes the slab arithmetic produce 0 * inf = NaN; the
    reference's negated comparisons (objects.cpp:534-570) treat that
    box as crossed. The interval-form filter (max(mins) <= min(maxs))
    NaN-rejected it, silently culling the triangle on the dense and
    Pallas paths while the BVH walk (literal slab_test) accepted it —
    all three paths must agree on the reference semantics."""
    from rendering_jax.models.objloader import MeshArrays
    from rendering_jax.ops.traversal import traverse_bvh

    verts = np.array([[[0, 0, -5], [1, 0, -5], [0, 1, -5]]], np.float32)
    ma = MeshArrays(
        v=verts,
        n=np.zeros((1, 3, 3), np.float32),
        uv=np.zeros((1, 3, 2), np.float32),
        tangent=np.zeros((1, 3), np.float32),
        bitangent=np.zeros((1, 3), np.float32),
        root_bounds=np.array([[0, 0, -6], [2, 2, -4]], np.float32),
    )
    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -5), size=(2, 2, 2), color=(1, 1, 1))
    obj.mesh = ma
    sd.objects = [obj]
    scene = build_scene(sd)
    mesh = scene.meshes[0]

    # reach-box x-lo is exactly 0.0 == ro.x, and rd.x == 0 -> NaN slab.
    ro = jnp.asarray([[0.0, 0.25, 0.0]], jnp.float32)
    rd = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    t_b, tri_b, _, _ = bruteforce_mesh(mesh, ro, rd, use_root_filter=True)
    t_p, tri_p, _, _ = bruteforce_mesh_pallas(
        mesh, ro, rd, use_root_filter=True, interpret=True
    )
    r = traverse_bvh(mesh, ro.reshape(1, 3), rd.reshape(1, 3))
    assert int(tri_b[0]) == 0, "dense path must accept the NaN corner"
    assert int(tri_p[0]) == 0, "Pallas path must accept the NaN corner"
    assert int(r.tri[0]) == 0
    np.testing.assert_allclose(float(t_b[0]), 5.0, rtol=1e-6)
    np.testing.assert_allclose(float(t_p[0]), 5.0, rtol=1e-6)


def test_integrate_empty_batch():
    """integrate()/shade_normals with zero rays return empty/zero
    results instead of dividing by a zero block size."""
    from rendering_jax.render.integrator import integrate, shade_normals

    mesh_arrays = procedural_mesh(100, pos=(0, 0, -3), size=(2, 2, 2))
    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2), color=(1, 1, 1))
    obj.mesh = mesh_arrays
    sd.objects = [obj]
    scene = build_scene(sd)

    ro = jnp.zeros((0, 3), jnp.float32)
    rd = jnp.zeros((0, 3), jnp.float32)
    accum3, stats = integrate(
        scene, ro, rd, jnp.zeros((0,), jnp.int32),
        jnp.zeros((0,), jnp.float32), n_pixels=64,
    )
    assert accum3.shape == (3, 64)
    assert float(jnp.sum(jnp.abs(accum3))) == 0.0
    assert float(stats["rays_casted"]) == 0.0
    assert shade_normals(scene, ro, rd).shape == (3, 0)

import jax.numpy as jnp
import numpy as np

from rendering_jax.accel.bvh import build_bvh
from rendering_jax.models.scene import MeshData
from rendering_jax.ops.geometry import FLT_MAX
from rendering_jax.ops.intersect import ray_triangle
from rendering_jax.ops.traversal import traverse_bvh


def _random_tris(n, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2, 2, (n, 1, 3))
    tris = centers + rng.uniform(-0.3, 0.3, (n, 3, 3))
    return tris.astype(np.float32)


def _mesh_from(tri_v, bounds, **kw):
    bvh = build_bvh(tri_v, bounds, **kw)
    z3 = np.zeros_like(tri_v)
    t_count = len(tri_v)
    return MeshData(
        v=jnp.asarray(tri_v), n=jnp.asarray(z3),
        uv=jnp.zeros((t_count, 3, 2)),
        tangent=jnp.zeros((t_count, 3)), bitangent=jnp.zeros((t_count, 3)),
        vgeoT=jnp.concatenate(
            [jnp.asarray(tri_v.reshape(t_count, 9).T.copy()),
             jnp.zeros((21, t_count))], axis=0),
        reach_lo=jnp.asarray(bvh.reach_lo), reach_hi=jnp.asarray(bvh.reach_hi),
        node_min=jnp.asarray(bvh.node_min), node_max=jnp.asarray(bvh.node_max),
        skip=jnp.asarray(bvh.skip), leaf_start=jnp.asarray(bvh.leaf_start),
        leaf_count=jnp.asarray(bvh.leaf_count), real_flag=jnp.asarray(bvh.real_flag),
        leaf_tris=jnp.asarray(bvh.leaf_tris),
        diffuse_map=None, normal_map=None, specular_map=None,
        leaf_chunk=bvh.leaf_chunk,
    ), bvh


def test_flatten_invariants():
    tri_v = _random_tris(200)
    bounds = np.stack([tri_v.min((0, 1)), tri_v.max((0, 1))])
    _, bvh = _mesh_from(tri_v, bounds, ac_penalty=1, leaf_chunk=8)
    n = bvh.n_nodes
    assert np.all(bvh.skip > np.arange(n))  # skip always jumps forward
    assert np.all(bvh.skip <= n)
    assert np.all(bvh.leaf_count <= 8)
    # every triangle appears in at least one leaf
    covered = set(bvh.leaf_tris[: int(sum(bvh.leaf_count))].tolist())
    leaf_ids = []
    for i in range(n):
        if bvh.leaf_count[i]:
            s, c = bvh.leaf_start[i], bvh.leaf_count[i]
            leaf_ids.extend(bvh.leaf_tris[s : s + c].tolist())
    assert set(leaf_ids) == set(range(200))
    # duplication accounted
    assert bvh.tri_copies == len(leaf_ids)


def test_traversal_matches_bruteforce():
    tri_v = _random_tris(300, seed=1)
    bounds = np.stack([tri_v.min((0, 1)), tri_v.max((0, 1))])
    mesh, _ = _mesh_from(tri_v, bounds, ac_penalty=2, leaf_chunk=8)

    rng = np.random.RandomState(2)
    n_rays = 128
    ro = jnp.asarray(rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32))
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd = jnp.asarray(rd)

    res = traverse_bvh(mesh, ro, rd, backface_culling=False)

    t_all, _, _, ok = ray_triangle(
        ro[:, None, :], rd[:, None, :],
        mesh.v[None, :, 0], mesh.v[None, :, 1], mesh.v[None, :, 2], False,
    )
    t_best = np.asarray(jnp.min(t_all, axis=1))
    got = np.asarray(res.t)
    hit_ref = t_best < FLT_MAX
    hit_got = np.asarray(res.tri) >= 0
    np.testing.assert_array_equal(hit_got, hit_ref)
    np.testing.assert_allclose(got[hit_ref], t_best[hit_ref], rtol=1e-6)


def test_shadow_limit_semantics():
    tri_v = _random_tris(50, seed=3)
    bounds = np.stack([tri_v.min((0, 1)), tri_v.max((0, 1))])
    mesh, _ = _mesh_from(tri_v, bounds, ac_penalty=1, leaf_chunk=4)
    ro = jnp.asarray(np.full((32, 3), -5.0, np.float32))
    rd = jnp.asarray(
        np.tile(np.array([1, 1, 1], np.float32) / np.sqrt(3), (32, 1))
    )
    full = traverse_bvh(mesh, ro, rd, backface_culling=False)
    # limit below the closest hit -> no hit reported
    lim = jnp.where(full.t < FLT_MAX, full.t * 0.99, 1.0)
    res = traverse_bvh(mesh, ro, rd, lim, backface_culling=False)
    assert not np.any(np.asarray(res.tri) >= 0)
    # limit above -> hit again
    lim2 = jnp.where(full.t < FLT_MAX, full.t * 1.01, FLT_MAX)
    res2 = traverse_bvh(mesh, ro, rd, lim2, backface_culling=False)
    np.testing.assert_array_equal(
        np.asarray(res2.tri) >= 0, np.asarray(full.tri) >= 0
    )


def test_leaf_rule_ac_penalty():
    # n_tris <= depth * ac_penalty stops subdivision at the root
    tri_v = _random_tris(5, seed=4)
    bounds = np.stack([tri_v.min((0, 1)), tri_v.max((0, 1))])
    bvh = build_bvh(tri_v, bounds, ac_penalty=5, leaf_chunk=8)
    assert bvh.n_real_nodes == 1
    assert bvh.n_nodes == 1


def test_box_tests_independent_of_leaf_chunking():
    """accelStructTests parity: one reference intersectBox call per
    real node visited (objects.cpp:534-541). Flattening big leaves
    into several chunk nodes shares the parent's box — the counter
    must not scale with leaf_chunk."""
    tri_v = _random_tris(120, seed=3)
    bounds = np.stack([tri_v.min((0, 1)), tri_v.max((0, 1))])
    rng = np.random.RandomState(5)
    ro = jnp.asarray(rng.uniform(-3, 3, (64, 3)), jnp.float32)
    rd = rng.normal(size=(64, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True),
                     jnp.float32)

    counts = []
    for chunk in (4, 32):
        # High penalty -> big leaves -> many chunk nodes at chunk=4.
        mesh, bvh = _mesh_from(tri_v, bounds, ac_penalty=8,
                               leaf_chunk=chunk)
        # prune=False: visit order identical regardless of chunking.
        r = traverse_bvh(mesh, ro, rd, prune=False)
        counts.append(int(r.box_tests))
        # chunking must not change the hits either
        if len(counts) == 2:
            r0 = traverse_bvh(
                _mesh_from(tri_v, bounds, ac_penalty=8, leaf_chunk=4)[0],
                ro, rd, prune=False,
            )
            np.testing.assert_array_equal(
                np.asarray(r0.tri), np.asarray(r.tri)
            )
    assert counts[0] == counts[1]

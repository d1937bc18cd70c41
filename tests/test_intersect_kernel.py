"""Edge cases of the intersection kernel's tile walk (Pallas interpret
mode on the CPU), each against the jnp dense oracle: tiles with no or
every super chunk live, ray counts off the tile, exact ties across
chunks, the any-hit early exit, and the per-tile stats rows. Small
meshes keep every case fast."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.flagship import procedural_mesh
from rendering_jax.ops.bruteforce import bruteforce_mesh
from rendering_jax.ops.pallas_intersect import (
    _tile_live_exact,
    _tile_tables,
    bruteforce_mesh_pallas,
    build_intersect_tables,
)

TILE = 32


def _mesh(n_tris=300, seed=0, tri_chunk=16, n_sub=4):
    """Host mesh view + kernel tables: a bumpy sphere of radius ~1 at
    (0, 0, -3). Its faces point outward (backface culling keeps hits
    from outside and rejects hits from inside)."""
    m = procedural_mesh(n_tris, pos=(0, 0, -3), size=(2, 2, 2), seed=seed)
    v = np.asarray(m.v)
    mesh = types.SimpleNamespace(
        v=jnp.asarray(v), reach_lo=jnp.asarray(v.min(axis=1)),
        reach_hi=jnp.asarray(v.max(axis=1)), morton_perm=None,
    )
    return mesh, build_intersect_tables(mesh, tri_chunk=tri_chunk,
                                        n_sub=n_sub)


def _from_center(r, seed=0):
    """r rays from the sphere's center outward, in all directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = np.tile(np.float32([0, 0, -3]), (r, 1))
    return jnp.asarray(ro), jnp.asarray(d)


def _run(mesh, tb, ro, rd, t_limit=None, **kw):
    kw.setdefault("use_root_filter", False)
    return bruteforce_mesh_pallas(mesh, ro, rd, t_limit, tables=tb,
                                  ray_tile=TILE, interpret=True, **kw)


def _dense(mesh, ro, rd, t_limit=None, **kw):
    return bruteforce_mesh(mesh, ro, rd, t_limit, use_root_filter=False,
                           **kw)


def _counts(tb, ro, rd, t_limit=None):
    r = ro.shape[0]
    n_tiles = -(-r // TILE)
    pad = n_tiles * TILE - r
    t0 = jnp.full((r,), 3.4e38, jnp.float32)
    if t_limit is not None:
        t0 = jnp.minimum(t0, t_limit)
    ro3 = jnp.pad(ro.T, ((0, 0), (0, pad)))
    inv3 = 1.0 / jnp.pad(rd.T, ((0, 0), (0, pad)), constant_values=1.0)
    t0 = jnp.pad(t0, (0, pad), constant_values=-1.0)
    _, counts = _tile_tables(
        ro3.reshape(3, n_tiles, TILE).swapaxes(0, 1),
        inv3.reshape(3, n_tiles, TILE).swapaxes(0, 1),
        t0.reshape(n_tiles, TILE), tb.sbox,
    )
    return np.asarray(counts)


def test_tile_with_no_live_chunk():
    """A tile whose rays all point away from the mesh has an empty live
    list: the program visits nothing and writes misses, while the next
    tile (aimed at the mesh) still intersects."""
    mesh, tb = _mesh()
    away_o = jnp.tile(jnp.float32([[0, 0, 0]]), (TILE, 1))
    away_d = jnp.tile(jnp.float32([[0, 0, 1]]), (TILE, 1))
    rng = np.random.default_rng(1)
    aim_o = jnp.asarray(rng.normal(0, 0.2, (TILE, 3)), jnp.float32)
    aim_d = jnp.asarray([0, 0, -3], jnp.float32) - aim_o
    aim_d = aim_d / jnp.linalg.norm(aim_d, axis=1, keepdims=True)
    ro = jnp.concatenate([away_o, aim_o])
    rd = jnp.concatenate([away_d, aim_d])
    counts = _counts(tb, ro, rd)
    assert counts[0] == 0 and counts[1] > 0, counts
    t, tri, bt, tt = _run(mesh, tb, ro, rd, collect_stats=True)
    _, tri_d, _, _ = _dense(mesh, ro, rd)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(tri_d))
    assert (np.asarray(tri)[:TILE] == -1).all()
    assert (np.asarray(tri)[TILE:] >= 0).all()
    # Only the aimed tile's visits count.
    assert float(bt) == counts[1] * tb.n_sub * TILE


def test_tile_with_every_chunk_live():
    """Rays from the sphere's center in all directions: one tile sees
    every super chunk live, and the walk over all of them equals the
    dense oracle (culling off, so the inside faces are hit)."""
    mesh, tb = _mesh()
    ro, rd = _from_center(TILE, seed=2)
    n_super = tb.sbox.shape[0]
    assert n_super >= 3
    assert _counts(tb, ro, rd)[0] == n_super
    t, tri, _, _ = _run(mesh, tb, ro, rd, backface_culling=False)
    t_d, tri_d, _, _ = _dense(mesh, ro, rd, backface_culling=False)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(tri_d))
    hit = np.asarray(tri) >= 0
    assert hit.mean() > 0.8  # the rest leave through the open poles
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(t_d)[hit],
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_ray_count_not_a_tile_multiple(mode):
    """2 tiles + 1 ray: the padded lanes of the last tile are born
    resolved and sliced off; every real ray, the last one included,
    matches the dense oracle."""
    mesh, tb = _mesh()
    r = 2 * TILE + 1
    rng = np.random.default_rng(3)
    ro = jnp.asarray(rng.normal(0, 0.3, (r, 3)), jnp.float32)
    rd = jnp.asarray([0, 0, -3], jnp.float32) - ro
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)
    t_limit = jnp.asarray(rng.uniform(1.0, 4.0, (r,)), jnp.float32)
    _, tri, _, _ = _run(mesh, tb, ro, rd, t_limit, mode=mode)
    _, tri_d, _, _ = _dense(mesh, ro, rd, t_limit)
    assert tri.shape == (r,)
    if mode == "closest":
        np.testing.assert_array_equal(np.asarray(tri), np.asarray(tri_d))
    else:
        np.testing.assert_array_equal(np.asarray(tri) >= 0,
                                      np.asarray(tri_d) >= 0)
    assert 0 < int(jnp.sum(tri_d >= 0)) < r  # both outcomes occur


def test_exact_tie_across_chunks_takes_lower_id():
    """Two copies of one triangle in different chunks hit at the same
    f32 t: the lower id wins, as in the dense oracle's first-index
    argmin, even though the walk visits the higher id's chunk first
    (its chunk sits nearer the rays' origins)."""
    rng = np.random.default_rng(4)
    far = rng.uniform(-0.2, 0.2, (16, 3, 3)).astype(np.float32)
    far[..., 2] -= 30.0                       # chunk 0: far off-axis bits
    far[..., 0] += 5.0
    near = rng.uniform(-0.2, 0.2, (16, 3, 3)).astype(np.float32)
    near[..., 2] -= 1.0                       # chunk 1: near the origin
    near[..., 0] += 2.0
    tri = np.float32([[-1, -1, -5], [1, -1, -5], [0, 1, -5]])
    far[3] = tri                              # id 3
    near[5] = tri                             # id 21
    v = np.concatenate([far, near])
    mesh = types.SimpleNamespace(
        v=jnp.asarray(v), reach_lo=jnp.asarray(v.min(axis=1)),
        reach_hi=jnp.asarray(v.max(axis=1)), morton_perm=None,
    )
    tb = build_intersect_tables(mesh, tri_chunk=16, n_sub=1)
    ro = jnp.asarray(rng.uniform(-0.3, 0.3, (TILE, 3)) * [1, 1, 0],
                     jnp.float32)
    rd = jnp.tile(jnp.float32([[0, 0, -1]]), (TILE, 1))
    torder, counts = _tile_tables(
        ro.T[None], (1.0 / rd.T)[None], jnp.full((1, TILE), 3e38),
        tb.sbox,
    )
    assert list(np.asarray(torder)[0, :2]) == [1, 0]  # near chunk first
    t, tri_k, _, _ = _run(mesh, tb, ro, rd)
    _, tri_d, _, _ = _dense(mesh, ro, rd)
    assert (np.asarray(tri_d) == 3).all()
    np.testing.assert_array_equal(np.asarray(tri_k), np.asarray(tri_d))
    np.testing.assert_allclose(np.asarray(t), 5.0)


def test_anyhit_early_exit_matches_dense():
    """Shadow rays from just inside the sphere toward a far light: a
    tile whose rays are all occluded by their first chunk leaves the
    walk early (it visits fewer supers than the closest-hit walk of the
    same rays), and every occlusion bit equals the dense oracle's."""
    mesh, tb = _mesh(n_tris=600, seed=5)
    ro, rd = _from_center(4 * TILE, seed=6)
    light = ro + rd * 10.0
    dist = jnp.linalg.norm(light - ro, axis=1)
    _, occ, bt_any, _ = _run(mesh, tb, ro, rd, dist, mode="any",
                             backface_culling=False, collect_stats=True)
    _, tri_c, bt_closest, _ = _run(mesh, tb, ro, rd, dist,
                                   backface_culling=False,
                                   collect_stats=True)
    _, tri_d, _, _ = _dense(mesh, ro, rd, dist, backface_culling=False)
    np.testing.assert_array_equal(np.asarray(occ) >= 0,
                                  np.asarray(tri_d) >= 0)
    np.testing.assert_array_equal(np.asarray(tri_c), np.asarray(tri_d))
    assert (np.asarray(tri_d) >= 0).mean() > 0.8
    assert float(bt_any) < float(bt_closest)


def test_per_tile_stats_sum_to_jnp_counts():
    """Rays from the sphere's center out through its open pole cross
    chunk boxes but hit no triangle, so nothing prunes: box tests are
    n_sub * tile per visited super (the pre-pass counts), and
    Moller-Trumbore tests are tc per (ray, cull chunk) pair whose box
    the ray crosses — both computed here in plain jnp and compared with
    the summed per-tile rows."""
    mesh, tb = _mesh(n_tris=500, seed=7)
    r = 3 * TILE - 5
    rng = np.random.default_rng(8)
    d = np.concatenate([rng.uniform(-0.04, 0.04, (r, 1)), np.ones((r, 1)),
                        rng.uniform(-0.04, 0.04, (r, 1))], axis=1)
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                     jnp.float32)
    ro = jnp.tile(jnp.float32([[0, 0, -3]]), (r, 1))
    _, tri, bt, tt = _run(mesh, tb, ro, rd, collect_stats=True,
                          backface_culling=False)
    assert (np.asarray(tri) == -1).all()
    counts = _counts(tb, ro, rd)
    assert float(bt) == counts.sum() * tb.n_sub * TILE
    # Each ray as its own tile of one against every cull chunk.
    live = _tile_live_exact(
        ro[:, :, None], (1.0 / rd)[:, :, None],
        jnp.full((r, 1), 3.4e38, jnp.float32), tb.cbox,
    )
    expect = int(jnp.sum(live)) * tb.tri_chunk
    assert expect > 0
    assert float(tt) == expect


def test_kernel_vertex_grads_match_plain_oracle():
    """Vertex gradients of a rendered loss with the interpreted kernel
    as the hit oracle (closest and shadow queries) equal those with the
    plain jnp oracle: the kernel only picks the hit triangles, which
    are re-evaluated differentiably either way."""
    import dataclasses

    from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
    from rendering_jax.models.scene import build_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.render.pipeline import render_scene

    def scene_with(**kw):
        st = RenderSettings(width=24, height=16, enable_ssaa=False,
                            enable_output=False, output_progress=False,
                            max_ray_depth=1, **kw)
        sd = SceneDef(settings=st)
        sd.lights = [LightDef("point", color=(1, 1, 1), intensity=0.4,
                              pos=(1, 2, -1))]
        obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2),
                        color=(0.9, 0.6, 0.4), material="phong",
                        ambient=0.3, diffuse=0.5, specular=0.2,
                        n_specular=8.0)
        obj.mesh = procedural_mesh(200, pos=(0, 0, -3), size=(2, 2, 2))
        sd.objects = [ObjectDef("plane", pos=(0, -1.2, 0),
                                normal=(0, 1, 0), color=(1, 1, 1)), obj]
        return build_scene(sd)

    def loss(scene, v):
        m = dataclasses.replace(scene.meshes[0], v=v)
        frame, _ = render_scene(dataclasses.replace(scene, meshes=(m,)))
        w = (jnp.arange(frame.size, dtype=jnp.float32) % 7 + 1) / 7.0
        return jnp.sum(frame * w.reshape(frame.shape))

    kern = scene_with(pallas_interpret=True)
    plain = scene_with(use_pallas_intersect=False)
    g_k = np.asarray(jax.grad(loss, argnums=1)(kern, kern.meshes[0].v))
    g_p = np.asarray(jax.grad(loss, argnums=1)(plain, plain.meshes[0].v))
    assert np.abs(g_p).sum() > 0
    np.testing.assert_allclose(g_k, g_p, rtol=1e-5, atol=1e-7)


def test_pallas_backend_dispatch(monkeypatch):
    """On a GPU the compiled kernel runs, and asking for interpret mode
    there is an error (never a slow path); on the CPU the jnp oracles
    run unless a test asks for the interpreted kernel."""
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.render.integrator import _pallas_backend

    default = RenderSettings()
    interp = RenderSettings(pallas_interpret=True)
    off = RenderSettings(use_pallas_intersect=False)
    assert _pallas_backend(default) == (False, False)
    assert _pallas_backend(interp) == (True, True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _pallas_backend(default) == (True, False)
    assert _pallas_backend(off) == (False, False)
    with pytest.raises(ValueError, match="pallas_interpret"):
        _pallas_backend(interp)

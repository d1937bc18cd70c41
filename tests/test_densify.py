"""densify_mesh (the real-geometry benchmark asset generator) must
produce a CRACK-FREE mesh: mixed subdivision levels get green closure
along level boundaries (_split_bary) and the displacement field is a
pure function of position, so a watertight input stays watertight —
no pinholes for benchmark rays to escape through."""

from __future__ import annotations

import numpy as np

from rendering_jax.flagship import _split_bary, _subdiv_bary, densify_mesh
from rendering_jax.models.objloader import MeshArrays


def _octahedron() -> MeshArrays:
    """Closed watertight octahedron as a triangle soup with smooth
    per-vertex normals, corners bit-shared across faces."""
    p = np.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
         [0, 0, -1]], np.float32,
    )
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    v = np.stack([p[list(f)] for f in faces])  # (8, 3, 3)
    n = v.copy()  # unit sphere normals = positions
    return MeshArrays(
        v=v, n=n, uv=np.zeros((8, 3, 2), np.float32),
        tangent=np.zeros((8, 3), np.float32),
        bitangent=np.zeros((8, 3), np.float32),
        root_bounds=np.stack([p.min(0) - 1, p.max(0) + 1]),
    )


def _edge_counts(v: np.ndarray) -> dict:
    """Count soup edges by quantized endpoint positions."""
    q = np.round(v.astype(np.float64) * (1 << 20)).astype(np.int64)
    counts: dict = {}
    for t in range(q.shape[0]):
        for k in range(3):
            a = q[t, k].tobytes()
            b = q[t, (k + 1) % 3].tobytes()
            key = (min(a, b), max(a, b))
            counts[key] = counts.get(key, 0) + 1
    return counts


def test_split_bary_doubles_marked_boundary_nodes():
    """A marked parent edge must carry 2**(level+1) sub-edges (the
    finer neighbor's boundary resolution); unmarked edges keep
    2**level. Total area is preserved (bisections only)."""
    for level in (0, 1, 2):
        plain = _subdiv_bary(level)
        split = _split_bary(level, (True, False, False))
        # nodes on parent edge opposite corner 0 (weight 0 vanishes)
        def boundary_nodes(bary, k):
            pts = bary.reshape(-1, 3)
            on = pts[np.abs(pts[:, k]) == 0.0]
            return {tuple(x) for x in on}
        assert len(boundary_nodes(split, 0)) == (1 << (level + 1)) + 1
        assert len(boundary_nodes(split, 1)) == (1 << level) + 1
        assert len(boundary_nodes(plain, 0)) == (1 << level) + 1
        # green bisections preserve coverage: areas sum to the parent
        def area_sum(bary):
            # barycentric area of (b0,b1,b2) = |det([b1-b0, b2-b0])|/2
            # in (w1, w2) coordinates
            d1 = bary[:, 1, 1:] - bary[:, 0, 1:]
            d2 = bary[:, 2, 1:] - bary[:, 0, 1:]
            det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
            return float(np.abs(det).sum()) * 0.5
        # the (w1, w2) barycentric domain is the unit right triangle
        np.testing.assert_allclose(area_sum(split), 0.5, rtol=1e-12)


def test_densify_mixed_levels_watertight():
    """Octahedron densified to a target that forces mixed levels (some
    triangles one level deeper) must stay closed: every edge shared by
    exactly 2 triangles. Without green closure the level boundaries
    leave T-junctions (coarse chord counted once, fine halves once
    each)."""
    mesh = _octahedron()
    # 8 tris, target 80: base=1 (8*4=32 <= 80 < 8*16), promote 4 of 8
    out = densify_mesh(mesh, 80, displace_frac=0.02)
    assert out.v.shape[0] > 8 * 4  # promotions actually happened
    counts = _edge_counts(out.v)
    bad = {k: c for k, c in counts.items() if c != 2}
    assert not bad, f"{len(bad)} non-manifold/T-junction edges"


def test_densify_uniform_watertight_and_bounded():
    """Uniform level (promote everything): still watertight, and with
    displace_frac=0 the surface is EXACTLY the input (midpoint
    subdivision of flat faces)."""
    mesh = _octahedron()
    out = densify_mesh(mesh, 8 * 16, displace_frac=0.0)
    assert out.v.shape[0] == 8 * 16
    counts = _edge_counts(out.v)
    assert all(c == 2 for c in counts.values())
    # every subdivided vertex satisfies the octahedron's |x|+|y|+|z|=1
    s = np.abs(out.v.reshape(-1, 3)).sum(axis=1)
    np.testing.assert_allclose(s, 1.0, atol=1e-6)


def test_densify_rays_cannot_escape_level_boundary():
    """End-to-end pinhole probe: fire a dense ray grid at the displaced
    mixed-level octahedron; every ray through the silhouette interior
    must hit (a T-junction crack lets some escape)."""
    from rendering_jax.ops.bruteforce import bruteforce_mesh
    import jax.numpy as jnp
    import types

    mesh = _octahedron()
    out = densify_mesh(mesh, 80, displace_frac=0.02)
    g = np.linspace(-0.4, 0.4, 40, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    ro = np.stack(
        [xx.ravel(), yy.ravel(), np.full(xx.size, 3.0, np.float32)], axis=1
    )
    rd = np.tile(np.asarray([[0, 0, -1]], np.float32), (ro.shape[0], 1))
    m = types.SimpleNamespace(
        v=jnp.asarray(out.v),
        reach_lo=jnp.asarray(out.v.min(axis=1)),
        reach_hi=jnp.asarray(out.v.max(axis=1)),
    )
    t, tri, _, _ = bruteforce_mesh(m, jnp.asarray(ro), jnp.asarray(rd))
    assert int((np.asarray(tri) < 0).sum()) == 0, "rays escaped the mesh"

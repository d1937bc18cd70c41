"""Dense chunked ray-mesh intersection — the plain reference oracle.

Tests ALL triangles against every ray: the direct ops.intersect
.ray_triangle arithmetic with the triangle data broadcast as constants
— no gathers, no divergence. The lockstep BVH walk is gather-bound
(per-ray node/leaf/vertex gathers every step, with the whole ray block
stalled on its longest path), so for small meshes the dense test wins.

Work is O(R*T) instead of O(R*log T). A lax.scan over triangle chunks
keeps peak memory at (R, tri_chunk) while XLA fuses each chunk's
Moller-Trumbore into the running min-reduction.

Semantics: identical accept conditions as the traversal (strict
t < best, reference epsilons); tie-breaking is by global triangle order
(the reference breaks ties by leaf DFS order — differences only occur
for two distinct triangles at the exact same float t).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rendering_jax.ops.geometry import FLT_MAX, pvary_like
from rendering_jax.ops.intersect import ray_triangle


def make_aabb_acceptor(mesh, ro, rd, use_root_filter: bool):
    """Replicates the reference's geometry clipping by its BVH root box.

    The reference's root AABB is pos +- |rotate(size)|/2
    (objects.cpp:328-330) — NOT the true AABB of a rotated mesh, so
    triangles (or parts) outside it are unreachable: a triangle is only
    tested if the ray crosses a leaf box containing it, leaf boxes
    partition the ROOT box, and a triangle belongs to every leaf its
    own AABB overlaps (the vertex-halfspace split rule,
    objects.cpp:737-760). Dense intersection replicates this by
    accepting a triangle only when the ray crosses (tri AABB
    intersected with the root box). With use_ac=0 every reference box
    test is forced true (objects.cpp:536-538) — no filter.

    Returns accept(lo (Tc, 3), hi (Tc, 3)) -> (R, Tc) bool, where lo/hi
    are per-triangle AABBs (clipped or unclipped; clipping to root is
    applied here).
    """
    if not use_root_filter:
        def accept_all(lo, hi):
            return jnp.ones((ro.shape[0], lo.shape[0]), bool)

        return accept_all

    inv = 1.0 / rd  # (R, 3); inf on zero components like the reference

    def accept(lo_c, hi_c):  # (Tc, 3) reach boxes, already inside root
        # LITERAL transcription of intersectBox (objects.cpp:534-570):
        # sign-swap + pairwise running comparisons, no t >= 0 check
        # (behind-origin boxes count as crossed). The interval form
        # (max(mins) <= min(maxs)) is equivalent on real values but
        # NaN-rejects the rd_c == 0 / origin-on-plane IEEE corner the
        # reference accepts; must match slab_test and the Pallas
        # kernel's root filter exactly.
        def tpair(c):
            neg = inv[:, c : c + 1] < 0  # (R, 1)
            lo = jnp.where(neg, hi_c[None, :, c], lo_c[None, :, c])
            hi = jnp.where(neg, lo_c[None, :, c], hi_c[None, :, c])
            return (
                (lo - ro[:, c : c + 1]) * inv[:, c : c + 1],
                (hi - ro[:, c : c + 1]) * inv[:, c : c + 1],
            )

        tmin, tmax = tpair(0)
        tymin, tymax = tpair(1)
        hit = ~((tmin > tymax) | (tymin > tmax))
        tmin = jnp.where(tymin > tmin, tymin, tmin)
        tmax = jnp.where(tymax < tmax, tymax, tmax)
        tzmin, tzmax = tpair(2)
        return hit & ~((tmin > tzmax) | (tzmin > tmax))

    return accept


def bruteforce_mesh(
    mesh,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_limit: jnp.ndarray | None = None,
    *,
    backface_culling: bool = True,
    tri_chunk: int = 512,
    use_root_filter: bool = True,
):
    """Closest hit over all mesh triangles. ro/rd: (R, 3).
    Returns (t, tri, box_tests, tri_tests) like the traversal wrapper;
    t is FLT_MAX (and tri -1) on miss or beyond t_limit."""
    T = int(mesh.v.shape[0])
    R = ro.shape[0]
    if T == 0:
        z = jnp.zeros((), jnp.int32)
        return (
            jnp.full((R,), FLT_MAX, jnp.float32),
            jnp.full((R,), -1, jnp.int32),
            z, z,
        )

    n_chunks = -(-T // tri_chunk)
    pad = n_chunks * tri_chunk - T
    # Pad with copies of triangle 0; the padded lanes are masked out.
    v = jnp.concatenate([mesh.v, jnp.broadcast_to(mesh.v[:1], (pad, 3, 3))])
    v = v.reshape(n_chunks, tri_chunk, 3, 3)

    t0 = jnp.full((R,), FLT_MAX, jnp.float32)
    if t_limit is not None:
        t0 = jnp.minimum(t0, t_limit)

    accept = make_aabb_acceptor(mesh, ro, rd, use_root_filter)

    def body(carry, xs):
        t_best, tri_best = carry
        chunk_v, base, reach = xs  # (Tc, 3, 3), (), ((Tc, 3), (Tc, 3))
        lane = jnp.arange(tri_chunk, dtype=jnp.int32)
        valid = (base + lane) < T
        t, _u, _v, ok = ray_triangle(
            ro[:, None, :], rd[:, None, :],
            chunk_v[None, :, 0], chunk_v[None, :, 1], chunk_v[None, :, 2],
            backface_culling,
        )  # (R, Tc)
        reach_lo_b, reach_hi_b = reach
        ok = (
            ok & valid[None, :] & (t < t_best[:, None])
            & accept(reach_lo_b, reach_hi_b)
        )
        t = jnp.where(ok, t, FLT_MAX)
        lane_min = jnp.argmin(t, axis=1)  # first min = lowest tri id
        any_ok = jnp.any(ok, axis=1)
        t_new = jnp.take_along_axis(t, lane_min[:, None], 1)[:, 0]
        t_best = jnp.where(any_ok, t_new, t_best)
        tri_best = jnp.where(any_ok, base + lane_min, tri_best)
        return (t_best, tri_best), None

    pad_last = lambda a: jnp.concatenate(
        [a, jnp.broadcast_to(a[:1], (pad, 3))]
    ).reshape(n_chunks, tri_chunk, 3)
    reach = (pad_last(mesh.reach_lo), pad_last(mesh.reach_hi))
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * tri_chunk
    init = pvary_like((t0, jnp.full((R,), -1, jnp.int32)), ro, rd)
    (t_best, tri_best), _ = jax.lax.scan(body, init, (v, bases, reach))

    found = tri_best >= 0
    t_best = jnp.where(found, t_best, FLT_MAX)
    # f32 counter: R*T overflows int32 at the sizes the dense scan
    # is asked about in tests (advisor r1); the integrator accumulates
    # all counters in f32 anyway (see integrator._zero_stats).
    tri_tests = jnp.asarray(float(R) * float(T), jnp.float32)
    return t_best, tri_best, jnp.zeros((), jnp.float32), tri_tests

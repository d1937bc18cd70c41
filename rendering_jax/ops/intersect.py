"""Primitive intersection tests, vectorized over ray/primitive batches.

Each function reproduces the float32 semantics of its reference
counterpart (cited per function). Misses return +FLT_MAX so that a
plain first-occurrence argmin over the object axis reproduces the
reference's strict `tNear < best` scene-order tie-breaking
(src/scene.cpp:724-756).
"""

from __future__ import annotations

import jax.numpy as jnp

from rendering_jax.ops.geometry import FLT_MAX, cross_r, dot, dot_r


def intersect_spheres(ro, rd, pos, radius):
    """Geometric ray-sphere test (Sphere::intersectObject,
    src/objects.cpp:774-786). ro/rd: (R, 3); pos: (Ns, 3); radius: (Ns,).
    Returns t: (R, Ns), FLT_MAX on miss."""
    r2 = radius * radius  # r2 = powf(r, 2), scene.cpp:294
    L = pos[None, :, :] - ro[:, None, :]          # (R, Ns, 3)
    tca = jnp.sum(L * rd[:, None, :], axis=-1)    # (R, Ns)
    d2 = jnp.sum(L * L, axis=-1) - tca * tca
    inside = d2 <= r2[None, :]
    # double-where BOTH ways: sqrt(0) has an infinite derivative, so
    # the masked (!inside) lanes are guarded AND an EXACTLY tangent
    # LIVE lane (d2 == r2, which compiled fusion can produce even when
    # eager rounding does not) keeps its primal thc = 0 but routes the
    # gradient through a safe operand — a tangency's t is a kink and
    # its one-sided derivative is treated as 0, like the kernel's
    # other measure-zero guards (ops/shading.py).
    op = jnp.maximum(r2[None, :] - d2, 0.0)
    dead = (~inside) | (op <= 0.0)
    thc = jnp.where(
        dead, jnp.where(inside, 0.0, 1.0),
        jnp.sqrt(jnp.where(dead, 1.0, op)),
    )
    t0 = tca - thc
    t1 = tca + thc
    t0 = jnp.where(t0 < 0, t1, t0)
    ok = inside & (t0 >= 0)
    return jnp.where(ok, t0, FLT_MAX)


def intersect_planes(ro, rd, pos, normal):
    """Ray-plane test (Plane::intersectObject, src/objects.cpp:807-814).
    Returns t: (R, Np), FLT_MAX on miss."""
    denom = jnp.sum(rd[:, None, :] * normal[None, :, :], axis=-1)  # (R, Np)
    ok_denom = jnp.abs(denom) >= 1e-8
    safe = jnp.where(ok_denom, denom, 1.0)
    t = jnp.sum((pos[None, :, :] - ro[:, None, :]) * normal[None, :, :], axis=-1) / safe
    ok = ok_denom & (t >= 0)
    return jnp.where(ok, t, FLT_MAX)


def ray_triangle(ro, rd, v0, v1, v2, backface_culling: bool):
    """Moller-Trumbore (Triangle::rayTriangleIntersect,
    src/objects.cpp:59-95). Broadcasts over leading axes:
    ro/rd: (..., 3); v0/v1/v2: (..., 3).
    Returns (t, u, v, ok); t = FLT_MAX where not ok.

    Epsilon semantics replicated exactly: with culling ON the SIGNED
    det < 1e-8 rejects (objects.cpp:75-77); |det| < 1e-8 always rejects
    (objects.cpp:79); u/v/t bounds are strict as in the reference.
    """
    v0v1 = v1 - v0
    v0v2 = v2 - v0
    pvec = jnp.cross(rd, v0v2)
    det = dot(v0v1, pvec)
    if backface_culling:
        ok = det >= 1e-8
    else:
        ok = jnp.abs(det) >= 1e-8
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    ok = ok & (u >= 0) & (u <= 1)
    qvec = jnp.cross(tvec, v0v1)
    v = dot(rd, qvec) * inv_det
    ok = ok & (v >= 0) & (u + v <= 1)
    t = dot(v0v2, qvec) * inv_det
    ok = ok & (t >= 0)
    return jnp.where(ok, t, FLT_MAX), u, v, ok


def intersect_spheres_r(ro3, rd3, pos, radius):
    """intersect_spheres on rows: ro3/rd3 (3, R); pos (Ns, 3);
    radius (Ns,). Returns t (Ns, R) — rays on the minor axis.
    Same f32 formula sequence as intersect_spheres."""
    r2 = (radius * radius)[:, None]                       # (Ns, 1)
    L = [pos[:, c, None] - ro3[c][None, :] for c in range(3)]  # (Ns, R)
    tca = (L[0] * rd3[0][None, :] + L[1] * rd3[1][None, :]) + (
        L[2] * rd3[2][None, :]
    )
    d2 = ((L[0] * L[0] + L[1] * L[1]) + L[2] * L[2]) - tca * tca
    inside = d2 <= r2
    # double-where BOTH ways — see intersect_spheres (exact-tangency
    # live lanes must not feed sqrt'(0) = inf into reverse mode).
    op = jnp.maximum(r2 - d2, 0.0)
    dead = (~inside) | (op <= 0.0)
    thc = jnp.where(
        dead, jnp.where(inside, 0.0, 1.0),
        jnp.sqrt(jnp.where(dead, 1.0, op)),
    )
    t0 = tca - thc
    t1 = tca + thc
    t0 = jnp.where(t0 < 0, t1, t0)
    ok = inside & (t0 >= 0)
    return jnp.where(ok, t0, FLT_MAX)


def intersect_planes_r(ro3, rd3, pos, normal):
    """intersect_planes on rows: returns t (Np, R)."""
    n = [normal[:, c, None] for c in range(3)]            # (Np, 1)
    denom = (rd3[0][None, :] * n[0] + rd3[1][None, :] * n[1]) + (
        rd3[2][None, :] * n[2]
    )
    ok_denom = jnp.abs(denom) >= 1e-8
    safe = jnp.where(ok_denom, denom, 1.0)
    num = (
        (pos[:, 0, None] - ro3[0][None, :]) * n[0]
        + (pos[:, 1, None] - ro3[1][None, :]) * n[1]
    ) + (pos[:, 2, None] - ro3[2][None, :]) * n[2]
    t = num / safe
    ok = ok_denom & (t >= 0)
    return jnp.where(ok, t, FLT_MAX)


def ray_triangle_r(ro3, rd3, v03, v13, v23, backface_culling: bool):
    """Moller-Trumbore on rows: every vector (3, ...). Same f32
    formula sequence as ray_triangle (same epsilons/strictness).
    Returns (t, u, v, ok) each (...,)."""
    v0v1 = v13 - v03
    v0v2 = v23 - v03
    pvec = cross_r(rd3, v0v2)
    det = dot_r(v0v1, pvec)
    if backface_culling:
        ok = det >= 1e-8
    else:
        ok = jnp.abs(det) >= 1e-8
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = ro3 - v03
    u = dot_r(tvec, pvec) * inv_det
    ok = ok & (u >= 0) & (u <= 1)
    qvec = cross_r(tvec, v0v1)
    v = dot_r(rd3, qvec) * inv_det
    ok = ok & (v >= 0) & (u + v <= 1)
    t = dot_r(v0v2, qvec) * inv_det
    ok = ok & (t >= 0)
    return jnp.where(ok, t, FLT_MAX), u, v, ok


def slab_test(ro, rd, bmin, bmax):
    """AABB slab test (AccelerationStructure::intersectBox,
    src/objects.cpp:534-570), literal transcription so IEEE inf/nan
    corner cases match. Returns (hit, tmin, tmax) — hit is the
    reference's boolean; tmin/tmax support ordered-traversal pruning.
    Note the reference does NOT reject boxes entirely behind the origin
    (no tmax >= 0 check); `hit` reproduces that."""
    inv = 1.0 / rd
    neg = inv < 0
    lo = jnp.where(neg, bmax, bmin)
    hi = jnp.where(neg, bmin, bmax)
    tmin = (lo[..., 0] - ro[..., 0]) * inv[..., 0]
    tmax = (hi[..., 0] - ro[..., 0]) * inv[..., 0]
    tymin = (lo[..., 1] - ro[..., 1]) * inv[..., 1]
    tymax = (hi[..., 1] - ro[..., 1]) * inv[..., 1]
    hit = ~((tmin > tymax) | (tymin > tmax))
    tmin = jnp.where(tymin > tmin, tymin, tmin)
    tmax = jnp.where(tymax < tmax, tymax, tmax)
    tzmin = (lo[..., 2] - ro[..., 2]) * inv[..., 2]
    tzmax = (hi[..., 2] - ro[..., 2]) * inv[..., 2]
    hit = hit & ~((tmin > tzmax) | (tzmin > tmax))
    tmin = jnp.where(tzmin > tmin, tzmin, tmin)
    tmax = jnp.where(tzmax < tmax, tzmax, tmax)
    return hit, tmin, tmax

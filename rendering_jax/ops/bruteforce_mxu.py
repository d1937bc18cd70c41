"""Matmul-formulated dense ray-mesh intersection.

Moller-Trumbore decomposes into scalar triple products that are
BILINEAR in (ray origin, ray direction):

    det     = -rd . N                      N  = e1 x e2
    t * det =  ro . N - v0 . N
    u * det = (rd x e2) . (ro - v0) = sum of rd_i*ro_j and rd_i terms
    v * det = ((ro - v0) x e1) . rd = sum of rd_i*ro_j and rd_i terms

so for a 13-feature vector per ray
    F = [1, ro, rd, rd_y*ro_x, rd_z*ro_x, rd_z*ro_y,
               rd_x*ro_y, rd_x*ro_z, rd_y*ro_z]
all four quantities for ALL triangles are ONE matmul F @ C with a
per-triangle coefficient table C (13, 4T) precomputed from the vertex
positions; only the cheap accept/min epilogue is elementwise (vs ~45
elementwise flops per (ray, tri) for the direct form). The product
runs at HIGHEST precision (full f32), outside the tensor cores on a
GPU.

Accept conditions match the reference exactly in infinite precision
(same epsilons/strictness as ops/intersect.ray_triangle); the bilinear
evaluation order differs in f32 rounding, which can flip grazing hits —
the same class of divergence the golden tests already tolerate, and the
differentiable re-evaluation in the integrator recomputes the accepted
hit with the reference formula anyway.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rendering_jax.ops.geometry import FLT_MAX, pvary_like

HIGH = jax.lax.Precision.HIGHEST


def mt_coefficients(v: jnp.ndarray) -> jnp.ndarray:
    """Per-triangle bilinear coefficient table from v (T, 3, 3).
    Returns (13, T, 4) with the last axis = (det, tdet, udet, vdet)."""
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    n = jnp.cross(e1, e2)  # (T, 3)
    t_count = v.shape[0]
    z = jnp.zeros((t_count,), v.dtype)

    # feature order: [1, ro_x, ro_y, ro_z, rd_x, rd_y, rd_z,
    #                 rd_y*ro_x, rd_z*ro_x, rd_z*ro_y,
    #                 rd_x*ro_y, rd_x*ro_z, rd_y*ro_z]
    def col(const, ro_c, rd_c, cross_c):
        return jnp.stack(
            [const, ro_c[0], ro_c[1], ro_c[2], rd_c[0], rd_c[1], rd_c[2],
             cross_c[0], cross_c[1], cross_c[2], cross_c[3], cross_c[4],
             cross_c[5]],
            axis=0,
        )  # (13, T)

    # det = -rd.N
    det_c = col(z, (z, z, z), (-n[:, 0], -n[:, 1], -n[:, 2]),
                (z, z, z, z, z, z))
    # tdet = ro.N - v0.N
    v0n = jnp.sum(v0 * n, axis=1)
    tdet_c = col(-v0n, (n[:, 0], n[:, 1], n[:, 2]), (z, z, z),
                 (z, z, z, z, z, z))
    # udet = (rd x e2).(ro - v0)
    #      = rd_y*ro_x*e2z - rd_z*ro_x*e2y + rd_z*ro_y*e2x - rd_x*ro_y*e2z
    #      + rd_x*ro_z*e2y - rd_y*ro_z*e2x + rd.(v0 x e2)
    v0xe2 = jnp.cross(v0, e2)
    udet_c = col(
        z, (z, z, z), (v0xe2[:, 0], v0xe2[:, 1], v0xe2[:, 2]),
        (e2[:, 2], -e2[:, 1], e2[:, 0], -e2[:, 2], e2[:, 1], -e2[:, 0]),
    )
    # vdet = ((ro - v0) x e1).rd = (ro x e1).rd - (v0 x e1).rd
    #      = -[rd_y*ro_x*e1z - rd_z*ro_x*e1y + rd_z*ro_y*e1x
    #          - rd_x*ro_y*e1z + rd_x*ro_z*e1y - rd_y*ro_z*e1x]
    #        ... careful: (ro x e1).rd = det3(ro, e1, rd) = -det3(rd, e1, ro)
    # det3(a, b, c) = a.(b x c); (ro x e1).rd = rd.(ro x e1)
    # rd.(ro x e1) = rd_x(ro_y e1z - ro_z e1y) + rd_y(ro_z e1x - ro_x e1z)
    #              + rd_z(ro_x e1y - ro_y e1x)
    e1xv0 = jnp.cross(e1, v0)
    vdet_c = col(
        z, (z, z, z), (e1xv0[:, 0], e1xv0[:, 1], e1xv0[:, 2]),
        (-e1[:, 2], e1[:, 1], -e1[:, 0], e1[:, 2], -e1[:, 1], e1[:, 0]),
    )
    return jnp.stack([det_c, tdet_c, udet_c, vdet_c], axis=-1)  # (13, T, 4)


def ray_features(ro: jnp.ndarray, rd: jnp.ndarray) -> jnp.ndarray:
    """(B, 3) x2 -> (B, 13) feature matrix."""
    one = jnp.ones((ro.shape[0],), ro.dtype)
    return jnp.stack(
        [one, ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2],
         rd[:, 1] * ro[:, 0], rd[:, 2] * ro[:, 0], rd[:, 2] * ro[:, 1],
         rd[:, 0] * ro[:, 1], rd[:, 0] * ro[:, 2], rd[:, 1] * ro[:, 2]],
        axis=-1,
    )


def bruteforce_mesh_mxu(
    mesh,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_limit: jnp.ndarray | None = None,
    *,
    backface_culling: bool = True,
    tri_chunk: int = 512,
    use_root_filter: bool = True,
):
    """Closest hit over all mesh triangles via the matmul bilinear form.
    Interface identical to ops.bruteforce.bruteforce_mesh."""
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
    v = jnp.concatenate([mesh.v, jnp.broadcast_to(mesh.v[:1], (pad, 3, 3))])
    coef = mt_coefficients(v)  # (13, Tp, 4)
    # chunked as (n_chunks, 13, 4*Tc): columns grouped per quantity so
    # epilogue slices are (B, Tc) with a large minor dim.
    coef = (
        coef.reshape(13, n_chunks, tri_chunk, 4)
        .transpose(1, 0, 3, 2)
        .reshape(n_chunks, 13, 4 * tri_chunk)
    )

    feats = ray_features(ro, rd)  # (R, 13)

    t0 = jnp.full((R,), FLT_MAX, jnp.float32)
    if t_limit is not None:
        t0 = jnp.minimum(t0, t_limit)

    from rendering_jax.ops.bruteforce import make_aabb_acceptor

    accept = make_aabb_acceptor(mesh, ro, rd, use_root_filter)
    pad_last = lambda a: jnp.concatenate(
        [a, jnp.broadcast_to(a[:1], (pad, 3))]
    ).reshape(n_chunks, tri_chunk, 3)
    aabb_lo = pad_last(mesh.reach_lo)
    aabb_hi = pad_last(mesh.reach_hi)

    def body(carry, xs):
        t_best, tri_best = carry
        chunk_c, base, lo_b, hi_b = xs  # (13, 4*Tc), (), (Tc, 3), (Tc, 3)
        out = jnp.dot(feats, chunk_c, precision=HIGH)  # (R, 4*Tc)
        det = out[:, 0 * tri_chunk : 1 * tri_chunk]
        tdet = out[:, 1 * tri_chunk : 2 * tri_chunk]
        udet = out[:, 2 * tri_chunk : 3 * tri_chunk]
        vdet = out[:, 3 * tri_chunk : 4 * tri_chunk]

        if backface_culling:
            ok = det >= 1e-8
        else:
            ok = jnp.abs(det) >= 1e-8
        inv = 1.0 / jnp.where(ok, det, 1.0)
        u = udet * inv
        vq = vdet * inv
        t = tdet * inv
        ok = ok & (u >= 0) & (u <= 1) & (vq >= 0) & (u + vq <= 1) & (t >= 0)

        lane = jnp.arange(tri_chunk, dtype=jnp.int32)
        ok = (
            ok & ((base + lane) < T)[None, :] & (t < t_best[:, None])
            & accept(lo_b, hi_b)
        )
        t = jnp.where(ok, t, FLT_MAX)
        lane_min = jnp.argmin(t, axis=1)
        any_ok = jnp.any(ok, axis=1)
        t_new = jnp.take_along_axis(t, lane_min[:, None], 1)[:, 0]
        t_best = jnp.where(any_ok, t_new, t_best)
        tri_best = jnp.where(any_ok, base + lane_min, tri_best)
        return (t_best, tri_best), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * tri_chunk
    init = pvary_like((t0, jnp.full((R,), -1, jnp.int32)), ro, rd)
    (t_best, tri_best), _ = jax.lax.scan(
        body, init, (coef, bases, aabb_lo, aabb_hi)
    )

    found = tri_best >= 0
    t_best = jnp.where(found, t_best, FLT_MAX)
    # f32 counter: R*T overflows int32 at the sizes the dense scan
    # is asked about in tests (advisor r1); the integrator accumulates
    # all counters in f32 anyway (see integrator._zero_stats).
    tri_tests = jnp.asarray(float(R) * float(T), jnp.float32)
    return t_best, tri_best, jnp.zeros((), jnp.float32), tri_tests

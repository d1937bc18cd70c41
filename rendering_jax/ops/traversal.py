"""Lockstep threaded-BVH traversal over a ray batch (pure jnp version).

A data-parallel redesign of the reference's recursive pointer-chasing
`AccelerationStructure::intersectAccelStruct` (src/objects.cpp:587-631):
the tree is flattened DFS left-first at build time (accel/bvh.py); every
ray keeps a cursor into the node array. One `lax.while_loop` steps all
rays together: AABB hit -> advance to i+1 (first child / leaf chunk),
miss -> jump to skip[i]. Leaves are fixed-size chunks of <= K triangles
tested with a vectorized Moller-Trumbore, so every step has static
shape. The loop exits when every cursor has walked off the end.

Correctness vs the reference:
* DFS left-first + strict `t < t_best` + first-occurrence argmin inside
  a chunk reproduces the reference's tie-breaking (left subtree first,
  in-leaf iteration order, objects.cpp:605-630).
* Optional pruning (skip subtree when box tmin > t_best or box fully
  behind the origin) only skips subtrees that cannot produce an
  accepted hit (the reference rejects t < 0 triangles anyway), so the
  result is identical while doing strictly less work than the
  reference's unpruned descent.
* `use_ac=False` forces every box test to hit, reproducing the
  reference's brute-force-through-the-tree mode (objects.cpp:536-538).

This function is an oracle for DISCRETE hit info (triangle id); it runs
under stop_gradient in the integrator and hits are re-evaluated
differentiably afterwards (see render/integrator.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rendering_jax.ops.geometry import FLT_MAX, pvary_like
from rendering_jax.ops.intersect import ray_triangle, slab_test


class TraversalResult(NamedTuple):
    t: jnp.ndarray        # (R,) closest hit t, FLT_MAX on miss
    tri: jnp.ndarray      # (R,) i32 triangle id, -1 on miss
    u: jnp.ndarray        # (R,)
    v: jnp.ndarray        # (R,)
    box_tests: jnp.ndarray  # () i32 — accelStructTests analogue
    tri_tests: jnp.ndarray  # () i32 — rayTriTests analogue


def traverse_bvh(
    mesh,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_limit: jnp.ndarray | None = None,
    *,
    backface_culling: bool = True,
    use_ac: bool = True,
    prune: bool = True,
) -> TraversalResult:
    """mesh: MeshData pytree with node_min/node_max/skip/leaf_start/
    leaf_count/leaf_tris and v (T, 3, 3). ro/rd: (R, 3).
    t_limit: optional (R,) — prune hits beyond it (shadow rays)."""
    n_nodes = int(mesh.node_min.shape[0])
    K = int(mesh.leaf_chunk) if hasattr(mesh, "leaf_chunk") else 8
    R = ro.shape[0]

    t0 = jnp.full((R,), FLT_MAX, jnp.float32)
    if t_limit is not None and prune:
        t0 = jnp.minimum(t0, t_limit)

    if n_nodes == 0:
        z = jnp.zeros((), jnp.int32)
        # FLT_MAX, not the t_limit-clamped t0: the no-hit contract
        # (callers test t < FLT_MAX) must hold for empty meshes too.
        return TraversalResult(
            jnp.full((R,), FLT_MAX, jnp.float32),
            jnp.full((R,), -1, jnp.int32), jnp.zeros((R,)), jnp.zeros((R,)),
            z, z,
        )

    karange = jnp.arange(K, dtype=jnp.int32)

    def cond(state):
        cur = state[0]
        return jnp.any(cur < n_nodes)

    def body(state):
        cur, t_best, tri_best, u_best, v_best, box_ct, tri_ct = state
        active = cur < n_nodes
        node = jnp.clip(cur, 0, n_nodes - 1)

        bmin = mesh.node_min[node]  # (R, 3) gather
        bmax = mesh.node_max[node]
        box_hit, tmin, tmax = slab_test(ro, rd, bmin, bmax)
        if not use_ac:
            box_hit = jnp.ones_like(box_hit)
        descend = box_hit & active
        if prune:
            # Conservative: NaN comparisons are False, so NaN lanes never
            # get extra skips relative to the reference.
            descend = descend & ~((tmax < 0) | (tmin > t_best))

        cnt = mesh.leaf_count[node]          # (R,)
        start = mesh.leaf_start[node]        # (R,)
        is_leaf_hit = descend & (cnt > 0)

        idx = start[:, None] + karange[None, :]          # (R, K)
        tri_ids = mesh.leaf_tris[idx]                    # (R, K)
        lane_ok = (karange[None, :] < cnt[:, None]) & is_leaf_hit[:, None]
        safe_ids = jnp.where(lane_ok, tri_ids, 0)
        tv = mesh.v[safe_ids]                            # (R, K, 3, 3)
        t, u, v, ok = ray_triangle(
            ro[:, None, :], rd[:, None, :], tv[:, :, 0], tv[:, :, 1], tv[:, :, 2],
            backface_culling,
        )
        ok = ok & lane_ok & (t < t_best[:, None])
        t = jnp.where(ok, t, FLT_MAX)
        lane = jnp.argmin(t, axis=1)                     # first min wins ties
        any_ok = jnp.any(ok, axis=1)
        t_new = jnp.take_along_axis(t, lane[:, None], 1)[:, 0]
        tri_new = jnp.take_along_axis(safe_ids, lane[:, None], 1)[:, 0]
        u_new = jnp.take_along_axis(u, lane[:, None], 1)[:, 0]
        v_new = jnp.take_along_axis(v, lane[:, None], 1)[:, 0]

        t_best = jnp.where(any_ok, t_new, t_best)
        tri_best = jnp.where(any_ok, tri_new.astype(jnp.int32), tri_best)
        u_best = jnp.where(any_ok, u_new, u_best)
        v_best = jnp.where(any_ok, v_new, v_best)

        nxt = jnp.where(descend, cur + 1, mesh.skip[node].astype(jnp.int32))
        cur = jnp.where(active, nxt, cur)

        # One reference intersectBox call per REAL node visited
        # (objects.cpp:541): leaf-chunk nodes share their parent's box
        # and must not inflate the accelStructTests analogue.
        box_ct = box_ct + jnp.sum(
            (active & (mesh.real_flag[node] > 0)).astype(jnp.int32)
        ) * (1 if use_ac else 0)
        tri_ct = tri_ct + jnp.sum(lane_ok.astype(jnp.int32))
        return cur, t_best, tri_best, u_best, v_best, box_ct, tri_ct

    init = (
        jnp.zeros((R,), jnp.int32),
        t0,
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
    )
    init = pvary_like(init, ro, rd, *( (t_limit,) if t_limit is not None else () ))
    cur, t_best, tri_best, u_best, v_best, box_ct, tri_ct = jax.lax.while_loop(
        cond, body, init
    )
    if t_limit is not None and prune:
        # Restore FLT_MAX for "no hit within limit" so callers comparing
        # against the limit see the same boolean as the reference.
        t_best = jnp.where(tri_best >= 0, t_best, FLT_MAX)
    return TraversalResult(t_best, tri_best, u_best, v_best, box_ct, tri_ct)


def count_ac_nodes(mesh, ro: jnp.ndarray, rd: jnp.ndarray, *, use_ac: bool = True):
    """showAC heatmap oracle — `AccelerationStructure::recCountAC`
    (src/objects.cpp:572-585): count nodes whose AABB is hit, visiting a
    node only if all its ancestors' boxes were hit. No t-pruning (the
    reference has none here) and behind-origin boxes count as hits,
    matching intersectBox. Returns (R,) i32 counts."""
    n_nodes = int(mesh.node_min.shape[0])
    R = ro.shape[0]
    if n_nodes == 0:
        return jnp.zeros((R,), jnp.int32)

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        cur, count = state
        active = cur < n_nodes
        node = jnp.clip(cur, 0, n_nodes - 1)
        box_hit, _, _ = slab_test(ro, rd, mesh.node_min[node], mesh.node_max[node])
        if not use_ac:
            box_hit = jnp.ones_like(box_hit)
        descend = box_hit & active
        count = count + (descend & (mesh.real_flag[node] > 0)).astype(jnp.int32)
        nxt = jnp.where(descend, cur + 1, mesh.skip[node].astype(jnp.int32))
        return jnp.where(active, nxt, cur), count

    init = pvary_like(
        (jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32)), ro, rd
    )
    _, count = jax.lax.while_loop(cond, body, init)
    return count

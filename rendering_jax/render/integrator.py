"""Wavefront integrator — the reference's recursive `Render::castRay`
(src/scene.cpp:672-946) unrolled into a fixed-depth bounce loop over
struct-of-arrays ray queues.

Design (data-parallel, not a port):
* All rays of a bounce are SoA batches; each bounce is one fused pass:
  closest-hit -> surface data -> direct lighting (shadow rays) ->
  material combine -> spawn continuations. Material branches are
  computed vectorized and selected — no divergence.
* LAYOUT: every per-ray vector lives as (3, B) ROWS (minor dim = the
  large ray-block axis, so a component is one contiguous vector) —
  persistent queues as (nb, 3, B) blocks, and the
  row convention is carried through the whole bounce body
  (trace/surface/lighting/material ops all take and return (3, B)),
  so no (B, 3) <-> (3, B) relayout ever materializes. The ops._r
  helpers use the exact same formulas as their (..., 3) counterparts;
  XLA fusion/FMA choices shift a few ulp in float, but quantized u8
  frames are identical (verified across all golden scenes).
* The Whitted recursion tree becomes weighted continuation paths:
  Reflective spawns one child with weight *= 0.8 (scene.cpp:858);
  Transparent spawns refraction (weight*(1-kr), if kr<1) + reflection
  (weight*kr) (scene.cpp:897-908). Contributions are linear in child
  radiance, so the weighted path sum EQUALS the reference's tree sum.
* With transparent materials present the two children per ray are
  compacted back to capacity Q; active paths are kept ahead of
  inactive lanes and ordered by a Morton key of their origins (queue
  sorting keeps the intersection kernel's ray tiles spatially coherent
  across bounces). Capacity = n_rays makes drops impossible for the
  bundled scenes; any drop is counted in stats["paths_dropped"].
* Discrete hit topology (mesh hit oracle, object argmin, shadow
  visibility) is computed under stop_gradient; hit t/u/v are then
  RE-EVALUATED differentiably from gathered primitive data, so
  `jax.grad` flows to vertices, positions, radii, normals, materials,
  light parameters, textures and the skybox with fixed hit topology.
* Depth semantics match scene.cpp:760: castRay at depth > max returns
  skybox, so the loop runs max_ray_depth+1 bounces and surviving
  continuations take the skybox color afterwards.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rendering_jax.models.scene import (
    KIND_MESH,
    KIND_PLANE,
    KIND_SPHERE,
    MAT_DIFFUSE,
    MAT_PHONG,
    MAT_REFLECTIVE,
    MAT_TRANSPARENT,
)
from rendering_jax.ops.geometry import (
    FLT_MAX,
    dot_r,
    morton_key_r,
    normalize_r,
    pvary_like,
)
from rendering_jax.ops.intersect import (
    intersect_planes_r,
    intersect_spheres_r,
    ray_triangle_r,
)
from rendering_jax.ops.shading import (
    fresnel_r,
    reflect_r,
    refract_r,
    spec_pow,
)
from rendering_jax.ops.skybox import sample_skybox_r
from rendering_jax.ops.texture import (
    sample_map_bilinear_r,
    sample_map_r,
    sample_packed_bilinear_r,
    sample_packed_r,
)
from rendering_jax.ops.traversal import traverse_bvh


def _samplers(settings):
    """Map-sampling functions for the configured texture_filter:
    (packed (rows, R) sampler, per-map (C, R) sampler). "nearest" is
    the reference's truncating index math (objects.cpp:144-172);
    "bilinear" is the smooth-gradient framework extension."""
    if settings.texture_filter == "bilinear":
        return sample_packed_bilinear_r, sample_map_bilinear_r
    if settings.texture_filter != "nearest":
        raise ValueError(
            f"texture_filter must be 'nearest' or 'bilinear', "
            f"got {settings.texture_filter!r}"
        )
    return sample_packed_r, sample_map_r

# Rays per block of the bounce body (bounds every per-ray temporary;
# each block is one intersection-oracle call).
DEFAULT_RAY_BLOCK = 1 << 17


class Hit(NamedTuple):
    t: jnp.ndarray      # (Q,) f32 — differentiable (re-evaluated)
    obj: jnp.ndarray    # (Q,) i32 — discrete
    hit: jnp.ndarray    # (Q,) bool
    tri: jnp.ndarray    # (Q,) i32 (mesh hits; -1 otherwise)
    u: jnp.ndarray      # (Q,)
    v: jnp.ndarray      # (Q,)
    # Gathered per-hit surface rows of the WINNING mesh (30, Q):
    # vgeoT rows [v 0-8 | n 9-17 | uv 18-23 | tan 24-26 | bit 27-29].
    # A gather costs per index more than per row, so trace_closest
    # gathers ALL rows once and surface_data reuses them instead of
    # gathering again. None when no meshes.
    geo: jnp.ndarray | None = None


def _zero_stats():
    # Test counters accumulate in f32: int32 wraps at ~2.1e9, which a
    # single 250k-triangle frame exceeds; the reference's counters are
    # 64-bit atomics (include/stats.h). f32 keeps them monotone and
    # within ~1e-7 relative — they are a work oracle, not an exact sum.
    return {
        "rays_casted": jnp.zeros((), jnp.float32),
        "accel_struct_tests": jnp.zeros((), jnp.float32),
        "ray_tri_tests": jnp.zeros((), jnp.float32),
        # Active continuation paths dropped by the transparent-queue
        # top-Q compaction (must stay 0 for exact parity with the
        # reference's unbounded recursion tree; capacity = n_rays makes
        # drops impossible for the bundled scenes — this counter proves
        # it per render instead of assuming it).
        "paths_dropped": jnp.zeros((), jnp.float32),
    }


# Up to this many objects, per-object values are picked by a chain of
# selects instead of a gather. The backward pass then sums each object's
# gradient with a reduction, in a fixed order; a gather's transpose is a
# scatter-add, which on a GPU sums in no fixed order (obj_color
# gradients changed by up to 4e-5 relative from run to run, and by 4e-4
# between one card and four).
_SELECT_MAX_OBJECTS = 8


def _select_obj(rows, obj, n_objects: int):
    """rows(k) for each ray's object k, by selects. Miss rays (obj = -1)
    read the last object, as the gather does."""
    out = rows(n_objects - 1)
    for k in range(n_objects - 1):
        out = jnp.where(obj == k, rows(k), out)
    return out


def _per_obj(table, obj, n_objects: int):
    """table[obj] with a broadcast fast path for single-object scenes:
    a (1, ...) table gathered by 131k indices is real gather work per
    use that a broadcast gets for free."""
    shape = obj.shape + table.shape[1:]
    if n_objects == 1:
        return jnp.broadcast_to(table[0], shape)
    if n_objects <= _SELECT_MAX_OBJECTS:
        sel = obj.reshape(obj.shape + (1,) * (table.ndim - 1))
        return _select_obj(lambda k: jnp.broadcast_to(table[k], shape),
                           sel, n_objects)
    return table[obj]


def _per_obj3(table, obj, n_objects: int):
    """Per-object 3-vector table -> (3, Q) rows. table: (No, 3);
    obj: (Q,) i32. Gathers from the transposed (3, No) view so the
    output lands rays-minor (No is tiny — the transpose is free)."""
    shape = (3, obj.shape[0])
    if n_objects == 1:
        return jnp.broadcast_to(table[0][:, None], shape)
    if n_objects <= _SELECT_MAX_OBJECTS:
        return _select_obj(
            lambda k: jnp.broadcast_to(table[k][:, None], shape),
            obj[None, :], n_objects)
    return table.T[:, obj]


def _pallas_backend(settings):
    """(use_kernel, interpret) for the intersection oracle: the compiled
    kernel on a GPU; on the CPU the jnp oracles, or the same kernel in
    Pallas interpret mode when settings.pallas_interpret is set (test
    hook — the CPU suite exercises the exact kernel code paths,
    including the fused multi-mesh oracle). Interpret mode on a GPU is
    an error, never a slow path."""
    if not settings.use_pallas_intersect:
        return False, False
    if jax.default_backend() == "gpu":
        if settings.pallas_interpret:
            raise ValueError(
                "pallas_interpret is a CPU test hook; on a GPU the "
                "intersection kernel runs compiled"
            )
        return True, False
    return settings.pallas_interpret, settings.pallas_interpret


def _mesh_oracle(mesh, settings, ro3, rd3, t_limit, mode: str = "closest"):
    """Discrete mesh hit: the intersection kernel (closest-hit or
    any-hit occlusion mode) where _pallas_backend enables it; otherwise
    dense chunked Moller-Trumbore up to settings.bruteforce_threshold
    triangles and the lockstep threaded-BVH walk above it.
    ro3/rd3: (3, Q) rows. Returns (tri_id, box_tests, tri_tests); in
    any-hit mode tri_id >= 0 means occluded within t_limit."""
    from rendering_jax.ops.bruteforce import bruteforce_mesh
    from rendering_jax.ops.bruteforce_mxu import bruteforce_mesh_mxu
    from rendering_jax.ops.pallas_intersect import bruteforce_mesh_pallas

    t_count = int(mesh.v.shape[0])
    use_pallas, pallas_interp = _pallas_backend(settings)
    if use_pallas or t_count <= settings.bruteforce_threshold:
        root_filter = settings.use_ac and mesh.clipped_by_root
        kw = {}
        if use_pallas:
            fn = bruteforce_mesh_pallas
            kw["mode"] = mode
            kw["collect_stats"] = settings.collect_statistics
            kw["rays_row"] = True  # (3, Q) straight through — no relayout
            kw["interpret"] = pallas_interp
            tables = getattr(mesh, "itables", None)
            if tables is not None:
                # Baked tables own the chunking decision (per-mesh
                # size). Table content is flag-independent (root
                # filtering etc. are kernel args), so one build serves
                # any post-build settings surgery.
                kw["tables"] = tables
                kw["tri_chunk"] = tables.tri_chunk
        elif settings.use_mxu_intersect:
            fn = bruteforce_mesh_mxu
        else:
            fn = bruteforce_mesh
        kw.setdefault("tri_chunk", settings.tri_chunk)
        if use_pallas:
            ro_a, rd_a = ro3, rd3
        else:
            ro_a, rd_a = ro3.T, rd3.T  # jnp fallbacks keep (Q, 3)
        _t, tri, bt, tt = fn(
            mesh, ro_a, rd_a, t_limit,
            backface_culling=settings.use_backface_culling,
            use_root_filter=root_filter,
            **kw,
        )
        return tri, bt, tt
    r = traverse_bvh(
        mesh, ro3.T, rd3.T, t_limit,
        backface_culling=settings.use_backface_culling,
        use_ac=settings.use_ac,
    )
    return r.tri, r.box_tests, r.tri_tests


def trace_closest(scene, ro3, rd3, *, t_limit=None,
                  ray_block: int | None = None):
    """Closest hit over all scene objects in scene order
    (Render::trace, src/scene.cpp:724-756). ro3/rd3: (3, Q) rows.
    Returns (Hit, stats dict). Call with block-sized ray batches (the
    bounce loop does). Shadow queries (which skip transparent objects,
    scene.cpp:733-734) go through trace_occlusion — any-hit semantics,
    not closest-hit.

    Differentiability: sphere/plane t's are direct jnp math; mesh t/u/v
    are re-evaluated via Moller-Trumbore on the hit oracle's triangle
    id, so every returned float is differentiable.
    """
    del ray_block  # callers pass block-sized batches already
    st = scene.static
    settings = st.settings
    q = ro3.shape[1]
    stats = _zero_stats()
    stats["rays_casted"] = jnp.asarray(q, jnp.float32)

    t_sph = (
        intersect_spheres_r(ro3, rd3, scene.sph_pos, scene.sph_r)
        if st.n_spheres
        else None
    )  # (Ns, Q)
    t_pln = (
        intersect_planes_r(ro3, rd3, scene.pln_pos, scene.pln_n)
        if st.n_planes
        else None
    )  # (Np, Q)

    mesh_t, mesh_tri, mesh_u, mesh_v, mesh_geo = [], [], [], [], []
    sg = jax.lax.stop_gradient
    use_pallas, pallas_interp = _pallas_backend(settings)
    ft = getattr(scene, "fused_itables", None)
    if ft is not None and use_pallas and (
        st.n_meshes >= 2 or settings.geo_shard_axis is not None
    ):
        # Fused multi-mesh oracle: ONE kernel dispatch (and one shared
        # tile pre-cull) for every mesh in the scene — the reference's
        # per-object loop (scene.cpp:724-756) costs nothing per extra
        # object, and neither does this. The winning (mesh, triangle)
        # comes back as one global vgeoT column, so the surface-row
        # gather and the differentiable re-evaluation also run ONCE
        # instead of once per mesh.
        from rendering_jax.ops.pallas_intersect import intersect_fused

        t_d, mid, vid, bt, tt = intersect_fused(
            sg(ft), sg(ro3), sg(rd3),
            sg(t_limit) if t_limit is not None else None,
            mode="closest",
            backface_culling=settings.use_backface_culling,
            use_root_filter=settings.use_ac and ft.any_clipped,
            collect_stats=settings.collect_statistics,
            interpret=pallas_interp,
        )
        if settings.geo_shard_axis is not None:
            # Geometry sharding (SURVEY 5.8 stretch): each device
            # intersected the rays against ITS table shard; combine
            # per-ray winners across the geo axis. idmap values are
            # GLOBAL (mesh sub / vgeoT column), so only the (t, mid,
            # vid) triple needs reducing: argmin over the gathered t
            # with first-device-wins ties. Shards hold consecutive super
            # ranges in device order, so the first device holds the
            # lowest id: the kernel's own rule (on equal t the lower
            # padded id wins), and the unsharded result.
            ax = settings.geo_shard_axis
            tmin = jax.lax.pmin(t_d, ax)
            rank = jax.lax.axis_index(ax)
            is_win = t_d == tmin
            win_rank = jax.lax.pmin(
                jnp.where(is_win, rank, jnp.int32(2**30)), ax
            )
            sel = is_win & (rank == win_rank)
            mid = jax.lax.psum(jnp.where(sel, mid, 0), ax)
            vid = jax.lax.psum(jnp.where(sel, vid, 0), ax)
            # Miss lanes: t = FLT_MAX on every shard -> device 0 wins
            # -> mid = -1, vid = 0, exactly the unsharded miss values.
            # Counters: each shard tested its own chunks; totals sum.
            bt = jax.lax.psum(bt, ax)
            tt = jax.lax.psum(tt, ax)
        del t_d  # the oracle's t is discrete; t re-evaluates below
        stats["accel_struct_tests"] = stats["accel_struct_tests"] + bt
        stats["ray_tri_tests"] = stats["ray_tri_tests"] + tt
        vsh = getattr(scene, "vgeoT_sharded", None)
        if settings.geo_shard_axis is not None and vsh is not None:
            # Shading-side geometry sharding: each device holds a
            # contiguous COLUMN range of the global vgeoT (its local
            # block under shard_map). Gather the winner rows from the
            # local range (out-of-range lanes read a clamped column
            # and are masked to zero) and psum across 'geo' — exactly
            # one shard is in-range per lane, so the sum IS the row.
            # Miss lanes (vid = 0) land in shard 0's range and yield
            # the same column-0 rows the replicated gather produces.
            ax = settings.geo_shard_axis
            local_cols = vsh.shape[1]
            loc = vid - jax.lax.axis_index(ax) * local_cols
            inb = (loc >= 0) & (loc < local_cols)
            g_loc = vsh[:, jnp.clip(loc, 0, local_cols - 1)]
            g = jax.lax.psum(jnp.where(inb, g_loc, 0.0), ax)  # (30, Q)
        else:
            # In-graph concatenation keeps gradients flowing to every
            # mesh's vertex arrays (concatenate is differentiable; XLA
            # hoists the loop-invariant concat out of the bounce scan).
            vgeoT_all = jnp.concatenate(
                [m.vgeoT for m in scene.meshes], axis=1
            )  # (30, T_total)
            g = vgeoT_all[:, vid]  # (30, Q); vid is 0-clamped on miss
        t_r, u_r, v_r, _ = ray_triangle_r(
            ro3, rd3, g[0:3], g[3:6], g[6:9], settings.use_backface_culling
        )
        # Per-mesh columns for the scene-order object argmin below —
        # identical downstream to the per-mesh path. Local triangle ids
        # recover via the static per-mesh vgeoT offsets.
        vofs = [0]
        for ms in st.meshes:
            vofs.append(vofs[-1] + ms.n_tris)
        for sub in range(st.n_meshes):
            selm = mid == sub  # only true where the oracle found a hit
            mesh_t.append(jnp.where(selm, t_r, FLT_MAX))
            mesh_tri.append(jnp.where(selm, vid - vofs[sub], -1))
            mesh_u.append(jnp.where(selm, u_r, 0.0))
            mesh_v.append(jnp.where(selm, v_r, 0.0))
            mesh_geo.append(g)
    else:
        for mesh in scene.meshes:
            tri_d, bt, tt = _mesh_oracle(
                sg(mesh), settings, sg(ro3), sg(rd3),
                sg(t_limit) if t_limit is not None else None,
            )
            stats["accel_struct_tests"] = stats["accel_struct_tests"] + bt
            stats["ray_tri_tests"] = stats["ray_tri_tests"] + tt
            # ONE gather of every per-triangle surface row (a gather
            # costs the same regardless of row count); rows 0-8 feed
            # the differentiable hit re-evaluation here, the rest ride
            # along in Hit.geo for surface_data. Row layout: the vertex
            # vectors are SLICES of the gather output — no repacking.
            g = mesh.vgeoT[:, jnp.maximum(tri_d, 0)]  # (30, Q)
            t_r, u_r, v_r, _ = ray_triangle_r(
                ro3, rd3, g[0:3], g[3:6], g[6:9],
                settings.use_backface_culling
            )
            found = tri_d >= 0
            mesh_t.append(jnp.where(found, t_r, FLT_MAX))
            mesh_tri.append(jnp.where(found, tri_d, -1))
            mesh_u.append(jnp.where(found, u_r, 0.0))
            mesh_v.append(jnp.where(found, v_r, 0.0))
            mesh_geo.append(g)

    cols = []
    for oi, kind in enumerate(st.obj_kinds):
        sub = st.obj_subs[oi]
        if kind == KIND_SPHERE:
            cols.append(t_sph[sub])
        elif kind == KIND_PLANE:
            cols.append(t_pln[sub])
        else:
            cols.append(mesh_t[sub])
    if not cols:
        miss = jnp.full((q,), FLT_MAX, jnp.float32)
        zi = jnp.zeros((q,), jnp.int32)
        return (
            Hit(miss, zi, jnp.zeros((q,), bool), zi - 1, jnp.zeros((q,)),
                jnp.zeros((q,))),
            stats,
        )

    if len(cols) == 1:
        # Single object: no closest-hit competition to resolve.
        obj = jnp.zeros((q,), jnp.int32)
        t = cols[0]
    else:
        t_mat = jnp.stack(cols, axis=0)  # (No, Q) in scene order
        obj = jnp.argmin(
            jax.lax.stop_gradient(t_mat), axis=0
        ).astype(jnp.int32)
        t = jnp.take_along_axis(t_mat, obj[None, :], axis=0)[0]
    hit = t < FLT_MAX

    tri = jnp.full((q,), -1, jnp.int32)
    u = jnp.zeros((q,), jnp.float32)
    v = jnp.zeros((q,), jnp.float32)
    geo = None
    for oi, kind in enumerate(st.obj_kinds):
        if kind == KIND_MESH:
            sub = st.obj_subs[oi]
            sel = obj == oi
            tri = jnp.where(sel, mesh_tri[sub], tri)
            u = jnp.where(sel, mesh_u[sub], u)
            v = jnp.where(sel, mesh_v[sub], v)
            geo = (
                mesh_geo[sub] if geo is None
                else jnp.where(sel[None, :], mesh_geo[sub], geo)
            )
    return Hit(t, obj, hit, tri, u, v, geo), stats


def trace_occlusion(scene, ro3, rd3, dist, *, ray_block: int | None = None):
    """Boolean shadow query: does any non-transparent object intersect
    strictly closer than `dist`? (trace() called with intrInfo.tNear
    pre-set to the light distance, scene.cpp:785-787.) ro3/rd3: (3, Q).
    Entirely under stop_gradient — visibility is a step function and is
    treated as locally constant for gradients. Returns (occluded, stats).
    """
    del ray_block
    st = scene.static
    settings = st.settings
    ro3 = jax.lax.stop_gradient(ro3)
    rd3 = jax.lax.stop_gradient(rd3)
    dist = jax.lax.stop_gradient(dist)
    q = ro3.shape[1]
    stats = _zero_stats()
    stats["rays_casted"] = jnp.asarray(q, jnp.float32)
    occluded = jnp.zeros((q,), bool)

    sph_mask = [
        st.mat_types[oi] != MAT_TRANSPARENT
        for oi, k in enumerate(st.obj_kinds)
        if k == KIND_SPHERE
    ]
    pln_mask = [
        st.mat_types[oi] != MAT_TRANSPARENT
        for oi, k in enumerate(st.obj_kinds)
        if k == KIND_PLANE
    ]
    mesh_mask = [
        st.mat_types[oi] != MAT_TRANSPARENT
        for oi, k in enumerate(st.obj_kinds)
        if k == KIND_MESH
    ]

    if st.n_spheres and any(sph_mask):
        t = intersect_spheres_r(ro3, rd3, scene.sph_pos, scene.sph_r)
        keep = jnp.asarray(sph_mask)[:, None]  # (Ns, 1)
        occluded = occluded | jnp.any(keep & (t < dist[None, :]), axis=0)
    if st.n_planes and any(pln_mask):
        t = intersect_planes_r(ro3, rd3, scene.pln_pos, scene.pln_n)
        keep = jnp.asarray(pln_mask)[:, None]
        occluded = occluded | jnp.any(keep & (t < dist[None, :]), axis=0)
    use_pallas, pallas_interp = _pallas_backend(settings)
    fts = getattr(scene, "fused_shadow_itables", None)
    if fts is not None and use_pallas and any(mesh_mask):
        # Fused shadow oracle: one any-hit dispatch over every
        # non-transparent mesh (transparent objects cast no shadows,
        # scene.cpp:733-734 — they are excluded at table-build time).
        # Rays already occluded by spheres/planes enter pre-done
        # (t0 = -1 culls every chunk); cross-mesh progressive pruning
        # happens INSIDE the kernel via the running done marker.
        from rendering_jax.ops.pallas_intersect import intersect_fused

        dist_m = jnp.where(occluded, -1.0, dist)
        occ_m, bt, tt = intersect_fused(
            jax.lax.stop_gradient(fts), ro3, rd3, dist_m,
            mode="any",
            backface_culling=settings.use_backface_culling,
            use_root_filter=settings.use_ac and fts.any_clipped,
            collect_stats=settings.collect_statistics,
            interpret=pallas_interp,
        )
        if settings.geo_shard_axis is not None:
            # Geometry sharding: a ray is occluded if ANY device's
            # table shard occludes it; counters sum across shards.
            ax = settings.geo_shard_axis
            occ_m = jax.lax.psum(occ_m.astype(jnp.int32), ax) > 0
            bt = jax.lax.psum(bt, ax)
            tt = jax.lax.psum(tt, ax)
        stats["accel_struct_tests"] = stats["accel_struct_tests"] + bt
        stats["ray_tri_tests"] = stats["ray_tri_tests"] + tt
        occluded = occluded | occ_m
        return occluded, stats
    for mi, mesh in enumerate(scene.meshes):
        if not mesh_mask[mi]:
            continue
        # Rays already occluded (spheres/planes/earlier meshes) enter
        # pre-done (t0 = -1 culls every chunk) — exact: occluded is
        # already final for them.
        dist_m = jnp.where(occluded, -1.0, dist)
        tri_d, bt, tt = _mesh_oracle(
            jax.lax.stop_gradient(mesh), settings, ro3, rd3, dist_m,
            mode="any"
        )
        stats["accel_struct_tests"] = stats["accel_struct_tests"] + bt
        stats["ray_tri_tests"] = stats["ray_tri_tests"] + tt
        occluded = occluded | (tri_d >= 0)
    return occluded, stats


def surface_data(scene, hit: Hit, hit_point3, *, want_maps: bool = False):
    """Normal + texture coordinate at the hit (getSurfaceData
    implementations: mesh objects.cpp:121-151, sphere :788-796, plane
    :816-824). hit_point3: (3, Q). Returns (normal3 (3, Q), tex2
    (2, Q)); with want_maps=True also a {obj_index: (7, Q)} dict of
    packed map rows (diffuse rgb | normal xyz | specular) for meshes
    whose maps share texel indices — gathered ONCE here and reused by
    object_color / specular_coefficient instead of re-gathering per
    map."""
    st = scene.static
    q = hit_point3.shape[1]
    normal3 = jnp.zeros((3, q), jnp.float32)
    tex2 = jnp.zeros((2, q), jnp.float32)
    msamp: dict[int, jnp.ndarray] = {}

    for oi, kind in enumerate(st.obj_kinds):
        sub = st.obj_subs[oi]
        sel = (hit.obj == oi) & hit.hit
        if kind == KIND_SPHERE:
            n3 = normalize_r(hit_point3 - scene.sph_pos[sub][:, None])
            normal3 = jnp.where(sel[None, :], n3, normal3)
            # Sphere UV (objects.cpp:793-795): debug-only (maps exist
            # only on meshes); stop_gradient avoids the acos'(+-1) pole.
            n_sg = jax.lax.stop_gradient(n3)
            tx = (1.0 + jnp.arctan2(n_sg[2], n_sg[0]) / math.pi) * 0.5
            ty = jnp.arccos(jnp.clip(n_sg[1], -1.0, 1.0)) / math.pi
            tex2 = jnp.where(sel[None, :], jnp.stack([tx, ty]), tex2)
        elif kind == KIND_PLANE:
            n3 = jnp.broadcast_to(scene.pln_n[sub][:, None], (3, q))
            normal3 = jnp.where(sel[None, :], n3, normal3)
            d3 = hit_point3 - scene.pln_pos[sub][:, None]
            tex2 = jnp.where(
                sel[None, :], jnp.stack([d3[0] / 15.0, d3[2] / 15.0]), tex2
            )
        else:
            ms = st.meshes[sub]
            # Surface rows already gathered by trace_closest (Hit.geo);
            # lanes where another mesh won hold that mesh's rows, but
            # `sel` masks them out exactly as before. All vertex
            # vectors are SLICES of the row-major gather — no repack.
            g = hit.geo[9:]  # (21, Q): n9 | uv6 | tan3 | bit3
            uvg = g[9:15]  # (6, Q)
            w0 = 1.0 - hit.u - hit.v
            # texCoord = t_b*u + t_c*v + (1-u-v)*t_a (objects.cpp:124)
            tc2 = jnp.stack(
                [
                    uvg[2] * hit.u + uvg[4] * hit.v + uvg[0] * w0,
                    uvg[3] * hit.u + uvg[5] * hit.v + uvg[1] * w0,
                ]
            )
            # smooth vertex normal; the /3 is a no-op under normalize
            # (objects.cpp:127)
            n3 = normalize_r(
                (g[3:6] * hit.u[None] + g[6:9] * hit.v[None]
                 + g[0:3] * w0[None]) / 3.0
            )
            packed_fn, map_fn = _samplers(st.settings)
            g7 = None
            if ms.has_packed_maps:
                g7 = packed_fn(
                    scene.meshes[sub].mapsT, ms.pmap_wh, tc2
                )  # (7, Q)
                msamp[oi] = g7
            if ms.has_normal_map:
                # Tangent-space normal via the (unorthonormalized) TBN
                # rows exactly as objects.cpp:129-150.
                raw = (
                    g7[3:6] if g7 is not None
                    else map_fn(
                        scene.meshes[sub].normal_map, ms.nmap_wh, tc2
                    )
                )
                tn = normalize_r(raw)
                n3 = normalize_r(
                    tn[0:1] * g[15:18] + tn[1:2] * g[18:21] + tn[2:3] * n3
                )
            normal3 = jnp.where(sel[None, :], n3, normal3)
            tex2 = jnp.where(sel[None, :], tc2, tex2)
    if want_maps:
        return normal3, tex2, msamp
    return normal3, tex2


def object_color(scene, hit: Hit, tex2, msamp=None):
    """objectColor: mesh -> getDiffuseColor(tex) (diffuse map or color,
    objects.cpp:153-163, applied for every material via scene.cpp:774);
    sphere/plane -> object color. Returns (3, Q). msamp: packed map
    rows gathered by surface_data (reused instead of a second gather)."""
    st = scene.static
    color3 = _per_obj3(scene.obj_color, hit.obj, st.n_objects)
    for oi, kind in enumerate(st.obj_kinds):
        if kind != KIND_MESH:
            continue
        sub = st.obj_subs[oi]
        ms = st.meshes[sub]
        if ms.has_diffuse_map:
            sel = (hit.obj == oi)[None, :]
            if msamp is not None and oi in msamp:
                smp = msamp[oi][0:3]
            else:
                smp = _samplers(st.settings)[1](
                    scene.meshes[sub].diffuse_map, ms.dmap_wh, tex2
                )
            color3 = jnp.where(sel, smp, color3)
    return color3


def specular_coefficient(scene, hit: Hit, tex2, msamp=None):
    """Phong specular coefficient: specular map if the mesh has one
    (scene.cpp:849-852, objects.cpp:165-175), else object specular.
    msamp: packed map rows gathered by surface_data (reused)."""
    st = scene.static
    spec = _per_obj(scene.obj_specular, hit.obj, st.n_objects)
    for oi, kind in enumerate(st.obj_kinds):
        if kind != KIND_MESH:
            continue
        sub = st.obj_subs[oi]
        ms = st.meshes[sub]
        if ms.has_specular_map:
            sel = hit.obj == oi
            if msamp is not None and oi in msamp:
                smp = msamp[oi][6]
            else:
                smp = _samplers(st.settings)[1](
                    scene.meshes[sub].specular_map, ms.smap_wh, tex2
                )[0]
            spec = jnp.where(sel, smp, spec)
    return spec


def _area_points(light):
    """AreaLight::setPoints (src/lights.cpp:46-63): samples^2 grid
    including both edges; samples == 1 -> the center point."""
    s = light.samples
    if s <= 1:
        return light.pos[None, :]
    ii = jnp.arange(s, dtype=jnp.float32) / jnp.float32(s - 1)
    corner = light.pos - light.ivec / 2.0 - light.jvec / 2.0
    pts = (
        corner[None, None, :]
        + ii[:, None, None] * light.ivec[None, None, :]
        + ii[None, :, None] * light.jvec[None, None, :]
    )
    return pts.reshape(s * s, 3)


def _point_falloff(intensity, d2):
    """min(1, I / (4*pi*d2/1000)) (lights.cpp:35, scene.cpp:796)."""
    safe = jnp.maximum(d2, 1e-30)
    return jnp.minimum(1.0, intensity / (4.0 * math.pi * safe / 1000.0))


def lighting(scene, hit_point3, normal3, rd3, nspec, *, stats, mask=None,
             ray_block=None):
    """Direct lighting over all lights, shared by every material branch
    (the per-branch light loops at scene.cpp:780-941 compute the same
    two sums). All vectors (3, Q) rows. Returns
    (diffuse_comp (3, Q), spec_comp (3, Q)).

    Area lights reproduce the pow-of-MEAN quirk (scene.cpp:846): the
    specular term is pow(sum(vis*max(0,R.(-V)))/S, nspec), not the mean
    of pows.
    """
    del ray_block
    q = hit_point3.shape[1]
    diffuse_c3 = jnp.zeros((3, q), jnp.float32)
    spec_c3 = jnp.zeros((3, q), jnp.float32)
    shadow_orig3 = hit_point3 + normal3 * scene.bias

    # Point/distant shadow rays share their origins and the mesh chunk
    # tables, so ALL of them go through ONE batched any-hit occlusion
    # query (rays concatenated along the ray axis) — one kernel
    # launch and one tile pre-cull instead of one per light. Rays whose
    # result is provably unused enter the query pre-done (t0 = -1, the
    # any-hit done marker: every chunk is culled for them): miss/
    # inactive lanes (the material combine masks their contribution)
    # and lanes where BOTH the diffuse (ndl <= 0) and specular
    # (spec_pow(rdv) <= 0) factors are zero so visibility cannot
    # matter. Exact — only the multiplied-by-zero lanes are skipped.
    point_lights = [
        li for li in scene.lights if li.kind in ("distant", "point")
    ]
    batched = []  # (ldir3, inten3, dist, ndl, spec_f) per light
    for light in point_lights:
        if light.kind == "distant":
            ldir3 = jnp.broadcast_to(light.dir[:, None], (3, q))
            inten3 = jnp.broadcast_to(
                (light.color * light.intensity)[:, None], (3, q)
            )
            dist = jnp.full((q,), FLT_MAX, jnp.float32)
        else:
            delta3 = hit_point3 - light.pos[:, None]
            d2 = dot_r(delta3, delta3)
            inten3 = (
                light.color[:, None]
                * _point_falloff(light.intensity, d2)[None, :]
            )
            ldir3 = normalize_r(delta3)
            dist = jnp.sqrt(d2)
        ndl = jnp.maximum(0.0, dot_r(normal3, -ldir3))
        spec_f = spec_pow(
            jnp.maximum(0.0, dot_r(reflect_r(ldir3, normal3), -rd3)), nspec
        )
        unused = (ndl <= 0.0) & (spec_f <= 0.0)
        if mask is not None:
            unused = unused | ~mask
        dist = jnp.where(jax.lax.stop_gradient(unused), -1.0, dist)
        batched.append((ldir3, inten3, dist, ndl, spec_f))

    if batched:
        n_l = len(batched)
        occ_all, s_stats = trace_occlusion(
            scene,
            jnp.tile(shadow_orig3, (1, n_l)),
            jnp.concatenate([-b[0] for b in batched], axis=1),
            jnp.concatenate([b[2] for b in batched]),
        )
        for k in stats:
            stats[k] = stats[k] + s_stats[k]
        for li, (ldir3, inten3, dist, ndl, spec_f) in enumerate(batched):
            vis = (~occ_all[li * q : (li + 1) * q]).astype(jnp.float32)
            diffuse_c3 = diffuse_c3 + inten3 * (vis * ndl)[None, :]
            spec_c3 = spec_c3 + (vis * spec_f)[None, :] * inten3

    for light in scene.lights:
        if light.kind in ("distant", "point"):
            continue  # handled by the batched query above
        else:  # area — sample grid, scene.cpp:790-806 / 826-846
            pts3 = _area_points(light).T  # (3, S)
            s_count = pts3.shape[1]
            delta3 = hit_point3[:, :, None] - pts3[:, None, :]  # (3, Q, S)
            dist_s = jnp.sqrt(dot_r(delta3, delta3))            # (Q, S)
            if mask is not None:  # pre-done miss/inactive lanes (exact)
                dist_s = jnp.where(
                    jax.lax.stop_gradient(mask)[:, None], dist_s, -1.0
                )
            ldn3 = normalize_r(delta3)
            occ, s_stats = trace_occlusion(
                scene,
                jnp.broadcast_to(
                    shadow_orig3[:, :, None], delta3.shape
                ).reshape(3, -1),
                (-ldn3).reshape(3, -1),
                dist_s.reshape(-1),
            )
            for k in stats:
                stats[k] = stats[k] + s_stats[k]
            vis = (~occ).reshape(q, s_count).astype(jnp.float32)
            ndl = jnp.maximum(0.0, dot_r(normal3[:, :, None], -ldn3))  # (Q, S)
            refl_s3 = reflect_r(ldn3, normal3[:, :, None])      # (3, Q, S)
            rdv = jnp.maximum(0.0, dot_r(refl_s3, -rd3[:, :, None]))
            dsum = jnp.sum(vis * ndl, axis=1) / s_count
            ssum = jnp.sum(vis * rdv, axis=1) / s_count
            dc3 = hit_point3 - light.pos[:, None]
            inten3 = (
                light.color[:, None]
                * _point_falloff(light.intensity, dot_r(dc3, dc3))[None, :]
            )
            diffuse_c3 = diffuse_c3 + dsum[None, :] * inten3
            spec_c3 = spec_c3 + spec_pow(ssum, nspec)[None, :] * inten3
    return diffuse_c3, spec_c3


class BlockOut(NamedTuple):
    contrib3: jnp.ndarray  # (3, B) weighted radiance to scatter
    c1_ro3: jnp.ndarray    # (3, B) continuation 1 (reflective / transparent-refl)
    c1_rd3: jnp.ndarray
    c1_w: jnp.ndarray      # (B,)
    c2_ro3: jnp.ndarray    # (3, B) continuation 2 (transparent refraction)
    c2_rd3: jnp.ndarray
    c2_w: jnp.ndarray
    stats: dict


def _bounce_block(scene, ro3, rd3, weight, active) -> BlockOut:
    """One castRay level for a block of rays — (3, B) rows throughout
    (no layout change from queue to ops to queue)."""
    st = scene.static
    stats = _zero_stats()

    # Inactive lanes (weight-0 queue padding, TIR children, terminated
    # paths) get t_limit = -1: the kernel's pre-pass and per-step culls
    # treat them as resolved, so they cost no intersection work. Their
    # contributions were already masked by `active`; exact either way.
    hit, t_stats = trace_closest(
        scene, ro3, rd3,
        t_limit=jnp.where(active, FLT_MAX, -1.0),
    )
    for k in stats:
        stats[k] = stats[k] + t_stats[k]
    hit_m = hit.hit & active
    miss_m = (~hit.hit) & active

    sky3 = sample_skybox_r(
        scene.skybox if st.settings.use_skybox else None, rd3, scene.bg_color
    )
    contrib3 = jnp.where(miss_m[None, :], weight[None, :] * sky3, 0.0)

    # Sanitize miss-lane t (FLT_MAX) so masked lanes stay finite: any
    # inf/NaN in a masked forward value would poison reverse-mode
    # through the 0 * inf chain rule.
    t_safe = jnp.where(hit.hit, hit.t, 1.0)
    hit_point3 = ro3 + rd3 * t_safe[None, :]
    normal3, tex2, msamp = surface_data(
        scene, hit, hit_point3, want_maps=True
    )
    obj_col3 = object_color(scene, hit, tex2, msamp)
    nspec = _per_obj(scene.obj_nspec, hit.obj, st.n_objects)
    mat = _per_obj(scene.mat_type, hit.obj, st.n_objects)

    diffuse_c3, spec_c3 = lighting(
        scene, hit_point3, normal3, rd3, nspec, stats=stats, mask=hit_m
    )

    # Material combine (scene.cpp:780-941).
    spec_coef = specular_coefficient(scene, hit, tex2, msamp)
    hc_diffuse = obj_col3 * diffuse_c3
    hc_phong = (
        obj_col3 * _per_obj(scene.obj_ambient, hit.obj, st.n_objects)[None, :]
        + diffuse_c3
        * _per_obj(scene.obj_diffuse, hit.obj, st.n_objects)[None, :]
        + spec_c3 * spec_coef[None, :]
    )
    hc_reflective = spec_c3

    if st.any_transparent:
        ior = _per_obj(scene.obj_ior, hit.obj, st.n_objects)
        kr = fresnel_r(rd3, normal3, ior)
        hc_last = jnp.where(
            (mat == MAT_REFLECTIVE)[None, :], hc_reflective,
            spec_c3 * kr[None, :],
        )
    else:
        # No transparent materials in the scene (static): the fresnel
        # evaluation and its where-arm are dead — skip them per bounce.
        hc_last = hc_reflective

    hc = jnp.where(
        (mat == MAT_DIFFUSE)[None, :],
        hc_diffuse,
        jnp.where((mat == MAT_PHONG)[None, :], hc_phong, hc_last),
    )
    contrib3 = contrib3 + jnp.where(hit_m[None, :], weight[None, :] * hc, 0.0)

    # ---- continuations ----
    bias_v3 = scene.bias[None, None] * normal3
    rdn = dot_r(rd3, normal3)

    is_refl = hit_m & (mat == MAT_REFLECTIVE)
    is_trans = hit_m & (mat == MAT_TRANSPARENT)

    # Reflective child (scene.cpp:856-858): dir NOT normalized there.
    refl_dir_r3 = rd3 - 2.0 * rdn[None, :] * normal3
    refl_orig_r3 = hit_point3 + bias_v3

    if st.any_transparent:
        outside = rdn < 0
        refr_dir3 = normalize_r(refract_r(rd3, normal3, ior))
        refr_orig3 = jnp.where(
            outside[None, :], hit_point3 - bias_v3, hit_point3 + bias_v3
        )
        refl_dir_t3 = normalize_r(reflect_r(rd3, normal3))
        refl_orig_t3 = jnp.where(
            outside[None, :], hit_point3 + bias_v3, hit_point3 - bias_v3
        )
        c1_dir3 = jnp.where(is_refl[None, :], refl_dir_r3, refl_dir_t3)
        c1_orig3 = jnp.where(is_refl[None, :], refl_orig_r3, refl_orig_t3)
        c1_w = jnp.where(
            is_refl, weight * 0.8, jnp.where(is_trans, weight * kr, 0.0)
        )
        c2_dir3 = refr_dir3
        c2_orig3 = refr_orig3
        c2_w = jnp.where(is_trans & (kr < 1.0), weight * (1.0 - kr), 0.0)
    else:
        c1_dir3 = refl_dir_r3
        c1_orig3 = refl_orig_r3
        c1_w = jnp.where(is_refl, weight * 0.8, 0.0)
        c2_dir3 = rd3
        c2_orig3 = ro3
        c2_w = jnp.zeros_like(weight)

    return BlockOut(
        contrib3=contrib3,
        c1_ro3=c1_orig3, c1_rd3=c1_dir3, c1_w=c1_w,
        c2_ro3=c2_orig3, c2_rd3=c2_dir3, c2_w=c2_w,
        stats=stats,
    )


class Queue(NamedTuple):
    """Bounce queue in blocked layout: vectors as (nb, 3, B)."""

    ro3: jnp.ndarray     # (nb, 3, B)
    rd3: jnp.ndarray     # (nb, 3, B)
    weight: jnp.ndarray  # (nb, B)
    pix: jnp.ndarray     # (nb, B) i32


def _bounce(scene, queue: Queue, accum3, stats, *, slot_accum: bool):
    """One castRay level for the whole queue. Returns (queue', accum3').

    slot_accum: accumulate contributions per QUEUE SLOT ((nb, 3, B)
    accumulator) instead of scatter-adding into the pixel buffer —
    valid whenever slot -> pixel is fixed across bounces (no
    transparent-queue resorting). The caller unpermutes once at the
    end; this removes a (3, n_pixels)-sized scatter per render."""
    st = scene.static
    min_w = st.settings.min_weight
    nb, _, B = queue.ro3.shape
    q = nb * B

    def body(args):
        ro3, rd3, w = args
        out = _bounce_block(scene, ro3, rd3, w, w > min_w)
        return out

    out = jax.lax.map(body, (queue.ro3, queue.rd3, queue.weight))
    for k in stats:
        stats[k] = stats[k] + jnp.sum(out.stats[k])

    pix_flat = queue.pix.reshape(q)
    if slot_accum:
        accum3 = accum3 + out.contrib3
    else:
        # Scatter contributions (values flat to (3, Q) — minor dim Q).
        contrib_flat = jnp.moveaxis(out.contrib3, 0, 1).reshape(3, q)
        accum3 = accum3.at[:, pix_flat].add(contrib_flat)

    if not st.any_transparent:
        if slot_accum:
            # Single continuation in place — slots stay pixel-aligned.
            return Queue(
                ro3=out.c1_ro3, rd3=out.c1_rd3, weight=out.c1_w,
                pix=queue.pix
            ), accum3
        # Scatter mode (bouncing scene): Morton-sort the continuation
        # queue by origin so the next bounce's ray tiles stay spatially
        # coherent after reflection scatters them (incoherent tiles
        # cost the intersection kernel ~60x; see ops.geometry.morton_key_r).
        # Inactive lanes sort last. Pure reordering — contributions
        # ride with pix.
        def flat3(a):  # (nb, 3, B) -> (3, Q)
            return jnp.moveaxis(a, 0, 1).reshape(3, q)

        c_ro = flat3(out.c1_ro3)
        c_rd = flat3(out.c1_rd3)
        c_w = out.c1_w.reshape(q)
        active = c_w > min_w
        key = jnp.where(active, morton_key_r(c_ro), jnp.uint32(0xFFFFFFFF))
        order = jnp.argsort(key, stable=True)
        return Queue(
            ro3=jnp.moveaxis(c_ro[:, order].reshape(3, nb, B), 1, 0),
            rd3=jnp.moveaxis(c_rd[:, order].reshape(3, nb, B), 1, 0),
            weight=c_w[order].reshape(nb, B),
            pix=queue.pix.reshape(q)[order].reshape(nb, B),
        ), accum3

    # Two candidate children per ray -> weight-priority top-Q,
    # Morton-ordered (see _compact_children).
    def flat3(a):  # (nb, 3, B) -> (3, Q)
        return jnp.moveaxis(a, 0, 1).reshape(3, q)

    cand_ro = jnp.concatenate([flat3(out.c1_ro3), flat3(out.c2_ro3)], axis=1)
    cand_rd = jnp.concatenate([flat3(out.c1_rd3), flat3(out.c2_rd3)], axis=1)
    cand_w = jnp.concatenate([out.c1_w.reshape(q), out.c2_w.reshape(q)])
    cand_pix = jnp.concatenate([pix_flat, pix_flat])
    k_ro, k_rd, k_w, k_pix = _compact_children(
        cand_ro, cand_rd, cand_w, cand_pix, q, min_w, stats
    )
    return Queue(
        ro3=jnp.moveaxis(k_ro.reshape(3, nb, B), 1, 0),
        rd3=jnp.moveaxis(k_rd.reshape(3, nb, B), 1, 0),
        weight=k_w.reshape(nb, B),
        pix=k_pix.reshape(nb, B),
    ), accum3


def _compact_children(cand_ro, cand_rd, cand_w, cand_pix, capacity: int,
                      min_w, stats):
    """Compact 2Q candidate children to the queue capacity Q.

    Weight-priority selection: when more than Q children stay active,
    the Q LARGEST weights are kept (the reference's recursion never
    drops, so any forced drop should be the smallest-error one — a
    pure Morton-key top-Q would drop by spatial position instead).
    The kept set is then Morton-ordered by origin for next-bounce ray
    tile coherence; inactive lanes sort last so a drop never displaces
    an active path for an inactive one. Drops are counted into
    stats["paths_dropped"] (asserted zero by the golden suite)."""
    cand_w = jnp.where(cand_w > min_w, cand_w, 0.0)
    active = cand_w > min_w
    worder = jnp.argsort(jnp.where(active, -cand_w, jnp.inf), stable=True)
    keep = jnp.zeros(cand_w.shape, bool).at[worder[:capacity]].set(True)
    key = jnp.where(
        keep & active, morton_key_r(cand_ro), jnp.uint32(0xFFFFFFFF)
    )
    order = jnp.argsort(key, stable=True)[:capacity]
    kept_w = cand_w[order]
    n_active = jnp.sum(active.astype(jnp.float32))
    n_kept = jnp.sum((kept_w > min_w).astype(jnp.float32))
    stats["paths_dropped"] = stats["paths_dropped"] + (n_active - n_kept)
    return cand_ro[:, order], cand_rd[:, order], kept_w, cand_pix[order]


def _to_blocks(ro, rd, pix, weight, block):
    """Pack (Q, 3) rays into the blocked (nb, 3, B) queue layout."""
    q = ro.shape[0]
    nb = max(1, -(-q // block))
    pad = nb * block - q
    if pad:
        ro = jnp.pad(ro, ((0, pad), (0, 0)))
        rd = jnp.pad(rd, ((0, pad), (0, 0)), constant_values=1.0)
        pix = jnp.pad(pix, (0, pad))
        weight = jnp.pad(weight, (0, pad))
    return Queue(
        ro3=ro.T.reshape(3, nb, block).swapaxes(0, 1),
        rd3=rd.T.reshape(3, nb, block).swapaxes(0, 1),
        weight=weight.reshape(nb, block),
        pix=pix.astype(jnp.int32).reshape(nb, block),
    )


def integrate(scene, ro, rd, pix, weight, n_pixels: int, *,
              ray_block: int = DEFAULT_RAY_BLOCK,
              out_slots: bool = False, queue_headroom: int = 1):
    """Run the full bounce loop for a ray batch; scatter-add weighted
    radiance into a (3, n_pixels) accumulator. Returns (accum3, stats).

    out_slots=True returns the radiance per INPUT RAY instead —
    (3, len(ro)), slot i = total radiance of ray i's bounce tree — and
    never touches a pixel buffer (the caller owns the slot -> pixel
    mapping, typically a static screen-tile permutation it can invert
    with a transpose/static gather instead of a huge scatter). Only
    valid without transparent materials: the transparent queue resort
    reassigns slots mid-loop.

    queue_headroom > 1 (static) appends that many extra dead queue
    blocks on transparent scenes, raising the continuation-compaction
    capacity to headroom * len(ro): when the 2^depth transparent tree
    outgrows one slot per input ray (glass-heavy frames, or a sharded
    device owning more than its share of glass pixels), paths survive
    instead of being weight-dropped. Dead lanes cost almost nothing to
    trace (t_limit = -1 culls them in the intersection kernel). The
    host wrappers escalate it automatically when stats report drops.

    Gradient aggregation under shard_map (SURVEY section 5.8): the
    scene enters the bounce scan as a replicated (vma-unvarying)
    closure constant, so vma-aware partitioned AD transposes each
    in-body `pvary` into a `psum` INSIDE the backward scan — parameter
    gradients all-reduce once per bounce, overlapped with the next
    backward step's compute, by construction. See
    parallel.overlap (which pins this structurally and provides the
    single-bulk-psum alternative schedule for hardware A/B).
    """
    st = scene.static
    if out_slots:
        assert not st.any_transparent, "slot accumulation needs fixed slots"
    n_bounces = (st.settings.max_ray_depth + 1) if st.any_bouncing else 1
    r_in = ro.shape[0]
    if r_in == 0:  # empty batch: _to_blocks would divide by block=0
        empty = (jnp.zeros((3, 0), jnp.float32) if out_slots
                 else jnp.zeros((3, n_pixels), jnp.float32))
        return empty, _zero_stats()
    stats = _zero_stats()
    queue = _to_blocks(ro, rd, pix, weight, min(ray_block, ro.shape[0]))
    if queue_headroom > 1 and st.any_transparent:
        nb0, _, B0 = queue.ro3.shape
        extra = nb0 * (queue_headroom - 1)
        queue = Queue(
            ro3=jnp.concatenate(
                [queue.ro3, jnp.zeros((extra, 3, B0), jnp.float32)]
            ),
            rd3=jnp.concatenate(
                [queue.rd3, jnp.ones((extra, 3, B0), jnp.float32)]
            ),
            weight=jnp.concatenate(
                [queue.weight, jnp.zeros((extra, B0), jnp.float32)]
            ),
            pix=jnp.concatenate(
                [queue.pix, jnp.zeros((extra, B0), jnp.int32)]
            ),
        )
    if out_slots:
        accum3 = jnp.zeros(queue.ro3.shape, jnp.float32)  # (nb, 3, B)
    else:
        accum3 = jnp.zeros((3, n_pixels), jnp.float32)

    accum3, queue, stats = pvary_like(
        (accum3, queue, stats), ro, rd, weight, pix
    )

    def body(carry, _):
        queue, accum3, stats = carry
        stats = dict(stats)
        queue, accum3 = _bounce(
            scene, queue, accum3, stats, slot_accum=out_slots
        )
        return (queue, accum3, stats), None

    (queue, accum3, stats), _ = jax.lax.scan(
        body, (queue, accum3, stats), None, length=n_bounces
    )

    # Depth guard: surviving continuations return the skybox
    # (scene.cpp:760).
    if st.any_bouncing:
        def tail_block(args):
            rd3, w = args
            sky3 = sample_skybox_r(
                scene.skybox if st.settings.use_skybox else None,
                rd3, scene.bg_color,
            )
            active = w > st.settings.min_weight
            return jnp.where(active[None, :], w[None, :] * sky3, 0.0)

        tail3 = jax.lax.map(tail_block, (queue.rd3, queue.weight))
        nb, _, B = queue.ro3.shape
        if out_slots:
            accum3 = accum3 + tail3
        else:
            accum3 = accum3.at[:, queue.pix.reshape(-1)].add(
                jnp.moveaxis(tail3, 0, 1).reshape(3, nb * B)
            )
    if out_slots:
        nb, _, B = accum3.shape
        accum3 = jnp.moveaxis(accum3, 0, 1).reshape(3, nb * B)[:, :r_in]
    return accum3, stats


def shade_normals(scene, ro, rd, *, ray_block: int = DEFAULT_RAY_BLOCK):
    """showNormals mode (scene.cpp:771-772): first hit -> n/2 + 0.5,
    miss -> skybox. Single bounce by construction (the reference returns
    before any recursion). ro/rd: (Q, 3); returns (3, Q)."""
    st = scene.static
    q = ro.shape[0]
    if q == 0:
        return jnp.zeros((3, 0), jnp.float32)
    block = min(ray_block, q)
    nb = max(1, -(-q // block))
    pad = nb * block - q
    if pad:
        ro = jnp.pad(ro, ((0, pad), (0, 0)))
        rd = jnp.pad(rd, ((0, pad), (0, 0)), constant_values=1.0)
    ro3 = ro.T.reshape(3, nb, block).swapaxes(0, 1)
    rd3 = rd.T.reshape(3, nb, block).swapaxes(0, 1)

    def body(args):
        ro3_b, rd3_b = args
        hit, _ = trace_closest(scene, ro3_b, rd3_b)
        hit_point3 = ro3_b + rd3_b * jnp.where(hit.hit, hit.t, 1.0)[None, :]
        normal3, _ = surface_data(scene, hit, hit_point3)
        sky3 = sample_skybox_r(
            scene.skybox if st.settings.use_skybox else None, rd3_b,
            scene.bg_color,
        )
        return jnp.where(hit.hit[None, :], normal3 / 2.0 + 0.5, sky3)

    out = jax.lax.map(body, (ro3, rd3))  # (nb, 3, B)
    return jnp.moveaxis(out, 0, 1).reshape(3, nb * block)[:, :q]

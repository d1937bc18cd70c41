"""By-primitive GEOMETRY sharding (SURVEY section 5.8 stretch goal).

The default scale-out replicates the scene and shards rays — right for
shotgun-class scenes (<< 1 GB). For scenes whose acceleration tables
outgrow one chip's HBM, this module shards the FUSED chunk tables
themselves across a second mesh axis:

  mesh = Mesh(devices.reshape(R, G), ("rays", "geo"))

* the fused super-chunk tables (ops.pallas_intersect.FusedTables) are
  padded to G-divisible super counts and physically sharded along the
  super axis (shard_map in_specs) — each device HOLDS 1/G of the
  scene's triangles in kernel format;
* every device intersects its ray shard against its table shard (the
  kernel and its tile pre-cull are shard-size-agnostic);
* trace_closest combines per-ray winners across 'geo' with pmin +
  rank-tie-break psum selects, trace_occlusion with a psum-any — both
  collectives produce vma-unvarying results, so shading runs once per
  ray shard on the combined hit, replicated over 'geo'
  (render.integrator fused branches, settings.geo_shard_axis);
* idmap values are GLOBAL (mesh sub index / vgeoT column), so a shard-
  local hit needs no id rebasing after the combine.

Scope: this shards the INTERSECTION tables (16 f32 rows per triangle
+ chunk boxes) always, and with shade_sharded=True ALSO the
shading-side (30, T) vgeoT table — column-wise over 'geo', with the
winner-row gather done locally per shard and combined by one masked
psum (render.integrator, SceneData.vgeoT_sharded). The replicated
per-mesh geometry arrays (v/n/uv/tangents/vgeoT/BVH) are stripped to
zero-size in that mode, so each device holds only 1/G of ALL
per-triangle data — intersection and shading — plus the (small)
replicated maps/lights/materials. `geo_shard_memory_accounting`
measures exactly that from the staged device buffers.

Feature coverage matches the ray-sharded renderer: primary pass,
Sobel-adaptive SSAA refinement, showNormals, showAC (the BVH heatmap
debug pass stages the replicated BVH — it VISUALIZES the BVH, which
only exists replicated), strip rendering for the progress / resumable
host loops (render.pipeline routes a 2-D ('rays', 'geo') mesh here
automatically), u8 on-device quantization, and the SSAA-capacity /
transparent-queue auto-escalations via the host-facing
`render_geo_sharded`. Scenes must be BUILT with
settings.geo_shard_axis="geo" (the combine collectives are traced
into the bounce loop and the O(T) arrays then stay host-side numpy
until shard_map stages each device's shard) and can then only render
through this module.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rendering_jax.ops.pallas_intersect import (
    FusedTables,
    IntersectTables,
    _FMAX,
)
from rendering_jax.ops.sobel import sobel_mask
from rendering_jax.ops.traversal import count_ac_nodes
from rendering_jax.parallel.shard import (
    _pad_to,
    _round_robin_layout,
    _shard_map,
    assemble_frame,
)
from rendering_jax.render.integrator import (
    DEFAULT_RAY_BLOCK,
    _zero_stats,
    integrate,
    shade_normals,
)
from rendering_jax.render.raygen import pixel_dirs, ssaa_subsample_rays


def make_geo_mesh(devices=None, n_geo: int = 2) -> Mesh:
    """2-D (rays, geo) mesh over the devices; n_geo divides them."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size % n_geo == 0
    return Mesh(devices.reshape(devices.size // n_geo, n_geo),
                ("rays", "geo"))


def _axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def pad_fused_for_shards(ft: FusedTables, g: int) -> FusedTables:
    """Pad the super-chunk count to a multiple of g so P('geo') shards
    whole supers. Padding supers carry zero triangles and inverted
    boxes — the cull's validity test rejects them. Host numpy tables
    (the beyond-HBM build, scene.build_scene as_numpy) stay numpy, so
    shard_map's sharded in_specs can transfer each device only its
    shard instead of staging the padded whole on one device."""
    cs = ft.geo.sbox.shape[0]
    pad = (-cs) % g
    if pad == 0:
        return ft
    xp = np if isinstance(ft.geo.sbox, np.ndarray) else jnp
    tc, ns = ft.geo.tri_chunk, ft.geo.n_sub
    inv_box = np.concatenate(
        [np.full((pad, 3), _FMAX, np.float32),
         np.full((pad, 3), -_FMAX, np.float32),
         np.zeros((pad, 2), np.float32)], axis=1,
    )
    inv_cbox = np.repeat(inv_box, ns, axis=0)
    geo = IntersectTables(
        tc, ns, None,
        xp.concatenate(
            [ft.geo.tri, xp.zeros((pad,) + ft.geo.tri.shape[1:],
                                  np.float32)]
        ),
        xp.concatenate([ft.geo.cbox, xp.asarray(inv_cbox)]),
        xp.concatenate([ft.geo.sbox, xp.asarray(inv_box)]),
    )
    idmap = xp.concatenate(
        [ft.idmap, xp.zeros((2, pad * ns * tc), np.int32)], axis=1
    )
    return FusedTables(geo, idmap, ft.n_meshes, ft.any_clipped, ft.t_total)


def pad_vgeo_for_shards(vgeo, g: int):
    """Pad the global (30, T) vgeoT column count to a multiple of g so
    P(None, 'geo') shards whole columns. Pad columns are zeros — no
    winner vid ever points at them (idmap only holds real columns).
    Host numpy input stays numpy (see pad_fused_for_shards)."""
    t = vgeo.shape[1]
    pad = (-t) % g
    if pad == 0:
        return vgeo
    xp = np if isinstance(vgeo, np.ndarray) else jnp
    return xp.concatenate(
        [vgeo, xp.zeros((vgeo.shape[0], pad), np.float32)], axis=1
    )


def _strip_mesh_heavy(m):
    """Zero-size every per-triangle array of a MeshData so the
    replicated scene carries no O(T) payload — the fused trace reads
    only the sharded chunk tables and (shade_sharded) the sharded
    vgeoT; shading reads hit.geo and the (kept) map tables."""
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    zi = lambda *s: jnp.zeros(s, jnp.int32)  # noqa: E731
    return dataclasses.replace(
        m, v=z(0, 3, 3), n=z(0, 3, 3), uv=z(0, 3, 2), tangent=z(0, 3),
        bitangent=z(0, 3), vgeoT=z(30, 0), reach_lo=z(0, 3),
        reach_hi=z(0, 3), node_min=z(0, 3), node_max=z(0, 3),
        skip=zi(0), leaf_start=zi(0), leaf_count=zi(0),
        real_flag=zi(0), leaf_tris=zi(0), morton_perm=None,
        itables=None,
    )


def _table_args(ft: FusedTables):
    return {"tri": ft.geo.tri, "cbox": ft.geo.cbox, "sbox": ft.geo.sbox,
            "idmap": ft.idmap}


_TABLE_SPECS = {
    "tri": P("geo", None, None),
    "cbox": P("geo", None),
    "sbox": P("geo", None),
    "idmap": P(None, "geo"),
}


@dataclasses.dataclass(frozen=True)
class GeoStatic:
    """Hashable statics of a prepared geo-sharded scene — everything
    the jitted render fns need beyond the pytree leaves (part of each
    lru_cache key, so every (mesh, preparation shape) pair gets its
    own jit wrapper and trace cache)."""
    ft: tuple          # (tri_chunk, n_sub, n_meshes, any_clipped, t_total)
    fts: tuple | None  # same for the shadow tables when not aliased
    shadow_aliases: bool
    has_shadow: bool
    shade_sharded: bool


def prepare_geo_scene(scene, g: int, shade_sharded: bool):
    """Pad + split a geo-shard-built scene ONCE per render (the strip
    loops memoize it): returns (gs, scene0, tables) where `tables`
    holds every 'geo'-sharded array (host numpy stays numpy so each
    device is staged only its shard) and scene0 is the replicated
    remainder with the fused tables detached and — shade_sharded —
    every O(T) per-mesh array stripped to zero size."""
    st = scene.static
    settings = st.settings
    assert settings.geo_shard_axis == "geo", (
        "build the scene with RenderSettings(geo_shard_axis='geo')"
    )
    assert scene.fused_itables is not None, "geo sharding needs meshes"
    # The fused branch only activates with the intersection kernel;
    # without it the per-mesh fallback would iterate the (possibly
    # stripped) meshes and silently render geometry-free frames.
    from rendering_jax.render.integrator import _pallas_backend

    use_pallas, _interp = _pallas_backend(settings)
    assert use_pallas, (
        "geo sharding requires the intersection kernel (a GPU, or "
        "settings.pallas_interpret=True on the CPU)"
    )

    ft = pad_fused_for_shards(scene.fused_itables, g)
    fts = scene.fused_shadow_itables
    shadow_aliases = fts is scene.fused_itables
    fts_p = (
        ft if shadow_aliases
        else (pad_fused_for_shards(fts, g) if fts is not None else None)
    )
    scene0 = dataclasses.replace(
        scene, fused_itables=None, fused_shadow_itables=None
    )
    vgeo_p = None
    if shade_sharded:
        vt = [m.vgeoT for m in scene.meshes]
        cat = (np.concatenate
               if all(isinstance(v, np.ndarray) for v in vt)
               else jnp.concatenate)
        vgeo_p = pad_vgeo_for_shards(cat(vt, axis=1), g)
        scene0 = dataclasses.replace(
            scene0, meshes=tuple(_strip_mesh_heavy(m)
                                 for m in scene0.meshes)
        )

    tables = _table_args(ft)
    if fts_p is not None and not shadow_aliases:
        tables.update({
            "s_" + k: v for k, v in _table_args(fts_p).items()
        })
    if vgeo_p is not None:
        tables["vgeo"] = vgeo_p

    gs = GeoStatic(
        ft=(ft.geo.tri_chunk, ft.geo.n_sub, ft.n_meshes,
            ft.any_clipped, ft.t_total),
        fts=((fts_p.geo.tri_chunk, fts_p.geo.n_sub, fts_p.n_meshes,
              fts_p.any_clipped, fts_p.t_total)
             if fts_p is not None and not shadow_aliases else None),
        shadow_aliases=shadow_aliases,
        has_shadow=fts_p is not None,
        shade_sharded=shade_sharded,
    )
    return gs, scene0, tables


def _specs_for(gs: GeoStatic) -> dict:
    specs = dict(_TABLE_SPECS)
    if gs.fts is not None:
        specs.update({"s_" + k: v for k, v in _TABLE_SPECS.items()})
    if gs.shade_sharded:
        specs["vgeo"] = P(None, "geo")
    return specs


def stage_geo_prepared(gs: GeoStatic, scene0, tables, mesh: Mesh):
    """device_put the prepared inputs with their ACTUAL shardings —
    each table along its P(... 'geo' ...) spec (each device receives
    only its 1/G shard), the scene remainder replicated. Host numpy
    arrays transfer ONCE here; subsequent render/strip calls see
    committed device arrays and move zero bytes (without this, every
    call — every STRIP — re-ships the full table set through the
    shard_map staging path). The staged arrays pin device memory for
    as long as the
    caller holds them — exactly the resident acceleration structure."""
    specs = _specs_for(gs)
    staged_tables = {
        k: jax.device_put(v, NamedSharding(mesh, specs[k]))
        for k, v in tables.items()
    }
    staged_scene0 = jax.tree_util.tree_map(
        lambda leaf: (jax.device_put(leaf, NamedSharding(mesh, P()))
                      if hasattr(leaf, "shape") else leaf),
        scene0,
    )
    return gs, staged_scene0, staged_tables


def _local_scene(scene0, tables, gs: GeoStatic):
    """Reassemble the full scene INSIDE the shard_map body from the
    replicated remainder + this device's table shards, then re-derive
    the transposed gather tables (gradients flow; stripped meshes
    derive zero-size tables that the sharded-vgeoT branch ignores)."""
    from rendering_jax.render.pipeline import derive_mesh_tables

    tc, ns, nm, clip, tt = gs.ft
    ft_l = FusedTables(
        IntersectTables(tc, ns, None, tables["tri"], tables["cbox"],
                        tables["sbox"]),
        tables["idmap"], nm, clip, tt,
    )
    if not gs.has_shadow:
        fts_l = None
    elif gs.shadow_aliases:
        fts_l = ft_l
    else:
        stc, sns, snm, sclip, stt = gs.fts
        fts_l = FusedTables(
            IntersectTables(stc, sns, None, tables["s_tri"],
                            tables["s_cbox"], tables["s_sbox"]),
            tables["s_idmap"], snm, sclip, stt,
        )
    s = dataclasses.replace(
        scene0, fused_itables=ft_l, fused_shadow_itables=fts_l,
        vgeoT_sharded=tables.get("vgeo"),
    )
    return derive_mesh_tables(s)


# check_vma=False on every Pallas-bearing shard_map below: the
# interpret-mode Pallas lowering (the CPU test path) trips an internal
# lowering-cache KeyError under a 2-axis manual mesh with vma tracking
# on (jax 0.9); these wrappers are forward-only, every cross-shard
# combine is explicit (pmin/psum in the integrator's fused branches),
# and equality tests pin the results, so the static vma check buys
# nothing here.


@functools.lru_cache(maxsize=32)
def _geo_integrate_fn(mesh: Mesh, gs: GeoStatic, ray_block: int,
                      queue_headroom: int):
    """Jitted (scene0, tables, xs, ys) -> (accum3 (3, rp) in global
    slot order over 'rays', psum'd stats). showNormals branches on
    scene0's static settings (part of the jit cache key)."""

    def local(scene0, tables, xs_l, ys_l):
        s = _local_scene(scene0, tables, gs)
        st = s.static
        rd = pixel_dirs(s, xs_l, ys_l, 1.0, 1.0)
        ro = jnp.broadcast_to(s.cam_pos, rd.shape)
        nloc = xs_l.shape[0]
        if st.settings.show_normals:
            # shade_normals traces through trace_closest, whose fused
            # branch carries the cross-'geo' hit combine — the normals
            # frame is geo-unvarying like the shaded one.
            accum3 = shade_normals(s, ro, rd, ray_block=ray_block)
            stats = _zero_stats()
        else:
            accum3, stats = integrate(
                s, ro, rd, jnp.arange(nloc, dtype=jnp.int32),
                jnp.ones((nloc,), jnp.float32), n_pixels=nloc,
                ray_block=ray_block, out_slots=not st.any_bouncing,
                queue_headroom=queue_headroom,
            )
        # All stats leaves are 'geo'-unvarying by here (the fused
        # combines psum the per-shard counters over 'geo' already);
        # one psum over the ray shards finishes the totals.
        stats = {k: jax.lax.psum(v, "rays") for k, v in stats.items()}
        return accum3, stats

    def fn(scene0, tables, xs, ys):
        return _shard_map(
            local, mesh=mesh,
            in_specs=(P(), _specs_for(gs), P("rays"), P("rays")),
            out_specs=(P(None, "rays"), P()),
            check_vma=False,
        )(scene0, tables, xs, ys)

    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def _geo_strip_fn(mesh: Mesh, gs: GeoStatic, ray_block: int,
                  queue_headroom: int):
    """Jitted strip renderer with the shard.render_strip_sharded
    contract: (scene0, tables, y0, rows) -> (STRIP-SIZED flat
    (3, rows*W) accumulator, psum'd stats); rows static, y0 traced."""
    base = _geo_integrate_fn(mesh, gs, ray_block, queue_headroom)
    ndev_r = _axis_sizes(mesh)["rays"]

    @functools.partial(jax.jit, static_argnames=("rows",))
    def fn(scene0, tables, y0, rows: int):
        st = scene0.static
        w = st.settings.width
        r = rows * w
        rp, perm = _round_robin_layout(r, ndev_r, (w, rows))
        local_pix = jnp.minimum(perm, r - 1)
        xs = (local_pix % w).astype(jnp.float32)
        ys = (y0 + local_pix // w).astype(jnp.float32)
        accum3, stats = base(scene0, tables, xs, ys)
        if st.settings.show_normals:
            stats["rays_casted"] = jnp.asarray(r, jnp.float32)
        from rendering_jax.parallel.shard import unpermute_slots

        return unpermute_slots(accum3, r, w, rows, ndev_r), stats

    return fn


@functools.lru_cache(maxsize=32)
def _geo_ssaa_fn(mesh: Mesh, gs: GeoStatic, ray_block: int,
                 capacity: int, queue_headroom: int):
    """Jitted Sobel-adaptive refinement with the pipeline._ssaa_pass
    contract: (scene0, tables, frame3) -> (frame3, n_masked, stats).
    Edge-pixel indices shard over 'rays'; each subsample ray's trace
    combines over 'geo' inside the integrator, so the psum'd
    refinement accumulator is unvarying over both axes."""
    ndev_r = _axis_sizes(mesh)["rays"]
    cap = _pad_to(capacity, ndev_r)

    def local(scene0, tables, idx_l, valid_l):
        s = _local_scene(scene0, tables, gs)
        st = s.static
        w, h = st.settings.width, st.settings.height
        ro, rd, pixk, wt = ssaa_subsample_rays(s, idx_l, valid_l, w)
        if st.settings.show_normals:
            colors3 = shade_normals(s, ro, rd, ray_block=ray_block)
            accum3 = (
                jnp.zeros((3, w * h), jnp.float32)
                .at[:, pixk]
                .add(wt[None, :] * colors3)
            )
            stats = _zero_stats()
        elif st.any_bouncing:
            accum3, stats = integrate(
                s, ro, rd, pixk, wt, n_pixels=w * h,
                ray_block=ray_block, queue_headroom=queue_headroom,
            )
        else:
            # Slot accumulation (pipeline._ssaa_pass): subsample i of
            # masked pixel k sits at slot i*nloc + k; one reshape-sum
            # collapses the 4 slots, fill lanes add exact zeros.
            nloc = idx_l.shape[0]
            slots3, stats = integrate(
                s, ro, rd, pixk, wt, n_pixels=w * h,
                ray_block=ray_block, out_slots=True,
            )
            summed3 = jnp.sum(slots3.reshape(3, 4, nloc), axis=1)
            accum3 = (
                jnp.zeros((3, w * h), jnp.float32)
                .at[:, idx_l].add(summed3)
            )
        accum3 = jax.lax.psum(accum3, "rays")
        stats = {k: jax.lax.psum(v, "rays") for k, v in stats.items()}
        return accum3, stats

    def fn(scene0, tables, frame3):
        st = scene0.static
        w, h = st.settings.width, st.settings.height
        mask = sobel_mask(frame3)
        flat_mask = mask.reshape(-1)
        n_masked = jnp.sum(flat_mask.astype(jnp.int32))
        (idx,) = jnp.nonzero(flat_mask, size=cap, fill_value=w * h)
        valid = idx < w * h
        idx_c = jnp.minimum(idx, w * h - 1).astype(jnp.int32)
        accum3, stats = _shard_map(
            local, mesh=mesh,
            in_specs=(P(), _specs_for(gs), P("rays"), P("rays")),
            out_specs=(P(), P()),
            check_vma=False,
        )(scene0, tables, idx_c, valid)
        refined3 = accum3.reshape(3, h, w)
        frame3 = jnp.where(mask[None, :, :], refined3, frame3)
        return frame3, n_masked, stats

    return jax.jit(fn)


def _strip_for_ac(m):
    """Keep only what count_ac_nodes reads (node boxes / skip links /
    real flags) plus small leaves; the shading-side O(T) arrays stay
    host-side instead of being staged replicated for a debug pass."""
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    zi = lambda *s: jnp.zeros(s, jnp.int32)  # noqa: E731
    return dataclasses.replace(
        m, v=z(0, 3, 3), n=z(0, 3, 3), uv=z(0, 3, 2), tangent=z(0, 3),
        bitangent=z(0, 3), vgeoT=z(30, 0), reach_lo=z(0, 3),
        reach_hi=z(0, 3), leaf_tris=zi(0), morton_perm=None,
        itables=None,
    )


def _show_ac_geo(scene, mesh: Mesh, *, ray_block=DEFAULT_RAY_BLOCK):
    """showAC heatmap on the 2-D mesh: per-ray BVH node-visit counts,
    sharded over 'rays', replicated over 'geo'. The BVH node arrays ARE
    what this debug pass visualizes, so they stage replicated (they are
    O(T / leaf_chunk), ~8x smaller than the triangle payload); the
    fused tables and shading arrays stay host-side."""
    del ray_block
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ndev_r = _axis_sizes(mesh)["rays"]
    scene_ac = dataclasses.replace(
        scene, fused_itables=None, fused_shadow_itables=None,
        meshes=tuple(_strip_for_ac(m) for m in scene.meshes),
    )
    r = w * h
    rp = _pad_to(r, ndev_r)
    pix = jnp.arange(rp, dtype=jnp.int32)
    xs = (pix % w).astype(jnp.float32)
    ys = jnp.minimum(pix // w, h - 1).astype(jnp.float32)

    def local(scene_ac, xs_l, ys_l):
        rd = pixel_dirs(scene_ac, xs_l, ys_l, 0.5, 0.5)
        ro = jnp.broadcast_to(scene_ac.cam_pos, rd.shape)
        counts = jnp.zeros((xs_l.shape[0],), jnp.int32)
        for mesh_data in scene_ac.meshes:
            counts = counts + count_ac_nodes(
                mesh_data, ro, rd, use_ac=st.settings.use_ac
            )
        return counts

    counts = _shard_map(
        local, mesh=mesh, in_specs=(P(), P("rays"), P("rays")),
        out_specs=P("rays"),
    )(scene_ac, xs, ys)[:r]
    ac_max = jnp.maximum(jnp.max(counts), 1)
    val = counts.astype(jnp.float32) / ac_max.astype(jnp.float32)
    return jnp.broadcast_to(val[None, :], (3, r)).reshape(3, h, w)


def render_scene_geo_sharded(scene, mesh: Mesh,
                             ray_block: int = DEFAULT_RAY_BLOCK,
                             shade_sharded: bool = False,
                             ssaa_capacity: int | None = None,
                             queue_headroom: int = 1,
                             out_u8: bool = False,
                             _prepared=None):
    """Full render with rays sharded over 'rays' and the fused geometry
    tables sharded over 'geo': primary pass + adaptive SSAA + debug
    modes, matching render_scene u8-exactly (pinned by
    tests/test_geoshard.py). Returns (frame3 (3, H, W), aux) with the
    render_scene aux contract ({"stats", "ssaa_masked"}); out_u8
    returns the (H, W, 3) u8 frame instead. The scene must be built
    with settings.geo_shard_axis == 'geo'.

    shade_sharded=True additionally shards the (30, T) shading table
    column-wise over 'geo' and strips every replicated per-triangle
    array from the scene, so NOTHING O(T) is replicated — the full
    beyond-HBM mode. Output is identical (u8-exact, pinned)."""
    from rendering_jax.render.pipeline import quantize_u8

    st = scene.static
    settings = st.settings
    if settings.show_ac:
        frame3 = _show_ac_geo(scene, mesh)
        return (quantize_u8(frame3) if out_u8 else frame3), {
            "stats": _zero_stats(),
            "ssaa_masked": jnp.zeros((), jnp.int32),
        }
    g = _axis_sizes(mesh)["geo"]
    gs, scene0, tables = (
        _prepared if _prepared is not None
        else stage_geo_prepared(
            *prepare_geo_scene(scene, g, shade_sharded), mesh
        )
    )
    capacity = 0
    if settings.enable_ssaa:
        capacity = ssaa_capacity or max(
            1, int(settings.width * settings.height
                   * settings.ssaa_capacity_fraction)
        )
    return _geo_full_render_fn(
        mesh, gs, ray_block, capacity, queue_headroom, out_u8
    )(scene0, tables)


@functools.lru_cache(maxsize=32)
def _geo_full_render_fn(mesh: Mesh, gs: GeoStatic, ray_block: int,
                        ssaa_capacity: int, queue_headroom: int,
                        out_u8: bool):
    """ONE jitted program for the whole geo-sharded render — raygen,
    slot layout, shard_map'd integrate, frame assembly, SSAA, u8
    quantization. Nothing runs eagerly per call: every eager jnp op is
    a separate host->device dispatch."""
    from rendering_jax.render.pipeline import quantize_u8

    base = _geo_integrate_fn(mesh, gs, ray_block, queue_headroom)
    ssaa = (_geo_ssaa_fn(mesh, gs, ray_block, ssaa_capacity,
                         queue_headroom)
            if ssaa_capacity else None)
    ndev_r = _axis_sizes(mesh)["rays"]

    @jax.jit
    def fn(scene0, tables):
        st = scene0.static
        settings = st.settings
        w, h = settings.width, settings.height
        r = w * h
        rp, perm = _round_robin_layout(r, ndev_r, (w, h))
        xs = (perm % w).astype(jnp.float32)
        ys = jnp.minimum(perm // w, h - 1).astype(jnp.float32)
        accum3, stats = base(scene0, tables, xs, ys)
        if settings.show_normals:
            stats["rays_casted"] = jnp.asarray(r, jnp.float32)
        frame3 = assemble_frame(accum3, perm, rp, r, w, h, ndev_r)
        n_masked = jnp.zeros((), jnp.int32)
        if ssaa is not None:
            frame3, n_masked, s2 = ssaa(scene0, tables, frame3)
            stats = {k: stats[k] + s2[k] for k in stats}
        if out_u8:
            return quantize_u8(frame3), {"stats": stats,
                                         "ssaa_masked": n_masked}
        return frame3, {"stats": stats, "ssaa_masked": n_masked}

    return fn


def render_geo_sharded(scene, mesh: Mesh, shade_sharded: bool = True,
                       ray_block: int = DEFAULT_RAY_BLOCK,
                       out_u8: bool = False):
    """Host-facing geometry-sharded render: ((H, W, 3) numpy frame,
    aux), with the same SSAA-capacity / transparent-queue
    auto-escalations as pipeline.render (escalating_render). The
    preparation (table padding / stripping) runs once and is reused
    across escalation redos."""
    from rendering_jax.render.pipeline import escalating_render

    g = _axis_sizes(mesh)["geo"]
    prep = None
    if not scene.static.settings.show_ac:
        prep = stage_geo_prepared(
            *prepare_geo_scene(scene, g, shade_sharded), mesh
        )
    frame3, aux = escalating_render(
        lambda ssaa_cap, headroom: render_scene_geo_sharded(
            scene, mesh, ray_block=ray_block, shade_sharded=shade_sharded,
            ssaa_capacity=ssaa_cap, queue_headroom=headroom,
            out_u8=out_u8, _prepared=prep,
        ),
        scene.static.settings,
        cap_pad=_axis_sizes(mesh)["rays"],
    )
    if out_u8:
        return np.asarray(frame3), aux
    return np.asarray(frame3).transpose(1, 2, 0), aux


def make_geo_strip_fns(mesh: Mesh, ray_block: int,
                       queue_headroom: int = 1,
                       shade_sharded: bool = True):
    """(strip_fn, ssaa_fn) with the pipeline._make_strip_fns contract
    — strip_fn(scene, y0=, rows=) / ssaa_fn(scene, frame3, capacity) —
    for the progress / resumable strip loops over a 2-D ('rays',
    'geo') mesh. The per-scene preparation (table padding, stripping)
    is memoized on the scene's fused-tables identity, so a strip loop
    prepares once, not once per strip."""
    g = _axis_sizes(mesh)["geo"]
    memo: dict = {}

    def prep_for(scene):
        key = scene.fused_itables
        hit = memo.get("k")
        if hit is not None and hit[0] is key:
            return hit[1]
        # Stage once per scene: the strip loop then moves ZERO table
        # bytes per strip (the tables are committed device shards).
        prep = stage_geo_prepared(
            *prepare_geo_scene(scene, g, shade_sharded), mesh
        )
        memo["k"] = (key, prep)
        return prep

    def strip_fn(scene, *, y0, rows: int):
        gs, scene0, tables = prep_for(scene)
        return _geo_strip_fn(mesh, gs, ray_block, queue_headroom)(
            scene0, tables, y0, rows
        )

    def ssaa_fn(scene, frame3, capacity):
        gs, scene0, tables = prep_for(scene)
        return _geo_ssaa_fn(mesh, gs, ray_block, capacity,
                            queue_headroom)(scene0, tables, frame3)

    return strip_fn, ssaa_fn


def geo_shard_memory_accounting(scene, mesh: Mesh,
                                shade_sharded: bool = True) -> dict:
    """Stage the prepared render inputs with their ACTUAL shardings
    (NamedSharding device_put — the same placement shard_map's
    in_specs produce) and measure per-device bytes from the staged
    buffers themselves. Returns
      {"sharded_bytes_device0", "replicated_bytes_device0",
       "per_device_bytes_device0", "sharded_bytes_total",
       "staged": {name: array}}
    where device0 is the first mesh device. The beyond-HBM claim is
    the assertion that sharded_bytes_device0 ~ sharded_bytes_total/G
    and replicated_bytes_device0 does not grow with triangle count
    (tests/test_geoshard.py pins both at >= 1M triangles)."""
    g = _axis_sizes(mesh)["geo"]
    gs, scene0, staged = stage_geo_prepared(
        *prepare_geo_scene(scene, g, shade_sharded), mesh
    )
    dev0 = mesh.devices.reshape(-1)[0]

    def dev0_bytes(arr) -> int:
        return sum(
            sh.data.nbytes for sh in arr.addressable_shards
            if sh.device == dev0
        )

    sharded_dev0 = 0
    sharded_total = 0
    for v in staged.values():
        sharded_dev0 += dev0_bytes(v)
        sharded_total += v.nbytes
    repl_dev0 = 0
    for leaf in jax.tree_util.tree_leaves(scene0):
        if hasattr(leaf, "nbytes"):
            repl_dev0 += dev0_bytes(leaf)
    return {
        "sharded_bytes_device0": int(sharded_dev0),
        "replicated_bytes_device0": int(repl_dev0),
        "per_device_bytes_device0": int(sharded_dev0 + repl_dev0),
        "sharded_bytes_total": int(sharded_total),
        "staged": staged,
    }

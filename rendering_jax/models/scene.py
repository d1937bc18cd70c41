"""Scene pytree — the device-side scene representation.

The reference keeps a polymorphic object graph (`Scene` owning
`vector<unique_ptr<Object>>` / `vector<unique_ptr<Light>>`,
include/scene.h:68-100). Here the scene is a PYTREE of
struct-of-arrays leaves: spheres/planes as (N, 3) tables, each mesh as
flat triangle + BVH arrays, lights as small per-light pytrees with
static kind, materials as per-object parameter rows. Every float leaf
is a differentiable input to the renderer; everything shape- or
branch-determining lives in `SceneStatic` (a hashable meta field, so
`jax.jit` specializes on it automatically).

Material enum order matches the reference (include/objects.h:17):
0=Diffuse, 1=Reflective, 2=Transparent, 3=Phong.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rendering_jax.accel.bvh import FlatBVH, build_bvh, morton_order
from rendering_jax.models.objloader import euler_matrix
from rendering_jax.models.parser import SceneDef, parse_scene
from rendering_jax.models.settings import RenderSettings

MAT_DIFFUSE, MAT_REFLECTIVE, MAT_TRANSPARENT, MAT_PHONG = 0, 1, 2, 3
_MAT_IDS = {
    "diffuse": MAT_DIFFUSE,
    "reflective": MAT_REFLECTIVE,
    "transparent": MAT_TRANSPARENT,
    "phong": MAT_PHONG,
}
KIND_SPHERE, KIND_PLANE, KIND_MESH = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class MeshStatic:
    n_tris: int
    n_nodes: int
    leaf_chunk: int
    n_real_nodes: int
    tri_copies: int = 0  # stats::triCopiesCount analogue (BVH duplication)
    dmap_wh: tuple[int, int] = (0, 0)
    nmap_wh: tuple[int, int] = (0, 0)
    smap_wh: tuple[int, int] = (0, 0)
    # Common (W, H) when >= 2 maps are present with identical dims:
    # they share texel indices, so one 7-row gather (diffuse rgb |
    # normal xyz | specular) replaces up to three per-map gathers —
    # a gather costs per index more than per row. (0, 0) = unpacked.
    pmap_wh: tuple[int, int] = (0, 0)

    @property
    def has_diffuse_map(self) -> bool:
        return self.dmap_wh[0] > 0

    @property
    def has_normal_map(self) -> bool:
        return self.nmap_wh[0] > 0

    @property
    def has_specular_map(self) -> bool:
        return self.smap_wh[0] > 0

    @property
    def has_packed_maps(self) -> bool:
        return self.pmap_wh[0] > 0


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    settings: RenderSettings
    obj_kinds: tuple[int, ...]      # KIND_* per object, scene order
    obj_subs: tuple[int, ...]       # index within the kind's table
    mat_types: tuple[int, ...]      # MAT_* per object (static copy)
    light_kinds: tuple[str, ...]    # "distant" | "point" | "area"
    light_samples: tuple[int, ...]
    meshes: tuple[MeshStatic, ...]
    skybox_wh: tuple[int, int] = (0, 0)

    @property
    def n_objects(self) -> int:
        return len(self.obj_kinds)

    @property
    def n_spheres(self) -> int:
        return sum(1 for k in self.obj_kinds if k == KIND_SPHERE)

    @property
    def n_planes(self) -> int:
        return sum(1 for k in self.obj_kinds if k == KIND_PLANE)

    @property
    def n_meshes(self) -> int:
        return len(self.meshes)

    @property
    def has_skybox(self) -> bool:
        return self.skybox_wh[0] > 0

    @property
    def any_bouncing(self) -> bool:
        """True if any material spawns secondary rays."""
        return any(m in (MAT_REFLECTIVE, MAT_TRANSPARENT) for m in self.mat_types)

    @property
    def any_transparent(self) -> bool:
        return any(m == MAT_TRANSPARENT for m in self.mat_types)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MeshData:
    v: jnp.ndarray          # (T, 3, 3)
    n: jnp.ndarray          # (T, 3, 3)
    uv: jnp.ndarray         # (T, 3, 2)
    tangent: jnp.ndarray    # (T, 3)
    bitangent: jnp.ndarray  # (T, 3)
    # ONE combined transposed gather table (component-major, minor dim
    # = T): rows 0-8 vertices, 9-17 vertex normals, 18-23 uvs, 24-26
    # tangent, 27-29 bitangent. A per-ray gather from it produces a
    # (30, Q) buffer (rays on the minor dim), and since a gather costs
    # per index more than per row, one 30-row gather (and one gradient
    # scatter) replaces what were six.
    vgeoT: jnp.ndarray      # (30, T)
    reach_lo: jnp.ndarray   # (T, 3) — see accel.bvh.FlatBVH.reach_lo
    reach_hi: jnp.ndarray   # (T, 3)
    node_min: jnp.ndarray   # (N, 3)
    node_max: jnp.ndarray   # (N, 3)
    skip: jnp.ndarray       # (N,) i32
    leaf_start: jnp.ndarray  # (N,) i32
    leaf_count: jnp.ndarray  # (N,) i32
    real_flag: jnp.ndarray   # (N,) i32
    leaf_tris: jnp.ndarray   # (L,) i32
    diffuse_map: Optional[jnp.ndarray]   # (Hd*Wd, 3) or None
    normal_map: Optional[jnp.ndarray]    # (Hn*Wn, 3) or None
    specular_map: Optional[jnp.ndarray]  # (Hs*Ws, 1) or None
    # Spatial triangle permutation (accel.bvh.morton_order); the dense
    # Pallas kernel iterates triangles in this order for tight chunk
    # AABBs and maps hit ids back. All other arrays stay in load order.
    # Packed transposed map table (7, Wp*Hp): rows 0-2 diffuse rgb,
    # 3-5 normal xyz, 6 specular (zeros for absent maps). Derived
    # IN-GRAPH from the per-map arrays by pipeline.derive_mesh_tables
    # when MeshStatic.pmap_wh is set, so map-texel gradients flow.
    mapsT: Optional[jnp.ndarray] = None
    morton_perm: Optional[jnp.ndarray] = None  # (T,) i32
    # Prebuilt kernel-format chunk tables (ops.pallas_intersect
    # .IntersectTables) — the baked acceleration structure for the
    # fused intersection kernel. None on hand-built test meshes.
    itables: Optional[object] = None
    leaf_chunk: int = dataclasses.field(metadata=dict(static=True), default=8)
    # True when the mesh's true AABB pokes outside the reference's root
    # box (rotated meshes) — only then does dense intersection need the
    # reachability filter (ops/bruteforce.make_aabb_acceptor).
    clipped_by_root: bool = dataclasses.field(metadata=dict(static=True),
                                              default=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LightData:
    color: jnp.ndarray      # (3,)
    intensity: jnp.ndarray  # ()
    dir: jnp.ndarray        # (3,) distant — normalized
    pos: jnp.ndarray        # (3,) point / area
    ivec: jnp.ndarray       # (3,) area basis
    jvec: jnp.ndarray       # (3,)
    kind: str = dataclasses.field(metadata=dict(static=True), default="point")
    samples: int = dataclasses.field(metadata=dict(static=True), default=1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneData:
    cam_pos: jnp.ndarray    # (3,)
    cam_rmat: jnp.ndarray   # (3, 3) row-vector convention: d' = d @ R
    scale: jnp.ndarray      # () tan(fov/2)
    bg_color: jnp.ndarray   # (3,)
    bias: jnp.ndarray       # ()
    obj_color: jnp.ndarray  # (No, 3)
    obj_ior: jnp.ndarray    # (No,)
    obj_ambient: jnp.ndarray   # (No,)
    obj_diffuse: jnp.ndarray   # (No,)
    obj_specular: jnp.ndarray  # (No,)
    obj_nspec: jnp.ndarray     # (No,)
    mat_type: jnp.ndarray      # (No,) i32
    sph_pos: jnp.ndarray    # (Ns, 3)
    sph_r: jnp.ndarray      # (Ns,)
    pln_pos: jnp.ndarray    # (Np, 3)
    pln_n: jnp.ndarray      # (Np, 3) normalized
    meshes: tuple           # tuple[MeshData, ...]
    lights: tuple           # tuple[LightData, ...]
    skybox: Optional[jnp.ndarray]  # (6, H, W, 3)
    # Fused multi-mesh chunk tables (ops.pallas_intersect.FusedTables):
    # baked when the scene has >= 2 meshes so trace_closest /
    # trace_occlusion issue ONE kernel dispatch per ray block
    # regardless of mesh count (the reference's per-object loop,
    # scene.cpp:724-756, has no per-object launch cost to mirror).
    # The shadow tables exclude transparent meshes (scene.cpp:733-734);
    # they alias fused_itables when no mesh is transparent.
    fused_itables: Optional[object] = None
    fused_shadow_itables: Optional[object] = None
    # Shading-side geometry shard (parallel.geoshard shade_sharded):
    # the concatenated global (30, T_pad) vgeoT table physically
    # sharded column-wise over the 'geo' mesh axis. When set, the
    # fused trace gathers surface rows from the LOCAL column range and
    # psums the masked rows across 'geo' instead of reading a
    # replicated per-mesh vgeoT — each device then holds only 1/G of
    # the per-triangle shading data (beyond-HBM scenes). None outside
    # render_scene_geo_sharded(shade_sharded=True).
    vgeoT_sharded: Optional[jnp.ndarray] = None
    static: SceneStatic = dataclasses.field(metadata=dict(static=True), default=None)


def _packable_wh(o) -> tuple[int, int]:
    """Shared (W, H) if >= 2 of the object's maps exist with identical
    dims (they then share texel indices and one packed gather serves
    all of them); (0, 0) otherwise."""
    whs = []
    if o.diffuse_map is not None:
        whs.append(tuple(o.diffuse_map_wh))
    if o.normal_map is not None:
        whs.append(tuple(o.normal_map_wh))
    if o.specular_map is not None:
        whs.append(tuple(o.specular_map_wh))
    if len(whs) >= 2 and all(wh == whs[0] for wh in whs):
        return whs[0]
    return (0, 0)


def build_scene(sd: SceneDef, *,
                bake_per_mesh_tables: bool | None = None) -> SceneData:
    st = sd.settings
    f32 = np.float32

    obj_kinds, obj_subs, mat_types = [], [], []
    colors, iors, ambients, diffuses, speculars, nspecs = [], [], [], [], [], []
    sph_pos, sph_r = [], []
    pln_pos, pln_n = [], []
    meshes, mesh_statics = [], []
    mesh_host_views, mesh_obj_idx = [], []

    # Multi-mesh scenes never read the per-mesh kernel tables: with
    # n_meshes >= 2 (a static) the pallas path always takes the FUSED
    # branch (integrator.trace_closest/_occlusion) and the non-pallas
    # fallbacks use the BVH/dense arrays. Skip baking them — otherwise
    # every multi-mesh scene holds its ~16 f32/triangle tables twice
    # (per-mesh + fused) in device memory for life. Single-mesh scenes
    # keep theirs even under geometry sharding (post-build settings
    # surgery may drop the geo axis and take the per-mesh path).
    # bake_per_mesh_tables=True overrides the skip (the fused-vs-
    # per-mesh A/B harness strips fused_itables post-build and drives
    # the per-mesh loop directly).
    n_mesh_objs = sum(1 for o in sd.objects if o.kind == "mesh")
    auto_skip = n_mesh_objs >= 2
    will_fuse = (auto_skip if bake_per_mesh_tables is None
                 else not bake_per_mesh_tables)
    # The fused tables below are gated on >= 2 meshes (or geometry
    # sharding); an explicit bake_per_mesh_tables=False on a scene that
    # will not bake them either would leave meshes with NO kernel
    # tables at all — the Pallas path would then try to build tables
    # host-side under jit and fail far from the cause. Fail here.
    if (bake_per_mesh_tables is False and n_mesh_objs
            and not (n_mesh_objs >= 2 or st.geo_shard_axis is not None)):
        raise ValueError(
            "bake_per_mesh_tables=False on a single-mesh scene without "
            "geometry sharding would leave the mesh with neither "
            "per-mesh nor fused kernel tables"
        )

    for o in sd.objects:
        mat_types.append(_MAT_IDS[o.material])
        colors.append(o.color)
        iors.append(o.ior)
        ambients.append(o.ambient)
        diffuses.append(o.diffuse)
        speculars.append(o.specular)
        nspecs.append(o.n_specular)
        if o.kind == "sphere":
            obj_kinds.append(KIND_SPHERE)
            obj_subs.append(len(sph_pos))
            sph_pos.append(o.pos)
            sph_r.append(o.radius)
        elif o.kind == "plane":
            obj_kinds.append(KIND_PLANE)
            obj_subs.append(len(pln_pos))
            pln_pos.append(o.pos)
            # NOT normalized: the scene parser assigns `normal=` directly
            # (scene.cpp:299-301), bypassing the Plane ctor's normalize.
            # Scene-loaded plane normals keep their raw magnitude.
            pln_n.append(np.asarray(o.normal, dtype=np.float32))
        elif o.kind == "mesh":
            obj_kinds.append(KIND_MESH)
            obj_subs.append(len(meshes))
            m = o.mesh
            if m is None:
                raise ValueError("mesh object without loaded OBJ (missing name=)")
            # Canonicalize triangle order to the Morton (Z-curve)
            # permutation at build: the intersection kernel's chunk
            # tables need spatial contiguity, and storing EVERYTHING in
            # that order removes a 250k-entry id-remap gather per
            # oracle call. BVH node geometry is order-independent
            # (splits are coordinate searches over bounds), so goldens
            # and AC counts are unaffected; only equal-t tie-breaks can
            # shift, same caveat as the reference's leaf-DFS order.
            if m.n_tris:
                mp = np.asarray(morton_order(m.v))
                m = dataclasses.replace(
                    m, v=m.v[mp], n=m.n[mp], uv=m.uv[mp],
                    tangent=m.tangent[mp], bitangent=m.bitangent[mp],
                )
            bvh: FlatBVH = build_bvh(
                m.v, m.root_bounds, ac_penalty=st.ac_penalty,
                leaf_chunk=st.leaf_chunk,
            )
            t_count = m.n_tris
            if t_count:
                clipped = bool(
                    np.any(m.v.min(axis=(0, 1)) < m.root_bounds[0])
                    or np.any(m.v.max(axis=(0, 1)) > m.root_bounds[1])
                )
            else:
                clipped = False
            vgeoT_np = np.concatenate([
                m.v.reshape(t_count, 9).T,
                m.n.reshape(t_count, 9).T,
                m.uv.reshape(t_count, 6).T,
                m.tangent.T,
                m.bitangent.T,
            ], axis=0).copy()
            # Under geometry sharding EVERY O(T) array stays a HOST
            # numpy view until render time: the shade-sharded path
            # shards vgeoT over 'geo' and strips the rest
            # (parallel.geoshard), and even the table-sharded path only
            # stages what shard_map's in_specs ask for. An unconditional
            # jnp.asarray here would stage the full per-triangle payload
            # (~30 f32/tri + BVH) on one device at BUILD time — a scene
            # that exceeds one chip's HBM (the beyond-HBM target) would
            # OOM before shard_map ever ran.
            stage = ((lambda a: a) if st.geo_shard_axis is not None
                     else jnp.asarray)
            meshes.append(
                MeshData(
                    v=stage(m.v),
                    n=stage(m.n),
                    uv=stage(m.uv),
                    tangent=stage(m.tangent),
                    bitangent=stage(m.bitangent),
                    vgeoT=stage(vgeoT_np),
                    reach_lo=stage(bvh.reach_lo),
                    reach_hi=stage(bvh.reach_hi),
                    node_min=stage(bvh.node_min),
                    node_max=stage(bvh.node_max),
                    skip=stage(bvh.skip),
                    leaf_start=stage(bvh.leaf_start),
                    leaf_count=stage(bvh.leaf_count),
                    real_flag=stage(bvh.real_flag),
                    leaf_tris=stage(bvh.leaf_tris),
                    diffuse_map=(
                        jnp.asarray(o.diffuse_map) if o.diffuse_map is not None else None
                    ),
                    normal_map=(
                        jnp.asarray(o.normal_map) if o.normal_map is not None else None
                    ),
                    specular_map=(
                        jnp.asarray(o.specular_map)
                        if o.specular_map is not None
                        else None
                    ),
                    morton_perm=None,  # arrays already Morton-ordered
                    leaf_chunk=st.leaf_chunk,
                    clipped_by_root=clipped,
                )
            )
            # Bake the kernel chunk tables (the reference builds its
            # BVH here too, src/objects.cpp:389). Kept out of the traced
            # render AND built from the HOST-side numpy arrays, so the
            # table math never reads the device copies above back.
            import types

            from rendering_jax.ops.pallas_intersect import (
                build_intersect_tables,
                default_tri_chunk,
            )

            host_mesh = types.SimpleNamespace(
                v=m.v,
                reach_lo=bvh.reach_lo,
                reach_hi=bvh.reach_hi,
                morton_perm=None,  # arrays already Morton-ordered
            )
            if not will_fuse:
                meshes[-1] = dataclasses.replace(
                    meshes[-1],
                    itables=build_intersect_tables(
                        host_mesh, tri_chunk=default_tri_chunk(t_count)
                    ),
                )
            mesh_host_views.append(host_mesh)
            mesh_obj_idx.append(len(obj_kinds) - 1)
            mesh_statics.append(
                MeshStatic(
                    n_tris=m.n_tris,
                    n_nodes=bvh.n_nodes,
                    leaf_chunk=st.leaf_chunk,
                    n_real_nodes=bvh.n_real_nodes,
                    tri_copies=bvh.tri_copies,
                    dmap_wh=o.diffuse_map_wh if o.diffuse_map is not None else (0, 0),
                    nmap_wh=o.normal_map_wh if o.normal_map is not None else (0, 0),
                    smap_wh=o.specular_map_wh if o.specular_map is not None else (0, 0),
                    pmap_wh=_packable_wh(o),
                )
            )
        else:
            raise ValueError(f"unknown object kind {o.kind}")

    lights = tuple(
        LightData(
            color=jnp.asarray(l.color, jnp.float32),
            intensity=jnp.asarray(l.intensity, jnp.float32),
            # NOT normalized: `direction=` is assigned raw by the parser
            # (scene.cpp:219-223), bypassing the DistantLight ctor's
            # normalize — N.L and the specular pow are scaled by |dir|
            # for scene-loaded distant lights. Replicated bug-for-bug.
            dir=jnp.asarray(l.dir, jnp.float32),
            pos=jnp.asarray(l.pos, jnp.float32),
            ivec=jnp.asarray(l.i, jnp.float32),
            jvec=jnp.asarray(l.j, jnp.float32),
            kind=l.kind,
            samples=l.samples,
        )
        for l in sd.lights
    )

    static = SceneStatic(
        settings=st,
        obj_kinds=tuple(obj_kinds),
        obj_subs=tuple(obj_subs),
        mat_types=tuple(mat_types),
        light_kinds=tuple(l.kind for l in sd.lights),
        light_samples=tuple(l.samples for l in sd.lights),
        meshes=tuple(mesh_statics),
        skybox_wh=sd.skybox_wh,
    )

    no = len(sd.objects)
    scale = np.tan(f32(st.fov) * f32(0.5) / f32(180.0) * f32(np.pi))

    # Fused multi-mesh tables: one intersection dispatch for the whole
    # scene. Gated on >= 2 meshes — single-mesh scenes keep the
    # per-mesh path bit-for-bit (zero flagship regression by
    # construction) — except under geometry sharding, which always
    # routes through the fused tables (they are what gets sharded).
    fused_itables = None
    fused_shadow_itables = None
    if len(mesh_host_views) >= 2 or (
        st.geo_shard_axis is not None and mesh_host_views
    ):
        from rendering_jax.ops.pallas_intersect import build_fused_tables

        clipped_flags = [m.clipped_by_root for m in meshes]
        # Under geometry sharding the fused tables stay HOST-side:
        # parallel.geoshard feeds them into shard_map with sharded
        # in_specs, so each device receives only its 1/G shard — a
        # device jnp copy here would stage the full O(T_total) tables
        # on one chip first and defeat the beyond-HBM mode.
        host_tables = st.geo_shard_axis is not None
        fused_itables = build_fused_tables(
            mesh_host_views, clipped_flags, as_numpy=host_tables
        )
        shadow_inc = [
            mat_types[oi] != MAT_TRANSPARENT for oi in mesh_obj_idx
        ]
        if all(shadow_inc):
            fused_shadow_itables = fused_itables
        else:
            fused_shadow_itables = build_fused_tables(
                mesh_host_views, clipped_flags, include=shadow_inc,
                as_numpy=host_tables,
            )  # None when every mesh is transparent

    return SceneData(
        cam_pos=jnp.asarray(sd.cam_pos, jnp.float32),
        cam_rmat=jnp.asarray(euler_matrix(sd.cam_rot)),
        scale=jnp.asarray(scale, jnp.float32),
        bg_color=jnp.asarray(st.background_color, jnp.float32),
        bias=jnp.asarray(st.bias, jnp.float32),
        obj_color=jnp.asarray(np.asarray(colors, f32).reshape(no, 3)),
        obj_ior=jnp.asarray(np.asarray(iors, f32)),
        obj_ambient=jnp.asarray(np.asarray(ambients, f32)),
        obj_diffuse=jnp.asarray(np.asarray(diffuses, f32)),
        obj_specular=jnp.asarray(np.asarray(speculars, f32)),
        obj_nspec=jnp.asarray(np.asarray(nspecs, f32)),
        mat_type=jnp.asarray(np.asarray(mat_types, np.int32)),
        sph_pos=jnp.asarray(np.asarray(sph_pos, f32).reshape(len(sph_pos), 3)),
        sph_r=jnp.asarray(np.asarray(sph_r, f32)),
        pln_pos=jnp.asarray(np.asarray(pln_pos, f32).reshape(len(pln_pos), 3)),
        pln_n=jnp.asarray(np.asarray(pln_n, f32).reshape(len(pln_n), 3)),
        meshes=tuple(meshes),
        lights=lights,
        skybox=jnp.asarray(sd.skybox) if sd.skybox is not None else None,
        fused_itables=fused_itables,
        fused_shadow_itables=fused_shadow_itables,
        static=static,
    )


def load_scene(path: str, base_settings: RenderSettings | None = None) -> SceneData:
    """Parse + build in one step (the `Scene(path)` constructor analogue)."""
    return build_scene(parse_scene(path, base_settings))

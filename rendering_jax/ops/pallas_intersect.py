"""Ray-mesh intersection kernel for NVIDIA GPUs (Pallas, Triton route).

Structure:

  triangles -> Morton-ordered chunks of `tri_chunk` with per-chunk
               vertex/edge/reach-box tables (build_intersect_tables —
               the baked acceleration structure, rebuilt on geometry
               updates like the reference rebuilds its BVH,
               src/objects.cpp:461-530). n_sub consecutive cull chunks
               form one SUPER chunk, the unit of the pre-pass.
  pre-pass  -> per ray TILE, an exact any-ray slab test of every super
               AABB (_tile_live_exact), giving each tile its live super
               list sorted near-to-far from the tile's origin centroid
               and its length (_tile_tables). This is the packet-descent
               step of a packet-BVH, done as one dense XLA reduction
               over (n_tiles, ray_tile, n_super).
  kernel    -> one program per ray tile (grid = n_tiles). Each program
               walks ITS live list with the per-ray running best
               (t, triangle) in registers: per super, every cull chunk
               is slab-tested against the rays (re-checked against the
               running t, so hits found earlier prune later chunks), and
               a chunk that any ray still reaches is intersected one
               triangle at a time (the triangle's rows are uniform
               scalar loads; each thread evaluates Moller-Trumbore for
               its rays). Tables are read by dynamic offsets from the
               whole arrays, so nothing but the tile's own rays is
               blocked.

Two modes:
  * closest-hit (primary/bounce rays): running minimum + triangle id.
  * any-hit (shadow rays, mode="any"): a ray that finds ANY accepted
    hit below its limit marks itself done (t <- -1), which the chunk
    cull treats as "skip"; a tile leaves its super loop as soon as
    every one of its rays is done. Matches trace_occlusion's boolean
    semantics exactly.

Stats are device-side (reference counters, include/stats.h:18-36):
with collect_stats=True each program writes its own partial counts —
slab-tested (ray, cull chunk) pairs and (live ray x triangle)
Moller-Trumbore evaluations — to one row of an (n_tiles, 2) output,
and XLA sums the rows (no atomics: the sums are deterministic).
Otherwise the counters compile out and return 0, like the reference's
collectStatistics gate.

This is a discrete hit ORACLE (t / triangle id / occlusion bit): the
integrator runs it under stop_gradient and re-evaluates accepted hits
differentiably, so no custom VJP is needed.

Tie-breaking: a hit replaces the running best on a smaller t, or on an
exactly equal t with a lower triangle id — so the result does not
depend on the visit order and equals the jnp oracles' first-index
argmin (rays that cross a shared edge exactly hit both triangles at
the same f32 t; about 1% of the flagship's camera rays do). Ids are
Morton order within a mesh and scene order across fused meshes. The
per-pair arithmetic is the mul/sub/div f32 sequence of
ops.intersect.ray_triangle; in interpret mode on the CPU the results
are bit-identical to it. Compiled for the GPU, Triton may contract a
multiply and an add into one FMA, so (t, accept) can differ from the
CPU in the last bits: hits within ~1e-5 relative t of a tie or of a
t_limit may resolve differently, and bit-exactness with the CPU is not
promised there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rendering_jax.ops.geometry import FLT_MAX

# Rays per program. A power of two: Triton blocks are powers of two.
RAY_TILE = 128
# Triangles per cull chunk and cull chunks per super chunk (the
# pre-pass unit); default_tri_chunk widens the chunk for huge meshes.
DEFAULT_TRI_CHUNK = 64
DEFAULT_SUB_PER_SUPER = 8
# Cap on the super count: the pre-pass and the per-tile order table
# scale with it.
_MAX_SUPERS = 512
_FMAX = 3.4028234663852886e38  # FLT_MAX literal (kernels can't capture arrays)


def _num_warps(ray_tile: int) -> int:
    """One ray per thread up to 8 warps."""
    return max(1, min(8, ray_tile // 32))


def _any(mask):
    # Triton has no reduce_or lowering; a max over int32 is the same.
    return jnp.max(jnp.where(mask, 1, 0)) > 0


def _kernel(
    cnt_ref,     # (n_tiles,) i32 — live super count of each tile
    order_ref,   # (n_tiles, Cs) i32 — live-first near-to-far super order
    tri_ref,     # (Cs, 16, n_sub*Tc) — rows [v0 xyz, e1 xyz, e2 xyz,
                 #   reach_lo xyz, reach_hi xyz, 0] per super chunk
    cbox_ref,    # (Cs*n_sub, 8) cull-chunk AABBs [lo xyz, hi xyz, 0, 0];
                 #   padded chunks hold inverted boxes (always culled)
    aux_ref,     # (16, Rp) — rows [ro xyz, rd xyz, 1/rd xyz, t0]
    t_ref,       # (BR,) out — best t (-1 = occluded, any-hit)
    id_ref,      # (BR,) out — best padded chunk-space triangle id
    *stats_ref,  # (2,) i32 out [tri_tests, box_tests], collect_stats only
    tc: int,
    n_sub: int,
    backface_culling: bool,
    use_root_filter: bool,
    anyhit: bool,
    collect_stats: bool,
):
    i = pl.program_id(0)
    br = t_ref.shape[0]
    lanes = pl.ds(pl.multiple_of(i * br, br), br)
    ro = [aux_ref[c, lanes] for c in range(3)]
    rd = [aux_ref[3 + c, lanes] for c in range(3)]
    inv = [aux_ref[6 + c, lanes] for c in range(3)]
    t0 = aux_ref[9, lanes]
    rays = (ro, rd, inv)
    kw = dict(tc=tc, backface_culling=backface_culling,
              use_root_filter=use_root_filter, anyhit=anyhit)

    def visit_super(k, t_best, id_best, n_tri):
        t_best = jnp.minimum(t_best, t0)  # t0 only on the first visit
        sup = order_ref[i, k]
        for j in range(n_sub):
            # Chunk cull: a triangle of this cull chunk can only be
            # accepted if the ray crosses the chunk's AABB at some t in
            # [0, t_best] (t_best itself: an exact tie with a lower id
            # wins) and the ray is not resolved (any-hit done marker
            # t_best < 0). Comparisons are negated so a NaN slab value
            # (rd_c == 0 with the origin on the box plane) keeps the
            # chunk live (conservative).
            cb = sup * n_sub + j
            lo = [cbox_ref[cb, c] for c in range(3)]
            hi = [cbox_ref[cb, 3 + c] for c in range(3)]
            ctmin = jnp.full((br,), -_FMAX, jnp.float32)
            ctmax = jnp.full((br,), _FMAX, jnp.float32)
            for c in range(3):
                t1 = (lo[c] - ro[c]) * inv[c]
                t2 = (hi[c] - ro[c]) * inv[c]
                ctmin = jnp.maximum(ctmin, jnp.minimum(t1, t2))
                ctmax = jnp.minimum(ctmax, jnp.maximum(t1, t2))
            # Padded cull chunks hold INVERTED boxes [+FMAX, -FMAX]; the
            # per-axis min/max swap above would turn them into an
            # everything-box, so they need an explicit validity test
            # (lo.x > hi.x only holds for pads; NaN compares False).
            invalid = lo[0] > hi[0]
            live = ~((ctmin > ctmax) | (ctmax < 0) | invalid
                     | (ctmin > t_best) | (t_best < 0))
            n = jnp.sum(live.astype(jnp.int32))
            t_best, id_best = jax.lax.cond(
                n > 0,
                functools.partial(_intersect_chunk, tri_ref, sup, j * tc,
                                  sup * (n_sub * tc), rays, **kw),
                lambda tb, ib: (tb, ib),
                t_best, id_best,
            )
            if collect_stats:
                n_tri = n_tri + n * tc
        return t_best, id_best, n_tri

    # The loop carries start from constants and every ref is read inside
    # the loops: under shard_map a value read at the kernel's top level
    # carries the input's varying mesh axes, which the loop bodies'
    # carries do not, and the two would not type-check as one carry.
    def cond(c):
        go = c[0] < cnt_ref[i]
        if anyhit:  # leave the walk once every ray of the tile is done
            go = go & _any(c[1] >= 0)
        return go

    init = (jnp.int32(0), jnp.full((br,), _FMAX, jnp.float32),
            jnp.full((br,), -1, jnp.int32), jnp.int32(0))
    n_visit, t_best, id_best, n_tri = jax.lax.while_loop(
        cond, lambda c: (c[0] + 1, *visit_super(*c)), init
    )
    t_ref[...] = jnp.minimum(t_best, t0)
    id_ref[...] = id_best
    if collect_stats:
        lane = jax.lax.broadcasted_iota(jnp.int32, (2,), 0)
        stats_ref[0][...] = jnp.where(lane == 0, n_tri,
                                      n_visit * (n_sub * br))


def _intersect_chunk(tri_ref, sup, col0, base, rays, t_best, id_best, *,
                     tc, backface_culling, use_root_filter, anyhit):
    """Moller-Trumbore of every triangle of one cull chunk against the
    tile's rays, one triangle per loop step. Same f32 sequence as
    ops.intersect.ray_triangle (reference formula, src/objects.cpp:
    59-95): pvec = rd x e2, det = e1.pvec, u = tvec.pvec/det,
    qvec = tvec x e1, v = rd.qvec/det, t = e2.qvec/det. Zero-padded
    triangles fail the det epsilon in both culling modes."""
    ro, rd, inv = rays

    def step(m, carry):
        t_best, id_best = carry
        col = col0 + m

        def row(r):  # table row r of this triangle: a uniform scalar
            return tri_ref[sup, r, col]

        v0 = [row(c) for c in range(3)]
        e1 = [row(3 + c) for c in range(3)]
        e2 = [row(6 + c) for c in range(3)]
        p0 = rd[1] * e2[2] - rd[2] * e2[1]
        p1 = rd[2] * e2[0] - rd[0] * e2[2]
        p2 = rd[0] * e2[1] - rd[1] * e2[0]
        det = e1[0] * p0 + e1[1] * p1 + e1[2] * p2
        if backface_culling:
            ok = det >= 1e-8
        else:
            ok = jnp.abs(det) >= 1e-8
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tv0 = ro[0] - v0[0]
        tv1 = ro[1] - v0[1]
        tv2 = ro[2] - v0[2]
        u = (tv0 * p0 + tv1 * p1 + tv2 * p2) * inv_det
        q0 = tv1 * e1[2] - tv2 * e1[1]
        q1 = tv2 * e1[0] - tv0 * e1[2]
        q2 = tv0 * e1[1] - tv1 * e1[0]
        v = (rd[0] * q0 + rd[1] * q1 + rd[2] * q2) * inv_det
        t = (e2[0] * q0 + e2[1] * q1 + e2[2] * q2) * inv_det
        ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)

        if use_root_filter:
            # LITERAL transcription of the reference slab
            # (AccelerationStructure::intersectBox, src/objects.cpp:
            # 534-570, sign-swap + pairwise running comparisons; no t>=0
            # clamp) against the root-clipped per-triangle box. The
            # interval form (max(mins) <= min(maxs)) NaN-REJECTS the
            # IEEE corner (rd_c == 0 with the origin exactly on a box
            # plane) that the reference's negated comparisons accept;
            # ops.intersect.slab_test (the BVH path) matches the
            # reference, so this must too.
            def tpair(c):
                lo_c = row(9 + c)
                hi_c = row(12 + c)
                neg = inv[c] < 0
                lo = jnp.where(neg, hi_c, lo_c)
                hi = jnp.where(neg, lo_c, hi_c)
                return (lo - ro[c]) * inv[c], (hi - ro[c]) * inv[c]

            tmin, tmax = tpair(0)
            tymin, tymax = tpair(1)
            box_hit = ~((tmin > tymax) | (tymin > tmax))
            tmin = jnp.where(tymin > tmin, tymin, tmin)
            tmax = jnp.where(tymax < tmax, tymax, tmax)
            tzmin, tzmax = tpair(2)
            box_hit = box_hit & ~((tmin > tzmax) | (tzmin > tmax))
            ok = ok & box_hit

        if anyhit:
            # Done rays (t_best = -1) never re-accept.
            ok = ok & (t < t_best)
            return (jnp.where(ok, -1.0, t_best),
                    jnp.where(ok, 0, id_best))
        # On an exact tie the lower id wins, whatever the visit order
        # (a miss carries id -1, so a hit AT the limit never enters).
        tid = base + col
        ok = ok & ((t < t_best) | ((t == t_best) & (tid < id_best)))
        return jnp.where(ok, t, t_best), jnp.where(ok, tid, id_best)

    return jax.lax.fori_loop(0, tc, step, (t_best, id_best))


class IntersectTables:
    """Precomputed, Morton-ordered chunk tables for the kernel — the
    analogue of the reference's built acceleration structure
    (src/objects.cpp:461-530): geometry is baked into kernel-layout
    vertex/edge/reach tables once per scene build. Rebuild after any
    geometry update, exactly as the reference rebuilds its BVH per run;
    within a render the tables are the oracle's geometry snapshot (hit
    topology is stop_gradient'd anyway, and accepted hits are
    re-evaluated from live vertices)."""

    def __init__(self, tri_chunk, n_sub, perm, tri, cbox, sbox):
        self.tri_chunk = tri_chunk   # cull-chunk triangles (Tc)
        self.n_sub = n_sub           # cull chunks per super chunk
        self.perm = perm      # (T,) i32 or None
        self.tri = tri        # (Cs, 16, n_sub*Tc)
        self.cbox = cbox      # (Cs*n_sub, 8) cull-chunk AABBs
        self.sbox = sbox      # (Cs, 8) super-chunk AABBs (pre-pass)

    def tree_flatten(self):
        return (
            (self.perm, self.tri, self.cbox, self.sbox),
            (self.tri_chunk, self.n_sub),
        )

    @classmethod
    def tree_unflatten(cls, static, dyn):
        return cls(static[0], static[1], *dyn)


jax.tree_util.register_pytree_node(
    IntersectTables,
    lambda t: t.tree_flatten(),
    IntersectTables.tree_unflatten,
)


def default_tri_chunk(n_tris: int) -> int:
    """Cull-chunk-size policy: tight chunks (few triangles -> tight
    AABBs -> little wasted Moller-Trumbore work), doubled until the
    super count is at most _MAX_SUPERS."""
    tc = DEFAULT_TRI_CHUNK
    while -(-n_tris // (tc * DEFAULT_SUB_PER_SUPER)) > _MAX_SUPERS:
        tc *= 2
    return min(tc, 2048)


def build_intersect_tables(mesh, *, tri_chunk: int = 256,
                           n_sub: int | None = None,
                           as_numpy: bool = False):
    """Build the kernel-format chunk tables for a mesh. Call once per
    scene build. Pure NUMPY on the host (milliseconds; a jnp
    formulation compiles a program per mesh). The tables are
    independent of every render flag (use_root_filter etc. only change
    the KERNEL's behavior), so one build serves any settings surgery
    applied after build_scene.

    n_sub overrides the cull-chunks-per-super fanout (the fused
    multi-mesh builder pins one value across all meshes so their super
    blocks share one (16, n_sub*Tc) shape; a mesh with fewer chunks
    than n_sub pads its super with inverted-box cull chunks that are
    always culled)."""
    import numpy as np

    if isinstance(mesh.v, jax.core.Tracer):
        raise TypeError(
            "build_intersect_tables is host-side numpy; build tables at "
            "scene-build time (models.scene.build_scene bakes mesh.itables) "
            "instead of under jit"
        )
    T = int(mesh.v.shape[0])
    if T == 0:
        return None
    n_chunks = -(-T // tri_chunk)
    if n_sub is None:
        n_sub = min(DEFAULT_SUB_PER_SUPER, n_chunks)
    n_super = -(-n_chunks // n_sub)
    n_chunks = n_super * n_sub           # pad to whole supers
    t_pad = n_chunks * tri_chunk - T

    perm = getattr(mesh, "morton_perm", None)
    v = np.asarray(mesh.v)
    reach_lo = np.asarray(mesh.reach_lo)
    reach_hi = np.asarray(mesh.reach_hi)
    if perm is not None:
        p = np.asarray(perm)
        v, reach_lo, reach_hi = v[p], reach_lo[p], reach_hi[p]

    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    # (T, 16) rows -> (C, 16, Tc). Zero padding: degenerate triangles
    # (det = 0) fail the epsilon test in both culling modes.
    rows = np.concatenate(
        [v0, e1, e2, reach_lo, reach_hi, np.zeros((T, 1), np.float32)],
        axis=1,
    ).astype(np.float32)  # (T, 16)
    rows = np.pad(rows, ((0, t_pad), (0, 0)))
    tri = np.ascontiguousarray(
        rows.reshape(n_super, n_sub * tri_chunk, 16).transpose(0, 2, 1)
    )

    # Chunk AABBs for the tile pre-cull and the in-kernel cull: union
    # of RAW vertex bounds. Any accepted Moller-Trumbore hit point lies
    # on its triangle, hence inside this union, so culling chunks whose
    # union the ray misses (within [0, t_best)) is sound — and much
    # tighter than the union of the root-clipped reach boxes. Padding
    # is min/max-neutral.
    ub_lo = np.pad(v.min(axis=1), ((0, t_pad), (0, 0)),
                   constant_values=_FMAX)
    ub_hi = np.pad(v.max(axis=1), ((0, t_pad), (0, 0)),
                   constant_values=-_FMAX)
    clo = ub_lo.reshape(n_chunks, tri_chunk, 3).min(axis=1)
    chi = ub_hi.reshape(n_chunks, tri_chunk, 3).max(axis=1)
    cbox = np.concatenate(
        [clo, chi, np.zeros((n_chunks, 2), np.float32)], axis=1
    ).astype(np.float32)  # (C, 8); padded chunks hold inverted boxes
    sbox = np.concatenate(
        [
            clo.reshape(n_super, n_sub, 3).min(axis=1),
            chi.reshape(n_super, n_sub, 3).max(axis=1),
            np.zeros((n_super, 2), np.float32),
        ],
        axis=1,
    ).astype(np.float32)  # (Cs, 8)
    # as_numpy keeps the tables HOST-side: the fused builder
    # re-concatenates them on the host anyway, and the geo-sharded path
    # feeds host arrays straight into shard_map so each device receives
    # only ITS shard — staging the full table on one device first would
    # defeat the beyond-device-memory mode.
    wrap = (lambda a: a) if as_numpy else jnp.asarray
    return IntersectTables(
        tri_chunk, n_sub,
        None if perm is None else wrap(perm),
        wrap(tri), wrap(cbox), wrap(sbox),
    )


def _tile_live_exact(ro_t, inv_t, t0_t, cbox):
    """Per-tile chunk cull: EXACT per-ray slab test, any() over the
    tile's rays — the packet-descent step of a packet-BVH, done as one
    dense XLA reduction over the minor (ray) axis of (n_tiles, C, BR).
    ro_t/inv_t: (n_tiles, 3, BR); t0_t: (n_tiles, BR); cbox: (C, 8).
    Returns live (n_tiles, C) bool. Comparisons are negated so a NaN
    slab value (rd_c == 0 with origin on the box plane) keeps the chunk
    live (conservative), never skips it. (Bounding the tile's
    origin/direction boxes by intervals instead admits ray combinations
    no real ray achieves and keeps many times more chunks live.)"""
    shape = (ro_t.shape[0], cbox.shape[0], ro_t.shape[2])
    ctmin = jnp.full(shape, -_FMAX, jnp.float32)
    ctmax = jnp.full(shape, _FMAX, jnp.float32)
    for c in range(3):
        o = ro_t[:, None, c, :]
        iv = inv_t[:, None, c, :]
        t1 = (cbox[None, :, c, None] - o) * iv
        t2 = (cbox[None, :, 3 + c, None] - o) * iv
        ctmin = jnp.maximum(ctmin, jnp.minimum(t1, t2))
        ctmax = jnp.minimum(ctmax, jnp.maximum(t1, t2))
    t0 = t0_t[:, None, :]
    live = ~(
        (ctmin > ctmax) | (ctmax < 0) | (ctmin >= t0)
        # Resolved rays (t0 = -1: pre-done shadow lanes, padding,
        # dead-weight paths) contribute no liveness even when a chunk
        # straddles their origin (there ctmin < -1, so the ctmin >= t0
        # clause alone would keep it live).
        | (t0 < 0)
        # Padded chunks hold INVERTED boxes [+FMAX, -FMAX]; the per-axis
        # min/max swap turns them into an everything-box, so they need
        # an explicit validity test (lo.x > hi.x only holds for pads;
        # NaN compares False -> conservative).
        | (cbox[None, :, 0, None] > cbox[None, :, 3, None])
    )
    return jnp.any(live, axis=2)  # (n_tiles, C)


def _tile_tables(ro_t, inv_t, t0_t, cbox):
    """Per-tile live-first near-to-far chunk visit order (ro_t/inv_t:
    (n_tiles, 3, BR)). Returns (torder (n_tiles, C) i32, counts
    (n_tiles,) i32)."""
    live = _tile_live_exact(ro_t, inv_t, t0_t, cbox)
    # Near-to-far sort key from the centroid of the tile's LIVE ray
    # origins: padded/pre-done lanes carry t0 < 0 and zero origins — a
    # plain mean would drag a partial tile's centroid toward the world
    # origin and weaken its progressive t-pruning (pure perf: the
    # kernel's tie rule makes its results independent of the order).
    lane = (t0_t >= 0).astype(jnp.float32)            # (n_tiles, BR)
    cnt = jnp.maximum(jnp.sum(lane, axis=1), 1.0)     # (n_tiles,)
    centroid = (
        jnp.sum(ro_t * lane[:, None, :], axis=2) / cnt[:, None]
    )  # (n_tiles, 3)
    ccenter = (cbox[None, :, 0:3] + cbox[None, :, 3:6]) * 0.5
    dist2 = jnp.sum((ccenter - centroid[:, None, :]) ** 2, axis=-1)
    # One sort does both: dead chunks key to +inf (stable -> id order),
    # live chunks order near-to-far.
    key = jnp.where(live, dist2, _FMAX)
    torder = jnp.argsort(key, axis=1).astype(jnp.int32)  # (n_tiles, C)
    counts = jnp.sum(live, axis=1).astype(jnp.int32)
    return torder, counts


def _pallas_call(counts, torder, tri, cbox, aux, *, ray_tile, tc, n_sub,
                 kernel_kw, interpret):
    n_tiles = counts.shape[0]
    rp = n_tiles * ray_tile
    collect_stats = kernel_kw["collect_stats"]
    kernel = functools.partial(_kernel, tc=tc, n_sub=n_sub, **kernel_kw)
    # vma for mixed-varying operands (geometry sharding: tables vary
    # over 'geo' while rays vary over 'rays'): with check_vma shard_map
    # pallas_call cannot infer the output's varying axes, so declare
    # them as the union of the inputs'.
    vma = set()
    for a in (counts, torder, tri, cbox, aux):
        vma |= set(getattr(jax.typeof(a), "vma", ()) or ())
    sds_kw = {"vma": frozenset(vma)} if vma else {}
    ray_spec = pl.BlockSpec((ray_tile,), lambda i: (i,))
    out_specs = [ray_spec, ray_spec]
    out_shape = [
        jax.ShapeDtypeStruct((rp,), jnp.float32, **sds_kw),
        jax.ShapeDtypeStruct((rp,), jnp.int32, **sds_kw),
    ]
    if collect_stats:
        out_specs.append(pl.BlockSpec((None, 2), lambda i: (i, 0)))
        out_shape.append(
            jax.ShapeDtypeStruct((n_tiles, 2), jnp.int32, **sds_kw)
        )
    whole = pl.no_block_spec
    out = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        # The rays are read by offset too: a blocked input would carry
        # its varying mesh axes into the kernel's loop carries, which
        # the kernel's trace (vma-free) cannot type under shard_map.
        in_specs=[whole] * 5,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(ray_tile), num_stages=1
        ),
        interpret=interpret,
        name="intersect_tiles",
    )(counts, torder, tri, cbox, aux)
    if collect_stats:
        t, ids, stats = out
        # Per-tile partial counts, summed by XLA in f32 (the host-side
        # counters' type: totals exceed int32 range on large meshes).
        tri_tests, box_tests = jnp.sum(stats.astype(jnp.float32), axis=0)
        return t, ids, box_tests, tri_tests
    t, ids = out
    z = jnp.zeros((), jnp.float32)
    return t, ids, z, z


def check_ray_tile(ray_tile: int) -> None:
    """Ray tiles are Triton blocks: powers of two, at least one warp's
    worth of rays and at most 16 per thread of 8 warps."""
    if ray_tile < 32 or ray_tile > 4096 or ray_tile & (ray_tile - 1):
        raise ValueError(
            f"ray_tile must be a power of two in [32, 4096], got {ray_tile}"
        )


def _intersect_tables_impl(
    tb: "IntersectTables",
    ro: jnp.ndarray,   # (3, R) rows
    rd: jnp.ndarray,   # (3, R) rows
    t_limit: jnp.ndarray | None,
    *,
    backface_culling: bool,
    use_root_filter: bool,
    anyhit: bool,
    collect_stats: bool,
    ray_tile: int | None,
    interpret: bool,
):
    """Run the chunked intersection kernel over prebuilt tables.
    Mesh-agnostic core shared by the single-mesh wrapper
    (bruteforce_mesh_pallas) and the fused multi-mesh oracle
    (intersect_fused): the kernel only sees Morton-ordered chunk
    tables, so multi-mesh fusion is pure table concatenation. Returns
    (t_best (R,), raw_tri (R,), box_tests, tri_tests) where raw_tri is
    the PADDED CHUNK-SPACE triangle id ((super*n_sub + sub)*tc + row;
    -1 = miss / not occluded); callers own the id remap."""
    R = ro.shape[1]
    if ray_tile is None:
        ray_tile = RAY_TILE
    check_ray_tile(ray_tile)
    n_tiles = -(-R // ray_tile)
    rp = n_tiles * ray_tile
    r_pad = rp - R

    t0 = jnp.full((R,), FLT_MAX, jnp.float32)
    if t_limit is not None:
        t0 = jnp.minimum(t0, t_limit)
    ro_p, rd_p = ro, rd
    if r_pad:
        ro_p = jnp.pad(ro, ((0, 0), (0, r_pad)))
        rd_p = jnp.pad(rd, ((0, 0), (0, r_pad)), constant_values=1.0)
        # Padded lanes are born resolved (t0 = -1, the done marker):
        # the pre-pass and the in-kernel culls treat them as dead, so
        # they add no live chunks and no Moller-Trumbore work. Their
        # outputs are sliced off below.
        t0 = jnp.pad(t0, (0, r_pad), constant_values=-1.0)
    invT = 1.0 / rd_p
    aux = jnp.concatenate(
        [ro_p, rd_p, invT, t0[None, :],
         jnp.zeros((6, rp), jnp.float32)],
        axis=0,
    )  # (16, Rp)

    sg = jax.lax.stop_gradient
    ro_t = sg(ro_p).reshape(3, n_tiles, ray_tile).swapaxes(0, 1)
    inv_t = sg(invT).reshape(3, n_tiles, ray_tile).swapaxes(0, 1)
    t0_t = sg(t0).reshape(n_tiles, ray_tile)
    torder, counts = _tile_tables(ro_t, inv_t, t0_t, tb.sbox)

    t_out, id_out, box_tests, tri_tests = _pallas_call(
        counts, torder, tb.tri, tb.cbox, sg(aux),
        ray_tile=ray_tile, tc=tb.tri_chunk, n_sub=tb.n_sub,
        kernel_kw=dict(
            backface_culling=backface_culling,
            use_root_filter=use_root_filter,
            anyhit=anyhit,
            collect_stats=collect_stats,
        ),
        interpret=interpret,
    )
    return t_out[:R], id_out[:R], box_tests, tri_tests


def bruteforce_mesh_pallas(
    mesh,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_limit: jnp.ndarray | None = None,
    *,
    backface_culling: bool = True,
    tri_chunk: int | None = None,
    use_root_filter: bool = True,
    ray_tile: int | None = None,
    interpret: bool = False,
    tables: "IntersectTables | None" = None,
    mode: str = "closest",
    collect_stats: bool = False,
    rays_row: bool = False,
):
    """Closest hit (mode="closest") or occlusion query (mode="any") over
    all mesh triangles in one kernel. Interface matches
    ops.bruteforce.bruteforce_mesh; in any-hit mode the returned tri is
    0 where the ray is occluded within t_limit and -1 otherwise (t is
    FLT_MAX). Pass prebuilt `tables` (build_intersect_tables) to skip
    host-side table construction (required under jit — the build is
    host numpy); table content is independent of every render flag.
    Returns (t, tri, box_tests, tri_tests), the counters accumulated on
    the device when collect_stats=True (0 otherwise, like the
    reference's collectStatistics flag).

    rays_row=True takes ro/rd as (3, R) rows (the integrator's (3, B)
    layout) and skips the (R, 3) <-> (3, R) relayouts entirely."""
    T = int(mesh.v.shape[0])
    if not rays_row:
        ro = ro.T  # (3, R) — all internal layouts are row-major
        rd = rd.T
    R = ro.shape[1]
    anyhit = mode == "any"
    if T == 0:
        z = jnp.zeros((), jnp.int32)
        return (
            jnp.full((R,), FLT_MAX, jnp.float32),
            jnp.full((R,), -1, jnp.int32),
            z, z,
        )

    if tables is None:
        if tri_chunk is None:
            tri_chunk = default_tri_chunk(T)
        tables = build_intersect_tables(mesh, tri_chunk=tri_chunk)
    else:
        if tri_chunk is not None:
            assert tables.tri_chunk == tri_chunk
    perm = tables.perm

    t_best, tri_best, box_tests, tri_tests = _intersect_tables_impl(
        tables, ro, rd, t_limit,
        backface_culling=backface_culling,
        use_root_filter=use_root_filter,
        anyhit=anyhit,
        collect_stats=collect_stats,
        ray_tile=ray_tile,
        interpret=interpret,
    )
    if anyhit:
        return (
            jnp.full((R,), FLT_MAX, jnp.float32),
            tri_best,
            box_tests,
            tri_tests,
        )
    if perm is None:
        tri_remap = tri_best
    else:
        tri_remap = perm[jnp.maximum(tri_best, 0)].astype(jnp.int32)
    tri_best = jnp.where(tri_best >= 0, tri_remap, -1)
    found = tri_best >= 0
    t_best = jnp.where(found, t_best, FLT_MAX)
    return t_best, tri_best, box_tests, tri_tests


class FusedTables:
    """Concatenated multi-mesh chunk tables: ONE kernel dispatch per
    ray block intersects EVERY mesh in the scene.

    The reference's per-object closest-hit loop
    (src/scene.cpp:724-756) costs nothing per extra object; a per-mesh
    kernel launch costs a full tile pre-cull + dispatch each — an
    N-mesh scene would pay N of them per bounce. But the kernel is
    mesh-agnostic: it walks Morton-ordered chunk tables, so fusing N
    meshes is pure table concatenation along the super-chunk axis
    (every mesh built with the SAME (tri_chunk, n_sub) so the static
    block shapes agree). One shared pre-cull sees all meshes' super
    AABBs; per-tile live lists naturally skip meshes the tile's rays
    never approach.

    `geo` is a plain IntersectTables over the concatenated chunks;
    `idmap` is the raw-id remap — rows [mesh sub index, global column
    into the scene's concatenated (30, T_total) vgeoT] indexed by the
    kernel's padded chunk-space triangle id. Padded slots alias their
    mesh's LAST real row (np.minimum(arange, t_i - 1) clamps upward;
    they are zero triangles and can never be returned).
    """

    def __init__(self, geo: IntersectTables, idmap, n_meshes: int,
                 any_clipped: bool, t_total: int):
        self.geo = geo
        self.idmap = idmap          # (2, n_pad_total) i32
        self.n_meshes = n_meshes
        self.any_clipped = any_clipped
        self.t_total = t_total

    def tree_flatten(self):
        return (
            (self.geo, self.idmap),
            (self.n_meshes, self.any_clipped, self.t_total),
        )

    @classmethod
    def tree_unflatten(cls, static, dyn):
        return cls(dyn[0], dyn[1], *static)


jax.tree_util.register_pytree_node(
    FusedTables,
    lambda t: t.tree_flatten(),
    FusedTables.tree_unflatten,
)


def build_fused_tables(host_meshes, clipped_flags, include=None,
                       as_numpy: bool = False):
    """Concatenate per-mesh chunk tables into one FusedTables.

    host_meshes: sequence of host-side mesh views (numpy .v (T, 3, 3),
    .reach_lo/.reach_hi (T, 3), .morton_perm or None) in scene sub
    order — ALL meshes, including excluded ones (their triangle counts
    still advance the global vgeoT column offset so idmap columns line
    up with the scene's concatenated vgeoT).
    clipped_flags[i]: mesh i's AABB pokes outside the reference's root
    box (MeshData.clipped_by_root). Unclipped meshes get their RAW
    triangle bounds substituted for the reach rows, which makes the
    kernel's root filter an exact no-op for them — so one global
    use_root_filter flag (use_ac and any_clipped) reproduces the
    per-mesh `use_ac and clipped_by_root` gating exactly.
    include: optional bool per mesh (e.g. the shadow tables exclude
    transparent meshes, scene.cpp:733-734). Default: all.

    Returns None when no included mesh has triangles. Host-side numpy
    (same reasoning as build_intersect_tables)."""
    import numpy as np

    n = len(host_meshes)
    if include is None:
        include = [True] * n
    ts = [int(m.v.shape[0]) for m in host_meshes]
    t_total_inc = sum(t for t, inc in zip(ts, include) if inc)
    if t_total_inc == 0:
        return None
    # One chunk shape for every mesh, sized by the INCLUDED total (the
    # pre-pass and the per-tile order table scale with the fused super
    # count).
    tc = default_tri_chunk(t_total_inc)
    n_sub = DEFAULT_SUB_PER_SUPER

    tris, cboxes, sboxes, mids, vids = [], [], [], [], []
    vofs = 0
    any_clipped = False
    for i, m in enumerate(host_meshes):
        t_i = ts[i]
        if not include[i] or t_i == 0:
            vofs += t_i
            continue
        any_clipped = any_clipped or bool(clipped_flags[i])
        if clipped_flags[i]:
            mm = m
        else:
            # Raw triangle bounds: the literal reference slab against a
            # triangle's own AABB accepts every accepted M-T hit, so
            # the root filter cannot reject anything for this mesh.
            import types

            v = np.asarray(m.v)
            mm = types.SimpleNamespace(
                v=m.v, reach_lo=v.min(axis=1), reach_hi=v.max(axis=1),
                morton_perm=getattr(m, "morton_perm", None),
            )
        # as_numpy: the per-mesh tables are concatenated on the host
        # below — materializing each on device first costs a full
        # device->host round-trip per mesh for nothing.
        p = build_intersect_tables(mm, tri_chunk=tc, n_sub=n_sub,
                                   as_numpy=True)
        tris.append(p.tri)
        cboxes.append(p.cbox)
        sboxes.append(p.sbox)
        n_pad = p.tri.shape[0] * n_sub * tc
        local = np.minimum(np.arange(n_pad), t_i - 1)
        perm = getattr(m, "morton_perm", None)
        if perm is not None:
            local = np.asarray(perm)[local]
        mids.append(np.full((n_pad,), i, np.int32))
        vids.append((vofs + local).astype(np.int32))
        vofs += t_i

    idmap = np.stack(
        [np.concatenate(mids), np.concatenate(vids)], axis=0
    )  # (2, n_pad_total)
    # as_numpy keeps the fused tables HOST-side for the geo-sharded
    # path: shard_map's sharded in_specs then transfer each device only
    # ITS table shard, instead of staging the full O(T_total) arrays on
    # one device first (which would defeat the beyond-HBM mode).
    wrap = (lambda a: a) if as_numpy else jnp.asarray
    geo = IntersectTables(
        tc, n_sub, None,
        wrap(np.concatenate(tris, axis=0)),
        wrap(np.concatenate(cboxes, axis=0)),
        wrap(np.concatenate(sboxes, axis=0)),
    )
    return FusedTables(geo, wrap(idmap), n, any_clipped, vofs)


def intersect_fused(
    ft: FusedTables,
    ro: jnp.ndarray,   # (3, R) rows
    rd: jnp.ndarray,   # (3, R) rows
    t_limit: jnp.ndarray | None = None,
    *,
    mode: str = "closest",
    backface_culling: bool = True,
    use_root_filter: bool = True,
    collect_stats: bool = False,
    ray_tile: int | None = None,
    interpret: bool = False,
):
    """One kernel dispatch over ALL fused meshes.

    mode="closest": returns (t (R,), mid (R,), vid (R,), box_tests,
    tri_tests) — mid is the winning mesh's scene sub index (-1 = miss),
    vid the global column into the concatenated vgeoT (clamped to 0 on
    miss so it is always gather-safe). Cross-mesh ties at bit-equal t
    go to the lower padded id, i.e. the mesh earlier in scene order.

    mode="any": returns (occluded (R,) bool, box_tests, tri_tests) —
    occlusion within t_limit by any fused mesh (rays entering with
    t_limit < 0 are pre-done and cost nothing, the trace_occlusion
    progressive-pruning contract)."""
    anyhit = mode == "any"
    t_best, raw, box_tests, tri_tests = _intersect_tables_impl(
        ft.geo, ro, rd, t_limit,
        backface_culling=backface_culling,
        use_root_filter=use_root_filter,
        anyhit=anyhit,
        collect_stats=collect_stats,
        ray_tile=ray_tile,
        interpret=interpret,
    )
    if anyhit:
        return raw >= 0, box_tests, tri_tests
    found = raw >= 0
    mv = ft.idmap[:, jnp.maximum(raw, 0)]  # (2, R)
    mid = jnp.where(found, mv[0], -1)
    vid = jnp.where(found, mv[1], 0)
    t_best = jnp.where(found, t_best, FLT_MAX)
    return t_best, mid, vid, box_tests, tri_tests

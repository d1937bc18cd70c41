"""Scale-out: rays sharded over a device mesh, scene replicated.

The replacement for the reference's entire parallelism story —
the 128x128 tile scheduler + bounded thread pool (src/scene.cpp:362-506)
becomes a 1-D `jax.sharding.Mesh` over all chips with the pixel/ray
axis sharded via `shard_map` (SURVEY section 5.8):

* primary pass: each device integrates a contiguous row-major pixel
  block (the "tiles"); ray queues (bounce continuations) stay
  device-local, exactly like tiles stay thread-local in the reference.
  No communication at all until the frame is assembled (the output IS
  the sharded framebuffer).
* adaptive SSAA: the Sobel mask is computed on the (small) replicated
  frame; compacted edge-pixel indices are sharded evenly across
  devices; each device scatter-adds its refined subsamples into a
  full-size accumulator which is psum'd — one all-reduce of a
  (3, H*W) buffer per refinement pass.
* gradients: under `jax.grad`, shard_map's partitioned AD inserts the
  psum for the replicated scene parameters automatically — the
  all-reduce IS the gradient aggregation.

Multi-host: the same code runs under `jax.distributed.initialize`; the
mesh then spans all processes' devices (rays sharded across hosts, DCN
only sees the SSAA psum + grad reductions).

Frames are channel-first (3, H, W) like the single-chip pipeline.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from rendering_jax.ops.sobel import sobel_mask
from rendering_jax.ops.traversal import count_ac_nodes
from rendering_jax.render.integrator import (
    DEFAULT_RAY_BLOCK,
    _zero_stats,
    integrate,
    shade_normals,
)
from rendering_jax.render.raygen import pixel_dirs, ssaa_subsample_rays

try:
    from jax import shard_map as _shard_map  # jax >= 0.7 style
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map


def make_ray_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("rays",))


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


# Pixels per screen tile for the static round-robin device interleave.
# Matches the reference's 128x128 tile granularity (scene.cpp:364) in
# spirit: big enough to keep per-device rays coherent for the oracle's
# tile pre-cull, small enough that expensive screen regions (glass,
# deep bounces) spread across all chips instead of landing on one
# contiguous block (SURVEY section 7, hard part 3).
TILE_PX = 16384


def _round_robin_layout(r: int, ndev: int, wh=None):
    """Screen-tile round-robin layout: n_tiles = ndev * k tiles of
    `tile` pixels, device d taking tiles d, d+ndev, ... Returns
    (rp, perm) with perm (rp,) i32: perm[k] = pixel index handled by
    global ray slot k (slots are contiguous per device under
    P('rays')).

    wh=(w, h) with w*h == r additionally orders pixels by the SAME
    2-D screen-tile traversal the single-device primary pass uses
    (raygen.tile_dims rects) BEFORE the device interleave, so each
    kernel ray tile covers a compact screen rect. Without it a
    kernel tile is a SCANLINE RUN whose long thin frustum
    stays live against many more super chunks."""
    k = max(1, -(-r // (ndev * TILE_PX)))
    n_tiles = ndev * k
    rp = _pad_to(r, n_tiles)
    tile = rp // n_tiles
    if wh is not None and wh[0] * wh[1] == r:
        from rendering_jax.render.raygen import tile_dims

        w, h = wh
        tw, th = tile_dims(w, h)
        s = jnp.arange(r, dtype=jnp.int32)
        tile_id, within = s // (tw * th), s % (tw * th)
        ty, tx = within // tw, within % tw
        tiles_x = w // tw
        x = (tile_id % tiles_x) * tw + tx
        y = (tile_id // tiles_x) * th + ty
        base = jnp.concatenate(
            [y * w + x, jnp.arange(r, rp, dtype=jnp.int32)]
        )
    else:
        base = jnp.arange(rp, dtype=jnp.int32)
    tiles = base.reshape(n_tiles, tile)
    order = jnp.concatenate(
        [jnp.arange(d, n_tiles, ndev, dtype=jnp.int32) for d in range(ndev)]
    )
    return rp, tiles[order].reshape(-1)


def _integrate_slots_sharded(scene, mesh: Mesh, xs, ys, *, ray_block,
                             queue_headroom: int = 1):
    """shard_map'd slot integration shared by the primary and strip
    passes: each device integrates its (xs, ys) primary rays with
    identity local pixel ids (slot accumulation when nothing bounces).
    Returns (accum3 (3, rp) in global slot order, psum'd stats).
    Stats count padded duplicate slots, like the block padding of the
    single-device paths — the counters are a work oracle, not an exact
    pixel count (see integrator._zero_stats). show_normals reports the
    true primary count, matching _primary_pass."""
    st = scene.static

    def local(scene, xs_l, ys_l):
        rd = pixel_dirs(scene, xs_l, ys_l, 1.0, 1.0)
        ro = jnp.broadcast_to(scene.cam_pos, rd.shape)
        nloc = xs_l.shape[0]
        if st.settings.show_normals:
            accum3 = shade_normals(scene, ro, rd, ray_block=ray_block)
            stats = _zero_stats()
        else:
            accum3, stats = integrate(
                scene, ro, rd, jnp.arange(nloc, dtype=jnp.int32),
                jnp.ones((nloc,), jnp.float32), n_pixels=nloc,
                ray_block=ray_block, out_slots=not st.any_bouncing,
                queue_headroom=queue_headroom,
            )
        stats = {k: jax.lax.psum(v, "rays") for k, v in stats.items()}
        return accum3, stats

    return _shard_map(
        local, mesh=mesh, in_specs=(P(), P("rays"), P("rays")),
        out_specs=(P(None, "rays"), P()),
    )(scene, xs, ys)


def unpermute_slots(accum3, r: int, w: int, h: int, ndev: int):
    """Invert the TILED round-robin slot layout (_round_robin_layout
    with wh=(w, h)) with pure reshapes + transposes — no (3, r)
    scatter: slot (d, j, within)
    holds base group g = j*ndev + d, and the tile-order base inverts
    exactly like pipeline._untile. Returns a flat (3, r) PIXEL-order
    buffer (padded slots drop off the tile-order tail)."""
    from rendering_jax.render.raygen import tile_dims

    k = max(1, -(-r // (ndev * TILE_PX)))
    n_tiles = ndev * k
    rp = _pad_to(r, n_tiles)
    tile = rp // n_tiles
    base = (
        accum3.reshape(3, ndev, k, tile)
        .transpose(0, 2, 1, 3)
        .reshape(3, rp)[:, :r]
    )
    tw, th = tile_dims(w, h)
    t = base.reshape(3, h // th, w // tw, th, tw)
    return t.transpose(0, 1, 3, 2, 4).reshape(3, h * w)


def assemble_frame(accum3, perm, rp: int, r: int, w: int, h: int,
                   ndev: int | None = None):
    """Undo the round-robin tile permutation (slot k -> pixel perm[k]),
    drop the padding, and black out the reference's dead last
    row/column (scene.cpp:369-372). Shared by the ray-sharded and
    geometry-sharded primary passes. With `ndev` (callers that built
    the layout with wh=(w, h)) the inversion is scatter-free
    (unpermute_slots)."""
    if ndev is not None and r == w * h:
        frame3 = unpermute_slots(accum3, r, w, h, ndev).reshape(3, h, w)
    else:
        flat = jnp.zeros((3, rp), jnp.float32).at[:, perm].set(accum3)
        frame3 = flat[:, :r].reshape(3, h, w)
    frame3 = frame3.at[:, h - 1, :].set(0.0)
    return frame3.at[:, :, w - 1].set(0.0)


def _primary_sharded(scene, mesh: Mesh, *, ray_block, queue_headroom=1):
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ndev = mesh.devices.size
    r = w * h
    rp, perm = _round_robin_layout(r, ndev, (w, h))

    xs = (perm % w).astype(jnp.float32)
    ys = jnp.minimum(perm // w, h - 1).astype(jnp.float32)

    accum3, stats = _integrate_slots_sharded(
        scene, mesh, xs, ys, ray_block=ray_block,
        queue_headroom=queue_headroom,
    )
    if st.settings.show_normals:
        stats["rays_casted"] = jnp.asarray(r, jnp.float32)

    return assemble_frame(accum3, perm, rp, r, w, h, ndev), stats


def _ssaa_sharded(scene, frame3, mesh: Mesh, *, capacity, ray_block,
                  queue_headroom: int = 1):
    """Sobel-adaptive refinement. Returns (frame3, n_masked, stats)."""
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ndev = mesh.devices.size
    cap = _pad_to(capacity, ndev)

    mask = sobel_mask(frame3)
    flat_mask = mask.reshape(-1)
    n_masked = jnp.sum(flat_mask.astype(jnp.int32))
    (idx,) = jnp.nonzero(flat_mask, size=cap, fill_value=w * h)
    valid = idx < w * h
    idx_c = jnp.minimum(idx, w * h - 1).astype(jnp.int32)

    def local(scene, idx_l, valid_l):
        ro, rd, pixk, wt = ssaa_subsample_rays(scene, idx_l, valid_l, w)
        if st.settings.show_normals:
            colors3 = shade_normals(scene, ro, rd, ray_block=ray_block)
            accum3 = (
                jnp.zeros((3, w * h), jnp.float32)
                .at[:, pixk]
                .add(wt[None, :] * colors3)
            )
            stats = _zero_stats()
        elif st.any_bouncing:
            accum3, stats = integrate(
                scene, ro, rd, pixk, wt, n_pixels=w * h, ray_block=ray_block,
                queue_headroom=queue_headroom,
            )
        else:
            # No bouncing: slot accumulation (pipeline._ssaa_pass) —
            # subsample i of masked pixel k sits at slot i*nloc + k
            # (subsample-major concatenation); collapse the 4 slots
            # with one reshape-sum, then scatter capacity/ndev lanes
            # instead of
            # 4x that. Fill lanes (idx clamped, weight 0) add zeros.
            nloc = idx_l.shape[0]
            slots3, stats = integrate(
                scene, ro, rd, pixk, wt, n_pixels=w * h,
                ray_block=ray_block, out_slots=True,
            )
            summed3 = jnp.sum(slots3.reshape(3, 4, nloc), axis=1)
            accum3 = (
                jnp.zeros((3, w * h), jnp.float32).at[:, idx_l].add(summed3)
            )
        # Refined pixels are disjoint across devices -> psum assembles.
        accum3 = jax.lax.psum(accum3, "rays")
        stats = {k: jax.lax.psum(v, "rays") for k, v in stats.items()}
        return accum3, stats

    accum3, stats = _shard_map(
        local, mesh=mesh, in_specs=(P(), P("rays"), P("rays")),
        out_specs=(P(), P()),
    )(scene, idx_c, valid)

    refined3 = accum3.reshape(3, h, w)
    frame3 = jnp.where(mask[None, :, :], refined3, frame3)
    return frame3, n_masked, stats


def render_strip_sharded(scene, *, y0, rows: int, mesh: Mesh,
                         ray_block: int = DEFAULT_RAY_BLOCK,
                         queue_headroom: int = 1):
    """Sharded analogue of pipeline._render_strip: integrate the primary
    rays of pixel rows [y0, y0+rows) with the strip's rays round-robin
    tile-interleaved across the mesh. Returns (STRIP-SIZED flat
    (3, rows*W) accumulator, psum'd stats) — the same contract as the
    single-device strip fn, so the progress / resumable strip loops
    swap it in unchanged, and the host pulls rows*W pixels per strip
    instead of a full frame (jittable; rows static, y0 TRACED — it
    only offsets the row indices, so full-height strips share one
    compiled program; mesh closure-bound)."""
    from rendering_jax.render.pipeline import derive_mesh_tables

    scene = derive_mesh_tables(scene)
    st = scene.static
    w = st.settings.width
    ndev = mesh.devices.size
    r = rows * w
    rp, perm = _round_robin_layout(r, ndev, (w, rows))
    # Slot k handles strip-local pixel perm[k]; padded slots (perm >= r)
    # render a clamped duplicate ray whose result is sliced off below.
    local_pix = jnp.minimum(perm, r - 1)
    xs = (local_pix % w).astype(jnp.float32)
    ys = (y0 + local_pix // w).astype(jnp.float32)

    accum3, stats = _integrate_slots_sharded(
        scene, mesh, xs, ys, ray_block=ray_block,
        queue_headroom=queue_headroom,
    )
    if st.settings.show_normals:
        stats["rays_casted"] = jnp.asarray(r, jnp.float32)

    # Undo the round-robin permutation scatter-free (the strip layout
    # was built with wh=(w, rows)); the host loop places the strip.
    return unpermute_slots(accum3, r, w, rows, ndev), stats


@functools.lru_cache(maxsize=16)
def _cached_ssaa_sharded_fn(mesh: Mesh, ray_block: int, capacity: int,
                            queue_headroom: int = 1):
    def fn(scene_t, frame3):
        return _ssaa_sharded(scene_t, frame3, mesh, capacity=capacity,
                             ray_block=ray_block,
                             queue_headroom=queue_headroom)

    return jax.jit(fn)


def ssaa_pass_sharded(scene_t, frame3, mesh: Mesh, *, capacity: int,
                      ray_block: int = DEFAULT_RAY_BLOCK,
                      queue_headroom: int = 1):
    """Jitted sharded SSAA refinement with the same
    (frame3, n_masked, stats) contract as pipeline._ssaa_pass. Expects
    a derive_mesh_tables'd scene (like _ssaa_pass when called from the
    strip paths)."""
    return _cached_ssaa_sharded_fn(
        mesh, ray_block, capacity, queue_headroom
    )(scene_t, frame3)


def _show_ac_sharded(scene, mesh: Mesh):
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ndev = mesh.devices.size
    r = w * h
    rp = _pad_to(r, ndev)
    pix = jnp.arange(rp, dtype=jnp.int32)
    xs = (pix % w).astype(jnp.float32)
    ys = jnp.minimum(pix // w, h - 1).astype(jnp.float32)

    def local(scene, xs_l, ys_l):
        rd = pixel_dirs(scene, xs_l, ys_l, 0.5, 0.5)
        ro = jnp.broadcast_to(scene.cam_pos, rd.shape)
        counts = jnp.zeros((xs_l.shape[0],), jnp.int32)
        for mesh_data in scene.meshes:
            counts = counts + count_ac_nodes(
                mesh_data, ro, rd, use_ac=st.settings.use_ac
            )
        return counts

    counts = _shard_map(
        local, mesh=mesh, in_specs=(P(), P("rays"), P("rays")),
        out_specs=P("rays"),
    )(scene, xs, ys)[:r]
    ac_max = jnp.maximum(jnp.max(counts), 1)
    val = counts.astype(jnp.float32) / ac_max.astype(jnp.float32)
    return jnp.broadcast_to(val[None, :], (3, r)).reshape(3, h, w)


def render_scene_sharded(scene, mesh: Mesh, ray_block: int = DEFAULT_RAY_BLOCK,
                         ssaa_capacity: int | None = None,
                         queue_headroom: int = 1, out_u8: bool = False):
    """Jittable sharded render over `mesh` (1-D, axis 'rays').
    Returns (frame3 (3, H, W), aux) identical (up to f32 scheduling) to
    rendering_jax.render.pipeline.render_scene. `ssaa_capacity`
    overrides the fraction-derived refinement queue size and
    `queue_headroom` multiplies the per-device transparent-queue
    capacity (used by render_sharded's overflow auto-escalations —
    a device owning more than its 1/ndev share of glass pixels can
    need headroom the single-device render doesn't)."""
    from rendering_jax.render.pipeline import derive_mesh_tables, quantize_u8

    scene = derive_mesh_tables(scene)
    st = scene.static
    settings = st.settings
    if settings.show_ac:
        frame3 = _show_ac_sharded(scene, mesh)
        return (quantize_u8(frame3) if out_u8 else frame3), {
            "stats": _zero_stats(),
            "ssaa_masked": jnp.zeros((), jnp.int32),
        }
    frame3, stats = _primary_sharded(
        scene, mesh, ray_block=ray_block, queue_headroom=queue_headroom
    )
    n_masked = jnp.zeros((), jnp.int32)
    if settings.enable_ssaa:
        capacity = ssaa_capacity or max(
            1,
            int(settings.width * settings.height
                * settings.ssaa_capacity_fraction),
        )
        frame3, n_masked, s2 = _ssaa_sharded(
            scene, frame3, mesh, capacity=capacity, ray_block=ray_block,
            queue_headroom=queue_headroom,
        )
        for k in stats:
            stats[k] = stats[k] + s2[k]
    if out_u8:
        return quantize_u8(frame3), {"stats": stats,
                                     "ssaa_masked": n_masked}
    return frame3, {"stats": stats, "ssaa_masked": n_masked}


def render_sharded(scene, mesh: Mesh | None = None,
                   ray_block: int = DEFAULT_RAY_BLOCK,
                   out_u8: bool = False):
    """Host-facing sharded render: ((H, W, 3) numpy frame, aux).
    With out_u8 the frame is the BMP writer's exact u8 codes quantized
    on device (pipeline.quantize_u8); otherwise f32.

    Like pipeline.render, both static queue sizes auto-escalate so the
    output matches the single-chip render(): the SSAA refinement
    capacity on mask overflow, and the per-device transparent-queue
    headroom on path drops (sharding divides the queue by ndev, so an
    imbalanced glass region can overflow a device's share)."""
    from rendering_jax.render.pipeline import escalating_render

    mesh = mesh or make_ray_mesh()
    frame3, aux = escalating_render(
        lambda ssaa_cap, headroom: _cached_sharded_fn(
            mesh, ray_block, ssaa_cap, headroom, out_u8
        )(scene),
        scene.static.settings,
        # _ssaa_sharded pads the refinement capacity up to a multiple
        # of ndev; overflow is judged against what was actually refined.
        cap_pad=mesh.devices.size,
    )
    if out_u8:
        return np.asarray(frame3), aux  # already (H, W, 3) u8
    return np.asarray(frame3).transpose(1, 2, 0), aux


@functools.lru_cache(maxsize=16)
def _cached_sharded_fn(mesh: Mesh, ray_block: int,
                       ssaa_capacity: int | None = None,
                       queue_headroom: int = 1, out_u8: bool = False):
    return jax.jit(
        functools.partial(
            render_scene_sharded, mesh=mesh, ray_block=ray_block,
            ssaa_capacity=ssaa_capacity, queue_headroom=queue_headroom,
            out_u8=out_u8,
        )
    )

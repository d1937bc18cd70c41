"""Render pipeline — the reference's `Scene::render` orchestration
(src/scene.cpp:595-657) as jitted passes.

Pass structure:
  1. primary: full-pixel-grid wavefront integrate (replaces the 128x128
     tile scheduler + thread pool — data parallelism over pixels is the
     sharding axis across devices, see rendering_jax.parallel).
  2. adaptive SSAA (scene.cpp:508-593): Sobel edge mask -> edge pixels
     compacted to a static-capacity queue -> 4 subsample rays each at
     grid offsets +0.75/+1.25 (the reference's +0.25/+0.75 plus its
     getPixels +0.5) -> weighted scatter-mean back into the frame.
  3. debug modes: showNormals (first-hit normals), showAC (BVH
     node-visit heatmap, scene.cpp:607-635).

Frames are channel-first f32[3, H, W] on device (the large H, W axes
minor). The host-facing `render` returns the usual (H, W, 3) numpy
array.

Parity quirks: the last pixel row/column are never rendered by the
reference (its tile clamp, scene.cpp:369-372) and stay black; showAC
renders the FULL grid at +0.5 offsets and skips SSAA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rendering_jax.ops.sobel import sobel_mask
from rendering_jax.ops.traversal import count_ac_nodes
from rendering_jax.render.integrator import (
    DEFAULT_RAY_BLOCK,
    _zero_stats,
    integrate,
    shade_normals,
)
from rendering_jax.render.raygen import (
    pixel_dirs,
    primary_rays,
    ssaa_subsample_rays,
    tile_dims,
)


def quantize_u8(frame3):
    """Device-side (3, H, W) f32 -> (H, W, 3) u8, bit-identical to
    utils.bmp.quantize_reference (the reference writer's
    `static_cast<char>(clamp(0,1,f) * 255)`, src/util.cpp:50, as
    compiled: >= 255.0 saturates to 127, in-range truncates).
    jnp.floor before the integer convert pins truncation regardless of
    the backend's float->int rounding mode (values are non-negative).
    Quantizing on device shrinks the per-frame device->host transfer 4x
    (f32 -> u8) — at 3840x1080 that is ~50 MB -> ~12.4 MB per frame."""
    product = jnp.clip(frame3, 0.0, 1.0) * jnp.float32(255.0)
    u8 = jnp.floor(product).astype(jnp.uint8)
    u8 = jnp.where(product >= jnp.float32(255.0), jnp.uint8(127), u8)
    return jnp.moveaxis(u8, 0, -1)


def _untile(slots3, w: int, h: int):
    """Invert the primary-ray screen-tile permutation with reshapes +
    one transpose (tile_dims guarantees exact tiling): slot s maps to
    (tile_row, tile_col, y_in_tile, x_in_tile) row-major. Replaces a
    (3, w*h) pixel scatter with pure data movement."""
    tw, th = tile_dims(w, h)
    t = slots3.reshape(3, h // th, w // tw, th, tw)
    return t.transpose(0, 1, 3, 2, 4).reshape(3, h, w)


def _primary_pass(scene, *, ray_block=DEFAULT_RAY_BLOCK, queue_headroom=1):
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ro, rd, pix = primary_rays(scene, offset=1.0)
    if st.settings.show_normals:
        colors3 = shade_normals(scene, ro, rd, ray_block=ray_block)
        frame3 = _untile(colors3, w, h)
        stats = _zero_stats()
        stats["rays_casted"] = jnp.asarray(w * h, jnp.float32)
    else:
        weight = jnp.ones((w * h,), jnp.float32)
        if st.any_bouncing:
            accum3, stats = integrate(
                scene, ro, rd, pix, weight, n_pixels=w * h,
                ray_block=ray_block, queue_headroom=queue_headroom,
            )
            frame3 = accum3.reshape(3, h, w)
        else:
            # No bouncing: slots stay pixel-aligned for the whole
            # loop, so radiance accumulates per slot (no pixel
            # scatter) and one transpose undoes the tile order.
            slots3, stats = integrate(
                scene, ro, rd, pix, weight, n_pixels=w * h,
                ray_block=ray_block, out_slots=True,
            )
            frame3 = _untile(slots3, w, h)
    # Dead last row/column (scene.cpp:369-372): never rendered, stays 0.
    frame3 = frame3.at[:, h - 1, :].set(0.0)
    frame3 = frame3.at[:, :, w - 1].set(0.0)
    return frame3, stats


@functools.partial(
    jax.jit, static_argnames=("capacity", "ray_block", "queue_headroom")
)
def _ssaa_pass(scene, frame3, *, capacity: int, ray_block=DEFAULT_RAY_BLOCK,
               queue_headroom: int = 1):
    """Sobel-adaptive refinement. Returns (frame3, n_masked, stats).
    Jitted standalone for the strip-rendering paths (render_scene traces
    it inline; jit-of-jit is free)."""
    st = scene.static
    w, h = st.settings.width, st.settings.height
    mask = sobel_mask(frame3)
    flat_mask = mask.reshape(-1)
    n_masked = jnp.sum(flat_mask.astype(jnp.int32))

    (idx,) = jnp.nonzero(flat_mask, size=capacity, fill_value=w * h)
    valid = idx < w * h
    idx_c = jnp.minimum(idx, w * h - 1).astype(jnp.int32)
    ro, rd, pix, weight = ssaa_subsample_rays(scene, idx_c, valid, w)

    if st.settings.show_normals:
        colors3 = shade_normals(scene, ro, rd, ray_block=ray_block)
        accum3 = (
            jnp.zeros((3, w * h), jnp.float32)
            .at[:, pix]
            .add(weight[None, :] * colors3)
        )
        stats = _zero_stats()
    elif st.any_bouncing:
        accum3, stats = integrate(
            scene, ro, rd, pix, weight, n_pixels=w * h, ray_block=ray_block,
            queue_headroom=queue_headroom,
        )
    else:
        # No bouncing: slot accumulation (see _primary_pass) — rays are
        # concatenated subsample-major, so subsample i of masked pixel
        # k sits at slot i*capacity + k; the reshape(3, 4, capacity)
        # sum over axis 1 collapses them and the pixel scatter shrinks
        # from 4*capacity lanes into w*h to capacity lanes (this was
        # the last per-frame pixel-sized scatter on the SSAA path). Fill lanes
        # (idx clamped, weight 0) contribute exact zeros.
        slots3, stats = integrate(
            scene, ro, rd, pix, weight, n_pixels=w * h, ray_block=ray_block,
            out_slots=True,
        )
        summed3 = jnp.sum(slots3.reshape(3, 4, capacity), axis=1)
        accum3 = (
            jnp.zeros((3, w * h), jnp.float32).at[:, idx_c].add(summed3)
        )

    refined3 = accum3.reshape(3, h, w)
    frame3 = jnp.where(mask[None, :, :], refined3, frame3)
    return frame3, n_masked, stats


def _show_ac_pass(scene, *, ray_block=DEFAULT_RAY_BLOCK):
    """AC heatmap (scene.cpp:607-635): per-pixel count of BVH nodes whose
    AABB the primary ray hits (ancestors hitting too), normalized by the
    global max. Full grid, single +0.5 offset, no SSAA."""
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ro, rd, pix = primary_rays(scene, offset=0.5)

    q = w * h
    block = min(ray_block, q)
    nb = -(-q // block)
    pad = nb * block - q
    ro_p = jnp.pad(ro, ((0, pad), (0, 0)))
    rd_p = jnp.pad(rd, ((0, pad), (0, 0)), constant_values=1.0)

    def body(args):
        ro_b, rd_b = args
        counts = jnp.zeros((block,), jnp.int32)
        for mesh in scene.meshes:
            counts = counts + count_ac_nodes(
                mesh, ro_b, rd_b, use_ac=st.settings.use_ac
            )
        return counts

    counts = jax.lax.map(
        body, (ro_p.reshape(nb, block, 3), rd_p.reshape(nb, block, 3))
    ).reshape(-1)[:q]
    counts = jnp.zeros((q,), jnp.int32).at[pix].set(counts)
    ac_max = jnp.maximum(jnp.max(counts), 1)
    val = counts.astype(jnp.float32) / ac_max.astype(jnp.float32)
    return jnp.broadcast_to(val[None, :], (3, q)).reshape(3, h, w)


def derive_mesh_tables(scene):
    """Re-derive the transposed gather tables (vgeoT, packed mapsT)
    from the canonical per-triangle / per-map arrays INSIDE the traced
    program, so `jax.grad` w.r.t. vertices/normals/uvs/tangents and map
    texels flows through the differentiable hit re-evaluation (the
    build-time copies would be unconnected constants). One transpose
    per render — XLA hoists it out of the bounce loop."""
    import dataclasses

    def tables(m, ms):
        mapsT = None
        if ms.has_packed_maps:
            n_tex = ms.pmap_wh[0] * ms.pmap_wh[1]
            z3 = jnp.zeros((3, n_tex), jnp.float32)
            mapsT = jnp.concatenate(
                [
                    m.diffuse_map.T if ms.has_diffuse_map else z3,
                    m.normal_map.T if ms.has_normal_map else z3,
                    (m.specular_map.reshape(1, n_tex)
                     if ms.has_specular_map else z3[:1]),
                ],
                axis=0,
            )  # (7, Wp*Hp)
        return dataclasses.replace(
            m,
            vgeoT=jnp.concatenate(
                [m.v.reshape(-1, 9).T, m.n.reshape(-1, 9).T,
                 m.uv.reshape(-1, 6).T, m.tangent.T, m.bitangent.T],
                axis=0,
            ),
            mapsT=mapsT,
        )

    meshes = tuple(
        tables(m, ms) for m, ms in zip(scene.meshes, scene.static.meshes)
    )
    return dataclasses.replace(scene, meshes=meshes)


@functools.partial(
    jax.jit,
    static_argnames=("ray_block", "ssaa_capacity", "queue_headroom",
                     "out_u8"),
)
def render_scene(scene, ray_block: int = DEFAULT_RAY_BLOCK,
                 ssaa_capacity: int | None = None,
                 queue_headroom: int = 1, out_u8: bool = False):
    """Full jitted render: returns (frame3 (3, H, W) f32, aux dict).

    aux contains device-side stats counters and the SSAA mask size
    (for capacity-overflow detection host-side). `ssaa_capacity`
    overrides the fraction-derived refinement queue size;
    `queue_headroom` multiplies the transparent continuation-queue
    capacity (both used by the host wrapper's overflow
    auto-escalations). `out_u8` (static) quantizes the finished frame
    on device to the BMP writer's exact u8 codes and returns
    (H, W, 3) u8 instead — for hosts that only write the image out.
    """
    scene = derive_mesh_tables(scene)
    st = scene.static
    settings = st.settings
    if settings.show_ac:
        frame3 = _show_ac_pass(scene, ray_block=ray_block)
        return (quantize_u8(frame3) if out_u8 else frame3), {
            "stats": _zero_stats(),
            "ssaa_masked": jnp.zeros((), jnp.int32),
        }

    frame3, stats = _primary_pass(
        scene, ray_block=ray_block, queue_headroom=queue_headroom
    )
    n_masked = jnp.zeros((), jnp.int32)
    if settings.enable_ssaa:
        capacity = ssaa_capacity or max(
            1, int(settings.width * settings.height
                   * settings.ssaa_capacity_fraction)
        )
        frame3, n_masked, s2 = _ssaa_pass(
            scene, frame3, capacity=capacity, ray_block=ray_block,
            queue_headroom=queue_headroom,
        )
        for k in stats:
            stats[k] = stats[k] + s2[k]
    if out_u8:
        return quantize_u8(frame3), {"stats": stats,
                                     "ssaa_masked": n_masked}
    return frame3, {"stats": stats, "ssaa_masked": n_masked}


# Upper bound for the transparent-queue headroom escalation: headroom
# h costs h x queue lanes per bounce (dead lanes are kernel-culled but
# still shade), so a frame whose transparent tree outgrows 8 slots per
# pixel keeps the drop warning instead of escalating further.
MAX_QUEUE_HEADROOM = 8


def render(scene, ray_block: int = DEFAULT_RAY_BLOCK,
           out_u8: bool = False):
    """Host-facing render: returns ((H, W, 3) numpy frame, aux).
    With out_u8 the frame is the BMP writer's exact u8 codes,
    quantized on device (4x smaller device->host transfer); otherwise
    f32 in [0, 1+].

    Two auto-escalations keep the output exact regardless of the
    static queue sizes (each redo is a bounded recompile):
    * SSAA overflow — more Sobel-masked edge pixels than the
      fraction-derived capacity: redo with the capacity raised to the
      measured mask size (next power of two), equal to fraction=1.0.
    * Transparent-path drops — the 2^depth continuation tree outgrew
      one queue slot per input ray: redo with the queue headroom
      doubled (the reference's recursion never drops paths), up to
      MAX_QUEUE_HEADROOM (then the drop warning stands)."""
    import numpy as np

    frame3, aux = escalating_render(
        lambda ssaa_cap, headroom: render_scene(
            scene, ray_block=ray_block, ssaa_capacity=ssaa_cap,
            queue_headroom=headroom, out_u8=out_u8,
        ),
        scene.static.settings,
    )
    if out_u8:
        frame = np.asarray(frame3)  # already (H, W, 3) u8
    else:
        frame = np.asarray(frame3).transpose(1, 2, 0)
    return frame, aux


def escalating_render(render_fn, st, *, cap_pad: int = 1):
    """The SSAA-capacity / transparent-queue auto-escalation policy,
    shared by every host-facing wrapper (render, render_sharded):
    render_fn(ssaa_cap, headroom) -> (frame3, aux) is re-invoked with
    the capacity raised to the measured mask size (next power of two)
    on SSAA overflow and the queue headroom doubled on path drops, so
    the output is exact regardless of the static queue sizes. cap_pad:
    the sharded SSAA pass pads its capacity up to a multiple of ndev —
    overflow is judged against what was actually refined, or the
    padding window would trigger spurious identical redos. Emits the
    drop warning on the final attempt's stats."""
    cap = max(1, int(st.width * st.height * st.ssaa_capacity_fraction))
    ssaa_cap = None
    headroom = 1
    while True:
        frame3, aux = render_fn(ssaa_cap, headroom)
        redo = False
        n_masked = int(aux["ssaa_masked"])
        eff_cap = -(-(ssaa_cap or cap) // cap_pad) * cap_pad
        if st.enable_ssaa and not st.show_ac and n_masked > eff_cap:
            ssaa_cap = min(
                st.width * st.height,
                1 << (max(n_masked, 2) - 1).bit_length(),
            )
            redo = True
        if (float(aux["stats"].get("paths_dropped", 0.0)) > 0
                and headroom < MAX_QUEUE_HEADROOM):
            headroom *= 2
            redo = True
        if not redo:
            break
    warn_dropped_paths(aux["stats"])
    return frame3, aux


def warn_dropped_paths(stats) -> None:
    """Print the transparent-queue drop warning when a render's stats
    report compacted-away continuation paths (shared by every
    host-facing render wrapper; drops must stay 0 for exact parity with
    the reference's unbounded recursion)."""
    dropped = float(stats.get("paths_dropped", 0.0))
    if dropped:
        print(
            f"warning: {dropped:.0f} transparent continuation paths were "
            f"dropped by queue compaction; output deviates from the "
            f"reference's unbounded recursion"
        )


@functools.lru_cache(maxsize=16)
def _make_strip_fns(mesh, ray_block, queue_headroom=1):
    """(strip_fn, ssaa_fn) for the strip-rendering paths: single-device
    when mesh is None, shard_map'd over a 1-D ('rays',) mesh, or
    geometry-sharded over a 2-D ('rays', 'geo') mesh. Same contracts
    either way: strip_fn(scene, y0=, rows=) -> (strip accum, stats),
    ssaa_fn(scene, frame3, capacity) -> (frame3, n_masked, stats) —
    each variant owns its gather-table derivation (the geo-sharded one
    must NOT derive eagerly: that would stage O(T) arrays whole).

    Only `rows` is a static jit argument — y0 enters the row indices
    additively, so it traces as a scalar and a whole-frame strip render
    compiles at most TWO programs (full strip + tail strip) instead of
    one per strip; the lru_cache reuses the jit wrappers (and their
    compile cache) across renders."""
    if mesh is not None and "geo" in mesh.axis_names:
        from rendering_jax.parallel.geoshard import make_geo_strip_fns

        return make_geo_strip_fns(mesh, ray_block, queue_headroom)
    if mesh is None:
        strip_fn = jax.jit(
            functools.partial(_render_strip, ray_block=ray_block,
                              queue_headroom=queue_headroom),
            static_argnames=("rows",),
        )

        def ssaa_fn(scene, frame3, capacity):
            return _ssaa_pass(derive_mesh_tables(scene), frame3,
                              capacity=capacity, ray_block=ray_block,
                              queue_headroom=queue_headroom)

        return strip_fn, ssaa_fn

    from rendering_jax.parallel.shard import (
        render_strip_sharded,
        ssaa_pass_sharded,
    )

    strip_fn = jax.jit(
        functools.partial(render_strip_sharded, mesh=mesh,
                          ray_block=ray_block,
                          queue_headroom=queue_headroom),
        static_argnames=("rows",),
    )

    def ssaa_fn(scene, frame3, capacity):
        return ssaa_pass_sharded(derive_mesh_tables(scene), frame3, mesh,
                                 capacity=capacity, ray_block=ray_block,
                                 queue_headroom=queue_headroom)

    return strip_fn, ssaa_fn


def render_with_progress(scene, *, strip_rows: int = 128,
                         ray_block: int = DEFAULT_RAY_BLOCK,
                         mesh=None, queue_headroom: int = 1,
                         out_u8: bool = False,
                         _now=None, _print=print):
    """`outputProgress` render (src/scene.cpp:486-492): the frame is
    produced in horizontal strips and the completed-pixel percentage is
    printed at most once per second, formatted like the reference
    (`std::fixed << setw(2) << setprecision(0) << pct << "%"`). With
    `mesh` every strip (and the SSAA pass) renders sharded over the
    device mesh (shard.render_strip_sharded). Strips
    scatter into disjoint pixels and each primary ray's bounce tree
    lives in its own wavefront queue, so output equals render() up to
    f32 instruction scheduling (<= 1 ulp: the SSAA stage runs as its
    own XLA program here vs inline in render_scene's; transparent
    materials can also reorder a pixel's continuation children in the
    per-strip queue sort). Returns ((H, W, 3) numpy frame, aux)."""
    import time as _time

    import numpy as np

    now = _now or _time.perf_counter
    st = scene.static.settings
    if st.show_ac:
        # showAC skips strips and SSAA (scene.cpp:607-635 renders the
        # whole heatmap in one pass); delegate so the output matches
        # render() instead of silently rendering the normal image.
        if mesh is not None and "geo" in mesh.axis_names:
            from rendering_jax.parallel.geoshard import (
                render_scene_geo_sharded,
            )

            frame3, aux = render_scene_geo_sharded(scene, mesh,
                                                   ray_block=ray_block)
        elif mesh is not None:
            from rendering_jax.parallel.shard import _cached_sharded_fn

            frame3, aux = _cached_sharded_fn(mesh, ray_block)(scene)
        else:
            frame3, aux = render_scene(scene, ray_block=ray_block)
        if out_u8:
            frame = np.asarray(jax.jit(quantize_u8)(frame3))
        else:
            frame = np.asarray(frame3).transpose(1, 2, 0)
        _print("100%")
        return frame, {
            "stats": {k: float(v) for k, v in aux["stats"].items()},
            "ssaa_masked": aux["ssaa_masked"],
        }
    w, h = st.width, st.height
    n_strips = -(-h // strip_rows)
    last = now()
    done_px = 0
    coef = 100.0 / (w * h)
    strip_fn, ssaa_fn = _make_strip_fns(mesh, ray_block, queue_headroom)
    stats_acc = {k: 0.0 for k in _zero_stats()}

    # Pipelined strips with ZERO per-strip pixel pulls: the strip
    # accumulators STAY ON DEVICE (the progress loop has no durability
    # contract — render_resumable is the one that must land pixels on
    # the host). Strip k+1 is dispatched (JAX dispatch is
    # asynchronous) before strip k is awaited; the await itself is the
    # host read of strip k's psum'd stats SCALARS — a few bytes that
    # complete only when the strip's program has run, which is exactly
    # the once-per-second progress semantic. The finished frame
    # assembles device-side from the kept parts, so the whole path
    # moves scalars per strip + one final frame pull (u8 when out_u8)
    # instead of pull-strip + re-upload + pull-frame (~3x the bytes).
    parts = []  # device strip accumulators, in y order

    def drain(p):
        nonlocal done_px, last
        rowsp, s_stats = p
        for k in stats_acc:
            stats_acc[k] += float(s_stats[k])  # sync: strip k finished
        done_px += rowsp * w
        if (now() - last) > 1.0:
            _print(f"{coef * done_px:2.0f}%")
            last = now()

    pending = None
    for s in range(n_strips):
        y0 = s * strip_rows
        rows = min(strip_rows, h - y0)
        part, s_stats = strip_fn(scene, y0=y0, rows=rows)
        parts.append(part)
        if pending is not None:
            drain(pending)
        pending = (rows, s_stats)
    drain(pending)
    accum3 = jnp.concatenate(parts, axis=1)  # (3, h*w), device

    frame3, n_masked = _finish_strips(scene, accum3, stats_acc, ssaa_fn,
                                      timers=True)
    if (stats_acc["paths_dropped"] > 0
            and queue_headroom < MAX_QUEUE_HEADROOM):
        # Transparent tree outgrew the queue: redo with double headroom
        # (same escalation as render(); the reference never drops).
        return render_with_progress(
            scene, strip_rows=strip_rows, ray_block=ray_block, mesh=mesh,
            queue_headroom=queue_headroom * 2, out_u8=out_u8,
            _now=_now, _print=_print,
        )
    # The strips themselves must pull f32 (the SSAA Sobel pass reads
    # the accumulated frame), but the FINISHED frame can quantize on
    # device: out_u8 shrinks the final whole-frame pull 4x (the CLI
    # only writes the BMP).
    if out_u8:
        frame = np.asarray(jax.jit(quantize_u8)(frame3))
    else:
        frame = np.asarray(frame3).transpose(1, 2, 0)
    warn_dropped_paths(stats_acc)
    return frame, {"stats": stats_acc, "ssaa_masked": n_masked}


def _finish_strips(scene, accum3, stats_acc, ssaa_fn, *, timers: bool):
    """Shared tail of the strip-rendering wrappers (render_with_progress
    / render_resumable): blacks out the reference's dead last
    row/column, then runs the whole-frame adaptive-SSAA pass with the
    escalate-once-to-exact retry, merging its stats into stats_acc in
    place. SSAA also runs under showNormals — the reference's
    SSAAworker casts through castRay, which returns normal colors in
    that mode (scene.cpp:601-605, 771-772); _ssaa_pass has the matching
    branch. timers: print the reference's Sobel/MSAA phase timers
    (scene.cpp:544,553) when the scene has output enabled. Returns
    (frame3, n_masked)."""
    st = scene.static.settings
    w, h = st.width, st.height
    frame3 = jnp.asarray(accum3.reshape(3, h, w))
    frame3 = frame3.at[:, h - 1, :].set(0.0)
    frame3 = frame3.at[:, :, w - 1].set(0.0)
    n_masked = jnp.zeros((), jnp.int32)
    if st.enable_ssaa:
        from rendering_jax.utils.timer import Timer

        show = timers and st.enable_output
        # The Sobel mask is recomputed inside the jitted SSAA program;
        # this standalone evaluation (sub-ms conv2d) exists only to
        # report the phase, so it runs only when the print would.
        if show:
            t_sobel = Timer("Sobel filter", True)
            t_sobel.stop(jax.jit(sobel_mask)(frame3))
        t_msaa = Timer("MSAA", show)
        capacity = max(1, int(w * h * st.ssaa_capacity_fraction))
        base3 = frame3
        frame3, n_masked, s2 = ssaa_fn(scene, base3, capacity)
        if int(n_masked) > capacity:  # auto-escalate: exact refinement
            capacity = min(w * h,
                           1 << (max(int(n_masked), 2) - 1).bit_length())
            frame3, n_masked, s2 = ssaa_fn(scene, base3, capacity)
        t_msaa.stop(frame3)
        for k in stats_acc:
            stats_acc[k] += float(s2[k])
    return frame3, n_masked


def _scene_fingerprint(scene) -> np.int64:
    """Identity hash of a scene for checkpoint validation: the static
    config repr plus every leaf's shape, dtype and full bytes (one
    device-to-host read per leaf, small next to the render it
    protects). Any edit to any leaf changes it; this is validation,
    not authentication."""
    import hashlib

    import numpy as np

    h = hashlib.sha1()
    h.update(repr(scene.static).encode())
    for leaf in jax.tree_util.tree_leaves(scene):
        a = np.asarray(leaf)
        h.update(f"{a.shape}|{a.dtype};".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest()[:8], dtype=np.int64)[0]


def render_resumable(scene, checkpoint_path: str, *, strip_rows: int = 128,
                     resume: bool = True, ray_block: int = DEFAULT_RAY_BLOCK,
                     mesh=None, queue_headroom: int = 1,
                     out_u8: bool = False):
    """Preemption-safe render: the frame is produced in horizontal strips
    of `strip_rows` pixel rows, checkpointing the accumulated framebuffer
    and finished-strip mask after each strip (SURVEY sections 5.3/5.4 —
    the reference is all-or-nothing; this is the accelerator analogue of
    per-tile checkpointing). On restart with resume=True, finished
    strips are skipped. The adaptive-SSAA refinement (whole-frame pass)
    runs only once all strips are done. With `mesh` every strip and the
    SSAA pass render sharded over the device mesh — preemption-safe
    long renders on multi-chip.

    Returns ((H, W, 3) numpy frame, aux). Strips are independent because
    every primary ray's full bounce tree lives in its own wavefront
    queue — output equals render() up to f32 instruction scheduling
    (<= 1 ulp; the SSAA stage runs as its own XLA program here, inline
    in render_scene's).
    """
    import os

    import numpy as np

    from rendering_jax.diff.checkpoint import (
        load_checkpoint,
        load_checkpoint_meta,
        save_checkpoint,
    )

    st = scene.static.settings
    if st.show_ac:
        # showAC is a single whole-frame debug pass (no strips, no
        # SSAA) — delegate instead of stripping the normal image.
        if mesh is not None and "geo" in mesh.axis_names:
            from rendering_jax.parallel.geoshard import (
                render_scene_geo_sharded,
            )

            frame3, aux = render_scene_geo_sharded(scene, mesh,
                                                   ray_block=ray_block)
        elif mesh is not None:
            from rendering_jax.parallel.shard import _cached_sharded_fn

            frame3, aux = _cached_sharded_fn(mesh, ray_block)(scene)
        else:
            frame3, aux = render_scene(scene, ray_block=ray_block)
        frame = (np.asarray(jax.jit(quantize_u8)(frame3)) if out_u8
                 else np.asarray(frame3).transpose(1, 2, 0))
        return (
            frame,
            {"stats": {k: float(v) for k, v in aux["stats"].items()},
             "ssaa_masked": aux["ssaa_masked"]},
        )
    w, h = st.width, st.height
    n_strips = -(-h // strip_rows)

    accum3 = np.zeros((3, h * w), np.float32)
    done = np.zeros((n_strips,), bool)
    stats_acc = {k: 0.0 for k in _zero_stats()}
    fp = _scene_fingerprint(scene)
    if resume and os.path.exists(checkpoint_path):
        _step, _p, _o, frame_ck, mask_ck = load_checkpoint(
            checkpoint_path, {}, {}
        )
        meta = load_checkpoint_meta(checkpoint_path)
        # The strip mask length must match the current strip layout —
        # a checkpoint taken at a different strip_rows would map done
        # entries onto different row ranges (silently corrupt frame) —
        # and the scene fingerprint must match: a checkpoint from a
        # different scene/settings at the same resolution would
        # otherwise be silently reused as finished pixels.
        fp_ok = ("scene_fp" in meta
                 and int(meta["scene_fp"]) == int(fp)
                 and int(meta.get("queue_headroom", 1)) == queue_headroom)
        if (
            frame_ck is not None
            and frame_ck.shape == accum3.shape
            and mask_ck is not None
            and len(np.asarray(mask_ck)) == n_strips
            and fp_ok
        ):
            # Copy: the loop writes strips into accum3 in place, and a
            # loaded checkpoint array may be read-only.
            accum3 = np.asarray(frame_ck).copy()
            done = np.asarray(mask_ck).astype(bool)
            # Restore the finished strips' accumulated counters —
            # paths_dropped in particular must survive a preemption,
            # or a resumed glass-heavy render would skip the headroom
            # escalation redo (and its warning) that an uninterrupted
            # run performs.
            for k in stats_acc:
                if k in meta:
                    stats_acc[k] = float(meta[k])
        elif frame_ck is not None and not fp_ok:
            print(
                "warning: ignoring checkpoint (scene or settings "
                "changed since it was written); rendering from scratch"
            )

    strip_fn, ssaa_fn = _make_strip_fns(mesh, ray_block, queue_headroom)

    # Pipelined like render_with_progress: strip k+1 dispatches before
    # strip k's pull + checkpoint write. The checkpoint still only
    # marks a strip done AFTER its pixels are host-side — a preemption
    # between dispatch and drain loses exactly that strip, the same
    # window the serial loop had mid-pull.
    def drain(p):
        s_idx, y0p, rowsp, part, s_stats = p
        accum3[:, y0p * w : y0p * w + rowsp * w] = np.asarray(part)
        for k in stats_acc:
            stats_acc[k] += float(s_stats[k])
        done[s_idx] = True
        save_checkpoint(checkpoint_path, s_idx + 1, {}, {}, frame=accum3,
                        tile_mask=done,
                        meta={"scene_fp": fp,
                              "queue_headroom": queue_headroom,
                              **stats_acc})

    pending = None
    for s in range(n_strips):
        if done[s]:
            continue
        y0 = s * strip_rows
        rows = min(strip_rows, h - y0)
        out = strip_fn(scene, y0=y0, rows=rows)
        if pending is not None:
            drain(pending)
        pending = (s, y0, rows, *out)
    if pending is not None:
        drain(pending)

    frame3, n_masked = _finish_strips(scene, accum3, stats_acc, ssaa_fn,
                                      timers=False)
    if (stats_acc["paths_dropped"] > 0
            and queue_headroom < MAX_QUEUE_HEADROOM):
        # Redo from scratch with double headroom (resume=False: the
        # checkpointed strips were rendered with the dropping queue).
        return render_resumable(
            scene, checkpoint_path, strip_rows=strip_rows, resume=False,
            ray_block=ray_block, mesh=mesh,
            queue_headroom=queue_headroom * 2, out_u8=out_u8,
        )
    # Checkpoints stay f32 (resume math needs the accumulators); only
    # the finished frame's pull shrinks 4x under out_u8.
    if out_u8:
        frame = np.asarray(jax.jit(quantize_u8)(frame3))
    else:
        frame = np.asarray(frame3).transpose(1, 2, 0)
    warn_dropped_paths(stats_acc)
    return frame, {"stats": stats_acc, "ssaa_masked": n_masked}


def _render_strip(scene, *, y0, rows: int, ray_block: int,
                  queue_headroom: int = 1):
    """Integrate the primary rays of pixel rows [y0, y0+rows) into a
    STRIP-SIZED (3, rows*w) flat accumulator (jittable; rows static,
    y0 TRACED — it only offsets the row indices, so every full-height
    strip shares one compiled program). Strip-sized so the
    progress/resumable host loops pull rows*w pixels per strip instead
    of a full frame each (at 3840x1080 with 128-row strips that is
    ~6 MB vs ~50 MB per pull, x9 strips)."""
    scene = derive_mesh_tables(scene)
    st = scene.static
    settings = st.settings
    w = settings.width
    ys, xs = jnp.meshgrid(
        jnp.arange(rows, dtype=jnp.float32) + jnp.float32(y0),
        jnp.arange(w, dtype=jnp.float32),
        indexing="ij",
    )
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    rd = pixel_dirs(scene, xs, ys, 1.0, 1.0)
    ro = jnp.broadcast_to(scene.cam_pos, rd.shape)
    if settings.show_normals:
        accum3 = shade_normals(scene, ro, rd, ray_block=ray_block)
        stats = _zero_stats()
        # Strip totals sum to _primary_pass's w*h count.
        stats["rays_casted"] = jnp.asarray(rows * w, jnp.float32)
        return accum3, stats
    weight = jnp.ones((rows * w,), jnp.float32)
    pix = jnp.arange(rows * w, dtype=jnp.int32)  # strip-local pixels
    if st.any_bouncing:
        return integrate(
            scene, ro, rd, pix, weight, n_pixels=rows * w,
            ray_block=ray_block, queue_headroom=queue_headroom,
        )
    # No bouncing: rays ARE the strip pixels in order — slot
    # accumulation returns them directly, no scatter at all.
    return integrate(
        scene, ro, rd, pix, weight, n_pixels=rows * w,
        ray_block=ray_block, out_slots=True,
    )

"""Batched primary-ray generation.

Replaces `Camera::getRay` + the per-pixel loops in `renderWorker`
(src/scene.cpp:16-54, 444-468) with one broadcast over the pixel grid.

Parity quirks reproduced (SURVEY section 3):
* The reference double-adds 0.5: renderWorker passes (x+0.5, y+0.5) and
  the getPixels lambda adds another +0.5, so the primary sample sits at
  grid position (x+1.0, y+1.0). SSAA subsamples land at +0.75/+1.25.
  The showAC path adds only one +0.5. Callers pass the TOTAL offset.
* NDC: xPix = (2*sx/W - 1) * scale * aspect, yPix = -(2*sy/H - 1) *
  scale, aspect = W/H (scene.cpp:447-457).
* Direction = normalize((xPix, yPix, -1)) @ R (rotation applied AFTER
  normalization, scene.cpp:52).
"""

from __future__ import annotations

import jax.numpy as jnp

from rendering_jax.ops.geometry import normalize


def pixel_dirs(scene, xs, ys, offset_x: float, offset_y: float):
    """xs/ys: (R,) float pixel coordinates. Returns rd (R, 3)."""
    st = scene.static.settings
    w = jnp.float32(st.width)
    h = jnp.float32(st.height)
    aspect = w / h
    x_pix = (2.0 * (xs + offset_x) / w - 1.0) * scene.scale * aspect
    y_pix = -(2.0 * (ys + offset_y) / h - 1.0) * scene.scale
    d = jnp.stack([x_pix, y_pix, -jnp.ones_like(x_pix)], axis=-1)
    d = normalize(d)
    # Row-vector rotate d @ R, written as multiply-adds: a (R,3)x(3,3)
    # default-precision jnp matmul may run in reduced precision (TF32
    # on a GPU) and break f32 parity with the reference.
    r = scene.cam_rmat
    return d[:, 0:1] * r[0] + d[:, 1:2] * r[1] + d[:, 2:3] * r[2]


def tile_dims(w: int, h: int, tw: int = 32, th: int = 16):
    """Largest tile dims <= (tw, th) that divide the frame exactly.
    With exact tiling the screen-tile permutation is a pure reshape +
    transpose, so the primary pass can invert it with a transpose
    instead of a 4M-lane scatter/gather (see pipeline._primary_pass)."""
    while tw > 1 and w % tw:
        tw //= 2
    while th > 1 and h % th:
        th //= 2
    return tw, th


def primary_rays(scene, offset: float = 1.0, *, tiled: bool = True):
    """Full-frame ray grid. Pixel id (pix = y*W + x) rides with each
    ray; rays are emitted in screen-tile order when `tiled` — the
    analogue of the reference's 128x128 tile scheduler
    (src/scene.cpp:362-379): each ray batch the intersection kernel
    sees is a compact screen rect, maximizing per-chunk AABB culling.
    Returns (ro, rd, pix) with shapes (R, 3), (R, 3), (R,)."""
    st = scene.static.settings
    w, h = st.width, st.height
    if tiled:
        # Tile-order coordinates ARITHMETICALLY from the slot index
        # (tile_dims guarantees exact tiling, so slot -> (x, y) is pure
        # integer math) instead of two 4M-element permutation gathers.
        tw, th = tile_dims(w, h)
        s = jnp.arange(w * h, dtype=jnp.int32)
        tile_id, within = s // (tw * th), s % (tw * th)
        ty, tx = within // tw, within % tw
        tiles_x = w // tw
        x = (tile_id % tiles_x) * tw + tx
        y = (tile_id // tiles_x) * th + ty
        xs = x.astype(jnp.float32)
        ys = y.astype(jnp.float32)
        pix = y * w + x
    else:
        ys, xs = jnp.meshgrid(
            jnp.arange(h, dtype=jnp.float32),
            jnp.arange(w, dtype=jnp.float32),
            indexing="ij",
        )
        xs = xs.reshape(-1)
        ys = ys.reshape(-1)
        pix = jnp.arange(w * h, dtype=jnp.int32)
    rd = pixel_dirs(scene, xs, ys, offset, offset)
    ro = jnp.broadcast_to(scene.cam_pos, rd.shape)
    return ro, rd, pix


def ssaa_subsample_rays(scene, idx, valid, w: int):
    """The 4 SSAA refinement subsample rays of each masked pixel — the
    parity-pinned sampling (0.25/0.75 subpixel grid PLUS the +0.5 from
    the reference's getPixels lambda, scene.cpp:517-521), shared by the
    single-device (_ssaa_pass) and sharded (_ssaa_sharded) refinement
    passes so the quirk lives in exactly one place. idx: (K,) i32
    CLAMPED pixel ids; valid: (K,) bool (fill lanes get weight 0).
    Returns (ro, rd, pix, weight) concatenated subsample-major:
    subsample i of masked pixel k sits at row i*K + k."""
    xs = (idx % w).astype(jnp.float32)
    ys = (idx // w).astype(jnp.float32)
    ros, rds, pixs, wts = [], [], [], []
    for ox, oy in ((0.25, 0.25), (0.25, 0.75), (0.75, 0.25), (0.75, 0.75)):
        rd = pixel_dirs(scene, xs, ys, ox + 0.5, oy + 0.5)
        rds.append(rd)
        ros.append(jnp.broadcast_to(scene.cam_pos, rd.shape))
        pixs.append(idx)
        wts.append(jnp.where(valid, 0.25, 0.0))
    return (jnp.concatenate(ros), jnp.concatenate(rds),
            jnp.concatenate(pixs), jnp.concatenate(wts))

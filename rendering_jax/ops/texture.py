"""Nearest-neighbor map sampling (Mesh::{getDiffuseColor,
getSpecularValue,getSurfaceData} map paths, src/objects.cpp:121-175).

Maps live as flat (H*W, C) arrays in the reference's loadBMP layout
(bottom-up rows, see utils/bmp.py), so the index expression
`(int)(H*ty) * W + (int)(W*tx)` (with high-side clamping only) is
reproduced verbatim. All gathers are differentiable w.r.t. the map
texels (piecewise-constant w.r.t. the UVs, as in the reference).
"""

from __future__ import annotations

import jax.numpy as jnp


def _map_index(tx, ty, w: int, h: int):
    wi = (w * tx).astype(jnp.int32)
    hi = (h * ty).astype(jnp.int32)
    wi = jnp.minimum(wi, w - 1)  # high-side clamp only (objects.cpp:146-148)
    hi = jnp.minimum(hi, h - 1)
    return hi * w + wi


def sample_map(flat_map, wh, tex):
    """flat_map: (H*W, C) or (H*W,); wh: (W, H) static; tex: (R, 2)."""
    w, h = int(wh[0]), int(wh[1])
    idx = _map_index(tex[:, 0], tex[:, 1], w, h)
    return flat_map[idx]


def sample_packed(mapsT, wh, tex):
    """Gather all rows of a packed transposed map table at once.
    mapsT: (rows, H*W); wh: (W, H) static; tex: (R, 2).
    Returns (rows, R) — one gather serves every map sharing these
    texel indices (a gather costs per index more than per row)."""
    w, h = int(wh[0]), int(wh[1])
    idx = _map_index(tex[:, 0], tex[:, 1], w, h)
    return mapsT[:, idx]


def sample_map_r(flat_map, wh, tex2):
    """sample_map on rows: tex2 (2, R) -> (C, R) (or (1, R) for a
    single-channel map). Same texel indices/values; the gather runs
    against the channel-first view so its output lands rays-minor."""
    w, h = int(wh[0]), int(wh[1])
    idx = _map_index(tex2[0], tex2[1], w, h)
    if flat_map.ndim == 1:
        return flat_map[idx][None]
    return flat_map.T[:, idx]


def sample_packed_r(mapsT, wh, tex2):
    """sample_packed with row texcoords: tex2 (2, R) -> (rows, R)."""
    w, h = int(wh[0]), int(wh[1])
    idx = _map_index(tex2[0], tex2[1], w, h)
    return mapsT[:, idx]


def _bilinear_corners(tx, ty, w: int, h: int):
    """4 corner texel indices + blend weights for bilinear filtering.
    Texel centers sit at (i + 0.5)/w (so a sample exactly on a center
    reproduces that texel); edges clamp. Returns (idx4 (4, R) i32,
    wts4 (4, R) f32). The weights are differentiable in (tx, ty) —
    this is the whole point of the bilinear option: smooth in-texture
    gradients for inverse rendering (the framework extension; the
    reference is nearest-only, objects.cpp:144-172)."""
    fx = w * tx - 0.5
    fy = h * ty - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    ax = fx - x0
    ay = fy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    idx4 = jnp.stack(
        [y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i]
    )
    wts4 = jnp.stack(
        [(1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay, ax * ay]
    )
    return idx4, wts4


def sample_map_bilinear_r(flat_map, wh, tex2):
    """Bilinear sample_map_r: tex2 (2, R) -> (C, R) (or (1, R))."""
    w, h = int(wh[0]), int(wh[1])
    idx4, wts4 = _bilinear_corners(tex2[0], tex2[1], w, h)
    fm = flat_map[None] if flat_map.ndim == 1 else flat_map.T
    vals = fm[:, idx4]                      # (C, 4, R)
    return jnp.sum(vals * wts4[None], axis=1)


def sample_packed_bilinear_r(mapsT, wh, tex2):
    """Bilinear sample_packed_r: one (rows, 4R) gather + weighted sum.
    tex2 (2, R) -> (rows, R)."""
    w, h = int(wh[0]), int(wh[1])
    idx4, wts4 = _bilinear_corners(tex2[0], tex2[1], w, h)
    vals = mapsT[:, idx4]                   # (rows, 4, R)
    return jnp.sum(vals * wts4[None], axis=1)

"""Six-face skybox lookup (Scene::getSkybox, src/scene.cpp:381-442).

The reference picks the dominant-|axis| face with an if/else ladder
whose ORDER is load-bearing for ties (z checked first, then x, else y),
projects the direction onto the face plane, and nearest-texel samples
with `toPixel(v) = min((int)((v+1)/2*max), max-1)`.

Face index mapping (scene-file key order left,front,right,back,top,
bottom): 0=left(x<0), 1=front(z<0), 2=right(x>0), 3=back(z>0),
4=top(y>0), 5=bottom(y<0).

Branchless: compute (face, i, j) per ray with selects, one
gather from the replicated (6, H, W, 3) array. The array rows are in
loadBMP order (bottom-up), same as the reference's in-memory layout, so
index math is identical.
"""

from __future__ import annotations

import jax.numpy as jnp


def _to_pixel(v, maximum: int):
    val = ((v + 1.0) / 2.0 * maximum).astype(jnp.int32)
    return jnp.minimum(val, maximum - 1)


def _face_ij(x, y, z, h: int, w: int):
    """The face ladder + projection + texel math shared by both entry
    points (any fix here must stay single-sourced — the values are a
    byte-parity surface). Returns (face, i, j) i32 arrays."""
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    m = jnp.maximum(ax, jnp.maximum(ay, az))

    # Guard zero-length dirs (cannot occur for camera rays).
    safe = jnp.where(m > 0, m, 1.0)
    # RECIPROCAL then multiply, exactly like `dir * (1 / -dir.z)`
    # (scene.cpp:398-439): the reciprocal rounds once and each product
    # rounds again — a plain division rounds only once and can land a
    # different nearest texel when (v+1)/2*W sits within 1 ulp of an
    # integer boundary. The reciprocal's argument is ±component ==
    # |component| == m (fabs/negation are exact), so 1/safe matches.
    recip = 1.0 / safe
    px, py, pz = x * recip, y * recip, z * recip

    # Ladder order: z first, then x, else y (scene.cpp:398-439).
    is_z = m == az
    is_x = (~is_z) & (m == ax)
    neg = jnp.where(is_z, z < 0, jnp.where(is_x, x < 0, y < 0))

    face = jnp.where(
        is_z,
        jnp.where(neg, 1, 3),
        jnp.where(is_x, jnp.where(neg, 0, 2), jnp.where(neg, 5, 4)),
    ).astype(jnp.int32)

    # Per-face (i, j) projection.
    i_val = jnp.where(is_z | is_x, py, pz)
    j_val = jnp.where(
        is_z,
        jnp.where(neg, px, -px),
        jnp.where(is_x, jnp.where(neg, -pz, pz), px),
    )
    return face, _to_pixel(i_val, h), _to_pixel(j_val, w)


def sample_skybox(skybox, dir, bg_color):
    """skybox: (6, H, W, 3) or None; dir: (R, 3); bg_color: (3,).
    Returns (R, 3). With no skybox returns the background color
    (scene.cpp:383-385)."""
    if skybox is None:
        return jnp.broadcast_to(bg_color, dir.shape)
    h = int(skybox.shape[1])
    w = int(skybox.shape[2])
    face, i, j = _face_ij(dir[:, 0], dir[:, 1], dir[:, 2], h, w)
    return skybox[face, i, j]


def sample_skybox_r(skybox, dir3, bg_color):
    """sample_skybox on rows: dir3 (3, R) -> (3, R). Same face ladder,
    projection, and texel math (values bit-identical); the gather runs
    against the channel-first view so its output lands rays-minor."""
    if skybox is None:
        return jnp.broadcast_to(bg_color[:, None], (3, dir3.shape[1]))
    h = int(skybox.shape[1])
    w = int(skybox.shape[2])
    face, i, j = _face_ij(dir3[0], dir3[1], dir3[2], h, w)
    return jnp.moveaxis(skybox, 3, 0)[:, face, i, j]

"""Sobel edge mask for adaptive SSAA (Scene::launchSSAA,
src/scene.cpp:547-569), as a dense stencil over the framebuffer.

The reference convolves the RGB framebuffer with the 3x3 Sobel operator
in both orientations, takes val = sqrt(|gx|^2 + |gy|^2) where |.| is the
RGB vector length, and marks pixels with val > 0.5. Border pixels
(row/col 0 and H-1/W-1) are never written by the reference (its loop
runs over the interior only; the buffer is heap garbage there) — we
define them as False, the common zero-initialized-page outcome.

Frames are channel-first (3, H, W), the layout the render produces:
the large (H, W) axes stay minor.
"""

from __future__ import annotations

import jax.numpy as jnp

_S = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_mask(frame3: jnp.ndarray, threshold: float = 0.5) -> jnp.ndarray:
    """frame3: (3, H, W) -> bool (H, W); borders False."""
    h, w = frame3.shape[1:]
    if h < 3 or w < 3:
        # No interior pixels: the reference's interior-only loop does
        # no work (scene.cpp:556); a (h-2, w-2) stencil would go
        # negative-dimension here.
        return jnp.zeros((h, w), bool)
    gx = jnp.zeros((3, h - 2, w - 2), frame3.dtype)
    gy = jnp.zeros((3, h - 2, w - 2), frame3.dtype)
    # x += fb[i-1+a, j-1+b] * S[a][b]; y += fb[...] * S[b][a]
    # (scene.cpp:558-562). Unrolled 3x3 stencil — XLA fuses this into a
    # single vectorized pass.
    for a in range(3):
        for b in range(3):
            patch = frame3[:, a : h - 2 + a, b : w - 2 + b]
            gx = gx + patch * _S[a][b]
            gy = gy + patch * _S[b][a]
    # val = sqrtf(powf(x.length(), 2) + powf(y.length(), 2))
    # (scene.cpp:564): each length() is a rounded sqrtf of the
    # left-to-right sum x*x + y*y + z*z (geometry.h:94-102), then
    # RE-SQUARED (powf(.,2) == the correctly-rounded f32 product).
    # The sqrt->square round-trip and the explicit sum associativity
    # matter: a direct sqrt(sum+sum) can differ by ulps and flip the
    # strict > 0.5 mask for pixels at the threshold.
    def _len(g):
        return jnp.sqrt((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2])

    lx, ly = _len(gx), _len(gy)
    val = jnp.sqrt(lx * lx + ly * ly)
    mask = val > threshold
    return jnp.pad(mask, 1, constant_values=False)

"""Shading math — reflect/refract/fresnel with the reference's exact
float semantics (Render::{reflect,refract,fresnel},
src/scene.cpp:672-722), batched over rays.
"""

from __future__ import annotations

import jax.numpy as jnp

from rendering_jax.ops.geometry import clamp, dot, dot_r


def reflect(direction, normal):
    """dir - 2*dot(dir, n)*n (scene.cpp:672-675)."""
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


# ---- Row ("(3, B)") variants — same formulas as the (..., 3)
# functions above; see ops.geometry row-helper rationale (u8 output
# frames identical; float values may differ a few ulp via fusion).


def reflect_r(d3, n3):
    return d3 - 2.0 * dot_r(d3, n3)[None] * n3


def refract_r(d3, n3, ior):
    """refract on rows. d3/n3: (3, B); ior: (B,). Returns (3, B)."""
    cosi = clamp(-1.0, 1.0, dot_r(d3, n3))
    outside = cosi < 0
    n1 = jnp.where(outside, 1.0, ior)
    n2 = jnp.where(outside, ior, 1.0)
    cosi_abs = jnp.abs(cosi)
    mod_normal = jnp.where(outside[None], n3, -n3)
    rri = n1 / n2
    k = 1.0 - rri * rri * (1.0 - cosi_abs * cosi_abs)
    tir = k < 0  # the reference's TIR test (k == 0 refracts, scene.cpp:693)
    # double-where: at the exact critical angle k == 0 the lane is LIVE
    # and sqrt'(0) = inf would poison reverse mode; keep the primal
    # sqrt(0) = 0 but route the gradient through a guarded operand.
    crit = k <= 0
    sqrt_k = jnp.where(crit, 0.0, jnp.sqrt(jnp.where(crit, 1.0, k)))
    out = (
        rri[None] * d3
        + (rri * cosi_abs - sqrt_k)[None] * mod_normal
    )
    return jnp.where(tir[None], 0.0, out)


def fresnel_r(d3, n3, ior):
    """fresnel on rows. d3/n3: (3, B); ior: (B,). Returns kr (B,)."""
    cosi = clamp(-1.0, 1.0, dot_r(d3, n3))
    outside_medium = cosi > 0
    n1 = jnp.where(outside_medium, ior, 1.0)
    n2 = jnp.where(outside_medium, 1.0, ior)
    sin2 = jnp.maximum(0.0, 1.0 - cosi * cosi)
    head_on = sin2 <= 0.0
    sint = n1 / n2 * jnp.where(
        head_on, 0.0, jnp.sqrt(jnp.where(head_on, 1.0, sin2))
    )
    tir = sint >= 1.0
    cost = jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(0.0, 1.0 - sint * sint)))
    cosi_a = jnp.abs(cosi)
    rs = ((n2 * cosi_a) - (n1 * cost)) / ((n2 * cosi_a) + (n1 * cost))
    rp = ((n1 * cosi_a) - (n2 * cost)) / ((n1 * cosi_a) + (n2 * cost))
    kr = (rs * rs + rp * rp) / 2.0
    return jnp.where(tir, 1.0, kr)


def refract(direction, normal, ior):
    """Snell refraction with TIR -> zero vector (scene.cpp:677-696).
    direction/normal: (..., 3); ior: (...,). Returns (..., 3)."""
    cosi = clamp(-1.0, 1.0, dot(direction, normal))
    outside = cosi < 0
    n1 = jnp.where(outside, 1.0, ior)
    n2 = jnp.where(outside, ior, 1.0)
    cosi_abs = jnp.abs(cosi)  # cosi = -cosi when outside; already >=0 inside
    mod_normal = jnp.where(outside[..., None], normal, -normal)
    rri = n1 / n2
    k = 1.0 - rri * rri * (1.0 - cosi_abs * cosi_abs)
    tir = k < 0  # the reference's TIR test (k == 0 refracts, scene.cpp:693)
    # double-where: k == 0 (exact critical angle) is a LIVE lane whose
    # sqrt'(0) = inf would poison reverse mode; keep the primal but
    # suppress the gradient through the guarded operand.
    crit = k <= 0
    sqrt_k = jnp.where(crit, 0.0, jnp.sqrt(jnp.where(crit, 1.0, k)))
    out = (
        rri[..., None] * direction
        + (rri * cosi_abs - sqrt_k)[..., None] * mod_normal
    )
    return jnp.where(tir[..., None], 0.0, out)


def fresnel(direction, normal, ior):
    """Exact Fresnel rs/rp average, kr (scene.cpp:698-722).
    Returns kr: (...,). TIR -> 1."""
    cosi = clamp(-1.0, 1.0, dot(direction, normal))
    outside_medium = cosi > 0  # note: fresnel's n1/n2 swap is on cosi > 0
    n1 = jnp.where(outside_medium, ior, 1.0)
    n2 = jnp.where(outside_medium, 1.0, ior)
    # double-where: at cosi == +-1 (head-on hits) sin^2 is exactly 0 and
    # sqrt'(0) = inf would poison reverse mode through the masked lanes.
    sin2 = jnp.maximum(0.0, 1.0 - cosi * cosi)
    head_on = sin2 <= 0.0
    sint = n1 / n2 * jnp.where(
        head_on, 0.0, jnp.sqrt(jnp.where(head_on, 1.0, sin2))
    )
    tir = sint >= 1.0
    cost = jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(0.0, 1.0 - sint * sint)))
    cosi_a = jnp.abs(cosi)
    rs = ((n2 * cosi_a) - (n1 * cost)) / ((n2 * cosi_a) + (n1 * cost))
    rp = ((n1 * cosi_a) - (n2 * cost)) / ((n1 * cosi_a) + (n2 * cost))
    kr = (rs * rs + rp * rp) / 2.0
    return jnp.where(tir, 1.0, kr)


def spec_pow(base, exponent):
    """pow(max(0, base), exponent) with NaN-safe reverse mode.

    jnp.power's exponent-gradient computes log(base), which is -inf at
    base == 0 (common: every unlit specular lane), poisoning grads of
    n_specular. Matches std::pow for base > 0, exponent > 0; base <= 0
    maps to 0 (the reference always feeds max(0, x) with exponent > 0).
    """
    pos = base > 0
    safe = jnp.where(pos, base, 1.0)
    return jnp.where(pos, jnp.exp(exponent * jnp.log(safe)), 0.0)

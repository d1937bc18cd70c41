"""Small vector helpers over SoA (..., 3) jnp arrays.

Replaces the reference's Vec3f/Matrix44f classes (include/geometry.h):
here a "Vec3" is just the last axis of a batched array and a "Ray" is
the pair (orig, dir) of (N, 3) arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

FLT_MAX = jnp.float32(3.4028234663852886e38)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


# ---- Row ("(3, B)") variants -------------------------------------------
# The integrator's bounce body keeps every per-ray 3-vector as a (3, B)
# array (components on the leading axis, the large ray axis minor), so
# elementwise work reads contiguous rays and no (B, 3) <-> (3, B)
# relayout sits in the bounce loop. These helpers use the exact same
# formulas as their (..., 3) counterparts above (left-to-right sums,
# identical cross/normalize sequences); the layout change does shift
# which ops XLA fuses/FMA-contracts, so float frames may differ by a
# few ulp (measured max 2.3e-4 across the golden scenes) — but the
# quantized u8 output frames are identical, which is the parity
# contract the golden suite asserts.


def dot_r(a, b):
    """a, b: (3, ...) -> (...,). Same adds as jnp.sum(a*b, -1)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def cross_r(a, b):
    """a, b: (3, ...) -> (3, ...). Component order of jnp.cross."""
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def normalize_r(a):
    """Vec3::normalize on rows; zero vectors unchanged (geometry.h)."""
    len2 = dot_r(a, a)[None]
    safe = jnp.where(len2 > 0, len2, 1.0)
    return jnp.where(len2 > 0, a * (1.0 / jnp.sqrt(safe)), a)


def cross(a, b):
    return jnp.cross(a, b)


def length2(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(length2(a))


def normalize(a):
    """Vec3::normalize semantics (geometry.h:104-112): zero vectors are
    left unchanged (guard len2 > 0), no epsilon."""
    len2 = length2(a)[..., None]
    safe = jnp.where(len2 > 0, len2, 1.0)
    return jnp.where(len2 > 0, a * (1.0 / jnp.sqrt(safe)), a)


def clamp(low, high, val):
    return jnp.maximum(low, jnp.minimum(high, val))


def pvary_like(tree, *refs):
    """Align a pytree's shard_map varying-axis types (vma) with the
    union of the reference arrays' vma. No-op outside shard_map. Needed
    for lax.scan/while_loop carries whose init values are unvarying
    constants (jnp.zeros etc.) while the loop body mixes in per-shard
    data."""
    import jax

    vma = set()
    for r in refs:
        try:
            vma |= set(jax.typeof(r).vma)
        except AttributeError:  # pragma: no cover
            pass
    if not vma:
        return tree

    def pv(x):
        have = set(getattr(jax.typeof(x), "vma", ()))
        missing = tuple(a for a in vma if a not in have)
        if not missing:
            return x
        pcast = getattr(jax.lax, "pcast", None)
        if pcast is not None:  # jax >= 0.9 name for pvary
            return pcast(x, missing, to="varying")  # axis_name accepts a tuple
        return jax.lax.pvary(x, missing)

    import jax.tree_util as jtu

    return jtu.tree_map(pv, tree)


def morton_key_r(p3):
    """Per-point 30-bit Morton (Z-curve) key, jnp/traced. p3: (3, N) ->
    (N,) uint32. Points are quantized to a 1024^3 grid over the batch's
    own bounds (stop_gradient — the key is discrete reordering metadata
    only). Used to sort bounce/shadow ray queues so the intersection
    kernel's ray tiles stay spatially coherent after reflection/
    refraction scatters them (an incoherent tile keeps far more chunks
    live in the kernel's pre-pass)."""
    import jax

    p3 = jax.lax.stop_gradient(p3)
    lo = jnp.min(p3, axis=1, keepdims=True)
    span = jnp.max(p3, axis=1, keepdims=True) - lo
    span = jnp.where(span > 0, span, 1.0)
    q = jnp.clip((p3 - lo) / span * 1023.0, 0.0, 1023.0).astype(jnp.uint32)

    def spread(x):
        x = (x | (x << 16)) & jnp.uint32(0x030000FF)
        x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
        x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
        x = (x | (x << 2)) & jnp.uint32(0x09249249)
        return x

    return spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2)


def euler_matrix_j(rot_deg):
    """Differentiable jnp twin of models.objloader.euler_matrix: 3x3
    rotation from Euler DEGREES (3,) in the reference's row-vector
    convention (apply as v @ R; mz*my*mx composition, scene.cpp:22-49).
    Use for gradients w.r.t. camera/object rotation angles — the
    numpy original is the f32-exact PARITY path baked at scene build;
    this one traces so jax.grad flows to the angles (agreement with
    the original is pinned to ~1 ulp by tests/test_grad.py)."""
    r = jnp.asarray(rot_deg, jnp.float32) * jnp.float32(jnp.pi / 180.0)
    cx, sx = jnp.cos(r[0]), jnp.sin(r[0])
    cy, sy = jnp.cos(r[1]), jnp.sin(r[1])
    cz, sz = jnp.cos(r[2]), jnp.sin(r[2])
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    mx = jnp.array([[one, zero, zero],
                    [zero, cx, -sx],
                    [zero, sx, cx]])
    my = jnp.array([[cy, zero, sy],
                    [zero, one, zero],
                    [-sy, zero, cy]])
    mz = jnp.array([[cz, -sz, zero],
                    [sz, cz, zero],
                    [zero, zero, one]])
    # Explicit f32 precision: a default-precision f32 matmul may run in
    # TF32 on a GPU, which keeps ~3 decimal digits.
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(mz, my, precision=hi), mx, precision=hi)

import math

import jax.numpy as jnp
import numpy as np

from rendering_jax.ops.shading import fresnel, reflect, refract


def test_reflect():
    d = jnp.array([[1.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(np.asarray(reflect(d, n))[0], [1, 1, 0], atol=1e-6)


def _ref_refract(d, n, ior):
    # direct transcription of scene.cpp:677-696 as numpy oracle
    n1, n2 = 1.0, ior
    cosi = float(np.clip(np.dot(d, n), -1, 1))
    mod_n = np.array(n, float)
    if cosi < 0:
        cosi = -cosi
    else:
        n1, n2 = n2, n1
        mod_n = -mod_n
    rri = n1 / n2
    k = 1 - rri * rri * (1 - cosi * cosi)
    if k < 0:
        return np.zeros(3)
    return rri * np.array(d) + (rri * cosi - math.sqrt(k)) * mod_n


def _ref_fresnel(d, n, ior):
    n1, n2 = 1.0, ior
    cosi = float(np.clip(np.dot(d, n), -1, 1))
    if cosi > 0:
        n1, n2 = n2, n1
    sint = n1 / n2 * math.sqrt(max(0.0, 1 - cosi * cosi))
    if sint >= 1:
        return 1.0
    cost = math.sqrt(max(0.0, 1 - sint * sint))
    cosi = abs(cosi)
    rs = ((n2 * cosi) - (n1 * cost)) / ((n2 * cosi) + (n1 * cost))
    rp = ((n1 * cosi) - (n2 * cost)) / ((n1 * cosi) + (n2 * cost))
    return (rs * rs + rp * rp) / 2


def test_refract_and_fresnel_against_oracle():
    cases = []
    for theta in (0.1, 0.7, 1.2, 1.5):
        d = np.array([math.sin(theta), -math.cos(theta), 0.0])
        cases.append((d, np.array([0.0, 1.0, 0.0]), 1.4))   # entering
        cases.append((-d, np.array([0.0, 1.0, 0.0]), 1.4))  # exiting
    for d, n, ior in cases:
        got_r = np.asarray(
            refract(jnp.array([d]), jnp.array([n]), jnp.array([ior]))
        )[0]
        np.testing.assert_allclose(got_r, _ref_refract(d, n, ior), atol=1e-6)
        got_f = float(fresnel(jnp.array([d]), jnp.array([n]), jnp.array([ior]))[0])
        np.testing.assert_allclose(got_f, _ref_fresnel(d, n, ior), atol=1e-6)


def test_total_internal_reflection():
    # exiting a dense medium at a grazing angle -> TIR
    theta = 1.4
    d = np.array([math.sin(theta), math.cos(theta), 0.0])  # going up, inside
    n = np.array([0.0, 1.0, 0.0])
    r = np.asarray(refract(jnp.array([d]), jnp.array([n]), jnp.array([1.8])))[0]
    np.testing.assert_allclose(r, 0.0)
    f = float(fresnel(jnp.array([d]), jnp.array([n]), jnp.array([1.8]))[0])
    assert f == 1.0


def test_compact_children_drops_smallest_weights():
    """Transparent-queue overflow keeps the Q LARGEST weights (the
    smallest-error drop policy), Morton-orders the kept set, and counts
    the drops."""
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.render.integrator import (
        _compact_children,
        _zero_stats,
    )

    q = 8
    rng = np.random.default_rng(3)
    ro = jnp.asarray(rng.uniform(-1, 1, (3, 2 * q)), jnp.float32)
    rd = jnp.asarray(rng.uniform(-1, 1, (3, 2 * q)), jnp.float32)
    # 12 active candidates (> capacity 8), distinct weights.
    w = jnp.asarray(
        [0.9, 0.05, 0.8, 0.0, 0.7, 0.3, 0.02, 0.6,
         0.5, 0.0, 0.4, 0.35, 0.0, 0.25, 0.15, 0.0],
        jnp.float32,
    )
    pix = jnp.arange(2 * q, dtype=jnp.int32)
    stats = _zero_stats()
    k_ro, k_rd, k_w, k_pix = _compact_children(
        ro, rd, w, pix, q, 0.01, stats
    )
    # Kept = the 8 largest of the 12 active weights, in SOME order.
    expect = sorted([0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.35, 0.3])
    np.testing.assert_allclose(sorted(np.asarray(k_w)), expect, atol=1e-6)
    assert float(stats["paths_dropped"]) == 4.0
    # Rays ride with their weights (pix identifies the candidate).
    for i, p in enumerate(np.asarray(k_pix)):
        np.testing.assert_array_equal(
            np.asarray(k_ro[:, i]), np.asarray(ro[:, p])
        )
        np.testing.assert_allclose(float(k_w[i]), float(w[p]), atol=1e-6)

    # No overflow: every active candidate survives, zero drops.
    stats2 = _zero_stats()
    w2 = jnp.where(w > 0.55, w, 0.0)
    _, _, k_w2, _ = _compact_children(ro, rd, w2, pix, q, 0.01, stats2)
    np.testing.assert_allclose(
        sorted(np.asarray(k_w2))[-4:], [0.6, 0.7, 0.8, 0.9], atol=1e-6
    )
    assert float(stats2["paths_dropped"]) == 0.0


def test_refract_critical_angle_gradient_finite():
    """k == 0 (exact critical angle) is a LIVE lane in the reference
    (its TIR test is k < 0, scene.cpp:693); sqrt'(0) = inf must not
    reach reverse mode. Finds an f32 ior that makes k land on exactly
    0.0 for a fixed ray, then checks grad(refract) is finite there."""
    import jax
    import jax.numpy as jnp

    from rendering_jax.ops.shading import refract

    d = np.array([0.8, 0.0, -0.6], np.float32)
    n = np.array([0.0, 0.0, 1.0], np.float32)
    cosi = np.float32(np.clip(np.dot(d, n), -1, 1))  # -0.6, outside
    iors = np.float32(0.795) + np.arange(200000, dtype=np.float32) * np.float32(5e-8)
    rri = np.float32(1.0) / iors
    k = np.float32(1.0) - rri * rri * (np.float32(1.0) - cosi * cosi)
    hits = iors[k == 0.0]
    if hits.size == 0:
        import pytest
        pytest.skip("no f32 ior lands k exactly on 0 for this ray")
    ior0 = jnp.float32(hits[0])

    def f(ior):
        return jnp.sum(refract(jnp.asarray(d), jnp.asarray(n), ior))

    g = jax.grad(f)(ior0)
    assert np.isfinite(float(g))
    # Primal parity: k == 0 refracts (no TIR zero-vector).
    out = refract(jnp.asarray(d), jnp.asarray(n), ior0)
    assert float(jnp.sum(jnp.abs(out))) > 0.0

"""Bilinear texture filtering (framework extension behind
RenderSettings.texture_filter; default "nearest" keeps reference
parity, pinned by the golden suite). Bilinear exists for inverse
rendering: nearest's UV-space gradient is zero almost everywhere,
bilinear's is the smooth texel blend."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.ops.texture import (
    sample_map_bilinear_r,
    sample_map_r,
    sample_packed_bilinear_r,
)


def _rand_map(w, h, c, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0, 1, (h * w, c)), jnp.float32)


def test_bilinear_matches_nearest_at_texel_centers():
    w, h = 7, 5
    fm = _rand_map(w, h, 3)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    tex2 = jnp.asarray(
        np.stack([(xs.ravel() + 0.5) / w, (ys.ravel() + 0.5) / h]),
        jnp.float32,
    )
    near = sample_map_r(fm, (w, h), tex2)
    bil = sample_map_bilinear_r(fm, (w, h), tex2)
    np.testing.assert_allclose(np.asarray(bil), np.asarray(near), atol=1e-6)


def test_bilinear_midpoint_blends():
    w, h = 4, 1
    fm = jnp.asarray([[0.0], [1.0], [0.2], [0.8]], jnp.float32)
    # halfway between texel 1 and texel 2 centers: (1.5+0.5)/4 = 0.5
    tex2 = jnp.asarray([[0.5], [0.5]], jnp.float32)
    v = float(sample_map_bilinear_r(fm, (w, h), tex2)[0, 0])
    np.testing.assert_allclose(v, 0.6, atol=1e-6)  # (1.0 + 0.2) / 2
    # edge clamp: sampling at u=0 stays inside
    tex_edge = jnp.asarray([[0.0], [0.5]], jnp.float32)
    v0 = float(sample_map_bilinear_r(fm, (w, h), tex_edge)[0, 0])
    np.testing.assert_allclose(v0, 0.0, atol=1e-6)


def test_bilinear_packed_matches_per_map():
    w, h = 6, 4
    fm = _rand_map(w, h, 7, seed=2)
    rng = np.random.default_rng(3)
    tex2 = jnp.asarray(rng.uniform(0, 1, (2, 33)), jnp.float32)
    a = sample_packed_bilinear_r(fm.T, (w, h), tex2)
    b = sample_map_bilinear_r(fm, (w, h), tex2)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_bilinear_uv_gradient_matches_fd():
    """The point of the feature: d(sample)/d(u) is the exact texel
    blend slope (nearest would give 0)."""
    w, h = 8, 8
    fm = _rand_map(w, h, 1, seed=4)

    def f(u):
        tex2 = jnp.stack([u[None], jnp.asarray([0.4], jnp.float32)])
        return sample_map_bilinear_r(fm, (w, h), tex2)[0, 0]

    u0 = jnp.float32(0.37)  # interior, away from texel boundaries
    g = float(jax.grad(f)(u0))
    eps = 1e-3
    fd = (float(f(u0 + eps)) - float(f(u0 - eps))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-3)
    assert abs(g) > 1e-3  # non-degenerate slope


def _textured_scene(texture_filter):
    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings

    scene = load_scene(
        "t03_cow_textured.scene",
        RenderSettings(texture_filter=texture_filter, enable_ssaa=False),
    )
    st = scene.static
    settings = st.settings.replace(width=64, height=48)
    return dataclasses.replace(
        scene, static=dataclasses.replace(st, settings=settings)
    )


@pytest.mark.slow
def test_render_bilinear_differs_and_is_finite(in_workspace):
    from rendering_jax.render.pipeline import render_scene

    f_near, _ = render_scene(_textured_scene("nearest"))
    f_bil, _ = render_scene(_textured_scene("bilinear"))
    f_near = np.asarray(f_near)
    f_bil = np.asarray(f_bil)
    assert np.isfinite(f_bil).all()
    assert np.abs(f_bil - f_near).max() > 1e-3  # filtering visibly differs
    # ... but only where the texture is sampled: background identical
    np.testing.assert_allclose(
        f_bil.mean(), f_near.mean(), rtol=0.05
    )


@pytest.mark.slow
def test_render_bilinear_texel_gradients_flow(in_workspace):
    from rendering_jax.diff.inverse import apply_params, extract_params
    from rendering_jax.render.pipeline import render_scene

    scene = _textured_scene("bilinear")
    paths = (("meshes", 0, "diffuse_map"),)
    params = extract_params(scene, paths)

    def loss(params):
        s = apply_params(scene, params, paths)
        frame, _ = render_scene(s)
        return jnp.mean(frame)

    g = np.asarray(jax.grad(loss)(params)["meshes/0/diffuse_map"])
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).sum() > 10  # many texels receive gradient


def test_invalid_filter_rejected():
    from rendering_jax.render.integrator import _samplers
    from rendering_jax.models.settings import RenderSettings

    with pytest.raises(ValueError, match="texture_filter"):
        _samplers(RenderSettings(texture_filter="trilinear"))

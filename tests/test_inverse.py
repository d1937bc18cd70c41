"""Inverse rendering end-to-end: gradient-descent recovery of perturbed
scene parameters against a target render (the north-star demo of the
differentiable redesign — SURVEY section 7 step 8; the reference is
forward-only and has no counterpart)."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from rendering_jax.diff.checkpoint import load_checkpoint, save_checkpoint
from rendering_jax.diff.inverse import (
    apply_params,
    extract_params,
    make_train_step,
)
from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
from rendering_jax.models.scene import build_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render_scene


def _scene(intensity=0.6, color=(1.0, 0.3, 0.2)):
    st = RenderSettings(
        width=20, height=16, enable_ssaa=False, enable_output=False,
        output_progress=False, background_color=(0.15, 0.15, 0.2),
    )
    sd = SceneDef(settings=st)
    sd.lights = [
        LightDef("distant", color=(1, 1, 1), intensity=intensity,
                 dir=(0.2, -0.4, -1.0)),
    ]
    sd.objects = [
        ObjectDef("plane", pos=(0, -1.2, 0), normal=(0, 1, 0),
                  color=(0.8, 0.8, 0.8)),
        ObjectDef("sphere", pos=(0, 0, -3), radius=0.9, color=color),
    ]
    return build_scene(sd)


def test_recover_light_and_color():
    """Start from wrong light intensity + sphere color; adam on the
    pixel MSE must recover both (loss drops >100x, params approach the
    target values)."""
    import optax

    target_scene = _scene(intensity=0.6, color=(1.0, 0.3, 0.2))
    target, _ = render_scene(target_scene)

    start = _scene(intensity=0.25, color=(0.4, 0.7, 0.6))
    paths = (("lights", 0, "intensity"), ("obj_color",))
    params = extract_params(start, paths)

    init_fn, step_fn = make_train_step(paths, optimizer=optax.adam(5e-2))
    opt_state = init_fn(params)
    losses = []
    for _ in range(120):
        params, opt_state, loss = step_fn(params, opt_state, start, target)
        losses.append(float(loss))

    assert losses[-1] < losses[0] * 1e-3, (losses[0], losses[-1])
    # intensity and albedo are only identifiable as a product from a
    # diffuse image (classic scale ambiguity): assert the product.
    rec_i = float(params["lights/0/intensity"])
    rec_color = np.asarray(params["obj_color"])[1]
    np.testing.assert_allclose(
        rec_i * rec_color, 0.6 * np.array([1.0, 0.3, 0.2]), atol=0.02
    )


def test_checkpoint_roundtrip_with_opt_state(tmp_path):
    import optax

    scene = _scene()
    paths = (("lights", 0, "intensity"),)
    params = extract_params(scene, paths)
    init_fn, step_fn = make_train_step(paths, optimizer=optax.adam(1e-2))
    opt_state = init_fn(params)
    target, _ = render_scene(_scene(intensity=0.9))
    params, opt_state, _ = step_fn(params, opt_state, scene, target)

    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, 7, params, opt_state)
    step, p2, o2, frame, mask = load_checkpoint(path, params, opt_state)
    assert step == 7 and frame is None and mask is None
    np.testing.assert_allclose(
        np.asarray(p2["lights/0/intensity"]),
        np.asarray(params["lights/0/intensity"]),
    )
    # resumed step must run with the restored optimizer state
    p3, o3, loss = step_fn(p2, o2, scene, target)
    assert np.isfinite(float(loss))


def test_recover_texture_with_bilinear(monkeypatch):
    """Texture inverse rendering: recover a diffuse map from a target
    render. Needs texture_filter="bilinear" — with nearest filtering
    each sampled texel gets gradient but the UV-space landscape is
    piecewise constant; bilinear spreads gradient over the 4 blended
    texels, so adam converges on every texel the camera actually sees."""
    import optax

    from rendering_jax.flagship import procedural_mesh

    def scene_with_map(tex):
        st = RenderSettings(
            width=32, height=24, enable_ssaa=False, enable_output=False,
            output_progress=False, background_color=(0.1, 0.1, 0.12),
            texture_filter="bilinear",
        )
        sd = SceneDef(settings=st)
        sd.lights = [
            LightDef("distant", color=(1, 1, 1), intensity=0.8,
                     dir=(0.0, -0.3, -1.0)),
        ]
        obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2.5, 2.5, 2.5),
                        color=(1, 1, 1))
        obj.mesh = procedural_mesh(200, pos=(0, 0, -3), size=(2.5, 2.5, 2.5))
        obj.diffuse_map = tex
        obj.diffuse_map_wh = (8, 8)
        sd.objects = [obj]
        return build_scene(sd)

    rng = np.random.default_rng(5)
    true_tex = rng.uniform(0.1, 0.9, (64, 3)).astype(np.float32)
    target, _ = render_scene(scene_with_map(true_tex))

    start = scene_with_map(np.full((64, 3), 0.5, np.float32))
    paths = (("meshes", 0, "diffuse_map"),)
    params = extract_params(start, paths)

    init_fn, step_fn = make_train_step(paths, optimizer=optax.adam(3e-2))
    opt_state = init_fn(params)
    losses = []
    for _ in range(150):
        params, opt_state, loss = step_fn(params, opt_state, start, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 1e-2, (losses[0], losses[-1])

    # Texels the optimization moved (seen by the camera) must move
    # TOWARD the true texture: mean error vs truth drops well below the
    # 0.5-gray init error. (Exact per-texel recovery needs many more
    # steps for small-footprint texels — this asserts convergence
    # direction and magnitude, not the fixed point.)
    rec = np.asarray(params["meshes/0/diffuse_map"])
    moved = np.abs(rec - 0.5).sum(axis=1) > 0.05
    assert moved.sum() >= 8, moved.sum()
    err_init = np.abs(0.5 - true_tex[moved]).mean()
    err_rec = np.abs(rec[moved] - true_tex[moved]).mean()
    assert err_rec < 0.5 * err_init, (err_rec, err_init)


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    """A checkpoint restored into a template with the same leaf count
    but different structure (renamed param keys across code versions)
    must raise instead of silently assigning leaves to the wrong
    parameters."""
    import numpy as np
    import pytest

    from rendering_jax.diff.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, 3, {"x": np.ones(2)}, {})
    # Same structure restores fine.
    step, params, _, _, _ = load_checkpoint(path, {"x": np.zeros(2)}, {})
    assert step == 3 and float(params["x"][0]) == 1.0
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(path, {"y": np.zeros(2)}, {})

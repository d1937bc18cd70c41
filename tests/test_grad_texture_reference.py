"""Texture-texel and background-color gradients vs the COMPILED C++
REFERENCE (SURVEY section 4.3; extends test_grad_reference.py to map
texels).

A diffuse-map BMP is perturbed by a u8 step on a texel block, the
patched SSAA-off reference re-renders, and the finite difference of
mean(u8)/255 is compared against the DIRECTIONAL derivative
sum(grad(diffuse_map) * delta) of our loss — gradients through the
nearest-neighbor texel gather (objects.cpp:153-163) with the hit
topology fixed. Background color gets the same treatment through the
miss path (scene.cpp:383-385).

The delta is computed by round-tripping both perturbed BMPs through
the parser's own loader, so quantization, the /256 decode, and the
loadBMP row layout cancel exactly; the perturbation block is large
(half the map, +-24 u8 steps) so the signal dominates the truncating
u8 writer's ~0.3/255/sqrt(3HW) frame-mean noise.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# Builds and runs the C++ reference binary per FD probe — CI-slow.
pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

MAP_W, MAP_H = 64, 64  # width multiple of 4: no BMP row padding shear

SCENE_TMPL = """[options]
width=160
height=120
background_color={bg0},{bg1},{bg2}
image_name=golden/fdtex
enableOutput=0
outputProgress=0

[light]
type=distant
direction=0.2,-1,-0.3
color=1,1,1
intensity=0.8

[light]
type=point
position=0,1,-1
color=1,1,0.9
intensity=0.5

[object]
type=mesh
pos=0,-0.2,-3.2
size=2.2,2.2,2.2
rot=0,30,0
color=1,1,1
name=input/objects/cow.obj
diffuse_map=input/maps/fdtex_diffuse.bmp

[end]
"""

BASE_BG = (0.35, 0.45, 0.55)


def _base_map_u8() -> np.ndarray:
    """Non-uniform base map (top-down (H, W, 3) u8), mid-range so the
    +-24 u8 perturbation never clips."""
    y, x = np.mgrid[0:MAP_H, 0:MAP_W]
    img = np.stack(
        [
            80 + (80 * x) // MAP_W,
            np.full_like(x, 120),
            100 + (60 * y) // MAP_H,
        ],
        axis=-1,
    )
    return img.astype(np.uint8)


def _perturbed_map_u8(delta: int) -> np.ndarray:
    """Green channel of the left half shifted by delta u8 steps."""
    img = _base_map_u8().astype(np.int16)
    img[:, : MAP_W // 2, 1] += delta
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_map(ws: str, u8_img: np.ndarray) -> None:
    from rendering_jax.utils.bmp import save_bmp

    save_bmp(os.path.join(ws, "input", "maps", "fdtex_diffuse.bmp"), u8_img)


def _write_scene(ws: str, bg) -> str:
    path = os.path.join(ws, "fdtex.scene")
    with open(path, "w") as f:
        f.write(SCENE_TMPL.format(bg0=bg[0], bg1=bg[1], bg2=bg[2]))
    os.makedirs(os.path.join(ws, "golden"), exist_ok=True)
    return path


def _ref_mean(ws: str, binary: str) -> float:
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    subprocess.run(
        [binary, "fdtex.scene"], cwd=ws, check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    img = bmp_to_image(load_bmp(os.path.join(ws, "golden", "fdtex.bmp")))
    return float(img.astype(np.float64).mean()) / 255.0


def _load_scene(ws: str):
    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings

    old = os.getcwd()
    os.chdir(ws)
    try:
        return load_scene("fdtex.scene", RenderSettings(enable_ssaa=False))
    finally:
        os.chdir(old)


def _loaded_map(ws: str, u8_img: np.ndarray) -> np.ndarray:
    """Round-trip a map image through the parser's loader to get the
    exact (H*W, 3) float texel array our renderer would see."""
    from rendering_jax.models.parser import _load_map

    _write_map(ws, u8_img)
    flat, wh = _load_map(os.path.join(ws, "input", "maps",
                                      "fdtex_diffuse.bmp"))
    assert wh == (MAP_W, MAP_H)
    return np.asarray(flat)


@pytest.mark.golden
def test_texture_and_background_grads_match_reference_fd(workspace):
    from gen_goldens import build_reference

    binary = build_reference(ssaa=False)
    ws = str(workspace)

    # --- our gradients at the base point -------------------------------
    _write_map(ws, _base_map_u8())
    _write_scene(ws, BASE_BG)
    scene = _load_scene(ws)

    from rendering_jax.render.pipeline import render_scene

    def loss_fn(dmap, bg):
        import dataclasses

        m = dataclasses.replace(scene.meshes[0], diffuse_map=dmap)
        s = dataclasses.replace(scene, meshes=(m,), bg_color=bg)
        frame, _ = render_scene(s)
        return jnp.mean(jnp.clip(frame, 0.0, 1.0))

    g_map, g_bg = jax.grad(loss_fn, argnums=(0, 1))(
        scene.meshes[0].diffuse_map, scene.bg_color
    )
    g_map = np.asarray(g_map, np.float64)
    g_bg = np.asarray(g_bg, np.float64)

    # --- texture-texel FD ----------------------------------------------
    delta = 24
    plus_flat = _loaded_map(ws, _perturbed_map_u8(delta))
    minus_flat = _loaded_map(ws, _perturbed_map_u8(-delta))
    d_flat = (plus_flat.astype(np.float64) - minus_flat) / 2.0
    g_dot = float((g_map * d_flat).sum())

    _write_map(ws, _perturbed_map_u8(delta))
    up = _ref_mean(ws, binary)
    _write_map(ws, _perturbed_map_u8(-delta))
    dn = _ref_mean(ws, binary)
    fd = (up - dn) / 2.0
    assert fd > 1e-5 and g_dot > 1e-5, (fd, g_dot)
    np.testing.assert_allclose(g_dot, fd, rtol=0.10)

    # --- background-color FD (miss path) -------------------------------
    _write_map(ws, _base_map_u8())
    eps = 0.06
    _write_scene(ws, tuple(b + eps for b in BASE_BG))
    up = _ref_mean(ws, binary)
    _write_scene(ws, tuple(b - eps for b in BASE_BG))
    dn = _ref_mean(ws, binary)
    fd_bg = (up - dn) / (2 * eps)
    g_bg_dir = float(g_bg.sum())  # all three channels perturbed together
    assert fd_bg > 1e-3 and g_bg_dir > 1e-3, (fd_bg, g_bg_dir)
    np.testing.assert_allclose(g_bg_dir, fd_bg, rtol=0.08)


SKY_W = SKY_H = 64

SKY_SCENE_TMPL = """[options]
width=160
height=120
image_name=golden/fdsky
enableOutput=0
outputProgress=0
skyboxes=input/maps/sb0.bmp,input/maps/sb1.bmp,input/maps/sb2.bmp,input/maps/sb3.bmp,input/maps/sb4.bmp,input/maps/sb5.bmp

[light]
type=distant
direction=0,-1,-0.3
color=1,1,1
intensity=0.6

[object]
type=sphere
pos=0,0,-3
radius=0.8
color=0.8,0.5,0.4

[end]
"""


def _sky_base_u8(face: int) -> np.ndarray:
    """Distinct non-uniform mid-range image per face."""
    y, x = np.mgrid[0:SKY_H, 0:SKY_W]
    img = np.stack(
        [
            60 + 10 * face + (70 * x) // SKY_W,
            np.full_like(x, 110 + 5 * face),
            90 + (70 * y) // SKY_H,
        ],
        axis=-1,
    )
    return img.astype(np.uint8)


def _sky_perturbed_u8(delta: int) -> np.ndarray:
    """FRONT face (index 1, z<0 — the camera looks down -z so it
    dominates the miss pixels): red channel of the right half shifted."""
    img = _sky_base_u8(1).astype(np.int16)
    img[:, SKY_W // 2 :, 0] += delta
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_sky(ws: str, front_u8: np.ndarray) -> None:
    from rendering_jax.utils.bmp import save_bmp

    for i in range(6):
        img = front_u8 if i == 1 else _sky_base_u8(i)
        save_bmp(os.path.join(ws, "input", "maps", f"sb{i}.bmp"), img)


def _loaded_face(ws: str, u8_img: np.ndarray) -> np.ndarray:
    """Round-trip the front face through the parser's skybox decoder
    (load_bmp_float: /256, loadBMP row order) so quantization and
    layout cancel in the delta."""
    from rendering_jax.utils.bmp import load_bmp_float, save_bmp

    p = os.path.join(ws, "input", "maps", "sb1.bmp")
    save_bmp(p, u8_img)
    return np.asarray(load_bmp_float(p))


@pytest.mark.golden
def test_skybox_texel_grads_match_reference_fd(workspace):
    """Skybox texel gradients vs the reference binary's FD: perturb the
    front face's texels, re-render the SSAA-off reference, compare the
    frame-mean FD against the directional derivative
    sum(grad(scene.skybox)[1] * delta) — gradients through the miss
    path's nearest-texel face gather (scene.cpp:381-442) with hit
    topology fixed. Closes the last FD-vs-binary gradient surface
    (lights/colors/vertices/texels/background are covered above and in
    the sibling tests)."""
    import dataclasses

    from gen_goldens import build_reference

    binary = build_reference(ssaa=False)
    ws = str(workspace)

    _write_sky(ws, _sky_base_u8(1))
    path = os.path.join(ws, "fdsky.scene")
    with open(path, "w") as f:
        f.write(SKY_SCENE_TMPL)
    os.makedirs(os.path.join(ws, "golden"), exist_ok=True)

    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.render.pipeline import render_scene

    old = os.getcwd()
    os.chdir(ws)
    try:
        scene = load_scene("fdsky.scene", RenderSettings(enable_ssaa=False))
    finally:
        os.chdir(old)
    assert scene.static.settings.use_skybox and scene.skybox is not None

    def loss_fn(sky):
        s = dataclasses.replace(scene, skybox=sky)
        frame, _ = render_scene(s)
        return jnp.mean(jnp.clip(frame, 0.0, 1.0))

    g_sky = np.asarray(jax.grad(loss_fn)(scene.skybox), np.float64)

    delta = 24
    plus = _loaded_face(ws, _sky_perturbed_u8(delta))
    minus = _loaded_face(ws, _sky_perturbed_u8(-delta))
    d_face = (plus.astype(np.float64) - minus) / 2.0
    g_dot = float((g_sky[1] * d_face).sum())

    def ref_mean_sky(front_u8):
        from rendering_jax.utils.bmp import bmp_to_image, load_bmp

        _write_sky(ws, front_u8)
        subprocess.run(
            [binary, "fdsky.scene"], cwd=ws, check=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        img = bmp_to_image(load_bmp(os.path.join(ws, "golden", "fdsky.bmp")))
        return float(img.astype(np.float64).mean()) / 255.0

    up = ref_mean_sky(_sky_perturbed_u8(delta))
    dn = ref_mean_sky(_sky_perturbed_u8(-delta))
    fd = (up - dn) / 2.0
    assert fd > 1e-5 and g_dot > 1e-5, (fd, g_dot)
    np.testing.assert_allclose(g_dot, fd, rtol=0.10)

"""Camera-parameter gradient check against the COMPILED C++ REFERENCE
(closes the FD matrix over the scene-file
parameter space: lights, colors, vertices, texels, skybox, background,
and now camera pose).

jax.grad w.r.t. the camera POSITION (scene leaf cam_pos) and the
camera ROTATION euler angles (cam_rmat rebuilt in-graph by
ops.geometry.euler_matrix_j) is compared against central finite
differences of the reference binary's u8 output w.r.t. the scene-file
`position=` / `rotation=` keys (src/scene.cpp:146-197).

Making camera FD valid needs the same care as the vertex test: camera
motion slides silhouettes, and our gradients treat hit topology as
locally constant (stop_gradient). The scene is therefore an INFINITE
plane filling the whole frame (camera pitched 50 degrees down, horizon
off-screen for every probe): coverage is constant under all probes, no
boundary terms exist, and per-pixel radiance varies smoothly through
the point light's distance falloff and N.L (both differentiably
re-evaluated from the hit point). The light sits at x=0.8 so lateral
motion has signal too; intensity=0.05 keeps the /1000 falloff
(lights.cpp:35) off its min(1, .) clamp everywhere in frame.
"""

from __future__ import annotations

import dataclasses
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

SCENE_TMPL = """[options]
width=200
height=150
background_color=1,0,1
image_name=golden/fdcam
enableOutput=0
outputProgress=0
position={px},{py},{pz}
rotation={rx},0,0

[light]
type=point
position=0.8,1,-3
color=1,0.95,0.9
intensity=0.05

[object]
type=plane
pos=0,-2,0
normal=0,1,0
color=0.7,0.75,0.8

[end]
"""

BASE = {"px": 0.0, "py": 0.0, "pz": 0.0, "rx": 50.0}


def _ref_mean(ws, binary, **params):
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    with open(os.path.join(ws, "fdcam.scene"), "w") as f:
        f.write(SCENE_TMPL.format(**params))
    os.makedirs(os.path.join(ws, "golden"), exist_ok=True)
    subprocess.run(
        [binary, "fdcam.scene"], cwd=ws, check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    img = bmp_to_image(load_bmp(os.path.join(ws, "golden", "fdcam.bmp")))
    # Guard: the magenta background must never be visible — a probe
    # that slid the horizon into frame would add a coverage
    # discontinuity our gradients cannot represent.
    assert not ((img[..., 0] > 200) & (img[..., 1] < 40)
                & (img[..., 2] > 200)).any(), "background entered frame"
    return float(img.astype(np.float64).mean()) / 255.0


@pytest.mark.golden
def test_camera_grads_match_reference_fd(workspace):
    from gen_goldens import build_reference

    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.ops.geometry import euler_matrix_j
    from rendering_jax.render.pipeline import render_scene

    binary = build_reference(ssaa=False)
    ws = str(workspace)

    with open(os.path.join(ws, "fdcam.scene"), "w") as f:
        f.write(SCENE_TMPL.format(**BASE))
    old = os.getcwd()
    os.chdir(ws)
    try:
        scene = load_scene("fdcam.scene", RenderSettings(enable_ssaa=False))
    finally:
        os.chdir(old)

    # --- our analytic gradients ---
    def loss_pos(cam_pos):
        s = dataclasses.replace(scene, cam_pos=cam_pos)
        frame, _ = render_scene(s)
        return jnp.mean(jnp.clip(frame, 0.0, 1.0))

    g_pos = np.asarray(jax.grad(loss_pos)(scene.cam_pos))  # (3,)

    def loss_rot(angles_deg):
        s = dataclasses.replace(scene, cam_rmat=euler_matrix_j(angles_deg))
        frame, _ = render_scene(s)
        return jnp.mean(jnp.clip(frame, 0.0, 1.0))

    g_rot = np.asarray(
        jax.grad(loss_rot)(jnp.asarray([BASE["rx"], 0.0, 0.0],
                                       jnp.float32))
    )  # d loss / d euler DEGREES

    # --- reference central FD per parameter ---
    eps = 0.05
    fd = {}
    for key in ("px", "pz"):
        up = _ref_mean(ws, binary, **{**BASE, key: BASE[key] + eps})
        dn = _ref_mean(ws, binary, **{**BASE, key: BASE[key] - eps})
        fd[key] = (up - dn) / (2 * eps)
    eps_r = 1.0
    up = _ref_mean(ws, binary, **{**BASE, "rx": BASE["rx"] + eps_r})
    dn = _ref_mean(ws, binary, **{**BASE, "rx": BASE["rx"] - eps_r})
    fd["rx"] = (up - dn) / (2 * eps_r)

    # Signal must dominate the ~4e-6 u8 quantization noise floor.
    assert abs(fd["px"]) > 1e-3 and abs(fd["pz"]) > 1e-3, fd
    assert abs(fd["rx"]) > 1e-4, fd
    np.testing.assert_allclose(g_pos[0], fd["px"], rtol=0.08)
    np.testing.assert_allclose(g_pos[2], fd["pz"], rtol=0.08)
    np.testing.assert_allclose(g_rot[0], fd["rx"], rtol=0.08)

"""Vertex-position gradient check against the COMPILED C++ REFERENCE
(SURVEY §4.3; extends test_grad_reference.py to mesh geometry).

jax.grad w.r.t. mesh vertex positions is compared against central
finite differences of the reference binary's u8 output w.r.t. an OBJ
rewrite. Making the FD valid for geometry needs care:

* The loader's normalize-on-first-face transform (objects.cpp:282-331)
  maps OBJ coords through `norm_size * ((v - vmin)/rng - 0.5)`, so a
  perturbation that touches a bbox-extreme vertex changes EVERY
  vertex. The test perturbs only vertices strictly inside the bbox on
  the perturbed axis, leaving the affine map fixed; the OBJ->world
  chain rule is then the constant `norm_size_z / rng_z`.
* Pixel-space vertex gradients are only FD-checkable where radiance is
  continuous in the perturbation: the mesh is a heightfield grid whose
  OUTER silhouette vertices stay fixed (no boundary terms), viewed and
  lit nearly along the height axis (no self-occlusion or self-shadow
  flips), with explicit `vn` normals (both sides treat shading normals
  as independent of the perturbed positions).
* The interior shading signal comes from a point light's distance
  falloff + direction (scene.cpp:793-806): both vary smoothly with the
  hit point, which our forward differentiably re-evaluates from the
  gathered triangle vertices (render.integrator.trace_closest).
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

N = 6             # grid cells per side -> (N+1)^2 vertices, 2*N^2 tris
Z_INTERIOR = 0.2  # base height of perturbed interior vertices
Z_CENTER = 0.5    # fixed spike pinning the bbox z-max

SCENE_TMPL = """[options]
width=200
height=150
background_color=0.1,0.12,0.2
image_name=golden/fdmesh
enableOutput=0
outputProgress=0

[light]
type=point
position=0,0,-1
color=1,0.95,0.9
intensity=0.08

[object]
type=mesh
pos=0,0,-4
size=3,3,1
rot=0,0,0
color=0.8,0.7,0.6
name=input/fdmesh.obj

[end]
"""


def _grid_geometry():
    """Vertex heights + face list of the heightfield OBJ (load order =
    emit order, so (triangle, corner) -> vertex index is explicit)."""
    idx = lambda i, j: i * (N + 1) + j
    z = np.zeros(((N + 1) * (N + 1),), np.float64)
    perturbed = []
    for i in range(1, N):
        for j in range(1, N):
            if (i, j) == (N // 2, N // 2):
                z[idx(i, j)] = Z_CENTER
            else:
                z[idx(i, j)] = Z_INTERIOR
                perturbed.append(idx(i, j))
    faces = []
    for i in range(N):
        for j in range(N):
            a, b = idx(i, j), idx(i + 1, j)
            c, d = idx(i + 1, j + 1), idx(i, j + 1)
            # CCW viewed from +z -> front faces survive backface culling
            faces.append((a, b, c))
            faces.append((a, c, d))
    return z, faces, perturbed


def _write_obj(path, z):
    lines = []
    for i in range(N + 1):
        for j in range(N + 1):
            lines.append(f"v {float(i)} {float(j)} {z[i * (N + 1) + j]:.9f}")
    lines.append("vn 0 0 1")
    _, faces, _ = _grid_geometry()
    for a, b, c in faces:
        lines.append(f"f {a + 1}//1 {b + 1}//1 {c + 1}//1")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _ref_mean(ws, binary, z):
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    # ws/input is a REAL directory owned by the fixture; ws/input/objects
    # is a symlink into the read-only reference tree, so the generated
    # OBJ must NOT go there (writing through the symlink would pollute
    # the reference tree).
    _write_obj(os.path.join(ws, "input", "fdmesh.obj"), z)
    with open(os.path.join(ws, "fdmesh.scene"), "w") as f:
        f.write(SCENE_TMPL)
    os.makedirs(os.path.join(ws, "golden"), exist_ok=True)
    subprocess.run(
        [binary, "fdmesh.scene"], cwd=ws, check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    img = bmp_to_image(load_bmp(os.path.join(ws, "golden", "fdmesh.bmp")))
    return float(img.astype(np.float64).mean()) / 255.0


@pytest.mark.golden
def test_vertex_grad_matches_reference_fd(workspace):
    from gen_goldens import build_reference

    from rendering_jax.diff.inverse import apply_params, extract_params
    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.render.pipeline import render_scene

    binary = build_reference(ssaa=False)
    ws = str(workspace)
    z0, faces, perturbed = _grid_geometry()

    # --- our gradient w.r.t. the shared OBJ z of the perturbed set ---
    _write_obj(os.path.join(ws, "input", "fdmesh.obj"), z0)
    with open(os.path.join(ws, "fdmesh.scene"), "w") as f:
        f.write(SCENE_TMPL)
    old = os.getcwd()
    os.chdir(ws)
    try:
        # SSAA off on both sides (reference: enableSSAA=false build —
        # no scene key exists; ours: settings flag).
        scene = load_scene("fdmesh.scene", RenderSettings(enable_ssaa=False))
    finally:
        os.chdir(old)

    paths = (("meshes", 0, "v"),)
    params = extract_params(scene, paths)

    def loss_fn(params):
        s = apply_params(scene, params, paths)
        frame, _ = render_scene(s)
        return jnp.mean(jnp.clip(frame, 0.0, 1.0))

    gv = np.asarray(jax.grad(loss_fn)(params)["meshes/0/v"])  # (T, 3, 3)

    # Chain rule through normalize-on-first-face: the perturbed verts
    # are strictly interior in z, so d world_z / d obj_z is the fixed
    # affine scale norm_size_z / rng_z. rng = (N, N, Z_CENTER); the
    # min-stretch axis is x (size 3 / range 6), so norm_size_z =
    # 3 / (N / Z_CENTER).
    scale_z = (3.0 / (N / Z_CENTER)) / Z_CENTER  # = 3 / N
    pset = set(perturbed)
    # build_scene stores triangles Morton-permuted (stored row t = OBJ
    # face mp[t]), so gradient rows must be mapped back to emit-order
    # faces through the same permutation it computes (morton_order on
    # the loaded, pre-permutation vertices).
    from rendering_jax.accel.bvh import morton_order
    from rendering_jax.models.objloader import load_obj

    m_load = load_obj(
        os.path.join(ws, "input", "fdmesh.obj"),
        size=(3.0, 3.0, 1.0), rot=(0.0, 0.0, 0.0), pos=(0.0, 0.0, -4.0),
    )
    mp = np.asarray(morton_order(m_load.v))
    assert len(mp) == len(faces)
    g_obj = 0.0
    for t in range(len(faces)):
        a, b, c = faces[int(mp[t])]
        for corner, vid in enumerate((a, b, c)):
            if vid in pset:
                g_obj += float(gv[t, corner, 2])
    g_obj *= scale_z

    # --- reference central FD over the same joint perturbation ---
    eps = 0.05  # keeps z in (0, Z_CENTER): bbox and outer silhouette fixed
    zp = z0.copy()
    zm = z0.copy()
    for vid in perturbed:
        zp[vid] += eps
        zm[vid] -= eps
    up = _ref_mean(ws, binary, zp)
    dn = _ref_mean(ws, binary, zm)
    fd = (up - dn) / (2 * eps)

    # Guard against a degenerate setup (mesh off-screen, light clamped):
    # the signal must dominate the ~4e-6 u8 quantization noise floor.
    assert abs(fd) > 3e-5, fd
    np.testing.assert_allclose(g_obj, fd, rtol=0.10)

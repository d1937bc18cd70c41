"""Smoke test of the renderer on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py                # every phase below, one card
    python chip_smoke.py --four-cards   # the multi-card checks only

It drives the main paths once, through the entry points a user calls,
at the flagship size (a seeded 250,000-triangle mesh at 3840x1080) and
checks each against the repository's plain references:

  device   the card (nvidia-smi), JAX's device kind and versions, the
           compile-cache directory;
  gpu_tests  the tests marked `gpu` (tests/test_gpu_kernel.py: the
           compiled kernel vs the dense oracle at small sizes);
  parity   the compiled intersection kernel vs the lockstep BVH walk
           (traverse_bvh) over all primary rays of the flagship camera
           and a batch of shadow rays with limits, in closest and
           any-hit mode, and vs the dense ray_triangle oracle
           (bruteforce_mesh) on a 65,536-ray sample;
  goldens  rendering_jax.cli.main on the self-contained golden scenes
           (t01, t05) vs tests/goldens under the CI tolerance;
  cli      a seeded 250k-triangle OBJ and .scene at 3840x1080 rendered
           to BMP by cli.main, cold then warm;
  train    3 steps of diff.inverse.make_train_step on the flagship
           (lights, colors, vertices): the loss must stay finite;
  grads    the gradients of one make_train_step step at 3840x1080 on a
           lit scene where every compared leaf moves the loss, kernel
           vs plain oracle, for the 250k mesh and a 4,096-triangle one;
  timing   fwd+bwd and fwd-only steps with the kernel and with the
           plain XLA oracle, interleaved (kernel, plain, plain,
           kernel), for the 250k mesh (plain = traverse_bvh) and a
           seeded 4,096-triangle mesh (plain = bruteforce_mesh_mxu);
           peak device memory and the compiled step's memory analysis.

With --four-cards it runs, besides the device line, only the sharded
paths on 4 cards against 1 card: render_sharded, the sharded train
step's gradients and a 2x2 (rays x geometry) render_geo_sharded.

Each phase prints one `PHASE <name> {json}` line and raises on failure.
The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU (or outside a checkout) it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WS = os.path.join(REPO, ".smoke_ws")
W, H = 3840, 1080
N_TRIS = 250_000
SMALL_TRIS = 4096
# The 4-card train-step and geometry-sharding checks run at this size.
SHARD_WH = (960, 540)
# Parity tolerance: hits whose t differ by at most REL_T * t are ties
# (either triangle id is right), and an any-hit bit may differ where the
# occluder sits that close to the ray's limit. The compiled kernel may
# contract mul+add into FMA; the references may not. Shadow rays start
# on a surface, where t is near 0 and the rounding error of t is
# absolute (about 1e-7 of the coordinates), so their tolerance has a
# floor of REL_T scene units; primary rays have none.
REL_T = 1e-5
# Rays whose hit/miss may flip with the rounding of u, v at a shared
# edge (a crack in one oracle, a hit in the other), per comparison. Runs
# on the H100 have shown none; a wrong kernel disagrees on thousands.
MAX_EDGE_FLIPS = 4
DENSE_SAMPLE = 65536


_LAST = [time.perf_counter()]


def phase(name, **fields):
    """One result line per phase, with its wall-clock seconds."""
    now = time.perf_counter()
    fields["phase_s"] = now - _LAST[0]
    _LAST[0] = now
    print(f"PHASE {name} " + json.dumps(fields, default=float), flush=True)


def with_settings(scene, **kw):
    st = scene.static
    return dataclasses.replace(
        scene,
        static=dataclasses.replace(st, settings=st.settings.replace(**kw)),
    )


def card_line() -> str:
    # A child that stays off JAX: only this process opens the card.
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def run_device(cache_dir):
    import jax
    import jaxlib

    line = card_line()
    print(line, flush=True)
    phase("device", nvidia_smi=line, kind=jax.devices()[0].device_kind,
          count=len(jax.devices()), jax=jax.__version__,
          jaxlib=jaxlib.__version__, compile_cache=cache_dir)


def _tol(t, floor=0.0):
    import numpy as np

    return REL_T * np.maximum(np.abs(t), floor)


def _closest_mismatch(id_k, t_k, id_r, t_r, floor=0.0):
    """(id mismatches beyond ties, t mismatches among agreeing hits)."""
    import numpy as np

    tol = _tol(t_r, floor)
    both = (id_k >= 0) & (id_r >= 0)
    ok_id = (id_k == id_r) | (both & (np.abs(t_k - t_r) <= tol))
    bad_t = both & ok_id & (np.abs(t_k - t_r) > tol)
    return int((~ok_id).sum()), int(bad_t.sum())


def run_parity(flagship):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.ops.bruteforce import bruteforce_mesh
    from rendering_jax.ops.pallas_intersect import bruteforce_mesh_pallas
    from rendering_jax.ops.traversal import traverse_bvh
    from rendering_jax.render.raygen import primary_rays

    scene = flagship
    st = scene.static.settings
    mesh = scene.meshes[0]
    root_filter = st.use_ac and mesh.clipped_by_root
    ro, rd, _ = jax.jit(primary_rays)(scene)
    n = ro.shape[0]

    def kernel_fn(mode):
        return jax.jit(lambda ro, rd, t_limit: bruteforce_mesh_pallas(
            mesh, ro, rd, t_limit, tables=mesh.itables, mode=mode,
            use_root_filter=root_filter,
            backface_culling=st.use_backface_culling,
        )[:2])

    kernel, kernel_any = kernel_fn("closest"), kernel_fn("any")

    @jax.jit
    def walk(ro, rd, t_limit):
        r = traverse_bvh(mesh, ro, rd, t_limit,
                         backface_culling=st.use_backface_culling,
                         use_ac=st.use_ac)
        return r.t, r.tri

    @jax.jit
    def dense(ro, rd):
        return bruteforce_mesh(mesh, ro, rd,
                               backface_culling=st.use_backface_culling,
                               use_root_filter=root_filter)[:2]

    t0 = time.perf_counter()
    t_k, id_k = jax.block_until_ready(kernel(ro, rd, None))
    kernel_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_k, id_k = jax.block_until_ready(kernel(ro, rd, None))
    kernel_s = time.perf_counter() - t0
    jax.block_until_ready(walk(ro, rd, None))
    t0 = time.perf_counter()
    t_r, id_r = jax.block_until_ready(walk(ro, rd, None))
    walk_s = time.perf_counter() - t0
    t_k, id_k, t_r, id_r = map(np.asarray, (t_k, id_k, t_r, id_r))
    prim_id_bad, prim_t_bad = _closest_mismatch(id_k, t_k, id_r, t_r)
    n_hit = int((id_r >= 0).sum())
    assert n_hit > n // 10, "the flagship camera must see the mesh"

    # Dense ray_triangle oracle on a seeded sample of the primary rays.
    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(n, DENSE_SAMPLE, replace=False))
    t_d, id_d = map(np.asarray, dense(ro[sample], rd[sample]))
    dense_id_bad, dense_t_bad = _closest_mismatch(
        id_k[sample], t_k[sample], id_d, t_d)

    # Shadow rays: from the primary hits toward a point behind and
    # above the mesh (so that many are occluded), with the distance as
    # limit; origins nudged back along the view ray.
    hit_idx = np.nonzero(id_r >= 0)[0]
    p = np.asarray(ro)[hit_idx] + np.asarray(rd)[hit_idx] * (
        t_r[hit_idx, None] * np.float32(1 - 1e-4))
    light = np.asarray([1.9, 3.0, -3.6], np.float32)
    d = light[None, :] - p
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    s_ro = jnp.asarray(p, jnp.float32)
    s_rd = jnp.asarray(d / dist[:, None], jnp.float32)
    s_tl = jnp.asarray(dist)
    ts_k, ids_k = map(np.asarray, kernel(s_ro, s_rd, s_tl))
    ts_r, ids_r = map(np.asarray, walk(s_ro, s_rd, s_tl))
    sh_id_bad, sh_t_bad = _closest_mismatch(ids_k, ts_k, ids_r, ts_r,
                                            floor=1.0)
    occ_k = np.asarray(kernel_any(s_ro, s_rd, s_tl)[1]) >= 0
    tc_r, idc_r = map(np.asarray, walk(s_ro, s_rd, None))
    occ_r = (idc_r >= 0) & (tc_r < dist)
    near_limit = (idc_r >= 0) & (np.abs(tc_r - dist) <= _tol(dist))
    any_bad = int(((occ_k != occ_r) & ~near_limit).sum())

    res = dict(
        rays=n, hits=n_hit, kernel_first_call_s=kernel_first_s,
        kernel_closest_s=kernel_s, walk_closest_s=walk_s,
        primary_vs_walk=dict(id_mismatch=prim_id_bad,
                             t_mismatch=prim_t_bad),
        primary_vs_dense=dict(rays=len(sample), id_mismatch=dense_id_bad,
                              t_mismatch=dense_t_bad),
        shadow_rays=len(hit_idx),
        shadow_closest_vs_walk=dict(id_mismatch=sh_id_bad,
                                    t_mismatch=sh_t_bad),
        shadow_any_vs_walk=dict(mismatch=any_bad,
                                occluded=int(occ_r.sum())),
    )
    phase("parity", **res)
    ok = (max(prim_id_bad, dense_id_bad, sh_id_bad, any_bad)
          <= MAX_EDGE_FLIPS
          and prim_t_bad == dense_t_bad == sh_t_bad == 0)
    assert ok, f"kernel parity outside tolerance: {res}"


def _golden_check(ours, gold):
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_golden import DEFAULT_TOL, neighborhood_violations

    d = np.abs(ours.astype(np.int16) - gold.astype(np.int16))[1:-1, 1:-1]
    fr = (
        float((d > 1).mean()),
        float((d > 8).mean()),
        float(neighborhood_violations(ours, gold)[1:-1, 1:-1].mean()),
    )
    return fr, all(f <= tol for f, tol in zip(fr, DEFAULT_TOL))


def run_gpu_tests():
    """The tests marked `gpu`, in this process (one process per card).
    --noconftest: the suite's conftest pins JAX to the CPU."""
    import pytest

    rc = pytest.main([os.path.join(REPO, "tests"), "-m", "gpu", "-q",
                      "--noconftest", "-p", "no:cacheprovider"])
    phase("gpu_tests", pytest_exit_code=int(rc))
    assert rc == 0, f"gpu tests failed (pytest exit code {rc})"


def run_goldens():
    from rendering_jax.cli import main as cli_main
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    out = {}
    cwd = os.getcwd()
    os.chdir(WS)
    try:
        for name in ("t01_simple_shapes", "t05_area"):
            shutil.copy(os.path.join(REPO, "tests", "scenes",
                                     name + ".scene"), WS)
            bmp = os.path.join(WS, name + ".bmp")
            t0 = time.perf_counter()
            assert cli_main([name + ".scene", "--output", bmp]) == 0
            secs = time.perf_counter() - t0
            ours = bmp_to_image(load_bmp(bmp))
            gold = bmp_to_image(load_bmp(os.path.join(
                REPO, "tests", "goldens", name + ".bmp")))
            fr, ok = _golden_check(ours, gold)
            out[name] = dict(fractions=fr, passed=ok, seconds=secs)
    finally:
        os.chdir(cwd)
    phase("goldens", **out)
    assert all(v["passed"] for v in out.values()), out


SCENE_250K = """[options]
width={w}
height={h}
background_color=0.52,0.8,0.92
ac_penalty=3
image_name=smoke_250k
enableOutput=0
outputProgress=0

[light]
type=point
position=0,0,0
color=1,1,1
intensity=1

[light]
type=distant
direction=0.3,0,-1
color=1,1,1
intensity=0.2

[object]
type=mesh
pos=-0.1,0,-0.6
size=2,2,2
color=1,1,1
rot=0,100,0
material=phong,0.4,0.1,0.7,10.0
name=smoke_250k.obj

[end]
"""


def run_cli():
    from rendering_jax.cli import main as cli_main
    from rendering_jax.flagship import write_procedural_obj
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    n_faces = write_procedural_obj(os.path.join(WS, "smoke_250k.obj"),
                                   N_TRIS)
    with open(os.path.join(WS, "smoke_250k.scene"), "w") as fh:
        fh.write(SCENE_250K.format(w=W, h=H))
    bmp = os.path.join(WS, "smoke_250k.bmp")
    cwd = os.getcwd()
    os.chdir(WS)
    try:
        secs = []
        for _ in range(2):  # cold (load + build + compile), then warm
            t0 = time.perf_counter()
            assert cli_main(["smoke_250k.scene", "--output", bmp]) == 0
            secs.append(time.perf_counter() - t0)
    finally:
        os.chdir(cwd)
    img = bmp_to_image(load_bmp(bmp))
    assert img.shape == (H, W, 3), img.shape
    lit = float((img.max(axis=2) > 0).mean())
    phase("cli", triangles=n_faces, bmp=os.path.relpath(bmp, REPO),
          bmp_bytes=os.path.getsize(bmp), cold_s=secs[0], warm_s=secs[1],
          compile_and_load_s=secs[0] - secs[1], nonblack_fraction=lit)
    assert lit > 0.5, "the rendered frame is mostly black"


# The training phase's parameters: the flagship's lights, colours and
# vertices.
PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))
# Gradient comparisons run on lit_scene, where every one of these leaves
# moves the loss. On the flagship the camera and the point light sit
# inside the sphere, the point light's falloff is clamped and the mesh
# takes its colour from a diffuse map: the light and colour gradients
# there are exactly 0 and would prove nothing.
GRAD_PATHS = (("lights", 0, "intensity"), ("lights", 1, "intensity"),
              ("obj_color",), ("meshes", 0, "v"))
# Gradient tolerances. Kernel vs plain oracle: allclose at GRAD_RTOL.
# Sharded vs one card: allclose at SHARD_RTOL. `atol` is rtol times the
# leaf's largest |gradient|. Besides, every leaf's relative L2 difference
# must stay within GRAD_REL_L2, 10x the largest difference measured on
# H100s between two summation orders of one gradient (2.0e-5: vertex
# gradients, whose scatter-add splits differently over 4 cards than on
# one; the same step repeated on one card differs by about 1e-9).
GRAD_RTOL = 1e-3
SHARD_RTOL = 1e-4
GRAD_REL_L2 = 2e-4


def lit_scene(w, h, n_tris):
    """The flagship's procedural mesh seen from outside, untextured (its
    colour is obj_color), over a floor plane, lit by a point light below
    its falloff clamp and by a distant light."""
    from rendering_jax.flagship import procedural_mesh
    from rendering_jax.models.parser import LightDef, ObjectDef, SceneDef
    from rendering_jax.models.scene import build_scene
    from rendering_jax.models.settings import RenderSettings

    sd = SceneDef(settings=RenderSettings(
        width=w, height=h, ac_penalty=3, background_color=(0.52, 0.8, 0.92),
        enable_ssaa=False, enable_output=False, output_progress=False,
    ))
    sd.cam_pos = (0.0, 0.3, 2.4)
    sd.lights = [
        LightDef("point", color=(1, 1, 1), intensity=0.05,
                 pos=(1.5, 2.5, 1.5)),
        LightDef("distant", color=(1, 1, 1), intensity=0.3,
                 dir=(-0.4, -1, -0.5)),
    ]
    mesh = ObjectDef(
        "mesh", pos=(-0.1, 0, -0.6), size=(2, 2, 2), color=(0.9, 0.5, 0.3),
        material="phong", ambient=0.2, diffuse=0.6, specular=0.3,
        n_specular=10.0,
    )
    mesh.mesh = procedural_mesh(n_tris, pos=mesh.pos, size=mesh.size)
    sd.objects = [
        ObjectDef("plane", pos=(0, -1.1, 0), normal=(0, 1, 0),
                  color=(0.8, 0.75, 0.7)),
        mesh,
    ]
    return build_scene(sd)


def _grad_probe():
    """An optax transformation that leaves the parameters where they are
    and keeps the gradients as its state, so that a make_train_step step
    hands back its exact gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    def zeros(tree):
        return jax.tree_util.tree_map(jnp.zeros_like, tree)

    return optax.GradientTransformation(
        zeros, lambda grads, state, params=None: (zeros(grads), grads))


def grad_step(mesh=None):
    """fn(scene, target) -> ({leaf: gradient}, loss) of one step of
    diff.inverse.make_train_step over GRAD_PATHS (sharded over `mesh`
    when given). One jitted step serves every call."""
    import numpy as np

    from rendering_jax.diff.inverse import extract_params, make_train_step

    init_fn, step_fn = make_train_step(GRAD_PATHS, optimizer=_grad_probe(),
                                       mesh=mesh)

    def run(scene, target):
        params = extract_params(scene, GRAD_PATHS)
        _, grads, loss = step_fn(params, init_fn(params), scene, target)
        return {k: np.asarray(v) for k, v in grads.items()}, float(loss)

    return run


def _grads_close(got, want, rtol):
    """Per-leaf comparison of two gradient dicts: elementwise allclose at
    `rtol` (atol = rtol * the leaf's largest |gradient|) and relative L2
    within GRAD_REL_L2. A leaf whose gradient is 0 fails: comparing it
    proves nothing. Returns ({leaf: report}, all_ok)."""
    import numpy as np

    close, ok = {}, True
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        scale = float(np.abs(b).max())
        far = ~np.isclose(a, b, rtol=rtol, atol=rtol * scale)
        rel_l2 = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        close[key] = dict(n_not_close=int(far.sum()), rel_l2=rel_l2,
                          max_abs=scale)
        ok &= scale > 0 and not far.any() and rel_l2 <= GRAD_REL_L2
    return close, ok


def _same_loss(a, b):
    # Equal up to the order of the mean's f32 sum.
    return abs(a - b) <= 1e-6 * abs(b)


def run_train(flagship):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.diff.inverse import extract_params, make_train_step

    init_fn, step_fn = make_train_step(PATHS)
    params = extract_params(flagship, PATHS)
    params = {k: v * 0.98 for k, v in params.items()}
    opt_state = init_fn(params)
    target = jnp.full((3, H, W), 0.5, jnp.float32)
    losses, secs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, flagship,
                                          target)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    finite = all(np.isfinite(v).all() for v in
                 jax.tree_util.tree_leaves(params))
    phase("train", losses=losses, step_s=secs, params_finite=finite)
    assert all(np.isfinite(losses)) and finite


def run_grads():
    """Gradients of one training step on lit_scene at full width, kernel
    vs plain oracle, for the 250k mesh (plain = traverse_bvh) and the
    4,096-triangle one (plain = bruteforce_mesh, the ray_triangle
    reference). Not bruteforce_mesh_mxu, the timing phase's plain oracle
    there: its matmul form rounds u, v and t differently, so a few rays
    at shared edges hit the neighbouring triangle and move their whole
    contribution to other vertices. The kernel's step runs twice: the
    difference of the two is the run-to-run noise."""
    import jax.numpy as jnp

    target = jnp.full((3, H, W), 0.5, jnp.float32)
    step = grad_step()
    report, ok = {}, True
    for regime, n_tris in (("250k", N_TRIS), ("4096", SMALL_TRIS)):
        scene = lit_scene(W, H, n_tris)
        g_k, l_k = step(scene, target)
        g_k2, _ = step(scene, target)
        g_p, l_p = step(with_settings(scene, use_pallas_intersect=False,
                                      use_mxu_intersect=False), target)
        close, good = _grads_close(g_k, g_p, GRAD_RTOL)
        report[regime] = dict(
            loss_kernel=l_k, loss_plain=l_p, kernel_vs_plain=close,
            kernel_repeat=_grads_close(g_k2, g_k, GRAD_RTOL)[0])
        ok &= good and _same_loss(l_k, l_p)
    phase("grads", **report)
    assert ok, report


def _steps(scene, use_kernel):
    import jax
    import jax.numpy as jnp

    from rendering_jax.diff.inverse import apply_params, extract_params
    from rendering_jax.render.pipeline import render_scene

    s = with_settings(scene, use_pallas_intersect=use_kernel)
    params = extract_params(s, PATHS)

    def loss_fn(params, scene):
        frame, _ = render_scene(apply_params(scene, params, PATHS))
        return jnp.mean(frame)

    out = {}
    for kind, fn in (("fwd_bwd", jax.value_and_grad(loss_fn)),
                     ("fwd", loss_fn)):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(params, s).compile()
        out[kind] = (compiled, time.perf_counter() - t0)
        jax.block_until_ready(compiled(params, s))  # first-run set-up
    return s, params, out


def _time(compiled, params, scene, reps):
    import jax

    t0 = time.perf_counter()
    for _ in range(reps):
        res = compiled(params, scene)
    jax.block_until_ready(res)
    return (time.perf_counter() - t0) / reps


def run_timing(flagship, small, reps=2):
    import jax
    import numpy as np

    report = {}
    for regime, scene, plain in (("250k", flagship, "traverse_bvh"),
                                 ("4096", small, "bruteforce_mesh_mxu")):
        variants = {"kernel": _steps(scene, True),
                    "plain": _steps(scene, False)}
        secs = {(v, k): [] for v in variants for k in ("fwd_bwd", "fwd")}
        for kind in ("fwd_bwd", "fwd"):
            for v in ("kernel", "plain", "plain", "kernel"):
                s, params, steps = variants[v]
                secs[(v, kind)].append(_time(steps[kind][0], params, s, reps))
        rays = W * H
        entry = {"plain_oracle": plain}
        for (v, kind), ts in secs.items():
            entry[f"{v}_{kind}_s"] = ts
            entry[f"{v}_{kind}_rays_per_s"] = rays / float(np.mean(ts))
            entry[f"{v}_{kind}_compile_s"] = variants[v][2][kind][1]
        mem = variants["kernel"][2]["fwd_bwd"][0].memory_analysis()
        entry["kernel_fwd_bwd_memory"] = {
            k: getattr(mem, k) for k in (
                "temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)}
        report[regime] = entry
    stats = jax.devices()[0].memory_stats() or {}
    report["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    phase("timing", **report)


def run_four_cards():
    """Sharded paths on 4 cards vs the same work on 1 card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.flagship import (
        build_flagship_scene,
        build_multimesh_scene,
    )
    from rendering_jax.parallel.shard import make_ray_mesh, render_sharded
    from rendering_jax.render.pipeline import render
    from rendering_jax.utils.bmp import quantize_reference

    devs = jax.devices()[:4]
    assert len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    mesh = make_ray_mesh(devs)
    scene = build_flagship_scene(W, H, n_tris=N_TRIS)
    f1, _ = render(scene)
    f4, _ = render_sharded(scene, mesh)
    render_f32_diff = float(np.abs(f1 - f4).max())
    # u8 codes as the BMP writer quantizes them: a value within f32
    # rounding of a code boundary may land one code apart.
    q1, q4 = (quantize_reference(f).astype(np.int16) for f in (f1, f4))
    render_u8_diff = int((q1 != q4).sum())
    render_u8_max = int(np.abs(q1 - q4).max())

    sw, sh = SHARD_WH
    # lit_scene has SSAA off: its refinement mask is a discrete per-pixel
    # decision, and gradients through it are not a supported path
    # (ROADMAP R4). Each step runs twice: the difference of the two is
    # the run-to-run noise.
    small = lit_scene(sw, sh, N_TRIS)
    target = jnp.full((3, sh, sw), 0.5, jnp.float32)
    one, four = grad_step(), grad_step(mesh)
    (g1, l1), (g1b, _) = one(small, target), one(small, target)
    (g4, l4), (g4b, _) = four(small, target), four(small, target)
    grad_close, grad_ok = _grads_close(g4, g1, SHARD_RTOL)

    from rendering_jax.parallel.geoshard import (
        make_geo_mesh,
        render_geo_sharded,
    )

    ms = build_multimesh_scene(
        sw, sh, n_meshes=4, tris_per_mesh=N_TRIS // 10,
        settings_overrides=dict(geo_shard_axis="geo"))
    g_rep, _ = render_geo_sharded(ms, make_geo_mesh(devs, n_geo=1),
                                  out_u8=True)
    g_22, _ = render_geo_sharded(ms, make_geo_mesh(devs, n_geo=2),
                                 out_u8=True)
    geo_diff = int((np.asarray(g_rep) != np.asarray(g_22)).sum())
    phase("four_cards", render_sharded_vs_1card_f32_max_diff=render_f32_diff,
          render_sharded_vs_1card_u8_diff=render_u8_diff,
          render_sharded_vs_1card_u8_max_diff=render_u8_max,
          train_loss_1card=l1, train_loss_4card=l4,
          grads_4card_vs_1card=grad_close,
          grads_1card_repeat=_grads_close(g1b, g1, SHARD_RTOL)[0],
          grads_4card_repeat=_grads_close(g4b, g4, SHARD_RTOL)[0],
          geo_2x2_vs_replicated_u8_diff=geo_diff)
    assert render_u8_max <= 1 and render_u8_diff <= 1e-4 * q1.size
    assert grad_ok and _same_loss(l4, l1) and geo_diff == 0


def gpu_devices():
    """JAX's devices, or None (with a message) when they are no GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return None
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded checks")
    ap.add_argument("--phases", default="device,gpu_tests,parity,goldens,"
                    "cli,train,grads,timing",
                    help="comma-separated subset of phases")
    args = ap.parse_args(argv)

    devs = gpu_devices()
    if devs is None:
        return 1
    from rendering_jax.utils.compile_cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    shutil.rmtree(WS, ignore_errors=True)
    os.makedirs(WS)
    run_device(cache_dir)
    if args.four_cards:
        run_four_cards()
    else:
        from rendering_jax.flagship import build_flagship_scene

        phases = args.phases.split(",")
        flagship = None
        if {"parity", "train", "timing"} & set(phases):
            flagship = build_flagship_scene(W, H, n_tris=N_TRIS)
        if "gpu_tests" in phases:
            run_gpu_tests()
        if "parity" in phases:
            run_parity(flagship)
        if "goldens" in phases:
            run_goldens()
        if "cli" in phases:
            run_cli()
        if "train" in phases:
            run_train(flagship)
        if "grads" in phases:
            run_grads()
        if "timing" in phases:
            small = build_flagship_scene(W, H, n_tris=SMALL_TRIS)
            run_timing(flagship, small)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

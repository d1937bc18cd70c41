"""Texture painting by gradient descent — the flagship-scale inverse-
rendering showcase.

The forward-only C++ reference can RENDER the shotgun's diffuse map;
this framework can RECOVER it: starting from a flat gray texture, adam
on pixel MSE against one rendered target repaints every camera-visible
texel, with gradients flowing through the wavefront renderer's
differentiable hit re-evaluation and the in-graph packed-map gather
(render.pipeline.derive_mesh_tables). Runs at the benchmark scale —
the REAL shotgun.obj subdivided+displaced to 250k triangles
(flagship.densify_mesh) when the reference assets are present.

Writes to --out:
  target.bmp / start.bmp / recovered.bmp   (renders)
  map_true.bmp / map_start.bmp / map_recovered.bmp  (the texture)
  convergence.json   (per-step loss + covered-texel MAE)

Usage: python examples/texture_paint_demo.py [--steps 200]
       [--width 960] [--height 540] [--tris 250000] [--out showcase]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--tris", type=int, default=250_000)
    ap.add_argument("--out", default="showcase")
    ns = ap.parse_args(argv)

    from rendering_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from rendering_jax.diff.inverse import apply_params, extract_params
    from rendering_jax.flagship import build_flagship_scene
    from rendering_jax.render.pipeline import render_scene
    from rendering_jax.utils.bmp import save_bmp

    scene = build_flagship_scene(
        width=ns.width, height=ns.height, n_tris=ns.tris,
        enable_ssaa=False, real_geometry=True,
    )
    ms = scene.static.meshes[0]
    assert ms.has_diffuse_map, (
        "showcase needs the shotgun diffuse map (reference assets under "
        "input/maps — run from a workspace whose input/ holds them)"
    )
    w_t, h_t = ms.dmap_wh
    print(f"scene: {ms.n_tris} tris, {w_t}x{h_t} diffuse map, "
          f"{ns.width}x{ns.height} render", flush=True)

    paths = (("meshes", 0, "diffuse_map"),)
    true_map = np.asarray(scene.meshes[0].diffuse_map)  # (Wt*Ht, 3)

    target3, _ = render_scene(scene)
    target3 = jax.lax.stop_gradient(target3)

    def loss_fn(params):
        s = apply_params(scene, params, paths)
        frame3, _ = render_scene(s)
        return jnp.mean((frame3 - target3) ** 2)

    # Start: flat 50% gray — a full repaint, not a nudge.
    params = {"meshes/0/diffuse_map": jnp.full_like(
        scene.meshes[0].diffuse_map, 0.5
    )}

    # Texels the camera can see = texels with nonzero loss gradient at
    # the start; the rest (back faces, unused UV area) keep their init
    # and are excluded from the recovery error.
    g0 = jax.grad(loss_fn)(params)["meshes/0/diffuse_map"]
    covered = np.asarray(jnp.any(jnp.abs(g0) > 0, axis=1))
    print(f"covered texels: {covered.sum()}/{covered.size}", flush=True)

    opt = optax.adam(ns.lr)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        # Textures live in [0, 1] (decode_normal/specular contracts).
        params = {k: jnp.clip(v, 0.0, 1.0) for k, v in params.items()}
        return params, opt_state, loss

    def covered_mae(p):
        rec = np.asarray(p["meshes/0/diffuse_map"])
        return float(np.abs(rec - true_map)[covered].mean())

    os.makedirs(ns.out, exist_ok=True)
    start_frame3, _ = render_scene(apply_params(scene, params, paths))
    curve = []
    for i in range(ns.steps):
        params, opt_state, loss = train_step(params, opt_state)
        if i % 10 == 0 or i == ns.steps - 1:
            mae = covered_mae(params)
            curve.append({"step": i, "loss": float(loss),
                          "covered_texel_mae": round(mae, 5)})
            print(f"step {i:4d}  loss {float(loss):.3e}  "
                  f"covered-texel MAE {mae:.4f}", flush=True)

    rec_frame3, _ = render_scene(apply_params(scene, params, paths))

    def frame_img(f3):
        return np.asarray(f3).transpose(1, 2, 0)

    def map_img(flat):
        return np.asarray(flat).reshape(h_t, w_t, 3)

    save_bmp(os.path.join(ns.out, "target.bmp"), frame_img(target3))
    save_bmp(os.path.join(ns.out, "start.bmp"), frame_img(start_frame3))
    save_bmp(os.path.join(ns.out, "recovered.bmp"), frame_img(rec_frame3))
    save_bmp(os.path.join(ns.out, "map_true.bmp"), map_img(true_map))
    save_bmp(os.path.join(ns.out, "map_start.bmp"),
             np.full((h_t, w_t, 3), 0.5, np.float32))
    save_bmp(os.path.join(ns.out, "map_recovered.bmp"),
             map_img(params["meshes/0/diffuse_map"]))
    result = {
        "tris": int(ms.n_tris),
        "render": f"{ns.width}x{ns.height}",
        "map": f"{w_t}x{h_t}",
        "covered_texels": int(covered.sum()),
        "steps": ns.steps,
        "start_covered_mae": round(float(
            np.abs(0.5 - true_map)[covered].mean()), 5),
        "final_covered_mae": curve[-1]["covered_texel_mae"],
        "curve": curve,
        "platform": jax.default_backend(),
    }
    with open(os.path.join(ns.out, "convergence.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "curve"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

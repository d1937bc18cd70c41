"""Inverse-rendering demo: recover perturbed scene parameters by
gradient descent on pixel MSE — the capability the differentiable
redesign adds over the forward-only C++ reference.

Renders a target frame from a scene file, perturbs light intensity and
an object color, then optimizes them back with adam. Works on CPU or
GPU; any scene in tests/scenes/ (or the reference's input/) works.

Usage (from a directory whose input/ holds the scene's assets):
    python examples/inverse_demo.py [scene.scene] [--steps 150]
    python examples/inverse_demo.py [scene.scene] --camera

--camera recovers the CAMERA POSE instead (the classic inverse-
rendering parameter): the target is rendered at the scene file's
pose, the camera is then translated + rotated away, and gradient
descent on pixel MSE — flowing through the differentiable hit
re-evaluation and ops.geometry.euler_matrix_j — brings it back.
"""

from __future__ import annotations

import argparse
import sys


def recover_camera_pose(scene, steps: int, lr: float) -> int:
    """Camera pose recovery by gradient descent on pixel MSE."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from rendering_jax.ops.geometry import euler_matrix_j
    from rendering_jax.render.pipeline import render_scene

    target, _ = render_scene(scene)
    target = jnp.asarray(target)
    true_pos = np.asarray(scene.cam_pos)

    def set_pose(params):
        return dataclasses.replace(
            scene, cam_pos=params["pos"],
            cam_rmat=euler_matrix_j(params["angles_deg"]),
        )

    def loss_fn(params):
        frame, _ = render_scene(set_pose(params))
        return jnp.mean((frame - target) ** 2)

    # Perturbed start: translated + rotated away from the target pose.
    params = {
        "pos": scene.cam_pos + jnp.asarray([0.04, -0.03, 0.05]),
        "angles_deg": jnp.asarray([1.0, -0.7, 0.5], jnp.float32),
    }
    # Clipped adam with cosine lr decay: large early steps cross the
    # pose basin quickly, small late steps settle the residual (a
    # fixed lr parks adam's unit-scale steps at a limit cycle around
    # the optimum); clipping keeps a step from walking the camera
    # across a visibility discontinuity (or inside glass).
    schedule = optax.cosine_decay_schedule(lr, steps, alpha=0.02)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(schedule))
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(steps):
        params, opt_state, loss = train_step(params, opt_state)
        if i % 20 == 0 or i == steps - 1:
            pe = float(np.abs(np.asarray(params["pos"]) - true_pos).max())
            ae = float(np.abs(np.asarray(params["angles_deg"])).max())
            print(f"step {i:4d}  loss {float(loss):.3e}  "
                  f"pos_err {pe:.4f}  angle_err {ae:.3f} deg")
    pe = float(np.abs(np.asarray(params["pos"]) - true_pos).max())
    ae = float(np.abs(np.asarray(params["angles_deg"])).max())
    print(f"\nrecovered pose: max |pos err| {pe:.5f}, "
          f"max |angle err| {ae:.4f} deg "
          f"(started at 0.05 / 1.0)")
    return 0


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__)
    args.add_argument("scene", nargs="?", default="input/simple_shapes.scene")
    args.add_argument("--steps", type=int, default=150)
    args.add_argument("--lr", type=float, default=5e-2)
    args.add_argument("--camera", action="store_true",
                      help="recover a perturbed camera pose instead of "
                           "light/color parameters")
    ns = args.parse_args(argv)

    import jax.numpy as jnp
    import numpy as np
    import optax

    from rendering_jax.diff.inverse import (
        apply_params,
        extract_params,
        make_train_step,
    )
    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.render.pipeline import render_scene

    # SSAA off: the Sobel mask is a discrete function of the frame, so
    # keeping it out of the loop gives cleaner gradients.
    scene = load_scene(ns.scene, RenderSettings(enable_ssaa=False))

    if ns.camera:
        return recover_camera_pose(scene, ns.steps, ns.lr)

    paths = (("lights", 0, "intensity"), ("obj_color",))
    true_params = extract_params(scene, paths)
    target, _ = render_scene(scene)
    target = jnp.asarray(target)

    # Perturb: the optimizer has to find its way back.
    start_params = {
        k: v * 0.4 + 0.1 for k, v in true_params.items()
    }
    start_scene = apply_params(scene, start_params, paths)

    init_fn, step_fn = make_train_step(paths, optimizer=optax.adam(ns.lr))
    params = extract_params(start_scene, paths)
    opt_state = init_fn(params)

    for i in range(ns.steps):
        params, opt_state, loss = step_fn(
            params, opt_state, start_scene, target
        )
        if i % 10 == 0 or i == ns.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.3e}")

    print(
        "\nrecovered vs true (note: light intensity x albedo is only"
        "\nidentifiable as a product from a single image, and channels"
        "\nthe camera never sees keep their init):"
    )
    for k in params:
        rec = np.asarray(params[k]).ravel()
        true = np.asarray(true_params[k]).ravel()
        err = float(np.abs(rec - true).max())
        print(f"  {k}: max abs err {err:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Inverse rendering — gradient-descent recovery of scene parameters.

The reference has no counterpart (it is forward-only); this is the
capability the differentiable redesign buys: render -> pixel loss vs a
target image -> `jax.grad` through the whole wavefront integrator ->
optimizer step on any float leaf of the Scene pytree (light
intensities/colors, object colors/materials, sphere positions/radii,
plane/mesh geometry, textures, skybox).

Parameters are addressed by PATHS into the Scene pytree, e.g.
  ("lights", 0, "intensity")
  ("sph_pos",)
  ("obj_color",)
  ("meshes", 0, "v")
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from rendering_jax.render.pipeline import render_scene

Path = tuple


def _get(scene, path: Path):
    node = scene
    for p in path:
        node = node[p] if isinstance(p, int) else getattr(node, p)
    return node


def _set(scene, path: Path, value):
    if len(path) == 1:
        p = path[0]
        if isinstance(p, int):
            out = list(scene)
            out[p] = value
            return tuple(out)
        return dataclasses.replace(scene, **{p: value})
    p = path[0]
    child = scene[p] if isinstance(p, int) else getattr(scene, p)
    new_child = _set(child, path[1:], value)
    if isinstance(p, int):
        out = list(scene)
        out[p] = new_child
        return tuple(out)
    return dataclasses.replace(scene, **{p: new_child})


def extract_params(scene, paths: Sequence[Path]) -> dict:
    return {"/".join(map(str, p)): _get(scene, p) for p in paths}


def apply_params(scene, params: dict, paths: Sequence[Path]):
    for p in paths:
        scene = _set(scene, p, params["/".join(map(str, p))])
    return scene


def make_train_step(paths: Sequence[Path], optimizer=None, mesh=None,
                    render_fn=None):
    """Build (init_fn, step_fn):
      opt_state = init_fn(params)
      params, opt_state, loss = step_fn(params, opt_state, scene, target)
    `mesh` switches to the shard_map renderer (rays over chips, grads
    psum'd by partitioned AD). step_fn is jitted.
    """
    import optax

    optimizer = optimizer or optax.adam(1e-2)
    paths = tuple(tuple(p) for p in paths)

    if render_fn is None:
        if mesh is not None:
            from rendering_jax.parallel.shard import render_scene_sharded

            def render_fn(s):
                return render_scene_sharded(s, mesh)[0]
        else:
            def render_fn(s):
                return render_scene(s)[0]

    def loss_fn(params, scene, target):
        s = apply_params(scene, params, paths)
        frame = render_fn(s)
        return jnp.mean((frame - target) ** 2)

    @jax.jit
    def step_fn(params, opt_state, scene, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return optimizer.init, step_fn

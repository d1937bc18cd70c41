"""Gradient-aggregation / backward-bounce overlap (SURVEY section 5.8).

The sharded train step differentiates a replicated Scene through
shard_map. Under vma-aware partitioned AD, a replicated (unvarying)
parameter used inside the bounce `lax.scan` is routed through `pvary`
ops IN THE SCAN BODY, and `pvary`'s transpose is `psum` — so the
backward scan all-reduces each bounce's parameter cotangents AS THAT
BACKWARD STEP RUNS, accumulating already-reduced partials. The
"gradient aggregation overlapped with the backward bounce loop" the
SURVEY calls for is therefore the DEFAULT schedule of this renderer's
train step, by construction (one psum per scene-use per bounce riding
the interconnect while the next backward bounce computes — the same bucketed
schedule DDP frameworks implement by hand). `test_parallel.py`
verifies this STRUCTURALLY: the train-step jaxpr contains psums inside
the reverse-scan body.

What is NOT buildable without hardware is knowing whether many small
per-bounce psums beat one bulk reduction on a real interconnect. This module
provides both schedules behind a flag so multi-chip hardware can A/B
them on day one:

* overlap=True  — grads w.r.t. the replicated params (default AD:
  per-bounce psums inside the backward scan; the result is already
  globally reduced, no further collective).
* overlap=False — grads w.r.t. a `pvary`'d (device-varying) copy of
  the params: AD inserts NO in-loop psums, the body gets device-local
  partial gradients, and ONE bulk psum per leaf runs after the whole
  backward pass (the classic schedule).

Both return identical gradients up to f32 reduction order (pinned by
tests on the virtual 8-device mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_sharded_grad_fn(paths, mesh, *, overlap: bool = True,
                         ray_block: int | None = None):
    """Primary-pass sharded loss/grad with a selectable psum schedule.

    Returns f(params, scene, target3) -> (loss, grads): target3 is a
    (3, H, W) frame, loss = mean squared error over the rendered
    pixels (the reference's dead last row/column excluded), grads are
    the globally-reduced parameter gradients under either schedule.

    Scope: the flagship train-step shape — primary pass, no SSAA
    refinement (benchmark scenes render with enable_ssaa=False).
    """
    from jax.sharding import PartitionSpec as P

    from rendering_jax.diff.inverse import apply_params
    from rendering_jax.ops.geometry import pvary_like
    from rendering_jax.parallel.shard import (
        _round_robin_layout,
        _shard_map,
    )
    from rendering_jax.render.integrator import DEFAULT_RAY_BLOCK, integrate
    from rendering_jax.render.pipeline import derive_mesh_tables
    from rendering_jax.render.raygen import pixel_dirs

    paths = tuple(tuple(p) for p in paths)
    ray_block = ray_block or DEFAULT_RAY_BLOCK
    axis = "rays"

    def grad_fn(params, scene, target3):
        st = scene.static
        w, h = st.settings.width, st.settings.height
        assert not st.settings.enable_ssaa, (
            "make_sharded_grad_fn covers the primary pass only "
            "(benchmark shape); render with enable_ssaa=False"
        )
        ndev = mesh.devices.size
        r = w * h
        rp, perm = _round_robin_layout(r, ndev, (w, h))
        xs = (perm % w).astype(jnp.float32)
        ys = jnp.minimum(perm // w, h - 1).astype(jnp.float32)
        # Per-slot validity/targets in slot order (padded slots weigh 0;
        # the dead last row/column never renders in the reference —
        # scene.cpp:369-372 — so they are masked out of the loss).
        px = jnp.minimum(perm, r - 1)
        valid = (
            (perm < r) & (px % w != w - 1) & (px // w != h - 1)
        ).astype(jnp.float32)
        tgt_slots = target3.reshape(3, r)[:, px]  # (3, rp)
        n_loss_px = (w - 1) * (h - 1)

        def local(params, scene, xs_l, ys_l, tgt_l, valid_l):
            def local_loss(params):
                s = apply_params(scene, params, paths)
                s = derive_mesh_tables(s)
                rd = pixel_dirs(s, xs_l, ys_l, 1.0, 1.0)
                ro = jnp.broadcast_to(s.cam_pos, rd.shape)
                nloc = xs_l.shape[0]
                slots3, _stats = integrate(
                    s, ro, rd,
                    jnp.arange(nloc, dtype=jnp.int32),
                    jnp.ones((nloc,), jnp.float32),
                    n_pixels=nloc, ray_block=ray_block,
                    out_slots=not st.any_bouncing,
                )
                # Device-local partial of the global mean-squared error.
                err = (slots3 - tgt_l) * valid_l[None, :]
                return jnp.sum(err * err) / (3.0 * n_loss_px)

            if overlap:
                # Replicated params: partitioned AD psums each bounce's
                # cotangents inside the backward scan; g arrives
                # already globally reduced (vma-unvarying).
                loss_d, g = jax.value_and_grad(local_loss)(params)
            else:
                # Bulk schedule: grads w.r.t. a device-varying copy get
                # NO in-loop psums (device-local partials), then one
                # bulk reduction per leaf after the whole backward.
                params_v = pvary_like(params, xs_l)
                loss_d, g = jax.value_and_grad(local_loss)(params_v)
                g = jax.tree_util.tree_map(
                    lambda x: jax.lax.psum(x, axis), g
                )
            loss = jax.lax.psum(loss_d, axis)
            return loss, g

        return _shard_map(
            local, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(None, axis), P(axis)),
            out_specs=(P(), P()),
        )(params, scene, xs, ys, tgt_slots, valid)

    return grad_fn

"""psum / backward-bounce overlap (parallel.overlap; SURVEY 5.8).

Two claims, both CPU-checkable on the virtual 8-device mesh:

1. STRUCTURE: differentiating the replicated scene through the bounce
   scan under shard_map places the parameter-gradient psums INSIDE the
   backward (reverse) scan body — the per-bounce overlapped schedule —
   while the bulk schedule (grads w.r.t. a pvary'd copy + one final
   psum) has no in-scan psums. Pinned by walking the jaxpr.
2. NUMERICS: both schedules produce the same loss and gradients (up to
   f32 reduction order), and they match the standard train step that
   differentiates through the shard_map boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.diff.inverse import apply_params, extract_params
from rendering_jax.flagship import build_tiny_scene
from rendering_jax.parallel.overlap import make_sharded_grad_fn
from rendering_jax.parallel.shard import make_ray_mesh, render_scene_sharded

PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))


@pytest.fixture(scope="module")
def setup():
    mesh = make_ray_mesh(jax.devices()[:8])
    scene = build_tiny_scene(width=48, height=32, n_tris=64)
    target3 = render_scene_sharded(scene, mesh)[0]
    params = extract_params(scene, PATHS)
    # Perturb so gradients are non-trivial.
    params = {k: v + 0.03 for k, v in params.items()}
    return mesh, scene, target3, params


def _find_scan_psums(jaxpr, in_reverse_scan=False, found=None):
    """Collect (primitive_name, inside_reverse_scan) for psum ops.
    Recurses into sub-jaxprs whether they appear as ClosedJaxpr
    (.jaxpr) or raw Jaxpr (.eqns) params (shard_map holds the latter)."""
    if found is None:
        found = []
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if "psum" in name:
            found.append((name, in_reverse_scan))
        for v in eqn.params.values():
            for item in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(item, "jaxpr", None)
                if inner is None and hasattr(item, "eqns"):
                    inner = item
                if inner is not None and hasattr(inner, "eqns"):
                    rev = in_reverse_scan or (
                        name == "scan" and eqn.params.get("reverse", False)
                    )
                    _find_scan_psums(inner, rev, found)
    return found


def test_psum_placement(setup):
    mesh, scene, target3, params = setup
    for overlap, want_in_scan in ((True, True), (False, False)):
        fn = make_sharded_grad_fn(PATHS, mesh, overlap=overlap)
        jx = jax.make_jaxpr(fn)(params, scene, target3)
        psums = _find_scan_psums(jx.jaxpr)
        assert psums, "no psum anywhere — grads are not being reduced"
        in_scan = [p for p in psums if p[1]]
        if want_in_scan:
            # Overlapped schedule: parameter cotangents reduce inside
            # the backward bounce scan.
            assert in_scan, (
                f"overlap=True but no psum inside a reverse scan: {psums}"
            )
        else:
            assert not in_scan, (
                f"overlap=False (bulk) but psums inside a scan: {psums}"
            )


@pytest.mark.slow
def test_overlap_equals_bulk_and_boundary(setup):
    mesh, scene, target3, params = setup
    f_overlap = jax.jit(make_sharded_grad_fn(PATHS, mesh, overlap=True))
    f_bulk = jax.jit(make_sharded_grad_fn(PATHS, mesh, overlap=False))
    l0, g0 = f_overlap(params, scene, target3)
    l1, g1 = f_bulk(params, scene, target3)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(
            np.asarray(g0[k]), np.asarray(g1[k]), rtol=1e-4, atol=1e-7,
            err_msg=k,
        )

    # Cross-check against differentiating THROUGH the shard_map
    # boundary (the standard train step's gradient route). Same mask:
    # the grad fn excludes the reference's dead last row/column, the
    # sharded frame zeroes them — mse denominators align on (w-1)(h-1).
    st = scene.static.settings
    w, h = st.width, st.height

    def boundary_loss(params):
        s = apply_params(scene, params, PATHS)
        frame3, _ = render_scene_sharded(s, mesh)
        err = (frame3 - target3)[:, : h - 1, : w - 1]
        # frame3 and target3 both zero the dead column w-1 inside the
        # cropped rows, so restrict columns too for an exact match.
        return jnp.sum(err * err) / (3.0 * (w - 1) * (h - 1))

    l2, g2 = jax.value_and_grad(boundary_loss)(params)
    np.testing.assert_allclose(float(l0), float(l2), rtol=1e-5)
    for k in g0:
        np.testing.assert_allclose(
            np.asarray(g0[k]), np.asarray(g2[k]), rtol=2e-4, atol=1e-7,
            err_msg=k,
        )

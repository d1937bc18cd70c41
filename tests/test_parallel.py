"""Sharding tests on the virtual 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8, set in conftest).
"""

import dataclasses

import jax
import numpy as np
import pytest

from rendering_jax.models.scene import load_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.parallel.shard import make_ray_mesh, render_sharded
from rendering_jax.render.pipeline import render


def _shrink(scene, w, h, **kw):
    st = scene.static
    return dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(width=w, height=h, **kw)
        ),
    )


@pytest.fixture(scope="module")
def eight_device_mesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return make_ray_mesh(jax.devices())


def test_sharded_matches_single(in_workspace, eight_device_mesh):
    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 96, 64)
    f1, _ = render(scene)
    f8, _ = render_sharded(scene, eight_device_mesh)
    np.testing.assert_allclose(f1, f8, atol=2e-6)


@pytest.mark.slow
def test_sharded_mesh_scene(in_workspace, eight_device_mesh):
    scene = load_scene(
        "t07_no_ac.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 80, 60)
    f1, _ = render(scene)
    f8, _ = render_sharded(scene, eight_device_mesh)
    np.testing.assert_allclose(f1, f8, atol=2e-6)


@pytest.mark.slow
def test_sharded_grad_psum(in_workspace, eight_device_mesh):
    """Gradient of a scalar loss w.r.t. replicated scene params under
    shard_map must equal the single-device gradient (the partitioned-AD
    psum is the gradient all-reduce)."""
    import jax.numpy as jnp

    from rendering_jax.parallel.shard import render_scene_sharded
    from rendering_jax.render.pipeline import render_scene

    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 48, 32, enable_ssaa=False)

    def loss_single(intensity):
        lights = list(scene.lights)
        lights[0] = dataclasses.replace(lights[0], intensity=intensity)
        s = dataclasses.replace(scene, lights=tuple(lights))
        frame3, _ = render_scene(s)
        return jnp.sum(frame3)

    def loss_sharded(intensity):
        lights = list(scene.lights)
        lights[0] = dataclasses.replace(lights[0], intensity=intensity)
        s = dataclasses.replace(scene, lights=tuple(lights))
        frame3, _ = render_scene_sharded(s, eight_device_mesh)
        return jnp.sum(frame3)

    x = jnp.asarray(0.5, jnp.float32)
    g1 = float(jax.grad(loss_single)(x))
    g8 = float(jax.grad(loss_sharded)(x))
    np.testing.assert_allclose(g1, g8, rtol=1e-4)


def test_multihost_helpers_single_process():
    """Multi-host helpers degrade gracefully in a single process: no
    coordinator -> False, topology reflects the virtual 8-device mesh,
    global mesh spans all devices."""
    import jax

    from rendering_jax.parallel.multihost import (
        initialize_distributed,
        make_global_ray_mesh,
        make_host_ray_mesh,
        process_topology,
        scaling_report,
    )

    assert initialize_distributed() is False  # no cluster configured
    topo = process_topology()
    assert topo["process_count"] == 1
    assert topo["global_devices"] == len(jax.devices())
    mesh = make_global_ray_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert make_host_ray_mesh().devices.size == len(jax.local_devices())
    rep = scaling_report(1e6, 7.2e6, 8)
    assert abs(rep["efficiency"] - 0.9) < 1e-6


@pytest.mark.slow
def test_sharded_odd_device_count(in_workspace):
    """Non-power-of-two meshes (3 and 6 of the 8 virtual devices) must
    produce the same frame — catches ray-count divisibility assumptions
    in the padding/round-robin tile interleave."""
    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 70, 46)  # deliberately awkward raster too
    f1, _ = render(scene)
    for n in (3, 6):
        mesh_n = make_ray_mesh(jax.devices()[:n])
        fn, _ = render_sharded(scene, mesh_n)
        np.testing.assert_allclose(f1, fn, atol=2e-6, err_msg=f"ndev={n}")


def test_unpermute_slots_matches_scatter():
    """The scatter-free slot inversion (reshape/transpose chain) must
    equal the permutation scatter exactly for divisible and padded
    layouts."""
    import jax.numpy as jnp
    import numpy as np

    from rendering_jax.parallel.shard import (
        _round_robin_layout,
        unpermute_slots,
    )

    for (w, h, ndev) in [(64, 48, 1), (64, 48, 3), (123, 45, 4),
                         (64, 56, 8)]:
        r = w * h
        rp, perm = _round_robin_layout(r, ndev, (w, h))
        vals = jnp.arange(3 * rp, dtype=jnp.float32).reshape(3, rp)
        ref = np.zeros((3, rp), np.float32)
        ref[:, np.asarray(perm)] = np.asarray(vals)
        got = np.asarray(unpermute_slots(vals, r, w, h, ndev))
        np.testing.assert_array_equal(ref[:, :r], got, err_msg=str((w, h, ndev)))


def test_round_robin_layout_slots_are_screen_coherent():
    """Guard against the round-5 5.2x cliff regressing: each 512-slot
    run of the tiled round-robin layout must cover a COMPACT screen
    region (a few tw x th rects), not a scanline — a 512-pixel
    row-major run's thin frustum keeps ~5x more super chunks live in
    the kernel pre-cull."""
    import numpy as np

    from rendering_jax.parallel.shard import _round_robin_layout
    from rendering_jax.render.raygen import tile_dims

    w, h, ndev = 1920, 1080, 8
    rp, perm = _round_robin_layout(w * h, ndev, (w, h))
    perm = np.asarray(perm)
    tw, th = tile_dims(w, h)
    for start in (0, 512, rp // 2, rp - 1024):
        run = perm[start:start + 512]
        run = run[run < w * h]
        x, y = run % w, run // w
        area = (x.max() - x.min() + 1) * (y.max() - y.min() + 1)
        # 512 pixels cover ceil(512/(tw*th)) tw x th rects (+1 when
        # unaligned); the bounding box stays within a handful of
        # tiles, far below a 512x1 scanline's 512-wide extent.
        n_rects = -(-512 // (tw * th)) + 1
        assert area <= (n_rects + 1) * tw * th, (start, area)
        assert (x.max() - x.min() + 1) <= (n_rects + 1) * tw, start

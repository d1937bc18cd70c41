"""Two renders must be bitwise identical — unlike the reference, whose
thread scheduling is benign-racy (SURVEY section 5.2), the jitted
pipeline is pure and the CI asserts it stays that way."""

import numpy as np

from rendering_jax.models.scene import load_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render


def test_bitwise_deterministic(in_workspace):
    scene = load_scene(
        "t01_simple_shapes.scene",
        RenderSettings(ssaa_capacity_fraction=1.0),
    )
    import dataclasses

    st = scene.static
    scene = dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(width=80, height=60)
        ),
    )
    f1, _ = render(scene)
    f2, _ = render(scene)
    assert np.array_equal(f1, f2)


def test_render_resumable_matches_and_resumes(tmp_path):
    """Strip-checkpointed render == one-shot render, and a resumed run
    (pre-seeded checkpoint from a partial pass) completes identically."""
    import os

    import numpy as np

    from rendering_jax.flagship import build_tiny_scene
    from rendering_jax.render.pipeline import render, render_resumable

    scene = build_tiny_scene(width=48, height=40, n_tris=64)
    ref, _ = render(scene)

    ck = os.path.join(tmp_path, "strips.npz")
    out, _ = render_resumable(scene, ck, strip_rows=16, resume=False)
    np.testing.assert_allclose(out, ref, atol=1e-6)

    # simulate preemption: drop the last strip from the checkpoint
    from rendering_jax.diff.checkpoint import load_checkpoint, save_checkpoint

    _s, _p, _o, frame_ck, mask = load_checkpoint(ck, {}, {})
    mask = np.asarray(mask).copy()
    mask[-1] = False
    # zero the corresponding rows in the accumulator
    h, w = 40, 48
    acc = np.asarray(frame_ck).reshape(3, h, w).copy()
    acc[:, 32:, :] = 0.0
    save_checkpoint(ck, 0, {}, {}, frame=acc.reshape(3, h * w),
                    tile_mask=mask)
    out2, _ = render_resumable(scene, ck, strip_rows=16, resume=True)
    np.testing.assert_allclose(out2, ref, atol=1e-6)


def test_sharded_bitwise_deterministic(in_workspace):
    """The sharded render (psum + scatter orders included) must also be
    bitwise repeatable."""
    import dataclasses

    import jax

    from rendering_jax.parallel.shard import make_ray_mesh, render_sharded

    scene = load_scene(
        "t01_simple_shapes.scene",
        RenderSettings(ssaa_capacity_fraction=1.0),
    )
    st = scene.static
    scene = dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(width=80, height=60)
        ),
    )
    mesh = make_ray_mesh(jax.devices())
    f1, _ = render_sharded(scene, mesh)
    f2, _ = render_sharded(scene, mesh)
    assert np.array_equal(f1, f2)

"""outputProgress (src/scene.cpp:486-492): strip-rendered progress
prints, with output identical to the one-shot render."""

import dataclasses
import itertools

import numpy as np
import pytest

from rendering_jax.models.scene import load_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render, render_with_progress


def _shrink(scene, w, h, **kw):
    st = scene.static
    return dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(width=w, height=h, **kw)
        ),
    )


def test_progress_render_matches_and_prints(in_workspace):
    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 64, 48)

    f_ref, aux_ref = render(scene)

    # Fake clock: +2s per poll -> every strip triggers a print.
    clock = itertools.count(step=2.0)
    lines = []
    f_prog, aux = render_with_progress(
        scene, strip_rows=16, _now=lambda: next(clock),
        _print=lines.append,
    )
    # t01 has transparent materials: strip-local continuation queues
    # scatter-add a pixel's two children in a different slot order than
    # the whole-frame queue, so equality is up to f32 add reassociation.
    np.testing.assert_allclose(f_ref, f_prog, atol=2e-6, rtol=3e-4)
    # 48 rows / 16-row strips = 3 strips -> 3 once-per-"second" prints,
    # reference format: fixed precision-0 percentage + '%'.
    assert lines == ["33%", "67%", "100%"]
    # strip stats must cover the same primary rays as the one-shot
    assert aux["stats"]["rays_casted"] >= 64 * 48


@pytest.mark.slow
def test_progress_sharded_matches(in_workspace):
    """mesh= shards each strip over the 8 virtual devices
    (shard.render_strip_sharded); output and progress prints match the
    single-device strip render."""
    import jax

    from rendering_jax.parallel.shard import make_ray_mesh

    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 64, 48)
    mesh = make_ray_mesh(jax.devices())

    clock = itertools.count(step=2.0)
    lines = []
    f_single, _ = render_with_progress(scene, strip_rows=16)
    f_shard, aux = render_with_progress(
        scene, strip_rows=16, mesh=mesh, _now=lambda: next(clock),
        _print=lines.append,
    )
    np.testing.assert_allclose(f_single, f_shard, atol=2e-6, rtol=3e-4)
    assert lines == ["33%", "67%", "100%"]
    assert aux["stats"]["rays_casted"] >= 64 * 48


@pytest.mark.slow
def test_resumable_sharded_matches_and_resumes(in_workspace, tmp_path):
    """render_resumable(mesh=...) renders strips sharded, checkpoints,
    and resumes to the same frame."""
    import jax

    from rendering_jax.parallel.shard import make_ray_mesh
    from rendering_jax.render.pipeline import render_resumable

    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 64, 48)
    mesh = make_ray_mesh(jax.devices())
    ck = str(tmp_path / "shard_resume.npz")

    f_ref, _ = render(scene)
    f_shard, _ = render_resumable(scene, ck, strip_rows=16, mesh=mesh)
    np.testing.assert_allclose(f_ref, f_shard, atol=2e-6, rtol=3e-4)
    # Checkpoint marks all strips done -> the resume run must replay to
    # the identical frame (strips skipped, SSAA re-run).
    f_resume, _ = render_resumable(scene, ck, strip_rows=16, mesh=mesh)
    np.testing.assert_array_equal(f_shard, f_resume)


def test_resumable_rejects_stale_scene_checkpoint(in_workspace, tmp_path):
    """A finished checkpoint from a DIFFERENT scene (same resolution)
    must not be served as the render: the scene fingerprint in the
    checkpoint meta forces a from-scratch render, and the fresh run's
    aux carries real accumulated stats (the common wrapper contract)."""
    from rendering_jax.render.pipeline import render_resumable

    scene_a = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene_a = _shrink(scene_a, 64, 48)
    ck = str(tmp_path / "stale.npz")
    f_a, aux_a = render_resumable(scene_a, ck, strip_rows=16)
    assert aux_a["stats"]["rays_casted"] >= 64 * 48

    # Same shapes, different light intensity: resolution-only checks
    # would silently reuse scene A's framebuffer.
    l0 = scene_a.lights[0]
    scene_b = dataclasses.replace(
        scene_a,
        lights=(dataclasses.replace(l0, intensity=l0.intensity * 0.5),)
        + tuple(scene_a.lights[1:]),
    )
    f_b_fresh, _ = render_resumable(
        scene_b, str(tmp_path / "fresh.npz"), strip_rows=16
    )
    f_b_resumed, _ = render_resumable(scene_b, ck, strip_rows=16)
    np.testing.assert_array_equal(f_b_fresh, f_b_resumed)
    assert not np.array_equal(f_a, f_b_resumed)

    # Resuming the ORIGINAL scene from its finished checkpoint replays
    # to the identical frame AND restores the accumulated counters from
    # the checkpoint meta (a preempted glass render must keep its
    # paths_dropped across restarts to trigger the headroom redo).
    f_a2, aux_a2 = render_resumable(scene_a, ck, strip_rows=16)
    np.testing.assert_array_equal(f_a, f_a2)
    assert aux_a2["stats"]["rays_casted"] >= aux_a["stats"]["rays_casted"]


def test_fingerprint_detects_large_leaf_edits():
    """Moving a mesh rewrites the baked vertex arrays but not their
    shape/dtype — a shape-only fingerprint would silently serve a
    stale checkpoint as finished pixels. Large leaves must contribute
    their content: a uniform translate, a single-element interior
    edit, and a texel repaint must all change the hash; recomputing on
    the identical scene must not."""
    import jax.numpy as jnp

    from rendering_jax.flagship import build_flagship_scene
    from rendering_jax.render.pipeline import _scene_fingerprint

    scene = build_flagship_scene(32, 24, n_tris=4096)
    m = scene.meshes[0]
    assert m.v.size * 4 > 65536  # actually exercises the large path

    fp0 = _scene_fingerprint(scene)
    assert fp0 == _scene_fingerprint(scene)  # deterministic

    moved = dataclasses.replace(
        scene, meshes=(dataclasses.replace(m, v=m.v + 0.01),)
    )
    assert _scene_fingerprint(moved) != fp0

    # Interior single-triangle edit (away from head/tail windows).
    v2 = m.v.at[m.v.shape[0] // 2, 1, 1].add(0.25)
    edited = dataclasses.replace(
        scene, meshes=(dataclasses.replace(m, v=v2),)
    )
    assert _scene_fingerprint(edited) != fp0

    if m.diffuse_map is not None:
        repainted = dataclasses.replace(
            scene,
            meshes=(dataclasses.replace(
                m, diffuse_map=jnp.clip(m.diffuse_map * 0.5, 0, 1)
            ),),
        )
        assert _scene_fingerprint(repainted) != fp0


def test_fingerprint_detects_integer_leaf_edits():
    """A local edit to a large INTEGER leaf (a BVH skip pointer) that
    keeps every shape and every float leaf changes the hash: every
    leaf's full bytes are hashed, not a sample of them."""
    from rendering_jax.flagship import build_flagship_scene
    from rendering_jax.render.pipeline import _scene_fingerprint

    scene = build_flagship_scene(32, 24, n_tris=4096, with_maps=False)
    m = scene.meshes[0]
    skip = np.asarray(m.skip).copy()
    assert skip.size > 1024
    skip[skip.size // 2 + 7] += 1
    edited = dataclasses.replace(
        scene, meshes=(dataclasses.replace(m, skip=skip),)
    )
    assert _scene_fingerprint(edited) != _scene_fingerprint(scene)


def test_strip_render_compiles_one_program_per_rows_shape(in_workspace):
    """y0 is a TRACED scalar in the strip functions: a whole-frame
    strip render must compile at most two programs (full strip + tail
    strip), not one per strip — on an accelerator each bounce-program
    compile is tens of seconds, so per-strip recompiles would dominate
    progress / resumable renders."""
    from rendering_jax.render.integrator import DEFAULT_RAY_BLOCK
    from rendering_jax.render.pipeline import _make_strip_fns

    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 64, 40)  # 40 rows / 16 = strips of 16,16,8
    strip_fn, _ = _make_strip_fns(None, DEFAULT_RAY_BLOCK, 1)
    strip_fn.clear_cache()
    render_with_progress(scene, strip_rows=16)
    assert strip_fn._cache_size() == 2  # full + tail, NOT 3


def _showac_scene(ws) -> str:
    """An in-repo showAC=1 scene: t01's objects plus a seeded mesh
    loaded by name (the AC heatmap visualizes the mesh BVH)."""
    from rendering_jax.flagship import write_procedural_obj

    write_procedural_obj(str(ws / "showac_mesh.obj"), 400, seed=3)
    text = (ws / "t01_simple_shapes.scene").read_text()
    text = text.replace("outputProgress=0", "outputProgress=0\nshowAC=1")
    mesh = (
        "[object]\ntype=mesh\npos=0.6,-0.4,-3\nsize=1.5,1.5,1.5\n"
        "color=1,1,1\nrot=0,30,0\nname=showac_mesh.obj\n\n[end]"
    )
    text = text.replace("[end]", mesh)
    (ws / "showac_seeded.scene").write_text(text)
    return "showac_seeded.scene"


def test_progress_show_ac_delegates(in_workspace):
    """show_ac is a single whole-frame debug pass: render_with_progress
    must produce the AC heatmap (not silently strip-render the normal
    image), identical to render()."""
    scene = load_scene(_showac_scene(in_workspace), RenderSettings())
    scene = _shrink(scene, 48, 32)
    assert scene.static.settings.show_ac
    assert scene.static.meshes[0].n_tris >= 400

    f_ref, _ = render(scene)
    assert f_ref.max() > 0  # the heatmap is not blank
    lines = []
    f_prog, aux = render_with_progress(
        scene, strip_rows=16, _print=lines.append
    )
    np.testing.assert_array_equal(f_ref, f_prog)
    assert lines == ["100%"]


def test_resumable_show_ac_delegates(in_workspace, tmp_path):
    from rendering_jax.render.pipeline import render_resumable

    scene = load_scene(_showac_scene(in_workspace), RenderSettings())
    scene = _shrink(scene, 48, 32)
    f_ref, _ = render(scene)
    f_res, _ = render_resumable(
        scene, str(tmp_path / "ck.msgpack"), strip_rows=16
    )
    np.testing.assert_array_equal(f_ref, f_res)


@pytest.mark.slow
def test_progress_shownormals_runs_ssaa(in_workspace):
    """showNormals + SSAA: the reference's SSAAworker casts through
    castRay, which returns normal colors in that mode (scene.cpp:
    601-605, 771-772) — the strip paths must refine exactly like
    render() (review-found round-2 divergence: they skipped SSAA)."""
    scene = load_scene(
        "t08_shownormals.scene",
        RenderSettings(ssaa_capacity_fraction=1.0),
    )
    scene = _shrink(scene, 48, 32)
    assert scene.static.settings.show_normals
    assert scene.static.settings.enable_ssaa

    f_ref, aux_ref = render(scene)
    assert int(aux_ref["ssaa_masked"]) > 0  # edges exist -> SSAA ran
    # <= 1 ulp: render_scene traces _ssaa_pass inline (fusable with the
    # primary pass), the strip paths call it as its own program.
    f_prog, _ = render_with_progress(scene, strip_rows=16)
    np.testing.assert_allclose(f_ref, f_prog, atol=1.2e-7)

    from rendering_jax.render.pipeline import render_resumable
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        f_res, _ = render_resumable(
            scene, os.path.join(d, "ck.msgpack"), strip_rows=16
        )
    np.testing.assert_allclose(f_ref, f_res, atol=1.2e-7)


def test_progress_out_u8_matches_quantized(in_workspace):
    """out_u8 quantizes the FINISHED strip-rendered frame on device
    (4x smaller final pull); bytes must equal the host-quantized f32
    result exactly, for both strip wrappers."""
    from rendering_jax.render.pipeline import render_resumable
    from rendering_jax.utils.bmp import quantize_reference

    scene = load_scene(
        "t01_simple_shapes.scene", RenderSettings(ssaa_capacity_fraction=1.0)
    )
    scene = _shrink(scene, 64, 48)
    f32_frame, _ = render_with_progress(scene, strip_rows=16)
    u8_frame, _ = render_with_progress(scene, strip_rows=16, out_u8=True)
    np.testing.assert_array_equal(quantize_reference(f32_frame), u8_frame)

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        u8_res, _ = render_resumable(scene, d + "/ck.npz", strip_rows=16,
                                     out_u8=True)
    np.testing.assert_array_equal(quantize_reference(f32_frame), u8_res)

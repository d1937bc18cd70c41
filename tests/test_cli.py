"""CLI entry (src/main.cpp:5-16 parity surface): renders a scene file
to BMP, prints the collectStatistics table (include/stats.h:18-36) and
outputProgress percentages, honors --output."""

from __future__ import annotations

import os

import numpy as np
import pytest

SCENE = """[options]
width=64
height=48
background_color=0.52,0.8,0.92
image_name=golden/cli_smoke
enableOutput=0
outputProgress={progress}
collectStatistics=1

[light]
type=distant
direction=0,-1,0
color=1,1,1
intensity=0.4

[object]
type=sphere
pos=0,0,-4
color=1,0.2,0.2
radius=1.5

[end]
"""


def _run(tmp_path, capsys, progress, extra_args=()):
    from rendering_jax.cli import main
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    scene_path = tmp_path / "cli_smoke.scene"
    scene_path.write_text(SCENE.format(progress=progress))
    out_path = tmp_path / "out.bmp"
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([str(scene_path), "--output", str(out_path),
                   *extra_args])
    finally:
        os.chdir(old)
    assert rc == 0
    img = bmp_to_image(load_bmp(str(out_path)))
    assert img.shape == (48, 64, 3)
    # Sphere pixels differ from the background
    assert np.unique(img.reshape(-1, 3), axis=0).shape[0] > 1
    return capsys.readouterr().out, img


def test_cli_stats_table_and_output(tmp_path, capsys):
    out, img = _run(tmp_path, capsys, progress=0)
    assert "Statistics:" in out
    assert "Rays casted:" in out
    # rays casted = primary rays at least (64*48)
    rays = [ln for ln in out.splitlines() if "Rays casted" in ln][0]
    assert int(rays.split()[-1]) >= 64 * 48


def test_cli_trace_dir_captures_profile(tmp_path, capsys):
    """--trace-dir wraps the render phase in a jax.profiler trace
    (SURVEY §5.1's device profiling) and leaves an .xplane.pb
    capture behind."""
    from rendering_jax.cli import main
    from rendering_jax.utils.profiling import find_xplanes

    scene_path = tmp_path / "cli_smoke.scene"
    scene_path.write_text(SCENE.format(progress=0))
    out_path = tmp_path / "out.bmp"
    trace_dir = tmp_path / "trace"
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([str(scene_path), "--output", str(out_path),
                   "--trace-dir", str(trace_dir)])
    finally:
        os.chdir(old)
    assert rc == 0
    assert find_xplanes(str(trace_dir)), "no xplane capture written"


def test_cli_auto_shard_matches_no_shard(tmp_path, capsys):
    """With multiple visible devices (the conftest's 8 virtual CPU
    devices) the CLI shards rays across all of them by default — the
    analogue of the reference defaulting nWorkers to
    hardware_concurrency (src/scene.cpp:68-70). Must match the forced
    single-device render bitwise."""
    out_sharded, img_sharded = _run(tmp_path, capsys, progress=0)
    out_single, img_single = _run(tmp_path, capsys, progress=0,
                                  extra_args=("--no-shard",))
    np.testing.assert_array_equal(img_sharded, img_single)
    # The stats table must survive the sharded path too.
    assert "Rays casted:" in out_sharded


def test_cli_progress_path_identical(tmp_path, capsys):
    out0, img0 = _run(tmp_path, capsys, progress=0)
    out1, img1 = _run(tmp_path, capsys, progress=1)
    # outputProgress routes through the strip renderer; diffuse-only
    # scene -> identical pixels (no transparent queue reorder).
    np.testing.assert_array_equal(img0, img1)


MESH_OBJ = """v -1 -1 -4
v 1 -1 -4
v 0 1 -4
v 2 0.5 -5
v 3 -0.5 -5
v 2.5 1.5 -5
f 1 2 3
f 4 5 6
"""

MESH_SCENE = """[options]
width=64
height=48
background_color=0.52,0.8,0.92
image_name=golden/cli_geo
enableOutput=0
outputProgress={progress}

[light]
type=distant
direction=0,-1,-0.3
color=1,1,1
intensity=0.6

[object]
type=mesh
pos=0,0,-4
size=4,4,4
color=1,0.3,0.2
name=input/objects/cli_tris.obj

[end]
"""


def _run_mesh(tmp_path, capsys, progress, extra_args=()):
    from rendering_jax.cli import main
    from rendering_jax.utils.bmp import bmp_to_image, load_bmp

    (tmp_path / "input" / "objects").mkdir(parents=True, exist_ok=True)
    (tmp_path / "input" / "objects" / "cli_tris.obj").write_text(MESH_OBJ)
    scene_path = tmp_path / "cli_geo.scene"
    scene_path.write_text(MESH_SCENE.format(progress=progress))
    out_path = tmp_path / f"out_geo{len(extra_args)}_{progress}.bmp"
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([str(scene_path), "--output", str(out_path),
                   *extra_args])
    finally:
        os.chdir(old)
    assert rc == 0
    img = bmp_to_image(load_bmp(str(out_path)))
    capsys.readouterr()
    return img


def _interpret_kernel(monkeypatch):
    """Build every scene the CLI loads with the intersection kernel in
    Pallas interpret mode (the CPU stand-in for the compiled kernel)."""
    import rendering_jax.cli as cli
    from rendering_jax.models.settings import RenderSettings

    load = cli.load_scene

    def load_interpreted(path, base=None):
        base = (base or RenderSettings()).replace(pallas_interpret=True)
        return load(path, base)

    monkeypatch.setattr(cli, "load_scene", load_interpreted)


def test_cli_geo_shard_needs_kernel(tmp_path, capsys):
    """On the CPU, without the (interpreted) kernel, --geo-shard stops
    with a usage error instead of rendering a geometry-free frame."""
    with pytest.raises(SystemExit) as exc:
        _run_mesh(tmp_path, capsys, progress=0, extra_args=("--geo-shard",
                                                            "2"))
    assert exc.value.code == 2
    assert "needs the intersection kernel" in capsys.readouterr().err


def test_cli_geo_shard_matches(tmp_path, capsys, monkeypatch):
    """--geo-shard G renders with the geometry sharded over G of the 8
    virtual devices (nothing O(T) replicated; the kernel interpreted on
    the CPU): G=2 must match G=1 (one geometry shard IS the replicated
    path) u8-exactly on both the one-shot and outputProgress strip
    paths, and the single-device render up to the documented 1-ulp
    primary raygen divergence (knife-edge pixels only)."""
    with monkeypatch.context() as m:
        _interpret_kernel(m)
        img_g1 = _run_mesh(tmp_path, capsys, progress=0,
                           extra_args=("--geo-shard", "1"))
        img_geo = _run_mesh(tmp_path, capsys, progress=0,
                            extra_args=("--geo-shard", "2"))
        img_geo_prog = _run_mesh(tmp_path, capsys, progress=1,
                                 extra_args=("--geo-shard", "2"))
    assert np.unique(img_g1.reshape(-1, 3), axis=0).shape[0] > 1
    np.testing.assert_array_equal(img_g1, img_geo)
    np.testing.assert_array_equal(img_g1, img_geo_prog)
    img_ref = _run_mesh(tmp_path, capsys, progress=0,
                        extra_args=("--no-shard",))
    frac = (np.abs(img_ref.astype(np.int16)
                   - img_geo.astype(np.int16)) > 0).mean()
    assert frac < 0.03, frac

import numpy as np
import pytest

from rendering_jax.models.parser import SceneError, parse_scene
from rendering_jax.models.scene import build_scene


def _write(tmp_path, text):
    p = tmp_path / "s.scene"
    p.write_text(text)
    return str(p)


def test_options_and_camera(tmp_path):
    sd = parse_scene(
        _write(
            tmp_path,
            """
[options]
width=123
height = 45
fov=90
max_ray_depth=3
background_color=0.1,0.2,0.3
position=1,2,3
rotation=10,20,30
useBackfaceCulling=0
image_name=foo/bar

[end]
""",
        )
    )
    st = sd.settings
    assert (st.width, st.height) == (123, 45)
    assert st.fov == 90 and st.max_ray_depth == 3
    assert st.background_color == (0.1, 0.2, 0.3)
    assert not st.use_backface_culling
    assert st.image_name == "foo/bar"
    assert sd.cam_pos == (1, 2, 3) and sd.cam_rot == (10, 20, 30)


def test_comments_and_block_comments(tmp_path):
    sd = parse_scene(
        _write(
            tmp_path,
            """
[options]
width=10   # inline comment
######################
height=20
#[
[light]
type=point
#]
[object]
type=sphere
radius=2
pos=0,0,-5

[end]
""",
        )
    )
    # `#[` skips only until the NEXT bracketed line, which IS processed
    # (reference semantics, scene.cpp:110-116) — so the [light] block
    # that terminated the skip is still parsed.
    assert len(sd.lights) == 1 and sd.lights[0].kind == "point"
    assert len(sd.objects) == 1
    assert sd.objects[0].kind == "sphere" and sd.objects[0].radius == 2


def test_lights_and_materials(tmp_path):
    sd = parse_scene(
        _write(
            tmp_path,
            """
[light]
type=distant
direction=0.4,-0.6,-1
intensity=0.8

[light]
type=area
pos=0,3,0
i=2,0,0
j=0,0,2
samples=4

[object]
type=sphere
pos=0,0,-3
radius=1
material=transparent,1.52

[object]
type=sphere
pos=1,0,-3
radius=1
material=phong,0.4,0.1,0.7,10.0

[end]
""",
        )
    )
    assert sd.lights[0].kind == "distant"
    # direction must stay UNNORMALIZED (parser bypasses ctor normalize)
    assert sd.lights[0].dir == (0.4, -0.6, -1)
    assert sd.lights[1].kind == "area" and sd.lights[1].samples == 4
    assert sd.objects[0].material == "transparent"
    assert sd.objects[0].ior == pytest.approx(1.52)
    o = sd.objects[1]
    assert (o.ambient, o.diffuse, o.specular, o.n_specular) == (0.4, 0.1, 0.7, 10.0)


def test_unknown_block_errors(tmp_path):
    with pytest.raises(SceneError):
        parse_scene(_write(tmp_path, "[bogus]\n"))


def test_plane_normal_unnormalized(tmp_path):
    sd = parse_scene(
        _write(
            tmp_path,
            """
[object]
type=plane
pos=0,0,0
normal=0,2,0

[end]
""",
        )
    )
    scene = build_scene(sd)
    np.testing.assert_allclose(np.asarray(scene.pln_n[0]), [0, 2, 0])


def test_legacy_scene_format_rejected_like_reference():
    """input/smooth_shading.scene uses the reference's LEGACY comma-
    positional line format; the CURRENT reference parser LOG_ERROR-exits
    on it (src/scene.cpp:200-202 hits a '=' -less line). Parity: we must
    raise SceneError, not silently misparse."""
    import os

    import pytest

    from rendering_jax.flagship import REFERENCE_DIR
    from rendering_jax.models.parser import SceneError, parse_scene

    path = os.path.join(REFERENCE_DIR, "input", "smooth_shading.scene")
    if not os.path.exists(path):
        pytest.skip("reference assets not mounted")
    with pytest.raises(SceneError):
        parse_scene(path)


def test_stream_number_semantics():
    """Value parsing matches C++ `stringstream >>` + the util.h:41-67
    error check, pinned against a g++ probe of the reference's own
    helpers (NOT Python float()/int() semantics)."""
    import math

    from rendering_jax.models.parser import _to_float, _to_int

    ok = {
        "1_0": 1.0, "1.5abc": 1.5, "": 0.0, " ": 0.0, "0x1p3": 0.0,
        "0x10": 0.0, "0xg": 0.0, "1e": 0.0, "1e+": 0.0, "1e-": 0.0,
        "1.e": 0.0, ".5": 0.5, "-.5": -0.5, "+3": 3.0, "1e+5": 1e5,
        "1e-3": 1e-3, "1.e2": 100.0, "1.2.3": 1.2, "1..2": 1.0,
        "1x": 1.0, "+.": 0.0, "-": 0.0, ".": 0.0, "3.x": 3.0,
        "1,5": 1.0, "2.5e0abc": 2.5, "+.5": 0.5, "1+2": 1.0,
        "00x1": 0.0, "1e5x": 1e5,
    }
    for s, want in ok.items():
        got = _to_float(s)
        assert got == want and not math.isnan(got), (s, got, want)
    assert math.copysign(1.0, _to_float("-0x2")) == -1.0  # -0.0
    # A failed NON-hex conversion stores +0.0 — the sign does not
    # survive (g++ probe: "-", "-.", "-1e", "-1e+" all give signbit 0,
    # while "-0" converts successfully to -0.0 and hex keeps its sign).
    for s in ("-", "-.", "-1e", "-1e+"):
        assert math.copysign(1.0, _to_float(s)) == 1.0, s
    assert math.copysign(1.0, _to_float("-0")) == -1.0

    for s in ("abc", "inf", "INF", "nan", "+a", "-x", ".x", "1ex",
              "1e+x", "1e-x", "1.ex", "+e5", "e5", "..5", "+-3"):
        with pytest.raises(SceneError):
            _to_float(s)

    assert _to_int("1_0") == 1
    assert _to_int("1.5") == 1
    assert _to_int("") == 0
    assert _to_int("0x10") == 0
    assert _to_int("12junk") == 12
    assert _to_int("-") == 0
    with pytest.raises(SceneError):
        _to_int("abc")


def test_light_position_before_type_errors(tmp_path):
    """`position=` in a [light] block before any `type=`: the reference
    prints the type-missing warning, then nullptr-derefs in its second
    (accidentally split) dispatch chain — we raise SceneError at the
    same point."""
    p = tmp_path / "bad.scene"
    p.write_text(
        "[options]\nwidth=8\nheight=8\n\n[light]\nposition=0,1,0\n[end]\n"
    )
    with pytest.raises(SceneError, match="position"):
        parse_scene(str(p))


def test_sphere_default_center_is_origin(tmp_path):
    """Sphere's ctor defaults center to 0 (objects.h:170), unlike the
    Object base default of 1 that plane and mesh inherit (objects.h:27,
    :184) — a sphere block without pos= must sit at the origin."""
    sd = parse_scene(_write(tmp_path, """
[object]
type=sphere
radius=2

[object]
type=plane
normal=0,1,0

[end]
"""))
    assert sd.objects[0].pos == (0.0, 0.0, 0.0)
    assert sd.objects[1].pos == (1.0, 1.0, 1.0)


def test_vec3_trailing_comma_matches_getline(tmp_path):
    """splitString's getline loop yields exactly 3 cells for '1,2,3,'
    (the final empty cell never materializes, util.h:78-86), so the
    reference accepts a trailing comma; a doubled trailing comma gives
    a 4th empty cell and LOG_ERRORs."""
    sd = parse_scene(_write(tmp_path, """
[options]
position=1,2,3,

[end]
"""))
    assert sd.cam_pos == (1.0, 2.0, 3.0)
    with pytest.raises(SceneError):
        parse_scene(_write(tmp_path, """
[options]
position=1,2,3,,

[end]
"""))


def test_missing_texture_map_errors_like_reference(tmp_path):
    """loadBMP prints 'Could not open .bmp file' and LOG_ERROR-exits on
    a missing map (util.cpp:78-85); silently rendering untextured would
    quietly diverge. useTextures=0 skips the load entirely
    (objects.cpp:398) and must not error."""
    scene_text = """
[object]
type=mesh
size=1,1,1
diffuse_map=does_not_exist.bmp

[end]
"""
    with pytest.raises(SceneError, match="Could not open .bmp file"):
        parse_scene(_write(tmp_path, scene_text))
    sd = parse_scene(_write(tmp_path, "[options]\nuseTextures=0\n" + scene_text))
    assert sd.objects[0].diffuse_map is None


def test_string_values_keep_raw_whitespace(tmp_path):
    """The reference assigns string values RAW (scene.cpp:173:
    `options.imageName = std::string(value)` — the substring after '='
    with whitespace kept), so `image_name= foo` stores " foo". Pinned
    because it looks like a bug: it is parity."""
    sd = parse_scene(_write(tmp_path, """
[options]
image_name= spaced
[end]
"""))
    assert sd.settings.image_name == " spaced"


def test_material_missing_fields_errors(tmp_path):
    """The reference reads res[1..4] unchecked (scene.cpp:273-288) —
    out-of-bounds UB on missing fields. We can't replicate UB; a
    SceneError with the offending line is the framework behavior."""
    for mat in ("material=transparent", "material=phong,1,1,1"):
        with pytest.raises(SceneError):
            parse_scene(_write(tmp_path, f"""
[object]
type=sphere
{mat}
[end]
"""))


def test_skyboxes_trailing_comma_matches_getline(tmp_path):
    """getline-with-delimiter yields NO cell for a trailing delimiter,
    so five names + ',' is five cells in the reference -> LOG_ERROR,
    not five + an empty sixth that later fails to open."""
    with pytest.raises(SceneError):
        parse_scene(_write(tmp_path, """
[options]
skyboxes=a,b,c,d,e,
[end]
"""))


def test_traverse_empty_mesh_respects_flt_max_contract():
    """n_nodes == 0 with a t_limit must still return FLT_MAX on miss
    (callers test t < FLT_MAX as 'hit'; an early return of the clamped
    t_limit would fabricate a phantom hit at exactly the limit)."""
    import types

    import jax.numpy as jnp

    from rendering_jax.ops.traversal import FLT_MAX, traverse_bvh

    mesh = types.SimpleNamespace(
        node_min=jnp.zeros((0, 3), jnp.float32),
        node_max=jnp.zeros((0, 3), jnp.float32),
        skip=jnp.zeros((0,), jnp.int32),
        leaf_start=jnp.zeros((0,), jnp.int32),
        leaf_count=jnp.zeros((0,), jnp.int32),
        leaf_tris=jnp.zeros((0,), jnp.int32),
        v=jnp.zeros((0, 3, 3), jnp.float32),
        leaf_chunk=8,
    )
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.tile(jnp.asarray([[0, 0, -1]], jnp.float32), (4, 1))
    r = traverse_bvh(mesh, ro, rd, jnp.full((4,), 7.5, jnp.float32))
    assert np.all(np.asarray(r.t) == FLT_MAX)
    assert np.all(np.asarray(r.tri) == -1)

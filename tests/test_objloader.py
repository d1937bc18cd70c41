import numpy as np

from rendering_jax.models.objloader import (
    euler_matrix,
    load_obj,
    load_obj_python,
)


def _write(tmp_path, text):
    p = tmp_path / "m.obj"
    p.write_text(text)
    return str(p)


def test_fan_triangulation_bare_v(tmp_path):
    # 5-gon -> 3 triangles (v0,v1,v2), (v0,v2,v3), (v0,v3,v4)
    path = _write(
        tmp_path,
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\nf 1 2 3 4 5\n",
    )
    m = load_obj(path, size=(2, 2, 2), rot=(0, 0, 0), pos=(0, 0, 0))
    assert m.n_tris == 3
    # flat normals = unnormalized cross product, all three vertices equal
    assert np.allclose(m.n[0, 0], m.n[0, 1]) and np.allclose(m.n[0, 0], m.n[0, 2])
    # no UVs -> zero tangents
    assert np.all(m.tangent == 0)


def test_face_formats(tmp_path):
    base = "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\nvt 1 0\nvt 0 1\n"
    # v//n
    m1 = load_obj(
        _write(tmp_path, base + "f 1//1 2//1 3//1\n"), (1, 1, 1), (0, 0, 0), (0, 0, 0)
    )
    assert m1.n_tris == 1
    # explicit normals preserved (rotated by identity)
    assert np.allclose(m1.n[0, 0], [0, 0, 1])
    assert np.all(m1.uv[0] == 0)
    # v/t/n -> has uv + tangent
    m2 = load_obj(
        _write(tmp_path, base + "f 1/1/1 2/2/1 3/3/1\n"),
        (1, 1, 1), (0, 0, 0), (0, 0, 0),
    )
    assert np.allclose(m2.uv[0], [[0, 0], [1, 0], [0, 1]])
    assert not np.all(m2.tangent == 0)


def test_normalize_fit_and_translate(tmp_path):
    # Mesh spanning [0,2]x[0,1]x[0,1]; size (2,2,2) -> min stretch on x
    # (stretch = 1) so normSize = (2,1,1); centered at pos.
    path = _write(
        tmp_path,
        "v 0 0 0\nv 2 0 0\nv 2 1 0\nv 0 1 1\nf 1 2 3\nf 1 3 4\n",
    )
    m = load_obj(path, size=(2, 2, 2), rot=(0, 0, 0), pos=(5, 0, 0))
    v = m.v.reshape(-1, 3)
    assert v[:, 0].min() == -1 + 5 and v[:, 0].max() == 1 + 5
    assert v[:, 1].min() == -0.5 and v[:, 1].max() == 0.5
    np.testing.assert_allclose(
        m.root_bounds, [[5 - 1, -0.5, -0.5], [5 + 1, 0.5, 0.5]]
    )


def test_rotation_convention():
    # 90deg yaw: the reference's multVecMatrix(mz*my*mx) row-vector
    # convention maps +x -> +z (validated against golden renders with
    # rotated meshes, e.g. shotgun rot=0,100,0).
    r = euler_matrix((0, 90, 0))
    v = np.array([1.0, 0.0, 0.0]) @ r
    np.testing.assert_allclose(v, [0, 0, 1], atol=1e-6)


def test_degenerate_axis_flat_at_zero(tmp_path):
    # floor.obj-style flat mesh AT y=0: vmax is initialized to +FLT_MIN
    # (objects.cpp:229), so range.y = FLT_MIN (not 0!) -> 0/FLT_MIN = 0,
    # NO NaN; x/z stay clean and y snaps to pos.y. Bug-for-bug.
    path = _write(tmp_path, "v -1 0 -1\nv -1 0 1\nv 1 0 1\nf 1 2 3\n")
    m = load_obj(path, size=(2, 2, 2), rot=(0, 0, 0), pos=(0, 3, 0))
    v = m.v.reshape(-1, 3)
    assert np.all(v[:, 1] == 3.0)
    np.testing.assert_allclose(v[:, 0], [-1, -1, 1])


def test_degenerate_axis_nan_propagation(tmp_path):
    # flat mesh at a NONZERO height: range.y == 0 exactly -> 0/0 NaN
    # propagates through the rotation multiply-adds into ALL coords;
    # only y is snapped to pos afterwards (objects.cpp:306-320).
    path = _write(tmp_path, "v -1 5 -1\nv -1 5 1\nv 1 5 1\nf 1 2 3\n")
    m = load_obj(path, size=(2, 2, 2), rot=(0, 0, 0), pos=(0, 3, 0))
    v = m.v.reshape(-1, 3)
    assert np.all(v[:, 1] == 3.0)
    assert np.all(np.isnan(v[:, 0])) and np.all(np.isnan(v[:, 2]))


def test_vertices_after_first_face_stay_raw(tmp_path):
    path = _write(
        tmp_path,
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\nv 7 8 9\nv 7 9 8\nv 9 7 8\nf 4 5 6\n",
    )
    m = load_obj(path, size=(1, 1, 1), rot=(0, 0, 0), pos=(0, 0, 0))
    assert m.n_tris == 2
    np.testing.assert_allclose(m.v[1, 0], [7, 8, 9])


def test_interleaved_verts_after_first_face(tmp_path):
    """Verts/normals appearing AFTER the first `f` line stay raw (only
    the first-face snapshot is normalize/rotate/translated,
    objects.cpp:282-331) and later faces may index them. Also pins the
    O(V) buffered append (was O(V^2) per-line concatenate)."""
    p = tmp_path / "inter.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "f 1 2 3\n"
        "v 0.25 0.25 0.5\n"           # raw post-face vertex
        "vn 0 0 1\n"
        "f 1 2 4\n"
    )
    m = load_obj_python(str(p), size=(2, 2, 2), rot=(0, 0, 0), pos=(0, 0, -5))
    assert m.v.shape == (2, 3, 3)
    # Triangle 2's third vertex is the RAW post-face coordinate
    # (untransformed), exactly as the reference leaves it.
    np.testing.assert_allclose(m.v[1, 2], [0.25, 0.25, 0.5], atol=1e-6)

"""Native C++ runtime parity: the ctypes fast paths must produce
BIT-IDENTICAL float32 results to the Python implementations on the
bundled reference assets (the contract that lets them interchange
freely under the renderer)."""

import os

import numpy as np
import pytest

from rendering_jax.accel.bvh import build_bvh_python
from rendering_jax.flagship import REFERENCE_DIR
from rendering_jax.models.objloader import euler_matrix, load_obj_python
from rendering_jax.native import build_bvh_native, get_lib, load_obj_native

OBJS = os.path.join(REFERENCE_DIR, "input", "objects")

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native library not built"
)

CASES = [
    ("teapot.obj", (2, 2, 2), (0, 30, 0), (0, 0, -4)),
    ("bunny.obj", (2, 2, 2), (0, 160, 0), (0, 0, -3)),
    ("cow.obj", (2.5, 2.5, 2.5), (10, 140, 0), (0, 0, -3.5)),
    ("shotgun.obj", (2, 2, 2), (0, 100, 0), (-0.1, 0, -0.6)),
    ("icosahedron.obj", (1.5, 1.5, 1.5), (0, 20, 10), (0, 0, -3)),
    ("sphere.obj", (2, 2, 2), (0, 0, 0), (0, 0, -3)),
    ("floor.obj", (2, 2, 2), (0, 0, 0), (0, 3, 0)),
]


@pytest.mark.parametrize("name,size,rot,pos", CASES)
def test_obj_loader_parity(name, size, rot, pos):
    path = os.path.join(OBJS, name)
    if not os.path.exists(path):
        pytest.skip("reference assets unavailable")
    py = load_obj_python(path, size, rot, pos)
    nat = load_obj_native(
        path, np.asarray(size, np.float32), euler_matrix(rot),
        np.asarray(pos, np.float32), 0.0001,
    )
    assert nat is not None
    v, n, uv, tangent, bitangent, bounds = nat
    assert v.shape == py.v.shape
    np.testing.assert_array_equal(v, py.v)
    np.testing.assert_array_equal(n, py.n)
    np.testing.assert_array_equal(uv, py.uv)
    np.testing.assert_array_equal(tangent, py.tangent)
    np.testing.assert_array_equal(bitangent, py.bitangent)
    np.testing.assert_array_equal(bounds, py.root_bounds)


@pytest.mark.parametrize("penalty,chunk", [(1, 8), (3, 8), (2, 4)])
def test_bvh_builder_parity(penalty, chunk):
    path = os.path.join(OBJS, "teapot.obj")
    if not os.path.exists(path):
        pytest.skip("reference assets unavailable")
    m = load_obj_python(path, (2, 2, 2), (0, 30, 0), (0, 0, -4))
    py = build_bvh_python(m.v, m.root_bounds, penalty, chunk)
    nat = build_bvh_native(m.v, m.root_bounds, penalty, chunk)
    assert nat is not None
    np.testing.assert_array_equal(nat["node_min"], py.node_min)
    np.testing.assert_array_equal(nat["node_max"], py.node_max)
    np.testing.assert_array_equal(nat["skip"], py.skip)
    np.testing.assert_array_equal(nat["leaf_start"], py.leaf_start)
    np.testing.assert_array_equal(nat["leaf_count"], py.leaf_count)
    np.testing.assert_array_equal(nat["real_flag"], py.real_flag)
    np.testing.assert_array_equal(nat["leaf_tris"], py.leaf_tris)
    np.testing.assert_array_equal(nat["reach_lo"], py.reach_lo)
    np.testing.assert_array_equal(nat["reach_hi"], py.reach_hi)
    assert nat["n_real_nodes"] == py.n_real_nodes
    assert nat["tri_copies"] == py.tri_copies


def test_native_speedup_smoke():
    """Native must at least not be slower on a real asset (it is
    typically 10-100x faster; this is a smoke check, not a benchmark)."""
    import time

    path = os.path.join(OBJS, "cow.obj")
    if not os.path.exists(path):
        pytest.skip("reference assets unavailable")
    t0 = time.perf_counter()
    m = load_obj_python(path, (2, 2, 2), (0, 0, 0), (0, 0, -3))
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_obj_native(
        path, np.ones(3, np.float32) * 2, euler_matrix((0, 0, 0)),
        np.asarray([0, 0, -3], np.float32), 0.0001,
    )
    t_nat = time.perf_counter() - t0
    assert t_nat < t_py * 2, (t_nat, t_py)


def _write(tmp_path, text):
    p = tmp_path / "edge.obj"
    p.write_text(text)
    return str(p)


def test_native_rejects_malformed_face_token(tmp_path):
    """'f 1 2 x': the Python loader raises ValueError (int('x'));
    the native loader must return None (strtoll would not advance —
    the old code looped forever growing the index vector)."""
    path = _write(
        tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n"
    )
    assert load_obj_native(
        path, np.ones(3, np.float32), np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32), 1e-4,
    ) is None
    with pytest.raises(ValueError):
        load_obj_python(path, (1, 1, 1), (0, 0, 0), (0, 0, 0))
    # Same for a non-numeric field in the v/t/n format.
    path2 = _write(
        tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1/x/1 2/1/1 3/1/1\n"
    )
    assert load_obj_native(
        path2, np.ones(3, np.float32), np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32), 1e-4,
    ) is None


def test_native_negative_indices_match_python(tmp_path):
    """OBJ relative (negative) indices: the Python loader's numpy
    gather wraps them; the native loader must produce the identical
    mesh instead of an out-of-bounds read."""
    # Note the Python loader subtracts 1 BEFORE the numpy gather, so
    # its accepted "negative" range is tokens in [-(len-1), 0]:
    # token 0 -> index -1 (last vertex), token -3 -> index -4 (first).
    path = _write(
        tmp_path,
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 0 -1 -2\nf 2 3 4\n",
    )
    py = load_obj_python(path, (2, 2, 2), (0, 0, 0), (0, 0, 0))
    nat = load_obj_native(
        path, np.asarray((2, 2, 2), np.float32),
        euler_matrix((0, 0, 0)), np.zeros(3, np.float32), 1e-4,
    )
    assert nat is not None
    v, n, uv, tangent, bitangent, bounds = nat
    np.testing.assert_array_equal(py.v, v)
    np.testing.assert_array_equal(py.n, n)
    # An index beyond [-len, len) fails on both sides.
    bad = _write(
        tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9\n"
    )
    assert load_obj_native(
        bad, np.ones(3, np.float32), np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32), 1e-4,
    ) is None
    with pytest.raises(IndexError):
        load_obj_python(bad, (1, 1, 1), (0, 0, 0), (0, 0, 0))


def test_native_leading_whitespace_lines_match_python(tmp_path):
    """'  v 1 2 3' (indented statements): split() parses them in
    Python; the native header scan must not drop them (the old
    line+strlen(head) offset landed inside the leading spaces)."""
    path = _write(
        tmp_path,
        "  v 0 0 0\n\tv 1 0 0\n v 0 1 0\n  f 1 2 3\n",
    )
    py = load_obj_python(path, (2, 2, 2), (0, 0, 0), (0, 0, 0))
    nat = load_obj_native(
        path, np.asarray((2, 2, 2), np.float32),
        euler_matrix((0, 0, 0)), np.zeros(3, np.float32), 1e-4,
    )
    assert nat is not None
    assert py.n_tris == 1
    np.testing.assert_array_equal(py.v, nat[0])


def test_native_empty_trailing_fields_match_python(tmp_path):
    """'f 1// 2// 3//' — empty uv/normal fields with the token ending
    in slashes. A strtoll walk that skips whitespace mid-field reads
    the NEXT token's vertex index as this token's normal index and
    silently emits zero triangles; the Python loader emits one flat
    triangle. Both sides must agree."""
    path = _write(
        tmp_path,
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1// 2// 3//\n",
    )
    py = load_obj_python(path, (2, 2, 2), (0, 0, 0), (0, 0, 0))
    nat = load_obj_native(
        path, np.asarray((2, 2, 2), np.float32),
        euler_matrix((0, 0, 0)), np.zeros(3, np.float32), 1e-4,
    )
    assert nat is not None
    assert py.v.shape[0] == 1  # one flat-shaded triangle
    np.testing.assert_array_equal(py.v, nat[0])
    np.testing.assert_array_equal(py.n, nat[1])


@pytest.mark.parametrize("vline", ["v 1 2", "v 1 2 3x", "vn 1 2",
                                   "vt 0.5", "v nan(1) 0 0"])
def test_native_malformed_vertex_lines_error_like_python(tmp_path, vline):
    """Malformed v/vn/vt lines raise in the Python loader; the native
    loader must signal a parse error (None -> the dispatch falls back
    to Python, which re-raises) instead of silently dropping the line
    and shifting every later face index."""
    path = _write(tmp_path, f"{vline}\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(Exception):
        load_obj_python(path, (1, 1, 1), (0, 0, 0), (0, 0, 0))
    assert load_obj_native(
        path, np.ones(3, np.float32), np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32), 1e-4,
    ) is None

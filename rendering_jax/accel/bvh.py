"""SAH BVH — host-side build, flattened for lockstep traversal.

Build replicates `AccelerationStructure::{setup,calculateSAH,
binarySearchSAH,getOptimalSplit}` (src/objects.cpp:461-763) exactly:

* split along the longest axis of the node bounds (objects.cpp:486-490);
* split plane found by recursive binary search on the SAH cost
  `NL*(split-min) + NR*(max-split)` probing at +-0.05 and stopping when
  the interval is < 0.1 (objects.cpp:633-689), float32 arithmetic;
* triangles whose vertices span the plane go into BOTH children
  (duplication, objects.cpp:737-760);
* leaf when `n_tris <= depth * ac_penalty` (objects.cpp:477) or the
  split is degenerate / duplicates >= 1.5x (objects.cpp:498).

The tree is then flattened DFS left-first into a THREADED layout: a ray
walks nodes in array order; on AABB hit it advances to `i+1`, on miss it
jumps to `skip[i]` (the index just past node i's subtree). Leaves are
chunked to at most `leaf_chunk` triangles so the traversal loop tests a
fixed-size, maskable triangle block per step — this is what makes the
lockstep jnp/Pallas traversal shape-static. Left-first order preserves
the reference's tie-breaking (left subtree checked first with strict <,
objects.cpp:605-619).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

F32 = np.float32
FLT_MAX = np.float32(np.finfo(np.float32).max)


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray    # (N, 3) f32
    node_max: np.ndarray    # (N, 3) f32
    skip: np.ndarray        # (N,) i32 — jump target on AABB miss
    leaf_start: np.ndarray  # (N,) i32 — offset into leaf_tris
    leaf_count: np.ndarray  # (N,) i32 — 0 for inner nodes, <= leaf_chunk
    real_flag: np.ndarray   # (N,) i32 — 1 for the first flat node of each
    #                         reference AC node (for showAC counting)
    leaf_tris: np.ndarray   # (L,) i32 — triangle ids, duplicated like the ref
    n_real_nodes: int
    tri_copies: int         # stats::triCopiesCount equivalent
    leaf_chunk: int
    # Per-triangle REACH box: the AABB of the union of all leaf boxes
    # containing the triangle. The reference can only discover a
    # triangle through rays crossing one of those leaves (leaf boxes
    # partition the clipped root box, objects.cpp:328-330 + 737-760);
    # dense intersection uses this to replicate the clipping.
    reach_lo: np.ndarray = None  # (T, 3) f32
    reach_hi: np.ndarray = None  # (T, 3) f32

    @property
    def n_nodes(self) -> int:
        return int(self.node_min.shape[0])


def _calculate_sah(axis, tmin, tmax, idx, b0, b1, boundary):
    # objects.cpp:633-674: left = any vertex <= boundary (i.e. the tri's
    # min coord <= boundary), right = any vertex >= boundary.
    n_left = int(np.count_nonzero(tmin[idx, axis] <= boundary))
    n_right = int(np.count_nonzero(tmax[idx, axis] >= boundary))
    return F32(n_left * (boundary - b0) + n_right * (b1 - boundary))


def _binary_search_sah(axis, tmin, tmax, idx, b0, b1, left, right):
    # objects.cpp:676-689 — float32 arithmetic, recursion unrolled.
    left = F32(left)
    right = F32(right)
    while True:
        mid = F32(right - F32(right - left) / F32(2))
        if F32(right - left) < F32(0.1):
            return mid
        if _calculate_sah(axis, tmin, tmax, idx, b0, b1, F32(mid - F32(0.05))) < \
           _calculate_sah(axis, tmin, tmax, idx, b0, b1, F32(mid + F32(0.05))):
            right = mid
        else:
            left = mid


class _Node:
    __slots__ = ("bounds_min", "bounds_max", "tris", "left", "right")

    def __init__(self, bmin, bmax):
        self.bounds_min = np.asarray(bmin, dtype=F32)
        self.bounds_max = np.asarray(bmax, dtype=F32)
        self.tris: np.ndarray | None = None
        self.left: "_Node | None" = None
        self.right: "_Node | None" = None


def build_bvh(
    tri_v: np.ndarray,
    root_bounds: np.ndarray,
    ac_penalty: int = 1,
    leaf_chunk: int = 8,
) -> FlatBVH:
    """Build + flatten — native C++ builder when available (bit-identical
    contract, tests/test_native.py), else pure Python. `tri_v` is
    (T, 3, 3); `root_bounds` is (2, 3) — the bounds the reference
    computes at OBJ load (objects.cpp:328-330), NOT a recomputed tight
    AABB."""
    try:
        from rendering_jax.native import build_bvh_native
    except (ImportError, OSError):
        # Native library absent or unloadable: the Python builder is
        # the documented fallback. A native builder that loads but
        # FAILS mid-build propagates — silently swapping builders
        # there would mask a bit-contract violation.
        return build_bvh_python(tri_v, root_bounds, ac_penalty, leaf_chunk)
    d = build_bvh_native(tri_v, root_bounds, ac_penalty, leaf_chunk)
    if d is not None:
        return FlatBVH(**d)
    return build_bvh_python(tri_v, root_bounds, ac_penalty, leaf_chunk)


def build_bvh_python(
    tri_v: np.ndarray,
    root_bounds: np.ndarray,
    ac_penalty: int = 1,
    leaf_chunk: int = 8,
) -> FlatBVH:
    t_count = int(tri_v.shape[0])
    tmin = tri_v.min(axis=1).astype(F32)  # (T, 3) per-tri min coords
    tmax = tri_v.max(axis=1).astype(F32)

    stats = {"real_nodes": 1, "tri_copies": 0}
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))

    root = _Node(root_bounds[0], root_bounds[1])

    def setup(node: _Node, idx: np.ndarray, depth: int) -> None:
        if idx.size <= depth * ac_penalty:
            node.tris = idx
            stats["tri_copies"] += int(idx.size)
            return
        dim = node.bounds_max - node.bounds_min
        if dim[0] > dim[1] and dim[0] > dim[2]:
            axis = 0
        elif dim[1] > dim[2]:
            axis = 1
        else:
            axis = 2
        b0 = F32(node.bounds_min[axis])
        b1 = F32(node.bounds_max[axis])
        split = _binary_search_sah(axis, tmin, tmax, idx, b0, b1, b0, b1)
        left_idx = idx[tmin[idx, axis] <= split]
        right_idx = idx[tmax[idx, axis] >= split]
        if (
            left_idx.size == 0
            or right_idx.size == 0
            or left_idx.size + right_idx.size >= idx.size * 1.5
        ):
            node.tris = idx
            stats["tri_copies"] += int(idx.size)
            return
        lmax = node.bounds_max.copy()
        lmax[axis] = split
        rmin = node.bounds_min.copy()
        rmin[axis] = split
        node.left = _Node(node.bounds_min, lmax)
        node.right = _Node(rmin, node.bounds_max)
        stats["real_nodes"] += 2
        setup(node.right, right_idx, depth + 1)
        setup(node.left, left_idx, depth + 1)

    if t_count > 0:
        setup(root, np.arange(t_count, dtype=np.int64), 1)
    else:
        root.tris = np.zeros((0,), dtype=np.int64)

    # ---- flatten DFS left-first with chunked leaves ----
    node_min: list = []
    node_max: list = []
    leaf_start: list = []
    leaf_count: list = []
    real_flag: list = []
    leaf_tris: list = []
    skip: list = []

    reach_lo = np.full((t_count, 3), FLT_MAX, F32)
    reach_hi = np.full((t_count, 3), -FLT_MAX, F32)

    def emit(node: _Node) -> None:
        if node.tris is not None:
            tris = node.tris
            if tris.size:
                np.minimum.at(reach_lo, tris, node.bounds_min[None, :])
                np.maximum.at(reach_hi, tris, node.bounds_max[None, :])
            n_chunks = max(1, -(-tris.size // leaf_chunk))
            for c in range(n_chunks):
                chunk = tris[c * leaf_chunk : (c + 1) * leaf_chunk]
                i = len(node_min)
                node_min.append(node.bounds_min)
                node_max.append(node.bounds_max)
                leaf_start.append(len(leaf_tris))
                leaf_count.append(int(chunk.size))
                real_flag.append(1 if c == 0 else 0)
                leaf_tris.extend(int(t) for t in chunk)
                skip.append(-1)  # patched below
            first = len(node_min) - n_chunks
            after = len(node_min)
            for i in range(first, after):
                skip[i] = after  # a box miss skips every chunk of the leaf
        else:
            i = len(node_min)
            node_min.append(node.bounds_min)
            node_max.append(node.bounds_max)
            leaf_start.append(0)
            leaf_count.append(0)
            real_flag.append(1)
            skip.append(-1)
            emit(node.left)
            emit(node.right)
            skip[i] = len(node_min)

    emit(root)

    n = len(node_min)
    pad = leaf_chunk  # trailing pad so fixed-K gathers never run off the end
    leaf_tris_arr = np.zeros(len(leaf_tris) + pad, dtype=np.int32)
    if leaf_tris:
        leaf_tris_arr[: len(leaf_tris)] = np.asarray(leaf_tris, dtype=np.int32)

    return FlatBVH(
        node_min=np.stack(node_min).astype(F32) if n else np.zeros((0, 3), F32),
        node_max=np.stack(node_max).astype(F32) if n else np.zeros((0, 3), F32),
        skip=np.asarray(skip, dtype=np.int32),
        leaf_start=np.asarray(leaf_start, dtype=np.int32),
        leaf_count=np.asarray(leaf_count, dtype=np.int32),
        real_flag=np.asarray(real_flag, dtype=np.int32),
        leaf_tris=leaf_tris_arr,
        n_real_nodes=stats["real_nodes"],
        tri_copies=stats["tri_copies"],
        leaf_chunk=leaf_chunk,
        reach_lo=reach_lo,
        reach_hi=reach_hi,
    )


def morton_order(tri_v: np.ndarray) -> np.ndarray:
    """Spatial (Morton/Z-curve) triangle permutation by centroid.

    Consecutive triangles in this order are spatially adjacent, so the
    fixed-size chunks the dense intersection kernel processes get tight
    AABBs — the SPMD analogue of BVH leaf locality (the reference gets
    the same effect from its SAH partition, src/objects.cpp:676-760).
    build_scene applies this permutation PERMANENTLY at scene build
    (models/scene.py: v/n/uv/tangent/bitangent are stored Morton-
    ordered, morton_perm=None): triangle/hit ids everywhere downstream
    are Morton-order ids, not OBJ emit-order ids. Hand-built meshes may
    instead keep load order and pass the permutation via
    MeshData.morton_perm, in which case the kernel remaps hit ids back.
    Only equal-t tie-breaks can differ between the two conventions.
    """
    t_count = len(tri_v)
    if t_count == 0:
        return np.zeros((0,), np.int32)
    cent = (tri_v.min(axis=1) + tri_v.max(axis=1)) * 0.5
    lo = cent.min(axis=0)
    span = cent.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    q = ((cent - lo) / span * 1023.0).astype(np.uint32)
    q = np.minimum(q, 1023)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x0C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x249249249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (
        spread(q[:, 1]) << np.uint64(1)
    ) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)

"""Synthesize deterministic texture/normal/specular map BMPs.

The reference repo's shotgun scene references `shotgun_*.bmp` maps that
are NOT shipped (SURVEY section 2, scene/asset inventory). To test the
full texture stack we synthesize small deterministic maps used
IDENTICALLY by the C++ golden generator and our renderer. Committed
under tests/assets/maps/.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from rendering_jax.utils.bmp import encode_bmp  # noqa: E402

SIZE = 64


def _grid():
    y, x = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    return x, y


def diffuse_map(phase: int) -> np.ndarray:
    x, y = _grid()
    r = ((x * 4 + phase * 37) % 256).astype(np.uint8)
    g = ((y * 4 + phase * 11) % 256).astype(np.uint8)
    b = (((x // 8 + y // 8) % 2) * 200 + 30).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def normal_map(phase: int) -> np.ndarray:
    x, y = _grid()
    # Gentle sinusoidal bumps around the flat tangent normal (128,128,255).
    nx = (128 + 40 * np.sin((x + phase) * 0.4)).astype(np.uint8)
    ny = (128 + 40 * np.cos((y + phase) * 0.4)).astype(np.uint8)
    nz = np.full((SIZE, SIZE), 230, np.uint8)
    return np.stack([nx, ny, nz], axis=-1)


def specular_map(phase: int) -> np.ndarray:
    x, y = _grid()
    v = ((x * 2 + y * 2 + phase * 53) % 256).astype(np.uint8)
    return np.stack([v, v, v], axis=-1)


def write_all(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, phase in (("cow", 0), ("shotgun", 1)):
        for kind, fn in (
            ("diffuse", diffuse_map),
            ("normal", normal_map),
            ("specular", specular_map),
        ):
            path = os.path.join(out_dir, f"{name}_{kind}.bmp")
            with open(path, "wb") as fh:
                fh.write(encode_bmp(fn(phase)))
            print("wrote", path)


if __name__ == "__main__":
    write_all(sys.argv[1] if len(sys.argv) > 1 else "tests/assets/maps")

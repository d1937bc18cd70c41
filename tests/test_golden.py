"""Golden-parity tests: our render vs the C++ reference's BMP output.

Goldens are committed (tests/goldens/*.bmp), generated once by
tools/gen_goldens.py from the reference binary. Comparison is on the
reference's own quantization (see utils.bmp.quantize_reference).

Tolerances: float32 op-ordering/FMA differences between g++ scalar code
and XLA flip hit/miss at grazing silhouettes and shift u8 values by 1 at
rounding boundaries. We assert:
  * the overwhelming majority of interior pixels match within 1 u8 step;
  * large diffs are confined to a silhouette-sized pixel fraction.
The 1px image border is excluded: the reference's sobelBuffer borders
are uninitialized memory (scene.cpp:545 + 554-567 loop bounds).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from rendering_jax.models.scene import load_scene
from rendering_jax.models.settings import RenderSettings
from rendering_jax.render.pipeline import render
from rendering_jax.utils.bmp import bmp_to_image, load_bmp, quantize_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = [
    "t01_simple_shapes",
    "t02_teapot_diffuse",
    "t03_cow_textured",
    "t04_skybox",
    "t05_area",
    "t06_backface_off",
    "t07_no_ac",
    "t08_shownormals",
    "t09_showac",
    "t10_shotgun",
    "t11_sphere_smooth",
    "t12_bunny_multi",
    # Full-size reflective_refractive workload (the reference's
    # input/reflective_refractive.scene at its default 800x600, depth
    # 10, SSAA on — input/skybox1 path mismatch resolved to the shipped
    # skybox/ dir like the reduced t04). The 2^depth transparent tree
    # at full depth is exactly where the weight-sorted queue compaction
    # could diverge; the paths_dropped assertion below proves no
    # continuation was dropped.
    "t13_reflective_full",
]

# (frac of interior pixels with u8 diff > 1, frac with diff > 8,
#  frac of neighborhood-tolerant violations). The violation budget
# covers the dense path's reach-box approximation of the reference's
# root-box clipping on rotated meshes (isolated mesh-edge pixels).
DEFAULT_TOL = (0.006, 0.005, 0.001)

# Per-scene budgets: <= 1.5x the fractions measured against the
# committed goldens in round 4 (CPU and device runs agreed to ~1e-5;
# floors of 5e-5 absorb platform jitter on the scenes that currently
# match exactly) — so a localized shading bug cannot hide inside a blanket
# silhouette allowance (round-3 review point; the round-1 point about
# blanket budgets applies a fortiori).
SCENE_TOL = {
    "t01_simple_shapes":  (0.00045, 0.00040, 0.00005),
    "t02_teapot_diffuse": (0.00062, 0.00062, 0.00013),
    "t03_cow_textured":   (0.00028, 0.00024, 0.00005),
    "t04_skybox":         (0.00005, 0.00005, 0.00005),
    "t05_area":           (0.00005, 0.00005, 0.00005),
    "t06_backface_off":   (0.00070, 0.00055, 0.00005),
    "t07_no_ac":          (0.00005, 0.00005, 0.00005),
    "t08_shownormals":    (0.00032, 0.00026, 0.00012),
    "t09_showac":         (0.00500, 0.00057, 0.00033),
    "t10_shotgun":        (0.00140, 0.00140, 0.00086),
    "t11_sphere_smooth":  (0.00593, 0.00500, 0.00057),
    "t12_bunny_multi":    (0.00240, 0.00220, 0.00051),
    "t13_reflective_full": (0.00005, 0.00005, 0.00005),
}

# Mean-absolute-diff ceilings (u8 steps over interior pixels), <= 1.5x
# measured with a 0.002 floor: bounds the TOTAL deviation so even a
# sub-threshold-fraction bug with large magnitude fails.
SCENE_MAD = {
    "t01_simple_shapes":  0.048,
    "t02_teapot_diffuse": 0.037,
    "t03_cow_textured":   0.014,
    "t04_skybox":         0.002,
    "t05_area":           0.002,
    "t06_backface_off":   0.014,
    "t07_no_ac":          0.002,
    "t08_shownormals":    0.017,
    "t09_showac":         0.026,
    "t10_shotgun":        0.124,
    "t11_sphere_smooth":  0.144,
    "t12_bunny_multi":    0.096,
    "t13_reflective_full": 0.002,
}


def _pool3(img, op):
    """3x3 max/min pooling via shifted stacking (no scipy needed)."""
    h, w = img.shape[:2]
    pads = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            pads.append(
                np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")[
                    1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w
                ]
            )
    return op(np.stack(pads), axis=0)


def neighborhood_violations(ours, gold, tol=2):
    """A pixel is OK if it lies within [min, max] of the golden's 3x3
    neighborhood +- tol. This forgives one-pixel silhouette/shadow-edge
    flips caused by float op-ordering (XLA FMA vs the reference's SSE2
    scalar code) while still catching any real shading difference."""
    gmax = _pool3(gold.astype(np.int16), np.max)
    gmin = _pool3(gold.astype(np.int16), np.min)
    o = ours.astype(np.int16)
    ok = (o <= gmax + tol) & (o >= gmin - tol)
    return ~ok.all(axis=2)


@pytest.mark.golden
@pytest.mark.slow
@pytest.mark.parametrize("name", SCENES)
def test_golden(name, in_workspace):
    scene = load_scene(f"{name}.scene", RenderSettings(ssaa_capacity_fraction=1.0))
    frame, _aux = render(scene)
    # No golden scene may drop a transparent continuation (queue
    # capacity = ray count; the reference's recursion never drops).
    assert float(_aux["stats"]["paths_dropped"]) == 0.0, name
    ours = quantize_reference(frame)
    gold = bmp_to_image(load_bmp(os.path.join(REPO, "tests", "goldens", f"{name}.bmp")))
    assert ours.shape == gold.shape
    diff = np.abs(ours.astype(np.int16) - gold.astype(np.int16))
    inner = diff[1:-1, 1:-1]
    frac_gt1 = float((inner > 1).mean())
    frac_gt8 = float((inner > 8).mean())
    viol = neighborhood_violations(ours, gold)[1:-1, 1:-1]
    frac_viol = float(viol.mean())
    tol1, tol8, tolv = SCENE_TOL.get(name, DEFAULT_TOL)
    assert frac_gt1 <= tol1, f"{name}: {frac_gt1:.4%} interior pixels differ >1"
    assert frac_gt8 <= tol8, f"{name}: {frac_gt8:.4%} interior pixels differ >8"
    assert frac_viol <= tolv, (
        f"{name}: {frac_viol:.4%} interior pixels outside golden 3x3 envelope"
    )
    mad = float(inner.mean())
    mad_tol = SCENE_MAD.get(name, 0.15)
    assert mad <= mad_tol, (
        f"{name}: interior mean |diff| {mad:.4f} u8 steps > {mad_tol}"
    )

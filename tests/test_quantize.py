"""Device-side u8 quantization (pipeline.quantize_u8) must be
bit-identical to the host BMP writer's quantizer
(utils.bmp.quantize_reference — the reference's
`static_cast<char>(clamp(0,1,f) * 255)`, src/util.cpp:50), so a CLI
that pulls u8 frames writes byte-for-byte the same BMP as one that
pulls f32 frames and quantizes host-side."""

import jax.numpy as jnp
import numpy as np
import pytest

from rendering_jax.render.pipeline import quantize_u8, render
from rendering_jax.utils.bmp import encode_bmp, quantize_reference


def test_quantize_u8_matches_reference_quantizer():
    # Dense sweep plus the exact edge cases: negatives, 0, every u8
    # code boundary k/255 and its f32 neighbors, values just below and
    # at 1.0 (the saturate-to-127 quirk), and >1 overshoots (specular
    # highlights routinely exceed 1.0 before the clamp).
    ks = np.arange(256, dtype=np.float32)
    vals = np.concatenate([
        np.linspace(-0.25, 1.25, 4001, dtype=np.float32),
        ks / np.float32(255.0),
        np.nextafter(ks / np.float32(255.0), np.float32(-1.0)),
        np.nextafter(ks / np.float32(255.0), np.float32(2.0)),
        np.float32([0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0)),
                    np.nextafter(np.float32(1.0), np.float32(2.0)),
                    2.0, 1e30, -1e30]),
    ]).astype(np.float32)
    # Shape into a (3, H, W) frame.
    pad = (-len(vals)) % (3 * 16)
    frame3 = np.pad(vals, (0, pad)).reshape(3, 16, -1)

    expect = quantize_reference(frame3.transpose(1, 2, 0))
    got = np.asarray(quantize_u8(jnp.asarray(frame3)))
    np.testing.assert_array_equal(got, expect)


@pytest.mark.slow
def test_render_out_u8_matches_host_quantized_bmp(in_workspace):
    """render(out_u8=True) -> encode_bmp must produce the same bytes as
    the f32 render quantized host-side (the golden-test path)."""
    import dataclasses

    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings

    scene = load_scene(
        "t01_simple_shapes.scene",
        RenderSettings(ssaa_capacity_fraction=1.0),
    )
    st = scene.static
    scene = dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(width=64, height=48)
        ),
    )
    f32_frame, _ = render(scene)
    u8_frame, _ = render(scene, out_u8=True)
    assert u8_frame.dtype == np.uint8
    assert u8_frame.shape == f32_frame.shape
    assert encode_bmp(u8_frame) == encode_bmp(f32_frame)


@pytest.mark.slow
def test_render_sharded_out_u8_matches(in_workspace):
    import dataclasses

    from rendering_jax.models.scene import load_scene
    from rendering_jax.models.settings import RenderSettings
    from rendering_jax.parallel.shard import make_ray_mesh, render_sharded

    scene = load_scene(
        "t01_simple_shapes.scene",
        RenderSettings(ssaa_capacity_fraction=1.0),
    )
    st = scene.static
    scene = dataclasses.replace(
        scene,
        static=dataclasses.replace(
            st, settings=st.settings.replace(width=64, height=48)
        ),
    )
    mesh = make_ray_mesh()
    f32_frame, _ = render_sharded(scene, mesh)
    u8_frame, _ = render_sharded(scene, mesh, out_u8=True)
    assert u8_frame.dtype == np.uint8
    assert encode_bmp(u8_frame) == encode_bmp(f32_frame)

import jax.numpy as jnp
import numpy as np

from rendering_jax.ops.skybox import sample_skybox


def _box(h=4, w=4):
    # face f has constant color (f/10, 0, 0)
    sb = np.zeros((6, h, w, 3), np.float32)
    for f in range(6):
        sb[f, :, :, 0] = f / 10.0
    return jnp.asarray(sb)


def test_face_selection():
    sb = _box()
    # key order: 0=left(x<0) 1=front(z<0) 2=right(x>0) 3=back(z>0)
    #            4=top(y>0) 5=bottom(y<0)   (scene.cpp:398-439)
    dirs = jnp.asarray(
        np.array(
            [
                [-1, 0, 0], [0, 0, -1], [1, 0, 0],
                [0, 0, 1], [0, 1, 0], [0, -1, 0],
            ],
            np.float32,
        )
    )
    got = np.asarray(sample_skybox(sb, dirs, jnp.zeros(3)))[:, 0]
    np.testing.assert_allclose(got, [0.0, 0.1, 0.2, 0.3, 0.4, 0.5])


def test_tie_order_z_first_then_x():
    sb = _box()
    # |x| == |z|: the reference's ladder checks z first
    d = jnp.asarray(np.array([[1, 0, -1]], np.float32) / np.sqrt(2))
    assert np.isclose(float(sample_skybox(sb, d, jnp.zeros(3))[0, 0]), 0.1)  # front
    # |x| == |y|: x before y
    d2 = jnp.asarray(np.array([[1, 1, 0]], np.float32) / np.sqrt(2))
    assert np.isclose(float(sample_skybox(sb, d2, jnp.zeros(3))[0, 0]), 0.2)  # right


def test_texel_lookup():
    h, w = 4, 8
    sb = np.zeros((6, h, w, 3), np.float32)
    sb[1, :, :, 1] = np.arange(w)[None, :] / 10.0   # column id in G
    sb[1, :, :, 2] = np.arange(h)[:, None] / 10.0   # row id in B
    sb = jnp.asarray(sb)
    # straight -z: adir=(0,0,-1) -> i=toPixel(0,h)=2, j=toPixel(0,w)=4
    d = jnp.asarray(np.array([[0, 0, -1]], np.float32))
    px = np.asarray(sample_skybox(sb, d, jnp.zeros(3)))[0]
    assert px[1] == 0.4 and px[2] == 0.2
    # up-right into front face
    d2 = jnp.asarray(np.array([[0.5, 0.9, -1.0]], np.float32))
    px2 = np.asarray(sample_skybox(sb, d2, jnp.zeros(3)))[0]
    assert px2[1] == 0.6  # j = toPixel(0.5, 8) = 6
    assert px2[2] == 0.3  # i = toPixel(0.9, 4) = 3


def test_no_skybox_returns_background():
    d = jnp.asarray(np.array([[0, 0, -1]], np.float32))
    got = np.asarray(sample_skybox(None, d, jnp.asarray([0.1, 0.2, 0.3])))
    np.testing.assert_allclose(got[0], [0.1, 0.2, 0.3])

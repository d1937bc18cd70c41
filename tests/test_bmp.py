import numpy as np

from rendering_jax.utils.bmp import (
    bmp_to_image,
    decode_bmp,
    encode_bmp,
    load_bmp,
    quantize_reference,
)


def test_roundtrip_u8():
    img = ((np.arange(12 * 16 * 3).reshape(12, 16, 3) * 7) % 256).astype(np.uint8)
    out = bmp_to_image(decode_bmp(encode_bmp(img)))
    np.testing.assert_array_equal(out, img)


def test_quantize_reference_saturation():
    # g++ -O2 float->signed char: >= 1.0 saturates to 127 (verified
    # against the compiled reference, see utils/bmp.py docstring).
    f = np.array([[[0.0, 0.5, 0.9999], [1.0, 1.5, 0.52]]], np.float32)
    q = quantize_reference(f)
    assert q.tolist() == [[[0, 127, 254], [127, 127, 132]]]


def test_header_layout():
    img = np.zeros((4, 8, 3), np.uint8)
    data = encode_bmp(img)
    assert data[:2] == b"BM"
    assert int.from_bytes(data[18:22], "little") == 8
    assert int.from_bytes(data[22:26], "little") == 4
    assert data[0x1C] == 24
    assert len(data) == 54 + 4 * 8 * 3


def test_decode_ignores_padding_like_reference():
    # width=2 -> 6 bytes/row, real BMP pads to 8; the reference reader
    # (and ours) reads 3*w*h bytes sequentially, shearing the rows.
    h, w = 2, 2
    pad = 2
    header = bytearray(encode_bmp(np.zeros((h, w, 3), np.uint8))[:54])
    rows = bytes([1, 2, 3, 4, 5, 6]) + bytes(pad) + bytes([7, 8, 9, 10, 11, 12]) + bytes(pad)
    arr = decode_bmp(bytes(header) + rows)
    # Sequential read: first 12 bytes = row0 with padding bytes leaking in.
    assert arr.shape == (2, 2, 3)
    flat_bgr = arr[:, :, ::-1].reshape(-1)
    assert flat_bgr.tolist() == [1, 2, 3, 4, 5, 6, 0, 0, 7, 8, 9, 10]


def test_golden_files_never_contain_255(tmp_path):
    # Regression guard for the saturation quirk.
    import glob
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for f in glob.glob(os.path.join(repo, "tests", "goldens", "*.bmp")):
        body = open(f, "rb").read()[54:]
        assert 255 not in body, f


def test_padded_width_file_length_matches_header():
    """width % 4 != 0: the reference declares arraySize =
    h*(w+pad)*3 (util.cpp:29) but assembles rows of w*3+pad bytes —
    the tail it writes is uninitialized heap (UB). Our writer must
    emit exactly the declared length, deterministically (zeros)."""
    import struct

    from rendering_jax.utils.bmp import encode_bmp

    img = np.linspace(0, 1, 7 * 5 * 3, dtype=np.float32).reshape(5, 7, 3)
    raw = encode_bmp(img)
    total = struct.unpack_from("<I", raw, 0x2)[0]
    array_size = struct.unpack_from("<I", raw, 0x22)[0]
    pad = 4 - (7 * 3) % 4
    assert array_size == 5 * (7 + pad) * 3  # reference header math
    assert len(raw) == total == 54 + array_size
    # deterministic tail
    assert raw == encode_bmp(img)

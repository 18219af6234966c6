"""PNG codec (zlib + struct, no imaging library): what save_png writes,
load_png reads back exactly."""

import numpy as np
import pytest

from miniraytracer_tpu.utils import image


@pytest.mark.parametrize("h,w", [(1, 1), (20, 20), (13, 37)])
def test_png_roundtrip_exact(tmp_path, h, w):
    rng = np.random.default_rng(h * 100 + w)
    arr8 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    assert (image.decode_png(image.encode_png(arr8)) == arr8).all()
    frame = rng.uniform(-0.5, 1.5, (h, w, 3)).astype(np.float32)
    path = str(tmp_path / "f.png")
    image.save_png(path, frame)
    back = image.load_png(path)
    want = (np.clip(frame, 0, 1) * 255.99).astype(np.uint8)[::-1]
    assert back.shape == (h, w, 3)
    np.testing.assert_array_equal(back, want)


def test_png_signature_and_crc_checked():
    data = image.encode_png(np.zeros((4, 4, 3), np.uint8))
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError):
        image.decode_png(b"GIF89a" + data[6:])
    bad = bytearray(data)
    bad[40] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError):
        image.decode_png(bytes(bad))


def test_ppm_header_and_flip(tmp_path):
    frame = np.zeros((2, 3, 3), np.float32)
    frame[0] = 1.0  # bottom scanline in the reference layout
    path = tmp_path / "f.ppm"
    image.save_ppm(str(path), frame)
    data = path.read_bytes()
    assert data.startswith(b"P6\n3 2\n255\n")
    px = np.frombuffer(data[len(b"P6\n3 2\n255\n"):], np.uint8).reshape(2, 3, 3)
    assert (px[1] == 255).all() and (px[0] == 0).all()

"""Image output. The reference never writes files (window only); we add PNG
output as the headless equivalent of MRT_DrawToWindow. Row 0 of the
framebuffer is the *bottom* scanline (reference layout, main.cpp:156-157),
so files are written flipped.

The PNG codec is the standard library's `zlib` and `struct`: 8-bit RGB,
one IDAT chunk, filter type 0 on every scanline. `load_png` reads back
exactly what `save_png` writes (it is a reader for these files, not for
PNG in general)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _to_u8(frame, flip: bool):
    arr = np.asarray(frame)
    if flip:
        arr = arr[::-1]
    return (np.clip(arr, 0.0, 1.0) * 255.99).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(arr8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, unfiltered scanlines)."""
    h, w, c = arr8.shape
    assert c == 3 and arr8.dtype == np.uint8, (arr8.shape, arr8.dtype)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by encode_png -> (H, W, 3) uint8."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit RGB non-interlaced PNGs")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        raise ValueError("only unfiltered scanlines")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_png(path: str, frame, flip: bool = True):
    """frame (H,W,3) float in [0,1] -> 8-bit PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(_to_u8(frame, flip)))


def load_png(path: str) -> np.ndarray:
    """Read a PNG written by save_png -> (H, W, 3) uint8, file row order."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_ppm(path: str, frame, flip: bool = True):
    """Dependency-free binary PPM writer."""
    arr8 = _to_u8(frame, flip)
    h, w = arr8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr8.tobytes())

"""io/png.py: the numpy + zlib PNG codec of the Python image path."""

import struct
import zlib

import numpy as np
import pytest

from photobundle_tpu.io import kitti, png


def _encode(img: np.ndarray, ftype: int) -> bytes:
    """Reference encoder: every scanline with filter `ftype` (PNG spec,
    section 9), so the decoder's inverse of each filter is exercised."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = []
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        cur = rows[y]
        a = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        b = prev
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - a
        elif ftype == 2:
            f = cur - b
        elif ftype == 3:
            f = cur - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            f = cur - pred
        out.append(bytes([ftype]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_decodes_every_filter(tmp_path, rng, ftype, channels):
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, ftype))
    np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (20, 31, 3)])
def test_png_round_trip(tmp_path, rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "r.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_gray_conversion_and_loader(tmp_path, rng):
    """RGB converts to luma the usual way (ITU-R 601, rounded), alpha is
    dropped, and the KITTI loader returns the f32 reciprocal-scaled grey."""
    rgb = rng.integers(0, 256, size=(9, 11, 3), dtype=np.uint8)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    want = ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)
    np.testing.assert_array_equal(png.to_gray(rgb), want)
    rgba = np.concatenate([rgb, np.full((9, 11, 1), 7, np.uint8)], axis=2)
    np.testing.assert_array_equal(png.to_gray(rgba), want)
    path = tmp_path / "c.png"
    path.write_bytes(_encode(rgba, 4))
    got = kitti._imread_gray(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32)
                                  * np.float32(1.0 / 255.0))


def test_png_rejects_unsupported(tmp_path):
    body = struct.pack(">IIBBBBB", 4, 4, 16, 0, 0, 0, 0)   # 16-bit grey
    data = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(body)) + b"IHDR"
            + body + b"\0\0\0\0")
    path = tmp_path / "x.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="unsupported"):
        png.read_png(str(path))
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(path))
    with pytest.raises(ValueError):
        png.write_png(str(path), np.zeros((2, 2), np.float32))

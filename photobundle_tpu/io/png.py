"""8-bit PNG codec on numpy + zlib (no imaging library needed).

Reads non-interlaced 8-bit grey, grey+alpha, RGB and RGBA images with any
of the five scanline filters; writes 8-bit grey or RGB with filter 0. This
is the Python image path of the KITTI loader where the native libpng loader
is not built, and the writer of the synthetic datasets.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                            # Sub: running sum per lane
            cur = np.empty(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint64) & 0xFF
        elif ftype == 2:                            # Up
            cur = line + prev
        elif ftype in (3, 4):                       # Average / Paeth
            cur = np.zeros(stride, np.int32)
            f = line.astype(np.int32)
            b = prev.astype(np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + b[x]) >> 1
                else:
                    c = b[x - bpp] if x >= bpp else 0
                    p = a + b[x] - c
                    pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b[x] if pb <= pc else c)
                cur[x] = (f[x] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """uint8 array (H, W) for grey, (H, W, C) otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); 8-bit non-interlaced grey, "
            "grey+alpha, RGB or RGBA only")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 grey from a read_png result (ITU-R 601 luma, alpha dropped),
    rounded the way common imaging libraries convert RGB to 'L'."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return img[..., 0]
    rgb = img[..., :3].astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W) grey or (H, W, 3) RGB, filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("write_png takes uint8 (H, W) or (H, W, 3)")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))

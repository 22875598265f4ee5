"""PNG files without an image codec (the card's machine has neither cv2 nor
PIL): an encoder and a decoder on ``zlib`` for 8-bit images.

Images are BGR as everywhere in the visualizer, (H, W, 3) or (H, W, 4) or
grey (H, W). ``encode`` writes no filter (type 0 on every row); ``decode``
reads any non-interlaced 8-bit grey, RGB or RGBA PNG with the five filters,
so it reads what cv2 writes as well.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG colour type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 BGR(A) or grey image -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG encode wants uint8, got {a.dtype}")
    if a.ndim == 2:
        a, ctype = a[:, :, None], 0
    elif a.shape[2] == 3:
        a, ctype = a[:, :, ::-1], 2
    elif a.shape[2] == 4:
        a, ctype = a[:, :, [2, 1, 0, 3]], 6
    else:
        raise ValueError(f"PNG encode wants 1, 3 or 4 channels, got {a.shape}")
    h, w, c = a.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    rows = np.frombuffer(data, np.uint8).reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(stride) & 255
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):       # the left neighbour is this row's output
                left = cur[x - c] if x >= c else 0
                up = prev[x]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - c] if x >= c else 0
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
                cur[x] = (line[x] + pred) & 255
        else:
            raise ValueError(f"unknown PNG filter {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, c)


def decode(buf: bytes) -> np.ndarray:
    """PNG bytes -> uint8 BGR (H, W, 3), BGRA (H, W, 4) or grey (H, W)."""
    if not buf.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, hdr = len(SIGNATURE), [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"PNG of depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: only 8-bit non-interlaced grey, RGB, RGBA")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])
    if ctype == 0:
        return px[:, :, 0]
    if ctype == 4:
        return px[:, :, 0]            # grey with alpha: the grey
    if ctype == 2:
        return np.ascontiguousarray(px[:, :, ::-1])
    return np.ascontiguousarray(px[:, :, [2, 1, 0, 3]])


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` as a PNG file (whatever the path's extension says)."""
    with open(path, "wb") as f:
        f.write(encode(img))


def imread(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())

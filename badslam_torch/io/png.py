"""Minimal PNG reader and writer on the standard library's zlib and numpy.

Reads non-interlaced 8- and 16-bit gray, gray+alpha, RGB and RGBA images
(color types 0, 4, 2, 6) with any of the five row filters; writes 8-bit
gray, 8-bit RGB and 16-bit gray with filter type 0. 16-bit samples are
big-endian in the file, as the format requires. Palette and interlaced
images are refused.

Every malformed or truncated file raises ValueError. Rows with filter
types None, Sub and Up decode vectorized. Average and
Paeth rows depend on the row's own earlier output and decode in a Python
loop, which is slow for large images written by encoders that choose them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """The chunks up to IEND. A file that ends before IEND (one still being
    written, or cut short) raises ValueError, as libpng fails on it."""
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            break
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before IEND (truncated)")


def _unfilter_slow(kind: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) / Paeth (4) row filters, in place on `line`."""
    n = len(line)
    if kind == 3:
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prior[i]) >> 1)) & 0xFF
        return
    for i in range(n):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] or [H, W, C] uint8 / uint16 array."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, bit_depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS or bit_depth not in (8, 16):
        raise ValueError(
            f"unsupported PNG: color type {color_type}, bit depth {bit_depth}")
    if interlace != 0:
        raise ValueError("interlaced PNG is not supported")
    channels = _CHANNELS[color_type]
    bpp = channels * bit_depth // 8
    stride = width * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(width, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row filter type {kind} is invalid")
        out[y] = cur
        prior = out[y]
    if bit_depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W] uint8 / uint16 or [H, W, 3] uint8 array -> PNG bytes."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color_type = 2
    else:
        raise ValueError(
            f"cannot write {img.dtype} {img.shape} as PNG (8-bit gray/RGB or "
            f"16-bit gray)")
    height, width = img.shape[:2]
    bit_depth = 16 if img.dtype == np.uint16 else 8
    samples = img.astype(">u2") if bit_depth == 16 else img
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(height, -1)
    filtered = np.concatenate(
        [np.zeros((height, 1), np.uint8), rows], axis=1)  # filter type 0
    header = struct.pack(">IIBBBBB", width, height, bit_depth, color_type,
                         0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))

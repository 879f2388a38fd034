"""8-bit PNG files with the standard library alone (the port has no
Pillow): :func:`write_png` writes RGB; :func:`read_png` reads what
``np.asarray(PIL.Image.open(path))`` reads for 8-bit non-interlaced files
(grey, grey + alpha, RGB, RGBA, with every row filter), and expands a
palette file to RGB (Pillow would give the indices)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image [H, W, 3] as an 8-bit truecolor PNG."""
    height, width, _ = rgb.shape
    rows = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(height, width * 3)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


# Samples a pixel of each colour type: 0 grey, 2 RGB, 3 palette, 4 grey +
# alpha, 6 RGBA.
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth; each row's
    first byte names its filter) of ``raw`` [height * (stride + 1)] →
    uint8 [height, stride], byte arithmetic modulo 256 as the PNG
    specification defines it."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each byte lane, wrapping
            lanes = line.reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one left of it
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
                else:
                    corner = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(left, up[i], corner)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG → uint8 [H, W] (grey), [H, W, 2]
    (grey + alpha), [H, W, 3] (RGB, and a palette file of 1-8 bit indices
    expanded to RGB) or [H, W, 4] (RGBA); raises on other bit depths and on
    interlaced files."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    packed = colour == 3 and depth in (1, 2, 4)  # palette indices below a byte
    if not (depth == 8 or packed) or colour not in CHANNELS or interlace:
        raise ValueError(f"{path}: not an 8-bit non-interlaced PNG (bit depth {depth}, colour type "
                         f"{colour}, interlace {interlace})")
    channels = CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette file without a PLTE chunk")
        rows = unfilter(raw, height, -(-width * depth // 8), 1)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # the first index in the top bits
        indices = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)[:, :width]
        return palette[indices]
    pixels = unfilter(raw, height, width * channels, channels).reshape(height, width, channels)
    return pixels[:, :, 0] if channels == 1 else pixels

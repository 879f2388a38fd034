"""8-bit RGB PNG files with the standard library alone (the port has no
Pillow): :func:`write_png` and :func:`read_png`, which reads back what
:func:`write_png` writes."""

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


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit truecolor, non-interlaced PNG whose rows use no filter
    (what :func:`write_png` writes) → uint8 [H, W, 3]; raises on others."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace ({header})")
    width, height = header[0], header[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, width * 3 + 1)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    return raw[:, 1:].reshape(height, width, 3).copy()

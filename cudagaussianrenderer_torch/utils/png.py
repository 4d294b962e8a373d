"""Minimal dependency-free PNG writer and reader.

The reference displays frames through an OpenGL textured quad
(the reference's src/Demo.cpp:23-110, 484-515); the port is headless like
the JAX package, so frames are written as PNG files instead.  Pure stdlib
(zlib + struct) and NumPy: the port's own copy of the JAX package's
utils/png.py, byte for byte the same encoding.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, *, level: int = 6) -> bytes:
    """Encode [H, W], [H, W, 3] or [H, W, 4] uint8 into PNG bytes.

    ``image`` is a NumPy array or a tensor on any device (a frame of
    render_frame).  ``level`` is the zlib effort: 6 (default) for files, 0
    (stored blocks, the fastest) for live streaming.
    """
    if hasattr(image, "cpu"):
        image = image.cpu().numpy()
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("encode_png expects uint8")
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    color_type = {1: 0, 3: 2, 4: 6}.get(c)
    if color_type is None:
        raise ValueError(f"unsupported channel count {c}")

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter byte 0 (None) per scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, level))
        + _chunk(b"IEND", b"")
    )


def write_png(path, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path_or_bytes) -> np.ndarray:
    """Tiny PNG reader for round-trip tests: 8-bit, filter 0/1/2/3/4,
    non-interlaced only."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a png")
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if depth != 8 or interlace != 0:
                raise ValueError("unsupported png")
            channels = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f_type = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).astype(np.int32)
        if f_type == 0:
            cur = line
        elif f_type == 2:  # up
            cur = (line + prev) % 256
        else:  # sub/average/paeth need sequential reconstruction
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c0 = prev[i - channels] if i >= channels else 0
                if f_type == 1:
                    pred = a
                elif f_type == 3:
                    pred = (a + b) // 2
                elif f_type == 4:
                    p = a + b - c0
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c0)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c0)
                else:
                    raise ValueError(f"bad filter {f_type}")
                cur[i] = (line[i] + pred) % 256
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, channels)

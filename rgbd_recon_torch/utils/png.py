"""Minimal dependency-free PNG writer (mirrors ``rgbd_recon_tpu/utils/png.py``).

≙ the reference's texture/BMP dump path (NetKinectArray::writeCurrentTexture
/ bmp writers, NetKinectArray.cpp:531-707): the headless app dumps rendered
frames and processed sensor textures as PNGs for observability. Pure
zlib/struct — no imaging dependency in the base image.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload)) + tag + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """img: u8 or float [H, W] (grayscale), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA). Floats are clipped from [0, 1] to u8. Returns the PNG bytes
    (used by write_png and the live HTTP viewer's stream encoder)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.nan_to_num(img) * 255.0, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, level))
    out += _chunk(b"IEND", b"")
    return out


def write_png(path: str, img: np.ndarray) -> None:
    """See encode_png; writes the bytes to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """Decode the subset write_png emits (8-bit, filter 0, non-interlaced).
    Round-trip testing only."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = color_type = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            assert depth == 8 and comp == 0 and interlace == 0
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    c = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * c + 1
    rows = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        ftype = row[0]
        cur = np.frombuffer(row[1:], np.uint8).astype(np.int64)
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            cur = (cur + prev) % 256
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        rows.append(cur.astype(np.uint8))
        prev = cur
    img = np.stack(rows).reshape(h, w, c)
    return img[..., 0] if c == 1 else img

"""DXT1 / DXT5 texture codecs on the host (mirrors ``rgbd_recon_tpu/io/dxt.py``).

The reference's recorded streams carry DXT1- or DXT5-compressed color frames
(NetKinectArray.cpp:118-126). These vectorized numpy codecs are the port's
host decode's oracle (the threaded C++ decoder of ``io/native.py`` is bit
for bit these) and the oracle of the device decode (``ops/wire.py``).

Block layout (S3TC): 4x4 texel blocks, row-major over the image.
  DXT1 block (8B):  u16 c0, u16 c1 (RGB565 little-endian), u32 row-major
                    2-bit indices.
  DXT5 block (16B): 8B alpha block (ignored here — RGB output), then a DXT1
                    color block. DXT5 color mode is always 4-color.
"""
from __future__ import annotations

import numpy as np


def _expand565(c: np.ndarray):
    r = ((c >> 11) & 0x1F).astype(np.uint16)
    g = ((c >> 5) & 0x3F).astype(np.uint16)
    b = (c & 0x1F).astype(np.uint16)
    # standard bit replication
    r = (r << 3) | (r >> 2)
    g = (g << 2) | (g >> 4)
    b = (b << 3) | (b >> 2)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _decode_color_blocks(c0: np.ndarray, c1: np.ndarray, bits: np.ndarray, force4: bool):
    """c0,c1 u16[N]; bits u32[N] -> u8[N, 4, 4, 3]."""
    p0 = _expand565(c0).astype(np.int32)
    p1 = _expand565(c1).astype(np.int32)
    four_mode = (c0 > c1) | force4
    # palette entries 2 and 3
    p2_4 = (2 * p0 + p1) // 3
    p3_4 = (p0 + 2 * p1) // 3
    p2_3 = (p0 + p1) // 2
    p3_3 = np.zeros_like(p0)
    p2 = np.where(four_mode[:, None], p2_4, p2_3)
    p3 = np.where(four_mode[:, None], p3_4, p3_3)
    palette = np.stack([p0, p1, p2, p3], axis=1).astype(np.uint8)  # [N, 4, 3]

    shifts = np.arange(16, dtype=np.uint32) * 2
    idx = (bits[:, None] >> shifts[None, :]) & 0x3  # [N, 16]
    out = np.take_along_axis(palette[:, :, None, :], idx[..., None, None].astype(np.int64), axis=1)
    # palette [N,4,1,3] gathered at [N,16,1,1] -> [N,16,1,3]
    return out[:, :, 0, :].reshape(-1, 4, 4, 3)


def _assemble(blocks: np.ndarray, width: int, height: int) -> np.ndarray:
    bw, bh = width // 4, height // 4
    img = blocks.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    return img.reshape(height, width, 3)


def decode_dxt1(data: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """DXT1 payload -> u8[height, width, 3]."""
    raw = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n_blocks = (width // 4) * (height // 4)
    raw = raw[: n_blocks * 8].reshape(n_blocks, 8)
    c0 = raw[:, 0].astype(np.uint16) | (raw[:, 1].astype(np.uint16) << 8)
    c1 = raw[:, 2].astype(np.uint16) | (raw[:, 3].astype(np.uint16) << 8)
    bits = (
        raw[:, 4].astype(np.uint32)
        | (raw[:, 5].astype(np.uint32) << 8)
        | (raw[:, 6].astype(np.uint32) << 16)
        | (raw[:, 7].astype(np.uint32) << 24)
    )
    return _assemble(_decode_color_blocks(c0, c1, bits, force4=False), width, height)


def decode_dxt5(data: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """DXT5 payload -> u8[height, width, 3] (alpha dropped)."""
    raw = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n_blocks = (width // 4) * (height // 4)
    raw = raw[: n_blocks * 16].reshape(n_blocks, 16)
    col = raw[:, 8:]
    c0 = col[:, 0].astype(np.uint16) | (col[:, 1].astype(np.uint16) << 8)
    c1 = col[:, 2].astype(np.uint16) | (col[:, 3].astype(np.uint16) << 8)
    bits = (
        col[:, 4].astype(np.uint32)
        | (col[:, 5].astype(np.uint32) << 8)
        | (col[:, 6].astype(np.uint32) << 16)
        | (col[:, 7].astype(np.uint32) << 24)
    )
    return _assemble(_decode_color_blocks(c0, c1, bits, force4=True), width, height)


def encode_dxt1(img: np.ndarray) -> np.ndarray:
    """Minimal DXT1 encoder (for synthesizing test/replay fixtures; the
    reference uses fastdxt for live encoding, DXTCompressor.h:16-48).

    Per block: endpoints = per-channel min/max colors, 4-entry palette,
    nearest-palette indices. Not rate-optimal, but spec-conformant.
    """
    h, w, _ = img.shape
    bw, bh = w // 4, h // 4
    blocks = img.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3).astype(np.int32)
    mx = blocks.max(axis=1)
    mn = blocks.min(axis=1)

    def to565(c):
        return (
            ((c[:, 0] >> 3).astype(np.uint16) << 11)
            | ((c[:, 1] >> 2).astype(np.uint16) << 5)
            | (c[:, 2] >> 3).astype(np.uint16)
        )

    c0_565 = to565(mx)
    c1_565 = to565(mn)
    # ensure c0 > c1 for 4-color mode (swap where needed)
    swap = c0_565 <= c1_565
    c0_565, c1_565 = np.where(swap, c1_565, c0_565), np.where(swap, c0_565, c1_565)
    p0 = _expand565(c0_565).astype(np.int32)
    p1 = _expand565(c1_565).astype(np.int32)
    palette = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], axis=1)
    d = blocks[:, :, None, :] - palette[:, None, :, :]
    idx = np.argmin((d * d).sum(-1), axis=-1).astype(np.uint32)  # [N, 16]
    bits = np.zeros(len(blocks), np.uint32)
    for i in range(16):
        bits |= idx[:, i] << np.uint32(2 * i)
    out = np.zeros((len(blocks), 8), np.uint8)
    out[:, 0] = c0_565 & 0xFF
    out[:, 1] = c0_565 >> 8
    out[:, 2] = c1_565 & 0xFF
    out[:, 3] = c1_565 >> 8
    out[:, 4] = bits & 0xFF
    out[:, 5] = (bits >> 8) & 0xFF
    out[:, 6] = (bits >> 16) & 0xFF
    out[:, 7] = (bits >> 24) & 0xFF
    return out.reshape(-1)


def encode_dxt5(img: np.ndarray, alpha: np.ndarray | None = None) -> np.ndarray:
    """Minimal DXT5/BC3 encoder (capture parity with the reference's
    fastdxt recording path, DXTCompressor.h:16-48).

    ``img`` u8[H, W, 3]; ``alpha`` u8[H, W] (None = opaque). Per block:
    8B BC3 alpha (min/max endpoints, 8-value interpolated palette, 3-bit
    nearest indices) + 8B DXT1 color block in forced-4-color mode (the
    DXT5 color decoder always interpolates 4 entries, see decode_dxt5).
    Round-trips bit-exactly through decode_dxt5 for palette-exact inputs.
    """
    h, w, _ = img.shape
    if alpha is None:
        alpha = np.full((h, w), 255, np.uint8)
    bw, bh = w // 4, h // 4
    n = bw * bh
    ab = (
        alpha.reshape(bh, 4, bw, 4)
        .transpose(0, 2, 1, 3)
        .reshape(n, 16)
        .astype(np.int32)
    )
    a0 = ab.max(axis=1)
    a1 = ab.min(axis=1)
    # 8-value mode needs a0 > a1; constant-alpha blocks use index 0 only
    flat = a0 == a1
    a1 = np.where(flat, np.maximum(a1 - 1, 0), a1)
    a0 = np.where(flat & (a0 == 0), 1, a0)
    # BC3 alpha palette order: a0, a1, then 6 interpolated steps
    steps = np.stack(
        [a0, a1]
        + [((7 - i) * a0 + i * a1) // 7 for i in range(1, 7)],
        axis=1,
    )                                              # [N, 8]
    idx = np.argmin(
        np.abs(ab[:, :, None] - steps[:, None, :]), axis=-1
    ).astype(np.uint64)                            # [N, 16] 3-bit codes
    packed = np.zeros(n, np.uint64)
    for i in range(16):
        packed |= idx[:, i] << np.uint64(3 * i)    # 48 bits
    out = np.zeros((n, 16), np.uint8)
    out[:, 0] = a0.astype(np.uint8)
    out[:, 1] = a1.astype(np.uint8)
    for b in range(6):
        out[:, 2 + b] = ((packed >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    out[:, 8:] = encode_dxt1(img).reshape(n, 8)
    return out.reshape(-1)

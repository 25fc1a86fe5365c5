"""Device-side wire-format decode: DXT1/DXT5 color + compressed depth
(mirrors ``rgbd_recon_tpu/ops/wire.py``).

The reference uploads the RAW stream bytes to the GPU and lets the
hardware decompress them — GL samples S3TC textures natively
(NetKinectArray.cpp:118-126) and compressed u8 depth is decoded in-shader
(pre_depth.fs:51-61). Here the app uploads the payloads and decodes them
with integer tensor ops on the payload's device: a compressed frame is
~10x fewer bytes over the host link than the decoded float32 frame. The
JAX package computes these outside any Pallas kernel, so they are plain
PyTorch here too.

Bit-exactness with the host decode (``io/dxt.py``, ``FrameFormat``): the
DXT block decode is integer math. The normalizations divide by a 0-d
tensor on the payload's device, not by a Python float: on a CUDA tensor
torch turns division by a host scalar into a product with its reciprocal,
which is not the correctly rounded quotient numpy computes.
"""
from __future__ import annotations

import torch


def _div255(x: torch.Tensor) -> torch.Tensor:
    return x / torch.tensor(255.0, dtype=torch.float32, device=x.device)


def _expand565(c):
    """RGB565 (int32) -> 3 int32 channels with bit replication (matches
    io/dxt._expand565)."""
    r = (c >> 11) & 0x1F
    g = (c >> 5) & 0x3F
    b = c & 0x1F
    return (r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)


def _decode_color_blocks(raw: torch.Tensor, force4: bool) -> torch.Tensor:
    """raw i32[K, N, 8] (u8 values) -> i32[K, N, 16, 3] texel colors."""
    c0 = raw[..., 0] | (raw[..., 1] << 8)
    c1 = raw[..., 2] | (raw[..., 3] << 8)
    p0 = torch.stack(_expand565(c0), -1)           # [K, N, 3]
    p1 = torch.stack(_expand565(c1), -1)
    four = torch.ones_like(c0, dtype=torch.bool) if force4 else c0 > c1
    p2 = torch.where(four[..., None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = torch.where(four[..., None], (p0 + 2 * p1) // 3, 0)
    palette = torch.stack([p0, p1, p2, p3], dim=-2)   # [K, N, 4, 3]
    bits = raw[..., 4] | (raw[..., 5] << 8) | (raw[..., 6] << 16) | (raw[..., 7] << 24)
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=raw.device)
    idx = (bits[..., None] >> shifts) & 0x3           # [K, N, 16]
    return torch.gather(palette, -2, idx[..., None].expand(*idx.shape, 3).long())


def _assemble(texels: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[K, N, 16, 3] -> [K, H, W, 3] (row-major 4x4 blocks)."""
    k = texels.shape[0]
    bw, bh = width // 4, height // 4
    img = texels.reshape(k, bh, bw, 4, 4, 3)
    return img.permute(0, 1, 3, 2, 4, 5).reshape(k, height, width, 3)


def decode_dxt1_device(payload: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """payload u8[K, W*H/2] -> f32[K, H, W, 3] in [0, 1]."""
    k = payload.shape[0]
    n = (width // 4) * (height // 4)
    raw = payload[:, : n * 8].reshape(k, n, 8).to(torch.int32)
    img = _assemble(_decode_color_blocks(raw, force4=False), width, height)
    return _div255(img.to(torch.float32))


def decode_dxt5_device(payload: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """payload u8[K, W*H] -> f32[K, H, W, 3] (alpha dropped, like the
    replay path — NetKinectArray samples only rgb)."""
    k = payload.shape[0]
    n = (width // 4) * (height // 4)
    raw = payload[:, : n * 16].reshape(k, n, 16)[..., 8:].to(torch.int32)
    img = _assemble(_decode_color_blocks(raw, force4=True), width, height)
    return _div255(img.to(torch.float32))


def decode_depth_u8_device(payload: torch.Tensor, width: int, height: int,
                           near: float = 0.5, far: float = 4.5) -> torch.Tensor:
    """Compressed u8 depth -> f32[K, H, W] meters (the pre_depth.fs:51-61
    mapping; same op order as FrameFormat.decode_depth)."""
    k = payload.shape[0]
    d_c = _div255(payload.reshape(k, height, width).to(torch.float32))
    scale = far - near
    scaled_near = scale / 255.0
    out = (d_c * d_c + 0.15 * scaled_near) * scale + near
    return torch.where(d_c < scaled_near, 0.0, out)


def decode_depth_f32_device(payload: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Raw f32 depth bytes -> f32[K, H, W] (little-endian bitcast)."""
    k = payload.shape[0]
    return payload.reshape(k, height * width * 4).contiguous().view(
        torch.float32).reshape(k, height, width)


def make_wire_decoder(fmt):
    """(color_payload, depth_payload) u8 tensors -> (depth f32[K,H,W] m,
    color f32[K,Hc,Wc,3]) for a FrameFormat, on the payloads' device — the
    device-side equivalent of StreamReader's host decode."""

    def decode(color_payload: torch.Tensor, depth_payload: torch.Tensor):
        if fmt.compressed_rgb == 1:
            color = decode_dxt1_device(color_payload, fmt.width_c, fmt.height_c)
        elif fmt.compressed_rgb == 5:
            color = decode_dxt5_device(color_payload, 640, 480)
        else:
            k = color_payload.shape[0]
            color = _div255(color_payload.reshape(
                k, fmt.height_c, fmt.width_c, 3).to(torch.float32))
        if fmt.compressed_depth:
            depth = decode_depth_u8_device(depth_payload, fmt.width, fmt.height)
        else:
            depth = decode_depth_f32_device(depth_payload, fmt.width, fmt.height)
        return depth, color

    return decode

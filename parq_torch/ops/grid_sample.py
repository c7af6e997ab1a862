"""Bilinear sampling with ``F.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=True)`` semantics on channels-last
maps (port of parq_tpu/ops/grid_sample.py), written as a plain gather."""
from __future__ import annotations

import torch


def sample_bilinear_pixels(features: torch.Tensor,
                           xy: torch.Tensor) -> torch.Tensor:
    """features (N, H, W, C); xy (N, P, 2) pixel coordinates (x, y) →
    (N, P, C) in float32. The 4 taps around each point are weighted
    bilinearly; taps outside [0, W-1] × [0, H-1] contribute zero."""
    N, H, W, C = features.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = features.reshape(N, H * W, C).float()

    def gather(ix, iy):
        inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(N, idx.shape[1], C))
        return vals * inb[..., None].to(vals.dtype)

    return (gather(x0, y0) * (wx0 * wy0)[..., None]
            + gather(x0 + 1, y0) * (wx1 * wy0)[..., None]
            + gather(x0, y0 + 1) * (wx0 * wy1)[..., None]
            + gather(x0 + 1, y0 + 1) * (wx1 * wy1)[..., None])


def grid_sample_bilinear(features: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """features (N, H, W, C); grid (N, P, 2) normalized (x, y) in [-1, 1]
    with the align_corners=True convention → (N, P, C)."""
    _, H, W, _ = features.shape
    xy = torch.stack([(grid[..., 0] + 1.0) * 0.5 * (W - 1),
                      (grid[..., 1] + 1.0) * 0.5 * (H - 1)], dim=-1)
    return sample_bilinear_pixels(features, xy)

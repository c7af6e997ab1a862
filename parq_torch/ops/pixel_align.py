"""Pixel-aligned features: project 3D queries into every view, sample the
view's feature map bilinearly, sum over views and divide by the number of
views in which the query is valid (port of parq_tpu/ops/pixel_align.py).

Semantics kept exactly: the sum runs over EVERY view, valid or not (an
invalid view still contributes whatever in-image taps it has); only the
divisor is the valid count, clamped to 1. This is the plain reference op;
the decoder runs kernel B1 through `parq_torch.kernels.pixel_align`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import Camera, Pose
from .grid_sample import grid_sample_bilinear


def pixel_aligned_features(
    memory_hw: torch.Tensor,
    query_pos: torch.Tensor,
    T_camera_local: Pose,
    camera: Camera,
    feat_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """memory_hw (B, T, H, W, C); query_pos (B, Q, 3) metric, local frame;
    T_camera_local, camera: (B, T) at feature scale; feat_size (W, H).

    Returns features (B, Q, C) float32, center_im (B, T, Q, 2),
    center_valid (B, T, Q) bool.
    """
    B, T, H, W, C = memory_hw.shape
    if tuple(feat_size) != (W, H):
        raise ValueError(f"feat_size {feat_size} != memory {(W, H)}")
    query_pos_c = T_camera_local.transform(query_pos[:, None, :, :])
    center_im, center_valid = camera.project(query_pos_c)
    grid = torch.stack([2.0 * center_im[..., 0] / (W - 1) - 1.0,
                        2.0 * center_im[..., 1] / (H - 1) - 1.0], dim=-1)
    Q = query_pos.shape[1]
    feats = grid_sample_bilinear(memory_hw.reshape(B * T, H, W, C),
                                 grid.reshape(B * T, Q, 2))
    feats = feats.reshape(B, T, Q, C).sum(dim=1)
    count = center_valid.float().sum(dim=1).clamp(min=1.0)
    return feats / count[..., None], center_im, center_valid

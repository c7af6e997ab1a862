"""Ray geometry for the ray positional encoding (port of
parq_tpu/geometry/rays.py: grid, log-spaced depths, snippet-frame ray
directions, the reference's double-clamped logit)."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .camera import Camera
from .pose import Pose, _apply_R


def grid_2d(width: int, height: int, device=None) -> torch.Tensor:
    """(H, W, 2) pixel grid, x = 0..W-1, y = 0..H-1."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([x, y], dim=-1)


def depth_planes(num_samples: int, min_depth: float, max_depth: float,
                 device=None) -> torch.Tensor:
    """(num_samples,) log-spaced depths."""
    ramp = torch.linspace(0.0, 1.0, num_samples, dtype=torch.float32,
                          device=device)
    return torch.exp(math.log(min_depth)
                     + math.log(max_depth / min_depth) * ramp)


def ray_dirs_snippet(pixel_grid: torch.Tensor, camera: Camera,
                     T_camera_pseudoCam: Pose, T_world_pseudoCam: Pose,
                     T_local_world: Pose
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-view ray directions in the snippet-local frame and the frame
    translation: sample point n = rdir · depth_n + t.

    camera / poses: (B, T); T_local_world: (B, 1) or (B,).
    Returns rdir (B, T, H·W, 3), t (B, T, 3).
    """
    B, T = T_camera_pseudoCam.shape[:2]
    H, W = pixel_grid.shape[:2]
    pix = pixel_grid.reshape(1, H * W, 2).expand(B * T, H * W, 2)
    rays = camera.reshape(B * T).unproject(pix)          # (BT, HW, 3)
    if T_local_world.data.dim() == 2:
        T_local_world = Pose(T_local_world.data[:, None, :])
    T_local_pseudoCam = T_local_world @ T_world_pseudoCam
    T_local_cam = (T_local_pseudoCam.reshape(B * T)
                   @ T_camera_pseudoCam.reshape(B * T).inverse())
    rdir = _apply_R(T_local_cam.R[:, None], rays)        # (BT, HW, 3)
    return rdir.reshape(B, T, H * W, 3), T_local_cam.t.reshape(B, T, 3)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """logit with the reference's double clamp."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def normalize_points(p: torch.Tensor, s: Sequence[float]) -> torch.Tensor:
    """Metric coords → [0, 1]³ by the scene scale box."""
    return torch.stack([(p[..., 0] - s[0]) / (s[1] - s[0]),
                        (p[..., 1] - s[2]) / (s[3] - s[2]),
                        (p[..., 2] - s[4]) / (s[5] - s[4])], dim=-1)


def denormalize_points(p: torch.Tensor, s: Sequence[float]) -> torch.Tensor:
    return torch.stack([p[..., 0] * (s[1] - s[0]) + s[0],
                        p[..., 1] * (s[3] - s[2]) + s[2],
                        p[..., 2] * (s[5] - s[4]) + s[4]], dim=-1)

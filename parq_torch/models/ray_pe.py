"""Ray positional encoding (port of parq_tpu/models/ray_pe.py).

For every feature-map pixel: `num_samples` log-spaced depth points along
the camera ray in the snippet-local frame, min-max normalized by the scene
box, inverse-sigmoid, flattened SAMPLE-major (…, n, 3) as the reference
does, then a 2-layer MLP. (The JAX encoder builds the channel-major order
and folds the permutation into its first kernel; its stored kernel is in
this sample-major order, so weights map across as they are.)
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..geometry import (Camera, Pose, depth_planes, grid_2d,
                        inverse_sigmoid, ray_dirs_snippet)
from .mlp import MLP2


class AddRayPE(nn.Module):
    def __init__(self, dim_out: int = 1024,
                 ray_points_scale: Tuple[float, ...] = (
                     -3.0, 3.0, -2.0, 0.5, 0.25, 5.25),
                 num_samples: int = 64, min_depth: float = 0.25,
                 max_depth: float = 5.25,
                 feat_size: Tuple[int, int] = (80, 60)):
        super().__init__()
        self.ray_points_scale = tuple(float(s) for s in ray_points_scale)
        self.num_samples = num_samples
        self.min_depth, self.max_depth = min_depth, max_depth
        self.feat_size = tuple(feat_size)
        self.encoder = MLP2(3 * num_samples, dim_out, dim_out)
        # the scene box's lower corner and span, on the model's device (a
        # tensor built from host floats in the forward would be a blocking
        # upload every call)
        s = self.ray_points_scale
        self.register_buffer("box_lo", torch.tensor([s[0], s[2], s[4]]),
                             persistent=False)
        self.register_buffer("box_span", torch.tensor(
            [s[1] - s[0], s[3] - s[2], s[5] - s[4]]), persistent=False)

    def forward(self, camera: Camera, T_camera_pseudoCam: Pose,
                T_world_pseudoCam: Pose, T_world_local: Pose
                ) -> torch.Tensor:
        """→ per-pixel encoding (B, T, H, W, dim_out)."""
        W, H = self.feat_size
        dev = camera.data.device
        rdir, t = ray_dirs_snippet(grid_2d(W, H, dev), camera,
                                   T_camera_pseudoCam, T_world_pseudoCam,
                                   T_world_local.inverse())
        d = depth_planes(self.num_samples, self.min_depth, self.max_depth,
                         dev)
        pts = rdir[..., None, :] * d[:, None] + t[:, :, None, None, :]
        pts = inverse_sigmoid((pts - self.box_lo)
                              / self.box_span)         # (B, T, HW, n, 3)
        B, T = pts.shape[:2]
        return self.encoder(pts.reshape(B, T, H, W, 3 * self.num_samples))

"""Pinhole camera as a flat (..., 6) tensor ``[w, h, fx, fy, cx, cy]``.

Port of parq_tpu/geometry/camera.py (the parts the eval path uses).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

EPS = 1e-3  # z clamp of the reference projector


@dataclasses.dataclass(frozen=True)
class Camera:
    data: torch.Tensor  # (..., 6)

    @property
    def size(self) -> torch.Tensor:
        return self.data[..., :2]

    @property
    def f(self) -> torch.Tensor:
        return self.data[..., 2:4]

    @property
    def c(self) -> torch.Tensor:
        return self.data[..., 4:6]

    def reshape(self, *shape) -> "Camera":
        return Camera(self.data.reshape(*shape, 6))

    def scale(self, s: float) -> "Camera":
        """Intrinsics after an image resize by `s`, with the half-pixel
        aware principal point ``(c + 0.5) * s - 0.5``."""
        return Camera(torch.cat(
            [self.size * s, self.f * s, (self.c + 0.5) * s - 0.5], dim=-1))

    def in_image(self, p2d: torch.Tensor) -> torch.Tensor:
        """True where 2D points fall within [0, size - 1]."""
        size = self.size[..., None, :]
        return ((p2d >= 0) & (p2d <= size - 1)).all(dim=-1)

    def project(self, p3d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points (..., N, 3) → pixels (..., N, 2) and
        validity ``z > EPS & in_image``; z is clamped to EPS first."""
        z = p3d[..., -1]
        in_front = z > EPS
        z = z.clamp(min=EPS)
        p2d = p3d[..., :2] / z[..., None]
        p2d = p2d * self.f[..., None, :] + self.c[..., None, :]
        return p2d, in_front & self.in_image(p2d)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., N, 2) → z=1 rays (..., N, 3)."""
        xy = (uv - self.c[..., None, :]) / self.f[..., None, :]
        return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)

"""ortho6d → rotation matrix, and the rotation about y (port of
parq_tpu/geometry/rotation.py)."""
from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=eps)


def rotation_matrix_from_ortho6d(ortho6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) → (..., 3, 3) by Gram–Schmidt; columns are (x, y, z) with
    x = normalize(a1), z = normalize(x × a2), y = z × x."""
    x = _normalize(ortho6d[..., 0:3])
    z = _normalize(torch.linalg.cross(x, ortho6d[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def roty(t: torch.Tensor) -> torch.Tensor:
    """Rotation about the y axis, (...) angles → (..., 3, 3)."""
    c, s = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zero, s], -1),
                        torch.stack([zero, one, zero], -1),
                        torch.stack([-s, zero, c], -1)], dim=-2)

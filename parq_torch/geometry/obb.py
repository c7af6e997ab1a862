"""Oriented 3D boxes as flat (..., 19) tensors
``[bb3_object (6), T_world_object (12), sem_id (1)]`` — the parts of
parq_tpu/geometry/obb.py that parse_pred uses."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_BOXES = 100
MAX_SYMS = 50

# corner ordering of the reference (index into (min, max) per axis)
_CORNER_SIGNS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Obb3D:
    data: torch.Tensor  # (..., 19)

    @classmethod
    def from_parts(cls, bb3_object: torch.Tensor,
                   T_world_object: torch.Tensor,
                   sem_id: torch.Tensor) -> "Obb3D":
        if sem_id.dim() != bb3_object.dim():
            sem_id = sem_id[..., None]
        return cls(torch.cat([bb3_object, T_world_object,
                              sem_id.to(bb3_object.dtype)], dim=-1))

    @property
    def bb3_min_object(self) -> torch.Tensor:
        return self.data[..., 0:6:2]

    @property
    def bb3_max_object(self) -> torch.Tensor:
        return self.data[..., 1:6:2]

    @property
    def corners_object(self) -> torch.Tensor:
        """8 corners in the object frame, (..., 8, 3), reference order."""
        lo = self.bb3_min_object[..., None, :]
        hi = self.bb3_max_object[..., None, :]
        signs = torch.as_tensor(_CORNER_SIGNS, dtype=self.data.dtype,
                                device=self.data.device)
        return lo + (hi - lo) * signs


def pad_obbs_np(bb3: np.ndarray, T_world_object: np.ndarray,
                sem_id: np.ndarray, max_box: int = MAX_BOXES) -> np.ndarray:
    """Pad boxes on the host to a (max_box, 19) array; pad rows are all −1."""
    n = bb3.shape[0]
    data = np.concatenate(
        [bb3.reshape(n, 6), T_world_object.reshape(n, 12),
         sem_id.reshape(n, 1).astype(bb3.dtype)], axis=-1)
    if n >= max_box:
        return data[:max_box]
    pad = -np.ones((max_box - n, 19), dtype=data.dtype)
    return np.concatenate([data, pad], axis=0)

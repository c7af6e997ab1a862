"""Oriented 3D boxes as flat (..., 19) tensors
``[bb3_object (6), T_world_object (12), sem_id (1)]`` — the parts of
parq_tpu/geometry/obb.py that parse_pred and the loss's parse_targets
use."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pose import Pose

MAX_BOXES = 100
MAX_SYMS = 50

# corner ordering of the reference (index into (min, max) per axis)
_CORNER_SIGNS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float32)
_CORNER_SIGNS_ON = {}   # (dtype, device) → the signs, uploaded once


def corner_signs(dtype: torch.dtype, device) -> torch.Tensor:
    """The (8, 3) corner signs on `device`, uploaded on first use and
    cached, so a step or a captured graph makes no host copy."""
    key = (dtype, torch.device(device))
    signs = _CORNER_SIGNS_ON.get(key)
    if signs is None:
        signs = _CORNER_SIGNS_ON[key] = torch.as_tensor(
            _CORNER_SIGNS, dtype=dtype, device=device)
    return signs


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
    def bb3_object(self) -> torch.Tensor:
        return self.data[..., :6]

    @property
    def bb3_min_object(self) -> torch.Tensor:
        return self.data[..., 0:6:2]

    @property
    def bb3_max_object(self) -> torch.Tensor:
        return self.data[..., 1:6:2]

    @property
    def bb3_center_object(self) -> torch.Tensor:
        return 0.5 * (self.bb3_min_object + self.bb3_max_object)

    @property
    def bb3_size(self) -> torch.Tensor:
        return self.bb3_max_object - self.bb3_min_object

    @property
    def T_world_object(self) -> Pose:
        return Pose(self.data[..., 6:18])

    @property
    def sem_id(self) -> torch.Tensor:
        """(..., 1) float semantic id (−1 for pad)."""
        return self.data[..., 18:19]

    def valid_mask(self) -> torch.Tensor:
        """(...,) bool — True for real boxes, False for all −1 pad rows."""
        return ~torch.all(self.data == -1.0, dim=-1)

    @property
    def corners_object(self) -> torch.Tensor:
        """8 corners in the object frame, (..., 8, 3), reference order."""
        lo = self.bb3_min_object[..., None, :]
        hi = self.bb3_max_object[..., None, :]
        return lo + (hi - lo) * corner_signs(self.data.dtype,
                                             self.data.device)


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

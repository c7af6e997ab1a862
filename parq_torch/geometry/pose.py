"""SE(3) pose as a flat (..., 12) tensor: ``[R.reshape(9) (row-major), t]``.

Port of parq_tpu/geometry/pose.py. Every 3x3 contraction is written as
elementwise math so it stays in float32 under autocast (a matmul there
would drop to bf16 and move projected pixels).
"""
from __future__ import annotations

import dataclasses

import torch


def _apply_R(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) applied to vectors v (..., 3)."""
    return torch.stack([
        R[..., i, 0] * v[..., 0] + R[..., i, 1] * v[..., 1]
        + R[..., i, 2] * v[..., 2]
        for i in range(3)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Pose:
    """Batch of SE(3) transforms stored as (..., 12) tensors."""

    data: torch.Tensor  # (..., 12)

    @classmethod
    def from_Rt(cls, R: torch.Tensor, t: torch.Tensor) -> "Pose":
        return cls(torch.cat([R.reshape(R.shape[:-2] + (9,)), t], dim=-1))

    @property
    def shape(self):
        return self.data.shape[:-1]

    @property
    def R(self) -> torch.Tensor:
        return self.data[..., :9].reshape(self.data.shape[:-1] + (3, 3))

    @property
    def t(self) -> torch.Tensor:
        return self.data[..., 9:12]

    def reshape(self, *shape) -> "Pose":
        return Pose(self.data.reshape(*shape, 12))

    def inverse(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose.from_Rt(Rt, -_apply_R(Rt, self.t))

    def compose(self, other: "Pose") -> "Pose":
        """T_B2C.compose(T_A2B) -> T_A2C."""
        A, B = self.R, other.R
        R = torch.stack([
            torch.stack([
                A[..., i, 0] * B[..., 0, j] + A[..., i, 1] * B[..., 1, j]
                + A[..., i, 2] * B[..., 2, j]
                for j in range(3)], dim=-1)
            for i in range(3)], dim=-2)
        return Pose.from_Rt(R, self.t + _apply_R(A, other.t))

    def __matmul__(self, other: "Pose") -> "Pose":
        return self.compose(other)

    def transform(self, p3d: torch.Tensor) -> torch.Tensor:
        """Points (..., N, 3) → ``p3d @ R^T + t`` per pose."""
        R = self.R[..., None, :, :]
        out = torch.stack([
            p3d[..., 0] * R[..., i, 0] + p3d[..., 1] * R[..., i, 1]
            + p3d[..., 2] * R[..., i, 2]
            for i in range(3)], dim=-1)
        return out + self.t[..., None, :]

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


def invert_4x4(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 4, 4) matrices by cofactors over 2x2 minors,
    written out elementwise: no solver launch and no host sync, so a CUDA
    graph can capture it. Run it in float64 where the inputs mix pixel
    and metre scales (a camera's lidar2img)."""
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]
    s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1]
    s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2]
    s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3]
    s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2]
    s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3]
    s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3]
    c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3]
    c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3]
    c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2]
    c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3]
    c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2]
    c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    rows = [
        [a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
         -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
         a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
         -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3],
        [-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
         a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
         -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
         a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1],
        [a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
         -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
         a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
         -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0],
        [-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
         a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
         -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
         a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0]]
    inv = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return inv / det[..., None, None]

"""Sinusoidal 3D position embedding of the query reference points
(port of parq_tpu/ops/posemb.py): channel order (y, x, z), each with
interleaved sin/cos pairs."""
from __future__ import annotations

import math

import torch


def pos2posemb3d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """(..., 3) in [0, 1] → (..., 3 · num_pos_feats)."""
    pos = pos * (2.0 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=pos.dtype, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def emb(p):
        v = p[..., None] / dim_t
        return torch.stack([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])],
                           dim=-1).reshape(v.shape)

    return torch.cat([emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2])],
                     dim=-1)

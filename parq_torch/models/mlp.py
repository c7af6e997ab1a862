"""MLP building blocks of the heads and encoders (port of
parq_tpu/models/mlp.py).

The reference's detection heads are GenericMLPs of 1x1 Conv1d layers whose
"ln" norm is GroupNorm(num_groups=1): statistics over channels AND tokens
jointly, per sample. `GroupNorm1` keeps that quirk on (B, N, C) tokens.
Parameters keep the reference's Conv1d shapes (O, I, 1) and its
``layers.{i}`` indices, so the torch checkpoint layout loads unchanged.
`fused_detection_heads` of the JAX package is a TPU fusion of the same
math. Here each head runs on its own in training, in f32 and on the CPU;
the bf16 eval forward on the card runs all four, with the box decode, as
three kernels (`kernels/heads.py`, the decoder's dispatch).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class GroupNorm1(nn.Module):
    """torch GroupNorm(1, C) on (B, N, C) tokens: normalize over (N, C)
    jointly with per-channel affine. Statistics in f32; the output keeps
    the input dtype. `n_groups > 1`: the token axis folds n_groups decoder
    iterations (the batched-gradient training path), and the statistics
    are taken per group, so the folded call matches per-iteration calls."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
        B, N, C = x.shape
        xf = x.float().view(B, n_groups, N // n_groups, C)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).view(B, N, C)
        return (y * self.weight + self.bias).to(x.dtype)


class Conv1x1(nn.Conv1d):
    """A kernel-size-1 Conv1d (weights (O, I, 1), the checkpoint's shape)
    applied as a Linear over (B, N, C) tokens."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class HeadMLP(nn.Module):
    """Detection head over (B, N, C) tokens: per hidden width
    Conv1x1(no bias) → GroupNorm1 → ReLU → Dropout, then Conv1x1(bias).

    The output projection runs in f32 even under bf16 autocast (the JAX
    head does the same): its outputs feed sigmoid, softmax and exp."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 output_dim: int):
        super().__init__()
        layers, c = [], in_features
        for h in hidden_dims:
            layers += [Conv1x1(c, h, bias=False), GroupNorm1(h), nn.ReLU(),
                       nn.Dropout(0.0)]
            c = h
        layers.append(Conv1x1(c, output_dim))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = layer(x, n_groups) if isinstance(layer, GroupNorm1) \
                else layer(x)
        with torch.autocast(x.device.type, enabled=False):
            return self.layers[-1](x.float())


class MLP2(nn.Sequential):
    """Linear → ReLU → Linear (rayPE encoder, query position encoder);
    state_dict keys ``0.*`` and ``2.*`` as in the reference."""

    def __init__(self, in_features: int, hidden_dim: int, output_dim: int):
        super().__init__(nn.Linear(in_features, hidden_dim), nn.ReLU(),
                         nn.Linear(hidden_dim, output_dim))

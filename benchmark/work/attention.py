"""The least time the card could take for the decoder's cross-attention
forward, counted from the problem (whatever kernel computes it), bf16
operands: per forward pass L launches, each reading q, writing o and
reading the memory's K and V once. The bound is the larger of operations
over the bf16 peak and bytes over the memory bandwidth."""
from __future__ import annotations

from .peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S

BF16 = 2


def _sizes(cfg: dict, batch: int):
    T = cfg["num_views"]
    N = T * (cfg["image_size"][0] // 4) * (cfg["image_size"][1] // 4)
    return (batch, cfg["dec_heads"], cfg["num_queries"], N,
            cfg["dec_dim"] // cfg["dec_heads"], cfg["dec_layers"])


def fwd_bound_s(cfg: dict, batch: int) -> float:
    B, H, Q, N, D, L = _sizes(cfg, batch)
    q_o = 2 * B * H * Q * D * BF16
    kv = B * N * 2 * H * D * BF16
    flops = 4 * B * H * Q * N * D
    return L * max(flops / BF16_FLOP_PER_S, (q_o + kv) / HBM_BYTES_PER_S)


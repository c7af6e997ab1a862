"""Sequence-parallel cross-attention over the memory-token axis (port of
parq_tpu/parallel/seq_parallel.py).

The memory's N tokens (and so their K/V) shard over the ranks of the
model group; each rank runs the flash kernels on its shard, and the
per-shard partials merge exactly. With m = max_i lse_i and
w_i = exp(lse_i − m):

    o   = Σ_i o_i · w_i / Σ_i w_i          (the global softmax output)
    lse = m + log Σ_i w_i                  (the global logsumexp)

one all_reduce(MAX) and two all_reduce(SUM) over the model group
(`merge_partials` in kernels/cross_attention.py is the same arithmetic).

Gradients: the merged (o, lse) drive the precomputed backward (B3) against
each rank's local K/V shard — p = exp(s − lse) is the true global softmax
probability of a local column, so dK and dV of the shard are exact. q is
replicated: each rank's B3 gives the dq of its own tokens, and `sum_grad`
sums them over the model group in the backward. (The JAX package gets that
sum from shard_map's replicated-q in_spec, and rescales by the mesh size in
`_scale_grad` to undo shard_map's split of a replicated cotangent; torch
splits nothing, so nothing is rescaled here.) The merge itself carries no
gradient (the forward with LSE is declared gradient-free, as in JAX).

Dropout: each shard draws with its own seed, seed + index·0x9E3779B1 in
int32 arithmetic, and shard-local kv columns, as the JAX package does: SP
draws other masks than one process (by design) and the same masks as the
JAX package's SP.

A group of one rank (or None) runs the plain single-device call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..kernels.cross_attention import (
    Seed, flash_cross_attention, flash_cross_attention_fwd_lse,
    flash_cross_attention_kv_fused, flash_cross_attention_precomputed,
    flash_fwd_lse)

# decorrelates the in-kernel dropout hash across shards: the mask column is
# shard-local, so identical seeds on every shard would draw identical masks
# for different global columns (parq_tpu/parallel/seq_parallel.py:52)
SHARD_SEED_STRIDE = 0x9E3779B1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def local_seed(dropout_seed: Seed, index: int):
    """The shard's seeds: seed + index·0x9E3779B1 with int32 wrap-around
    (JAX's `_local_seed`, :108-113), computed in int64 and folded back to
    int32 two's complement, so it equals JAX's bit for bit."""
    if dropout_seed is None:
        return None
    s = torch.as_tensor(dropout_seed).reshape(-1).to(torch.int64)
    x = (s + index * SHARD_SEED_STRIDE) & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the cotangent over a process group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """`x` in the forward; its gradient summed over `group` in the
    backward (a no-op for a group of one)."""
    if group_size(group) == 1 or not torch.is_grad_enabled() \
            or not x.requires_grad:
        return x
    return _SumGrad.apply(x, group)


class _ShardTokens(torch.autograd.Function):
    """The rank's contiguous block of the token axis (axis 1). The backward
    puts each rank's cotangent in its block of a zero tensor and sums over
    the group: every rank gets the full cotangent of every token (a sum,
    not an all_gather, because gloo has no all_gather of CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, group):
        size, idx = group_size(group), group_rank(group)
        n = x.shape[1] // size
        ctx.group, ctx.n, ctx.idx, ctx.shape = group, n, idx, x.shape
        return x[:, idx * n:(idx + 1) * n]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[:, ctx.idx * ctx.n:(ctx.idx + 1) * ctx.n] = g
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=ctx.group)
        return full, None


def shard_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the N tokens of x (B, N, ...); N must divide by
    the group's size. Its gradient is the full one on every rank."""
    size = group_size(group)
    if size == 1:
        return x
    if x.shape[1] % size:
        raise ValueError(f"N={x.shape[1]} not divisible by the model group's "
                         f"{size} ranks")
    return _ShardTokens.apply(x, group)


def merge_partials(o_i: torch.Tensor, lse_i: torch.Tensor, group):
    """LSE-weighted merge of the per-shard partials over `group` → the
    global (o in o_i's dtype, lse f32) on every rank (JAX's
    `_merge_partials`, :78-91). No gradient."""
    with torch.no_grad():
        m = lse_i.float().clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        w = torch.exp(lse_i.float() - m)
        num = o_i.float() * w[..., None]
        dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
        return (num / w[..., None]).to(o_i.dtype), m + torch.log(w)


def _check_natural(q, k, v):
    B, H, Q, D = q.shape
    if k.dim() != 3 or k.shape[-1] != H * D or v.shape != k.shape:
        raise ValueError("the SP path wants K/V in the natural (B, N, H·D) "
                         f"layout, got {tuple(k.shape)}")


def sp_flash_cross_attention_fwd_lse(q, k, v, *, group,
                                     dropout_rate: float = 0.0,
                                     dropout_seed: Seed = None,
                                     q_tile: Optional[int] = None,
                                     b_offset: int = 0):
    """The global (o, lse) over K/V shards: k and v are this rank's
    (B, N/size, H·D) shards, q (B, H, Q, D) is replicated. No gradient
    (JAX's `sp_flash_cross_attention_fwd_lse`, :176)."""
    _check_natural(q, k, v)
    o_i, lse_i = flash_cross_attention_fwd_lse(
        q, k, v, n_valid=k.shape[1], dropout_rate=dropout_rate,
        dropout_seed=local_seed(dropout_seed, group_rank(group)),
        q_tile=q_tile, b_offset=b_offset)
    if group_size(group) == 1:
        return o_i, lse_i
    return merge_partials(o_i, lse_i, group)


def sp_flash_cross_attention_precomputed(q, k, v, o, lse, *, group,
                                         dropout_rate: float = 0.0,
                                         dropout_seed: Seed = None,
                                         q_tile: Optional[int] = None,
                                         b_offset: int = 0):
    """Differentiable SP attention whose forward is skipped: (o, lse) are
    the GLOBAL results of an identical earlier
    `sp_flash_cross_attention_fwd_lse` call. The backward is B3 on this
    rank's shard; dq is summed over the group (JAX's :251)."""
    _check_natural(q, k, v)
    return flash_cross_attention_precomputed(
        sum_grad(q, group), k, v, o, lse, n_valid=k.shape[1],
        dropout_rate=dropout_rate,
        dropout_seed=local_seed(dropout_seed, group_rank(group)),
        q_tile=q_tile, b_offset=b_offset)


def sp_flash_cross_attention(q, k, v, *, group, dropout_rate: float = 0.0,
                             dropout_seed: Seed = None,
                             q_tile: Optional[int] = None,
                             b_offset: int = 0):
    """Differentiable flash cross-attention with K/V sharded on the token
    axis over `group` (JAX's :115): the forward with LSE on the shard, the
    merge, then the precomputed form for the gradient. Returns the global
    output (B, H, Q, D), the same on every rank."""
    _check_natural(q, k, v)
    if group_size(group) == 1:
        return flash_cross_attention(
            q, k, v, n_valid=k.shape[1], dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, q_tile=q_tile, b_offset=b_offset)
    kw = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              q_tile=q_tile, b_offset=b_offset)
    o, lse = sp_flash_cross_attention_fwd_lse(q, k, v, group=group, **kw)
    return sp_flash_cross_attention_precomputed(q, k, v, o, lse, group=group,
                                                **kw)


def sp_flash_cross_attention_kv_fused(q: torch.Tensor, kv: torch.Tensor, *,
                                      group) -> torch.Tensor:
    """SP eval attention over this rank's shard of the fused (B, N/size,
    H·2D) K/V buffer: fused B2 with LSE at rate 0 (`flash_fwd_lse`) and the
    merge (JAX's :215). Inference only."""
    if group_size(group) == 1:
        return flash_cross_attention_kv_fused(q, kv)
    seeds = torch.zeros(1, dtype=torch.int32, device=q.device)
    o_i, lse_i = flash_fwd_lse(q.to(kv.dtype), kv, seeds, 0.0)
    return merge_partials(o_i, lse_i, group)[0]

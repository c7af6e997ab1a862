"""PARQ recurrent decoder (port of parq_tpu/models/decoder.py).

L iterations, weight-shared or not (a Python loop; the JAX package scans
the shared one). Per iteration: sinusoidal posemb of the reference points
→ query position MLP; project the points into every view and sample
pixel-aligned features (kernel B1); a post-norm decoder layer
(self-attention over the Q queries, cross-attention over the T·H·W memory
tokens through kernel B2, FFN); the four MLP heads; new reference points =
the detached normalized predicted centers. Outputs are stacked on a
leading L axis.

The memory K/V projection runs ONCE per forward (the memory is the same in
every iteration), as one matmul whose output columns are head-interleaved
``[K_h | V_h]``: the (B, N, H·2D) buffer kernels B2 and B3 read in place.

Training (``deterministic=False``) runs the JAX package's two-phase
batched-gradient fold (decoder.py:714-761) unless ``batched_grad`` is off,
the weights are unshared or the iterations are recomputed (`remat`; see
`PARQDecoder`).
The new reference points are detached, so the L iterations are
gradient-independent given their input points:
  1. a no-grad sequential pass yields the reference-point trajectory and
     each iteration's sampled features (B1) and attention output and
     logsumexp (B2, train form);
  2. ONE call over all L·Q rows, folded into the query axis, is the
     loss-bearing forward. Its sampler and attention forwards are skipped
     (the "precomputed" autograd entries); its backward runs B3 once and B4
     once over every folded row, and the self-attention and the heads'
     GroupNorm statistics run per group.
Dropout masks are a counter hash of one seed per (iteration, salt), drawn
on the step's generator and kept on the device (`DropoutDraws`), so group
g of phase 2 draws exactly what iteration g drew in phase 1 (the contract
of `_grouped_keep`, :77-87). The sequential
training path (``batched_grad=False``) is the fold's yardstick in the tests.

Parallel runs (`set_parallel`):
- data parallel: a rank holds rows b_offset .. b_offset + B − 1 of a
  global batch of B·data rows. Every mask is drawn for the global batch
  and the rank keeps its rows, and the flash kernels hash the global batch
  index, so the ranks together draw exactly what one process over the
  global batch draws.
- sequence parallel (a model group of more than one rank): the memory
  tokens shard over the group BEFORE the K/V projection
  (parq_tpu/models/decoder.py:648-656); each rank projects its block of
  tokens and the attention runs through parallel/seq_parallel.py. Eval
  keeps the fused K/V buffer (`sp_flash_cross_attention_kv_fused`);
  training projects K and V separately (``in_proj_weight[D:2D]`` and
  ``[2D:]``) for the split SP entries, as the JAX package does. Gradients:
  the token shard's backward hands every rank the full d(memory) (a sum
  over the group); the sampler's d(memory) is already full on every rank
  and is not summed; the K/V projection's weight gradients are partial
  per shard and are summed. Every parameter's gradient is then the same on
  every rank of the group and equals one process's.
- tensor parallelism (parallel/tensor_parallel.py, `shard_model_`): each
  decoder layer holds its rank's self-attention heads and FFN columns and
  runs them between `sum_grad` and `all_reduce_sum`, so every replicated
  activation and gradient is the same on each rank of the model group.
  The masks of the weight dropout and of the FFN's dropout are drawn for
  every head and column and the rank keeps its own, so the ranks draw
  what one process draws. The cross-attention is not sharded (the JAX
  rule's patterns for it match no parameter): its flash kernels run with
  every head on every rank.

Parameter names follow the reference checkpoint: ``refpoint``,
``parq_module.decoder.{position_encoder, layers.0.*}`` and
``mlp_heads.{sem_cls,center,size,rotation}_head``; an unshared decoder
adds ``iterations.{i}.{position_encoder, layer, mlp_heads}`` for i ≥ 1.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..geometry import (Camera, Pose, denormalize_points, inverse_sigmoid,
                        normalize_points)
from ..kernels import (flash_cross_attention_kv_fused,
                       pixel_aligned_features_kernel)
from ..kernels.cross_attention import (
    flash_cross_attention_kv_fused_fwd_lse,
    flash_cross_attention_kv_fused_precomputed,
    flash_cross_attention_kv_fused_train)
from ..kernels.dropout import draw_keep
from ..kernels.heads import detection_heads, engages as heads_engage
from ..kernels.pixel_align import (pixel_aligned_features_precomputed,
                                   pixel_aligned_features_train)
from ..ops.posemb import pos2posemb3d
from ..parallel.seq_parallel import (
    group_rank, group_size, shard_tokens, sp_flash_cross_attention,
    sp_flash_cross_attention_fwd_lse, sp_flash_cross_attention_kv_fused,
    sp_flash_cross_attention_precomputed, sum_grad)
from ..parallel.tensor_parallel import all_reduce_sum
from .mlp import MLP2, HeadMLP

# dropout-site salts, shared by the sequential and folded paths so their
# draws coincide (decoder.py:48-55)
SALT_SA_W = 0      # self-attention weight dropout
SALT_DROP1 = 1     # residual dropout after self-attention
SALT_CA_W = 2      # cross-attention weight dropout: the flash seed
SALT_DROP2 = 3     # residual dropout after cross-attention
SALT_FFN = 4       # dropout after the FFN ReLU
SALT_DROP3 = 5     # residual dropout after the FFN
N_SALTS = 6

# query axis of each decoder output (folding/unfolding the batched path)
_QUERY_AXIS = {"center_im": 2, "center_valid": 2}


class DropoutDraws:
    """The dropout of one training forward: one int64 seed per (iteration,
    salt), drawn by `torch.randint` on the step's `generator` and kept on
    the device, so no value goes back to the host. Each mask is a counter
    hash of its (iteration, salt) seed, its GLOBAL batch row and its column
    (the keep-mask kernel, kernels/dropout.py, with the flash kernels' v1
    hash), so a mask depends only on (iteration, salt, shape) and never on
    the order of the draws, and a data-parallel rank holding rows
    b_offset .. of the global batch draws those rows of the one-process
    mask (the seeds are the same on every rank)."""

    def __init__(self, rate: float, num_layers: int, device,
                 generator: Optional[torch.Generator] = None,
                 b_offset: int = 0):
        self.rate = float(rate)
        self.device = torch.device(device)
        self.b_offset = b_offset
        gdev = generator.device if generator is not None else "cpu"
        self.seeds = torch.randint(0, 2 ** 62, (num_layers, N_SALTS),
                                   generator=generator,
                                   device=gdev).to(self.device)

    def group_seeds(self, groups: Sequence[int], salt: int) -> torch.Tensor:
        """(G,) int64 seeds of `salt` for the iterations in `groups`: a
        strided view of the seed table where they are consecutive."""
        g = list(groups)
        if g == list(range(g[0], g[0] + len(g))):
            return self.seeds[g[0]:g[0] + len(g), salt]
        return torch.stack([self.seeds[l, salt] for l in g])

    def keep(self, groups: Sequence[int], salt: int, per_shape) -> torch.Tensor:
        """Keep masks of `per_shape` (leading axis: the rank's rows) for
        each iteration in `groups`, concatenated along axis 1."""
        B, inner = per_shape[0], tuple(per_shape[1:])
        G = len(groups)
        keep = draw_keep(self.group_seeds(groups, salt), B, self.b_offset,
                         math.prod(inner), self.rate)       # (B, G, M)
        return keep.view((B, G * inner[0]) + inner[1:])

    def flash_seeds(self, groups: Sequence[int]) -> torch.Tensor:
        """(G,) int32 seeds, one per iteration, for the flash kernels'
        hash: the salt's int64 seed modulo 2³¹ − 1, on the device."""
        return (self.group_seeds(groups, SALT_CA_W)
                % (2 ** 31 - 1)).to(torch.int32)


def apply_drop(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float):
    """where(keep, x / (1 − rate), 0), as the JAX package's `_apply_drop`."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def _heads_split(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H·hd) → (B, H, N, hd)."""
    B, N, F_ = x.shape
    return x.view(B, N, heads, F_ // heads).transpose(1, 2)


def self_attention(mha: nn.MultiheadAttention, q_in: torch.Tensor,
                   v_in: torch.Tensor, keep: Optional[torch.Tensor] = None,
                   rate: float = 0.0, tp_group=None) -> torch.Tensor:
    """Multi-head self-attention with q = k = `q_in` and values from
    `v_in`, on `mha`'s parameters: plain matmul + softmax (Q is small).
    `keep` (B, H, Q, Q): weight dropout, applied after the softmax.
    Under tensor parallelism (`tp_group`) `mha` holds this rank's heads
    (its q, k and v rows and its out_proj columns): the inputs' gradients
    are summed over the group and the output projection's partial sums
    reduced before its bias is added."""
    D, H = mha.embed_dim, mha.num_heads
    w, b = mha.in_proj_weight, mha.in_proj_bias
    Dl = w.shape[0] // 3                 # the rank's width: D / model
    Hl = H * Dl // D
    q_in, v_in = sum_grad(q_in, tp_group), sum_grad(v_in, tp_group)
    qk = F.linear(q_in, w[:2 * Dl], b[:2 * Dl])
    q = _heads_split(qk[..., :Dl], Hl) * (D // H) ** -0.5
    k = _heads_split(qk[..., Dl:], Hl)
    v = _heads_split(F.linear(v_in, w[2 * Dl:], b[2 * Dl:]), Hl)
    attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
    attn = apply_drop(attn.to(v.dtype), keep, rate)
    o = attn @ v                                     # (B, Hl, Q, hd)
    o = o.transpose(1, 2).reshape(q_in.shape[0], -1, Dl)
    if group_size(tp_group) == 1:
        return mha.out_proj(o)
    return all_reduce_sum(F.linear(o, mha.out_proj.weight),
                          tp_group) + mha.out_proj.bias


class QueryOutProjection(nn.Module):
    """The cross-attention's query and output projections alone
    (``q_proj``, ``out_proj``): the layer of an unshared iteration ≥ 1,
    whose memory K/V come from iteration 0's projection, as the JAX
    package hoists that projection to the decoder (decoder.py:615-686)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = dim, heads
        self.q_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer. Cross-attention takes the
    precomputed fused K/V buffer; this layer owns its query and output
    projections (``multihead_attn.in_proj_weight[:D]`` and ``out_proj``;
    with `kv_proj` off, ``multihead_attn`` is a `QueryOutProjection` and
    the layer carries no K/V weights). The LayerNorms use eps 1e-6, flax's
    default, as the JAX package does (the torch reference's 1e-5 differs
    from both).

    `groups` lists the decoder iterations whose queries the token axis
    holds (g-major, Q0 each): one for a sequential call, all L for the
    folded training call. Self-attention folds the groups into the batch
    axis, and every dropout site draws one mask per group."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 dropout_rate: float = 0.0, kv_proj: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ffn_dim = ffn_dim
        self.tp_group = None     # the model group under tensor parallelism
        self.self_attn = nn.MultiheadAttention(dim, heads, batch_first=True)
        self.multihead_attn = (
            nn.MultiheadAttention(dim, heads, batch_first=True) if kv_proj
            else QueryOutProjection(dim, heads))
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def fused_kv_projection(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight (H·2D, C), bias) of the memory K/V projection with
        head-interleaved output rows [K_h | V_h] per head."""
        mha = self.multihead_attn
        D, H = mha.embed_dim, mha.num_heads
        w, b = mha.in_proj_weight, mha.in_proj_bias
        wk = w[D:2 * D].view(H, 1, D // H, -1)
        wv = w[2 * D:].view(H, 1, D // H, -1)
        bk = b[D:2 * D].view(H, 1, D // H)
        bv = b[2 * D:].view(H, 1, D // H)
        return (torch.cat([wk, wv], dim=1).reshape(2 * D, -1),
                torch.cat([bk, bv], dim=1).reshape(2 * D))

    def cross_query(self, x: torch.Tensor) -> torch.Tensor:
        """The cross-attention's query projection of `x`."""
        mha = self.multihead_attn
        if isinstance(mha, QueryOutProjection):
            return mha.q_proj(x)
        D = mha.embed_dim
        return F.linear(x, mha.in_proj_weight[:D], mha.in_proj_bias[:D])

    def kv_projection(self, memory_tokens: torch.Tensor, fused: bool,
                      sp_group=None):
        """The memory's K/V: the fused (B, N, H·2D) buffer, or (k, v) as two
        natural (B, N, H·D) buffers. Under a sequence-parallel group
        `memory_tokens` is the rank's shard and the weights' gradients are
        summed over the group."""
        if fused:
            w, b = self.fused_kv_projection()
            return F.linear(memory_tokens, sum_grad(w, sp_group),
                            sum_grad(b, sp_group)).contiguous()
        mha = self.multihead_attn
        D = mha.embed_dim
        w, b = mha.in_proj_weight, mha.in_proj_bias
        return tuple(F.linear(memory_tokens, sum_grad(w[s], sp_group),
                              sum_grad(b[s], sp_group))
                     for s in (slice(D, 2 * D), slice(2 * D, 3 * D)))

    def _tp_part(self, n: int) -> slice:
        """This rank's block of `n` heads or FFN columns (all of them
        without tensor parallelism)."""
        per = n // group_size(self.tp_group)
        i = group_rank(self.tp_group)
        return slice(i * per, (i + 1) * per)

    def sa_keep(self, drops: DropoutDraws, groups: Sequence[int], B: int,
                Q0: int) -> torch.Tensor:
        """The self-attention weights' keep mask (B·G, H, Q0, Q0), drawn
        for every head; under tensor parallelism the rank's heads."""
        H = self.self_attn.num_heads
        keep = drops.keep(groups, SALT_SA_W, (B, 1, H, Q0, Q0))
        return keep[:, :, self._tp_part(H)].reshape(B * len(groups), -1,
                                                     Q0, Q0)

    def ffn_keep(self, drops: DropoutDraws, groups: Sequence[int], B: int,
                 Q0: int) -> torch.Tensor:
        """The keep mask after linear1's ReLU (B, G·Q0, F), drawn for every
        column; under tensor parallelism the rank's columns."""
        keep = drops.keep(groups, SALT_FFN, (B, Q0, self.ffn_dim))
        return keep[..., self._tp_part(self.ffn_dim)]

    def ffn(self, tgt: torch.Tensor, drops: Optional[DropoutDraws],
            groups: Sequence[int]) -> torch.Tensor:
        """linear2(drop(relu(linear1(tgt)))), before the residual dropout:
        under tensor parallelism on the rank's columns, the row-parallel
        partial sums reduced over the group before linear2's bias."""
        tp = self.tp_group
        h = F.relu(self.linear1(sum_grad(tgt, tp)))
        if drops is not None:
            h = apply_drop(h, self.ffn_keep(drops, groups, tgt.shape[0],
                                             tgt.shape[1] // len(groups)),
                           drops.rate)
        if group_size(tp) == 1:
            return self.linear2(h)
        return all_reduce_sum(F.linear(h, self.linear2.weight),
                              tp) + self.linear2.bias

    def forward(self, tgt: torch.Tensor, kv, query_pos: torch.Tensor,
                drops: Optional[DropoutDraws] = None,
                groups: Sequence[int] = (0,), aux_out: bool = False,
                precomputed: Optional[Dict[str, torch.Tensor]] = None,
                sp_group=None):
        """`kv`: the fused K/V buffer, or (k, v) under sequence-parallel
        training (`sp_group`, the model group: kv holds the rank's token
        shard). `drops`: the step's dropout (None: none). `aux_out`: also
        return {"attn_o", "attn_lse"} for a later folded call;
        `precomputed`: that dict, folded — the attention forward is skipped
        and only B3 runs."""
        B, GQ, C = tgt.shape
        G = len(groups)
        Q0 = GQ // G
        rate = drops.rate if drops is not None else 0.0
        mha = self.self_attn
        H = mha.num_heads

        def drop(x, salt):
            if drops is None:
                return x
            return apply_drop(x, drops.keep(groups, salt,
                                            (B, Q0) + tuple(x.shape[2:])),
                              rate)

        sa_keep = None
        if drops is not None:
            sa_keep = self.sa_keep(drops, groups, B, Q0)
        q_sa = (tgt + query_pos).reshape(B * G, Q0, C)
        sa = self_attention(mha, q_sa, tgt.reshape(B * G, Q0, C), sa_keep,
                            rate, self.tp_group).reshape(B, GQ, C)
        tgt = self.norm1(tgt + drop(sa, SALT_DROP1))

        mha = self.multihead_attn
        D = mha.embed_dim
        cq = _heads_split(self.cross_query(tgt + query_pos),
                          H)                         # (B, H, GQ, hd)
        sp = group_size(sp_group) > 1
        kv_t = kv if torch.is_tensor(kv) else kv[0]
        needs_grad = torch.is_grad_enabled() and (cq.requires_grad
                                                  or kv_t.requires_grad)
        aux = None
        kw = dict(dropout_rate=rate,
                  dropout_seed=(drops.flash_seeds(groups)
                                if drops is not None else None),
                  q_tile=Q0 if G > 1 else None,
                  b_offset=drops.b_offset if drops is not None else 0)
        if torch.is_tensor(kv) and drops is None and precomputed is None \
                and not aux_out and not needs_grad:  # eval form of B2
            q_in = cq.to(kv_t.dtype).contiguous()
            attn = (sp_flash_cross_attention_kv_fused(q_in, kv,
                                                      group=sp_group)
                    if sp else flash_cross_attention_kv_fused(q_in, kv))
        elif sp:
            k, v = kv
            spkw = dict(kw, group=sp_group)
            if precomputed is not None:
                attn = sp_flash_cross_attention_precomputed(
                    cq, k, v, precomputed["attn_o"], precomputed["attn_lse"],
                    **spkw)
            elif aux_out:
                attn, lse = sp_flash_cross_attention_fwd_lse(cq, k, v, **spkw)
                aux = {"attn_o": attn, "attn_lse": lse}
            else:
                attn = sp_flash_cross_attention(cq, k, v, **spkw)
        else:
            if precomputed is not None:
                attn = flash_cross_attention_kv_fused_precomputed(
                    cq, kv, precomputed["attn_o"], precomputed["attn_lse"],
                    **kw)
            elif aux_out:
                attn, lse = flash_cross_attention_kv_fused_fwd_lse(cq, kv,
                                                                   **kw)
                aux = {"attn_o": attn, "attn_lse": lse}
            else:
                attn = flash_cross_attention_kv_fused_train(cq, kv, **kw)
        ca = mha.out_proj(attn.transpose(1, 2).reshape(B, GQ, D))
        tgt = self.norm2(tgt + drop(ca, SALT_DROP2))

        tgt = self.norm3(tgt + drop(self.ffn(tgt, drops, groups),
                                    SALT_DROP3))
        return (tgt, aux) if aux_out else tgt


class _DecoderStack(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 dropout_rate: float):
        super().__init__()
        self.position_encoder = MLP2(384, dim, dim)
        self.layers = nn.ModuleList([DecoderLayer(dim, heads, ffn_dim,
                                                  dropout_rate)])


class _ParqModule(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 dropout_rate: float):
        super().__init__()
        self.decoder = _DecoderStack(dim, heads, ffn_dim, dropout_rate)


class _MLPHeads(nn.Module):
    def __init__(self, dim: int, num_semcls: int):
        super().__init__()
        self.sem_cls_head = HeadMLP(dim, (), num_semcls + 1)
        self.center_head = HeadMLP(dim, (dim, dim), 3)
        self.size_head = HeadMLP(dim, (), 3)
        self.rotation_head = HeadMLP(dim, (dim, dim), 6)


class _Iteration(nn.Module):
    """The own modules of decoder iteration i ≥ 1 when the iterations do
    not share weights (the JAX package's ``iteration_{i}``,
    decoder.py:783-792): its position encoder, its decoder layer without
    K/V weights, and its four heads."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 dropout_rate: float, num_semcls: int):
        super().__init__()
        self.position_encoder = MLP2(384, dim, dim)
        self.layer = DecoderLayer(dim, heads, ffn_dim, dropout_rate,
                                  kv_proj=False)
        self.mlp_heads = _MLPHeads(dim, num_semcls)


def _unfold_outputs(outputs: Dict[str, torch.Tensor], L: int):
    """(B, ..., L·Q, ...) folded outputs → (L, B, ..., Q, ...) stacks."""
    def unfold(name, x):
        ax = _QUERY_AXIS.get(name, 1)
        gq = x.shape[ax]
        x = x.reshape(x.shape[:ax] + (L, gq // L) + x.shape[ax + 1:])
        return x.movedim(ax, 0)
    return {k: unfold(k, v) for k, v in outputs.items()}


class PARQDecoder(nn.Module):
    """Learned reference points + the recurrent decoder.

    `share_weights` (the default, MODEL.DECODER.TRANSFORMER.SHARE_WEIGHTS):
    one iteration's modules run L times. Off: iteration 0 keeps the shared
    layout's modules and keys, so a reference-layout state_dict fills it
    (parq_tpu/io/torch_convert.py:227 maps it to ``iteration_0``), and
    iteration i ≥ 1 owns ``iterations.{i}`` (`_Iteration`); the memory K/V
    are still projected once, by iteration 0's layer.

    `remat` (TPU.REMAT): each training iteration runs under a
    non-reentrant `torch.utils.checkpoint`, the twin of
    ``nn.remat(DecoderIteration)`` (decoder.py:763): its activations are
    dropped after the forward and recomputed in the backward, which
    launches B1 and B2-train again. The recompute draws the same dropout:
    every mask is a counter hash of its (iteration, salt) seed, row and
    column (`DropoutDraws`), and the flash kernels' keep bits are a counter
    hash of (seed, b·H + h, row, kv column) with the seed fixed by
    (iteration, salt) too, so no state is consumed that a second draw would
    see changed; the checkpoint keeps no RNG state
    (``preserve_rng_state=False``), which a captured graph could not read.

    The two-phase fold runs only with shared weights, no remat and L > 1
    (decoder.py:714-722); otherwise training is sequential: B1 and
    B2-train forward per iteration, B3 and B4 backward per iteration."""

    def __init__(self, dim: int = 1024, heads: int = 4, ffn_dim: int = 768,
                 num_layers: int = 8, num_queries: int = 256,
                 num_semcls: int = 9,
                 scale: Tuple[float, ...] = (-3.0, 3.0, -2.0, 0.5, 0.25,
                                             5.25),
                 feat_size: Tuple[int, int] = (80, 60),
                 mean_size=None, dropout_rate: float = 0.1,
                 batched_grad: bool = True, share_weights: bool = True,
                 remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.scale = tuple(float(s) for s in scale)
        self.feat_size = tuple(feat_size)
        self.dropout_rate = dropout_rate
        self.batched_grad = batched_grad
        self.share_weights, self.remat = share_weights, remat
        self.refpoint = nn.Embedding(num_queries, 3)
        self.parq_module = _ParqModule(dim, heads, ffn_dim, dropout_rate)
        self.mlp_heads = _MLPHeads(dim, num_semcls)
        if not share_weights:
            self.iterations = nn.ModuleDict({
                str(i): _Iteration(dim, heads, ffn_dim, dropout_rate,
                                   num_semcls)
                for i in range(1, num_layers)})
        if mean_size is None:
            mean_size = torch.ones(num_semcls + 1, 3)
        self.register_buffer("mean_size",
                             torch.as_tensor(mean_size, dtype=torch.float32),
                             persistent=False)
        self.set_parallel()

    def set_parallel(self, sp_group=None, data_index: int = 0,
                     data: int = 1) -> None:
        """Sequence parallelism over `sp_group` (a model group; None or one
        rank: off), and this rank's place (`data_index` of `data`) in a
        data-parallel batch, for the dropout draws. A model sharded for
        tensor parallelism (parallel/tensor_parallel.py) refuses SP."""
        if sp_group is not None and any(
                m.tp_group is not None for m in self.modules()
                if isinstance(m, DecoderLayer)):
            raise ValueError("sequence parallelism on a model sharded for "
                             "tensor parallelism: the JAX package runs SP "
                             "with replicated state only")
        self.sp_group, self.data_index, self.data = sp_group, data_index, data

    def iteration_modules(self, l: int):
        """(position encoder, decoder layer, heads) of iteration `l`."""
        if self.share_weights or l == 0:
            dec = self.parq_module.decoder
            return dec.position_encoder, dec.layers[0], self.mlp_heads
        it = self.iterations[str(l)]
        return it.position_encoder, it.layer, it.mlp_heads

    def _iteration(self, ref, memory_hw, kv, camera, T_camera_local,
                   drops=None, groups=(0,), refs_only=False,
                   precomputed=None, diff_rows=None):
        """One recurrence step over the iterations in `groups` (folded
        g-major in the query axis). `refs_only`: the trajectory pass —
        only the center head runs, and the sampled features and attention
        (o, lse) come back for the folded call. `precomputed`: those,
        folded; their forwards are skipped. `diff_rows`: how many leading
        query rows have differentiable coordinates."""
        s = self.scale
        G = len(groups)
        position_encoder, layer, heads = self.iteration_modules(groups[0])
        pos_feat = position_encoder(pos2posemb3d(ref))
        query_metric = denormalize_points(ref, s)
        args = (memory_hw, query_metric, T_camera_local, camera,
                self.feat_size)
        if precomputed is not None:
            pix, center_im, center_valid = pixel_aligned_features_precomputed(
                *args, precomputed["pix"], diff_rows)
        elif torch.is_grad_enabled():
            pix, center_im, center_valid = pixel_aligned_features_train(
                *args, diff_rows)
        else:
            pix, center_im, center_valid = pixel_aligned_features_kernel(
                *args)
        out = layer(pix.to(pos_feat.dtype), kv, pos_feat, drops, groups,
                    aux_out=refs_only, precomputed=precomputed,
                    sp_group=self.sp_group)
        if refs_only:
            out, attn_aux = out
        elif heads_engage(out, ref, heads, G):   # the heads in 3 kernels
            new_ref, outputs = detection_heads(out, ref, heads,
                                               self.mean_size, s)
            return new_ref, {**outputs, "coord_pos": query_metric,
                             "center_im": center_im,
                             "center_valid": center_valid}

        center_offset = heads.center_head(out, n_groups=G)
        center_norm = torch.sigmoid(center_offset + inverse_sigmoid(ref))
        center_unnorm = denormalize_points(center_norm, s)
        new_ref = normalize_points(center_unnorm, s).detach()
        if refs_only:
            return new_ref, {"pix": pix, **attn_aux}

        cls_logits = heads.sem_cls_head(out, n_groups=G)
        size_scale = heads.size_head(out, n_groups=G)
        ortho6d = heads.rotation_head(out, n_groups=G)
        sem_cls_prob = torch.softmax(cls_logits, dim=-1).detach()
        size_unnorm = torch.exp(size_scale) * \
            self.mean_size[sem_cls_prob.argmax(dim=-1)]
        return new_ref, {
            "pred_logits": cls_logits,
            "center_unnormalized": center_unnorm,
            "size_unnormalized": size_unnorm,
            "ortho6d": ortho6d,
            "sem_cls_prob": sem_cls_prob,
            "coord_pos": query_metric,
            "center_im": center_im,
            "center_valid": center_valid,
        }

    def folds(self, deterministic: bool) -> bool:
        """Whether a forward takes the two-phase fold (decoder.py:714-722):
        training, with shared weights, no remat and L > 1."""
        return (not deterministic and self.batched_grad
                and self.share_weights and not self.remat
                and self.num_layers > 1)

    def forward(self, memory_hw: torch.Tensor, camera: Camera,
                T_camera_pseudoCam: Pose, T_world_pseudoCam: Pose,
                T_world_local: Pose, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """memory_hw (B, T, H, W, C) tokens; camera (B, T) at feature
        scale. Returns per-iteration stacks with a leading L axis.
        `deterministic=False` is the training forward: dropout drawn from
        `generator`, and the batched-gradient fold unless `batched_grad`
        is off."""
        B, T, H, W, C = memory_hw.shape
        L = self.num_layers
        Tl = T_world_local
        if Tl.data.dim() == 2:
            Tl = Pose(Tl.data[:, None, :])
        T_camera_local = T_camera_pseudoCam @ (T_world_pseudoCam.inverse()
                                               @ Tl)

        # K/V of the memory (the rank's token shard under SP): the fused
        # (B, N, H·2D) buffer, or (k, v) (B, N, H·D) where SP needs a
        # gradient (the SP entries with a backward take separate K and V)
        layer = self.parq_module.decoder.layers[0]
        tokens = shard_tokens(memory_hw.reshape(B, T * H * W, C),
                              self.sp_group)
        fused = group_size(self.sp_group) == 1 or (
            deterministic and not torch.is_grad_enabled())
        kv = layer.kv_projection(tokens, fused, self.sp_group)
        inputs = (memory_hw, kv, camera, T_camera_local)

        ref = torch.sigmoid(self.refpoint.weight)[None].expand(B, -1, 3)
        drops = None
        if not deterministic and self.dropout_rate > 0.0:
            drops = DropoutDraws(self.dropout_rate, L, memory_hw.device,
                                 generator, b_offset=self.data_index * B)
        if not self.folds(deterministic):
            remat = self.remat and torch.is_grad_enabled()
            outs = []
            for l in range(L):
                if remat:
                    ref, o = checkpoint(self._iteration, ref, *inputs, drops,
                                        (l,), use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    ref, o = self._iteration(ref, *inputs, drops, (l,))
                outs.append(o)
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

        # phase 1: the trajectory, with no gradient
        refs, auxes = [ref], []
        with torch.no_grad():
            r = ref.detach()
            for l in range(L):
                r, aux = self._iteration(r, *inputs, drops, (l,),
                                         refs_only=True)
                auxes.append(aux)
                if l < L - 1:
                    refs.append(r)
        fold_axis = {"pix": 1, "attn_o": 2, "attn_lse": 2}
        pre = {k: torch.cat([a[k] for a in auxes], dim=ax)
               for k, ax in fold_axis.items()}
        # phase 2: one folded call over the L·Q rows; only group 0 (the
        # learned reference points) has differentiable coordinates
        _, outputs = self._iteration(torch.cat(refs, dim=1), *inputs, drops,
                                     tuple(range(L)), precomputed=pre,
                                     diff_rows=ref.shape[1])
        return _unfold_outputs(outputs, L)

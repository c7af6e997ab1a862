"""PARQ recurrent decoder, eval mode (port of parq_tpu/models/decoder.py).

L weight-shared iterations (a Python loop; the JAX package scans). Per
iteration: sinusoidal posemb of the reference points → query position MLP;
project the points into every view and sample pixel-aligned features
(kernel B1); a post-norm decoder layer (self-attention over the Q queries,
cross-attention over the T·H·W memory tokens through kernel B2, FFN);
the four MLP heads; new reference points = the detached normalized
predicted centers. Outputs are stacked on a leading L axis.

The memory K/V projection runs ONCE per forward (the memory is the same in
every iteration), as one matmul whose output columns are head-interleaved
``[K_h | V_h]``: the (B, N, H·2D) buffer kernel B2 reads in place.

Parameter names follow the reference checkpoint: ``refpoint``,
``parq_module.decoder.{position_encoder, layers.0.*}`` and
``mlp_heads.{sem_cls,center,size,rotation}_head``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry import Camera, Pose, inverse_sigmoid
from ..kernels import (flash_cross_attention_kv_fused,
                       pixel_aligned_features_kernel)
from ..ops.posemb import pos2posemb3d
from .mlp import MLP2, HeadMLP


def normalize_points(p: torch.Tensor, s: Sequence[float]) -> torch.Tensor:
    """Metric coords → [0, 1]³ by the scene scale box."""
    return torch.stack([(p[..., 0] - s[0]) / (s[1] - s[0]),
                        (p[..., 1] - s[2]) / (s[3] - s[2]),
                        (p[..., 2] - s[4]) / (s[5] - s[4])], dim=-1)


def denormalize_points(p: torch.Tensor, s: Sequence[float]) -> torch.Tensor:
    return torch.stack([p[..., 0] * (s[1] - s[0]) + s[0],
                        p[..., 1] * (s[3] - s[2]) + s[2],
                        p[..., 2] * (s[5] - s[4]) + s[4]], dim=-1)


def _heads_split(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H·hd) → (B, H, N, hd)."""
    B, N, F_ = x.shape
    return x.view(B, N, heads, F_ // heads).transpose(1, 2)


def self_attention(mha: nn.MultiheadAttention, q_in: torch.Tensor,
                   v_in: torch.Tensor) -> torch.Tensor:
    """Multi-head self-attention with q = k = `q_in` and values from
    `v_in`, on `mha`'s parameters: plain matmul + softmax (Q is small)."""
    D, H = mha.embed_dim, mha.num_heads
    w, b = mha.in_proj_weight, mha.in_proj_bias
    qk = F.linear(q_in, w[:2 * D], b[:2 * D])
    q = _heads_split(qk[..., :D], H) * (D // H) ** -0.5
    k = _heads_split(qk[..., D:], H)
    v = _heads_split(F.linear(v_in, w[2 * D:], b[2 * D:]), H)
    attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
    o = attn.to(v.dtype) @ v                         # (B, H, Q, hd)
    return mha.out_proj(o.transpose(1, 2).reshape(q_in.shape[0], -1, D))


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer (eval). Cross-attention takes
    the precomputed fused K/V buffer; this layer owns its query and output
    projections (``multihead_attn.in_proj_weight[:D]`` and ``out_proj``)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(dim, heads, batch_first=True)
        self.multihead_attn = nn.MultiheadAttention(dim, heads,
                                                    batch_first=True)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

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

    def forward(self, tgt: torch.Tensor, kv: torch.Tensor,
                query_pos: torch.Tensor) -> torch.Tensor:
        q_sa = tgt + query_pos
        tgt = self.norm1(tgt + self_attention(self.self_attn, q_sa, tgt))

        mha = self.multihead_attn
        D, H = mha.embed_dim, mha.num_heads
        cq = F.linear(tgt + query_pos, mha.in_proj_weight[:D],
                      mha.in_proj_bias[:D])
        cq = _heads_split(cq, H)                     # (B, H, Q, hd)
        attn = flash_cross_attention_kv_fused(cq.to(kv.dtype).contiguous(),
                                              kv)
        ca = mha.out_proj(attn.transpose(1, 2).reshape(tgt.shape[0], -1, D))
        tgt = self.norm2(tgt + ca)

        ff = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + ff)


class _DecoderStack(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.position_encoder = MLP2(384, dim, dim)
        self.layers = nn.ModuleList([DecoderLayer(dim, heads, ffn_dim)])


class _ParqModule(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.decoder = _DecoderStack(dim, heads, ffn_dim)


class _MLPHeads(nn.Module):
    def __init__(self, dim: int, num_semcls: int):
        super().__init__()
        self.sem_cls_head = HeadMLP(dim, (), num_semcls + 1)
        self.center_head = HeadMLP(dim, (dim, dim), 3)
        self.size_head = HeadMLP(dim, (), 3)
        self.rotation_head = HeadMLP(dim, (dim, dim), 6)


class PARQDecoder(nn.Module):
    """Learned reference points + the weight-shared recurrent decoder."""

    def __init__(self, dim: int = 1024, heads: int = 4, ffn_dim: int = 768,
                 num_layers: int = 8, num_queries: int = 256,
                 num_semcls: int = 9,
                 scale: Tuple[float, ...] = (-3.0, 3.0, -2.0, 0.5, 0.25,
                                             5.25),
                 feat_size: Tuple[int, int] = (80, 60),
                 mean_size=None):
        super().__init__()
        self.num_layers = num_layers
        self.scale = tuple(float(s) for s in scale)
        self.feat_size = tuple(feat_size)
        self.refpoint = nn.Embedding(num_queries, 3)
        self.parq_module = _ParqModule(dim, heads, ffn_dim)
        self.mlp_heads = _MLPHeads(dim, num_semcls)
        if mean_size is None:
            mean_size = torch.ones(num_semcls + 1, 3)
        self.register_buffer("mean_size",
                             torch.as_tensor(mean_size, dtype=torch.float32),
                             persistent=False)

    def forward(self, memory_hw: torch.Tensor, camera: Camera,
                T_camera_pseudoCam: Pose, T_world_pseudoCam: Pose,
                T_world_local: Pose) -> Dict[str, torch.Tensor]:
        """memory_hw (B, T, H, W, C) tokens; camera (B, T) at feature
        scale. Returns per-iteration stacks with a leading L axis."""
        B, T, H, W, C = memory_hw.shape
        s = self.scale
        Tl = T_world_local
        if Tl.data.dim() == 2:
            Tl = Pose(Tl.data[:, None, :])
        T_camera_local = T_camera_pseudoCam @ (T_world_pseudoCam.inverse()
                                               @ Tl)

        dec = self.parq_module.decoder
        layer = dec.layers[0]
        w_kv, b_kv = layer.fused_kv_projection()
        kv = F.linear(memory_hw.reshape(B, T * H * W, C), w_kv, b_kv)
        kv = kv.contiguous()                         # (B, N, H·2D)

        ref = torch.sigmoid(self.refpoint.weight)[None].expand(B, -1, 3)
        heads = self.mlp_heads
        outs = []
        for _ in range(self.num_layers):
            pos_feat = dec.position_encoder(pos2posemb3d(ref))
            query_metric = denormalize_points(ref, s)
            pix, center_im, center_valid = pixel_aligned_features_kernel(
                memory_hw, query_metric, T_camera_local, camera,
                self.feat_size)
            out = layer(pix.to(pos_feat.dtype), kv, pos_feat)

            cls_logits = heads.sem_cls_head(out)
            center_offset = heads.center_head(out)
            size_scale = heads.size_head(out)
            ortho6d = heads.rotation_head(out)

            center_norm = torch.sigmoid(center_offset + inverse_sigmoid(ref))
            center_unnorm = denormalize_points(center_norm, s)
            sem_cls_prob = torch.softmax(cls_logits, dim=-1).detach()
            size_unnorm = torch.exp(size_scale) * \
                self.mean_size[sem_cls_prob.argmax(dim=-1)]
            outs.append({
                "pred_logits": cls_logits,
                "center_unnormalized": center_unnorm,
                "size_unnormalized": size_unnorm,
                "ortho6d": ortho6d,
                "sem_cls_prob": sem_cls_prob,
                "coord_pos": query_metric,
                "center_im": center_im,
                "center_valid": center_valid,
            })
            ref = normalize_points(center_unnorm, s).detach()
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

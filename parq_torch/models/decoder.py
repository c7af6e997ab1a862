"""PARQ recurrent decoder (port of parq_tpu/models/decoder.py).

L weight-shared iterations (a Python loop; the JAX package scans). Per
iteration: sinusoidal posemb of the reference points → query position MLP;
project the points into every view and sample pixel-aligned features
(kernel B1); a post-norm decoder layer (self-attention over the Q queries,
cross-attention over the T·H·W memory tokens through kernel B2, FFN);
the four MLP heads; new reference points = the detached normalized
predicted centers. Outputs are stacked on a leading L axis.

The memory K/V projection runs ONCE per forward (the memory is the same in
every iteration), as one matmul whose output columns are head-interleaved
``[K_h | V_h]``: the (B, N, H·2D) buffer kernels B2 and B3 read in place.

Training (``deterministic=False``) runs the JAX package's two-phase
batched-gradient fold (decoder.py:714-761) unless ``batched_grad`` is off.
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
Dropout draws come from one generator per (iteration, salt), seeded from
the step's generator, so group g of phase 2 draws exactly what iteration g
drew in phase 1 (the contract of `_grouped_keep`, :77-87). The sequential
training path (``batched_grad=False``) is the fold's yardstick in the tests.

Parameter names follow the reference checkpoint: ``refpoint``,
``parq_module.decoder.{position_encoder, layers.0.*}`` and
``mlp_heads.{sem_cls,center,size,rotation}_head``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry import Camera, Pose, inverse_sigmoid
from ..kernels import (flash_cross_attention_kv_fused,
                       pixel_aligned_features_kernel)
from ..kernels.cross_attention import (
    flash_cross_attention_kv_fused_fwd_lse,
    flash_cross_attention_kv_fused_precomputed,
    flash_cross_attention_kv_fused_train)
from ..kernels.pixel_align import (pixel_aligned_features_precomputed,
                                   pixel_aligned_features_train)
from ..ops.posemb import pos2posemb3d
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
    """The dropout of one training forward: one seed per (iteration,
    salt), drawn from the step's `generator`. Each draw seeds a fresh
    generator on `device`, so a mask depends only on (iteration, salt,
    shape) and never on the order of the draws."""

    def __init__(self, rate: float, num_layers: int, device,
                 generator: Optional[torch.Generator] = None):
        self.rate = float(rate)
        self.device = torch.device(device)
        gdev = generator.device if generator is not None else "cpu"
        self.seeds = torch.randint(0, 2 ** 62, (num_layers, N_SALTS),
                                   generator=generator, device=gdev).tolist()

    def keep(self, groups: Sequence[int], salt: int, per_shape) -> torch.Tensor:
        """Keep masks of `per_shape` for each iteration in `groups`,
        concatenated along axis 1."""
        masks = []
        for l in groups:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seeds[l][salt])
            masks.append(torch.rand(per_shape, generator=gen,
                                    device=self.device) < 1.0 - self.rate)
        return torch.cat(masks, dim=1) if len(masks) > 1 else masks[0]

    def flash_seeds(self, groups: Sequence[int]):
        """One int32 seed per iteration for the flash kernels' hash."""
        return [self.seeds[l][SALT_CA_W] % (2 ** 31 - 1) for l in groups]


def apply_drop(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float):
    """where(keep, x / (1 − rate), 0), as the JAX package's `_apply_drop`."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


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
                   v_in: torch.Tensor, keep: Optional[torch.Tensor] = None,
                   rate: float = 0.0) -> torch.Tensor:
    """Multi-head self-attention with q = k = `q_in` and values from
    `v_in`, on `mha`'s parameters: plain matmul + softmax (Q is small).
    `keep` (B, H, Q, Q): weight dropout, applied after the softmax."""
    D, H = mha.embed_dim, mha.num_heads
    w, b = mha.in_proj_weight, mha.in_proj_bias
    qk = F.linear(q_in, w[:2 * D], b[:2 * D])
    q = _heads_split(qk[..., :D], H) * (D // H) ** -0.5
    k = _heads_split(qk[..., D:], H)
    v = _heads_split(F.linear(v_in, w[2 * D:], b[2 * D:]), H)
    attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
    attn = apply_drop(attn.to(v.dtype), keep, rate)
    o = attn @ v                                     # (B, H, Q, hd)
    return mha.out_proj(o.transpose(1, 2).reshape(q_in.shape[0], -1, D))


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer. Cross-attention takes the
    precomputed fused K/V buffer; this layer owns its query and output
    projections (``multihead_attn.in_proj_weight[:D]`` and ``out_proj``).
    The LayerNorms use eps 1e-6, flax's default, as the JAX package does
    (the torch reference's 1e-5 differs from both).

    `groups` lists the decoder iterations whose queries the token axis
    holds (g-major, Q0 each): one for a sequential call, all L for the
    folded training call. Self-attention folds the groups into the batch
    axis, and every dropout site draws one mask per group."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = nn.MultiheadAttention(dim, heads, batch_first=True)
        self.multihead_attn = nn.MultiheadAttention(dim, heads,
                                                    batch_first=True)
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

    def forward(self, tgt: torch.Tensor, kv: torch.Tensor,
                query_pos: torch.Tensor,
                drops: Optional[DropoutDraws] = None,
                groups: Sequence[int] = (0,), aux_out: bool = False,
                precomputed: Optional[Dict[str, torch.Tensor]] = None):
        """`drops`: the step's dropout (None: none). `aux_out`: also return
        {"attn_o", "attn_lse"} for a later folded call; `precomputed`: that
        dict, folded — the attention forward is skipped and only B3 runs."""
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
            sa_keep = drops.keep(groups, SALT_SA_W,
                                 (B, 1, H, Q0, Q0)).reshape(B * G, H, Q0, Q0)
        q_sa = (tgt + query_pos).reshape(B * G, Q0, C)
        sa = self_attention(mha, q_sa, tgt.reshape(B * G, Q0, C), sa_keep,
                            rate).reshape(B, GQ, C)
        tgt = self.norm1(tgt + drop(sa, SALT_DROP1))

        mha = self.multihead_attn
        D = mha.embed_dim
        cq = F.linear(tgt + query_pos, mha.in_proj_weight[:D],
                      mha.in_proj_bias[:D])
        cq = _heads_split(cq, H)                     # (B, H, GQ, hd)
        needs_grad = torch.is_grad_enabled() and (cq.requires_grad
                                                  or kv.requires_grad)
        aux = None
        if drops is None and precomputed is None and not aux_out \
                and not needs_grad:                  # eval form of B2
            attn = flash_cross_attention_kv_fused(
                cq.to(kv.dtype).contiguous(), kv)
        else:
            kw = dict(dropout_rate=rate,
                      dropout_seed=(drops.flash_seeds(groups)
                                    if drops is not None else None),
                      q_tile=Q0 if G > 1 else None)
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

        ff = drop(F.relu(self.linear1(tgt)), SALT_FFN)
        tgt = self.norm3(tgt + drop(self.linear2(ff), SALT_DROP3))
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


def _unfold_outputs(outputs: Dict[str, torch.Tensor], L: int):
    """(B, ..., L·Q, ...) folded outputs → (L, B, ..., Q, ...) stacks."""
    def unfold(name, x):
        ax = _QUERY_AXIS.get(name, 1)
        gq = x.shape[ax]
        x = x.reshape(x.shape[:ax] + (L, gq // L) + x.shape[ax + 1:])
        return x.movedim(ax, 0)
    return {k: unfold(k, v) for k, v in outputs.items()}


class PARQDecoder(nn.Module):
    """Learned reference points + the weight-shared recurrent decoder."""

    def __init__(self, dim: int = 1024, heads: int = 4, ffn_dim: int = 768,
                 num_layers: int = 8, num_queries: int = 256,
                 num_semcls: int = 9,
                 scale: Tuple[float, ...] = (-3.0, 3.0, -2.0, 0.5, 0.25,
                                             5.25),
                 feat_size: Tuple[int, int] = (80, 60),
                 mean_size=None, dropout_rate: float = 0.1,
                 batched_grad: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.scale = tuple(float(s) for s in scale)
        self.feat_size = tuple(feat_size)
        self.dropout_rate = dropout_rate
        self.batched_grad = batched_grad
        self.refpoint = nn.Embedding(num_queries, 3)
        self.parq_module = _ParqModule(dim, heads, ffn_dim, dropout_rate)
        self.mlp_heads = _MLPHeads(dim, num_semcls)
        if mean_size is None:
            mean_size = torch.ones(num_semcls + 1, 3)
        self.register_buffer("mean_size",
                             torch.as_tensor(mean_size, dtype=torch.float32),
                             persistent=False)

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
        dec = self.parq_module.decoder
        heads = self.mlp_heads
        pos_feat = dec.position_encoder(pos2posemb3d(ref))
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
        out = dec.layers[0](pix.to(pos_feat.dtype), kv, pos_feat, drops,
                            groups, aux_out=refs_only,
                            precomputed=precomputed)
        if refs_only:
            out, attn_aux = out

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

        layer = self.parq_module.decoder.layers[0]
        w_kv, b_kv = layer.fused_kv_projection()
        kv = F.linear(memory_hw.reshape(B, T * H * W, C), w_kv, b_kv)
        kv = kv.contiguous()                         # (B, N, H·2D)
        inputs = (memory_hw, kv, camera, T_camera_local)

        ref = torch.sigmoid(self.refpoint.weight)[None].expand(B, -1, 3)
        drops = None
        if not deterministic and self.dropout_rate > 0.0:
            drops = DropoutDraws(self.dropout_rate, L, memory_hw.device,
                                 generator)
        if deterministic or not self.batched_grad or L == 1:
            outs = []
            for l in range(L):
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

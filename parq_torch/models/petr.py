"""PETR, the port's second multi-view 3D detector: the eval forward of
"PETR: Position Embedding Transformation for Multi-View 3D Object
Detection" (Liu, Wang, Zhang, Sun; ECCV 2022), megvii-research/PETR at
its published R50-DCN P4 setting (`config.PETRConfig`).

    img (B, N, 3, H, W) BGR 0..255, lidar2img (B, N, 4, 4)
      → caffe normalisation → ResNet-50 (caffe style, DCNv2 in stages 3
        and 4; `resnet_fpn.ResNetBody`) → CPFPN over C4, C5 → P4
        (stride 16): N·h·w tokens of width 256 (`input_proj`)
      → position encoding: the LID frustum (64 depth bins from 1 m) of
        every P4 pixel lifted to the lidar frame by lidar2img's inverse,
        normalised to `position_range`, inverse-sigmoid, 1x1 convs
        192 → 1024 → 256; plus the 3D sine encoding (camera, y, x) through
        `adapt_pos3d` (384 → 1024 → 256)
      → 900 queries: learned 3D reference points, their sine embedding
        through `query_embedding`; 6 post-norm decoder layers (self-attn,
        cross-attn over every token with the position encoding added to
        the keys, FFN 2048), the decoder's LayerNorm on each layer's output
      → per layer the class head (10 logits) and the box head (cx, cy, w,
        l, cz, h, sin, cos, vx, vy; the centre a sigmoid around the
        reference point's inverse sigmoid, scaled to `pc_range`).

Outputs ``all_cls_scores`` (L, B, Q, 10) and ``all_bbox_preds`` (L, B, Q,
10), float32, as PETRHead returns them; `evals.petr_decode` turns the last
layer's into detections. The image mask is all valid (1408 x 512 is a
multiple of 32, so nothing is padded): no key is masked. The
position encoder's out-of-range mask (a pixel whose frustum leaves the
range at more than half its depths) is computed as PETR computes it and,
as there, not applied.

What the port does differently, none of it in the mathematics:
- PETRHead's six class and box branches are one module in six slots
  (shared weights); the port holds one of each and runs it on the six
  layers' outputs at once.
- 1x1 convolutions on tokens run as matrix products on channels-last rows;
  the state dict keeps their (O, I, 1, 1) shapes.
- Attention is `F.scaled_dot_product_attention` at head dim 32 (the
  port's own flash kernels take head dims 64, 128 and 256).
- lidar2img is inverted on the device in float64 by cofactors
  (`geometry.invert_4x4`, capturable), where PETR inverts on the host in
  float64 with NumPy.
- Under bf16 autocast the geometry, norms' statistics and the heads'
  output layers stay float32.

Module names follow mmdet3d's (``img_backbone``, ``img_neck``,
``pts_bbox_head``) where a layer exists there; the decoder layers' own
names are the port's (see `PETRDecoderLayer`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device, telemetry
from ..config import PETRConfig
from ..geometry import inverse_sigmoid, invert_4x4
from ..ops.posemb import pos2posemb3d
from .resnet_fpn import ResNetBody, _resize

PETR_EPS = 1e-5          # mmdet's inverse_sigmoid and the frustum's clamp


class CPFPN(nn.Module):
    """PETR's neck (projects/mmdet3d_plugin/models/necks/cp_fpn.py): 1x1
    laterals (with bias) of C4 and C5, C5's lateral upsampled (nearest)
    and added to C4's, one 3x3 conv (with bias) on P4 only; P5 is its
    lateral as it is."""

    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1)])

    def forward(self, feats):
        lat = [m(f) for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + _resize(lat[i], lat[i - 1].shape[-2:],
                                              "nearest")
        return [self.fpn_convs[0](lat[0])] + lat[1:]


def lid_depths(depth_num: int, depth_start: float, depth_max: float
               ) -> torch.Tensor:
    """PETR's linear-increasing depth bins: d_i = start + (max − start) ·
    i (i + 1) / (n (n + 1)), i = 0..n−1 (float64, rounded once)."""
    i = torch.arange(depth_num, dtype=torch.float64)
    bin_size = (depth_max - depth_start) / (depth_num * (1 + depth_num))
    return (depth_start + bin_size * i * (i + 1)).float()


def frustum(cfg: PETRConfig) -> torch.Tensor:
    """(h, w, D, 4): per P4 pixel (its top-left corner in image pixels,
    u = j · W / w, v = i · H / h) and depth bin d, the homogeneous image
    point (u · d, v · d, d, 1) that img2lidar lifts to the lidar frame."""
    (W, H), (w, h) = cfg.image_size, cfg.feat_size
    d = lid_depths(cfg.depth_num, cfg.depth_start, cfg.position_range[3])
    v = torch.arange(h, dtype=torch.float32) * (H / h)
    u = torch.arange(w, dtype=torch.float32) * (W / w)
    vv, uu, dd = torch.meshgrid(v, u, d, indexing="ij")
    z = torch.clamp(dd, min=PETR_EPS)
    return torch.stack([uu * z, vv * z, dd, torch.ones_like(dd)], dim=-1)


def sine_encoding_3d(mask: torch.Tensor, num_feats: int,
                     temperature: float = 10000.0,
                     scale: float = 2 * math.pi, eps: float = 1e-6
                     ) -> torch.Tensor:
    """PETR's SinePositionalEncoding3D (normalize=True) of the padding mask
    (B, N, h, w), channels last: (B, N, h, w, 3 · num_feats), the camera,
    y and x embeddings in that order, each its num_feats/2 sines then its
    num_feats/2 cosines (PETR stacks them on dim 4 of a 5-d tensor: not
    interleaved)."""
    not_mask = (~mask).to(torch.int32)
    n = not_mask.cumsum(1, dtype=torch.float32)
    y = not_mask.cumsum(2, dtype=torch.float32)
    x = not_mask.cumsum(3, dtype=torch.float32)
    n = n / (n[:, -1:] + eps) * scale
    y = y / (y[:, :, -1:] + eps) * scale
    x = x / (x[:, :, :, -1:] + eps) * scale
    i = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(i, 2, rounding_mode="floor")
                            / num_feats)
    B, N, h, w = mask.shape

    def emb(p):
        p = p[..., None] / dim_t
        return torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()),
                           dim=4).view(B, N, h, w, -1)
    return torch.cat((emb(n), emb(y), emb(x)), dim=-1)


def conv1x1(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv2d, or a Sequential of them and ReLUs, on channels-last
    rows (..., C): each conv as the matrix product it is."""
    for m in (module if isinstance(module, nn.Sequential) else [module]):
        if isinstance(m, nn.Conv2d):
            x = F.linear(x, m.weight.flatten(1), m.bias)
        else:
            x = m(x)
    return x


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (``in_proj_weight`` (3D, D),
    ``in_proj_bias``, ``out_proj``) and its eval mathematics, the
    product of each head (D / heads wide) in
    `F.scaled_dot_product_attention`."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _heads(self, x: torch.Tensor, i: int) -> torch.Tensor:
        D = self.dim
        y = F.linear(x, self.in_proj_weight[i * D:(i + 1) * D],
                     self.in_proj_bias[i * D:(i + 1) * D])
        B, L, _ = y.shape
        return y.view(B, L, self.heads, D // self.heads).transpose(1, 2)

    def keys(self, key: torch.Tensor, value: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The projected keys and values (B, heads, L, D / heads)."""
        return self._heads(key, 1), self._heads(value, 2)

    def forward(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        q = self._heads(query, 0)
        o = F.scaled_dot_product_attention(q, k, v)
        B, _, Q, _ = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(B, Q, self.dim))


class PETRDecoderLayer(nn.Module):
    """mmcv's BaseTransformerLayer with PETR's operation order (self_attn,
    norm, cross_attn, norm, ffn, norm), post-norm, in eval: self-attention
    with q = k = tgt + query_pos, v = tgt; cross-attention with q = tgt +
    query_pos, k = memory + key_pos, v = memory; FFN Linear–ReLU–Linear;
    each added to its input before the norm."""

    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.cross_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim)
                                              for _ in range(3))

    def forward(self, tgt, query_pos, key, memory):
        """key = memory + key_pos."""
        q = tgt + query_pos
        k, v = self.self_attn.keys(q, tgt)
        tgt = self.norm1(tgt + self.self_attn(q, k, v))
        k, v = self.cross_attn.keys(key, memory)
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos, k, v))
        ffn = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + ffn)


def _final_f32(branch: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A head: its hidden layers under the caller's autocast, its output
    layer in float32."""
    for m in branch[:-1]:
        x = m(x)
    out = branch[-1]
    with torch.autocast(x.device.type, enabled=False):
        return F.linear(x.float(), out.weight, out.bias)


class PETRHead(nn.Module):
    """PETRHead's eval forward (projects/mmdet3d_plugin/models/
    dense_heads/petr_head.py, with_position and with_multiview), with the
    PETRTransformer's decoder inside it."""

    def __init__(self, cfg: PETRConfig):
        super().__init__()
        self.cfg = cfg
        D, Dn = cfg.embed_dims, cfg.depth_num
        self.input_proj = nn.Conv2d(D, D, 1)
        self.position_encoder = nn.Sequential(
            nn.Conv2d(3 * Dn, 4 * D, 1), nn.ReLU(), nn.Conv2d(4 * D, D, 1))
        self.adapt_pos3d = nn.Sequential(
            nn.Conv2d(3 * D // 2, 4 * D, 1), nn.ReLU(),
            nn.Conv2d(4 * D, D, 1))
        self.reference_points = nn.Embedding(cfg.num_query, 3)
        self.query_embedding = nn.Sequential(
            nn.Linear(3 * D // 2, D), nn.ReLU(), nn.Linear(D, D))
        self.layers = nn.ModuleList(
            [PETRDecoderLayer(D, cfg.num_heads, cfg.ffn_dim)
             for _ in range(cfg.num_layers)])
        self.post_norm = nn.LayerNorm(D)
        cls = []
        for _ in range(cfg.num_reg_fcs):
            cls += [nn.Linear(D, D), nn.LayerNorm(D), nn.ReLU()]
        self.cls_branch = nn.Sequential(*cls, nn.Linear(D, cfg.num_classes))
        reg = []
        for _ in range(cfg.num_reg_fcs):
            reg += [nn.Linear(D, D), nn.ReLU()]
        self.reg_branch = nn.Sequential(*reg, nn.Linear(D, cfg.code_size))
        nn.init.uniform_(self.reference_points.weight, 0.0, 1.0)
        r = cfg.position_range
        self.register_buffer("frustum", frustum(cfg), persistent=False)
        self.register_buffer("range_lo", torch.tensor(r[:3]),
                             persistent=False)
        self.register_buffer("range_span", torch.tensor(
            [r[3] - r[0], r[4] - r[1], r[5] - r[2]]), persistent=False)

    def position_embedding(self, lidar2img: torch.Tensor,
                           masks: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 3D position encoding (B, N, h, w, D) of every P4 pixel, and
        the padding mask `masks` (B, N, h, w) or'ed with the out-of-range
        mask: the pixels whose frustum points leave [0, 1] (after the
        normalisation to `position_range`) in more than half of the 3·D
        coordinates, as PETR's position_embeding computes it."""
        M = invert_4x4(lidar2img.double()).float()[:, :, None, None, None]
        g = self.frustum                                   # (h, w, D, 4)
        p = torch.stack([M[..., i, 0] * g[..., 0] + M[..., i, 1] * g[..., 1]
                         + M[..., i, 2] * g[..., 2] + M[..., i, 3] * g[..., 3]
                         for i in range(3)], dim=-1)       # (B,N,h,w,D,3)
        p = (p - self.range_lo) / self.range_span
        out = ((p > 1.0) | (p < 0.0)).flatten(-2).sum(-1) \
            > self.cfg.depth_num * 0.5
        p = inverse_sigmoid(p, eps=PETR_EPS).flatten(-2)   # (B,N,h,w,3D)
        return conv1x1(self.position_encoder, p), masks | out

    def forward(self, feats: torch.Tensor, lidar2img: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """feats (B, N, h, w, C) P4, channels last; lidar2img (B, N, 4,
        4) float32."""
        cfg = self.cfg
        B, N, h, w, _ = feats.shape
        D = cfg.embed_dims
        x = conv1x1(self.input_proj, feats)
        masks = torch.zeros((B, N, h, w), dtype=torch.bool,
                            device=feats.device)
        pos, _ = self.position_embedding(lidar2img, masks)
        pos = pos + conv1x1(self.adapt_pos3d,
                            sine_encoding_3d(masks, D // 2))
        ref = self.reference_points.weight                    # (Q, 3)
        query_pos = self.query_embedding(
            pos2posemb3d(ref, D // 2))[None].expand(B, -1, -1)
        memory = x.reshape(B, N * h * w, D)
        key = memory + pos.reshape(B, N * h * w, D)
        tgt = torch.zeros((B, cfg.num_query, D), dtype=torch.float32,
                          device=feats.device)
        outs = []
        for layer in self.layers:
            tgt = layer(tgt, query_pos, key, memory)
            outs.append(self.post_norm(tgt))
        outs = torch.nan_to_num(torch.stack(outs))            # (L, B, Q, D)
        cls = _final_f32(self.cls_branch, outs)
        reg = _final_f32(self.reg_branch, outs)
        return {"all_cls_scores": cls,
                "all_bbox_preds": self.decode_boxes(reg, ref)}

    def decode_boxes(self, reg: torch.Tensor, ref: torch.Tensor
                     ) -> torch.Tensor:
        """The box head's (..., Q, 10) with the centre decoded: cx, cy, cz
        = sigmoid(t + inverse_sigmoid(reference point)), scaled to
        `pc_range`; the rest as the head gives it."""
        pc = self.cfg.pc_range
        r = inverse_sigmoid(ref.float(), eps=PETR_EPS)
        cxy = torch.sigmoid(reg[..., 0:2] + r[:, 0:2])
        cz = torch.sigmoid(reg[..., 4:5] + r[:, 2:3])
        cx = cxy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
        cy = cxy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
        cz = cz * (pc[5] - pc[2]) + pc[2]
        return torch.cat([cx, cy, reg[..., 2:4], cz, reg[..., 5:]], dim=-1)


class PETRModel(nn.Module):
    """The PETR detector's eval forward (see the module's docstring)."""

    @telemetry.spanned("models.init")
    def __init__(self, cfg: PETRConfig = PETRConfig()):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = ResNetBody(cfg.resnet_name, cfg.style,
                                       cfg.stage_with_dcn)
        self.img_neck = CPFPN(cfg.neck_in_channels, cfg.embed_dims)
        self.pts_bbox_head = PETRHead(cfg)
        self.register_buffer("img_mean", torch.tensor(cfg.img_mean),
                             persistent=False)
        self.register_buffer("img_std", torch.tensor(cfg.img_std),
                             persistent=False)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch: img (B, N, 3, H, W) BGR in 0..255 (uint8 or float),
        lidar2img (B, N, 4, 4). bf16 runs under autocast."""
        img = batch["img"]
        B, N, _, H, W = img.shape
        dev = img.device
        # autocast's weight cache is off while a CUDA graph is captured
        # (parq_torch/graphs.py): the graph must hold every cast it reads
        capturing = dev.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        ctx = (torch.autocast(dev.type, dtype=torch.bfloat16,
                              cache_enabled=not capturing)
               if self.cfg.compute_dtype == "bfloat16"
               else contextlib.nullcontext())
        with ctx:
            x = (img.reshape(B * N, 3, H, W).float()
                 - self.img_mean.view(1, 3, 1, 1)) \
                / self.img_std.view(1, 3, 1, 1)
            x = x.contiguous(memory_format=torch.channels_last)
            feats = self.img_backbone(x)
            p4 = self.img_neck(feats[-len(self.cfg.neck_in_channels):])[0]
            tokens = p4.permute(0, 2, 3, 1).reshape(B, N, *p4.shape[-2:],
                                                    p4.shape[1])
            return self.pts_bbox_head(tokens, batch["lidar2img"].float())


def init_petr_weights(model: PETRModel, generator: torch.Generator) -> None:
    """Random init from `generator`, in parameter order: weights of rank
    ≥ 2 ~ N(0, 1/fan_in), biases 0, norm scales 1, the reference points ~
    U(0, 1) (PETRHead's init); the DCN offset convs zero, as mmcv
    initialises them (each DCN then starts as a plain conv). Frozen
    BatchNorm statistics stay at identity."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("reference_points.weight"):
                p.copy_(torch.rand(p.shape, generator=generator))
            elif ".conv_offset." in name:
                p.zero_()
            elif p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(math.prod(p.shape[1:])))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def build_petr_model(cfg: PETRConfig = PETRConfig(), seed: int = 0,
                     device=None, state_dict=None) -> PETRModel:
    """A PETRModel in eval mode on `device` (CUDA unless the caller names
    another), beside `build_model`: with `state_dict` loaded strictly
    where one is given, else with random weights from `seed`, drawn on the
    CPU, so that one seed gives the same weights on every device."""
    dev = resolve_device(device)
    if state_dict is not None:
        with torch.device(dev):
            model = PETRModel(cfg)
        model.load_state_dict(state_dict, strict=True)
        return model.eval()
    model = PETRModel(cfg)
    init_petr_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

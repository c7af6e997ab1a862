"""BEVFormer, the port's third detector and its first with state that
crosses samples: the eval forward of "BEVFormer: Learning Bird's-Eye-View
Representation from Multi-Camera Images via Spatiotemporal Transformers"
(Li et al., ECCV 2022), fundamentalvision/BEVFormer at its published base
setting (`config.BEVFormerConfig`), and `BEVStream`, the carry of
BEVFormer.forward_test in video test mode.

    img (B, N, 3, 900, 1600) BGR 0..255, lidar2img (B, N, 4, 4), can_bus
    (B, 18) absolute; the previous sample's BEV and CAN-bus, or neither
      → caffe normalisation, zero pad to 1600 x 928 → ResNet-101 (caffe
        style, DCNv2 in stages 3 and 4; `resnet_fpn.ResNetBody`) → mmdet's
        FPN over C3..C5 with one extra stride-2 conv: 4 levels of width
        256 (116 x 200 .. 15 x 25), plus the camera and level embeddings
      → the BEV queries (200 x 200, width 256) plus the CAN-bus MLP of the
        deltas; a learned row/column position
      → 6 encoder layers: temporal self-attention over (the previous BEV
        rotated by the ego's yaw change, the initial queries) at the BEV
        cells' centres shifted by the ego's translation; spatial
        cross-attention: each cell's 4 height anchors projected into
        every camera, the cameras it lands in sampled at their 4 levels
        and averaged; FFN 512; post-norm
      → the new BEV (what the next sample carries), and 6 decoder layers
        over 900 queries (self-attention, deformable attention over the
        BEV at the queries' reference points, FFN), each layer's box head
        refining the reference points; per layer the class head (10
        logits) and the box head (the centre a sigmoid around the
        reference point, scaled to `pc_range`), unshared.

Outputs ``bev_embed`` (B, 40,000, 256), ``all_cls_scores`` (L, B, Q, 10)
and ``all_bbox_preds`` (L, B, Q, 10), float32, as BEVFormerHead returns
them; `evals.petr_decode` (the same NMSFreeCoder) turns the last layer's
into detections.

The three deformable attentions run in `kernels.ms_deform_attn` (one
launch each, 18 a forward). The spatial cross-attention's rebatch is not
a buffer: BEVFormer gathers each camera's hit queries into max_len rows
(max_len read on the host, a sync a layer); here the kernel walks each
query's cameras from its column of the hit mask (B, N, Q) and sums them
in order, so nothing has a capacity and no rig can overflow one. The
offsets and logits are computed once on the 40,000 queries (the
published Linears run on copies of the same query for every camera).

What the port does differently, none of it in the mathematics:
- the rotation of the previous BEV is torchvision's tensor `rotate`
  (nearest, zero fill) written out on the device from the yaw change in
  a tensor, so the whole forward replays as one CUDA graph; the CAN-bus
  deltas, the shift and the angle are computed on the device in float64,
  as NumPy computes them on the host there;
- each layer's box head runs once: the decoder's refinement and the
  head's outputs read the same result;
- the anchors' projection is written out as sums in float32 (the
  published code takes a float32 matmul with TF32 off);
- under bf16 autocast the geometry, the reference points, the norms'
  statistics and the heads' output layers stay float32, and the carried
  BEV is float32 (the encoder's last LayerNorm).

Module names follow BEVFormer's (``img_backbone``, ``img_neck``,
``pts_bbox_head.transformer.encoder.layers.{i}.attentions.{0,1}``, ...).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device, telemetry
from ..config import BEVFormerConfig
from ..geometry import inverse_sigmoid
from ..kernels.ms_deform_attn import ms_deform_attn
from .petr import MultiheadAttention, _final_f32
from .resnet_fpn import ResNetBody, _resize

EPS = 1e-5                # point_sampling's depth floor; inverse_sigmoid's


def _f32(t: torch.Tensor):
    """A region outside autocast on `t`'s device."""
    return torch.autocast(t.device.type, enabled=False)


class FPN(nn.Module):
    """mmdet's FPN (start_level 0, add_extra_convs 'on_output',
    relu_before_extra_convs): 1x1 laterals, the top-down nearest upsample
    and add, a 3x3 conv on each; extra 3x3 stride-2 convs up to
    `num_outs`, the first on the last output as it is, each later one on
    the ReLU of the one before."""

    def __init__(self, in_channels, out_channels: int, num_outs: int):
        super().__init__()
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1)
             for _ in range(n)]
            + [nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)
               for _ in range(num_outs - n)])

    def forward(self, feats):
        lat = [m(f) for m, f in zip(self.lateral_convs, feats)]
        n = len(lat)
        for i in range(n - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + _resize(lat[i], lat[i - 1].shape[-2:],
                                              "nearest")
        outs = [self.fpn_convs[i](lat[i]) for i in range(n)]
        for i in range(n, len(self.fpn_convs)):
            outs.append(self.fpn_convs[i](
                outs[-1] if i == n else F.relu(outs[-1])))
        return outs


class FFN(nn.Module):
    """mmcv's FFN (2 fcs, ReLU, identity added): ``layers.0.0`` and
    ``layers.1``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, hidden), nn.ReLU()),
            nn.Linear(hidden, dim))

    def forward(self, x):
        return x + self.layers(x)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., Nv, C) → (..., Nv, heads, C / heads)."""
    return x.view(*x.shape[:-1], heads, x.shape[-1] // heads)


class TemporalSelfAttention(nn.Module):
    """BEVFormer's TemporalSelfAttention (1 level, num_bev_queue 2): the
    offsets and logits of both queues from cat(first queue, query + pos),
    the (previous, current) pair sampled at the BEV cells' (shifted)
    centres, the queues' mean, output_proj, the residual."""

    def __init__(self, dim: int, heads: int, points: int):
        super().__init__()
        self.heads, self.points = heads, points
        self.sampling_offsets = nn.Linear(2 * dim, 2 * heads * points * 2)
        self.attention_weights = nn.Linear(2 * dim, 2 * heads * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, pos, pair, ref, shape):
        """query, pos (B, Q, C); pair (B, 2, Q, C) or None (the query
        twice); ref (B, Q, 2) float32; shape (h, w) of the BEV."""
        B, Q, C = query.shape
        if pair is None:
            pair = torch.stack([query, query], 1)
        # value[:bs] of the published (2B, Q, C) stack: at B = 1 the first
        # queue
        first = pair.reshape(B * 2, Q, C)[:B]
        q = torch.cat([first, query + pos], -1)
        Hh, P = self.heads, self.points
        off = self.sampling_offsets(q).view(B, Q, Hh, 2, 1, P, 2)
        logits = self.attention_weights(q).view(B, Q, Hh, 2, P)
        v = _heads(self.value_proj(pair), Hh)
        o = ms_deform_attn(v, [shape], ref[:, None, :, None, :], off,
                           logits)
        return self.output_proj(o) + query


class MSDeformableAttention3D(nn.Module):
    """The spatial cross-attention's sampler: offsets (H, L, P, 2) and
    logits (H, L · P) of each query, the value projection of the cameras'
    levels."""

    def __init__(self, dim: int, heads: int, levels: int, points: int):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)


class SpatialCrossAttention(nn.Module):
    """BEVFormer's SpatialCrossAttention: each query sampled in every
    camera its anchors land in (8 points a level, 2 a height anchor), the
    cameras summed and divided by their count (at least 1), output_proj,
    the residual."""

    def __init__(self, dim: int, heads: int, levels: int, points: int):
        super().__init__()
        self.deformable_attention = MSDeformableAttention3D(dim, heads,
                                                            levels, points)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, feats, shapes, ref_cam, hit):
        """query (B, Q, C); feats (B, N, Nv, C); ref_cam (B, N, Q, A, 2)
        float32; hit (B, N, Q) bool."""
        B, Q, C = query.shape
        d = self.deformable_attention
        Hh, L, P = d.heads, d.levels, d.points
        off = d.sampling_offsets(query).view(B, Q, Hh, 1, L, P, 2)
        logits = d.attention_weights(query).view(B, Q, Hh, 1, L * P)
        v = _heads(d.value_proj(feats), Hh)
        o = ms_deform_attn(v, shapes, ref_cam, off, logits, hit)
        return self.output_proj(o) + query


class EncoderLayer(nn.Module):
    """BEVFormerLayer: self_attn (TSA), norm, cross_attn (SCA), norm, ffn,
    norm."""

    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        D, Hh = cfg.embed_dims, cfg.num_heads
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(D, Hh, cfg.tsa_points),
            SpatialCrossAttention(D, Hh, cfg.num_levels, cfg.sca_points)])
        self.ffns = nn.ModuleList([FFN(D, cfg.ffn_dim)])
        self.norms = nn.ModuleList([nn.LayerNorm(D) for _ in range(3)])

    def forward(self, x, pos, pair, ref, bev_shape, feats, shapes, ref_cam,
                hit):
        x = self.norms[0](self.attentions[0](x, pos, pair, ref, bev_shape))
        x = self.norms[1](self.attentions[1](x, feats, shapes, ref_cam, hit))
        return self.norms[2](self.ffns[0](x))


class SelfAttention(nn.Module):
    """mmcv's MultiheadAttention in a decoder layer: q = k = tgt +
    query_pos, v = tgt, the residual (`attn` holds nn.MultiheadAttention's
    parameters)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(dim, heads)

    def forward(self, tgt, pos):
        q = tgt + pos
        k, v = self.attn.keys(q, tgt)
        return tgt + self.attn(q, k, v)


class CustomMSDeformableAttention(nn.Module):
    """The decoder's deformable attention over the BEV (1 level): offsets
    and logits from query + query_pos, sampled at the reference points,
    output_proj, the residual."""

    def __init__(self, dim: int, heads: int, points: int):
        super().__init__()
        self.heads, self.points = heads, points
        self.sampling_offsets = nn.Linear(dim, heads * points * 2)
        self.attention_weights = nn.Linear(dim, heads * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, tgt, pos, bev, shape, ref):
        """ref (B, Q, 2) float32."""
        B, Q, C = tgt.shape
        q = tgt + pos
        Hh, P = self.heads, self.points
        off = self.sampling_offsets(q).view(B, Q, Hh, 1, 1, P, 2)
        logits = self.attention_weights(q).view(B, Q, Hh, 1, P)
        v = _heads(self.value_proj(bev), Hh)[:, None]
        o = ms_deform_attn(v, [shape], ref[:, None, :, None, :], off,
                           logits)
        return self.output_proj(o) + tgt


class DecoderLayer(nn.Module):
    """DetrTransformerDecoderLayer: self_attn, norm, cross_attn (over the
    BEV), norm, ffn, norm."""

    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        D, Hh = cfg.embed_dims, cfg.num_heads
        self.attentions = nn.ModuleList([
            SelfAttention(D, Hh),
            CustomMSDeformableAttention(D, Hh, cfg.decoder_points)])
        self.ffns = nn.ModuleList([FFN(D, cfg.ffn_dim)])
        self.norms = nn.ModuleList([nn.LayerNorm(D) for _ in range(3)])

    def forward(self, tgt, pos, bev, shape, ref):
        tgt = self.norms[0](self.attentions[0](tgt, pos))
        tgt = self.norms[1](self.attentions[1](tgt, pos, bev, shape, ref))
        return self.norms[2](self.ffns[0](tgt))


def bev_shift(cfg: BEVFormerConfig, can: torch.Tensor) -> torch.Tensor:
    """get_bev_features' shift (B, 2) (x, y) in BEV fractions, from the
    delta CAN-bus rows (B, 18) float64: the translation's length along
    the ego's absolute yaw (can[:, -2], radians) less its own angle."""
    pc = cfg.pc_range
    gy = (pc[4] - pc[1]) / cfg.bev_h
    gx = (pc[3] - pc[0]) / cfg.bev_w
    dx, dy = can[:, 0], can[:, 1]
    ego = can[:, -2] / math.pi * 180
    length = torch.sqrt(dx ** 2 + dy ** 2)
    angle = torch.atan2(dy, dx) / math.pi * 180
    bev = ego - angle
    sy = length * torch.cos(bev / 180 * math.pi) / gy / cfg.bev_h
    sx = length * torch.sin(bev / 180 * math.pi) / gx / cfg.bev_w
    return torch.stack([sx, sy], -1).float()


def can_bus_deltas(can_bus: torch.Tensor,
                   prev_can_bus: Optional[torch.Tensor]) -> torch.Tensor:
    """forward_test's CAN-bus rows (B, 18), float64: with the previous
    sample's, the position [:3] and the yaw in degrees [-1] less the
    previous ones; at a scene's first sample both zero. The yaw in
    radians [-2] stays absolute."""
    c = can_bus.double()
    i = torch.arange(c.shape[-1], device=c.device)
    keep = ((i >= 3) & (i < c.shape[-1] - 1)).double()
    if prev_can_bus is None:
        return c * keep
    return c - prev_can_bus.double() * (1 - keep)


def rotation_grid(base: torch.Tensor, angle: torch.Tensor, center,
                  size) -> torch.Tensor:
    """torchvision's tensor `rotate` grid (expand=False) of (B,) angles in
    degrees (float64) about `center` (x, y) for a (H, W) map whose base
    grid `base` (H, W, 3) is (x, y, 1) at the pixel centres less the
    map's centre: (B, H, W, 2) for grid_sample(align_corners=False)."""
    H, W = size
    cx, cy = center[0] - W * 0.5, center[1] - H * 0.5
    rot = torch.deg2rad(-angle)
    cos, sin = torch.cos(rot), torch.sin(rot)
    # _get_inverse_affine_matrix(center, -angle, 0, 1, 0): [d, -b, ., -c,
    # a, .] with a = d = cos, b = -sin, c = sin; then the centre terms
    m0, m1, m3, m4 = cos, sin, -sin, cos
    m2 = m0 * (-cx) + m1 * (-cy) + cx
    m5 = m3 * (-cx) + m4 * (-cy) + cy
    theta = torch.stack([torch.stack([m0, m1, m2], -1),
                         torch.stack([m3, m4, m5], -1)], -2).float()
    t = theta.transpose(1, 2)                                  # (B, 3, 2)
    scaled = torch.stack([t[..., 0] / (0.5 * W), t[..., 1] / (0.5 * H)], -1)
    B = angle.shape[0]
    return torch.bmm(base.reshape(1, H * W, 3).expand(B, -1, -1),
                     scaled).view(B, H, W, 2)


def rotate_bev(prev_bev: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The previous BEV (B, H · W, C) resampled at `grid` (B, H, W, 2):
    nearest, zero fill."""
    B, _, C = prev_bev.shape
    H, W = grid.shape[1:3]
    m = prev_bev.float().view(B, H, W, C).permute(0, 3, 1, 2)
    r = F.grid_sample(m, grid, mode="nearest", padding_mode="zeros",
                      align_corners=False)
    return r.permute(0, 2, 3, 1).reshape(B, H * W, C)


class BEVFormerHead(nn.Module):
    """BEVFormerHead with its PerceptionTransformer (``transformer``): the
    BEV encoder, the decoder with box refinement and the six unshared
    class and box branches."""

    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        D, Q = cfg.embed_dims, cfg.bev_h * cfg.bev_w
        t = self.transformer = nn.Module()
        t.level_embeds = nn.Parameter(torch.randn(cfg.num_levels, D))
        t.cams_embeds = nn.Parameter(torch.randn(cfg.num_cams, D))
        t.reference_points = nn.Linear(D, 3)
        t.can_bus_mlp = nn.Sequential(
            nn.Linear(cfg.can_bus_dims, D // 2), nn.ReLU(),
            nn.Linear(D // 2, D), nn.ReLU())
        t.can_bus_mlp.add_module("norm", nn.LayerNorm(D))
        t.encoder, t.decoder = nn.Module(), nn.Module()
        t.encoder.layers = nn.ModuleList([EncoderLayer(cfg)
                                          for _ in range(cfg.encoder_layers)])
        t.decoder.layers = nn.ModuleList([DecoderLayer(cfg)
                                          for _ in range(cfg.decoder_layers)])
        cls, reg = [], []
        for _ in range(cfg.decoder_layers):
            c = []
            for _ in range(cfg.num_reg_fcs):
                c += [nn.Linear(D, D), nn.LayerNorm(D), nn.ReLU()]
            cls.append(nn.Sequential(*c, nn.Linear(D, cfg.num_classes)))
            r = []
            for _ in range(cfg.num_reg_fcs):
                r += [nn.Linear(D, D), nn.ReLU()]
            reg.append(nn.Sequential(*r, nn.Linear(D, cfg.code_size)))
        self.cls_branches = nn.ModuleList(cls)
        self.reg_branches = nn.ModuleList(reg)
        self.bev_embedding = nn.Embedding(Q, D)
        self.query_embedding = nn.Embedding(cfg.num_query, 2 * D)
        pe = self.positional_encoding = nn.Module()
        pe.row_embed = nn.Embedding(cfg.bev_h, D // 2)
        pe.col_embed = nn.Embedding(cfg.bev_w, D // 2)
        self._geometry(cfg)

    def _geometry(self, cfg: BEVFormerConfig) -> None:
        """Buffers the forward reads: the pillar anchors in the lidar
        frame (A, Q, 3), the cells' centres (Q, 2) in [0, 1], the rotation's
        base grid (H, W, 3)."""
        H, W, A = cfg.bev_h, cfg.bev_w, cfg.num_points_in_pillar
        pc = cfg.pc_range
        Z = pc[5] - pc[2]
        zs = torch.linspace(0.5, Z - 0.5, A).view(-1, 1, 1) \
            .expand(A, H, W) / Z
        xs = torch.linspace(0.5, W - 0.5, W).view(1, 1, W) \
            .expand(A, H, W) / W
        ys = torch.linspace(0.5, H - 0.5, H).view(1, H, 1) \
            .expand(A, H, W) / H
        r = torch.stack((xs, ys, zs), -1).reshape(A, H * W, 3)
        lo = torch.tensor(pc[:3])
        span = torch.tensor(pc[3:]) - lo
        self.register_buffer("anchors", r * span + lo, persistent=False)
        y, x = torch.meshgrid(torch.linspace(0.5, H - 0.5, H),
                              torch.linspace(0.5, W - 0.5, W), indexing="ij")
        self.register_buffer("centres", torch.stack(
            (x.reshape(-1) / W, y.reshape(-1) / H), -1), persistent=False)
        base = torch.ones(H, W, 3)
        base[..., 0] = torch.linspace(-W * 0.5 + 0.5, W * 0.5 - 0.5, W)
        base[..., 1] = torch.linspace(-H * 0.5 + 0.5, H * 0.5 - 0.5,
                                      H)[:, None]
        self.register_buffer("rotation_base", base, persistent=False)

    def point_sampling(self, lidar2img: torch.Tensor):
        """The anchors through lidar2img (B, N, 4, 4), float32: ref_cam
        (B, N, Q, A, 2) (u, v over the padded image's W and H) and hit
        (B, N, Q): some anchor at depth > 1e-5 with 0 < u, v < 1."""
        W, H = self.cfg.padded_size
        with _f32(lidar2img):
            m = lidar2img.float()[:, :, None, None]        # (B, N, 1, 1, 4, 4)
            p = self.anchors                               # (A, Q, 3)
            x, y, z = p[..., 0], p[..., 1], p[..., 2]
            cam = [m[..., i, 0] * x + m[..., i, 1] * y + m[..., i, 2] * z
                   + m[..., i, 3] for i in range(3)]       # (B, N, A, Q)
            depth = cam[2]
            d = torch.clamp(depth, min=EPS)
            u, v = cam[0] / d / W, cam[1] / d / H
            mask = (depth > EPS) & (v > 0.0) & (v < 1.0) & (u < 1.0) \
                & (u > 0.0)
            ref = torch.stack([u, v], -1).permute(0, 1, 3, 2, 4)
            return ref.contiguous(), mask.any(2)

    def forward(self, feats, shapes, lidar2img, can_bus, prev_bev=None,
                prev_can_bus=None) -> Dict[str, torch.Tensor]:
        """feats (B, N, Nv, C) the cameras' levels with their embeddings,
        channels last; lidar2img (B, N, 4, 4); can_bus (B, 18) absolute;
        prev_bev (B, Q, C) and prev_can_bus (B, 18), or neither."""
        bev = self.encode(feats, shapes, lidar2img, can_bus, prev_bev,
                          prev_can_bus)
        cls, reg = self.decode(bev)
        return {"bev_embed": bev, "all_cls_scores": cls,
                "all_bbox_preds": reg}

    def encode(self, feats, shapes, lidar2img, can_bus, prev_bev=None,
               prev_can_bus=None) -> torch.Tensor:
        """The BEV encoder → the new BEV (B, Q, C) float32."""
        cfg, t = self.cfg, self.transformer
        D, Hb, Wb = cfg.embed_dims, cfg.bev_h, cfg.bev_w
        with _f32(can_bus):
            can = can_bus_deltas(can_bus, prev_can_bus)
            shift = bev_shift(cfg, can)
            ref = (self.centres + shift[:, None, :]).contiguous()
            ref_cam, hit = self.point_sampling(lidar2img)
        q = self.bev_embedding.weight[None] + t.can_bus_mlp(can.float())[
            :, None, :]
        pe = self.positional_encoding
        pos = torch.cat([pe.col_embed.weight[None].expand(Hb, -1, -1),
                         pe.row_embed.weight[:, None].expand(-1, Wb, -1)],
                        -1).reshape(1, Hb * Wb, D)
        pair = None
        if prev_bev is not None:
            with _f32(can):
                grid = rotation_grid(self.rotation_base, can[:, -1],
                                     cfg.rotate_center, (Hb, Wb))
                prev = rotate_bev(prev_bev, grid)
            pair = torch.stack([prev, q.float()], 1)
        x = q
        for layer in t.encoder.layers:
            x = layer(x, pos, pair, ref, (Hb, Wb), feats, shapes, ref_cam,
                      hit)
        return x.float()

    def decode(self, bev: torch.Tensor):
        """The decoder with box refinement and the heads → all_cls_scores,
        all_bbox_preds (L, B, Q, ...) float32."""
        cfg, t = self.cfg, self.transformer
        B, D = bev.shape[0], cfg.embed_dims
        qe = self.query_embedding.weight
        pos = qe[:, :D][None].expand(B, -1, -1)
        tgt = qe[:, D:][None].expand(B, -1, -1)
        with _f32(bev):
            ref = torch.sigmoid(F.linear(pos.float(),
                                         t.reference_points.weight,
                                         t.reference_points.bias))
        pc = cfg.pc_range
        cls, reg = [], []
        for i, layer in enumerate(t.decoder.layers):
            tgt = layer(tgt, pos, bev, (cfg.bev_h, cfg.bev_w),
                        ref[..., :2].contiguous())
            tmp = _final_f32(self.reg_branches[i], tgt)
            cls.append(_final_f32(self.cls_branches[i], tgt))
            with _f32(tmp):
                r = inverse_sigmoid(ref, EPS)
                cxy = torch.sigmoid(tmp[..., 0:2] + r[..., 0:2])
                cz = torch.sigmoid(tmp[..., 4:5] + r[..., 2:3])
                ref = torch.cat([cxy, cz], -1)
                reg.append(torch.cat([
                    cxy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
                    cxy[..., 1:2] * (pc[4] - pc[1]) + pc[1],
                    tmp[..., 2:4], cz * (pc[5] - pc[2]) + pc[2],
                    tmp[..., 5:]], -1))
        return torch.stack(cls), torch.stack(reg)


class BEVFormerModel(nn.Module):
    """The BEVFormer detector's eval forward (see the module's
    docstring)."""

    @telemetry.spanned("models.init")
    def __init__(self, cfg: BEVFormerConfig = BEVFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = ResNetBody(cfg.resnet_name, cfg.style,
                                       cfg.stage_with_dcn)
        self.img_neck = FPN(cfg.neck_in_channels, cfg.embed_dims,
                            cfg.num_levels)
        self.pts_bbox_head = BEVFormerHead(cfg)
        self.register_buffer("img_mean", torch.tensor(cfg.img_mean),
                             persistent=False)
        self.register_buffer("img_std", torch.tensor(cfg.img_std),
                             persistent=False)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch: img (B, N, 3, H, W) BGR in 0..255 (uint8 or float),
        lidar2img (B, N, 4, 4), can_bus (B, 18) absolute; with prev_bev
        (B, Q, C) and prev_can_bus (B, 18), the previous sample's (a
        carried frame). bf16 runs under autocast."""
        img = batch["img"]
        with self.autocast(img.device):
            feats, shapes = self.features(img)
            return self.pts_bbox_head(feats, shapes, batch["lidar2img"],
                                      batch["can_bus"],
                                      batch.get("prev_bev"),
                                      batch.get("prev_can_bus"))

    def autocast(self, dev: torch.device):
        """The forward's autocast region: bf16 where the configuration
        computes in it, else none."""
        if self.cfg.compute_dtype != "bfloat16":
            return contextlib.nullcontext()
        # autocast's weight cache is off while a CUDA graph is captured
        # (parq_torch/graphs.py): the graph must hold every cast it reads
        capturing = dev.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        return torch.autocast(dev.type, dtype=torch.bfloat16,
                              cache_enabled=not capturing)

    def features(self, img: torch.Tensor):
        """img (B, N, 3, H, W) → the cameras' FPN levels as value rows (B,
        N, Nv, C) with the camera and level embeddings added, and the
        levels' (h, w): normalised, zero-padded, through the body and the
        neck (under the caller's autocast)."""
        B, N, _, H, W = img.shape
        Wp, Hp = self.cfg.padded_size
        x = (img.reshape(B * N, 3, H, W).float()
             - self.img_mean.view(1, 3, 1, 1)) / self.img_std.view(1, 3, 1, 1)
        x = F.pad(x, (0, Wp - W, 0, Hp - H))
        x = x.contiguous(memory_format=torch.channels_last)
        levels = self.img_neck(self.img_backbone(x)[1:])
        t = self.pts_bbox_head.transformer
        flat, shapes = [], []
        for lvl, f in enumerate(levels):
            h, w = f.shape[-2:]
            f = f.permute(0, 2, 3, 1).reshape(B, N, h * w, f.shape[1])
            f = f + t.cams_embeds[None, :, None, :].to(f.dtype)
            f = f + t.level_embeds[None, None, lvl:lvl + 1, :].to(f.dtype)
            flat.append(f)
            shapes.append((h, w))
        return torch.cat(flat, 2), shapes


class BEVStream:
    """BEVFormer.forward_test's carry in video test mode, around a forward
    `fn` (a `graphs.Graphed` of the model on the card): per sample, a new
    scene id drops the previous BEV (a scene's first sample runs without
    one, its CAN-bus deltas zero); otherwise the previous sample's BEV and
    absolute CAN-bus go in beside the sample, and the forward forms the
    deltas, the shift and the rotation on the device. The call returns
    the forward's outputs and keeps their ``bev_embed`` and the sample's
    CAN-bus for the next one.

    The recorder sees the host half as the span ``bevformer.stream`` and
    counts ``bevformer.scene_resets`` and ``bevformer.prev_bev_carried``.
    """

    def __init__(self, fn):
        self.fn = fn
        self.reset()

    def reset(self) -> None:
        self.scene, self.prev_bev, self.prev_can_bus = None, None, None

    def __call__(self, sample: Dict[str, torch.Tensor], scene
                 ) -> Dict[str, torch.Tensor]:
        """sample: img, lidar2img and can_bus on the model's device;
        scene: the sample's scene id (any comparable value)."""
        with telemetry.span("bevformer.stream"):
            if scene != self.scene:
                self.prev_bev = self.prev_can_bus = None
                telemetry.count("bevformer.scene_resets")
            self.scene = scene
            x = {k: sample[k] for k in ("img", "lidar2img", "can_bus")}
            if self.prev_bev is not None:
                x["prev_bev"] = self.prev_bev
                x["prev_can_bus"] = self.prev_can_bus
                telemetry.count("bevformer.prev_bev_carried")
        with torch.inference_mode():
            out = self.fn(x)
        self.prev_bev, self.prev_can_bus = out["bev_embed"], x["can_bus"]
        return out


def init_bevformer_weights(model: BEVFormerModel,
                           generator: torch.Generator) -> None:
    """Random init from `generator`, in parameter order: weights of rank
    ≥ 2 ~ N(0, 1/fan_in) (the embeddings N(0, 1)), biases 0, norm scales
    1; the DCN offset convs zero, as mmcv initialises them. Frozen
    BatchNorm statistics stay at identity."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".conv_offset." in name:
                p.zero_()
            elif "embed" in name:
                p.copy_(torch.randn(p.shape, generator=generator))
            elif p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(math.prod(p.shape[1:])))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def build_bevformer_model(cfg: BEVFormerConfig = BEVFormerConfig(),
                          seed: int = 0, device=None, state_dict=None
                          ) -> BEVFormerModel:
    """A BEVFormerModel in eval mode on `device` (CUDA unless the caller
    names another), beside `build_petr_model`: with `state_dict` loaded
    strictly where one is given, else with random weights from `seed`,
    drawn on the CPU."""
    dev = resolve_device(device)
    if state_dict is not None:
        with torch.device(dev):
            model = BEVFormerModel(cfg)
        model.load_state_dict(state_dict, strict=True)
        return model.eval()
    model = BEVFormerModel(cfg)
    init_bevformer_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

"""BEVFormer in plain PyTorch and NumPy: the reference that decides
`correct` in the BEVFormer cell, and the one the port's CPU tests hold it
to.

The eval forward, the temporal carry and the NMS-free decode of
BEVFormer-base ("BEVFormer: Learning Bird's-Eye-View Representation from
Multi-Camera Images via Spatiotemporal Transformers", Li et al., ECCV
2022), written from the paper and from fundamentalvision/BEVFormer
(projects/configs/bevformer/bevformer_base.py and the plugin's
transformer.py, encoder.py, temporal_self_attention.py,
spatial_cross_attention.py, decoder.py, bevformer.py, bevformer_head.py,
nms_free_coder.py): caffe-style ResNet-101 with DCNv2 in stages 3 and 4
(PETR's reference's block and DCN, `reference.petr`), mmdet's FPN with
its extra output conv, the BEV encoder (temporal self-attention, spatial
cross-attention with the published rebatch by `max_len`, FFN), the
decoder with box refinement, the six unshared heads, forward_test's
CAN-bus deltas and the rotation of the previous BEV. It imports nothing
of the measured program and takes no tensor the program made except the
previous BEV it carried (the reference runs the program's own carry):
weights come from `benchmark.weights_bevformer`, inputs from
`benchmark.data_bevformer`.

Everything runs in float32 with TF32 off (the caller sets the switches:
`benchmark.checks.no_tf32`), the CAN-bus arithmetic in float64 as NumPy
does it there. Multi-scale deformable attention is mmcv's
`multi_scale_deformable_attn_pytorch`: one `grid_sample` a level
(bilinear, align_corners=False, zero padding) and the softmax weights.
The rotation of the previous BEV is torchvision's tensor `rotate`
(nearest, zero fill, expand=False) written out: its inverse affine
matrix, its grid, `grid_sample(mode="nearest")`. `Precision("fp8")`
(from the PARQ reference) rounds every operand of a matrix product or
convolution to float8 e4m3 with a per-tensor scale: the control.

Departures from the published model, none in its mathematics:
- random weights (`weights_bevformer`), not the released checkpoint; the
  DCN offset convs and the deformable attentions' offset Linears are
  drawn at scales that move the sampling points by a few pixels or
  cells, and the attention logits away from uniform;
- the six-camera rig and the ego trajectory are nuScenes-like and
  synthetic (`data_bevformer`);
- the caffe normalisation and the zero pad to a multiple of 32 run
  inside the forward, where mmdet3d's loader does them;
- the published code shifts the reference points of both queues of the
  temporal self-attention (`shift_ref_2d = ref_2d` adds in place; the
  authors keep it "for reproducing our results"): so does this file;
- the first extra FPN conv reads the last output without a ReLU, as
  mmdet's FPN does for `add_extra_convs='on_output'` (its
  `relu_before_extra_convs` applies to the convs after the first);
- the decode ranks the logits with ties broken by index
  (`reference.petr.decode`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import Precision
from .petr import (POINTS, _bn, attention, dcn, decode, decode_mismatch,
                   inverse_sigmoid, layer_norm)

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
EPS = 1e-5                 # point_sampling's depth floor


# ---- sizes ----------------------------------------------------------------

def padded_size(cfg: dict) -> Tuple[int, int]:
    d = cfg["size_divisor"]
    return tuple(-(-n // d) * d for n in cfg["image_size"])


def level_shapes(cfg: dict) -> List[Tuple[int, int]]:
    """(h, w) of the FPN's levels at the padded size."""
    W, H = padded_size(cfg)
    h, w = H, W
    for _ in range(2):
        h, w = -(-h // 2), -(-w // 2)
    shapes = []
    while len(shapes) < cfg["num_levels"]:
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    return shapes


# ---- the parameter layout -------------------------------------------------

def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model's state dict, in a
    fixed order. kind: "matrix" (N(0, 1/fan_in)), "head_out" (a head's
    output layer), "offset" (a DCN's offset conv), "msda_offset" (a
    deformable attention's offset Linear), "msda_logit" (its attention
    logits' Linear), "msda_ring" (the offset Linear's bias: mmcv's ring,
    computed, not drawn), "embed" (N(0, 1)), "uniform" (U(0, 1): the
    learned BEV positions), "bias" (0), "scale" (1), "bn_one" /
    "bn_zero" (frozen BatchNorm at identity), "bn_stem_var" (the stem
    BN's variance); `weights_bevformer` draws them."""
    specs = []

    def bn(prefix, n):
        for k, kind in (("weight", "bn_one"), ("bias", "bn_zero"),
                        ("running_mean", "bn_zero"),
                        ("running_var", "bn_one")):
            specs.append((f"{prefix}.{k}", (n,), kind))

    def lin(name, o, i, kind="matrix", bias="bias"):
        specs.extend([(f"{name}.weight", (o, i), kind),
                      (f"{name}.bias", (o,), bias)])

    def conv(name, o, i, k, kind="matrix"):
        specs.extend([(f"{name}.weight", (o, i, k, k), kind),
                      (f"{name}.bias", (o,), "bias")])

    def norm(name, n):
        specs.extend([(f"{name}.weight", (n,), "scale"),
                      (f"{name}.bias", (n,), "bias")])

    b = "img_backbone"
    specs.append((f"{b}.conv1.weight", (64, 3, 7, 7), "matrix"))
    bn(f"{b}.bn1", 64)
    specs[-1] = (f"{b}.bn1.running_var", (64,), "bn_stem_var")
    cin, width = 64, 64
    for si, blocks in enumerate(STAGES[cfg["resnet_name"]]):
        for bi in range(blocks):
            p = f"{b}.layer{si + 1}.{bi}"
            specs.append((f"{p}.conv1.weight", (width, cin, 1, 1), "matrix"))
            bn(f"{p}.bn1", width)
            specs.append((f"{p}.conv2.weight", (width, width, 3, 3),
                          "matrix"))
            if cfg["stage_with_dcn"][si]:
                conv(f"{p}.conv2.conv_offset", 3 * POINTS, width, 3,
                     "offset")
            bn(f"{p}.bn2", width)
            specs.append((f"{p}.conv3.weight", (4 * width, width, 1, 1),
                          "matrix"))
            bn(f"{p}.bn3", 4 * width)
            if bi == 0:
                specs.append((f"{p}.downsample.0.weight",
                              (4 * width, cin, 1, 1), "matrix"))
                bn(f"{p}.downsample.1", 4 * width)
            cin = 4 * width
        width *= 2
    D, Hh = cfg["embed_dims"], cfg["num_heads"]
    for i, c in enumerate(cfg["neck_in_channels"]):
        conv(f"img_neck.lateral_convs.{i}", D, c, 1)
    for i in range(cfg["num_levels"]):
        conv(f"img_neck.fpn_convs.{i}", D, D, 3)
    h = "pts_bbox_head"
    t = f"{h}.transformer"
    specs += [(f"{t}.level_embeds", (cfg["num_levels"], D), "embed"),
              (f"{t}.cams_embeds", (cfg["num_cams"], D), "embed")]
    lin(f"{t}.reference_points", 3, D)
    lin(f"{t}.can_bus_mlp.0", D // 2, cfg["can_bus_dims"])
    lin(f"{t}.can_bus_mlp.2", D, D // 2)
    norm(f"{t}.can_bus_mlp.norm", D)
    L, Ph = cfg["num_levels"], cfg["tsa_points"]
    for i in range(cfg["encoder_layers"]):
        e = f"{t}.encoder.layers.{i}"
        a = f"{e}.attentions.0"                  # temporal self-attention
        lin(f"{a}.sampling_offsets", 2 * Hh * Ph * 2, 2 * D, "msda_offset",
            "msda_ring")
        lin(f"{a}.attention_weights", 2 * Hh * Ph, 2 * D, "msda_logit")
        lin(f"{a}.value_proj", D, D)
        lin(f"{a}.output_proj", D, D)
        a = f"{e}.attentions.1"                  # spatial cross-attention
        Ps = cfg["sca_points"]
        lin(f"{a}.deformable_attention.sampling_offsets", Hh * L * Ps * 2,
            D, "msda_offset", "msda_ring")
        lin(f"{a}.deformable_attention.attention_weights", Hh * L * Ps, D,
            "msda_logit")
        lin(f"{a}.deformable_attention.value_proj", D, D)
        lin(f"{a}.output_proj", D, D)
        lin(f"{e}.ffns.0.layers.0.0", cfg["ffn_dim"], D)
        lin(f"{e}.ffns.0.layers.1", D, cfg["ffn_dim"])
        for n in range(3):
            norm(f"{e}.norms.{n}", D)
    Pd = cfg["decoder_points"]
    for i in range(cfg["decoder_layers"]):
        d = f"{t}.decoder.layers.{i}"
        a = f"{d}.attentions.0"
        specs += [(f"{a}.attn.in_proj_weight", (3 * D, D), "matrix"),
                  (f"{a}.attn.in_proj_bias", (3 * D,), "bias")]
        lin(f"{a}.attn.out_proj", D, D)
        a = f"{d}.attentions.1"
        lin(f"{a}.sampling_offsets", Hh * Pd * 2, D, "msda_offset",
            "msda_ring")
        lin(f"{a}.attention_weights", Hh * Pd, D, "msda_logit")
        lin(f"{a}.value_proj", D, D)
        lin(f"{a}.output_proj", D, D)
        lin(f"{d}.ffns.0.layers.0.0", cfg["ffn_dim"], D)
        lin(f"{d}.ffns.0.layers.1", D, cfg["ffn_dim"])
        for n in range(3):
            norm(f"{d}.norms.{n}", D)
    n = cfg["num_reg_fcs"]
    for i in range(cfg["decoder_layers"]):
        c = f"{h}.cls_branches.{i}"
        for j in range(n):
            lin(f"{c}.{3 * j}", D, D)
            norm(f"{c}.{3 * j + 1}", D)
        lin(f"{c}.{3 * n}", cfg["num_classes"], D, "head_out")
    for i in range(cfg["decoder_layers"]):
        r = f"{h}.reg_branches.{i}"
        for j in range(n):
            lin(f"{r}.{2 * j}", D, D)
        lin(f"{r}.{2 * n}", cfg["code_size"], D, "head_out")
    specs += [(f"{h}.bev_embedding.weight",
               (cfg["bev_h"] * cfg["bev_w"], D), "embed"),
              (f"{h}.query_embedding.weight", (cfg["num_query"], 2 * D),
               "embed"),
              (f"{h}.positional_encoding.row_embed.weight",
               (cfg["bev_h"], D // 2), "uniform"),
              (f"{h}.positional_encoding.col_embed.weight",
               (cfg["bev_w"], D // 2), "uniform")]
    return specs


def ring(heads: int, groups: int, points: int) -> torch.Tensor:
    """mmcv's init of a deformable attention's offset bias: per head h a
    direction at angle 2πh/heads, scaled to unit max-norm, times i + 1
    for point i; `groups` levels (times queues) between head and point."""
    th = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    g = torch.stack([th.cos(), th.sin()], -1)
    g = (g / g.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2)
    g = g.repeat(1, groups, points, 1)
    for i in range(points):
        g[:, :, i, :] *= i + 1
    return g.reshape(-1)


def ring_of(cfg: dict, name: str, n: int) -> torch.Tensor:
    """The ring bias (n values) of the offset Linear `name`."""
    Hh = cfg["num_heads"]
    if ".attentions.0." in name and ".encoder." in name:      # TSA
        return ring(Hh, 2, cfg["tsa_points"])
    if "deformable_attention" in name:                        # SCA
        return ring(Hh, cfg["num_levels"], cfg["sca_points"])
    return ring(Hh, 1, cfg["decoder_points"])                 # decoder


# ---- backbone and neck ----------------------------------------------------

def backbone(w, cfg, x, P: Precision):
    """mmdet's ResNet, caffe style, DCNv2 as the conv2 of the stages
    `stage_with_dcn` names, frozen BatchNorm → C3, C4, C5."""
    b = "img_backbone"
    x = F.relu(_bn(w, f"{b}.bn1", P.conv(x, w[f"{b}.conv1.weight"], None,
                                         2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feats = []
    for si, blocks in enumerate(STAGES[cfg["resnet_name"]]):
        for bi in range(blocks):
            p = f"{b}.layer{si + 1}.{bi}"
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out = F.relu(_bn(w, f"{p}.bn1", P.conv(
                x, w[f"{p}.conv1.weight"], None, stride, 0)))
            if cfg["stage_with_dcn"][si]:
                out = dcn(w, f"{p}.conv2", out, P)
            else:
                out = P.conv(out, w[f"{p}.conv2.weight"], None, 1, 1)
            out = F.relu(_bn(w, f"{p}.bn2", out))
            out = _bn(w, f"{p}.bn3", P.conv(out, w[f"{p}.conv3.weight"]))
            if bi == 0:
                x = _bn(w, f"{p}.downsample.1", P.conv(
                    x, w[f"{p}.downsample.0.weight"], None, stride, 0))
            x = F.relu(out + x)
        feats.append(x)
    return feats[1:]


def neck(w, cfg, feats, P: Precision):
    """mmdet's FPN (start_level 0, add_extra_convs 'on_output'): laterals,
    the top-down nearest upsample and add, a 3x3 conv on each; then the
    extra 3x3 stride-2 convs, the first on the last output as it is, each
    later one on the ReLU of the one before."""
    n = len(feats)
    lat = [P.conv(f, w[f"img_neck.lateral_convs.{i}.weight"],
                  w[f"img_neck.lateral_convs.{i}.bias"])
           for i, f in enumerate(feats)]
    for i in range(n - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(
            lat[i], size=lat[i - 1].shape[-2:], mode="nearest")
    outs = [P.conv(lat[i], w[f"img_neck.fpn_convs.{i}.weight"],
                   w[f"img_neck.fpn_convs.{i}.bias"], 1, 1)
            for i in range(n)]
    for i in range(n, cfg["num_levels"]):
        src = outs[-1] if i == n else F.relu(outs[-1])
        outs.append(P.conv(src, w[f"img_neck.fpn_convs.{i}.weight"],
                           w[f"img_neck.fpn_convs.{i}.bias"], 2, 1))
    return outs


def image_features(w, cfg, img, P: Precision):
    """img (B, N, 3, H, W) BGR in 0..255 → the FPN's levels, each (B, N,
    C, h, w): normalised, zero-padded to a multiple of size_divisor."""
    img = img.float()
    B, N, _, H, W = img.shape
    dev = img.device
    mean = torch.tensor(cfg["img_mean"], device=dev).view(1, 3, 1, 1)
    std = torch.tensor(cfg["img_std"], device=dev).view(1, 3, 1, 1)
    x = (img.reshape(B * N, 3, H, W) - mean) / std
    Wp, Hp = padded_size(cfg)
    x = F.pad(x, (0, Wp - W, 0, Hp - H))
    outs = neck(w, cfg, backbone(w, cfg, x, P), P)
    return [o.view(B, N, *o.shape[1:]) for o in outs]


# ---- multi-scale deformable attention -------------------------------------

def msda(value, shapes, loc, weights):
    """mmcv's multi_scale_deformable_attn_pytorch: value (B, Nv, H, d)
    over the levels `shapes` [(h, w)], loc (B, Q, H, L, P, 2) in [0, 1]
    (x, y), weights (B, Q, H, L, P) → (B, Q, H · d)."""
    B, _, Hh, d = value.shape
    _, Q, _, L, Pn, _ = loc.shape
    vals = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    out = []
    for l, (h, w) in enumerate(shapes):
        v = vals[l].flatten(2).transpose(1, 2).reshape(B * Hh, d, h, w)
        g = grids[:, :, :, l].transpose(1, 2).flatten(0, 1)
        out.append(F.grid_sample(v, g, mode="bilinear",
                                 padding_mode="zeros", align_corners=False))
    a = weights.transpose(1, 2).reshape(B * Hh, 1, Q, L * Pn)
    o = (torch.stack(out, dim=-2).flatten(-2) * a).sum(-1)
    return o.view(B, Hh * d, Q).transpose(1, 2).contiguous()


def _normaliser(shapes, dev):
    s = torch.tensor(shapes, dtype=torch.float32, device=dev)
    return torch.stack([s[:, 1], s[:, 0]], -1)                 # (L, 2) w, h


# ---- the encoder ----------------------------------------------------------

def ref_3d(cfg, dev):
    """(A, Q, 3): each BEV cell's pillar anchors, normalised to [0, 1]."""
    H, W, A = cfg["bev_h"], cfg["bev_w"], cfg["num_points_in_pillar"]
    Z = cfg["pc_range"][5] - cfg["pc_range"][2]
    zs = torch.linspace(0.5, Z - 0.5, A, device=dev).view(-1, 1, 1) \
        .expand(A, H, W) / Z
    xs = torch.linspace(0.5, W - 0.5, W, device=dev).view(1, 1, W) \
        .expand(A, H, W) / W
    ys = torch.linspace(0.5, H - 0.5, H, device=dev).view(1, H, 1) \
        .expand(A, H, W) / H
    r = torch.stack((xs, ys, zs), -1)
    return r.permute(0, 3, 1, 2).flatten(2).permute(0, 2, 1)


def ref_2d(cfg, dev):
    """(Q, 2): each BEV cell's centre (x, y) in [0, 1]."""
    H, W = cfg["bev_h"], cfg["bev_w"]
    y, x = torch.meshgrid(torch.linspace(0.5, H - 0.5, H, device=dev),
                          torch.linspace(0.5, W - 0.5, W, device=dev),
                          indexing="ij")
    return torch.stack((x.reshape(-1) / W, y.reshape(-1) / H), -1)


def point_sampling(cfg, lidar2img):
    """BEVFormerEncoder.point_sampling: the pillar anchors in the lidar
    frame, through lidar2img (B, N, 4, 4), divided by the depth (floored
    at 1e-5), normalised by the padded image size → ref (N, B, Q, A, 2)
    and the mask (N, B, Q, A): depth > 1e-5 and 0 < u, v < 1."""
    dev = lidar2img.device
    pc = cfg["pc_range"]
    r = ref_3d(cfg, dev).clone()                               # (A, Q, 3)
    for i in range(3):
        r[..., i] = r[..., i] * (pc[i + 3] - pc[i]) + pc[i]
    r = torch.cat((r, torch.ones_like(r[..., :1])), -1)
    A, Q = r.shape[:2]
    B, N = lidar2img.shape[:2]
    r = r.view(A, 1, 1, Q, 4, 1).expand(A, B, N, Q, 4, 1)
    m = lidar2img.float().view(1, B, N, 1, 4, 4).expand(A, B, N, Q, 4, 4)
    cam = torch.matmul(m, r).squeeze(-1)                    # (A, B, N, Q, 4)
    mask = cam[..., 2:3] > EPS
    uv = cam[..., 0:2] / torch.maximum(cam[..., 2:3],
                                       torch.ones_like(cam[..., 2:3]) * EPS)
    Wp, Hp = padded_size(cfg)
    uv[..., 0] /= Wp
    uv[..., 1] /= Hp
    mask = (mask & (uv[..., 1:2] > 0.0) & (uv[..., 1:2] < 1.0)
            & (uv[..., 0:1] < 1.0) & (uv[..., 0:1] > 0.0))
    return uv.permute(2, 1, 3, 0, 4), mask.permute(2, 1, 3, 0, 4)[..., 0]


def tsa(w, cfg, prefix, query, pos, value, ref, P: Precision):
    """TemporalSelfAttention (1 level, num_bev_queue 2): value (2B, Q, C)
    the (previous, current) BEV pair, or None (the query twice); the
    offsets and weights from cat(value[:B], query + pos)."""
    B, Q, C = query.shape
    Hh, Pn = cfg["num_heads"], cfg["tsa_points"]
    if value is None:
        value = torch.stack([query, query], 1).reshape(B * 2, Q, C)
    q = torch.cat([value[:B], query + pos], -1)
    v = P.linear(value, w[f"{prefix}.value_proj.weight"],
                 w[f"{prefix}.value_proj.bias"]).view(B * 2, Q, Hh, -1)
    off = P.linear(q, w[f"{prefix}.sampling_offsets.weight"],
                   w[f"{prefix}.sampling_offsets.bias"]).view(
        B, Q, Hh, 2, 1, Pn, 2)
    a = P.linear(q, w[f"{prefix}.attention_weights.weight"],
                 w[f"{prefix}.attention_weights.bias"]).view(
        B, Q, Hh, 2, Pn).softmax(-1).view(B, Q, Hh, 2, 1, Pn)
    a = a.permute(0, 3, 1, 2, 4, 5).reshape(B * 2, Q, Hh, 1, Pn)
    off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * 2, Q, Hh, 1, Pn, 2)
    shapes = [(cfg["bev_h"], cfg["bev_w"])]
    loc = ref[:, :, None, :, None, :] \
        + off / _normaliser(shapes, query.device)[None, None, None, :,
                                                  None, :]
    o = msda(v, shapes, loc, a)                               # (2B, Q, C)
    o = o.permute(1, 2, 0).view(Q, C, B, 2).mean(-1).permute(2, 0, 1)
    return P.linear(o, w[f"{prefix}.output_proj.weight"],
                    w[f"{prefix}.output_proj.bias"]) + query


def rebatch(mask):
    """SpatialCrossAttention's per-camera index lists (mask (N, B, Q, A),
    batch 0's, as published) and max_len."""
    idx = [m[0].sum(-1).nonzero().squeeze(-1) for m in mask]
    return idx, max(len(i) for i in idx)


def sca(w, cfg, prefix, query, feats, shapes, ref_cam, mask,
        P: Precision):
    """SpatialCrossAttention with MSDeformableAttention3D: each camera's
    hit queries rebatched to max_len (host indexing), the camera's levels
    sampled at 8 points a level split 2 to each height anchor, the
    camera slots summed, divided by the cameras hit (at least 1),
    output_proj, the residual. feats (N, Nv, B, C)."""
    B, Q, C = query.shape
    N, Nv = feats.shape[:2]
    Hh, L, Pn = cfg["num_heads"], cfg["num_levels"], cfg["sca_points"]
    A = ref_cam.shape[3]
    idx, max_len = rebatch(mask)
    qr = query.new_zeros([B, N, max_len, C])
    rr = ref_cam.new_zeros([B, N, max_len, A, 2])
    for j in range(B):
        for i, r in enumerate(ref_cam):
            qr[j, i, :len(idx[i])] = query[j, idx[i]]
            rr[j, i, :len(idx[i])] = r[j, idx[i]]
    d = f"{prefix}.deformable_attention"
    value = feats.permute(2, 0, 1, 3).reshape(B * N, Nv, C)
    v = P.linear(value, w[f"{d}.value_proj.weight"],
                 w[f"{d}.value_proj.bias"]).view(B * N, Nv, Hh, -1)
    q = qr.view(B * N, max_len, C)
    off = P.linear(q, w[f"{d}.sampling_offsets.weight"],
                   w[f"{d}.sampling_offsets.bias"]).view(
        B * N, max_len, Hh, L, Pn, 2)
    a = P.linear(q, w[f"{d}.attention_weights.weight"],
                 w[f"{d}.attention_weights.bias"]).view(
        B * N, max_len, Hh, L * Pn).softmax(-1).view(
        B * N, max_len, Hh, L, Pn)
    off = off / _normaliser(shapes, query.device)[None, None, None, :,
                                                  None, :]
    off = off.view(B * N, max_len, Hh, L, Pn // A, A, 2)
    loc = rr.view(B * N, max_len, A, 2)[:, :, None, None, None] + off
    loc = loc.view(B * N, max_len, Hh, L, Pn, 2)
    o = msda(v, shapes, loc, a).view(B, N, max_len, C)
    slots = torch.zeros_like(query)
    for j in range(B):
        for i, ix in enumerate(idx):
            slots[j, ix] += o[j, i, :len(ix)]
    count = (mask.sum(-1) > 0).permute(1, 2, 0).sum(-1)
    slots = slots / torch.clamp(count, min=1.0)[..., None]
    return P.linear(slots, w[f"{prefix}.output_proj.weight"],
                    w[f"{prefix}.output_proj.bias"]) + query


def ffn(w, prefix, x, P: Precision):
    h = F.relu(P.linear(x, w[f"{prefix}.layers.0.0.weight"],
                        w[f"{prefix}.layers.0.0.bias"]))
    return x + P.linear(h, w[f"{prefix}.layers.1.weight"],
                        w[f"{prefix}.layers.1.bias"])


def encoder_layer(w, cfg, i, query, pos, value_pair, ref, feats, shapes,
                  ref_cam, mask, P: Precision):
    """BEVFormerLayer: self_attn (TSA), norm, cross_attn (SCA), norm, ffn,
    norm."""
    e = f"pts_bbox_head.transformer.encoder.layers.{i}"
    x = layer_norm(w, f"{e}.norms.0", tsa(w, cfg, f"{e}.attentions.0",
                                          query, pos, value_pair, ref, P))
    x = layer_norm(w, f"{e}.norms.1", sca(w, cfg, f"{e}.attentions.1", x,
                                          feats, shapes, ref_cam, mask, P))
    return layer_norm(w, f"{e}.norms.2", ffn(w, f"{e}.ffns.0", x, P))


# ---- the temporal carry ---------------------------------------------------

def can_bus_deltas(can_bus, prev_can_bus):
    """forward_test's deltas of (B, 18) float64 CAN-bus rows: with a
    previous pose, position [:3] and yaw in degrees [-1] less the
    previous ones; at a scene's first sample both zero. The yaw in
    radians [-2] stays absolute."""
    c = can_bus.double().clone()
    if prev_can_bus is None:
        c[:, :3] = 0.0
        c[:, -1] = 0.0
    else:
        c[:, :3] -= prev_can_bus.double()[:, :3]
        c[:, -1] -= prev_can_bus.double()[:, -1]
    return c


def shift_of(cfg, can_bus):
    """get_bev_features' shift (B, 2) (x, y), in BEV fractions, of the
    ego translation, from the delta CAN-bus (float64, as NumPy there)."""
    pc = cfg["pc_range"]
    gy = (pc[4] - pc[1]) / cfg["bev_h"]
    gx = (pc[3] - pc[0]) / cfg["bev_w"]
    c = can_bus.double().cpu().numpy()
    dx, dy = c[:, 0], c[:, 1]
    ego = c[:, -2] / np.pi * 180
    length = np.sqrt(dx ** 2 + dy ** 2)
    angle = np.arctan2(dy, dx) / np.pi * 180
    bev = ego - angle
    sy = length * np.cos(bev / 180 * np.pi) / gy / cfg["bev_h"]
    sx = length * np.sin(bev / 180 * np.pi) / gx / cfg["bev_w"]
    return torch.tensor(np.stack([sx, sy], -1), dtype=torch.float32,
                        device=can_bus.device)


def rotate(img, angle: float, center):
    """torchvision.transforms.functional.rotate of a tensor (C, H, W) by
    `angle` degrees counter-clockwise about `center` (x, y): nearest,
    zero fill, expand=False."""
    C, H, W = img.shape
    cx, cy = center[0] - W * 0.5, center[1] - H * 0.5
    rot = math.radians(-angle)
    a, b, c, d = math.cos(rot), -math.sin(rot), math.sin(rot), math.cos(rot)
    m = [d, -b, 0.0, -c, a, 0.0]
    m[2] += m[0] * (-cx) + m[1] * (-cy)
    m[5] += m[3] * (-cx) + m[4] * (-cy)
    m[2] += cx
    m[5] += cy
    theta = torch.tensor(m, dtype=img.dtype, device=img.device).view(1, 2, 3)
    base = torch.empty(1, H, W, 3, dtype=theta.dtype, device=img.device)
    base[..., 0].copy_(torch.linspace(-W * 0.5 + 0.5, W * 0.5 - 0.5,
                                      steps=W, device=img.device))
    base[..., 1].copy_(torch.linspace(-H * 0.5 + 0.5, H * 0.5 - 0.5,
                                      steps=H, device=img.device)[:, None])
    base[..., 2].fill_(1)
    scaled = theta.transpose(1, 2) / torch.tensor(
        [0.5 * W, 0.5 * H], dtype=theta.dtype, device=img.device)
    grid = base.view(1, H * W, 3).bmm(scaled).view(1, H, W, 2)
    return F.grid_sample(img[None], grid, mode="nearest",
                         padding_mode="zeros", align_corners=False)[0]


def rotate_bev(cfg, prev_bev, angles):
    """The previous BEV (B, Q, C), each sample's rotated by its angle."""
    H, W = cfg["bev_h"], cfg["bev_w"]
    out = []
    for i, ang in enumerate(angles):
        t = prev_bev[i].reshape(H, W, -1).permute(2, 0, 1)
        t = rotate(t, float(ang), cfg["rotate_center"])
        out.append(t.permute(1, 2, 0).reshape(H * W, -1))
    return torch.stack(out)


# ---- the decoder and heads ------------------------------------------------

def cmsda(w, cfg, prefix, query, pos, bev, ref, P: Precision):
    """CustomMSDeformableAttention over the BEV (1 level) at the
    reference points ref (B, Q, 2), with the residual."""
    B, Q, C = query.shape
    Hh, Pn = cfg["num_heads"], cfg["decoder_points"]
    q = query + pos
    v = P.linear(bev, w[f"{prefix}.value_proj.weight"],
                 w[f"{prefix}.value_proj.bias"]).view(B, bev.shape[1], Hh,
                                                      -1)
    off = P.linear(q, w[f"{prefix}.sampling_offsets.weight"],
                   w[f"{prefix}.sampling_offsets.bias"]).view(
        B, Q, Hh, 1, Pn, 2)
    a = P.linear(q, w[f"{prefix}.attention_weights.weight"],
                 w[f"{prefix}.attention_weights.bias"]).view(
        B, Q, Hh, Pn).softmax(-1).view(B, Q, Hh, 1, Pn)
    shapes = [(cfg["bev_h"], cfg["bev_w"])]
    loc = ref[:, :, None, None, None, :] \
        + off / _normaliser(shapes, query.device)[None, None, None, :,
                                                  None, :]
    o = msda(v, shapes, loc, a)
    return P.linear(o, w[f"{prefix}.output_proj.weight"],
                    w[f"{prefix}.output_proj.bias"]) + query


def branch(w, cfg, prefix, x, cls: bool, P: Precision):
    n = cfg["num_reg_fcs"]
    for j in range(n):
        k = 3 * j if cls else 2 * j
        x = P.linear(x, w[f"{prefix}.{k}.weight"], w[f"{prefix}.{k}.bias"])
        if cls:
            x = layer_norm(w, f"{prefix}.{k + 1}", x)
        x = F.relu(x)
    k = 3 * n if cls else 2 * n
    return P.linear(x, w[f"{prefix}.{k}.weight"], w[f"{prefix}.{k}.bias"])


def decoder(w, cfg, bev, P: Precision, refs=None):
    """DetectionTransformerDecoder with box refinement, then the heads:
    all_cls_scores, all_bbox_preds (L, B, Q, ...). With `refs` (L, B, Q,
    3), layer l ≥ 1 starts from refs[l − 1] (another run's refined
    reference points) instead of its own."""
    h = "pts_bbox_head"
    t = f"{h}.transformer"
    B = bev.shape[0]
    D = cfg["embed_dims"]
    qe = w[f"{h}.query_embedding.weight"]
    pos = qe[:, :D][None].expand(B, -1, -1)
    tgt = qe[:, D:][None].expand(B, -1, -1)
    ref = torch.sigmoid(P.linear(pos, w[f"{t}.reference_points.weight"],
                                 w[f"{t}.reference_points.bias"]))
    states, starts = [], []
    for i in range(cfg["decoder_layers"]):
        if refs is not None and i > 0:
            ref = refs[i - 1].to(ref)
        starts.append(ref)
        d = f"{t}.decoder.layers.{i}"
        q = tgt + pos
        tgt = layer_norm(w, f"{d}.norms.0", tgt + attention(
            w, f"{d}.attentions.0.attn", q, q, tgt, cfg["num_heads"], P))
        tgt = layer_norm(w, f"{d}.norms.1", cmsda(
            w, cfg, f"{d}.attentions.1", tgt, pos, bev, ref[..., :2], P))
        tgt = layer_norm(w, f"{d}.norms.2", ffn(w, f"{d}.ffns.0", tgt, P))
        tmp = branch(w, cfg, f"{h}.reg_branches.{i}", tgt, False, P)
        new = torch.zeros_like(ref)
        new[..., :2] = tmp[..., :2] + inverse_sigmoid(ref[..., :2])
        new[..., 2:3] = tmp[..., 4:5] + inverse_sigmoid(ref[..., 2:3])
        ref = new.sigmoid()
        states.append(tgt)
    pc = cfg["pc_range"]
    cls, reg = [], []
    for i, hs in enumerate(states):
        r = inverse_sigmoid(starts[i])
        cls.append(branch(w, cfg, f"{h}.cls_branches.{i}", hs, True, P))
        tmp = branch(w, cfg, f"{h}.reg_branches.{i}", hs, False, P).clone()
        tmp[..., 0:2] = torch.sigmoid(tmp[..., 0:2] + r[..., 0:2])
        tmp[..., 4:5] = torch.sigmoid(tmp[..., 4:5] + r[..., 2:3])
        tmp[..., 0:1] = tmp[..., 0:1] * (pc[3] - pc[0]) + pc[0]
        tmp[..., 1:2] = tmp[..., 1:2] * (pc[4] - pc[1]) + pc[1]
        tmp[..., 4:5] = tmp[..., 4:5] * (pc[5] - pc[2]) + pc[2]
        reg.append(tmp)
    return torch.stack(cls), torch.stack(reg)


def trajectory(cfg, bbox_preds):
    """The refined reference points (L, B, Q, 3) in [0, 1] that a run's
    all_bbox_preds (L, B, Q, 10) hold: each layer's centre (cx, cy, cz)
    is its refined point scaled to pc_range."""
    pc = cfg["pc_range"]
    b = bbox_preds.float()
    return torch.stack([(b[..., 0] - pc[0]) / (pc[3] - pc[0]),
                        (b[..., 1] - pc[1]) / (pc[4] - pc[1]),
                        (b[..., 4] - pc[2]) / (pc[5] - pc[2])], -1)


# ---- the forward ----------------------------------------------------------

def forward(w: Dict[str, torch.Tensor], cfg: dict,
            batch: Dict[str, torch.Tensor],
            prev_bev: Optional[torch.Tensor] = None,
            prev_can_bus: Optional[torch.Tensor] = None,
            P: Precision = Precision(),
            along: Optional[Dict[str, torch.Tensor]] = None
            ) -> Dict[str, torch.Tensor]:
    """bev_embed (B, Q_bev, C), all_cls_scores and all_bbox_preds (L, B,
    Q, ...) of batch: img (B, N, 3, H, W) BGR in 0..255, lidar2img (B, N,
    4, 4), can_bus (B, 18) absolute; prev_bev (B, Q_bev, C) and
    prev_can_bus (B, 18), both or neither: the previous sample's BEV and
    absolute CAN-bus (None at a scene's first sample).

    With `along` (another run's outputs: its bev_embed and every layer's
    all_bbox_preds) the decoder runs along that run's trajectory: on its
    BEV, each layer l ≥ 1 from its refined reference points of layer l −
    1 (`trajectory`), so that the outputs check that run's decoder step
    by step; bev_embed is this run's own encoder's."""
    h = "pts_bbox_head"
    t = f"{h}.transformer"
    feats = image_features(w, cfg, batch["img"], P)
    B, N = feats[0].shape[:2]
    dev = feats[0].device
    D = cfg["embed_dims"]
    shapes = [tuple(f.shape[-2:]) for f in feats]
    flat = []
    for lvl, f in enumerate(feats):
        f = f.flatten(3).permute(1, 0, 3, 2)                # (N, B, hw, C)
        f = f + w[f"{t}.cams_embeds"][:, None, None, :]
        f = f + w[f"{t}.level_embeds"][None, None, lvl:lvl + 1, :]
        flat.append(f)
    flat = torch.cat(flat, 2).permute(0, 2, 1, 3)          # (N, Nv, B, C)
    can = can_bus_deltas(batch["can_bus"], prev_can_bus)
    shift = shift_of(cfg, can)
    q = w[f"{h}.bev_embedding.weight"][None].expand(B, -1, -1)
    cb = F.relu(P.linear(can.float(), w[f"{t}.can_bus_mlp.0.weight"],
                         w[f"{t}.can_bus_mlp.0.bias"]))
    cb = F.relu(P.linear(cb, w[f"{t}.can_bus_mlp.2.weight"],
                         w[f"{t}.can_bus_mlp.2.bias"]))
    cb = layer_norm(w, f"{t}.can_bus_mlp.norm", cb)
    q = q + cb[:, None, :]
    Hb, Wb = cfg["bev_h"], cfg["bev_w"]
    pe = f"{h}.positional_encoding"
    pos = torch.cat([w[f"{pe}.col_embed.weight"][None].expand(Hb, -1, -1),
                     w[f"{pe}.row_embed.weight"][:, None].expand(-1, Wb, -1)],
                    -1).reshape(1, Hb * Wb, D).expand(B, -1, -1)
    ref_cam, mask = point_sampling(cfg, batch["lidar2img"])
    ref = ref_2d(cfg, dev)[None, :, None, :].repeat(B, 1, 1, 1)
    ref = ref + shift[:, None, None, :]           # both queues: see above
    pair = None
    if prev_bev is not None:
        prev = rotate_bev(cfg, prev_bev.float(), can[:, -1].tolist())
        pair = torch.stack([prev, q], 1).reshape(B * 2, Hb * Wb, D)
    ref = torch.stack([ref, ref], 1).reshape(B * 2, Hb * Wb, 1, 2)
    x = q
    for i in range(cfg["encoder_layers"]):
        x = encoder_layer(w, cfg, i, x, pos, pair, ref, flat, shapes,
                          ref_cam, mask, P)
    if along is None:
        cls, reg = decoder(w, cfg, x, P)
    else:
        cls, reg = decoder(w, cfg, along["bev_embed"].to(x), P,
                           trajectory(cfg, along["all_bbox_preds"]).to(x))
    return {"bev_embed": x, "all_cls_scores": cls, "all_bbox_preds": reg}


# ---- the comparisons ------------------------------------------------------

OUTPUTS = {"cls": ("all_cls_scores", slice(None)),
           "centre": ("all_bbox_preds", [0, 1, 4]),
           "box_rest": ("all_bbox_preds", [2, 3, 5, 6, 7, 8, 9])}


def output_gaps(prog: Dict[str, torch.Tensor],
                refr: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """‖program − reference‖ / ‖reference‖ of the last layer's class
    logits, box centres and the box's other fields."""
    out = {}
    for name, (key, cols) in OUTPUTS.items():
        p = prog[key][-1].float().to(refr[key].device)[..., cols]
        r = refr[key][-1].float()[..., cols]
        out[name] = float((p - r).norm() / r.norm())
    return out


def bev_gap(prog: torch.Tensor, refr: torch.Tensor) -> float:
    """‖program − reference‖ / ‖reference‖ of the new BEV embedding."""
    p = prog.float().to(refr.device)
    return float((p - refr.float()).norm() / refr.float().norm())


__all__ = ["bev_gap", "decode", "decode_mismatch", "forward", "output_gaps",
           "param_specs", "trajectory"]

"""PETR in plain PyTorch and NumPy: the reference that decides `correct`
in the PETR cells, and the one the port's CPU tests hold it to.

The eval forward and the NMS-free decode of PETR ("PETR: Position
Embedding Transformation for Multi-View 3D Object Detection", Liu, Wang,
Zhang, Sun; ECCV 2022), written from the paper and from
megvii-research/PETR (projects/configs/petr/petr_r50dcn_gridmask_p4.py and
the plugin's petr_head.py, petr_transformer.py, positional_encoding.py,
cp_fpn.py, nms_free_coder.py): caffe-style ResNet-50 with DCNv2 in stages
3 and 4, CPFPN's P4, the LID position encoder and the 3D sine encoding,
the query embedding of the learned reference points, 6 post-norm decoder
layers, the class and box heads, the decode. It imports nothing of the
measured program and takes no tensor the program made: weights come from
`benchmark.weights_petr`, inputs from `benchmark.data_petr`.

Everything runs in float32 with TF32 off (the caller sets the switches:
`benchmark.checks.no_tf32`). DCNv2 samples with `grid_sample` per kernel
point (align_corners=True, zero padding) and sums with einsum; attention
is an explicit softmax, computed in blocks of queries so that the
900 x 16,896 scores of a layer fit. `Precision("fp8")` (from the PARQ
reference) rounds every operand of a matrix product or convolution to
float8 e4m3 with a per-tensor scale: the control.

Departures from the published model, none in its mathematics:
- random weights (`weights_petr`), not the released checkpoint; the DCN
  offset convs are drawn at a scale that moves the sampling points by a
  few pixels and keeps the masks away from 0 and 1 (mmcv starts them at
  zero, where a DCN is a plain convolution);
- the six-camera rig is nuScenes-like and synthetic (`data_petr`);
- the input normalisation is caffe's (BGR, mean 103.530, 116.280,
  123.675; std 57.375, 57.120, 58.395) applied to the 0..255 image inside
  the forward, where mmdet3d's loader normalises;
- PETRHead puts one class branch and one box branch module in all six
  slots: one set of head weights here, applied to every layer;
- the decode ranks the logits with ties broken by index (see `decode`);
  NMSFreeCoder's torch.topk over the sigmoid scores leaves the order of
  ties open.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import Precision, posemb3d

STAGES = (3, 4, 6, 3)
POINTS = 9
ATTN_BLOCK = 128           # queries a block of the explicit softmax
EPS = 1e-5                 # mmdet's inverse_sigmoid; the frustum's clamp


# ---- the parameter layout -------------------------------------------------

def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model's state dict, in a
    fixed order. kind: "matrix" (rank >= 2, N(0, 1/fan_in)), "head_out"
    (a head's output layer), "offset" (a DCN's offset conv), "refpoint"
    (U(0, 1)), "bias" (0), "scale" (1), "bn_one" / "bn_zero" (frozen
    BatchNorm at identity); `weights_petr` draws them."""
    specs = []

    def bn(prefix, n):
        for k, kind in (("weight", "bn_one"), ("bias", "bn_zero"),
                        ("running_mean", "bn_zero"),
                        ("running_var", "bn_one")):
            specs.append((f"{prefix}.{k}", (n,), kind))

    def lin(name, o, i, kind="matrix"):
        specs.extend([(f"{name}.weight", (o, i), kind),
                      (f"{name}.bias", (o,), "bias")])

    def conv(name, o, i, k, kind="matrix"):
        specs.extend([(f"{name}.weight", (o, i, k, k), kind),
                      (f"{name}.bias", (o,), "bias")])

    b = "img_backbone"
    specs.append((f"{b}.conv1.weight", (64, 3, 7, 7), "matrix"))
    bn(f"{b}.bn1", 64)
    cin, width = 64, 64
    for si, blocks in enumerate(STAGES):
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
    D, Dn = cfg["embed_dims"], cfg["depth_num"]
    for i, c in enumerate(cfg["neck_in_channels"]):
        conv(f"img_neck.lateral_convs.{i}", D, c, 1)
    conv("img_neck.fpn_convs.0", D, D, 3)
    h = "pts_bbox_head"
    conv(f"{h}.input_proj", D, D, 1)
    conv(f"{h}.position_encoder.0", 4 * D, 3 * Dn, 1)
    conv(f"{h}.position_encoder.2", D, 4 * D, 1)
    conv(f"{h}.adapt_pos3d.0", 4 * D, 3 * D // 2, 1)
    conv(f"{h}.adapt_pos3d.2", D, 4 * D, 1)
    specs.append((f"{h}.reference_points.weight", (cfg["num_query"], 3),
                  "refpoint"))
    lin(f"{h}.query_embedding.0", D, 3 * D // 2)
    lin(f"{h}.query_embedding.2", D, D)
    for l in range(cfg["num_layers"]):
        ly = f"{h}.layers.{l}"
        for att in ("self_attn", "cross_attn"):
            specs += [(f"{ly}.{att}.in_proj_weight", (3 * D, D), "matrix"),
                      (f"{ly}.{att}.in_proj_bias", (3 * D,), "bias")]
            lin(f"{ly}.{att}.out_proj", D, D)
        lin(f"{ly}.linear1", cfg["ffn_dim"], D)
        lin(f"{ly}.linear2", D, cfg["ffn_dim"])
        for n in (1, 2, 3):
            specs += [(f"{ly}.norm{n}.weight", (D,), "scale"),
                      (f"{ly}.norm{n}.bias", (D,), "bias")]
    specs += [(f"{h}.post_norm.weight", (D,), "scale"),
              (f"{h}.post_norm.bias", (D,), "bias")]
    for i in range(cfg["num_reg_fcs"]):
        lin(f"{h}.cls_branch.{3 * i}", D, D)
        specs += [(f"{h}.cls_branch.{3 * i + 1}.weight", (D,), "scale"),
                  (f"{h}.cls_branch.{3 * i + 1}.bias", (D,), "bias")]
    lin(f"{h}.cls_branch.{3 * cfg['num_reg_fcs']}", cfg["num_classes"], D,
        "head_out")
    for i in range(cfg["num_reg_fcs"]):
        lin(f"{h}.reg_branch.{2 * i}", D, D)
    lin(f"{h}.reg_branch.{2 * cfg['num_reg_fcs']}", cfg["code_size"], D,
        "head_out")
    return specs


# ---- backbone and neck ----------------------------------------------------

def _bn(w, prefix, x):
    inv = w[prefix + ".weight"] / torch.sqrt(w[prefix + ".running_var"]
                                             + 1e-5)
    shift = w[prefix + ".bias"] - w[prefix + ".running_mean"] * inv
    return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def dcn_columns(x, om):
    """DCNv2's sampled columns (N, 9, C, H, W): for kernel point k = 3i +
    j, x sampled at (h − 1 + i + om[:, 2k], w − 1 + j + om[:, 2k + 1]) by
    grid_sample (bilinear, align_corners=True, zeros outside), times
    sigmoid(om[:, 18 + k]): mmcv's modulated_deform_im2col."""
    N, C, H, W = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=x.device),
        torch.arange(W, dtype=torch.float32, device=x.device), indexing="ij")
    cols = []
    for k in range(POINTS):
        y = gy + (k // 3 - 1) + om[:, 2 * k]
        xx = gx + (k % 3 - 1) + om[:, 2 * k + 1]
        grid = torch.stack([2.0 * xx / (W - 1) - 1.0,
                            2.0 * y / (H - 1) - 1.0], dim=-1)
        s = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        cols.append(s * torch.sigmoid(om[:, 2 * POINTS + k:2 * POINTS + k
                                          + 1]))
    return torch.stack(cols, dim=1)


def dcn(w, prefix, x, P: Precision):
    """mmcv's ModulatedDeformConv2dPack, 3x3, stride 1, padding 1, no bias:
    its offset conv, then the weights over the sampled columns."""
    om = P.conv(x, w[f"{prefix}.conv_offset.weight"],
                w[f"{prefix}.conv_offset.bias"], 1, 1)
    cols = dcn_columns(x, om)                       # (N, 9, C, H, W)
    wt = w[f"{prefix}.weight"]                      # (O, C, 3, 3)
    wk = wt.reshape(wt.shape[0], wt.shape[1], POINTS)
    return torch.einsum("nkchw,ock->nohw", P.r(cols), P.r(wk))


def backbone(w, cfg, x, P: Precision):
    """mmdet's ResNet-50, caffe style (the stride on conv1), DCNv2 as the
    conv2 of the stages `stage_with_dcn` names, frozen BatchNorm → the
    outputs of stages 3 and 4 (C4, C5)."""
    b = "img_backbone"
    x = F.relu(_bn(w, f"{b}.bn1", P.conv(x, w[f"{b}.conv1.weight"], None,
                                         2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feats = []
    for si, blocks in enumerate(STAGES):
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
    return feats[2:]


def neck(w, feats, P: Precision):
    """CPFPN: laterals, P5's lateral upsampled (nearest) into P4's, the 3x3
    conv on P4 → P4."""
    lat = [P.conv(f, w[f"img_neck.lateral_convs.{i}.weight"],
                  w[f"img_neck.lateral_convs.{i}.bias"])
           for i, f in enumerate(feats)]
    p4 = lat[0] + F.interpolate(lat[1], size=lat[0].shape[-2:],
                                mode="nearest")
    return P.conv(p4, w["img_neck.fpn_convs.0.weight"],
                  w["img_neck.fpn_convs.0.bias"], 1, 1)


# ---- position encodings ---------------------------------------------------

def inverse_sigmoid(x, eps=EPS):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def position_embedding(w, cfg, lidar2img, P: Precision):
    """PETR's position_embeding: the LID frustum of every P4 pixel lifted
    by inv(lidar2img) (float64 inverse, as NumPy's) into the lidar frame,
    normalised to position_range, inverse-sigmoid, through the two 1x1
    convs → (B, N, D, h, w); and the out-of-range mask (B, N, h, w)."""
    B, N = lidar2img.shape[:2]
    W, H = cfg["image_size"]
    s = cfg["stride"]
    h, wd = H // s, W // s
    dev = lidar2img.device
    Dn = cfg["depth_num"]
    r = cfg["position_range"]
    coords_h = torch.arange(h, device=dev).float() * H / h
    coords_w = torch.arange(wd, device=dev).float() * W / wd
    index = torch.arange(0, Dn, device=dev).float()
    bin_size = (r[3] - cfg["depth_start"]) / (Dn * (1 + Dn))
    coords_d = cfg["depth_start"] + bin_size * index * (index + 1)
    coords = torch.stack(torch.meshgrid([coords_w, coords_h, coords_d],
                                        indexing="ij")).permute(1, 2, 3, 0)
    coords = torch.cat((coords, torch.ones_like(coords[..., :1])), -1)
    coords[..., :2] = coords[..., :2] * torch.maximum(
        coords[..., 2:3], torch.ones_like(coords[..., 2:3]) * EPS)
    img2lidar = torch.linalg.inv(lidar2img.double()).float()
    c3d = torch.matmul(img2lidar.view(B, N, 1, 1, 1, 4, 4),
                       coords.view(1, 1, wd, h, Dn, 4, 1))[..., :3, 0]
    for i in range(3):
        c3d[..., i] = (c3d[..., i] - r[i]) / (r[i + 3] - r[i])
    mask = ((c3d > 1.0) | (c3d < 0.0)).flatten(-2).sum(-1) > Dn * 0.5
    mask = mask.permute(0, 1, 3, 2)                           # (B, N, h, w)
    c3d = c3d.permute(0, 1, 4, 5, 3, 2).reshape(B * N, Dn * 3, h, wd)
    c3d = inverse_sigmoid(c3d)
    p = "pts_bbox_head.position_encoder"
    e = F.relu(P.conv(c3d, w[f"{p}.0.weight"], w[f"{p}.0.bias"]))
    e = P.conv(e, w[f"{p}.2.weight"], w[f"{p}.2.bias"])
    return e.view(B, N, -1, h, wd), mask


def sine_encoding(mask, num_feats, temperature=10000.0, eps=1e-6,
                  scale=2 * math.pi):
    """SinePositionalEncoding3D(normalize=True) of the mask (B, N, h, w)
    → (B, N, 3 · num_feats, h, w)."""
    not_mask = 1 - mask.to(torch.int)
    n_embed = not_mask.cumsum(1, dtype=torch.float32)
    y_embed = not_mask.cumsum(2, dtype=torch.float32)
    x_embed = not_mask.cumsum(3, dtype=torch.float32)
    n_embed = n_embed / (n_embed[:, -1:, :, :] + eps) * scale
    y_embed = y_embed / (y_embed[:, :, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, :, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)
    B, N, H, W = mask.size()
    out = []
    for e in (n_embed, y_embed, x_embed):
        p = e[:, :, :, :, None] / dim_t
        out.append(torch.stack((p[:, :, :, :, 0::2].sin(),
                                p[:, :, :, :, 1::2].cos()),
                               dim=4).view(B, N, H, W, -1))
    return torch.cat(out, dim=4).permute(0, 1, 4, 2, 3)


# ---- decoder and heads ----------------------------------------------------

def _split(x, heads):
    B, L, D = x.shape
    return x.view(B, L, heads, D // heads).transpose(1, 2)


def attention(w, prefix, query, key, value, heads, P: Precision):
    """nn.MultiheadAttention (eval): q scaled by head_dim^-1/2, an explicit
    softmax over all keys, computed in blocks of ATTN_BLOCK queries."""
    wi, bi = w[f"{prefix}.in_proj_weight"], w[f"{prefix}.in_proj_bias"]
    D = query.shape[-1]
    q = _split(P.linear(query, wi[:D], bi[:D]), heads) \
        * (D // heads) ** -0.5
    k = _split(P.linear(key, wi[D:2 * D], bi[D:2 * D]), heads)
    v = _split(P.linear(value, wi[2 * D:], bi[2 * D:]), heads)
    outs = []
    for s in range(0, q.shape[2], ATTN_BLOCK):
        a = torch.softmax(P.matmul(q[:, :, s:s + ATTN_BLOCK],
                                   k.transpose(-1, -2)), dim=-1)
        outs.append(P.matmul(a, v))
    o = torch.cat(outs, dim=2)
    B, _, Q, _ = o.shape
    o = o.transpose(1, 2).reshape(B, Q, D)
    return P.linear(o, w[f"{prefix}.out_proj.weight"],
                    w[f"{prefix}.out_proj.bias"])


def layer_norm(w, prefix, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], 1e-5)


def decoder_layer(w, cfg, l, tgt, query_pos, memory, key_pos,
                  P: Precision):
    """PETRTransformerDecoderLayer (self_attn, norm, cross_attn, norm, ffn,
    norm) in eval."""
    ly = f"pts_bbox_head.layers.{l}"
    Hh = cfg["num_heads"]
    q = tgt + query_pos
    tgt = layer_norm(w, f"{ly}.norm1", tgt + attention(
        w, f"{ly}.self_attn", q, q, tgt, Hh, P))
    tgt = layer_norm(w, f"{ly}.norm2", tgt + attention(
        w, f"{ly}.cross_attn", tgt + query_pos, memory + key_pos, memory,
        Hh, P))
    f = P.linear(F.relu(P.linear(tgt, w[f"{ly}.linear1.weight"],
                                 w[f"{ly}.linear1.bias"])),
                 w[f"{ly}.linear2.weight"], w[f"{ly}.linear2.bias"])
    return layer_norm(w, f"{ly}.norm3", tgt + f)


def branches(w, cfg, x, P: Precision):
    """The class branch (Linear, LayerNorm, ReLU) x 2, Linear; the box
    branch (Linear, ReLU) x 2, Linear."""
    h = "pts_bbox_head"
    c, n = x, cfg["num_reg_fcs"]
    for i in range(n):
        c = P.linear(c, w[f"{h}.cls_branch.{3 * i}.weight"],
                     w[f"{h}.cls_branch.{3 * i}.bias"])
        c = F.relu(layer_norm(w, f"{h}.cls_branch.{3 * i + 1}", c))
    c = P.linear(c, w[f"{h}.cls_branch.{3 * n}.weight"],
                 w[f"{h}.cls_branch.{3 * n}.bias"])
    r = x
    for i in range(n):
        r = F.relu(P.linear(r, w[f"{h}.reg_branch.{2 * i}.weight"],
                            w[f"{h}.reg_branch.{2 * i}.bias"]))
    r = P.linear(r, w[f"{h}.reg_branch.{2 * n}.weight"],
                 w[f"{h}.reg_branch.{2 * n}.bias"])
    return c, r


def forward(w: Dict[str, torch.Tensor], cfg: dict,
            batch: Dict[str, torch.Tensor], P: Precision = Precision()
            ) -> Dict[str, torch.Tensor]:
    """all_cls_scores and all_bbox_preds (L, B, Q, ...) of batch: img (B,
    N, 3, H, W) BGR in 0..255, lidar2img (B, N, 4, 4)."""
    img = batch["img"].float()
    B, N, _, H, W = img.shape
    dev = img.device
    mean = torch.tensor(cfg["img_mean"], device=dev).view(1, 3, 1, 1)
    std = torch.tensor(cfg["img_std"], device=dev).view(1, 3, 1, 1)
    x = (img.reshape(B * N, 3, H, W) - mean) / std
    p4 = neck(w, backbone(w, cfg, x, P), P)
    h = "pts_bbox_head"
    x = P.conv(p4, w[f"{h}.input_proj.weight"], w[f"{h}.input_proj.bias"])
    D, hh, ww = x.shape[1:]
    x = x.view(B, N, D, hh, ww)
    masks = torch.zeros((B, N, hh, ww), dtype=torch.bool, device=dev)
    pos, _ = position_embedding(w, cfg, batch["lidar2img"].float(), P)
    sin = sine_encoding(masks, D // 2).flatten(0, 1)
    a = f"{h}.adapt_pos3d"
    sin = P.conv(F.relu(P.conv(sin, w[f"{a}.0.weight"], w[f"{a}.0.bias"])),
                 w[f"{a}.2.weight"], w[f"{a}.2.bias"])
    pos = pos + sin.view(x.shape)
    memory = x.permute(0, 1, 3, 4, 2).reshape(B, N * hh * ww, D)
    key_pos = pos.permute(0, 1, 3, 4, 2).reshape(B, N * hh * ww, D)
    ref = w[f"{h}.reference_points.weight"]
    qe = f"{h}.query_embedding"
    query_pos = P.linear(F.relu(P.linear(posemb3d(ref, D // 2),
                                         w[f"{qe}.0.weight"],
                                         w[f"{qe}.0.bias"])),
                         w[f"{qe}.2.weight"], w[f"{qe}.2.bias"])
    query_pos = query_pos[None].expand(B, -1, -1)
    tgt = torch.zeros_like(query_pos)
    outs = []
    for l in range(cfg["num_layers"]):
        tgt = decoder_layer(w, cfg, l, tgt, query_pos, memory, key_pos, P)
        outs.append(layer_norm(w, f"{h}.post_norm", tgt))
    outs = torch.nan_to_num(torch.stack(outs))
    cls, reg = branches(w, cfg, outs, P)
    reference = inverse_sigmoid(ref)
    pc = cfg["pc_range"]
    reg = reg.clone()
    reg[..., 0:2] = torch.sigmoid(reg[..., 0:2] + reference[..., 0:2])
    reg[..., 4:5] = torch.sigmoid(reg[..., 4:5] + reference[..., 2:3])
    reg[..., 0:1] = reg[..., 0:1] * (pc[3] - pc[0]) + pc[0]
    reg[..., 1:2] = reg[..., 1:2] * (pc[4] - pc[1]) + pc[1]
    reg[..., 4:5] = reg[..., 4:5] * (pc[5] - pc[2]) + pc[2]
    return {"all_cls_scores": cls, "all_bbox_preds": reg}


# ---- the decode and the comparisons --------------------------------------

def decode(cls_scores: np.ndarray, bbox_preds: np.ndarray,
           post_center_range, max_num: int) -> Dict[str, np.ndarray]:
    """NMSFreeCoder on one layer's outputs, per sample: cls_scores (B, Q,
    C) logits, bbox_preds (B, Q, 10) → boxes (B, K, 9) (cx, cy, cz, w, l,
    h, yaw, vx, vy), scores, labels, query (B, K), keep (B, K): the top
    K = max_num of the flattened scores, ranked by logit with ties by
    index (lower first; sigmoid is monotonic, so this is an order of the
    scores), the kept flag where the centre lies in post_center_range."""
    B, Q, C = cls_scores.shape
    logits = cls_scores.astype(np.float32).reshape(B, Q * C)
    order = np.argsort(-logits, axis=1, kind="stable")[:, :max_num]
    top = np.take_along_axis(logits, order, 1)
    scores = (1.0 / (1.0 + np.exp(-top.astype(np.float64)))).astype(
        np.float32)
    labels, query = order % C, order // C
    b = np.take_along_axis(bbox_preds.astype(np.float32), query[..., None],
                           1)
    centre = np.concatenate([b[..., 0:2], b[..., 4:5]], -1)
    size = np.exp(np.concatenate([b[..., 2:4], b[..., 5:6]], -1))
    yaw = np.arctan2(b[..., 6:7], b[..., 7:8])
    r = np.asarray(post_center_range, np.float32)
    keep = np.all((centre >= r[:3]) & (centre <= r[3:]), -1)
    return {"boxes": np.concatenate([centre, size, yaw, b[..., 8:10]], -1),
            "scores": scores, "labels": labels.astype(np.int64),
            "query": query.astype(np.int64), "keep": keep}


def decode_mismatch(prog: Dict[str, np.ndarray],
                    mine: Dict[str, np.ndarray]) -> int:
    """Detections that differ between the program's decode and the
    reference's of the same outputs: query, label or kept flag, a score
    by more than 1e-6, or a box value by more than 1e-5 (1 + |value|)
    (a few float32 roundings of sigmoid, exp and atan2)."""
    bad = prog["query"] != mine["query"]
    bad |= prog["labels"] != mine["labels"]
    bad |= prog["keep"] != mine["keep"]
    bad |= np.abs(prog["scores"] - mine["scores"]) > 1e-6
    bad |= (np.abs(prog["boxes"] - mine["boxes"])
            > 1e-5 * (1 + np.abs(mine["boxes"]))).any(-1)
    return int(bad.sum())


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

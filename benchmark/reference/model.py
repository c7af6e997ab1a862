"""PARQ in plain PyTorch: the reference that decides `correct`.

A frozen, functional copy of the model the benchmark measures
(ResNet-FPN concat backbone, ray positional encoding, the recurrent
decoder with pixel-aligned sampling, self- and cross-attention, FFN and
the four heads), written from the published description and the
checkpoint's state-dict layout. It imports nothing of the measured
program and takes no tensor the program made: weights come from
`benchmark.weights`, inputs from `benchmark.data`.

Everything runs in float32 with TF32 off, by default. `Precision("fp8")`
rounds every operand of a matrix product or convolution to float8 e4m3
with a per-tensor scale (the control: one step below the bf16 the
configuration states). The forward is the eval forward: no dropout. The
L iterations run one after another.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGES = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}
BOTTLENECK = {"resnet50"}


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale that maps its
    largest magnitude to the format's largest value, 448."""
    scale = 448.0 / x.abs().amax().float().clamp(min=1e-30)
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale
            ).to(x.dtype)


class Precision:
    """Where the reference rounds: "f32" nowhere; "fp8" every operand of a
    matrix product or convolution, in e4m3 with a per-tensor scale."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def r(self, x):
        return round_fp8(x) if self.kind == "fp8" else x

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def matmul(self, a, b):
        return self.r(a) @ self.r(b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.r(x), self.r(w), b, stride, padding)


# ---- the parameter layout (the checkpoint's keys) ------------------------

def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model's state dict, in a
    fixed order. kind: "matrix" (rank >= 2, drawn N(0, 1/fan_in)),
    "head_out" (a head's output layer, drawn smaller: `weights`),
    "refpoint" (N(0, 1)), "bias" (0), "scale" (1), "bn_*" (frozen
    BatchNorm: weight 1, bias 0, mean 0, var 1)."""
    specs = []

    def bn(prefix, n):
        for k, kind in (("weight", "bn_one"), ("bias", "bn_zero"),
                        ("running_mean", "bn_zero"),
                        ("running_var", "bn_one")):
            specs.append((f"{prefix}.{k}", (n,), kind))

    body = "backbone2d.resnet_fpn.body"
    specs.append((f"{body}.conv1.weight", (64, 3, 7, 7), "matrix"))
    bn(f"{body}.bn1", 64)
    bottleneck = cfg["resnet_name"] in BOTTLENECK
    exp = 4 if bottleneck else 1
    cin, width, outs = 64, 64, []
    for si, blocks in enumerate(STAGES[cfg["resnet_name"]]):
        for bi in range(blocks):
            p = f"{body}.layer{si + 1}.{bi}"
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            if bottleneck:
                convs = [(cin, width, 1), (width, width, 3),
                         (width, 4 * width, 1)]
            else:
                convs = [(cin, width, 3), (width, width, 3)]
            for ci, (a, b, k) in enumerate(convs):
                specs.append((f"{p}.conv{ci + 1}.weight", (b, a, k, k),
                              "matrix"))
                bn(f"{p}.bn{ci + 1}", b)
            if bi == 0 and (stride != 1 or cin != width * exp):
                specs.append((f"{p}.downsample.0.weight",
                              (width * exp, cin, 1, 1), "matrix"))
                bn(f"{p}.downsample.1", width * exp)
            cin = width * exp
        outs.append(cin)
        width *= 2
    Fc = cfg["fpn_channels"]
    fpn = "backbone2d.resnet_fpn.fpn"
    for i, c in enumerate(outs):
        specs += [(f"{fpn}.inner_blocks.{i}.weight", (Fc, c, 1, 1), "matrix"),
                  (f"{fpn}.inner_blocks.{i}.bias", (Fc,), "bias")]
    for i in range(len(outs)):
        specs += [(f"{fpn}.layer_blocks.{i}.weight", (Fc, Fc, 3, 3),
                   "matrix"),
                  (f"{fpn}.layer_blocks.{i}.bias", (Fc,), "bias")]
    Dt, D = cfg["tokenizer_out_channels"], cfg["dec_dim"]

    def lin(name, o, i):
        specs.extend([(f"{name}.weight", (o, i), "matrix"),
                      (f"{name}.bias", (o,), "bias")])

    lin("add_ray_pe.encoder.0", Dt, 3 * cfg["num_samples"])
    lin("add_ray_pe.encoder.2", Dt, Dt)
    dec = "box3d_decoder"
    specs.append((f"{dec}.refpoint.weight", (cfg["num_queries"], 3),
                  "refpoint"))
    pd = f"{dec}.parq_module.decoder"
    lin(f"{pd}.position_encoder.0", D, 384)
    lin(f"{pd}.position_encoder.2", D, D)
    ly = f"{pd}.layers.0"
    for att in ("self_attn", "multihead_attn"):
        specs += [(f"{ly}.{att}.in_proj_weight", (3 * D, D), "matrix"),
                  (f"{ly}.{att}.in_proj_bias", (3 * D,), "bias")]
        lin(f"{ly}.{att}.out_proj", D, D)
    lin(f"{ly}.linear1", cfg["dec_ffn_dim"], D)
    lin(f"{ly}.linear2", D, cfg["dec_ffn_dim"])
    for n in (1, 2, 3):
        specs += [(f"{ly}.norm{n}.weight", (D,), "scale"),
                  (f"{ly}.norm{n}.bias", (D,), "bias")]
    heads = {"sem_cls_head": ((), cfg["num_semcls"] + 1),
             "center_head": ((D, D), 3), "size_head": ((), 3),
             "rotation_head": ((D, D), 6)}
    for hname, (hidden, out) in heads.items():
        p, c, idx = f"{dec}.mlp_heads.{hname}.layers", D, 0
        for h in hidden:
            specs += [(f"{p}.{idx}.weight", (h, c, 1), "matrix"),
                      (f"{p}.{idx + 1}.weight", (h,), "scale"),
                      (f"{p}.{idx + 1}.bias", (h,), "bias")]
            c, idx = h, idx + 4
        specs += [(f"{p}.{idx}.weight", (out, c, 1), "head_out"),
                  (f"{p}.{idx}.bias", (out,), "bias")]
    return specs


# ---- geometry --------------------------------------------------------------

def pose_R(p):
    return p[..., :9].reshape(p.shape[:-1] + (3, 3))


def pose_t(p):
    return p[..., 9:12]


def pose_make(R, t):
    return torch.cat([R.reshape(R.shape[:-2] + (9,)), t], dim=-1)


def pose_inv(p):
    Rt = pose_R(p).transpose(-1, -2)
    return pose_make(Rt, -(Rt @ pose_t(p)[..., None])[..., 0])


def pose_mul(a, b):
    """a ∘ b: the pose that applies b, then a."""
    Ra, Rb = pose_R(a), pose_R(b)
    return pose_make(Ra @ Rb, (Ra @ pose_t(b)[..., None])[..., 0] + pose_t(a))


def pose_apply(p, x):
    """Points x (..., N, 3) by poses p (..., 12)."""
    return x @ pose_R(p).transpose(-1, -2) + pose_t(p)[..., None, :]


def camera_at_scale(cam, s):
    return torch.cat([cam[..., :2] * s, cam[..., 2:4] * s,
                      (cam[..., 4:6] + 0.5) * s - 0.5], dim=-1)


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def rot_from_ortho6d(o):
    def unit(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-8)
    x = unit(o[..., 0:3])
    z = unit(torch.linalg.cross(x, o[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


# ---- backbone --------------------------------------------------------------

def _bn(w, prefix, x):
    inv = w[prefix + ".weight"] / torch.sqrt(w[prefix + ".running_var"]
                                             + 1e-5)
    shift = w[prefix + ".bias"] - w[prefix + ".running_mean"] * inv
    return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def backbone(w, cfg, images, P: Precision):
    """images (B, T, H, W, 3) in [0, 1] → tokens (B, T, h, w, C) at
    pyramid level 0, every level resized to it and concatenated."""
    B, T, H, W, _ = images.shape
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = ((images.reshape(B * T, H, W, 3) - mean) / std).permute(0, 3, 1, 2)
    body = "backbone2d.resnet_fpn.body"
    x = F.relu(_bn(w, f"{body}.bn1",
                   P.conv(x, w[f"{body}.conv1.weight"], None, 2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    bottleneck = cfg["resnet_name"] in BOTTLENECK
    feats = []
    for si, blocks in enumerate(STAGES[cfg["resnet_name"]]):
        for bi in range(blocks):
            p = f"{body}.layer{si + 1}.{bi}"
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            if bottleneck:
                out = F.relu(_bn(w, f"{p}.bn1",
                                 P.conv(x, w[f"{p}.conv1.weight"])))
                out = F.relu(_bn(w, f"{p}.bn2", P.conv(
                    out, w[f"{p}.conv2.weight"], None, stride, 1)))
                out = _bn(w, f"{p}.bn3", P.conv(out, w[f"{p}.conv3.weight"]))
            else:
                out = F.relu(_bn(w, f"{p}.bn1", P.conv(
                    x, w[f"{p}.conv1.weight"], None, stride, 1)))
                out = _bn(w, f"{p}.bn2",
                          P.conv(out, w[f"{p}.conv2.weight"], None, 1, 1))
            if f"{p}.downsample.0.weight" in w:
                idt = _bn(w, f"{p}.downsample.1", P.conv(
                    x, w[f"{p}.downsample.0.weight"], None, stride, 0))
            else:
                idt = x
            x = F.relu(out + idt)
        feats.append(x)
    fpn = "backbone2d.resnet_fpn.fpn"
    lat = [P.conv(f, w[f"{fpn}.inner_blocks.{i}.weight"],
                  w[f"{fpn}.inner_blocks.{i}.bias"])
           for i, f in enumerate(feats)]
    outs, prev = [lat[-1]], lat[-1]
    for l in lat[-2::-1]:
        prev = l + F.interpolate(prev, size=l.shape[-2:], mode="nearest")
        outs.insert(0, prev)
    pyr = [P.conv(o, w[f"{fpn}.layer_blocks.{i}.weight"],
                  w[f"{fpn}.layer_blocks.{i}.bias"], 1, 1)
           for i, o in enumerate(outs)]
    size = pyr[0].shape[-2:]
    levels = [pyr[0]] + [F.interpolate(p, size=size, mode="bilinear",
                                       align_corners=False)
                         for p in pyr[1:4]]
    v = torch.cat(levels, dim=1).permute(0, 2, 3, 1)
    return v.reshape(B, T, size[0], size[1], v.shape[-1])


def feat_size(cfg):
    W, H = cfg["image_size"]
    return W // 4, H // 4


def ray_encoding(w, cfg, cam, Tcp, Twp, Twl, P: Precision):
    """The rays' positional encoding (B, T, h, w, C): log-spaced depth
    samples along each feature pixel's ray in the snippet's local frame,
    normalised by the scene box, through the two-layer MLP."""
    fw, fh = feat_size(cfg)
    dev = cam.device
    B, T = Tcp.shape[:2]
    y, x = torch.meshgrid(torch.arange(fh, dtype=torch.float32, device=dev),
                          torch.arange(fw, dtype=torch.float32, device=dev),
                          indexing="ij")
    uv = torch.stack([x, y], -1).reshape(1, 1, fh * fw, 2)
    xy = (uv - cam[..., None, 4:6]) / cam[..., None, 2:4]
    rays = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)   # (B,T,HW,3)
    T_local_cam = pose_mul(pose_mul(pose_inv(Twl), Twp), pose_inv(Tcp))
    rdir = rays @ pose_R(T_local_cam).transpose(-1, -2)
    n = cfg["num_samples"]
    ramp = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=dev)
    lo_d, hi_d = cfg["min_depth"], cfg["max_depth"]
    d = torch.exp(math.log(lo_d) + math.log(hi_d / lo_d) * ramp)
    pts = rdir[..., None, :] * d[:, None] + pose_t(T_local_cam)[:, :, None,
                                                                None, :]
    s = cfg["ray_points_scale"]
    lo = torch.tensor([s[0], s[2], s[4]], device=dev)
    span = torch.tensor([s[1] - s[0], s[3] - s[2], s[5] - s[4]], device=dev)
    pts = inverse_sigmoid((pts - lo) / span).reshape(B, T, fh, fw, 3 * n)
    e = "add_ray_pe.encoder"
    h = F.relu(P.linear(pts, w[f"{e}.0.weight"], w[f"{e}.0.bias"]))
    return P.linear(h, w[f"{e}.2.weight"], w[f"{e}.2.bias"])


# ---- decoder ---------------------------------------------------------------

def posemb3d(pos, num_feats=128, temperature=10000.0):
    pos = pos * (2.0 * math.pi)
    i = torch.arange(num_feats, dtype=pos.dtype, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(i / 2.0) / num_feats)

    def emb(p):
        v = p[..., None] / dim_t
        return torch.stack([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])],
                           -1).reshape(v.shape)
    return torch.cat([emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2])],
                     -1)


def normalize_points(p, s):
    lo = p.new_tensor([s[0], s[2], s[4]])
    span = p.new_tensor([s[1] - s[0], s[3] - s[2], s[5] - s[4]])
    return (p - lo) / span


def denormalize_points(p, s):
    lo = p.new_tensor([s[0], s[2], s[4]])
    span = p.new_tensor([s[1] - s[0], s[3] - s[2], s[5] - s[4]])
    return p * span + lo


def sample_views(memory, query, T_cam_local, cam):
    """Pixel-aligned features: each query projected into every view and
    sampled bilinearly (align_corners=True, zero outside), summed over
    the views and divided by the number of views in which it is valid.
    → features (B, Q, C), center_im (B, T, Q, 2), center_valid (B, T, Q)."""
    B, T, H, W, C = memory.shape
    pc = pose_apply(T_cam_local, query[:, None])                # (B,T,Q,3)
    z = pc[..., 2]
    front = z > 1e-3
    uv = pc[..., :2] / z.clamp(min=1e-3)[..., None] * cam[..., None, 2:4] \
        + cam[..., None, 4:6]
    size = cam[..., None, :2]
    valid = front & ((uv >= 0) & (uv <= size - 1)).all(-1)
    x, y = uv[..., 0], uv[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = memory.reshape(B * T, H * W, C)
    Q = query.shape[1]
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            ix, iy = x0 + dx, y0 + dy
            wgt = (x - x0 if dx else 1 - (x - x0)) * \
                (y - y0 if dy else 1 - (y - y0))
            inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).long()
            vals = torch.gather(flat, 1, idx.reshape(B * T, Q, 1)
                                .expand(B * T, Q, C)).reshape(B, T, Q, C)
            out = out + vals * (wgt * inb)[..., None]
    count = valid.float().sum(1).clamp(min=1.0)
    return out.sum(1) / count[..., None], uv, valid


def layer_norm(x, w, b):
    return F.layer_norm(x, x.shape[-1:], w, b, 1e-6)


def group_norm1(x, w, b):
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * w + b


def head(w, name, x, P: Precision):
    p = f"box3d_decoder.mlp_heads.{name}.layers"
    idx = 0
    while f"{p}.{idx + 1}.weight" in w:
        x = P.linear(x, w[f"{p}.{idx}.weight"][..., 0])
        x = F.relu(group_norm1(x, w[f"{p}.{idx + 1}.weight"],
                               w[f"{p}.{idx + 1}.bias"]))
        idx += 4
    return P.linear(x, w[f"{p}.{idx}.weight"][..., 0], w[f"{p}.{idx}.bias"])


def _split_heads(x, H):
    B, N, Fd = x.shape
    return x.view(B, N, H, Fd // H).transpose(1, 2)


def decoder_layer(w, cfg, tgt, pos, k, v, P: Precision):
    """Post-norm decoder layer: self-attention over the queries,
    cross-attention over the memory tokens (k, v: (B, H, N, hd)), FFN."""
    ly = "box3d_decoder.parq_module.decoder.layers.0"
    D, H = cfg["dec_dim"], cfg["dec_heads"]
    hd = D // H
    B, Q, _ = tgt.shape

    wi, bi = w[f"{ly}.self_attn.in_proj_weight"], w[f"{ly}.self_attn.in_proj_bias"]
    qk_in = tgt + pos
    q = _split_heads(P.linear(qk_in, wi[:D], bi[:D]), H) * hd ** -0.5
    kk = _split_heads(P.linear(qk_in, wi[D:2 * D], bi[D:2 * D]), H)
    vv = _split_heads(P.linear(tgt, wi[2 * D:], bi[2 * D:]), H)
    a = torch.softmax(P.matmul(q, kk.transpose(-1, -2)), dim=-1)
    o = P.matmul(a, vv).transpose(1, 2).reshape(B, Q, D)
    sa = P.linear(o, w[f"{ly}.self_attn.out_proj.weight"],
                  w[f"{ly}.self_attn.out_proj.bias"])
    tgt = layer_norm(tgt + sa, w[f"{ly}.norm1.weight"],
                     w[f"{ly}.norm1.bias"])

    wm, bm = (w[f"{ly}.multihead_attn.in_proj_weight"],
              w[f"{ly}.multihead_attn.in_proj_bias"])
    cq = _split_heads(P.linear(tgt + pos, wm[:D], bm[:D]), H) * hd ** -0.5
    N = k.shape[2]
    outs = []
    for b in range(B):                      # one row at a time: (H, Q, N)
        s = P.matmul(cq[b], k[b].transpose(-1, -2))
        p = torch.softmax(s, dim=-1)
        outs.append(P.matmul(p, v[b]))
    o = torch.stack(outs).transpose(1, 2).reshape(B, Q, D)
    ca = P.linear(o, w[f"{ly}.multihead_attn.out_proj.weight"],
                  w[f"{ly}.multihead_attn.out_proj.bias"])
    tgt = layer_norm(tgt + ca, w[f"{ly}.norm2.weight"],
                     w[f"{ly}.norm2.bias"])

    h = F.relu(P.linear(tgt, w[f"{ly}.linear1.weight"],
                        w[f"{ly}.linear1.bias"]))
    f = P.linear(h, w[f"{ly}.linear2.weight"], w[f"{ly}.linear2.bias"])
    return layer_norm(tgt + f, w[f"{ly}.norm3.weight"],
                      w[f"{ly}.norm3.bias"])


def forward(w: Dict[str, torch.Tensor], cfg: dict,
            batch: Dict[str, torch.Tensor], mean_size: torch.Tensor,
            P: Precision = Precision(),
            centers: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """The model's outputs, stacked over the L iterations (L, B, Q, ...).
    batch: rgb_img (B, T, H, W, 3) in [0, 1], camera (B, T, 6),
    T_camera_pseudoCam, T_world_pseudoCam (B, T, 12), T_world_local
    (B, 1, 12). `centers` (L, B, Q, 3): another run's centers; iteration
    l > 0 then starts from that run's centers of iteration l − 1 instead
    of its own (to follow that run's trajectory); iteration 0 always
    starts from the learned points."""
    cam = camera_at_scale(batch["camera"], 0.25)
    Tcp, Twp = batch["T_camera_pseudoCam"], batch["T_world_pseudoCam"]
    Twl = batch["T_world_local"]
    memory = backbone(w, cfg, batch["rgb_img"], P) + ray_encoding(
        w, cfg, cam, Tcp, Twp, Twl, P)
    B, T, h, wd, C = memory.shape
    D, H = cfg["dec_dim"], cfg["dec_heads"]
    ly = "box3d_decoder.parq_module.decoder.layers.0"
    wm, bm = (w[f"{ly}.multihead_attn.in_proj_weight"],
              w[f"{ly}.multihead_attn.in_proj_bias"])
    tokens = memory.reshape(B, T * h * wd, C)
    k = _split_heads(P.linear(tokens, wm[D:2 * D], bm[D:2 * D]), H)
    v = _split_heads(P.linear(tokens, wm[2 * D:], bm[2 * D:]), H)
    T_cam_local = pose_mul(Tcp, pose_mul(pose_inv(Twp), Twl))
    s = cfg["scale"]
    pe = "box3d_decoder.parq_module.decoder.position_encoder"
    ref = torch.sigmoid(w["box3d_decoder.refpoint.weight"])[None].expand(
        B, -1, 3)
    outs = []
    for l in range(cfg["dec_layers"]):
        pos = P.linear(F.relu(P.linear(posemb3d(ref), w[f"{pe}.0.weight"],
                                       w[f"{pe}.0.bias"])),
                       w[f"{pe}.2.weight"], w[f"{pe}.2.bias"])
        query_metric = denormalize_points(ref, s)
        pix, center_im, center_valid = sample_views(
            memory, query_metric, T_cam_local, cam)
        out = decoder_layer(w, cfg, pix, pos, k, v, P)
        offset = head(w, "center_head", out, P)
        center_norm = torch.sigmoid(offset + inverse_sigmoid(ref))
        center = denormalize_points(center_norm, s)
        logits = head(w, "sem_cls_head", out, P)
        size_scale = head(w, "size_head", out, P)
        ortho6d = head(w, "rotation_head", out, P)
        prob = torch.softmax(logits, -1)
        cls = prob.argmax(-1)
        outs.append({
            "pred_logits": logits, "center_unnormalized": center,
            "size_unnormalized": torch.exp(size_scale)
            * mean_size[cls],
            "ortho6d": ortho6d, "sem_cls_prob": prob,
            "coord_pos": query_metric, "center_im": center_im,
            "center_valid": center_valid})
        ref = normalize_points(center if centers is None else centers[l],
                               s).detach()
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


def load_mean_size(path: str, num_semcls: int,
                   class_names: Sequence[str]) -> torch.Tensor:
    """(num_semcls + 1, 3) mean box sizes by class id from the table file
    (`name,alias,...: [x y z]` lines): each class's row where one of a
    line's names equals the class name, else ones, then ones for the
    background."""
    table = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            names, vals = line.split(": ")
            nums = [float(v) for v in vals.strip().strip("[]").split()][:3]
            for n in names.split(","):
                table.setdefault(n, nums)
    rows = [table.get(class_names[i], [1.0, 1.0, 1.0])
            for i in range(num_semcls)] + [[1.0, 1.0, 1.0]]
    return torch.tensor(rows, dtype=torch.float32)

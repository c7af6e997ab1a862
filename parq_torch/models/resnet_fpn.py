"""ResNet + FPN backbone with the reference's concat-to-level-0 trick
(port of parq_tpu/models/resnet_fpn.py).

torchvision's resnet_fpn_backbone as the reference uses it: frozen
BatchNorm, an FPN over C2..C5 with torch-nearest top-down upsampling, then
every level resized bilinearly (align_corners=False) to level 0 and
concatenated (C = 4 · fpn_channels); `layer` picks the target level
(BACKBONE2D.LAYER) and `freeze` stops the gradient at the resized levels
(BACKBONE2D.FREEZE), as parq_tpu/models/resnet_fpn.py:270-273. A level
larger than the target is resized with an antialiased (triangle) filter,
as `jax.image.resize` does when it shrinks. Convolutions run NCHW in
channels_last memory format, so the final (B, T, h, w, C) token layout the
JAX model emits is a free permute. Module and buffer names follow the
reference checkpoint (``backbone2d.resnet_fpn.body.*`` / ``.fpn.*``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

RESNET_STAGES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
BOTTLENECK = {"resnet50", "resnet101", "resnet152"}


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine (torchvision
    FrozenBatchNorm2d, eps=1e-5); the per-channel affine is applied in the
    activation's dtype."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return (x * inv.view(1, -1, 1, 1).to(x.dtype)
                + shift.view(1, -1, 1, 1).to(x.dtype))


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = nn.Sequential(
            _conv(cin, width * 4, 1, stride),
            FrozenBatchNorm2d(width * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2, self.bn2 = _conv(width, width, 3), FrozenBatchNorm2d(width)
        self.downsample = nn.Sequential(
            _conv(cin, width, 1, stride),
            FrozenBatchNorm2d(width)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class ResNetBody(nn.Module):
    """conv1/bn1/maxpool + layer1..layer4 → [C2, C3, C4, C5]."""

    def __init__(self, name: str = "resnet50"):
        super().__init__()
        block = Bottleneck if name in BOTTLENECK else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin, width = 64, 64
        self.out_channels = []
        for si, blocks in enumerate(RESNET_STAGES[name]):
            stride = 1 if si == 0 else 2
            layer = []
            for bi in range(blocks):
                down = bi == 0 and (stride != 1 or cin != width
                                    * block.expansion)
                layer.append(block(cin, width, stride if bi == 0 else 1,
                                   down))
                cin = width * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*layer))
            self.out_channels.append(cin)
            width *= 2

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return feats


def _resize(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    """F.interpolate in the activation's own dtype, as the JAX backbone
    resizes: CUDA autocast would run it in float32, and the concatenated
    tokens and everything that reads them (the sampler, its d(memory), the
    K/V projection's input) would then be float32 under bf16 compute.
    Bilinear shrinking is antialiased, as `jax.image.resize`'s."""
    shrink = mode == "bilinear" and (size[0] < x.shape[-2]
                                     or size[1] < x.shape[-1])
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(
            x, size=size, mode=mode,
            align_corners=False if mode == "bilinear" else None,
            antialias=shrink)


class FPN(nn.Module):
    """torchvision FeaturePyramidNetwork: 1x1 laterals, top-down nearest
    upsample (torch's src = floor(dst · in/out)) + add, 3x3 smoothing."""

    def __init__(self, in_channels: List[int], out_channels: int):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [m(f) for m, f in zip(self.inner_blocks, feats)]
        outs = [laterals[-1]]
        prev = laterals[-1]
        for lat in laterals[-2::-1]:
            prev = lat + _resize(prev, lat.shape[-2:], "nearest")
            outs.insert(0, prev)
        return [m(o) for m, o in zip(self.layer_blocks, outs)]


class BackboneWithFPN(nn.Module):
    def __init__(self, resnet_name: str, fpn_channels: int):
        super().__init__()
        self.body = ResNetBody(resnet_name)
        self.fpn = FPN(self.body.out_channels, fpn_channels)


class ResNetFPN(nn.Module):
    """Images (B, T, H, W, 3) in [0, 1] → tokens (B, T, H/s, W/s,
    4 · fpn_channels) with s = 2^(layer + 2), channels-last like the JAX
    model."""

    def __init__(self, resnet_name: str = "resnet50", fpn_channels: int = 256,
                 layer: int = 0, freeze: bool = False):
        super().__init__()
        self.layer, self.freeze = layer, freeze
        self.resnet_fpn = BackboneWithFPN(resnet_name, fpn_channels)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, T, H, W, _ = images.shape
        x = (images.reshape(B * T, H, W, 3) - self.mean) / self.std
        x = x.permute(0, 3, 1, 2)                 # NCHW view, NHWC storage
        x = x.contiguous(memory_format=torch.channels_last)
        pyr = self.resnet_fpn.fpn(self.resnet_fpn.body(x))
        size = pyr[self.layer].shape[-2:]
        levels = [p if i == self.layer else _resize(p, size, "bilinear")
                  for i, p in enumerate(pyr[:4])]
        if self.freeze:
            levels = [p.detach() for p in levels]
        v = torch.cat(levels, dim=1).permute(0, 2, 3, 1)   # (BT, h, w, C)
        return v.reshape(B, T, size[0], size[1], v.shape[-1])

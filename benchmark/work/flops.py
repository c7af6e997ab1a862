"""Matrix-product FLOPs of one sample's eval forward (2 per
multiply-add; no elementwise work), counted from the model's shapes:
338.69 GFLOP a sample of the release configuration."""
from __future__ import annotations

from typing import Dict

STAGES = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}
BOTTLENECK = {"resnet50"}


def _conv(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw[0] * hw[1]


def _out(hw, k, s, p):
    return tuple((n + 2 * p - k) // s + 1 for n in hw)


def backbone_flops(cfg: dict) -> int:
    """The ResNet-FPN's convolutions on one view."""
    W, H = cfg["image_size"]
    hw = _out((H, W), 7, 2, 3)
    total = _conv(3, 64, 7, hw)
    hw = _out(hw, 3, 2, 1)
    bottleneck = cfg["resnet_name"] in BOTTLENECK
    exp = 4 if bottleneck else 1
    cin, width, levels = 64, 64, []
    for si, blocks in enumerate(STAGES[cfg["resnet_name"]]):
        for bi in range(blocks):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out = _out(hw, 3, stride, 1)
            if bottleneck:
                total += (_conv(cin, width, 1, hw) + _conv(width, width, 3, out)
                          + _conv(width, 4 * width, 1, out))
            else:
                total += _conv(cin, width, 3, out) + _conv(width, width, 3, out)
            if bi == 0 and (stride != 1 or cin != width * exp):
                total += _conv(cin, width * exp, 1, out)
            cin, hw = width * exp, out
        levels.append((cin, hw))
        width *= 2
    Fc = cfg["fpn_channels"]
    for c, lhw in levels:
        total += _conv(c, Fc, 1, lhw) + _conv(Fc, Fc, 3, lhw)
    return total


def forward_flops(cfg: dict) -> Dict[str, int]:
    """FLOPs of one sample's forward by part."""
    T = cfg["num_views"]
    w, h = cfg["image_size"][0] // 4, cfg["image_size"][1] // 4
    N, D, Dt = T * h * w, cfg["dec_dim"], cfg["tokenizer_out_channels"]
    Q, Fd, L = cfg["num_queries"], cfg["dec_ffn_dim"], cfg["dec_layers"]
    per_iter = 2 * Q * (
        384 * D + D * D                          # position encoder
        + 3 * D * D + 2 * Q * D + D * D          # self-attention
        + D * D + D * D                          # cross q, out proj
        + 2 * D * Fd                             # FFN
        + D * (cfg["num_semcls"] + 1) + 3 * D    # class, size heads
        + 2 * (2 * D * D) + 9 * D)               # center, rotation
    return {"backbone": T * backbone_flops(cfg),
            "ray_pe": 2 * N * (3 * cfg["num_samples"] * Dt + Dt * Dt),
            "kv_projection": 2 * N * D * 2 * D,
            "cross_attention": L * 2 * 2 * Q * N * D,
            "iterations_rest": L * per_iter}


def sample_flops(cfg: dict) -> int:
    return sum(forward_flops(cfg).values())


"""PETR's work, counted from its shapes: the matrix-product FLOPs of one
sample's eval forward (2 per multiply-add; no elementwise work; DCNv2
counted as the 3x3 convolution it is plus its offset conv), and the bytes
of the DCN sampling kernel's bound (each input byte read once, each
output byte written once, bf16)."""
from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import HBM_BYTES_PER_S

STAGES = (3, 4, 6, 3)
POINTS = 9
BF16 = 2


def _conv(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw[0] * hw[1]


def _out(hw, k, s, p):
    return tuple((n + 2 * p - k) // s + 1 for n in hw)


def dcn_maps(cfg: dict) -> List[Tuple[int, Tuple[int, int]]]:
    """(channels, (h, w)) of every DCN block's input, one camera."""
    W, H = cfg["image_size"]
    hw = _out(_out((H, W), 7, 2, 3), 3, 2, 1)
    width, maps = 64, []
    for si, blocks in enumerate(STAGES):
        if si:
            hw = _out(hw, 1, 2, 0)
        if cfg["stage_with_dcn"][si]:
            maps += [(width, hw)] * blocks
        width *= 2
    return maps


def backbone_flops(cfg: dict) -> int:
    """The caffe-style ResNet-50 with DCNv2 and CPFPN's P4, one camera."""
    W, H = cfg["image_size"]
    hw = _out((H, W), 7, 2, 3)
    total = _conv(3, 64, 7, hw)
    hw = _out(hw, 3, 2, 1)
    cin, width, levels = 64, 64, []
    for si, blocks in enumerate(STAGES):
        for bi in range(blocks):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out = _out(hw, 1, stride, 0)           # caffe: conv1's stride
            total += _conv(cin, width, 1, out) + _conv(width, width, 3, out) \
                + _conv(width, 4 * width, 1, out)
            if cfg["stage_with_dcn"][si]:
                total += _conv(width, 3 * POINTS, 3, out)
            if bi == 0:
                total += _conv(cin, 4 * width, 1, out)
            cin, hw = 4 * width, out
        levels.append((cin, hw))
        width *= 2
    D = cfg["embed_dims"]
    for c, lhw in levels[2:]:
        total += _conv(c, D, 1, lhw)
    return total + _conv(D, D, 3, levels[2][1])


def forward_flops(cfg: dict) -> Dict[str, int]:
    """FLOPs of one sample's forward by part."""
    W, H = cfg["image_size"]
    s, D = cfg["stride"], cfg["embed_dims"]
    N = cfg["num_cams"] * (W // s) * (H // s)           # tokens
    Q, F, L = cfg["num_query"], cfg["ffn_dim"], cfg["num_layers"]
    Dn = cfg["depth_num"]
    dcn = sum(_conv(c, c, 3, hw) for c, hw in dcn_maps(cfg))
    heads = 2 * Q * (cfg["num_reg_fcs"] * 2 * D * D
                     + D * (cfg["num_classes"] + cfg["code_size"]))
    return {
        "backbone": cfg["num_cams"] * (backbone_flops(cfg) - dcn),
        "dcn": cfg["num_cams"] * dcn,
        "position_encoders": 2 * N * (D * D + 3 * Dn * 4 * D + 4 * D * D
                                      + 3 * D // 2 * 4 * D + 4 * D * D),
        "query_embedding": 2 * Q * (3 * D // 2 * D + D * D),
        "self_attention": L * 2 * Q * (4 * D * D + 2 * Q * D),
        "kv_projection": L * 2 * N * 2 * D * D,
        "cross_attention": L * 2 * (2 * Q * D * D + 2 * Q * N * D),
        "ffn": L * 2 * Q * 2 * D * F,
        "heads": L * heads,
    }


def sample_flops(cfg: dict) -> int:
    return sum(forward_flops(cfg).values())


def dcn_bytes(cfg: dict, batch: int) -> int:
    """Bytes of the DCN sampling kernel's launches of one forward: the
    input map, the 27 offset and mask channels read once and the nine
    columns a pixel and channel written once, bf16."""
    per = sum(h * w * (c + 3 * POINTS + POINTS * c)
              for c, (h, w) in dcn_maps(cfg))
    return batch * cfg["num_cams"] * per * BF16


def dcn_bound_s(cfg: dict, batch: int) -> float:
    """The least time the card could take for those launches: bytes over
    the memory bandwidth (the sampling does no matrix product)."""
    return dcn_bytes(cfg, batch) / HBM_BYTES_PER_S

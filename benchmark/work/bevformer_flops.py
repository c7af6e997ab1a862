"""BEVFormer's work, counted from its shapes: the matrix-product FLOPs of
one sample's eval forward (2 per multiply-add; no elementwise work, so
not the deformable attentions' gathers; DCNv2 counted as the 3x3
convolution it is plus its offset conv; each layer's box head once), and
the bytes of the multi-scale deformable attention kernels' bound (each
input byte read once, each output byte written once).

The MSDA bound a forward, B samples, per encoder layer: the spatial
cross-attention's value maps (cameras x 30,825 rows x 256, bf16), the
per-query offsets and logits (bf16), the per-camera reference points
(f32) and hit mask (bytes), the output rows (bf16); the temporal
self-attention's two BEV value frames, its offsets, logits and reference
points, its output; per decoder layer the BEV value map, the 900
queries' offsets, logits, reference points and output. It is fixed by
the configuration, not by the rig's hits nor by how a kernel pads or
lays out its work."""
from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import HBM_BYTES_PER_S

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
POINTS = 9
BF16, F32 = 2, 4


def _conv(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw[0] * hw[1]


def _out(hw, k, s, p):
    return tuple((n + 2 * p - k) // s + 1 for n in hw)


def padded(cfg: dict) -> Tuple[int, int]:
    d = cfg["size_divisor"]
    W, H = cfg["image_size"]
    return -(-H // d) * d, -(-W // d) * d


def backbone(cfg: dict) -> Tuple[int, int, List[Tuple[int, Tuple[int, int]]]]:
    """(FLOPs of the caffe ResNet, one camera; of its DCN 3x3 convs; the
    (channels, (h, w)) of C2..C5)."""
    hw = _out(padded(cfg), 7, 2, 3)
    total, dcn = _conv(3, 64, 7, hw), 0
    hw = _out(hw, 3, 2, 1)
    cin, width, levels = 64, 64, []
    for si, blocks in enumerate(STAGES[cfg["resnet_name"]]):
        for bi in range(blocks):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out = _out(hw, 1, stride, 0)           # caffe: conv1's stride
            total += _conv(cin, width, 1, out) + _conv(width, width, 3, out) \
                + _conv(width, 4 * width, 1, out)
            if cfg["stage_with_dcn"][si]:
                total += _conv(width, 3 * POINTS, 3, out)
                dcn += _conv(width, width, 3, out)
            if bi == 0:
                total += _conv(cin, 4 * width, 1, out)
            cin, hw = 4 * width, out
        levels.append((cin, hw))
        width *= 2
    return total, dcn, levels


def level_shapes(cfg: dict) -> List[Tuple[int, int]]:
    _, _, levels = backbone(cfg)
    shapes = [hw for _, hw in levels[1:]]
    while len(shapes) < cfg["num_levels"]:
        shapes.append(_out(shapes[-1], 3, 2, 1))
    return shapes


def forward_flops(cfg: dict) -> Dict[str, int]:
    """FLOPs of one sample's forward by part."""
    N, D, Hh = cfg["num_cams"], cfg["embed_dims"], cfg["num_heads"]
    F, L = cfg["ffn_dim"], cfg["num_levels"]
    Qb = cfg["bev_h"] * cfg["bev_w"]
    Q = cfg["num_query"]
    body, dcn, levels = backbone(cfg)
    shapes = level_shapes(cfg)
    Nv = sum(h * w for h, w in shapes)
    neck = sum(_conv(c, D, 1, hw) + _conv(D, D, 3, hw)
               for c, hw in levels[1:])
    neck += sum(_conv(D, D, 3, hw) for hw in shapes[len(levels) - 1:])
    Pt, Ps, Pd = cfg["tsa_points"], cfg["sca_points"], cfg["decoder_points"]
    tsa = 2 * (2 * Qb * D * D + Qb * 2 * D * (2 * Hh * Pt * 3)
               + Qb * D * D)
    sca = 2 * (N * Nv * D * D + Qb * D * Hh * L * Ps * 3 + Qb * D * D)
    ffn_bev = 2 * Qb * 2 * D * F
    self_attn = 2 * (4 * Q * D * D + 2 * Q * Q * D)
    cross = 2 * (Qb * D * D + Q * D * Hh * Pd * 3 + Q * D * D)
    ffn_q = 2 * Q * 2 * D * F
    n = cfg["num_reg_fcs"]
    heads = 2 * Q * (2 * n * D * D + D * (cfg["num_classes"]
                                          + cfg["code_size"]))
    can = cfg["can_bus_dims"]
    return {
        "backbone": N * (body - dcn),
        "dcn": N * dcn,
        "neck": N * neck,
        "can_bus_mlp": 2 * (can * D // 2 + D // 2 * D),
        "temporal_self_attention": cfg["encoder_layers"] * tsa,
        "spatial_cross_attention": cfg["encoder_layers"] * sca,
        "encoder_ffn": cfg["encoder_layers"] * ffn_bev,
        "reference_points": 2 * Q * D * 3,
        "decoder": cfg["decoder_layers"] * (self_attn + cross + ffn_q),
        "heads": cfg["decoder_layers"] * heads,
    }


def sample_flops(cfg: dict) -> int:
    return sum(forward_flops(cfg).values())


def msda_bytes(cfg: dict, batch: int) -> int:
    """Bytes of the MSDA kernels' launches of one forward (see the
    module's docstring)."""
    N, D, Hh, L = cfg["num_cams"], cfg["embed_dims"], cfg["num_heads"], \
        cfg["num_levels"]
    Qb = cfg["bev_h"] * cfg["bev_w"]
    Q = cfg["num_query"]
    A = cfg["num_points_in_pillar"]
    Nv = sum(h * w for h, w in level_shapes(cfg))
    Pt, Ps, Pd = cfg["tsa_points"], cfg["sca_points"], cfg["decoder_points"]
    sca = (N * Nv * D * BF16 + Qb * Hh * L * Ps * 3 * BF16
           + N * Qb * A * 2 * F32 + N * Qb + Qb * D * BF16)
    tsa = (2 * Qb * D * BF16 + Qb * Hh * 2 * Pt * 3 * BF16 + Qb * 2 * F32
           + Qb * D * BF16)
    dec = (Qb * D * BF16 + Q * Hh * Pd * 3 * BF16 + Q * 2 * F32
           + Q * D * BF16)
    return batch * (cfg["encoder_layers"] * (sca + tsa)
                    + cfg["decoder_layers"] * dec)


def msda_bound_s(cfg: dict, batch: int) -> float:
    """The least time the card could take for those launches: bytes over
    the memory bandwidth (the gather does no matrix product)."""
    return msda_bytes(cfg, batch) / HBM_BYTES_PER_S

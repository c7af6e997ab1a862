"""PETR's weights, made from the seed on the device in one draw.

Every matrix (rank ≥ 2) is N(0, 1/fan_in) (LeCun normal), with three
exceptions: each head's output layer N(0, HEAD_OUT_SCALE²/fan_in), so that
the box centres' sigmoids sit away from 0 and 1 as a trained model's do
(the random model's centres otherwise pile up on the edges of pc_range);
each DCN offset conv's offset rows N(0, OFFSET_SCALE²/fan_in) and its
mask rows N(0, MASK_SCALE²/fan_in), so that the sampling points move by a
few pixels (a standard deviation of 1–2 and up to ~10 on the CPU test's
images) and the masks' sigmoids spread between 0 and 1, away from both
(mmcv initialises these convs to zero, where a DCN is a plain convolution
and a wrong gather would not show); and the reference points
U(0, 1) (PETRHead's init), as Φ of a normal draw. Biases are 0, norm
scales 1, the frozen BatchNorm statistics identity. The normal draws come
from one `torch.Generator` on the device, as one `randn` over all of them,
cut into the tensors in the order of `reference.petr.param_specs`; the
same seed on the same device gives the same bits, so the reference
rebuilds exactly the weights the program was given."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.petr import param_specs

WEIGHT_SALT = 0x5EED_0020
HEAD_OUT_SCALE = 0.1
OFFSET_SCALE = 4.0
MASK_SCALE = 2.0
OFFSET_ROWS = 18            # of the offset conv's 27: (dy, dx) pairs
DRAWN = ("matrix", "head_out", "offset", "refpoint")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for the PETR configuration
    `cfg`."""
    device = torch.device(device)
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, kind in specs
                if kind in DRAWN)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ WEIGHT_SALT) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    scale = {"matrix": 1.0, "head_out": HEAD_OUT_SCALE}
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in DRAWN:
            t = flat[at:at + n].view(shape)
            at += n
            if kind == "refpoint":
                t = torch.special.ndtr(t)
            elif kind == "offset":
                t = t / math.sqrt(math.prod(shape[1:]))
                t = torch.cat([t[:OFFSET_ROWS] * OFFSET_SCALE,
                               t[OFFSET_ROWS:] * MASK_SCALE])
            else:
                t = t * (scale[kind] / math.sqrt(math.prod(shape[1:])))
            out[name] = t
        elif kind in ("scale", "bn_one"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out

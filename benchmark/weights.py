"""The model's weights, made from the seed on the device in one draw.

Every matrix (rank ≥ 2) is N(0, 1/fan_in) (LeCun normal), but the
output layer of each head N(0, (HEAD_OUT_SCALE)²/fan_in); the learned
reference points N(0, 1), biases 0, norm scales 1, and the frozen
BatchNorm statistics identity. The smaller head outputs keep the random
model's boxes where a trained model's are: in LeCun scale every query's
center drifts the same way through the 8 iterations, all of them end on
one edge of the scene box and outside the track box, and eval's NMS and
track filter then see no box to keep. The normal draws come from one
`torch.Generator` on the device, as one `randn` over all of them, cut
into the tensors in the order of `reference.model.param_specs`; the
same seed on the same device gives the same bits, so the reference
rebuilds exactly the weights the program was given."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import param_specs

WEIGHT_SALT = 0x5EED_0001
HEAD_OUT_SCALE = 0.1


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for the configuration `cfg`."""
    device = torch.device(device)
    specs = param_specs(cfg)
    drawn = [s for s in specs if s[2] in ("matrix", "head_out", "refpoint")]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ WEIGHT_SALT) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in ("matrix", "head_out", "refpoint"):
            t = flat[at:at + n].view(shape)
            at += n
            if kind != "refpoint":
                t = t * ((HEAD_OUT_SCALE if kind == "head_out" else 1.0)
                         / math.sqrt(math.prod(shape[1:])))
            out[name] = t
        elif kind in ("scale", "bn_one"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out

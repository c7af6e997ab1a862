"""BEVFormer's weights, made from the seed on the device in one draw.

Every matrix (rank ≥ 2) is N(0, 1/fan_in) (LeCun normal), with these
exceptions, each so that the mechanism the cell measures does its work:
- each head's output layer N(0, HEAD_OUT_SCALE²/fan_in), so that the box
  centres' sigmoids sit away from 0 and 1 as a trained model's do;
- each DCN offset conv as `weights_petr` draws it: offset rows at
  OFFSET_SCALE and mask rows at MASK_SCALE times LeCun (sampling points
  moved by a few pixels, masks between 0 and 1; mmcv starts them at
  zero, where a DCN is a plain convolution);
- each deformable attention's offset Linear N(0, MSDA_OFFSET_SCALE² /
  fan_in) on top of mmcv's ring bias (head h's direction at 2πh/heads,
  point i at i + 1 cells), so that the points move by a few cells of
  each level away from the ring, and its attention-logit Linear at
  MSDA_LOGIT_SCALE times LeCun, so that the softmax over the points is
  far from uniform (mmcv starts the logits at zero);
- the embeddings (the BEV queries, the object queries, the camera and
  level embeddings) N(0, 1), nn.Embedding's init; the learned BEV
  positions U(0, 1), mmcv's LearnedPositionalEncoding init, as Φ of a
  normal draw.
Biases other than the ring are 0, norm scales 1, the frozen BatchNorm
statistics identity but the stem's variance, STEM_STD²: BEVFormer's
caffe normalisation divides by 1, so the images reach conv1 at the
0..255 scale, which a trained caffe stem's BatchNorm absorbs (with
identity statistics every map, and every DCN offset with it, would come
out ~57 times larger, and the offsets hundreds of pixels long). The normal draws come from one `torch.Generator` on
the device, as one `randn` over all of them, cut into the tensors in the
order of `reference.bevformer.param_specs`; the same seed on the same
device gives the same bits, so the reference rebuilds exactly the
weights the program was given."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.bevformer import param_specs, ring_of
from .weights_petr import MASK_SCALE, OFFSET_ROWS, OFFSET_SCALE

WEIGHT_SALT = 0x5EED_0024
HEAD_OUT_SCALE = 0.1
MSDA_OFFSET_SCALE = 2.0
MSDA_LOGIT_SCALE = 3.0
STEM_STD = 57.375           # caffe's std of the blue channel (PETR's)
DRAWN = ("matrix", "head_out", "offset", "msda_offset", "msda_logit",
         "embed", "uniform")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for the BEVFormer configuration
    `cfg`."""
    device = torch.device(device)
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, kind in specs
                if kind in DRAWN)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ WEIGHT_SALT) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    scale = {"matrix": 1.0, "head_out": HEAD_OUT_SCALE,
             "msda_offset": MSDA_OFFSET_SCALE,
             "msda_logit": MSDA_LOGIT_SCALE}
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in DRAWN:
            t = flat[at:at + n].view(shape)
            at += n
            if kind == "uniform":
                t = torch.special.ndtr(t)
            elif kind == "embed":
                pass
            elif kind == "offset":
                t = t / math.sqrt(math.prod(shape[1:]))
                t = torch.cat([t[:OFFSET_ROWS] * OFFSET_SCALE,
                               t[OFFSET_ROWS:] * MASK_SCALE])
            else:
                t = t * (scale[kind] / math.sqrt(math.prod(shape[1:])))
            out[name] = t
        elif kind == "msda_ring":
            out[name] = ring_of(cfg, name, n).to(device)
        elif kind == "bn_stem_var":
            out[name] = torch.full(shape, STEM_STD ** 2, device=device)
        elif kind in ("scale", "bn_one"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out

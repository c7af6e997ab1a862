"""A checkpoint in parq_release.ckpt's key layout, made from the port's own
modules at a seed: the file a release-size dress rehearsal loads when the
released weights are not at hand (no download).

The file is ``{"state_dict": {...}}`` and nothing else, as a Lightning
checkpoint of the reference holds it: every ``backbone2d.*``,
``add_ray_pe.*`` and ``box3d_decoder.*`` tensor of the release model
(`ModelConfig()`), plus what released files carry and the port's model
has no use for — the dead decoder-final norm (``decoder.norm.*``, never
applied; `train/checkpoint.py` drops it) and torch BatchNorm's
``num_batches_tracked`` counters. The frozen BatchNorms get non-trivial
statistics and affines (a fresh init's mean 0, var 1, scale 1, shift 0
would hide a wrong fold of them).
"""
from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models import build_model
from ..models.resnet_fpn import FrozenBatchNorm2d
from ..train.checkpoint import DEAD_PREFIX


def synthesize_release_checkpoint(path: str, seed: int = 0) -> str:
    """Write ``{"state_dict": ...}`` in parq_release.ckpt's key layout to
    `path`: the release model's weights from `seed` (f32; the counters
    int64). Returns `path`."""
    cfg = ModelConfig()
    model = build_model(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                n = m.running_mean.numel()
                m.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    sd = dict(model.state_dict())
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.int64)
    sd[DEAD_PREFIX + "weight"] = torch.ones(cfg.dec_dim)
    sd[DEAD_PREFIX + "bias"] = torch.zeros(cfg.dec_dim)
    torch.save({"state_dict": sd}, path)
    return path

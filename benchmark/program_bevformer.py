"""The system under test in the BEVFormer cell, as its loop builds it:
the port's BEVFormer (`parq_torch`) at a configuration file's sizes,
loaded with the benchmark's weights, replayed as a CUDA graph inside the
port's stream runner. Only the port's public entry points are used:
`BEVFormerConfig`, `build_bevformer_model`, `BEVStream`, `Graphed` and
`petr_decode`."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

KEYS = ("img", "lidar2img", "can_bus")


def bevformer_config(cfg: dict):
    """The port's BEVFormerConfig of a configuration file's sizes: the
    file holds every field under the field's own name."""
    from parq_torch.config import BEVFormerConfig
    return BEVFormerConfig(**{
        f.name: tuple(cfg[f.name]) if isinstance(cfg[f.name], list)
        else cfg[f.name] for f in dataclasses.fields(BEVFormerConfig)})


def build_stream(cfg: dict, weights, device):
    """(the port's BEVFormerModel with `weights` on `device` in eval mode,
    its BEVStream around a Graphed forward)."""
    from parq_torch.graphs import Graphed
    from parq_torch.models import BEVStream, build_bevformer_model
    model = build_bevformer_model(bevformer_config(cfg), device=device,
                                  state_dict=weights)
    return model, BEVStream(Graphed(model))


def to_device(host: Dict[str, torch.Tensor], device):
    """A sample's tensors on `device` (non-blocking from pinned memory),
    in their own dtypes: the image stays uint8 until the model's
    normalisation, the CAN-bus float64."""
    return {k: host[k].to(device, non_blocking=True) for k in KEYS}

"""The system under test in the PETR cells, as their loop builds it: the
port's PETR (`parq_torch`) at a configuration file's sizes, loaded with
the benchmark's weights. Only the port's public entry points are used:
`PETRConfig`, `build_petr_model` (beside `build_model`), `Graphed` and
`petr_decode`."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

KEYS = ("img", "lidar2img")


def petr_config(cfg: dict):
    """The port's PETRConfig of a configuration file's sizes: the file
    holds every field under the field's own name."""
    from parq_torch.config import PETRConfig
    return PETRConfig(**{
        f.name: tuple(cfg[f.name]) if isinstance(cfg[f.name], list)
        else cfg[f.name] for f in dataclasses.fields(PETRConfig)})


def build_model(cfg: dict, weights, device):
    """The port's PETRModel with `weights`, on `device`, in eval mode."""
    from parq_torch.models import build_petr_model
    return build_petr_model(petr_config(cfg), device=device,
                            state_dict=weights)


def to_device(host: Dict[str, torch.Tensor], device):
    """A sample's tensors on `device` (non-blocking from pinned memory),
    in their own dtypes: the image stays uint8 until the model's
    normalisation."""
    return {k: host[k].to(device, non_blocking=True) for k in KEYS}

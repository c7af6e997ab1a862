"""Checkpoints with `torch.save` (port of parq_tpu/train/checkpoint.py,
which uses orbax): top-k by validation F1 plus the last, full resume, and
warm starts.

A checkpoint is one file, ``<dir>/step_<n>.pt``: the model's state_dict,
the optimizer's, the step, the loader's `data_state` and the validation
metrics. ``<dir>/index.json`` lists the kept steps with their metrics, so
retention and `best_step` read no checkpoint. JAX orbax checkpoints are
not read.

Several ranks (torch.distributed): every rank calls `save` with the same
state (the ranks' states are equal), rank 0 alone writes the file and the
index, and the others keep the same index in memory and wait for it at a
barrier. Every rank can `restore`. A model sharded for tensor parallelism
(parallel/tensor_parallel.py) is written in the reference layout: `save`
gathers its shards and AdamW's moments over the model group (every rank
takes part), and `restore_state` and `load_pretrained` cut the full
tensors back to the rank's shards, so its checkpoint loads strictly into
one process and one process's into it.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, Optional

import torch

from ..parallel.multihost import barrier, is_main_process
from ..parallel.tensor_parallel import (full_optimizer_state, full_state_dict,
                                        shard_optimizer_state,
                                        shard_state_dict)

logger = logging.getLogger(__name__)

# the dead `decoder.norm` of released checkpoints: the reference never
# applies it (parq_tpu/io/torch_convert.py:244 skips it as well)
DEAD_PREFIX = "box3d_decoder.parq_module.decoder.norm."
_BODY = "backbone2d.resnet_fpn.body."


class CheckpointManager:
    """Keeps the `save_top_k` checkpoints with the best `monitor` metric
    (`mode` "max" or "min"; ties go to the later step) and, with
    `save_last`, the latest one. `save_top_k` -1 keeps every checkpoint;
    checkpoints without the metric are kept only as the latest."""

    def __init__(self, directory: str, save_top_k: int = 3,
                 save_last: bool = True, monitor: str = "0.5_f1",
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"CALLBACK.MODE={mode!r}: 'max' or 'min'")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k, self.save_last = int(save_top_k), bool(save_last)
        self.monitor, self.mode = monitor, mode
        self._index_path = os.path.join(self.directory, "index.json")
        self.index: Dict[int, dict] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.index = {int(k): v for k, v in json.load(f).items()}

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self):
        return sorted(self.index)

    def latest_step(self) -> Optional[int]:
        return max(self.index) if self.index else None

    def _ranked(self):
        """Steps with the monitored metric, best first."""
        scored = [(v[self.monitor], s) for s, v in self.index.items()
                  if isinstance(v.get(self.monitor), (int, float))
                  and not math.isnan(v[self.monitor])]
        sign = -1.0 if self.mode == "max" else 1.0
        return [s for _, s in sorted(scored,
                                     key=lambda t: (sign * t[0], -t[1]))]

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[0] if ranked else None

    def save(self, step: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             metrics: Optional[dict] = None,
             data_state: Optional[dict] = None) -> str:
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        payload = {"model": full_state_dict(model), "step": int(step),
                   "metrics": metrics}
        if optimizer is not None:
            payload["optimizer"] = full_optimizer_state(model, optimizer)
        if data_state is not None:
            payload["data_state"] = {k: int(v) for k, v in data_state.items()}
        path = self.path(step)
        main = is_main_process()
        if main:
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
            logger.info("checkpoint: wrote step %d to %s", step, path)
        self.index[int(step)] = metrics
        self._retain(write=main)
        barrier()
        return path

    def _retain(self, write: bool = True):
        keep = set(self.index)
        if self.save_top_k >= 0:
            keep = set(self._ranked()[:self.save_top_k])
            if self.save_last:
                keep.add(self.latest_step())
        for step in sorted(set(self.index) - keep):
            del self.index[step]
            if write and os.path.exists(self.path(step)):
                os.remove(self.path(step))
        if not write:
            return
        with open(self._index_path + ".tmp", "w") as f:
            json.dump({str(k): v for k, v in sorted(self.index.items())}, f)
        os.replace(self._index_path + ".tmp", self._index_path)

    def restore(self, step: Optional[int] = None, map_location=None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            return {}
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)


def restore_state(mgr: CheckpointManager, model: torch.nn.Module,
                  optimizer: Optional[torch.optim.Optimizer] = None,
                  step: Optional[int] = None) -> dict:
    """Load a checkpoint (the latest unless `step` is given) into `model`
    and `optimizer` in place; returns its extras (step, data_state,
    metrics), or {} when there is none."""
    dev = next(model.parameters()).device
    payload = mgr.restore(step, map_location=dev)
    if not payload:
        return {}
    model.load_state_dict(shard_state_dict(model, payload["model"]),
                          strict=True)
    if optimizer is not None and "optimizer" in payload:
        optimizer.load_state_dict(shard_optimizer_state(
            model, optimizer, payload["optimizer"]))
    return {k: v for k, v in payload.items()
            if k not in ("model", "optimizer")}


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint file. A Lightning checkpoint pickles
    more than tensors, so this unpickles in full: load only files you
    trust, as with the JAX package's reader."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt \
            and isinstance(ckpt["model"], dict):
        ckpt = ckpt["model"]                    # the port's own checkpoint
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]               # a Lightning checkpoint
    return {k: v for k, v in ckpt.items() if torch.is_tensor(v)}


def is_torchvision_resnet_sd(sd) -> bool:
    return "conv1.weight" in sd and "layer1.0.conv1.weight" in sd


def load_pretrained(model: torch.nn.Module, path: str,
                    strict: bool = False) -> None:
    """Load weights into `model` in place from the port's checkpoint, a
    state_dict in the reference layout (``backbone2d.*``, the layout of
    parq_release.ckpt), or a torchvision ResNet state_dict (the body of the
    backbone only: a warm start).

    strict=False, the warm start: keys present in both override, the rest
    keep their init. strict=True, the eval load: every key of the model
    must be in the file and the file may hold no other (a released
    checkpoint's dead ``decoder.norm.*`` is dropped first); a torchvision
    state_dict cannot satisfy it."""
    sd = _read_state_dict(path)
    if any(k.startswith("backbone2d.") for k in sd):
        sd = {k: v for k, v in sd.items() if not k.startswith(DEAD_PREFIX)}
    elif is_torchvision_resnet_sd(sd):
        if strict:
            raise ValueError(
                "a torchvision ImageNet state_dict only covers the "
                "backbone body; it cannot satisfy a strict load")
        sd = {_BODY + k: v for k, v in sd.items()
              if not k.startswith("fc.")}
    else:
        raise ValueError(f"unrecognized checkpoint layout in {path}: keys "
                         f"like {sorted(sd)[:3]}")
    sd = shard_state_dict(model, sd)     # tensor parallelism: the shards
    own = model.state_dict()
    if strict:
        missing = sorted(set(own) - set(sd))
        unexpected = sorted(set(sd) - set(own))
        if missing or unexpected:
            probs = ([f"missing in checkpoint: {k}" for k in missing]
                     + [f"unexpected in checkpoint: {k}" for k in unexpected])
            raise ValueError(
                f"strict checkpoint load of {path} failed ({len(probs)} "
                "problems):\n  " + "\n  ".join(probs[:50]))
    else:
        sd = {k: v for k, v in sd.items() if k in own}
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the "
                             f"model's is {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=strict)

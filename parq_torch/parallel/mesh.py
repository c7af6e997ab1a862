"""The (data, model) grid of ranks (port of parq_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (data, model) `Mesh`: batches
shard over `data`; over `model`, the memory tokens under sequence
parallelism, or the decoder's FFN and self-attention heads under tensor
parallelism. Here one process runs each grid cell: rank r sits at data
index r // model and model index r % model (the JAX mesh's row-major
device order), and each row and column of the grid is a process group:
`model_group` joins the ranks of one data index (they hold the same rows
and split the memory tokens or the weights), `data_group` the ranks of one
model index (they hold different rows; their gradients are averaged).

Tensor parallelism (`param_sharding_rules`, `shard_model_`) lives in
parallel/tensor_parallel.py. As in the JAX package, only the dry run
(parallel/dryrun.py) applies it: the Trainer replicates its state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid's shape, this rank's data index and the groups of its row
    and column (None where the axis has size 1)."""
    data: int = 1
    model: int = 1
    data_index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The grid over the processes of the default group (one process: a
    1 x 1 grid). data=-1 takes every remaining rank. Every rank must call
    it, in the same order as the other ranks' calls: each new group is a
    collective call."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data == -1:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the process group has {world}")
    groups = {}
    if model > 1:     # one group per data index, created by every rank
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if d == rank // model:
                groups[MODEL_AXIS] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group(list(range(m, data * model, model)))
            if m == rank % model:
                groups[DATA_AXIS] = g
    return Mesh(data, model, rank // model, groups.get(DATA_AXIS),
                groups.get(MODEL_AXIS))


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a global batch: the data index's contiguous
    block of B / data rows (ranks of one data index take the same rows).
    Tensors and numpy arrays are sliced on their leading axis, anything
    else is passed through."""
    if mesh.data == 1:
        return dict(batch)
    out = {}
    for k, x in batch.items():
        if not hasattr(x, "shape") or len(x.shape) == 0:
            out[k] = x
            continue
        B = x.shape[0]
        if B % mesh.data:
            raise ValueError(f"{k}: batch {B} not divisible by data="
                             f"{mesh.data}")
        per = B // mesh.data
        out[k] = x[mesh.data_index * per:(mesh.data_index + 1) * per]
    return out


def replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer from rank 0, so all ranks start
    from rank 0's state (a no-op for one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module

"""Tensor parallelism over the model group (port of
parq_tpu/parallel/mesh.py:param_sharding_rules, :59, as
__graft_entry__.py:dryrun_multichip applies it).

The JAX rule shards exactly these kernels of every decoder layer over the
model axis, and nothing else (biases and every other leaf replicated):

    linear1/kernel (D, F)                P(None, model)   column-parallel FFN
    linear2/kernel (F, D)                P(model, None)   row-parallel FFN
    self_attn/{query,key,value}/kernel   P(None, model, None)   heads
        (D, H, hd)
    self_attn/out/kernel (H, hd, D)      P(model, None, None)

Its cross-attention patterns (``cross_attn/query/kernel`` ...) match no
leaf: the decoder names those parameters ``cross_attn_query``,
``cross_attn_key`` ... So the cross-attention is replicated on every rank
of the model group, with all its heads, and so is it here.

In the reference layout a flax kernel (in, out) is a torch weight (out,
in): the plan (`param_sharding_rules`) shards ``linear1.weight`` on dim 0,
``linear2.weight`` on dim 1, the q, k and v blocks of
``self_attn.in_proj_weight`` on dim 0 (rank r holds rows [r·Hl·hd,
(r+1)·Hl·hd) of each block, Hl = H / model heads), and
``self_attn.out_proj.weight`` on dim 1.

Under GSPMD the sharding never changes a result. Here the shards are
executed, Megatron-style (`shard_model_`): each rank holds its shard as a
parameter of the local shape and runs H / model self-attention heads and
F / model FFN columns. Around them, two conjugate operations keep every
replicated activation, and every replicated parameter's gradient, the same
on each rank:
- `sum_grad` (parallel/seq_parallel.py): identity forward, the gradient
  summed over the group; before the column-parallel projections;
- `all_reduce_sum`: the sum over the group forward, identity backward;
  after the row-parallel projections (``self_attn.out_proj``, ``linear2``).

Storage, not result: the port also holds the biases of the column-parallel
layers as shards (``linear1.bias`` and the q, k, v rows of
``self_attn.in_proj_bias``, `COLUMN_BIASES`), since each rank adds only its
columns' bias; the JAX plan replicates them, and XLA slices them where
they are used. Row-parallel biases (``linear2.bias``,
``self_attn.out_proj.bias``) stay whole and are added once, after the
reduction.

Checkpoints are written in the reference layout: `full_state_dict` and
`full_optimizer_state` gather the shards over the model group (a
collective), `shard_state_dict` and `shard_optimizer_state` cut a full one
back to this rank's shards. The step (train/train_step.py) keeps the
sharded gradients out of the model group's mean and adds their squares
over the group for the global-norm clip. gloo has no all_gather of CUDA
tensors, so a gather is an all_reduce of the shard placed in zeros.

The JAX package never combines TP with sequence parallelism (its SP runs
with replicated state), and neither does the port: `shard_model_` refuses
a model whose decoder shards its memory tokens, and the decoder refuses
SP on a sharded model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

import torch
import torch.distributed as dist
import torch.nn as nn

from .seq_parallel import group_rank, group_size

__all__ = ["COLUMN_BIASES", "Shard", "TensorParallel", "WEIGHT_RULES",
           "all_reduce_sum", "full_optimizer_state", "full_state_dict",
           "gathered", "param_sharding_rules", "shard_model_",
           "shard_optimizer_state", "shard_state_dict", "sharded_parameters",
           "storage_plan", "tensor_parallel"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter split over the model group along `dim`: the dim holds
    `blocks` equal blocks (q, k and v: 3), and rank r of m holds the r-th
    of m equal parts of each block, concatenated."""
    dim: int
    blocks: int = 1

    def _parts(self, full_shape, size: int):
        n = full_shape[self.dim]
        if n % (self.blocks * size):
            raise ValueError(f"dim {self.dim} of {tuple(full_shape)} does "
                             f"not split into {self.blocks} x {size} parts")
        return n // (self.blocks * size)

    def local(self, full: torch.Tensor, index: int, size: int
              ) -> torch.Tensor:
        """Rank `index`'s shard of the full tensor (a copy)."""
        part = self._parts(full.shape, size)
        x = full.unflatten(self.dim, (self.blocks, size, part))
        return x.select(self.dim + 1, index).flatten(
            self.dim, self.dim + 1).clone()

    def gather(self, shard: torch.Tensor, index: int, size: int, group
               ) -> torch.Tensor:
        """The full tensor from every rank's shard (a collective)."""
        part = shard.shape[self.dim] // self.blocks
        shape = list(shard.shape)
        shape[self.dim:self.dim + 1] = [self.blocks, size, part]
        full = shard.new_zeros(shape)
        full.select(self.dim + 1, index).copy_(
            shard.unflatten(self.dim, (self.blocks, part)))
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
        return full.flatten(self.dim, self.dim + 2)


# a decoder layer's parameters the JAX rule shards, by their name inside
# the layer (torch layout: weight (out, in))
WEIGHT_RULES = {
    "linear1.weight": Shard(0),                # linear1/kernel P(None, m)
    "linear2.weight": Shard(1),                # linear2/kernel P(m, None)
    "self_attn.in_proj_weight": Shard(0, 3),   # {query,key,value}/kernel
    "self_attn.out_proj.weight": Shard(1),     # out/kernel P(m, None, None)
}
# the column-parallel biases the port stores sharded (storage, not result)
COLUMN_BIASES = {
    "linear1.bias": Shard(0),
    "self_attn.in_proj_bias": Shard(0, 3),
}


@dataclasses.dataclass
class TensorParallel:
    """What `shard_model_` records on the model: the plan of what it
    holds as shards (weights and column biases), the model group, and this
    rank's place in it."""
    plan: Dict[str, Shard]
    group: Optional[object]
    index: int
    size: int

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return self.plan[name].local(full, self.index, self.size)

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        return self.plan[name].gather(shard, self.index, self.size,
                                      self.group)


def _decoder_layers(model: nn.Module):
    from ..models.decoder import DecoderLayer
    return [(p, m) for p, m in model.named_modules()
            if isinstance(m, DecoderLayer)]


def _sequence_parallel(model: nn.Module) -> bool:
    from ..models.decoder import PARQDecoder
    return any(m.sp_group is not None for m in model.modules()
               if isinstance(m, PARQDecoder))


def param_sharding_rules(mesh, model: nn.Module
                         ) -> Dict[str, Optional[Shard]]:
    """The JAX rule's plan in the reference layout: every parameter name
    of `model` → the `Shard` it takes over the model group, or None for
    replicated. It covers every decoder layer (``iterations.{i}.layer``
    too when the iterations do not share weights). With model = 1
    everything is replicated. Biases are replicated, as in the JAX plan;
    `shard_model_` also shards `COLUMN_BIASES`."""
    plan = {n: None for n, _ in model.named_parameters()}
    if mesh.model == 1:
        return plan
    for prefix, _ in _decoder_layers(model):
        for suffix, shard in WEIGHT_RULES.items():
            plan[f"{prefix}.{suffix}"] = shard
    return plan


def storage_plan(mesh, model: nn.Module) -> Dict[str, Shard]:
    """What `shard_model_` holds as shards: the plan's weights and, in
    each decoder layer, the `COLUMN_BIASES`."""
    plan = {n: s for n, s in param_sharding_rules(mesh, model).items()
            if s is not None}
    for prefix, _ in _decoder_layers(model) if mesh.model > 1 else ():
        for suffix, shard in COLUMN_BIASES.items():
            plan[f"{prefix}.{suffix}"] = shard
    return plan


def tensor_parallel(model: nn.Module) -> Optional[TensorParallel]:
    """The record `shard_model_` left on `model`, or None."""
    return getattr(model, "tensor_parallel", None)


def shard_model_(model: nn.Module, mesh) -> nn.Module:
    """Replace each parameter of the plan (and each column bias) with this
    rank's shard, a parameter of the local shape, and run the decoder
    layers on their local heads and FFN columns. Every rank must hold the
    same full weights before (one seed, or `replicated`). Build the
    optimizer after this call. Records a `TensorParallel` on the model
    (model = 1: the record only, nothing is sharded)."""
    if tensor_parallel(model) is not None:
        raise ValueError("the model is sharded already")
    layers = _decoder_layers(model)
    m = mesh.model
    if m > 1:
        if _sequence_parallel(model):
            raise ValueError("tensor parallelism together with "
                             "TPU.SEQ_PARALLEL: the JAX package runs SP "
                             "with replicated state only")
        for _, layer in layers:
            heads, ffn = layer.self_attn.num_heads, layer.ffn_dim
            if heads % m or ffn % m:
                raise ValueError(
                    f"tensor parallelism over {m} ranks needs DEC_HEADS "
                    f"({heads}) and DEC_FFN_DIM ({ffn}) divisible by {m}")
        if mesh.model_group is None:
            raise ValueError(f"a model axis of {m} without a model group: "
                             "make the mesh with parallel.mesh.make_mesh")
    plan = storage_plan(mesh, model)
    tp = TensorParallel(plan, mesh.model_group, group_rank(mesh.model_group),
                        m)
    with torch.no_grad():
        for name in plan:
            mod_name, attr = name.rsplit(".", 1)
            mod = model.get_submodule(mod_name)
            full = getattr(mod, attr)
            setattr(mod, attr, nn.Parameter(tp.local(name, full.detach()),
                                            requires_grad=full.requires_grad))
    if m > 1:
        for _, layer in layers:
            layer.tp_group = mesh.model_group
    model.tensor_parallel = tp
    return model


def sharded_parameters(model: nn.Module) -> Set[int]:
    """The ids of the parameters held as shards."""
    tp = tensor_parallel(model)
    if tp is None:
        return set()
    return {id(p) for n, p in model.named_parameters() if n in tp.plan}


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group in the forward; the cotangent passed
    through unchanged in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group` (the partial outputs of a row-parallel
    projection); its gradient is the output's, unchanged. A no-op for a
    group of one."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def gathered(model: nn.Module, tensors: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """`tensors` named as `model`'s parameters (the parameters, their
    gradients) in the reference layout: each shard gathered over the model
    group (every rank of it must call this)."""
    tp = tensor_parallel(model)
    if tp is None or tp.size == 1:
        return dict(tensors)
    return {k: tp.gather(k, v) if k in tp.plan else v
            for k, v in tensors.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict in the reference layout (a collective)."""
    return gathered(model, model.state_dict())


def shard_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A state_dict in the reference layout cut to this rank's shards."""
    tp = tensor_parallel(model)
    if tp is None or tp.size == 1:
        return sd
    return {k: tp.local(k, v) if k in tp.plan else v for k, v in sd.items()}


def _optimizer_names(model, optimizer):
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_moments(model, optimizer, osd, fn):
    tp = tensor_parallel(model)
    if tp is None or tp.size == 1:
        return osd
    names = _optimizer_names(model, optimizer)
    state = {}
    for i in sorted(osd["state"]):
        s, name = osd["state"][i], names[i]
        if name in tp.plan:
            s = {k: fn(tp, name, v) if torch.is_tensor(v) and v.dim() else v
                 for k, v in s.items()}
        state[i] = s
    return {"state": state, "param_groups": osd["param_groups"]}


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """The optimizer's state_dict with AdamW's moments of the sharded
    parameters gathered over the model group (a collective): the state of
    one process over the full model, whose parameters come in the same
    order."""
    return _map_moments(model, optimizer, optimizer.state_dict(),
                        lambda tp, n, v: tp.gather(n, v))


def shard_optimizer_state(model: nn.Module, optimizer, osd: dict) -> dict:
    """A one-process optimizer state_dict cut to this rank's shards."""
    return _map_moments(model, optimizer, osd,
                        lambda tp, n, v: tp.local(n, v))

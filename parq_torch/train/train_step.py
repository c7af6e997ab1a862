"""Training and eval steps (port of parq_tpu/train/train_step.py).

One step: forward in training mode (dropout from the step's generator,
the decoder's batched-gradient fold) → matching and the masked set loss →
backward → global-norm clip at 1.0 → AdamW. As the JAX package's optax
chain does:
- the clip scales every gradient by min(1, max_norm / ‖g‖), where ‖g‖ is
  the global norm over all parameters (torch's `clip_grad_norm_` adds
  1e-6 to the norm, which would show in the step);
- AdamW has β = (0.9, 0.999), eps 1e-8 and weight decay 0.01 on every
  trainable parameter. torch's AdamW computes the same update as
  optax.adamw: p ← p − lr·(m̂ / (√v̂ + eps) + wd·p). A frozen backbone
  (BACKBONE2D.FREEZE: its parameters do not require a gradient) is kept
  out of the optimizer, so it does not decay either: the JAX package hands
  every parameter to optax (train_step.py:43-47), and its frozen backbone
  still shrinks by lr·wd a step. The port diverges here on purpose.
The matcher (kernel M1), the clip and the metrics stay on the device,
and a step makes no host sync: nothing is read back and nothing is copied
from the host. What keeps it so: the dropout seeds stay a device tensor
and the keep masks are drawn from them on the card (models/decoder.py:
DropoutDraws, kernels/dropout.py); the flash kernels take those seeds as
a device vector (kernels/cross_attention.py:_seed_vector); the rayPE
bounds are buffers (models/ray_pe.py), the box corner signs and the loss's
symmetry tables are uploaded once per device (geometry/obb.py,
losses/set_loss.py) and the class weight is built on the device; a
captured step's AdamW is `capturable` with its lr a device tensor
(`make_optimizer(..., capturable=True)`, `set_lr`). chip_smoke.py's
`[graphs]` phase counts the syncs of one step
(sync debug mode "warn", tools/syncs.py): 0, where there were 16.

`make_graphed_train_step` and `make_graphed_eval_step` are the twins of
the JAX package's `make_jitted_train_step` / `make_jitted_eval_step`
(train_step.py:132-138): the step captured once per batch signature as a
CUDA graph and replayed after that (parq_torch/graphs.py). Parameters,
gradients and AdamW's state are updated in place by the replays, the
port's form of DONATE_TRAIN_STATE. Several ranks run eagerly: gloo's
collectives cannot be captured (`capture=False`, the Trainer's rule).

Data parallelism (`data_group`: the ranks holding the other rows of the
global batch): each rank's loss is weighted by its share of the matched
(iteration, sample) pairs, and the gradients are averaged over the group
BEFORE the global-norm clip, so the clip and the update see the gradient of
the global batch's loss, as the JAX package's step over the whole batch
does; the metrics are the global batch's too. The ranks of a model group
(`model_group`: the same rows, the memory tokens split under sequence
parallelism, or the same work repeated) each hold the full gradient
already; it is averaged over the group as well, so that the card's
nondeterministic kernels (cuDNN's weight gradients, atomics) cannot let
their copies of the parameters drift apart. Under tensor parallelism
(parallel/tensor_parallel.py) the ranks of a model group hold different
shards of some parameters: those gradients stay out of the model group's
mean (it would mix different shards) and are still averaged over the data
group, the clip adds their squares over the model group, and AdamW steps
each shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

import torch.distributed as dist

from ..geometry import Obb3D, Pose
from ..graphs import Graphed
from ..losses import parse_targets, set_loss
from ..parallel.seq_parallel import group_size
from ..parallel.tensor_parallel import sharded_parameters, tensor_parallel


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_weight: Tuple[float, float, float, float] = (5.0, 5.0, 5.0, 1.0)
    num_semcls: int = 9

    @classmethod
    def from_cfg(cls, cfg) -> "LossConfig":
        """From a config tree (parq_tpu/train/train_step.py:83-86)."""
        return cls(loss_weight=tuple(float(w) for w in
                                     cfg.MODEL.DECODER.LOSS_WEIGHT),
                   num_semcls=int(cfg.MODEL.DECODER.NUM_SEMCLS))


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4,
                   weight_decay: float = 0.01,
                   capturable: bool = False) -> torch.optim.AdamW:
    """AdamW with torch's defaults β = (0.9, 0.999), eps = 1e-8, which the
    reference relies on, and weight decay on every trainable parameter (a
    frozen one is left out, so it neither moves nor decays); the lr a
    float. `capturable`, for a step that is captured as a CUDA graph
    (`make_graphed_train_step`): on the card AdamW is then `capturable`
    (its step counts on the device) with the lr a device tensor that
    `set_lr` fills in place, so a replay reads both. An eager step keeps
    the plain AdamW, which launches fewer kernels; the CPU always does."""
    params = [p for p in model.parameters() if p.requires_grad]
    if capturable and params and params[0].device.type == "cuda":
        return torch.optim.AdamW(
            params, lr=torch.tensor(float(lr), device=params[0].device),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
            capturable=True)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The lr of every param group: written in place into a device tensor
    (what a captured step reads), else set as a float. A capturable
    optimizer whose lr a checkpoint restored as a float gets a device
    tensor again (capture after that, not before)."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        elif group.get("capturable"):
            group["lr"] = torch.tensor(float(lr),
                                       device=group["params"][0].device)
        else:
            group["lr"] = lr


def _data_weight(losses: Dict[str, torch.Tensor], data_group) -> torch.Tensor:
    """The factor that turns this rank's loss into its part of the global
    batch's loss times the group's size: the loss is a sum over matched
    pairs divided by max(valid_bs, 1), so rank r's share of the global
    loss is loss_r · max(valid_r, 1) / max(Σ valid, 1)."""
    valid = losses["valid_bs"].detach().reshape(1).float()
    total = valid.clone()
    dist.all_reduce(total, group=data_group)
    return (valid.clamp(min=1.0) / total.clamp(min=1.0)
            * group_size(data_group))[0]


def all_reduce_mean_(tensors, group) -> None:
    """Average `tensors` over `group` in place, in one flat buffer per
    dtype."""
    size = group_size(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


def _norms(grads) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])


def clip_by_global_norm_(params, max_norm: float = 1.0, sharded=(),
                         model_group=None) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ‖g‖) and return
    ‖g‖ before the clip (optax.clip_by_global_norm; no epsilon).
    `sharded`: the ids of parameters held as tensor-parallel shards over
    `model_group` (the model's own, `TensorParallel.group`); their squares are summed over the group and the
    replicated gradients counted once, so ‖g‖ is one process's, the same
    on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not sharded:
        norm = torch.linalg.vector_norm(_norms(grads))
    else:
        own = [p.grad for p in params
               if p.grad is not None and id(p) in sharded]
        rep = [p.grad for p in params
               if p.grad is not None and id(p) not in sharded]
        sq = _norms(own).square().sum()
        dist.all_reduce(sq, group=model_group)
        norm = torch.sqrt(sq + _norms(rep).square().sum())
    scale = torch.clamp(max_norm / norm, max=1.0)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


def _global_uniforms(outputs, targets, generator, dec) -> torch.Tensor:
    """The matcher's (L·B, Q, K) proximity draws of a data-parallel rank:
    drawn for the global batch, as one process over it would draw them
    (L outer, the global batch inner), and the rank's rows kept."""
    L, B, Q = outputs["pred_logits"].shape[:3]
    K = targets.labels.shape[1]
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand((L, dec.data * B, Q, K), generator=generator, device=gdev)
    b0 = dec.data_index * B
    return u[:, b0:b0 + B].reshape(L * B, Q, K)


def forward_and_loss(model, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator],
                     loss_cfg: LossConfig = LossConfig(),
                     deterministic: bool = False,
                     uniforms: Optional[torch.Tensor] = None):
    """(losses, outputs). The step's generator draws the dropout first,
    then the matcher's proximity uniforms (unless `uniforms` is given)."""
    outputs = model(batch, deterministic=deterministic, generator=generator)
    if "obbs_padded" not in batch:
        # no ground truth: zero loss (ref: parq_lightning.py:91-94)
        return {"total_loss": torch.zeros(())}, outputs
    targets = parse_targets(Obb3D(batch["obbs_padded"]),
                            Pose(batch["T_world_local"]), batch.get("sym"))
    dec = getattr(model, "box3d_decoder", None)
    if uniforms is None and not deterministic and dec is not None \
            and dec.data > 1:
        uniforms = _global_uniforms(outputs, targets, generator, dec)
    losses = set_loss(outputs, targets, uniforms=uniforms,
                      generator=generator,
                      loss_weight=loss_cfg.loss_weight,
                      num_semcls=loss_cfg.num_semcls)
    return losses, outputs


def train_step(model, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               loss_cfg: LossConfig = LossConfig(), max_norm: float = 1.0,
               uniforms: Optional[torch.Tensor] = None,
               accumulate: int = 1, micro_step: int = 0,
               data_group=None, model_group=None) -> Dict[str, torch.Tensor]:
    """One optimisation step in place; returns the metrics (device
    tensors): total_loss, its components, valid_bs and grad_norm (before
    the clip). `data_group`: the data-parallel ranks (None: one process);
    `batch` holds this rank's rows. `model_group`: the ranks that hold the
    same rows.

    With `accumulate` = k > 1 this is one micro-batch of optax.MultiSteps:
    call it with micro_step 0 .. k−1; each adds its gradient / k, and the
    last clips the mean gradient and applies the one update (grad_norm is
    the mean gradient's, reported by the last call only). A trainable
    parameter the loss does not reach gets a zero gradient, so AdamW decays
    it as optax does. The gradients are zeroed in place, so a captured
    step's gradients keep their buffers."""
    if micro_step == 0:
        optimizer.zero_grad(set_to_none=False)
    losses, _ = forward_and_loss(model, batch, generator, loss_cfg,
                                 deterministic=False, uniforms=uniforms)
    if group_size(data_group) > 1 and "valid_bs" in losses:
        weight = _data_weight(losses, data_group)
        losses = {k: v if k == "valid_bs" else v * weight
                  for k, v in losses.items()}
    loss = losses["total_loss"]
    (loss if accumulate == 1 else loss / accumulate).backward()
    metrics = {k: v.detach() for k, v in losses.items()}
    if group_size(data_group) > 1:
        names = sorted(metrics)
        flat = torch.stack([metrics[k].float().reshape(()) for k in names])
        all_reduce_mean_([flat], data_group)
        metrics = dict(zip(names, flat.unbind()))
        if "valid_bs" in metrics:
            metrics["valid_bs"] = metrics["valid_bs"] * group_size(data_group)
    if micro_step < accumulate - 1:
        return metrics
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sharded = sharded_parameters(model)
    if group_size(model_group) > 1:
        all_reduce_mean_([p.grad for p in params if id(p) not in sharded],
                         model_group)
    if group_size(data_group) > 1:
        all_reduce_mean_([p.grad for p in params], data_group)
    tp = tensor_parallel(model)
    metrics["grad_norm"] = clip_by_global_norm_(
        params, max_norm, sharded, None if tp is None else tp.group)
    optimizer.step()
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              loss_cfg: LossConfig = LossConfig(),
              uniforms: Optional[torch.Tensor] = None):
    """Forward (deterministic) and loss without gradient: (losses,
    outputs)."""
    return forward_and_loss(model, batch, generator, loss_cfg,
                            deterministic=True, uniforms=uniforms)


class GraphedTrainStep(Graphed):
    """`train_step` of one model and optimizer captured once per batch
    signature (and accumulation micro-step) and replayed after that; the
    generator is registered with each graph, so a replay draws what an
    eager step from the same generator state draws. The gradients are
    allocated before the first capture and zeroed in place, so every graph
    and eager step shares them. On the card a captured step needs a
    capturable optimizer (`make_optimizer(..., capturable=True)`).
    `capture=False` runs `train_step` eagerly (several ranks: the
    collectives cannot be captured)."""

    def __init__(self, model, optimizer, loss_cfg: LossConfig = LossConfig(),
                 max_norm: float = 1.0, data_group=None, model_group=None,
                 capture: bool = True):
        def step(batch, generator, accumulate, micro_step):
            return train_step(model, optimizer, batch, generator, loss_cfg,
                              max_norm, accumulate=accumulate,
                              micro_step=micro_step, data_group=data_group,
                              model_group=model_group)
        super().__init__(step, capture)   # no reference back to self
        self.optimizer = optimizer
        if capture and any(p.is_cuda and not group.get("capturable")
                           for group in optimizer.param_groups
                           for p in group["params"]):
            raise ValueError("a captured train step needs the optimizer "
                             "of make_optimizer(..., capturable=True)")

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator], accumulate: int = 1,
                 micro_step: int = 0) -> Dict[str, torch.Tensor]:
        if self.capture:
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
        return super().__call__(batch, generator, accumulate, micro_step)


def make_graphed_train_step(model, optimizer,
                            loss_cfg: LossConfig = LossConfig(),
                            max_norm: float = 1.0, data_group=None,
                            model_group=None,
                            capture: bool = True) -> GraphedTrainStep:
    """The twin of `make_jitted_train_step`: `step(batch, generator,
    accumulate=1, micro_step=0)` → metrics, one CUDA graph per batch
    signature on the card, `train_step` itself on the CPU."""
    return GraphedTrainStep(model, optimizer, loss_cfg, max_norm, data_group,
                            model_group, capture)


def make_graphed_eval_step(model, loss_cfg: LossConfig = LossConfig(),
                           capture: bool = True) -> Graphed:
    """The twin of `make_jitted_eval_step`: `step(batch, generator)` →
    (losses, outputs), one CUDA graph per batch signature on the card,
    `eval_step` itself on the CPU."""
    return Graphed(lambda batch, generator: eval_step(model, batch,
                                                      generator, loss_cfg),
                   capture)

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
The matcher (kernel M1), the clip and the metrics stay on the device.
What still synchronizes the host with the card in a step
(chip_smoke.py's [train] phase counts them with sync debug mode "warn"):
one read back, the dropout seeds the step's generator draws on the card
(models/decoder.py:115-116, `.tolist()`); and blocking copies of small
host values to the card, each of which waits for the stream: the rayPE
bounds (models/ray_pe.py:49-50), each attention call's seed vector
(kernels/cross_attention.py:160), the box corner signs
(geometry/obb.py:74), the loss's symmetry angles and mask and its class
weight (losses/set_loss.py:73, :78, :135).

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
their copies of the parameters drift apart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

import torch.distributed as dist

from ..geometry import Obb3D, Pose
from ..losses import parse_targets, set_loss
from ..parallel.seq_parallel import group_size


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
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW with torch's defaults β = (0.9, 0.999), eps = 1e-8, which the
    reference relies on, and weight decay on every trainable parameter (a
    frozen one is left out, so it neither moves nor decays)."""
    return torch.optim.AdamW([p for p in model.parameters()
                              if p.requires_grad], lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


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


def clip_by_global_norm_(params, max_norm: float = 1.0) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ‖g‖) and return
    ‖g‖ before the clip (optax.clip_by_global_norm; no epsilon)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
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
    it as optax does."""
    if micro_step == 0:
        optimizer.zero_grad(set_to_none=True)
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
    for group in (model_group, data_group):
        if group_size(group) > 1:
            all_reduce_mean_([p.grad for p in params], group)
    metrics["grad_norm"] = clip_by_global_norm_(params, max_norm)
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

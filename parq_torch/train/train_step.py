"""Training and eval steps (port of parq_tpu/train/train_step.py).

One step: forward in training mode (dropout from the step's generator,
the decoder's batched-gradient fold) → matching and the masked set loss →
backward → global-norm clip at 1.0 → AdamW. As the JAX package's optax
chain does:
- the clip scales every gradient by min(1, max_norm / ‖g‖), where ‖g‖ is
  the global norm over all parameters (torch's `clip_grad_norm_` adds
  1e-6 to the norm, which would show in the step);
- AdamW has β = (0.9, 0.999), eps 1e-8 and weight decay 0.01 on every
  parameter. torch's AdamW computes the same update as optax.adamw:
  p ← p − lr·(m̂ / (√v̂ + eps) + wd·p).
The clip and the metrics stay on the device: the only host sync of a step
is the matcher's transfer of its costs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..geometry import Obb3D, Pose
from ..losses import parse_targets, set_loss


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
    reference relies on, and weight decay on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def clip_by_global_norm_(params, max_norm: float = 1.0) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ‖g‖) and return
    ‖g‖ before the clip (optax.clip_by_global_norm; no epsilon)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.clamp(max_norm / norm, max=1.0)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


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
               accumulate: int = 1, micro_step: int = 0
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step in place; returns the metrics (device
    tensors): total_loss, its components, valid_bs and grad_norm (before
    the clip).

    With `accumulate` = k > 1 this is one micro-batch of optax.MultiSteps:
    call it with micro_step 0 .. k−1; each adds its gradient / k, and the
    last clips the mean gradient and applies the one update (grad_norm is
    the mean gradient's, reported by the last call only). A parameter the
    loss does not reach (a frozen backbone) gets a zero gradient, so AdamW
    decays it as optax does."""
    if micro_step == 0:
        optimizer.zero_grad(set_to_none=True)
    losses, _ = forward_and_loss(model, batch, generator, loss_cfg,
                                 deterministic=False, uniforms=uniforms)
    loss = losses["total_loss"]
    (loss if accumulate == 1 else loss / accumulate).backward()
    metrics = {k: v.detach() for k, v in losses.items()}
    if micro_step < accumulate - 1:
        return metrics
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
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

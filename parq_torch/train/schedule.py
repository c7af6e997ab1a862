"""LR schedule: cosine annealing with warmup and restarts (port of
parq_tpu/train/schedule.py).

`cosine_warmup_restarts` is the katsura-jp scheduler the reference steps
once per epoch, as a pure ``epoch → lr`` function. `build_lr_schedule`
repeats the reference's derivation of its arguments (effective-batch LR
autoscale, min-lr convention, cycle split) from explicit arguments instead
of a config tree.
"""
from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_restarts(first_cycle_steps: int, max_lr: float,
                           min_lr: float, warmup_steps: int = 0,
                           cycle_mult: float = 1.0, gamma: float = 1.0
                           ) -> Callable[[float], float]:
    """lr(epoch), as CosineAnnealingWarmupRestarts.get_lr with
    base_lrs = min_lr."""
    if warmup_steps >= first_cycle_steps:
        raise ValueError("warmup_steps must be < first_cycle_steps")

    def lr_fn(epoch: float) -> float:
        epoch = float(epoch)
        if cycle_mult == 1.0:
            cycle = math.floor(epoch / first_cycle_steps)
            step_in_cycle = epoch - cycle * first_cycle_steps
            cur_cycle_steps = float(first_cycle_steps)
        else:
            n = math.floor(math.log(epoch / first_cycle_steps
                                    * (cycle_mult - 1.0) + 1.0)
                           / math.log(cycle_mult))
            n = max(n, 0)
            start = (first_cycle_steps * (cycle_mult ** n - 1.0)
                     / (cycle_mult - 1.0))
            cycle = n
            step_in_cycle = epoch - start
            cur_cycle_steps = first_cycle_steps * cycle_mult ** n
        cycle_max = max_lr * gamma ** cycle
        if step_in_cycle < warmup_steps:
            return min_lr + (cycle_max - min_lr) * step_in_cycle \
                / max(warmup_steps, 1)
        return min_lr + (cycle_max - min_lr) * (
            1.0 + math.cos(math.pi * (step_in_cycle - warmup_steps)
                           / (cur_cycle_steps - warmup_steps))) / 2.0

    return lr_fn


def build_lr_schedule(*, base_lr: float, batch_size: int, max_epochs: int,
                      steps_per_epoch: int, warmup_epochs: int = 0,
                      cycle_mult: float = 1.0, num_restarts: int = 1,
                      autoscale_lr: bool = True, num_nodes: int = 1,
                      gpus: int = 1, accumulate: int = 1
                      ) -> Callable[[int], float]:
    """lr(step): the effective batch scales the peak lr by ebs/256 when
    `autoscale_lr`, the floor is base_lr/256 (base_lr beyond an effective
    batch of 256), and the first cycle spans max_epochs over the restarts'
    geometric fractions. The schedule steps once per epoch."""
    ebs = batch_size * num_nodes * gpus * accumulate
    lr = base_lr * ebs / 256.0 if autoscale_lr else base_lr
    lr_min = base_lr / 256.0 if ebs <= 256 else base_lr
    fractions = [cycle_mult ** i for i in range(num_restarts)]
    epochs_cycle_0 = math.ceil(max_epochs / sum(fractions))
    epoch_fn = cosine_warmup_restarts(epochs_cycle_0, lr, lr_min,
                                      warmup_epochs, cycle_mult)

    def step_fn(step: int) -> float:
        return epoch_fn(step // max(steps_per_epoch, 1))

    step_fn.peak_lr = lr
    return step_fn


def lr_schedule_from_cfg(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """`build_lr_schedule` on a config tree's keys
    (parq_tpu/train/schedule.py:build_lr_schedule)."""
    t, o = cfg.TRAINER, cfg.OPTIMIZER
    return build_lr_schedule(
        base_lr=float(o.LEARNING_RATE),
        batch_size=int(cfg.DATAMODULE.BATCH_SIZE),
        max_epochs=int(t.MAX_EPOCHS), steps_per_epoch=steps_per_epoch,
        warmup_epochs=int(o.WARMUP_EPOCHS), cycle_mult=float(o.CYCLE_MULT),
        num_restarts=int(o.NUM_RESTARTS),
        autoscale_lr=bool(o.AUTOSCALE_LR), num_nodes=int(t.NUM_NODES),
        gpus=int(t.GPUS), accumulate=int(t.ACCUMULATE_GRAD_BATCHES))

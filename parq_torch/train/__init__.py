"""Training: the step (AdamW, global-norm clip, set loss, gradient
accumulation; `make_graphed_train_step` / `make_graphed_eval_step`, the
steps captured as CUDA graphs) and the LR schedule; `loop.Trainer` (fit, validate, resume)
and `checkpoint` (torch.save, top-k + last, warm starts) behind the
train.py/eval.py twins in parq_torch/cli. ``python -m parq_torch.train``
runs steps on synthetic batches."""
from .schedule import build_lr_schedule, cosine_warmup_restarts
from .train_step import (LossConfig, clip_by_global_norm_, eval_step,
                         forward_and_loss, make_graphed_eval_step,
                         make_graphed_train_step, make_optimizer, set_lr,
                         train_step)

__all__ = ["LossConfig", "build_lr_schedule", "clip_by_global_norm_",
           "cosine_warmup_restarts", "eval_step", "forward_and_loss",
           "make_graphed_eval_step", "make_graphed_train_step",
           "make_optimizer", "set_lr", "train_step"]

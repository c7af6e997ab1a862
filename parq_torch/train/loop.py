"""Training and evaluation orchestration (port of parq_tpu/train/loop.py):
epochs over a snippet loader, validation every fraction of an epoch with
F1 model selection, top-k checkpoints and resume, the per-step LR
schedule, gradient accumulation, and the per-snippet latency protocol of
eval.py.

Scalars go to ``<workdir>/metrics.jsonl``, one JSON object a line with its
stage and step. Image logging (LOG_IMAGES) needs the vis utilities, which
are not ported yet: it is logged and skipped.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import ModelConfig, check_card_support, platform_device
from ..evals import (F1Calculator, finish_parse_pred, parse_pred_device,
                     targets_to_gt_list)
from ..geometry import Obb3D, Pose
from ..losses import parse_targets
from ..models import BATCH_KEYS, build_model
from .checkpoint import CheckpointManager, load_pretrained, restore_state
from .schedule import lr_schedule_from_cfg
from .train_step import LossConfig, eval_step, make_optimizer, train_step

logger = logging.getLogger(__name__)

DEVICE_KEYS = BATCH_KEYS + ("obbs_padded", "sym")


def to_device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The model's and the loss's arrays of a host batch on `device`
    (float64 as float32, sym as int32); on CUDA through pinned memory with
    non-blocking copies, so the copy overlaps the work already queued."""
    device = torch.device(device)
    out = {}
    for k in DEVICE_KEYS:
        if k not in batch:
            continue
        a = np.asarray(batch[k])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def device_prefetch(iterable, device, depth: int = 1, state_fn=None):
    """Yield (host_batch, device_batch, state) with the copy of batch i+1
    issued before step i is consumed. `state` is `state_fn()` at the fetch
    of that same batch: the loader runs `depth` batches ahead, and a
    snapshot taken at yield time would skip prefetched batches on resume."""
    buf = deque()
    for host in iterable:
        snap = state_fn() if state_fn is not None else None
        buf.append((host, to_device_batch(host, device), snap))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def val_batch_limit(limit_batches, n_batches: int) -> int:
    """Lightning's LIMIT_VAL_BATCHES: a float ≤ 1 is a fraction of the set
    (> 0 runs at least one batch), anything else a count, 0 runs none."""
    if isinstance(limit_batches, float) and limit_batches <= 1.0:
        return (max(1, int(n_batches * limit_batches))
                if limit_batches > 0 else 0)
    return int(limit_batches)


class Trainer:
    """The model, its AdamW and checkpoints for one config tree, on the
    device TPU.PLATFORM / PARQ_PLATFORM names (CUDA unless "cpu")."""

    def __init__(self, cfg, workdir: Optional[str] = None):
        check_card_support(cfg)
        if cfg.DEMO or cfg.MODEL.DECODER.FOR_VIS:
            raise ValueError("DEMO / MODEL.DECODER.FOR_VIS need the vis "
                             "utilities, not ported yet (ROADMAP §A9)")
        self.cfg = cfg
        self.device = resolve_device(platform_device(cfg))
        self.workdir = workdir or os.path.join(cfg.LOG_PATH, cfg.NAME)
        os.makedirs(self.workdir, exist_ok=True)
        self.model_cfg = ModelConfig.from_cfg(cfg)
        self.loss_cfg = LossConfig.from_cfg(cfg)
        self.accumulate = int(cfg.TRAINER.ACCUMULATE_GRAD_BATCHES)
        if self.accumulate < 1:
            raise ValueError("TRAINER.ACCUMULATE_GRAD_BATCHES must be >= 1")
        self.ckpt_mgr = CheckpointManager(
            os.path.join(self.workdir, "checkpoints"),
            save_top_k=cfg.CALLBACK.SAVE_TOP_K,
            save_last=cfg.CALLBACK.SAVE_LAST,
            monitor=str(cfg.CALLBACK.MONITOR).split("/")[-1],
            mode=cfg.CALLBACK.MODE)
        self.metrics_path = os.path.join(self.workdir, "metrics.jsonl")
        if cfg.LOG_IMAGES:
            logger.info("LOG_IMAGES: image logging is not ported yet "
                        "(utils/vis.py); no images are written")
        self.model = None
        self.optimizer = None
        self.lr_schedule: Optional[Callable[[int], float]] = None
        self.global_step = 0
        # 'simple' profiler: wall time per phase (TRAINER.PROFILER)
        self._prof = defaultdict(float)
        self._prof_n = defaultdict(int)

    # -- logging ---------------------------------------------------------
    def log_scalars(self, metrics: Dict, step: int, stage: str):
        row = {"stage": stage, "step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                pass
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def _tick(self, phase: str, t0: float) -> float:
        now = time.perf_counter()
        self._prof[phase] += now - t0
        self._prof_n[phase] += 1
        return now

    def profile_summary(self) -> str:
        lines = ["phase            total_s    calls    mean_ms"]
        for k in sorted(self._prof):
            n = max(self._prof_n[k], 1)
            lines.append(f"{k:<16} {self._prof[k]:>8.2f} {n:>8d} "
                         f"{self._prof[k] / n * 1e3:>9.2f}")
        return "\n".join(lines)

    # -- setup -----------------------------------------------------------
    def setup_state(self, steps_per_epoch: int):
        """The model (random weights from SEED, then PRETRAINED_PATH as a
        warm start), AdamW and the LR schedule."""
        cfg = self.cfg
        self.lr_schedule = lr_schedule_from_cfg(cfg, steps_per_epoch)
        self.model = build_model(self.model_cfg, seed=int(cfg.SEED),
                                 device=self.device)
        self.optimizer = make_optimizer(self.model, lr=self.lr_schedule(0))
        if cfg.PRETRAINED_PATH:
            logger.info("warm start from %s", cfg.PRETRAINED_PATH)
            load_pretrained(self.model, cfg.PRETRAINED_PATH, strict=False)

    def restore_if_available(self, data_loader=None) -> bool:
        """Full resume from the latest checkpoint: weights, AdamW, step
        and the loader's position."""
        if self.ckpt_mgr.latest_step() is None:
            return False
        extras = restore_state(self.ckpt_mgr, self.model, self.optimizer)
        self.global_step = int(extras["step"])
        if data_loader is not None and "data_state" in extras:
            data_loader.load_state_dict(extras["data_state"])
        logger.info("resumed at step %d", self.global_step)
        return True

    def restore_best(self) -> bool:
        """Reload the checkpoint with the best monitored metric (the final
        validation runs on it, as the reference's train.py does)."""
        best = self.ckpt_mgr.best_step()
        if best is None:
            return False
        restore_state(self.ckpt_mgr, self.model, self.optimizer, step=best)
        logger.info("restored best checkpoint (step %d) for final eval", best)
        return True

    # -- loops -----------------------------------------------------------
    def fit(self, train_loader, val_loader=None):
        cfg = self.cfg
        steps_per_epoch = len(train_loader)
        if self.model is None:
            self.setup_state(steps_per_epoch)
            self.restore_if_available(train_loader)
        val_every = max(1, int(steps_per_epoch
                               * float(cfg.TRAINER.VAL_CHECK_INTERVAL)))
        limit_val = cfg.TRAINER.LIMIT_VAL_BATCHES
        # the dropout stream, seeded as the JAX package's (loop.py:311);
        # like it, a resume does not restore the stream's position
        gen = torch.Generator(device=self.device).manual_seed(
            int(cfg.SEED) + 17)
        overfit = cfg.TRAINER.OVERFIT_BATCHES
        overfit_n = (int(overfit) if overfit >= 1
                     else int(len(train_loader) * overfit)) if overfit else 0
        limit_train = cfg.TRAINER.LIMIT_TRAIN_BATCHES
        limit_n = (int(limit_train) if limit_train > 1
                   else int(len(train_loader) * limit_train))
        prof_steps = int(cfg.TPU.PROFILE_STEPS)
        profiler = None
        k = self.accumulate
        overfit_cache = []
        while train_loader.epoch < cfg.TRAINER.MAX_EPOCHS:
            t0 = time.perf_counter()
            if overfit_n and len(overfit_cache) >= overfit_n:
                epoch_iter = list(overfit_cache)
                train_loader.epoch += 1
            else:
                epoch_iter = train_loader
            n_done = 0
            # CHECK_VAL_EVERY_N_EPOCH: Lightning's (epoch + 1) % N == 0
            val_this_epoch = (train_loader.epoch + 1) % max(
                int(cfg.TRAINER.CHECK_VAL_EVERY_N_EPOCH), 1) == 0
            state_fn = (train_loader.state_dict
                        if epoch_iter is train_loader else None)
            for batch, dev_batch, data_state in device_prefetch(
                    epoch_iter, self.device, state_fn=state_fn):
                if overfit_n and len(overfit_cache) < overfit_n:
                    overfit_cache.append(batch)
                n_done += 1
                if n_done > limit_n > 0:
                    break
                t0 = self._tick("data", t0)
                # optax's schedule counts updates: with accumulation, one
                # per k micro-batches
                lr = self.lr_schedule(self.global_step // k)
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.model.train()
                metrics = train_step(
                    self.model, self.optimizer, dev_batch, gen,
                    self.loss_cfg, float(cfg.TRAINER.GRADIENT_CLIP_VAL),
                    accumulate=k, micro_step=self.global_step % k)
                t0 = self._tick("train_step", t0)
                self.global_step += 1
                if prof_steps and self.global_step == 2:
                    profiler = self._start_profiler()
                if profiler is not None and \
                        self.global_step >= 2 + prof_steps:
                    self._stop_profiler(profiler)
                    profiler = None
                if self.global_step % cfg.TRAINER.LOG_EVERY_N_STEPS == 0:
                    host = {name: float(v) for name, v in metrics.items()}
                    host["lr"] = lr
                    self.log_scalars(host, self.global_step, "train")
                    logger.info("step %d loss %.4f", self.global_step,
                                host["total_loss"])
                    t0 = self._tick("log", t0)
                if val_loader is not None and val_this_epoch and \
                        self.global_step % val_every == 0:
                    val_metrics = self.validate(val_loader,
                                                limit_batches=limit_val)
                    self.log_scalars(val_metrics, self.global_step,
                                     "val/metrics")
                    t0 = self._tick("validate", t0)
                    self.ckpt_mgr.save(
                        self.global_step, self.model, self.optimizer,
                        metrics=val_metrics,
                        data_state=(data_state if data_state is not None
                                    else train_loader.state_dict()))
                    t0 = self._tick("checkpoint", t0)
            if val_loader is None:
                self.ckpt_mgr.save(self.global_step, self.model,
                                   self.optimizer,
                                   data_state=train_loader.state_dict())
        if profiler is not None:
            self._stop_profiler(profiler)
        if cfg.TRAINER.PROFILER:
            logger.info("profiler summary:\n%s", self.profile_summary())

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.workdir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("wrote a torch.profiler trace to %s", out)

    @torch.no_grad()
    def validate(self, loader, limit_batches=1.0, verbose: bool = False,
                 timing: bool = False) -> Dict[str, float]:
        """F1 at IoU 0.25/0.5/0.7 and the mean loss over the first
        `limit_batches` batches of `loader`, always from the start of the
        set. One batch of device work is queued before the previous batch's
        host half (numpy copy, NMS, F1 association) runs; `timing` keeps
        every batch strictly serial and prints its latency (eval.py's
        protocol)."""
        cfg = self.cfg
        dec = cfg.MODEL.DECODER
        calc = F1Calculator(dec.CONF_THRESH, num_semcls=dec.NUM_SEMCLS)
        limit = val_batch_limit(limit_batches, len(loader))
        gen = torch.Generator(device=self.device).manual_seed(0)
        times = []
        total_loss, count = 0.0, 0
        # restart the loader: an early break leaves it mid-epoch, and every
        # validation must score the same subset
        if hasattr(loader, "position"):
            loader.position = 0
        if timing:
            stream = ((b, to_device_batch(b, self.device)) for b in loader)
        else:
            stream = ((h, d) for h, d, _ in
                      device_prefetch(loader, self.device))
        was_training = self.model.training
        self.model.eval()

        def host_finish(item):
            batch, _, dev_parsed, _ = item
            host = finish_parse_pred(dev_parsed, dec.NUM_SEMCLS,
                                     enable_nms=bool(dec.ENABLE_NMS))
            host["scene_name"] = batch["scene_name"]
            return host

        def consume(item, host):
            nonlocal total_loss, count
            _, losses, _, targets = item
            if targets is not None:
                calc.step(host, targets_to_gt_list(targets))
                total_loss += float(losses["total_loss"])
                count += 1

        # the 'simple' profiler's split of a validation: waiting for the
        # loader (val_data), the step and device parse with the matcher's
        # sync (val_step), the host half and F1 association (val_host)
        tick = time.perf_counter()
        pending = None
        for i, (batch, dev_batch) in enumerate(stream):
            if i >= limit:
                break
            tick = self._tick("val_data", tick)
            t0 = time.perf_counter()
            losses, outputs = eval_step(self.model, dev_batch, gen,
                                        self.loss_cfg)
            last = {k: v[-1] for k, v in outputs.items()}
            dev_parsed = parse_pred_device(last, dev_batch["T_world_local"],
                                           tuple(dec.TRACK_SCALE))
            targets = None
            if "obbs_padded" in dev_batch:
                targets = parse_targets(Obb3D(dev_batch["obbs_padded"]),
                                        Pose(dev_batch["T_world_local"]),
                                        dev_batch.get("sym"))
            item = (batch, losses, dev_parsed, targets)
            tick = self._tick("val_step", tick)
            if timing:
                host = host_finish(item)
                dt = time.perf_counter() - t0
                times.append(dt)
                print(f"{batch['scene_name'][0]}: inference time {dt:.4f}s "
                      f"(running mean {np.mean(times[1:] or times):.4f}s)",
                      flush=True)
                consume(item, host)
            else:
                if pending is not None:
                    consume(pending, host_finish(pending))
                pending = item
            tick = self._tick("val_host", tick)
        if pending is not None:
            consume(pending, host_finish(pending))
        self.model.train(was_training)
        metrics = (calc.compute_metrics(verbose=verbose)
                   if calc.preds or calc.gts else {})
        self._tick("val_host", tick)
        if count:
            metrics["total_loss"] = total_loss / count
        if timing and times:
            # the first batch includes the warm-up; drop it when there are more
            metrics["mean_latency_s"] = float(np.mean(times[1:] or times))
        return metrics

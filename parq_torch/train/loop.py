"""Training and evaluation orchestration (port of parq_tpu/train/loop.py):
epochs over a snippet loader, validation every fraction of an epoch with
F1 model selection, top-k checkpoints and resume, the per-step LR
schedule, gradient accumulation, and the per-snippet latency protocol of
eval.py.

Scalars go to ``<workdir>/metrics.jsonl``, one JSON object a line with its
stage and step. Images (LOG_IMAGES; the port has no TensorBoard) go as PNGs
to ``<workdir>/images/<stage>_<tag>_<step>.png`` beside it: every
LOG_IMAGES_FREQUENCY train steps and on the first validation batch, the
prediction and GT wireframe overlays and, for train steps, the PCA of the
backbone's feature map (`log_images`). `validate(for_vis=True, vis_dir=d)`
writes each batch's ``{scene}_{snippet}_rgb_imgwithbox.png`` into d, the
FOR_VIS/DEMO output of eval.py. The vis utilities (utils/vis.py) need
neither cv2 nor PIL, and a failure in them raises (the JAX Trainer logs
and swallows it, loop.py:191-192).
TPU.DEBUG_NANS stops at the first NaN with FloatingPointError, as the JAX
package's jax_debug_nans does (train/debug_nans.py).

Several ranks (torch.distributed, under torchrun): the Trainer lays them out
as a (data, model) grid (parallel/mesh.py), as the JAX Trainer builds its
mesh (loop.py:92-106): TPU.MESH_MODEL ranks to a model group, the data
axis TPU.MESH_DATA (-1: the rest) clamped to a divisor of BATCH_SIZE.
BATCH_SIZE is the global batch, as in the JAX package; each data rank
takes BATCH_SIZE / data rows from its strided shard of the epoch order, and
the gradients are averaged over the data group. Under TPU.SEQ_PARALLEL the
model group shards the memory tokens; otherwise its ranks repeat the same
work (replicated, as the JAX Trainer with MESH_MODEL > 1 and no SP). Every
rank draws the same seeds and starts from rank 0's weights; rank 0 alone
writes metrics and checkpoints. Validation runs on every rank over the
whole validation set (the JAX Trainer's validation scores the whole batch
on every device), so every rank reaches the same F1 and the same choice of
checkpoint.

TRAINER.PROFILER 'simple': the phases of `fit` and `validate` are spans
of the recorder (`parq_torch.telemetry`), ``trainer.<phase>`` (data,
train_step, log_images, log, validate, checkpoint, val_data, val_step,
val_host), which also lie in a TPU.PROFILE_STEPS trace as ranges of their
names; `profile_summary` tabulates them.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device, telemetry
from ..config import ModelConfig, check_card_support, platform_device
from ..data.transforms import pose12_compose, pose12_inverse
from ..evals import (F1Calculator, finish_parse_pred, parse_pred,
                     parse_pred_device, targets_to_gt_list)
from ..geometry import Obb3D, Pose
from ..losses import parse_targets
from ..models import BATCH_KEYS, build_model
from ..parallel.mesh import make_mesh, replicated
from ..parallel.multihost import is_main_process, rank_device
from ..utils import vis
from . import debug_nans
from .checkpoint import CheckpointManager, load_pretrained, restore_state
from .schedule import lr_schedule_from_cfg
from .train_step import (LossConfig, make_graphed_eval_step,
                         make_graphed_train_step, make_optimizer, set_lr)

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


_DONE = object()


def _timed(iterable, name: str):
    """`iterable`'s items, each fetch (the last one too, which finds
    none) a span `name` of the recorder."""
    it = iter(iterable)
    while True:
        with telemetry.span(name):
            item = next(it, _DONE)
        if item is _DONE:
            return
        yield item


def make_trainer_mesh(cfg):
    """The (data, model) grid of the Trainer's ranks: TPU.MESH_MODEL ranks
    to a model group; the data axis TPU.MESH_DATA (-1: every other rank),
    clamped to the largest divisor of DATAMODULE.BATCH_SIZE it reaches, as
    the JAX Trainer clamps it. Raises where the grid would leave ranks
    idle."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = max(int(cfg.TPU.MESH_MODEL), 1)
    if world % model:
        raise ValueError(f"TPU.MESH_MODEL={model} does not divide the "
                         f"{world} ranks")
    data = int(cfg.TPU.MESH_DATA)
    data = world // model if data == -1 else min(data, world // model)
    bs = max(int(cfg.DATAMODULE.BATCH_SIZE), 1)
    while data > 1 and bs % data:
        data -= 1
    if data * model != world:
        raise ValueError(f"a {data} x {model} (data x model) grid for "
                         f"BATCH_SIZE {bs} leaves ranks of {world} idle: "
                         "launch data x model ranks")
    return make_mesh(data, model)


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
        self.cfg = cfg
        self.device = rank_device(resolve_device(platform_device(cfg)))
        if self.device.index is not None:   # a rank's own card
            torch.cuda.set_device(self.device)
        self.mesh = make_trainer_mesh(cfg)
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
        # the JAX Trainer logs validation images only once its writer
        # exists (loop.py:445-448): after the first scalars of a training
        # run; a standalone eval writes none
        self._logging = False
        self.model = None
        self.optimizer = None
        self.lr_schedule: Optional[Callable[[int], float]] = None
        self.train_step_fn = self.eval_step_fn = None
        # validation's matcher draws: one generator, reseeded to 0 by every
        # validation (a captured eval step is bound to its generator)
        self._val_gen = torch.Generator(device=self.device)
        self.global_step = 0
        # 'simple' profiler (TRAINER.PROFILER): the recorder's trainer.*
        # spans, counted from here
        self._phases_at_start = telemetry.spans("trainer.")

    # -- logging ---------------------------------------------------------
    def log_scalars(self, metrics: Dict, step: int, stage: str):
        if not is_main_process():
            return
        row = {"stage": stage, "step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                pass
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        self._logging = True

    def _write_image(self, img: np.ndarray, stage: str, tag: str) -> str:
        out = os.path.join(self.workdir, "images")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"{stage}_{tag}_{self.global_step}.png")
        vis.write_png(path, vis.to_uint8(img))
        return path

    def log_images(self, batch: Dict, outputs: Dict[str, torch.Tensor],
                   stage: str, feature_map: Optional[torch.Tensor] = None):
        """The prediction wireframes of the last iteration (parse_pred,
        with NMS when ENABLE_NMS), the GT wireframes when the batch has
        boxes, and the PCA of `feature_map` (B, T, h, w, C), each of
        sample 0, as PNGs (ref: parq_lightning.py:228-293). `batch` is the
        host batch. Returns the paths written."""
        dec = self.cfg.MODEL.DECODER
        last = {k: v[-1] for k, v in outputs.items()}
        Twl = torch.as_tensor(np.asarray(batch["T_world_local"], np.float32),
                              device=last["ortho6d"].device)
        host = parse_pred(last, Twl, tuple(dec.TRACK_SCALE), dec.NUM_SEMCLS,
                          enable_nms=bool(dec.ENABLE_NMS))
        paths = [self._write_image(self._render_boxes(batch, host), stage,
                                   "rgb_imgwithbox")]
        if "obbs_padded" in batch:
            paths.append(self._write_image(self._render_gt_boxes(batch),
                                           stage, "gt_imgwithbox"))
        if feature_map is not None:
            fm = feature_map[0].float().cpu().numpy()     # (T, h, w, C)
            pca = np.concatenate([vis.normalize_img(vis.pca_compress(fm[t]))
                                  for t in range(fm.shape[0])], axis=0)
            paths.append(self._write_image(pca, stage, "feature_map"))
        return paths

    def _render_boxes(self, batch: Dict, host: Dict):
        """Sample 0's kept predictions over its views; boxes live in the
        local frame and are lifted to the world (ref:
        parq_decoder.py:506-507)."""
        b = 0
        obb = host["obb_data"][b]
        T_world_object = pose12_compose(
            np.asarray(batch["T_world_local"], np.float32)[b], obb[:, 6:18])
        img = vis.draw_detections(
            np.asarray(batch["rgb_img"])[b], np.asarray(batch["camera"])[b],
            Obb3D(torch.from_numpy(obb)).corners_object.numpy(),
            T_world_object,
            pose12_inverse(np.asarray(batch["T_world_pseudoCam"])[b]),
            np.asarray(batch["T_camera_pseudoCam"])[b], host["labels"][b],
            self.cfg.MODEL.DECODER.NUM_SEMCLS, mask=host["pred_mask"][b])
        return vis.normalize_img(img)

    def _render_gt_boxes(self, batch: Dict):
        """Sample 0's GT wireframes (world-frame poses) over its views."""
        b = 0
        obb = Obb3D(torch.from_numpy(np.asarray(batch["obbs_padded"],
                                                np.float32)[b]))
        valid = obb.valid_mask().numpy()
        labels = np.where(valid, obb.sem_id[..., 0].numpy().astype(np.int64),
                          -1)
        img = vis.draw_detections(
            np.asarray(batch["rgb_img"])[b], np.asarray(batch["camera"])[b],
            obb.corners_object.numpy(), obb.T_world_object.data.numpy(),
            pose12_inverse(np.asarray(batch["T_world_pseudoCam"])[b]),
            np.asarray(batch["T_camera_pseudoCam"])[b], labels,
            self.cfg.MODEL.DECODER.NUM_SEMCLS, mask=valid)
        return vis.normalize_img(img)

    def _save_vis(self, batch: Dict, host: Dict, vis_dir: str) -> str:
        """The FOR_VIS/DEMO PNG of sample 0 (ref: parq_lightning.py:
        295-304): ``{scene}_{snippet}_rgb_imgwithbox.png``."""
        os.makedirs(vis_dir, exist_ok=True)
        name = f"{batch['scene_name'][0]}_{batch['snippet_id'][0]}"
        path = os.path.join(vis_dir, f"{name}_rgb_imgwithbox.png")
        vis.write_png(path, vis.to_uint8(self._render_boxes(batch, host)))
        return path

    def profile_summary(self) -> str:
        """Wall time per phase since the Trainer was made: the recorder's
        ``trainer.<phase>`` spans, total seconds, calls, mean ms."""
        lines = ["phase            total_s    calls    mean_ms"]
        start = self._phases_at_start
        for name, a in sorted(telemetry.spans("trainer.").items()):
            b = start.get(name, {"count": 0, "total_s": 0.0})
            n, total = a["count"] - b["count"], a["total_s"] - b["total_s"]
            if n > 0:
                lines.append(f"{name[len('trainer.'):]:<16} {total:>8.2f} "
                             f"{n:>8d} {total / n * 1e3:>9.2f}")
        return "\n".join(lines)

    # -- setup -----------------------------------------------------------
    def setup_state(self, steps_per_epoch: int):
        """The model (random weights from SEED, then PRETRAINED_PATH as a
        warm start), AdamW and the LR schedule."""
        cfg = self.cfg
        self.lr_schedule = lr_schedule_from_cfg(cfg, steps_per_epoch)
        self.model = replicated(build_model(self.model_cfg, seed=int(cfg.SEED),
                                            device=self.device))
        self.model.set_parallel(self.mesh, bool(cfg.TPU.SEQ_PARALLEL))
        self.optimizer = make_optimizer(self.model, lr=self.lr_schedule(0),
                                        capturable=self._captures())
        if cfg.PRETRAINED_PATH:
            logger.info("warm start from %s", cfg.PRETRAINED_PATH)
            load_pretrained(self.model, cfg.PRETRAINED_PATH, strict=False)
        if cfg.TPU.DEBUG_NANS:
            logger.info("DEBUG_NANS: stopping at the first NaN (forward "
                        "hooks, autograd anomaly mode)")
            debug_nans.enable(self.model)
        self._make_steps()

    def _captures(self) -> bool:
        """Whether the steps are captured as CUDA graphs (`_make_steps`).
        Eager by rule: several ranks (gloo's collectives cannot be
        captured; NCCL capture is ROADMAP §A4) and DEBUG_NANS (hooks and
        anomaly mode run op by op, as jax_debug_nans does). An eager
        Trainer keeps the plain AdamW (`make_optimizer`)."""
        return (self.mesh.data * self.mesh.model == 1
                and not self.cfg.TPU.DEBUG_NANS)

    def _make_steps(self):
        """The steps as the JAX Trainer jits them (loop.py:109-111): each
        captured once per batch signature as a CUDA graph and replayed
        (parq_torch/graphs.py), or eager by the rule of `_captures`.
        Rebuilt after a restore: the optimizer's state tensors are new,
        and the graphs must capture them."""
        capture = self._captures()
        self.train_step_fn = make_graphed_train_step(
            self.model, self.optimizer, self.loss_cfg,
            float(self.cfg.TRAINER.GRADIENT_CLIP_VAL),
            self.mesh.data_group, self.mesh.model_group, capture)
        self.eval_step_fn = make_graphed_eval_step(self.model, self.loss_cfg,
                                                   capture)

    def restore_if_available(self, data_loader=None) -> bool:
        """Full resume from the latest checkpoint: weights, AdamW, step
        and the loader's position."""
        if self.ckpt_mgr.latest_step() is None:
            return False
        extras = restore_state(self.ckpt_mgr, self.model, self.optimizer)
        self._make_steps()
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
        self._make_steps()
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
        nan_ctx = (debug_nans.nan_errors if cfg.TPU.DEBUG_NANS
                   else contextlib.nullcontext)
        k = self.accumulate
        log_img_every = max(int(cfg.LOG_IMAGES_FREQUENCY), 1)
        overfit_cache = []
        while train_loader.epoch < cfg.TRAINER.MAX_EPOCHS:
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
            for batch, dev_batch, data_state in _timed(device_prefetch(
                    epoch_iter, self.device, state_fn=state_fn),
                    "trainer.data"):
                if overfit_n and len(overfit_cache) < overfit_n:
                    overfit_cache.append(batch)
                n_done += 1
                if n_done > limit_n > 0:
                    break
                with telemetry.span("trainer.train_step"):
                    # optax's schedule counts updates: with accumulation,
                    # one per k micro-batches
                    lr = self.lr_schedule(self.global_step // k)
                    set_lr(self.optimizer, lr)
                    self.model.train()
                    with nan_ctx():
                        metrics = self.train_step_fn(
                            dev_batch, gen, accumulate=k,
                            micro_step=self.global_step % k)
                self.global_step += 1
                if cfg.LOG_IMAGES and self.global_step % log_img_every == 0:
                    # every rank runs the forward (its collectives), rank 0
                    # writes
                    with telemetry.span("trainer.log_images"), \
                            torch.no_grad():
                        outputs, feat = self.model(
                            dev_batch, deterministic=True,
                            return_feature_map=True)
                        if is_main_process():
                            self.log_images(batch, outputs, "train", feat)
                if prof_steps and self.global_step == 2:
                    profiler = self._start_profiler()
                if profiler is not None and \
                        self.global_step >= 2 + prof_steps:
                    self._stop_profiler(profiler)
                    profiler = None
                if self.global_step % cfg.TRAINER.LOG_EVERY_N_STEPS == 0:
                    with telemetry.span("trainer.log"):
                        host = {name: float(v)
                                for name, v in metrics.items()}
                        host["lr"] = lr
                        self.log_scalars(host, self.global_step, "train")
                        logger.info("step %d loss %.4f", self.global_step,
                                    host["total_loss"])
                if val_loader is not None and val_this_epoch and \
                        self.global_step % val_every == 0:
                    with telemetry.span("trainer.validate"):
                        val_metrics = self.validate(val_loader,
                                                    limit_batches=limit_val)
                        self.log_scalars(val_metrics, self.global_step,
                                         "val/metrics")
                    with telemetry.span("trainer.checkpoint"):
                        self.ckpt_mgr.save(
                            self.global_step, self.model, self.optimizer,
                            metrics=val_metrics,
                            data_state=(data_state if data_state is not None
                                        else train_loader.state_dict()))
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
                 timing: bool = False, for_vis: bool = False,
                 vis_dir: Optional[str] = None) -> Dict[str, float]:
        """F1 at IoU 0.25/0.5/0.7 and the mean loss over the first
        `limit_batches` batches of `loader`, always from the start of the
        set. One batch of device work is queued before the previous batch's
        host half (numpy copy, NMS, F1 association) runs; `timing` keeps
        every batch strictly serial and prints its latency (eval.py's
        protocol). `for_vis` (MODEL.DECODER.FOR_VIS): every box is valid and
        the NMS is the same-class one of the visualization; with `vis_dir`
        rank 0 writes each batch's overlay PNG there. Under LOG_IMAGES the
        first batch's overlays are logged, once the Trainer has logged
        scalars (a training run), by rank 0."""
        cfg = self.cfg
        dec = cfg.MODEL.DECODER
        calc = F1Calculator(dec.CONF_THRESH, num_semcls=dec.NUM_SEMCLS)
        limit = val_batch_limit(limit_batches, len(loader))
        gen = self._val_gen.manual_seed(0)
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
            batch, _, dev_parsed = item[:3]
            host = finish_parse_pred(dev_parsed, dec.NUM_SEMCLS,
                                     enable_nms=bool(dec.ENABLE_NMS),
                                     for_vis=for_vis)
            host["scene_name"] = batch["scene_name"]
            return host

        def consume(item, host):
            nonlocal total_loss, count
            batch, losses, _, targets, outputs, i = item
            if i == 0 and cfg.LOG_IMAGES and self._logging:
                self.log_images(batch, outputs, "val")
            if targets is not None:
                calc.step(host, targets_to_gt_list(targets))
                total_loss += float(losses["total_loss"])
                count += 1
            if for_vis and vis_dir and is_main_process():
                self._save_vis(batch, host, vis_dir)

        # the 'simple' profiler's split of a validation: waiting for the
        # loader (val_data), the step and device parse with the matcher's
        # sync (val_step), the host half and F1 association (val_host)
        pending = None
        for i, (batch, dev_batch) in enumerate(_timed(stream,
                                                      "trainer.val_data")):
            if i >= limit:
                break
            t0 = time.perf_counter()
            with telemetry.span("trainer.val_step"):
                losses, outputs = self.eval_step_fn(dev_batch, gen)
                last = {k: v[-1] for k, v in outputs.items()}
                dev_parsed = parse_pred_device(
                    last, dev_batch["T_world_local"], tuple(dec.TRACK_SCALE),
                    for_vis, dec.NUM_SEMCLS, bool(dec.ENABLE_NMS))
                targets = None
                if "obbs_padded" in dev_batch:
                    targets = parse_targets(
                        Obb3D(dev_batch["obbs_padded"]),
                        Pose(dev_batch["T_world_local"]),
                        dev_batch.get("sym"))
                item = (batch, losses, dev_parsed, targets, outputs, i)
            with telemetry.span("trainer.val_host"):
                if timing:
                    host = host_finish(item)
                    dt = time.perf_counter() - t0
                    times.append(dt)
                    if is_main_process():
                        print(f"{batch['scene_name'][0]}: inference time "
                              f"{dt:.4f}s (running mean "
                              f"{np.mean(times[1:] or times):.4f}s)",
                              flush=True)
                    consume(item, host)
                else:
                    if pending is not None:
                        consume(pending, host_finish(pending))
                    pending = item
        with telemetry.span("trainer.val_host"):
            if pending is not None:
                consume(pending, host_finish(pending))
            self.model.train(was_training)
            metrics = (calc.compute_metrics(verbose=verbose)
                       if calc.preds or calc.gts else {})
        if count:
            metrics["total_loss"] = total_loss / count
        if timing and times:
            # the first batch includes the warm-up; drop it when there are more
            metrics["mean_latency_s"] = float(np.mean(times[1:] or times))
        return metrics

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA source in parq_torch/csrc, one nvcc each, timed;
  3. kernels — the Hopper building blocks (wgmma descriptors, TMA) on one
               tile against a plain product; then each kernel against its
               plain PyTorch version at the release shapes: B1 (sampler) in
               bf16 and f32 at B=8 T=3, B=1 T=3 (eval, serving) and B=1 T=6
               (scaled), each timed against its bound: the output in the
               memory's dtype, its f32 sums within 1e-4 of the plain sums
               and the output equal to them rounded, bit for bit; B2 (flash cross-attention) in bf16
               (atol 2e-2: bf16 output rounding) and f32 (atol 1e-4), B2
               and its train form in bf16 at every KV split from 1 to 16
               (the rule's pick printed), plus B2 at a ragged
               N; B2's train form (LSE to 1e-4, dropout 0.1) at Q=256, and
               folded (Q=2048 in 8 seed groups) against 8 separate calls,
               equal bit for bit; B3 (flash backward) at Q=2048, G=8, with
               dropout 0.1 and 0, and at a ragged N, and in bf16 at every
               KV split of its dq pass (against the plain version with the
               same split, two launches equal bit for bit, dKV the same at
               every split; the rule's pick and the dq grid printed; its
               two passes and the dq combine from 5 profiled launches); B2, B2-train and B3 at
               a Q that does not divide the 128-row tile (200) and an N
               below one KV tile (40); B4 (sampler d(memory)) at Q=2048 in
               bf16 and f32 on three distributions of the rows (the
               decoder's, every row in one 8x8 patch, every row off the
               image), two launches equal bit for bit; then B2-train and B3
               on separate K and V (bf16 and f32): the natural layout at an
               SP shard's 7,200 tokens (Q=256, and Q=2048 in 8 seed groups),
               the legacy (B, H, N, D) layout padded past n_valid (rows past
               it never read, their gradients left zero), the v2 dropout
               hash (split and fused); a fused and a split call on the same
               K/V values agree; a call on rows 4-7 with b_offset 4 equals
               those rows of the call over all 8, bit for bit; then every
               kernel at the shapes of configs/scaled_recurrence.yaml (B=1,
               T=6, Q=256, N=28,800) with the same tolerances: B1 (bf16
               and f32), B2, B2-train, B3 and B4 (bf16), B2 and B2-train
               at every KV split, B3 at every dq split (its dq pass at
               least 100 CTAs on a 132-SM card);
  4. matcher — kernel M1 (the matcher's batched LAP) against its plain
               version on the CPU, bit for bit, on the release problem (64
               pairs of 100 target rows x 256 queries, n_rows mixed over
               0, 1, 3, 20, 100) and on the K > Q problem (64 query rows x
               100 targets, the invalid targets' columns flat: ties); the
               totals against scipy to 1e-5 relative; `match_batch` at
               release shapes under sync debug mode "error" (no sync, one
               M1 launch) equal to the CPU's on the same inputs; M1's ms
               (release and scaled, the batch's own targets and 100, each
               problem also held against the plain version bit for bit)
               beside the host route it replaced (copy, scipy, copy back);
  5. native  — parq_torch/native built with g++ (seconds); iou3d_matrix
               against the Python iou3d on 200 rotated boxes, each against
               itself included (1), to 1e-9; nms3d equal to greedy_nms,
               tied scores included; F1's
               IoU matrix and association both ways, timed;
  6. serve   — an Engine at the release config (ResNet50, 3 x 320x240,
               L=8, Q=256, dim 1024, B=8, bf16) answers 3 /detect requests
               over HTTP; every output is finite, each serving kernel's
               launch count rose by exactly 8 per request and the
               frozen-BN pass's by 49 (one a BN site of the ResNet-50 body
               but the downsamples'), no training kernel launched, and the
               token memory the sampler reads came in bf16;
  7. parity  — the same seeded weights and batch, B=1 f32, TF32 off: the
               card's forward (kernels) against the port's CPU forward
               (plain versions), atol 2e-3, every output of the last
               iteration;
  8. train   — the release model at B=8 in bf16, dropout 0.1, AdamW at lr
               1e-4 with a global-norm clip of 1.0, 5 steps through
               parq_torch.train's graphed step on synthetic batches (step
               0 eager and captured, steps 1-4 replayed): finite losses
               and gradient norms, the parameters moved, the token memory
               in bf16 (so B1 and B4 ran their bf16 forms), and per step
               B1 8, B2-train 8, B3 1, B4 1, M1 1 and 45 keep-mask
               launches; step ms of the replays from CUDA events; no
               synchronizing operation in a replay; a profile of one;
  8b. graphs — jax.jit's counterpart (parq_torch/graphs.py): the
               synchronizing operations of one eager release step (B=8
               bf16, dropout 0.1) and of one eager forward, 0 each (16 a
               step before); the replayed B=8 bf16 forward equal to the
               eager one bit for bit; wall (CUDA events over back-to-back
               calls) and device-busy ms (tools/profiling.py) of the
               forward and the step, eager against graph; an f32 gate (B=1,
               TF32 off, L=2, dropout 0.1): 3 replays against 3 eager steps
               from the same weights, AdamW state and generator state, the
               losses and parameters to the train-parity tolerance, the
               flash seeds bit for bit; the capturable AdamW against the
               plain one (parameters to 1e-6 relative after a step);
  9. train-parity — B=1, f32, TF32 off, dropout 0, release widths at L=2:
               the card's gradients (kernels) against the CPU's (plain
               versions), parameter by parameter, by norm; `unshared`:
               the same with SHARE_WEIGHTS False (each iteration its own
               modules);
 10. times   — forward ms at B=8 bf16 (CUDA events over 10 forwards, the
               host's work included) and a profile of one forward; per
               kernel device ms (CUDA-graph replay; the library's dropout
               and backward calls by CUDA events), launches on its path,
               bound ms, plain ms and the library call's ms (B4's record
               with g in the memory's dtype, as B1's output hands it on the
               training paths); B4 on its three distributions; B2 at B=1 over the release N (the eval
               twin's shape), its launches from the eval twin's run;
               the DCNv2 sampling kernel at PETR's two DCN stage shapes
               (six cameras; bf16, within one bf16 ulp of the plain
               version's f32 sums, two launches equal bit for bit); the
               frozen-BN pass (`frozen_bn_rows`) at PETR's stem map, a
               layer-1 residual site, a downsample site and the release
               stem, random non-identity buffers, bit for bit the modules'
               ops, two launches equal, timed against its byte bound and
               the modules' ops; each row's launches a forward from a
               recorder around the body's call sites in an eager PETR
               forward (summing to the replay's 49) and a release one
               (summing to the eval twin's count a snippet);
 10b. petr   — PETR at its published widths in bf16 through Graphed: two
               replays equal the eager forward bit for bit, 9 DCN
               launches and 49 frozen-BN launches a replay; the replay's
               ms and the peak memory;
 11. sp      — two ranks on the one card over gloo (NCCL refuses two ranks
               on one GPU), MESH_MODEL 2, the memory tokens sharded: an f32
               step (TF32 off, L=2, B=1, dropout 0) against the one-process
               step on the same weights (loss rtol 1e-5, each gradient
               ‖Δ‖ ≤ 2e-4·max(‖g‖, 1) + 1e-3 on each rank);
               3 release bf16 steps at B=8, L=8, dropout 0.1 (gradients
               averaged over the model group), per rank per step B1 8,
               split B2-train 8, split B3 1, B4 1 and M1 1 launches,
               parameters equal on both ranks after them; one SP validation forward,
               B1 8 and fused B2-LSE 8 per rank;
 12. ddp     — two ranks (MESH_DATA 2), dropout 0.1, the one-process step's
               seeds: an f32 gate (TF32 off, L=2, one row a rank) to the sp
               gate's tolerance; one release bf16 step, 4 rows a rank:
               its loss to 1e-5 of the same split computed in one process,
               its clipped gradients against the one-process B=8 step to
               twice that step's distance from the same step in f32 (bf16
               products over 4 rows instead of 8 round otherwise and break
               the matcher's near ties otherwise); then the record of the
               split, legacy and v2 forms;
 12b. tp     — tensor parallelism, two ranks on the one card over gloo,
               model 2 at release width (2 of 4 self-attention heads and
               384 of 768 FFN columns a rank; the cross-attention whole on
               each rank, as the JAX rule leaves it): an f32 gate (TF32
               off, L=2, B=2, dropout 0.1, the one-process step's seeds):
               loss and grad_norm rtol 1e-5, each clipped gradient in the
               reference layout to the sp gate's limit, the updated
               parameters where Adam's first step is well posed to
               1e-3·lr; 3 bf16 release steps at B=8 (per rank per step B1
               8, B2-train 8, B3 1, B4 1, M1 1; ms by CUDA events, no
               scaling figure: the ranks share the SMs; peak memory); the
               TP checkpoint loaded strictly into one process, its forward
               equal to the ranks' (1e-4 of max(1, max |want|)); then
               `dryrun_multichip(4)`: 4 ranks on the card, a (2, 2) grid,
               its OK line;
 13. fit     — `python -m parq_torch.cli.train` in-process on
               configs/train.yaml at release width in bf16 on synthetic
               snippets (32 to train, 8 to validate: the loaders' defaults
               for DATA_PATH synthetic), B=8, 2 epochs, validation every
               half epoch: 8 steps, 4 validations and the final one on the
               best checkpoint. Finite losses; per step B1 8, B2-train 8, B3
               1, B4 1 and M1 1 launches, per validation B1 and B2 8 each,
               M1 1 (the validation loss) and nothing else; the token memory in bf16; checkpoints written;
               then a Trainer with MAX_EPOCHS 3 resumes at step 8 with the
               saved weights bit for bit and takes the next epoch. ms per
               step (CUDA events) and validation's share of the fit;
 14. eval    — `python -m parq_torch.cli.eval` on configs/eval.yaml with
               the fit's best checkpoint, synthetic snippets, bf16: the
               metric lines 0.25_f1, 0.5_f1, 0.7_f1 and mean_latency_s are
               printed; per snippet B1 and B2 8 launches each and M1 1;
 14b. vis    — Trainer.validate(for_vis=True) at release width, bf16, on
               2 synthetic snippets: one PNG a batch, each read back as
               (720, 320, 3), B1 8, B2 8 and M1 1 launches a batch; one
               log_images call (the prediction and GT overlays, the feature
               map's PCA): its host ms, the GT overlay's box pixels present;
               the eval twin with MODEL.DECODER.FOR_VIS True writes its 8
               PNGs into demo_vis/ (under build/);
 15. serve-ckpt — an Engine from configs/eval.yaml with the fit's best
               checkpoint loaded strictly, then with the same weights as a
               reference-layout state_dict: their detections on a snippet
               equal those of the eval twin's model, at CONF_THRESH and at
               0 (1e-4);
 16. scaled  — configs/scaled_recurrence.yaml at full width (6 x 320x240,
               L=16, Q=256, 28,800 tokens, B=1, bf16, dropout 0.1): 3
               train steps with REMAT on (per step B1 32, B2-train 32, B3
               16, B4 16, M1 1: the recompute launches B1 and B2-train
               again),
               3 with REMAT off on the same sequential path (16 each) and 3
               on the fold the config takes without REMAT (B1 16, B2-train
               16, B3 1, B4 1); step ms (CUDA events) and peak memory of
               each; an f32 gate (TF32 off, dropout 0) of REMAT on against
               off, each gradient to the train-parity tolerance; one eval
               forward (B1 16, B2 16); the train twin on the config (2
               synthetic snippets, 2 steps, 2 validations); then the
               kernels' record at these shapes;
 17. export  — the release eval forward through parq_torch.export on the
               card, saved and loaded: f32 at B=1 against the live model to
               1e-5 (TF32 off), bf16 at B=8 to 1e-2; the bf16 artifact
               behind the server answers 3 /detect requests, B1 and B2
               rising by exactly 8 a request (the program runs the
               kernels through their custom ops), nothing else launching
               (the export traced the body's modules: no frozen-BN pass);
 18. fit-sp  — the train twin under `torchrun --standalone --nproc_per_node
               2` (gloo), TPU.SEQ_PARALLEL True, MESH_MODEL 2, B=8: 2 steps,
               1 validation, the checkpoint written once (by rank 0), the
               final validation; every rank must exit 0;
 19. bench   — `python -m parq_torch.bench` and `--train` (the twin of
               bench.py) in processes of their own at their default flags
               (B=8 bf16, 30 iterations): each prints one JSON line with
               bench.py's keys and the card's name, the host CPU,
               device_busy_ms and wall_ms; the rate above 0 and below the
               plausibility guard (bf16 peak over the forward's FLOPs a
               frame; half that for a step); per iteration B1 and B2 8
               launches a forward and a step's those of [train];
 20. rehearsal — a checkpoint in parq_release.ckpt's key layout from
               `parq_torch.tools.release_ckpt` (dead norm, BatchNorm
               counters, random BatchNorm statistics) loaded strictly by
               `python -m parq_torch.cli.eval --cfg configs/eval.yaml
               --CHECKPOINT_PATH ...` (CONF_THRESH 0.05, the real mean-size
               table, LIMIT_VAL_BATCHES 2, 2 synthetic snippets of one
               scene), f32 with TF32 off, on the card and on the CPU:
               every iteration's outputs within 1.5e-3·2.8^l (sizes over
               their own mean row, an argmax flip only at a near-tie), the
               F1 dicts within 0.15, per snippet B1 8, B2 8 and M1 1
               launches, M1 on the loss's 100 targets.
 21. preprocess — the offline ScanNet preprocessing twin
               (parq_torch/tools/scannet_preprocessing) on one synthetic
               scene at ScanNet's sizes, from a seed: 120 frames of
               640x480 16-bit P5 depth (a room's walls, floor and ceiling,
               4 mm of noise, 3% zeros), ScanNet's intrinsics, header-only
               1296x968 JPEGs, a loop of poses that view selection thins,
               24 rotated boxes (one of degenerate scale, three outside the
               room). parse_scan2cad, then both stages of the val
               (nonoverlap) and train (overlap) splits through the
               generator's CLI entry with --device cuda; the card's records
               of the first 8 snippets of each split against the port's CPU
               path: counts equal, ratios to 1e-12, the stage-2 pickles of
               those snippets equal once loaded; frames read, snippets
               written, ms a frame by part (reading the depth, uploading it,
               the device passes by CUDA events) and the CPU path's passes;
               the syncs of one scene, at most one a chunk of 16 frames.
The keep-mask kernel (csrc/dropout.cu, not a TPU kernel: the counterpart
of the JAX decoder's `_grouped_keep`) is held against `keep_mask` bit for
bit at every release mask shape, timed beside `torch.rand` + a compare,
and has its row in the record. So does the NMS kernel (csrc/nms.cu, the
counterpart of the JAX package's `nms_mask_device`: parse_pred's greedy
NMS and the pack of its detections, `nms_rows`) at the eval shape (B=1,
K=256): its pack equal to the plain version's and its keep mask to the
host library's, bit for bit, timed beside the host route it replaced and
`nms_mask_device` on the card; every phase that parses predictions counts
one of its launches a parse. The Trainer, the bench twin,
the serve Engine and the train entry replay CUDA graphs on the card: the
launch counts of the phases that drive them come from the graphs' capture
records, and a forward hook sees only an eager call and a capture.
               The files of the CLI, scaled, export, fit-sp, tp, vis,
               rehearsal and preprocess phases under build/ are deleted at
               the end.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a GPU, or without the parq_torch
package beside this file, it exits non-zero and prints no result.
"""
import dataclasses
import io
import json
import math
import argparse
import contextlib
import os
import pickle
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak, published


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def _elapsed_ms(run):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps):
    """Mean ms of `fn` over `reps` back-to-back runs, from CUDA events,
    after one warm-up run: the host's launch work is included."""
    fn()
    torch.cuda.synchronize()
    return _elapsed_ms(lambda: [fn() for _ in range(reps)]) / reps


def device_ms(fn, reps):
    """Mean device ms of `fn`: `reps` calls captured in one CUDA graph and
    replayed, so a small kernel is timed without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _elapsed_ms(graph.replay) / reps


# ---------------------------------------------------------------- inputs --
def release_sampler_inputs(cfg, B, dtype, gen):
    """Memory and (u, v, scale) rows as the decoder's first iteration makes
    them: the synthetic rig's cameras at feature scale, queries spread over
    the scene box."""
    from parq_torch.data.synthetic import make_batch
    from parq_torch.geometry import Camera, Pose
    from parq_torch.kernels.pixel_align import project_uvs
    from parq_torch.models.decoder import denormalize_points
    batch = make_batch(list(range(B)), image_size=cfg.image_size,
                       num_views=cfg.num_views)
    dev = "cuda"
    t = {k: torch.as_tensor(batch[k], device=dev) for k in
         ("camera", "T_camera_pseudoCam", "T_world_pseudoCam",
          "T_world_local")}
    Tcl = Pose(t["T_camera_pseudoCam"]) @ (
        Pose(t["T_world_pseudoCam"]).inverse() @ Pose(t["T_world_local"]))
    ref = torch.rand(B, cfg.num_queries, 3, device=dev, generator=gen)
    uvs, _, _ = project_uvs(denormalize_points(ref, cfg.scale), Tcl,
                            Camera(t["camera"]).scale(0.25))
    W, H = cfg.feat_size
    mem = torch.randn(B, cfg.num_views, H, W, cfg.tokenizer_out_channels,
                      device=dev, generator=gen).to(dtype)
    return mem, uvs


def sampler_bwd_inputs(cfg, B, gen):
    """B4's inputs at the training fold (Q = L·256 rows: the rows of all L
    iterations land on one map): the memory's shape, the cotangent g and
    three distributions of the (u, v, scale) rows: "release", the first
    iteration's points repeated L times plus one pixel of noise;
    "clustered", every row of every view inside one 8x8 patch of pixels (one
    CTA's tile: the longest hit list a map can give); "off-image", no tap
    inside any map (the result is all zeros)."""
    mem, uvs = release_sampler_inputs(cfg, B, torch.bfloat16, gen)
    H, W = mem.shape[2:4]
    fold = uvs.repeat(1, 1, cfg.dec_layers, 1).contiguous()
    fold[..., :2] += torch.randn(fold[..., :2].shape, device="cuda",
                                 generator=gen)
    g = torch.randn(B, fold.shape[2], mem.shape[-1], device="cuda",
                    generator=gen)
    r = torch.rand(2, *fold.shape[:3], 2, device="cuda", generator=gen)
    clustered, off = fold.clone(), fold.clone()
    clustered[..., :2] = torch.tensor([32.0, 24.0], device="cuda") + 8 * r[0]
    off[..., :2] = torch.tensor([W + 0.5, -1.5], device="cuda") \
        + torch.tensor([100.0, -100.0], device="cuda") * r[1]
    return mem.shape, g, {"release": fold, "clustered": clustered,
                          "off-image": off}


def rows_in_image(uvs, H, W):
    """Share of the (u, v) rows with at least one bilinear tap inside an
    H x W map."""
    x0, y0 = torch.floor(uvs[..., 0]), torch.floor(uvs[..., 1])
    return ((x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
            ).float().mean().item()


def attention_inputs(B, H, Q, N, D, dtype, gen):
    """Logits of std 2 (q ~ 2·N(0,1), k ~ N(0,1), scaled by 1/sqrt(D)): a
    softmax far from uniform, so outputs are O(0.1–1) and an error in the
    kernel's weighting shows."""
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    return q, kv


def sampler_bound_ms(mem, uvs, out_size=None):
    """Bytes the sampler must move for THIS data: every distinct in-image
    tap row read once, the (u, v, scale) rows read, the output written
    once in the memory's dtype (B1 writes it; `out_size` bytes an element
    otherwise, 4 for f32 sums)."""
    B, T, H, W, C = mem.shape
    x0, y0 = torch.floor(uvs[..., 0]), torch.floor(uvs[..., 1])
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
            bt = torch.arange(B * T, device=mem.device).view(B, T, 1)
            idx = (bt * H + y.clamp(0, H - 1).long()) * W \
                + x.clamp(0, W - 1).long()
            rows.append(idx[inb])
    n_rows = torch.unique(torch.cat(rows)).numel()
    Q = uvs.shape[2]
    out_size = mem.element_size() if out_size is None else out_size
    nbytes = (n_rows * C * mem.element_size() + uvs.numel() * 4
              + B * Q * C * out_size)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(q, kv, lse=False):
    """(ms, "bytes" | "operations"): q and kv read once, o (and the f32
    lse) written once, against 4·B·H·Q·N·D bf16 tensor-core operations."""
    B, H, Q, D = q.shape
    N = kv.shape[1]
    nbytes = (2 * q.numel() + kv.numel()) * q.element_size() \
        + (4 * B * H * Q if lse else 0)
    return _bound(nbytes, 4 * B * H * Q * N * D)


def attention_bwd_bound(q, kv):
    """B3: q, do and kv read once, dq and dKV written once, lse and delta
    read once, against 10·B·H·Q·N·D operations (the five products)."""
    B, H, Q, D = q.shape
    N = kv.shape[1]
    nbytes = (3 * q.numel() + 2 * kv.numel()) * q.element_size() \
        + 2 * 4 * B * H * Q
    return _bound(nbytes, 10 * B * H * Q * N * D)


def sampler_bwd_bound(uvs, g, mem_shape, dtype):
    """B4: d(memory) written once in its dtype, g (cast to it) and the
    (u, v, scale) rows read once; 2 operations per tap and channel."""
    B, T, H, W, C = mem_shape
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = math.prod(mem_shape) * size + g.numel() * size + uvs.numel() * 4
    return _bound(nbytes, 2 * 4 * uvs.shape[0] * T * uvs.shape[2] * C)


def watch_memory_dtype(model):
    """(dtypes, handle): the dtype of the token memory at each call of the
    model's decoder from now on. The sampler kernels take the memory's
    dtype, so it decides which form of B1 and B4 the path runs."""
    seen = []
    handle = model.box3d_decoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
    return seen, handle


def _excess(got, want):
    """max |got − want|, for bf16 less 2⁻⁷·|want|: the error beyond one bf16
    rounding of the value. With few tokens and dropout's 1/(1 − rate), |o|
    passes 4, where one bf16 step is 0.031, more than the absolute limit
    alone. f32 results get no such slack."""
    step = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    return ((got - want).abs() - want.abs() * step).max().item()


def _rel_err(got, want):
    """max |got − want| and that over max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


# ---------------------------------------------------------------- phases --
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          "visible")
    return line


def phase_build():
    from parq_torch.kernels import _build
    seconds = _build.build_all()
    for name in _build.SOURCES:
        check(_build.library_path(name).exists(), f"{name} did not build")
    phase("build", f"{', '.join(_build.SOURCES)} built from "
          f"parq_torch/csrc in {seconds:.2f} s")


def check_sampler(label, mem, uvs):
    """B1 on `mem` in bf16 and f32 against its plain version: the output in
    the memory's dtype, its f32 sums (`sample_views_sums`) within 1e-4 of
    the plain sums, the output equal to those sums cast by torch bit for
    bit, two launches equal bit for bit. Returns the bf16 output's max abs
    error against the plain version's (the plain sums cast to bf16: 0, or
    one bf16 step where the two sums round to either side)."""
    from parq_torch.kernels import sample_views
    from parq_torch.kernels.pixel_align import (sample_views_plain,
                                                sample_views_sums)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        m = mem.to(dtype)
        got = sample_views(m, uvs)
        check(got.dtype == dtype, f"{label} B1 {dtype}: output {got.dtype}")
        check(torch.equal(got, sample_views(m, uvs)),
              f"{label} B1 {dtype}: two launches differ")
        sums = sample_views_sums(m, uvs)
        want = sample_views_plain(m, uvs)
        err = (sums - want).abs().max().item()
        check(err <= 1e-4, f"{label} B1 {dtype}: f32 sums max abs err "
              f"{err} > 1e-4")
        check(torch.equal(got, sums.to(dtype)), f"{label} B1 {dtype}: the "
              "output is not its f32 sums rounded to the memory's dtype")
        errs[dtype] = (got.float() - want.to(dtype).float()
                       ).abs().max().item()
        phase("kernels", f"{label} B1 {str(dtype)[6:]} {tuple(m.shape)} "
              f"Q={uvs.shape[2]}: output {str(got.dtype)[6:]}, f32 sums max "
              f"abs err {err:.3e} (atol 1e-4), output = its sums rounded bit "
              f"for bit (against the plain output {errs[dtype]:.3e}), two "
              "launches equal")
    return errs[torch.bfloat16]


def sampler_rows(cfg, scaled_cfg, gen):
    """B1 checked and timed at the three shapes its paths give it: the
    release forward and step (B=8, T=3), the eval twin and serving at B=1
    (T=3) and the scaled config (B=1, T=6), bf16. Launches are filled from
    each path's run."""
    from parq_torch.kernels import sample_views
    from parq_torch.kernels.pixel_align import sample_views_plain
    rows = {}
    for name, mcfg, B in (("pixel_align_sample", cfg, 8),
                          ("pixel_align_sample_eval", cfg, 1),
                          ("pixel_align_sample_scaled", scaled_cfg, 1)):
        mem, uvs = release_sampler_inputs(mcfg, B, torch.bfloat16, gen)
        err = check_sampler(name, mem, uvs)
        rows[name] = dict(
            name=name, route="cuda", source="parq_torch/csrc/pixel_align.cu",
            replaces="parq_tpu/kernels/pixel_align_pallas.py:168",
            ms=device_ms(lambda: sample_views(mem, uvs), 50),
            plain_ms=device_ms(lambda: sample_views_plain(mem, uvs), 10),
            bound_ms=sampler_bound_ms(mem, uvs), bound_by="bytes",
            library_ms=None, max_abs_err=err)
        r = rows[name]
        phase("kernels", f"{name} B={B} T={mem.shape[1]}: {r['ms']:.4f} "
              f"ms/launch, bound {r['bound_ms']:.4f} ms (bytes, bf16 out), "
              f"plain {r['plain_ms']:.4f} ms")
    return rows


def phase_kernels(cfg, scaled_cfg):
    """Each kernel vs its plain version at the release shapes; B1 also at
    its B=1 shapes. Returns the errors and B1's record rows."""
    from parq_torch.kernels import flash_cross_attention_kv_fused as flash
    from parq_torch.kernels.cross_attention import (
        cross_attention_kv_fused_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    b1_rows = sampler_rows(cfg, scaled_cfg, gen)
    check_building_blocks(gen)
    Hh = cfg.dec_heads
    D = cfg.dec_dim // Hh
    N = cfg.num_views * cfg.feat_size[0] * cfg.feat_size[1]
    for dtype, n, atol in ((torch.bfloat16, N, 2e-2),
                           (torch.float32, N, 1e-4),
                           (torch.bfloat16, 1000, 2e-2),
                           (torch.float32, 1000, 1e-4)):
        q, kv = attention_inputs(8, Hh, cfg.num_queries, n, D, dtype, gen)
        err = (flash(q, kv).float()
               - cross_attention_kv_fused_plain(q, kv).float()
               ).abs().max().item()
        check(err <= atol, f"B2 {dtype} N={n} max abs err {err} > {atol}")
        errs[("B2", dtype, n)] = err
        phase("kernels", f"B2 flash {str(dtype)[6:]} q {tuple(q.shape)} "
              f"kv {tuple(kv.shape)}: max abs err {err:.3e} (atol {atol})")
        if dtype == torch.bfloat16:
            check_kv_splits(q, kv, cfg.dropout_rate, atol, gen,
                            f"B=8 N={n}")
    errs.update(train_kernels(cfg, gen, N))
    errs.update(split_kernels(cfg, gen, N))
    torch.cuda.synchronize()
    return {"pixel_align_sample": b1_rows["pixel_align_sample"][
                "max_abs_err"],
            "flash_cross_attention_fwd": errs[("B2", torch.bfloat16, N)],
            "flash_cross_attention_fwd_train": errs["B2-train"],
            "flash_cross_attention_bwd": errs["B3"],
            "pixel_align_bwd_mem": errs["B4"],
            **{k: v for k, v in errs.items() if isinstance(k, str)
               and k.startswith("flash_cross_attention_")}}, b1_rows


def valid_splits(N):
    """Every KV split the kernels take at N: 1..MAX_SPLITS, each split
    owning at least one 64-token block."""
    from parq_torch.kernels.cross_attention import MAX_SPLITS, split_bounds
    return [s for s in range(1, MAX_SPLITS + 1)
            if len(split_bounds(N, s)) == s]


def check_kv_splits(q, kv, rate, atol, gen, label):
    """B2 (eval form) and B2-train (dropout `rate`) at every KV split
    against their plain versions: o to `atol`, lse to 1e-4. Prints the
    split the wrapper's rule picks."""
    from parq_torch.kernels.cross_attention import (
        _flash_fwd, _flash_fwd_lse, _splits_for,
        cross_attention_kv_fused_plain, cross_attention_kv_fused_train_plain)
    N = kv.shape[1]
    seeds = seed_vector(1, gen)
    want = cross_attention_kv_fused_plain(q, kv).float()
    o_ref, lse_ref = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    worst, worst_t = {}, {}
    for splits in valid_splits(N):
        worst[splits] = (_flash_fwd(q, kv, splits).float()
                         - want).abs().max().item()
        o, lse = _flash_fwd_lse(q, kv, seeds, rate, splits)
        worst_t[splits] = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        check(max(worst[splits], worst_t[splits]) <= atol
              and err_l <= 1e-4, f"B2 {label} splits {splits}: eval "
              f"{worst[splits]}, train {worst_t[splits]} > {atol} or lse "
              f"{err_l} > 1e-4")
    fmt = lambda d: ", ".join(f"{k}: {v:.3e}" for k, v in d.items())
    phase("kernels", f"B2 bfloat16 {label} q {tuple(q.shape)} at every KV "
          f"split, max abs err: eval {fmt(worst)}; train (rate {rate}, lse "
          f"to 1e-4) {fmt(worst_t)} (atol {atol}; the rule picks "
          f"{_splits_for(q, N, q.shape[2], None)})")


def check_dq_splits(q, kv, seeds, rate, limit, gen, label):
    """B3 at every KV split of its dq pass against the plain version with
    the same split (`cross_attention_kv_fused_bwd_split_plain`): dq and
    dKV to `limit` of their largest elements; two launches equal bit for
    bit; dKV the same at every split. Prints the split the rule picks and
    its grid, and profiles 5 launches at that split (the passes and the
    combine apart); returns (the rule's split, its dq pass's CTAs)."""
    from parq_torch.kernels import flash_fwd_lse
    from parq_torch.kernels.cross_attention import (
        _flash_bwd, _splits_for, cross_attention_kv_fused_bwd_split_plain,
        split_bounds)
    N = kv.shape[1]
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    o, lse = flash_fwd_lse(q, kv, seeds, rate)
    delta = (do.float() * o.float()).sum(-1)
    errs, dkv1 = {}, None
    for splits in valid_splits(N):
        dq, dkv = _flash_bwd(q, kv, do, lse, delta, seeds, rate, splits)
        dq2, dkv2 = _flash_bwd(q, kv, do, lse, delta, seeds, rate, splits)
        check(torch.equal(dq, dq2) and torch.equal(dkv, dkv2),
              f"B3 {label} dq splits {splits}: two launches differ")
        check(dkv1 is None or torch.equal(dkv, dkv1),
              f"B3 {label}: dKV changes with the dq split ({splits})")
        dkv1 = dkv
        want = cross_attention_kv_fused_bwd_split_plain(
            q, kv, do, lse, delta, seeds, rate, split_bounds(N, splits))
        for name, a, b in (("dq", dq, want[0]), ("dkv", dkv, want[1])):
            err, rel = _rel_err(a, b)
            check(rel <= limit, f"B3 {label} dq splits {splits} {name}: "
                  f"max abs err {err} is {rel} of its max > {limit}")
        errs[splits] = _rel_err(dq, want[0])[0]
        del dq, dq2, dkv2, want
    B, H, Q, _ = q.shape
    rule = _splits_for(q, N, Q, None)
    grid = (-(-Q // 128) * rule, H, B)     # the dq pass's launch grid
    ctas = grid[0] * H * B
    phase("kernels", f"B3 bfloat16 {label} q {tuple(q.shape)} N={N} rate "
          f"{rate} at every dq split, two launches equal bit for bit, dKV "
          "the same at every split; dq max abs err " + ", ".join(
              f"{k}: {v:.3e}" for k, v in errs.items())
          + f" (limit {limit} of its max); the rule picks {rule}: dq pass "
          f"grid {grid}, {ctas} CTAs")
    # several launches in one window: the tracer can miss a window's first
    # kernels, and a lone short launch sometimes shows none
    device_profile(lambda: [_flash_bwd(q, kv, do, lse, delta, seeds, rate,
                                       rule) for _ in range(5)],
                   f"5 B3 launches, {label} (the dkv pass, the dq pass in "
                   f"{rule} splits and, where it splits, the dq combine)",
                   top=3, label_phase="kernels")
    return rule, ctas


def check_building_blocks(gen):
    """hopper.cuh on one tile: a K-major x K-major product from shared
    memory, then its bf16 rounding from registers times an MN-major tile."""
    from parq_torch.kernels.cross_attention import wgmma_selftest
    a, b, v = (torch.randn(64, n, device="cuda", generator=gen).bfloat16()
               for n in (64, 64, 256))
    c1, c2 = wgmma_selftest(a, b, v)
    want1 = a.float() @ b.float().T
    want2 = want1.bfloat16().float() @ v.float()
    err1, err2 = _rel_err(c1, want1)[1], _rel_err(c2, want2)[1]
    check(err1 <= 1e-5 and err2 <= 1e-2, f"wgmma selftest: a·bᵀ off by "
          f"{err1} of its max (limit 1e-5), bf16(a·bᵀ)·v by {err2} (1e-2: "
          "a bf16 rounding of the first product that falls the other way)")
    phase("kernels", f"wgmma/TMA building blocks, one tile: a·bᵀ {err1:.2e} "
          f"of its max (limit 1e-5), bf16(a·bᵀ)·v {err2:.2e} (limit 1e-2)")


def seed_vector(G, gen):
    return torch.randint(0, 2 ** 31 - 1, (G,), device="cuda", generator=gen,
                         dtype=torch.int64).to(torch.int32)


def check_backward(q, kv, seeds, rate, limit, gen):
    """B3 against its plain version on (q, kv) with a random cotangent:
    dq and dKV to `limit` of their largest elements. Returns the larger
    max abs error."""
    from parq_torch.kernels import flash_bwd, flash_fwd_lse
    from parq_torch.kernels.cross_attention import (
        cross_attention_kv_fused_bwd_plain)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    o, lse = flash_fwd_lse(q, kv, seeds, rate)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_bwd(q, kv, do, lse, delta, seeds, rate)
    want = cross_attention_kv_fused_bwd_plain(q, kv, do, lse, delta, seeds,
                                              rate)
    worst = 0.0
    for name, a, b in (("dq", got[0], want[0]), ("dkv", got[1], want[1])):
        err, rel = _rel_err(a, b)
        check(rel <= limit, f"B3 {q.dtype} q {tuple(q.shape)} N="
              f"{kv.shape[1]} rate {rate} {name}: max abs err {err} is "
              f"{rel} of its max > {limit}")
        worst = max(worst, err)
        phase("kernels", f"B3 {str(q.dtype)[6:]} q {tuple(q.shape)} "
              f"N={kv.shape[1]} G={seeds.numel()} rate {rate}: {name} max "
              f"abs err {err:.3e} ({rel:.2e} of its max; limit {limit})")
    return worst


def train_kernels(cfg, gen, N):
    """B2's train form, B3 and B4 against their plain versions at the
    release training shapes (Q = L·256 = 2048 folded rows in 8 seed groups
    for B3 and B4). Returns the bf16 max abs errors at the release N."""
    from parq_torch.kernels import (flash_cross_attention_kv_fused,
                                    flash_fwd_lse, sample_views_bwd_mem)
    from parq_torch.kernels.cross_attention import (
        cross_attention_kv_fused_plain, cross_attention_kv_fused_train_plain)
    from parq_torch.kernels.pixel_align import sample_views_bwd_mem_plain
    Hh, D, Q0, L = cfg.dec_heads, cfg.dec_dim // cfg.dec_heads, \
        cfg.num_queries, cfg.dec_layers
    rate, errs = cfg.dropout_rate, {}
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, kv = attention_inputs(8, Hh, Q0, N, D, dtype, gen)
        seeds = seed_vector(1, gen)
        o, lse = flash_fwd_lse(q, kv, seeds, rate)
        o_ref, lse_ref = cross_attention_kv_fused_train_plain(q, kv, seeds,
                                                              rate)
        err = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        check(err <= atol and err_l <= 1e-4,
              f"B2-train {dtype}: o err {err} > {atol} or lse {err_l} > 1e-4")
        if dtype == torch.bfloat16:
            errs["B2-train"] = err
        phase("kernels", f"B2-train {str(dtype)[6:]} q {tuple(q.shape)} "
              f"rate {rate}: o max abs err {err:.3e} (atol {atol}), lse "
              f"{err_l:.3e} (atol 1e-4)")

        # folded: 8 seed groups in one call against 8 calls of one group
        qf, _ = attention_inputs(8, Hh, L * Q0, 1, D, dtype, gen)
        seeds = seed_vector(L, gen)
        of, lf = flash_fwd_lse(qf, kv, seeds, rate)
        for g in range(L):
            rows = slice(g * Q0, (g + 1) * Q0)
            og, lg = flash_fwd_lse(qf[:, :, rows].contiguous(), kv,
                                   seeds[g:g + 1], rate)
            check(torch.equal(of[:, :, rows], og)
                  and torch.equal(lf[:, :, rows], lg),
                  f"B2-train {dtype}: folded group {g} differs from its "
                  "separate call")
        phase("kernels", f"B2-train {str(dtype)[6:]} folded q "
              f"{tuple(qf.shape)} G={L}: o and lse equal bit for bit to "
              f"{L} separate calls")

        # B3 at the fold with dropout on and off, and at a ragged N
        for n, r in ((N, rate), (N, 0.0), (1000, rate)):
            kvn = kv if n == N else attention_inputs(8, Hh, 1, n, D, dtype,
                                                     gen)[1]
            worst = check_backward(qf, kvn, seeds, r, atol, gen)
            if dtype == torch.bfloat16 and n == N and r == rate:
                errs["B3"] = worst
        if dtype == torch.bfloat16:    # only the bf16 kernel splits dq
            check_dq_splits(qf, kv, seeds, rate, atol, gen, "release fold")

        # a Q that does not divide the 128-row tile, an N below one KV tile
        for n in (1000, 40):
            q, kvn = attention_inputs(2, Hh, 200, n, D, dtype, gen)
            err = _excess(flash_cross_attention_kv_fused(q, kvn),
                               cross_attention_kv_fused_plain(q, kvn))
            seeds8 = seed_vector(8, gen)       # 8 groups of 25 rows
            o, lse = flash_fwd_lse(q, kvn, seeds8, rate)
            o_ref, lse_ref = cross_attention_kv_fused_train_plain(
                q, kvn, seeds8, rate)
            err_t = _excess(o, o_ref)
            err_l = (lse - lse_ref).abs().max().item()
            check(max(err, err_t) <= atol and err_l <= 1e-4,
                  f"B2 {dtype} Q=200 N={n}: eval {err}, train {err_t} > "
                  f"{atol} or lse {err_l} > 1e-4")
            phase("kernels", f"B2 {str(dtype)[6:]} Q=200 N={n}: max abs err "
                  f"(bf16: beyond one bf16 step of the value): eval "
                  f"{err:.3e}, train (rate {rate}, G=8) {err_t:.3e} (atol "
                  f"{atol}), lse "
                  f"{err_l:.3e} (atol 1e-4)")
            for r in (rate, 0.0):
                check_backward(q, kvn, seeds8, r, atol, gen)

    # B4 at the fold, on three distributions of the rows
    mem_shape, g, dists = sampler_bwd_inputs(cfg, 8, gen)
    for name, uvs in dists.items():
        for dtype, atol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            got = sample_views_bwd_mem(uvs, g, mem_shape, dtype)
            again = sample_views_bwd_mem(uvs, g, mem_shape, dtype)
            check(torch.equal(got, again), f"B4 {dtype} {name}: two launches "
                  "on the same inputs differ")
            del again
            want = sample_views_bwd_mem_plain(uvs, g, mem_shape, dtype)
            err, rel = _rel_err(got, want)
            check(name != "off-image" or not bool(want.any()),
                  f"B4 {dtype} {name}: the plain result is not all zeros")
            check(rel <= atol, f"B4 {dtype} {name}: max abs err {err} is "
                  f"{rel} of its max > {atol}")
            if dtype == torch.bfloat16 and name == "release":
                errs["B4"] = err
            phase("kernels", f"B4 {str(dtype)[6:]} dmem {tuple(mem_shape)} "
                  f"Q={uvs.shape[2]} {name}: max abs err {err:.3e} "
                  f"({rel:.2e} of its max; limit {atol}); two launches equal "
                  "bit for bit")
            del got, want
    return errs


def natural_kv(kv, H):
    """The fused (B, N, H·2D) buffer's K and V as two natural (B, N, H·D)
    buffers (copies)."""
    from parq_torch.kernels.cross_attention import split_kv
    B, N = kv.shape[:2]
    return tuple(t.transpose(1, 2).reshape(B, N, -1).contiguous()
                 for t in split_kv(kv, H))


def legacy_kv(k_nat, v_nat, H, n_pad, gen):
    """Natural K and V as legacy (B, H, n_pad, D) buffers: the first N
    rows hold them, the rows past N random numbers the kernels must never
    read (as a caller's `pad_kv_for_flash` buffer holds zeros there)."""
    B, N, F = k_nat.shape
    out = []
    for t in (k_nat, v_nat):
        buf = torch.randn(B, H, n_pad, F // H, device="cuda",
                          generator=gen).to(t.dtype)
        buf[:, :, :N] = t.view(B, N, H, F // H).transpose(1, 2)
        out.append(buf)
    return out


def check_split(q, k, v, n_valid, seeds, rate, atol, gen, label, v2=False,
                backward=True):
    """B2-train and B3 on K/V views (natural or legacy buffers) against
    their plain versions: o to atol (beyond one bf16 step for bf16), lse
    to 1e-4, dq, dK and dV to atol of their maxima; dK and dV rows past
    n_valid stay zero. Returns (o err, worst backward err)."""
    from parq_torch.kernels import flash_bwd_kv, flash_fwd_lse_kv
    from parq_torch.kernels.cross_attention import (
        attention_bwd_plain, attention_train_plain, heads_view)
    H = q.shape[1]
    kh, vh = heads_view(k, H, n_valid), heads_view(v, H, n_valid)
    o, lse = flash_fwd_lse_kv(q, kh, vh, seeds, rate, v2=v2)
    o_ref, lse_ref = attention_train_plain(q, kh, vh, seeds, rate, v2=v2)
    err, err_l = _excess(o, o_ref), (lse - lse_ref).abs().max().item()
    check(err <= atol and err_l <= 1e-4, f"{label}: o err {err} > {atol} or "
          f"lse {err_l} > 1e-4")
    phase("kernels", f"{label} B2-train {str(q.dtype)[6:]} q "
          f"{tuple(q.shape)} k {tuple(k.shape)} n_valid {n_valid} G="
          f"{seeds.numel()} rate {rate}: o max abs err {err:.3e} (bf16: "
          f"beyond one bf16 step; atol {atol}), lse {err_l:.3e} (atol 1e-4)")
    if not backward:
        return err, 0.0
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    delta = (do.float() * o.float()).sum(-1)
    grads = {}
    for name, fn in (("kernel", flash_bwd_kv), ("plain", attention_bwd_plain)):
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        dq = fn(q, kh, vh, do, lse, delta, seeds, rate, heads_view(dk, H,
                n_valid), heads_view(dv, H, n_valid), v2=v2)
        grads[name] = (dq, dk, dv)
    worst = 0.0
    for i, what in enumerate(("dq", "dk", "dv")):
        e, rel = _rel_err(grads["kernel"][i], grads["plain"][i])
        check(rel <= atol, f"{label} B3 {what}: max abs err {e} is {rel} of "
              f"its max > {atol}")
        worst = max(worst, e)
        phase("kernels", f"{label} B3 {str(q.dtype)[6:]} q {tuple(q.shape)} "
              f"{what}: max abs err {e:.3e} ({rel:.2e} of its max; limit "
              f"{atol})")
    if k.dim() == 4 and k.shape[2] > n_valid:
        check(not grads["kernel"][1][:, :, n_valid:].any()
              and not grads["kernel"][2][:, :, n_valid:].any(),
              f"{label} B3: rows past n_valid were written")
    return err, worst


def split_kernels(cfg, gen, N):
    """B2-train and B3 on separate K and V at the release widths: the
    natural layout at an SP shard's N/2 tokens (Q=256, and Q=2048 in 8
    seed groups for B3), the legacy layout padded past n_valid, the v2
    dropout hash; a fused and a split call on the same K/V values agree;
    a call on rows 4-7 with b_offset 4 equals those rows of the call over
    all 8, bit for bit. Returns the bf16 errors of the JSON rows."""
    from parq_torch.kernels import flash_bwd, flash_fwd_lse, flash_fwd_lse_kv
    from parq_torch.kernels.cross_attention import (
        _flash_bwd, _flash_fwd_lse, _splits_for,
        cross_attention_kv_fused_bwd_plain,
        cross_attention_kv_fused_train_plain, heads_view)
    Hh, D, Q0, L = cfg.dec_heads, cfg.dec_dim // cfg.dec_heads, \
        cfg.num_queries, cfg.dec_layers
    rate, errs, n_sp = cfg.dropout_rate, {}, N // 2
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, kv = attention_inputs(8, Hh, Q0, n_sp, D, dtype, gen)
        k, v = natural_kv(kv, Hh)
        s1, sL = seed_vector(1, gen), seed_vector(L, gen)
        err, _ = check_split(q, k, v, n_sp, s1, rate, atol, gen,
                             "split natural", backward=False)
        qf, _ = attention_inputs(8, Hh, L * Q0, 1, D, dtype, gen)
        err_f, worst = check_split(qf, k, v, n_sp, sL, rate, atol, gen,
                                   "split natural folded")
        # a fused and a split call on the same values
        o_f, l_f = flash_fwd_lse(q, kv, s1, rate)
        o_s, l_s = flash_fwd_lse_kv(q, heads_view(k, Hh, n_sp),
                                    heads_view(v, Hh, n_sp), s1, rate)
        d_o = (o_f.float() - o_s.float()).abs().max().item()
        d_l = (l_f - l_s).abs().max().item()
        check(d_o <= atol and d_l <= 1e-4, f"fused vs split {dtype}: o "
              f"{d_o}, lse {d_l}")
        phase("kernels", f"fused vs split B2-train {str(dtype)[6:]}, the same "
              f"K/V values: o differ by {d_o:.3e}, lse by {d_l:.3e} (equal "
              f"bit for bit: {torch.equal(o_f, o_s) and torch.equal(l_f, l_s)})")
        # legacy (B, H, N_pad, D) buffers, n_valid < N_pad
        k_leg, v_leg = legacy_kv(k, v, Hh, -(-n_sp // 1920) * 1920 + 1920,
                                 gen)
        err_leg, worst_leg = check_split(qf, k_leg, v_leg, n_sp, sL, rate,
                                         atol, gen, "legacy")
        # the v2 hash, fused and split
        err_v2, worst_v2 = check_split(qf, k, v, n_sp, sL, rate, atol, gen,
                                       "v2 split", v2=True)
        o2, lse2 = flash_fwd_lse(q, kv, s1, rate, v2=True)
        o2_ref, lse2_ref = cross_attention_kv_fused_train_plain(
            q, kv, s1, rate, v2=True)
        err2 = _excess(o2, o2_ref)
        check(err2 <= atol and (lse2 - lse2_ref).abs().max().item() <= 1e-4,
              f"v2 fused B2-train {dtype}: o err {err2}")
        do = torch.randn(qf.shape, device="cuda", generator=gen).to(dtype)
        of, lf = flash_fwd_lse(qf, kv, sL, rate, v2=True)
        delta = (do.float() * of.float()).sum(-1)
        got = flash_bwd(qf, kv, do, lf, delta, sL, rate, v2=True)
        want = cross_attention_kv_fused_bwd_plain(qf, kv, do, lf, delta, sL,
                                                  rate, v2=True)
        rel2 = max(_rel_err(a, b)[1] for a, b in zip(got, want))
        check(rel2 <= atol, f"v2 fused B3 {dtype}: {rel2} of its max")
        phase("kernels", f"v2 fused {str(dtype)[6:]}: B2-train o max abs err "
              f"{err2:.3e} (atol {atol}); B3 {rel2:.2e} of its max (limit "
              f"{atol})")
        # b_offset: rows 4-7 of the global call, bit for bit, at the
        # global call's KV splits (both rules count the call's CTAs)
        sp = _splits_for(q, n_sp, Q0, None)
        o_all, l_all = _flash_fwd_lse(q, kv, s1, rate, sp)
        o_4, l_4 = _flash_fwd_lse(q[4:], kv[4:], s1, rate, sp, b_offset=4)
        dq_all, dkv_all = _flash_bwd(q, kv, o_all, l_all, l_all, s1, rate,
                                     sp)
        dq_4, dkv_4 = _flash_bwd(q[4:], kv[4:], o_all[4:], l_all[4:],
                                 l_all[4:], s1, rate, sp, b_offset=4)
        check(torch.equal(o_all[4:], o_4) and torch.equal(l_all[4:], l_4)
              and torch.equal(dq_all[4:], dq_4)
              and torch.equal(dkv_all[4:], dkv_4),
              f"b_offset {dtype}: rows 4-7 differ from the global call")
        phase("kernels", f"b_offset {str(dtype)[6:]}: B2-train and B3 on rows "
              "4-7 with b_offset 4 equal rows 4-7 of the call over all 8, bit "
              "for bit")
        if dtype == torch.bfloat16:
            errs.update({"flash_cross_attention_fwd_train_split": err,
                         "flash_cross_attention_bwd_split": worst,
                         "flash_cross_attention_fwd_train_legacy": err_leg,
                         "flash_cross_attention_bwd_legacy": worst_leg,
                         "flash_cross_attention_fwd_train_v2": err2,
                         "flash_cross_attention_bwd_v2": worst_v2})
        del qf, kv, k, v, k_leg, v_leg
    return errs


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"/detect answered {r.status}")
        return json.loads(r.read())


def serve_requests(engine, requests, what="serve"):
    """`requests` /detect requests of the served batch over HTTP: (answers,
    launch counts set to 0 just before the first and read just after the
    last). Every answer has the batch's samples and finite detections."""
    from parq_torch.data.synthetic import make_batch
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import BATCH_KEYS
    from parq_torch.serve import build_server
    cfg, batch_size = engine.cfg.model, engine.batch_size
    server = build_server(engine)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            check(json.loads(r.read()) == {"status": "ok"}, "/healthz")
        bodies = [{k: v for k, v in make_batch(
            list(range(i * batch_size, (i + 1) * batch_size)),
            image_size=cfg.image_size, num_views=cfg.num_views).items()
            if k in BATCH_KEYS} for i in range(requests)]
        reset_launch_counts()
        answers = [_post(url + "/detect", b) for b in bodies]
        counts = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), f"{what}: server thread did not stop")
    n_dets = 0
    for ans in answers:
        check(len(ans["detections"]) == batch_size,
              f"{what}: response batch size")
        for dets in ans["detections"]:
            for d in dets:
                n_dets += 1
                vals = [d["score"], *d["center"], *d["size"],
                        *np.ravel(d["corners_world"])]
                check(all(math.isfinite(v) for v in vals),
                      f"{what}: non-finite detection")
    return answers, counts, n_dets


def check_serve_counts(counts, cfg, requests, what, body_sites=None):
    """Each serving kernel launched L times a request, the frozen-BN pass
    `body_sites` times (a bf16 ResNet-50 forward's `BODY_SITES` unless
    given), parse_pred's NMS once, nothing else."""
    from parq_torch.kernels import SERVE_KERNELS
    body_sites = BODY_SITES if body_sites is None else body_sites
    for name, n in counts.items():
        want = requests * (cfg.dec_layers if name in SERVE_KERNELS
                           else body_sites if name == "frozen_bn"
                           else 1 if name == "nms" else 0)
        check(n == want, f"{what}: {name}: {n} launches in {requests} "
              f"requests, want {want}")


def phase_serve(serve_cfg, batch_size, requests=3):
    from parq_torch.serve import Engine
    cfg = serve_cfg.model
    t0 = time.perf_counter()
    engine = Engine(serve_cfg, batch_size=batch_size, device="cuda", seed=0)
    phase("serve", f"engine ready in {time.perf_counter() - t0:.1f} s: "
          f"{cfg.resnet_name} {cfg.num_views}x{cfg.image_size} "
          f"L={cfg.dec_layers} Q={cfg.num_queries} dim={cfg.dec_dim} "
          f"B={batch_size} {cfg.compute_dtype}")
    check(len(engine._call) == 1, "serve: the engine's warm-up captured "
          f"{len(engine._call)} graphs, want 1")
    # a replay runs no Python: drop the capture, so that the first request
    # runs eagerly and captures again under the hook
    mem_dtypes, hook = watch_memory_dtype(engine.model)
    engine._call.reset()
    try:
        _, counts, n_dets = serve_requests(engine, requests)
    finally:
        hook.remove()
    check_serve_counts(counts, cfg, requests, "serve")
    want_dtype = getattr(torch, cfg.compute_dtype)
    check(mem_dtypes == [want_dtype] * 2, f"serve: the decoder's memory "
          f"came as {mem_dtypes}, want {want_dtype} in the first request's "
          "eager forward and capture")
    out = engine.forward(engine.example)
    L, B, Q = cfg.dec_layers, batch_size, cfg.num_queries
    check(out["pred_logits"].shape == (L, B, Q, cfg.num_semcls + 1),
          f"pred_logits shape {tuple(out['pred_logits'].shape)}")
    for k, v in out.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"non-finite output {k}")
    phase("serve", f"{requests} /detect requests answered, {n_dets} "
          f"detections, outputs finite; launches {counts} "
          f"({cfg.dec_layers} per request, the frozen-BN pass "
          f"{counts['frozen_bn'] // requests}); token memory in "
          f"{cfg.compute_dtype}")
    return engine, counts, requests


def phase_parity(cfg):
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.models import BATCH_KEYS, build_model
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = make_batch([5], image_size=f32.image_size)
    outs = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dev in ("cuda", "cpu"):
        model = build_model(f32, seed=1, device=dev)
        with torch.inference_mode():
            outs[dev] = model(to_device(batch, BATCH_KEYS, dev))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    worst = {}
    for k, v in outs["cuda"].items():
        got, want = v[-1].cpu(), outs["cpu"][k][-1]
        if got.dtype == torch.bool:
            check(torch.equal(got, want), f"parity: {k} differs")
            continue
        err = (got - want).abs().max().item()
        worst[k] = err
        check(err <= 2e-3, f"parity: {k} max abs err {err} > 2e-3")
    phase("parity", "card (kernels) vs CPU (plain), B=1 f32, TF32 off, "
          "last iteration, max abs err: "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items())))


def device_profile(run, label, top=8, label_phase="times"):
    """One call of `run` under torch.profiler (`tools/profiling.py`):
    device time by kernel name, and the device's busy share of the
    profiled call's wall time. A window in which the tracer saw no kernel
    is profiled again, up to three times in all."""
    from parq_torch.tools.profiling import device_profile as profile_call
    for _ in range(3):
        prof = profile_call(run)
        if prof is not None:
            break
    if prof is None:
        phase(label_phase, f"profiler saw no device time in the {label}: "
              "breakdown not measured")
        return
    wall_ms, busy_ms, kernels = prof["wall_ms"], prof["busy_ms"], \
        prof["kernels"]
    phase(label_phase, f"profiled {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels)} kernel names")
    for name, ms, n in kernels[:top]:
        phase(label_phase, f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{n} "
              f"{name[:90]}")


def phase_train(cfg, steps=5):
    """The release training step, B=8 bf16, through the entry point's
    graphed step (`make_graphed_train_step`: step 0 runs eagerly and
    captures the graph, steps 1.. replay it): finite metrics, moving
    parameters, the training kernels' launches per step (a replay adds
    those its capture recorded), step time, the syncs of a replay, and one
    profiled replay."""
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.tools.syncs import count_syncs
    from parq_torch.train.__main__ import build, synthetic_batches
    from parq_torch.train.train_step import make_graphed_train_step
    B = 8
    t0 = time.perf_counter()
    net, opt = build("release", "bfloat16", seed=0, device="cuda")
    batches = synthetic_batches(net.cfg, B, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    train_step = make_graphed_train_step(net, opt)
    before = [p.detach().clone() for p in net.parameters()]
    phase("train", f"model and batches ready in {time.perf_counter() - t0:.1f}"
          f" s: {cfg.resnet_name} L={cfg.dec_layers} Q={cfg.num_queries} "
          f"dim={cfg.dec_dim} B={B} bfloat16, dropout "
          f"{net.cfg.dropout_rate}, AdamW lr 1e-4, clip 1.0")
    mem_dtypes, hook = watch_memory_dtype(net)
    reset_launch_counts()
    ms = []
    for step in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = train_step(batches[step % len(batches)], gen)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        loss, norm = float(m["total_loss"]), float(m["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(norm),
              f"train step {step}: loss {loss}, grad norm {norm}")
        phase("train", f"step {step}: loss {loss:.5f} grad_norm {norm:.4f} "
              f"valid_bs {float(m['valid_bs']):.0f} ({ms[-1]:.1f} ms"
              f"{', eager + capture' if step == 0 else ', replay'})")
    counts = launch_counts()
    hook.remove()
    check(len(train_step) == 1, f"train: {len(train_step)} graphs captured")
    # a replay runs no Python: the forward hook sees the capture's forward
    check(mem_dtypes == [torch.bfloat16] * 2, f"train: the decoder's "
          f"memory came as {mem_dtypes}, want bfloat16 in the eager step "
          "and the capture (B1 and B4 take the memory's dtype)")
    want = dict(TRAIN_KERNELS, pixel_align_sample=cfg.dec_layers,
                flash_cross_attention_fwd_train=cfg.dec_layers,
                dropout_keep_mask=5 * cfg.dec_layers + 5)
    for name, n in counts.items():
        check(n == want[name] * steps, f"train: {name} launched {n} times "
              f"in {steps} steps, want {want[name]} per step")
    moved = sum(float((p.detach() - b).abs().sum())
                for p, b in zip(net.parameters(), before))
    check(moved > 0 and math.isfinite(moved), f"parameters moved {moved}")
    n_sync, sites = count_syncs(lambda: train_step(batches[0], gen))
    check(n_sync == 0, f"train: a replayed step synchronizes with the host "
          f"{n_sync} times: {dict(sites)}")
    phase("train", f"synchronizing operations in one replayed train step "
          f"(sync debug mode 'warn'): {n_sync}")
    step_ms = sum(ms[1:]) / len(ms[1:])
    phase("train", f"{steps} steps, launches {counts} (per step: {want}); "
          f"sum |Δparams| {moved:.4g}; step {step_ms:.2f} ms from CUDA "
          f"events over the replays 1-{steps - 1} (step 0, eager + "
          f"capture: {ms[0]:.1f} ms; {1e3 * B / step_ms:.2f} samples/s)")
    device_profile(lambda: train_step(batches[0], gen),
                   "train step (replay)")
    return counts, step_ms


def phase_train_parity(cfg, label="train-parity"):
    """Gradients on the card (kernels) against the CPU (plain versions):
    B=1, f32, TF32 off, dropout 0, release widths at L=2 (depth cut so the
    CPU side fits the time limit); the same weights, batch and matcher
    draws. `label` names the phase (`unshared`: the same with
    SHARE_WEIGHTS False in `cfg`)."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.models import build_model
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import forward_and_loss
    f32 = dataclasses.replace(cfg, compute_dtype="float32", dropout_rate=0.0,
                              dec_layers=2)
    raw = make_batch([5], image_size=f32.image_size)
    u = torch.rand((f32.dec_layers, f32.num_queries,
                    raw["obbs_padded"].shape[1]),
                   generator=torch.Generator().manual_seed(0))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(f32, seed=1, device=dev).train()
        lo, _ = forward_and_loss(model, to_device(raw, TRAIN_KEYS, dev),
                                 None, uniforms=u)
        lo["total_loss"].backward()
        losses[dev] = {k: float(v.detach()) for k, v in lo.items()}
        grads[dev] = {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()}
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    for k, v in losses["cpu"].items():
        check(abs(losses["cuda"][k] - v) <= 1e-3 * max(abs(v), 1.0),
              f"{label}: {k} {losses['cuda'][k]} vs {v}")
    total = math.sqrt(sum(float(g.norm()) ** 2
                          for g in grads["cpu"].values()))
    worst, worst_name = 0.0, ""
    for n, g in grads["cpu"].items():
        err = float((grads["cuda"][n] - g).norm())
        check(err <= 5e-3 * float(g.norm()) + 1e-6 * total,
              f"{label}: {n} gradient off by {err} (norm "
              f"{float(g.norm())})")
        rel = err / max(float(g.norm()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    phase(label, f"card (kernels) vs CPU (plain), B=1 f32, TF32 off, "
          f"dropout 0, L=2, shared weights {f32.share_weights}: loss "
          f"{losses['cuda']['total_loss']:.6f} vs "
          f"{losses['cpu']['total_loss']:.6f}; {len(grads['cpu'])} "
          f"gradients, worst ‖Δ‖/‖g‖ {worst:.2e} ({worst_name}); limit "
          f"5e-3·‖g‖ + 1e-6·‖G‖, ‖G‖ = {total:.4g}")


# ------------------------------------------------------------ the graphs --
def _keep_shapes(cfg, B):
    """The keep masks of a release step as the decoder draws them: (name,
    rows, groups, columns) of one launch, per iteration (G=1) and folded
    (G=L)."""
    Q, D, F, H = cfg.num_queries, cfg.dec_dim, cfg.dec_ffn_dim, cfg.dec_heads
    out = []
    for G in (1, cfg.dec_layers):
        out += [(f"self-attention weights G={G}", B, G, H * Q * Q),
                (f"residual G={G}", B, G, Q * D),
                (f"FFN G={G}", B, G, Q * F)]
    return out


def keep_mask_row(cfg, train_counts):
    """The keep-mask kernel against its plain version (`keep_mask`, int64
    on the card) at every release mask shape, bit for bit; its ms beside the
    plain version's and beside `torch.rand` + a compare (what the port
    drew before, with other bits); the record row at the fold's
    self-attention mask (its largest)."""
    from parq_torch.kernels.dropout import draw_keep, draw_keep_plain
    gen = torch.Generator(device="cuda").manual_seed(3)
    rate = cfg.dropout_rate
    seeds = torch.randint(0, 2 ** 62, (cfg.dec_layers, 6), device="cuda",
                          generator=gen)
    row = None
    for name, B, G, M in _keep_shapes(cfg, 8):
        s = seeds[:G, 0]
        got = draw_keep(s, B, 0, M, rate)
        want = draw_keep_plain(s, B, 0, M, rate)
        check(torch.equal(got, want), f"keep mask {name}: kernel differs "
              "from keep_mask")
        ms = device_ms(lambda: draw_keep(s, B, 0, M, rate), 10)
        rand_ms = device_ms(lambda: torch.rand(
            (B, G * M), device="cuda") < 1.0 - rate, 10)
        plain_ms = cuda_ms(lambda: draw_keep_plain(s, B, 0, M, rate), 2)
        bound = B * G * M / HBM_BYTES_PER_S * 1e3     # one byte written
        kept = float(got.float().mean())
        phase("graphs", f"keep mask {name} ({B}x{G}x{M}): equal to "
              f"keep_mask bit for bit, kept {kept:.5f}; kernel {ms:.4f} ms, "
              f"bound {bound:.4f} ms (bytes), torch.rand + compare "
              f"{rand_ms:.4f} ms, plain {plain_ms:.4f} ms")
        if G > 1 and M == cfg.dec_heads * cfg.num_queries ** 2:
            row = dict(name="dropout_keep_mask", route="cuda",
                       source="parq_torch/csrc/dropout.cu",
                       replaces="parq_tpu/models/decoder.py:76 "
                       "(_grouped_keep: jax.random, no pallas_call)",
                       launches=train_counts["dropout_keep_mask"],
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by="bytes", library_ms=None)
    return row


def _graph_times(label, eager, graphed, reps):
    """Wall ms (CUDA events over `reps` back-to-back calls, the host's work
    included) and device-busy ms (one profiled call, tools/profiling.py) of
    an eager call and of a replay."""
    from parq_torch.tools.profiling import device_profile as profile_call
    out = {}
    for kind, fn in (("eager", eager), ("graph", graphed)):
        wall = cuda_ms(fn, reps)
        prof = None
        for _ in range(3):
            prof = profile_call(fn)
            if prof is not None:
                break
        out[kind] = (wall, None if prof is None else prof["busy_ms"])
    phase("graphs", f"{label}: " + "; ".join(
        f"{k} wall {w:.2f} ms, device busy "
        + ("not measured" if b is None else f"{b:.2f} ms")
        for k, (w, b) in out.items()))
    return out


def _f32_graph_gate(cfg):
    """3 replayed f32 steps (B=1, TF32 off, L=2, dropout 0.1) against 3
    eager steps, each from the same weights, AdamW state and generator
    state (the eager model's, copied in place into the captured one before
    each replay): the losses, and every parameter's clipped gradient to the
    train-parity tolerance (‖Δ‖ ≤ 5e-3·‖g‖ + 1e-6·‖G‖); every updated
    parameter to the same tolerance of its update where Adam's step is
    well posed (|g| > max(2·|Δg|, 1e-6): Adam's first step is
    lr·g/(|g| + eps), so where a gradient is within its own rounding, as
    the card's atomics leave it from run to run, the step takes either
    sign) and within 2·lr anywhere; the flash seeds bit for bit."""
    from parq_torch.models import build_model
    from parq_torch.models.decoder import DropoutDraws
    from parq_torch.train.__main__ import synthetic_batches
    from parq_torch.train.train_step import (make_graphed_train_step,
                                             make_optimizer, train_step)
    f32 = dataclasses.replace(cfg, compute_dtype="float32", dec_layers=2,
                              dropout_rate=0.1)
    batches = synthetic_batches(f32, 1, "cuda", n_batches=3)
    record = []
    orig = DropoutDraws.flash_seeds

    def recording(self, groups):
        out = orig(self, groups)
        record.append(out)
        return out
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    DropoutDraws.flash_seeds = recording
    try:
        models = [build_model(f32, seed=1, device="cuda").train()
                  for _ in range(2)]
        opts = [make_optimizer(m, lr=1e-4, capturable=True)
                for m in models]
        gens = [torch.Generator(device="cuda") for _ in range(2)]
        step = make_graphed_train_step(models[0], opts[0])
        step(batches[0], gens[0].manual_seed(99))    # eager + capture
        static = record[len(record) // 2:]   # the capture's seed tensors
        check(len(step) == 1 and len(static) == f32.dec_layers + 1,
              f"graphs f32: {len(step)} captures, {len(static)} seed calls")
        rows = []
        for i in range(3):
            with torch.no_grad():   # the eager model's state, in place
                for pg, pe in zip(*(m.parameters() for m in models)):
                    pg.copy_(pe)
                    sg, se = opts[0].state[pg], opts[1].state.get(pe, {})
                    for k, v in sg.items():
                        v.copy_(se[k]) if k in se else v.zero_()
            start = [p.detach().clone() for p in models[1].parameters()]
            record.clear()
            m_e = train_step(models[1], opts[1], batches[i],
                             gens[1].manual_seed(7 + i))
            seeds_e = list(record)
            m_g = step(batches[i], gens[0].manual_seed(7 + i))
            torch.cuda.synchronize()
            rows.append((float(m_g["total_loss"]), float(m_e["total_loss"]),
                         [t.clone() for t in static], seeds_e, start,
                         [[p.detach().clone() for p in m.parameters()]
                          for m in models],
                         [[p.grad.clone() for p in m.parameters()]
                          for m in models]))
    finally:
        DropoutDraws.flash_seeds = orig
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    worst_g = worst_p = 0.0
    for i, (lg, le, sg, se, start, (pg, pe), (gg, ge)) in enumerate(rows):
        check(abs(lg - le) <= 1e-3 * max(abs(le), 1.0),
              f"graphs f32 step {i}: loss {lg} vs eager {le}")
        check(len(sg) == len(se) and all(
            torch.equal(a, b) for a, b in zip(sg, se)),
            f"graphs f32 step {i}: flash seeds {sg} vs {se}")
        total_g = math.sqrt(sum(float(g.norm()) ** 2 for g in ge))
        upd = [e - s0 for e, s0 in zip(pe, start)]
        posed = [g.abs() > torch.clamp(2 * (a - g).abs(), min=1e-6)
                 for a, g in zip(gg, ge)]
        total_u = math.sqrt(sum(float((u * m).norm()) ** 2
                                for u, m in zip(upd, posed)))
        for a, g, x, y, u, m in zip(gg, ge, pg, pe, upd, posed):
            err = float((a - g).norm())
            check(err <= 5e-3 * float(g.norm()) + 1e-6 * total_g,
                  f"graphs f32 step {i}: a gradient off by {err} (its norm "
                  f"{float(g.norm())})")
            worst_g = max(worst_g, err / max(float(g.norm()), 1e-30))
            d = (x - y).abs()
            err = float((d * m).norm())
            check(err <= 5e-3 * float((u * m).norm()) + 1e-6 * total_u
                  and float(d.max()) <= 2 * 1e-4 + 1e-6,
                  f"graphs f32 step {i}: a parameter off by {err} where "
                  f"Adam's step is well posed, {float(d.max())} anywhere")
            worst_p = max(worst_p, err / max(float((u * m).norm()), 1e-30))
    phase("graphs", f"f32 (B=1, TF32 off, L=2, dropout 0.1): 3 replays vs "
          f"3 eager steps from the same state, losses "
          + ", ".join(f"{lg:.7f}/{le:.7f}" for lg, le, *_ in rows)
          + f"; flash seeds equal bit for bit; worst gradient ‖Δ‖/‖g‖ "
          f"{worst_g:.2e} (limit 5e-3·‖g‖ + 1e-6·‖G‖); worst updated "
          f"parameter ‖Δ‖/‖u‖ {worst_p:.2e} where Adam's step is well posed "
          "(|g| > max(2·|Δg|, 1e-6); the same limit), within 2·lr anywhere")


def _adamw_gate():
    """One step of the port's capturable AdamW (lr a device tensor) against
    torch's plain AdamW (lr a float) on the same parameters and
    gradients: the updated parameters to 1e-6 relative."""
    from parq_torch.train.train_step import make_optimizer
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(1024, 1024), (768, 1024), (1024,)]
    ps = [torch.randn(s, device="cuda", generator=gen) * 0.03 for s in shapes]
    gs = [torch.randn(s, device="cuda", generator=gen) * 1e-3 for s in shapes]
    mods = []
    for _ in range(2):
        m = torch.nn.ParameterList([torch.nn.Parameter(p.clone())
                                    for p in ps])
        for p, g in zip(m, gs):
            p.grad = g.clone()
        mods.append(m)
    cap = make_optimizer(mods[0], lr=1e-4, capturable=True)
    check(cap.defaults["capturable"] and torch.is_tensor(
        cap.param_groups[0]["lr"]), "graphs: make_optimizer on the card is "
          "not capturable with a tensor lr")
    plain = torch.optim.AdamW(list(mods[1]), lr=1e-4, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=0.01)
    cap.step()
    plain.step()
    with torch.no_grad():
        rel = max(float((a - b).norm() / b.norm())
                  for a, b in zip(mods[0], mods[1]))
        upd = max(float((a - b).norm() / (b - p0).norm())
                  for a, b, p0 in zip(mods[0], mods[1], ps))
    check(rel <= 1e-6, f"graphs: capturable AdamW's parameters off by {rel} "
          "relative")
    phase("graphs", f"capturable AdamW vs plain, one step: parameters "
          f"within {rel:.2e} relative (limit 1e-6); the updates themselves "
          f"within {upd:.2e} (f32 bias corrections on the card)")


def phase_graphs(cfg, smi_line):
    """The counterpart of jax.jit: the syncs of one eager release step and
    of one eager forward (0 each), the graphed forward equal to the eager
    one bit for bit, eager against graph timings, the f32 step gate, the
    capturable AdamW, the keep-mask kernel."""
    from parq_torch.graphs import Graphed
    from parq_torch.models import BATCH_KEYS
    from parq_torch.tools.syncs import count_syncs
    from parq_torch.train.__main__ import build, synthetic_batches
    from parq_torch.train.train_step import (make_graphed_train_step,
                                             train_step)
    t0 = time.perf_counter()
    B = 8
    net, opt = build("release", "bfloat16", seed=0, device="cuda")
    batches = synthetic_batches(net.cfg, B, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    train_step(net, opt, batches[0], gen)       # builds, AdamW's state
    n_step, sites = count_syncs(lambda: train_step(net, opt, batches[1], gen))
    check(n_step == 0, f"graphs: an eager release step synchronizes "
          f"{n_step} times: {dict(sites)}")
    net.eval()
    x = {k: batches[0][k] for k in BATCH_KEYS}
    with torch.inference_mode():
        want = net(x)
        n_fwd, fsites = count_syncs(lambda: net(x))
        check(n_fwd == 0, f"graphs: an eager forward synchronizes {n_fwd} "
              f"times: {dict(fsites)}")
        fwd = Graphed(net)
        fwd(x)                                   # eager + capture
        got = fwd(x)                             # a replay
        for k, v in want.items():
            check(torch.equal(got[k], v), f"graphs: replayed forward {k} "
                  "differs from the eager forward")
        n_rep, _ = count_syncs(lambda: fwd(x))
        phase("graphs", f"syncs: one eager release step (B={B} bf16, dropout "
              f"{net.cfg.dropout_rate}) {n_step} (16 before the port's graph "
              f"layer), one eager forward {n_fwd}, one replayed forward "
              f"{n_rep}; the replayed forward equals the eager one bit for "
              f"bit ({len(want)} outputs)")
        fwd_times = _graph_times(f"[{smi_line}] forward B={B} bf16",
                                 lambda: net(x), lambda: fwd(x), 10)
    del fwd, got, want
    net.train()
    step = make_graphed_train_step(net, opt)
    step(batches[0], gen)                        # eager + capture
    n_rep, _ = count_syncs(lambda: step(batches[1], gen))
    check(n_rep == 0, f"graphs: a replayed step synchronizes {n_rep} times")
    step_times = _graph_times(
        f"[{smi_line}] train step B={B} bf16", lambda: train_step(
            net, opt, batches[0], gen), lambda: step(batches[0], gen), 5)
    del step, net, opt, batches
    torch.cuda.empty_cache()
    _f32_graph_gate(cfg)
    _adamw_gate()
    phase("graphs", f"phase {time.perf_counter() - t0:.1f} s")
    return fwd_times, step_times


# ------------------------------------------------------------ the matcher --
def matcher_inputs(cfg, batch, L, gen, n_valid=None):
    """The matcher's inputs for the L·B (iteration, sample) pairs of a
    train batch: random logits and reference points, the batch's own
    targets repeated over the L iterations or, with `n_valid`, that many
    valid targets a pair at random centers. Queries 1-5 copy query 0 next
    to target 0: exact ties, the same on either device."""
    from parq_torch.geometry import Obb3D, Pose
    from parq_torch.losses import parse_targets
    t = parse_targets(Obb3D(batch["obbs_padded"]),
                      Pose(batch["T_world_local"]), batch.get("sym"))
    labels, center, valid = (x.repeat((L,) + (1,) * (x.dim() - 1))
                             for x in (t.labels, t.center, t.valid))
    LB, K = labels.shape
    Q = cfg.num_queries
    if n_valid is not None:
        valid = (torch.arange(K, device="cuda") < n_valid)[None].expand(
            LB, K).contiguous()
        center = torch.rand((LB, K, 3), device="cuda", generator=gen) * 4 - 2
        labels = torch.where(valid, torch.randint(
            0, cfg.num_semcls, (LB, K), device="cuda", generator=gen), -1)
    logits = torch.randn((LB, Q, cfg.num_semcls + 1), device="cuda",
                         generator=gen)
    coord = torch.rand((LB, Q, 3), device="cuda", generator=gen) * 4 - 2
    coord[:, :6] = center[:, :1] + 0.05
    logits[:, 1:6] = logits[:, :1]
    return logits, coord, labels, center, valid


def host_lap_route(cost, valid):
    """The matcher's assignment before M1: the (LB, Q, K) costs to the
    host, one scipy LAP a pair over its valid targets, the (LB, Q)
    assignment back to the card."""
    from scipy.optimize import linear_sum_assignment
    cost_np, valid_np = cost.cpu().numpy(), valid.cpu().numpy()
    LB, Q, K = cost_np.shape
    hung = np.full((LB, Q), -1, np.int64)
    for i in range(LB):
        idx = np.flatnonzero(valid_np[i])
        if idx.size == 0:
            continue
        if K <= Q:
            rows, cols = linear_sum_assignment(cost_np[i][:, idx].T)
            hung[i, cols] = idx[rows]
        else:
            rows, cols = linear_sum_assignment(cost_np[i][:, idx])
            hung[i, rows] = idx[cols]
    return torch.from_numpy(hung).to(cost.device)


def lap_bound_ms(rows, n_rows, row_reads):
    """M1's bound: the bytes its searches must move (each cost row a
    search step reads, n_rows, the output) over the card's memory rate.
    The search is a chain of dependent steps, bound by latency: the bound
    says how far from bytes it is, not what it could reach."""
    P, R, C = rows.shape
    nbytes = row_reads * C * 4 + n_rows.numel() * 4 + P * R * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_lap(label, rows, n_rows):
    """M1 on the card against its plain version on the CPU on the same
    costs, bit for bit; the totals against scipy's to 1e-5 relative.
    Returns the largest |col4row - plain| (0, or the check fails) and the
    number of cost rows the searches read."""
    from scipy.optimize import linear_sum_assignment
    from parq_torch.kernels.lap import solve_lap, solve_lap_plain
    got = solve_lap(rows, n_rows).cpu()
    stats = {}
    want = solve_lap_plain(rows.cpu(), n_rows.cpu(), stats)
    diff = (got.long() - want.long()).abs().max().item()
    check(diff == 0, f"matcher: M1 {label} differs from the plain version "
          f"({int((got != want).sum())} rows)")
    cost = rows.double().cpu().numpy()
    worst = 0.0
    for p, n in enumerate(n_rows.tolist()):
        if n == 0:
            continue
        r, c = linear_sum_assignment(cost[p, :n])
        want_total = cost[p, r, c].sum()
        total = cost[p, np.arange(n), got[p, :n].numpy()].sum()
        worst = max(worst, abs(total - want_total) / max(abs(want_total),
                                                          1e-30))
    check(worst <= 1e-5, f"matcher: M1 {label} totals off scipy's by "
          f"{worst:.2e} (limit 1e-5 relative)")
    phase("matcher", f"M1 {label} {tuple(rows.shape)}, n_rows "
          f"{sorted(set(n_rows.tolist()))}: col4row equal to the plain "
          f"version bit for bit; totals vs scipy worst {worst:.2e} relative "
          f"(limit 1e-5); {stats['row_reads']} cost rows read")
    return diff, stats["row_reads"]


def phase_matcher(cfg, scaled_cfg, smi_line):
    """Kernel M1 against its plain version (release shapes with mixed
    n_rows, the tied K > Q shape), `match_batch` on the card under sync
    debug mode "error" against the CPU, and M1's times beside the host
    route it replaced; each timed problem is also held against the plain
    version. Returns the kernels' record rows of M1 (release and
    scaled), launches to be filled from the main path."""
    from parq_torch.kernels.lap import solve_lap, solve_lap_plain
    from parq_torch.ops.hungarian import lap_problem, match_batch, match_cost
    from parq_torch.train.__main__ import TRAIN_KEYS, synthetic_batches
    gen = torch.Generator(device="cuda").manual_seed(5)
    L, B, K = cfg.dec_layers, 8, 100
    batch = synthetic_batches(cfg, B, "cuda")[0]

    # M1 vs plain: the release problem (rows = targets), n_rows mixed
    inputs = matcher_inputs(cfg, batch, L, gen, n_valid=K)
    cost, _ = match_cost(*inputs[:4])
    rows, _ = lap_problem(cost, inputs[4])
    mix = torch.tensor([0, 1, 3, 20, 100], dtype=torch.int32)
    n_mix = mix[torch.arange(L * B) % 5].cuda()
    rows = torch.where(torch.arange(K, device="cuda")[None, :, None]
                       < n_mix[:, None, None], rows, 1e4).contiguous()
    errs = {"mix": check_lap("release, rows = targets", rows, n_mix)[0]}
    # K > Q, match_batch's other branch: rows = 64 queries, 100 targets,
    # the invalid targets' columns flat 1e4 (many exact ties)
    tq = cfg.num_queries
    small = dataclasses.replace(cfg, num_queries=64)
    inputs = matcher_inputs(small, batch, L, gen, n_valid=K)
    valid_q = torch.arange(K, device="cuda")[None] < torch.randint(
        1, K, (L * B, 1), device="cuda", generator=gen)
    cost, _ = match_cost(*inputs[:4])
    rows_q, n_q = lap_problem(cost, valid_q)
    check(rows_q.shape == (L * B, 64, K), "matcher: K > Q problem shape")
    errs["K > Q"] = check_lap("K > Q, rows = queries, flat columns", rows_q,
                              n_q)[0]

    # match_batch at release shapes, no sync, equal to the CPU's
    inputs = matcher_inputs(cfg, batch, L, gen)
    u = torch.rand((L * B, tq, K), device="cuda", generator=gen)
    before = solve_lap.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = match_batch(*inputs, uniforms=u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(solve_lap.launches == before + 1,
          f"matcher: match_batch launched M1 {solve_lap.launches - before} "
          "times, want 1")
    want = match_batch(*(x.cpu() for x in inputs), uniforms=u.cpu())
    for name, a, b in zip(got._fields, got, want):
        check(torch.equal(a.cpu(), b), f"matcher: match_batch {name} on the "
              "card differs from the CPU's")
    n_valid = inputs[4].sum(1)
    phase("matcher", f"match_batch at LB={L * B}, Q={tq}, K={K} (the release "
          f"batch's targets, n_valid {int(n_valid.min())}-"
          f"{int(n_valid.max())}) under sync debug mode 'error': no sync, M1 "
          f"launched once; assign, is_hungarian and punish_mask equal to the "
          f"CPU's ({int(got.is_hungarian.sum())} LAP matches, "
          f"{int((got.assign >= 0).sum())} matches in all)")

    # times: M1 at the batch's own n_valid and at 100, release and scaled
    scaled_batch = scaled_batches(scaled_cfg, [0], TRAIN_KEYS)[0]
    cases = {}
    for label, mcfg, b, nv in (
            ("release", cfg, batch, None), ("release, n_valid 100", cfg,
                                             batch, K),
            ("scaled", scaled_cfg, scaled_batch, None),
            ("scaled, n_valid 100", scaled_cfg, scaled_batch, K)):
        inp = matcher_inputs(mcfg, b, mcfg.dec_layers, gen, n_valid=nv)
        cost, _ = match_cost(*inp[:4])
        rows, n_rows = lap_problem(cost, inp[4])
        errs[label], row_reads = check_lap(label, rows, n_rows)
        ms = device_ms(lambda: solve_lap(rows, n_rows), 50)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host_lap_route(cost, inp[4])
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        cases[label] = dict(
            ms=ms, host_ms=sorted(host)[2], rows=rows, n_rows=n_rows,
            bound=lap_bound_ms(rows, n_rows, row_reads))
        phase("matcher", f"[{smi_line}] M1 {label}: P={rows.shape[0]} "
              f"{rows.shape[1]}x{rows.shape[2]}, n_rows "
              f"{int(n_rows.min())}-{int(n_rows.max())}: {ms:.4f} ms/launch "
              f"(CUDA-graph replay), bound {cases[label]['bound']:.5f} ms "
              f"({row_reads} cost rows read); the host route it "
              f"replaced (copy, {rows.shape[0]} scipy LAPs, copy back) "
              f"{cases[label]['host_ms']:.3f} ms wall, median of 5")
    rel = cases["release"]
    plain_ms = cuda_ms(lambda: solve_lap_plain(rel["rows"], rel["n_rows"]), 2)
    sc = cases["scaled"]
    sc_plain_ms = cuda_ms(lambda: solve_lap_plain(sc["rows"], sc["n_rows"]),
                          2)
    phase("matcher", f"match_batch on the card at release shapes: "
          f"{cuda_ms(lambda: match_batch(*inputs, uniforms=u), 10):.3f} ms "
          f"(CUDA events, host included); the plain LAP on the card "
          f"{plain_ms:.2f} ms")
    # bound_ms counts bytes; the search is a chain of dependent warp
    # reductions, so latency is what limits it (`limited_by`); the record
    # also carries the times at 100 targets a pair
    common = dict(route="cuda", source="parq_torch/csrc/lap.cu",
                  replaces="parq_tpu/ops/hungarian.py:24", bound_by="bytes",
                  limited_by="latency", library_ms=None)
    rel_err = max(errs[k] for k in ("mix", "K > Q", "release",
                                    "release, n_valid 100"))
    sc_err = max(errs["scaled"], errs["scaled, n_valid 100"])
    rel100, sc100 = cases["release, n_valid 100"], cases["scaled, n_valid 100"]
    return [dict(common, name="lap_solve", ms=rel["ms"], plain_ms=plain_ms,
                 bound_ms=rel["bound"], max_abs_err=rel_err,
                 host_route_ms=rel["host_ms"], ms_100_targets=rel100["ms"],
                 bound_ms_100_targets=rel100["bound"],
                 host_route_ms_100_targets=rel100["host_ms"]),
            dict(common, name="lap_solve_scaled", ms=sc["ms"],
                 plain_ms=sc_plain_ms, bound_ms=sc["bound"],
                 max_abs_err=sc_err, host_route_ms=sc["host_ms"],
                 ms_100_targets=sc100["ms"],
                 bound_ms_100_targets=sc100["bound"],
                 host_route_ms_100_targets=sc100["host_ms"])]


# ---------------------------------------------------- the host C++ library --
def rotated_box(rng, spread):
    """(8, 3) reference-ordered world corners of a random yaw-rotated box
    (evals.iou3d.to_odam takes them to the IoU's convention)."""
    from parq_torch.evals.iou3d import ROTX90
    signs = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    size = rng.rand(3) + 0.4
    a = rng.uniform(-np.pi, np.pi)
    roty = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                     [-np.sin(a), 0.0, np.cos(a)]])
    c = -size / 2.0 + signs * size
    return c @ (ROTX90 @ roty).T + rng.randn(3) * spread


def phase_native(smi_line):
    """parq_torch/native: the g++ build; iou3d_matrix against the Python
    iou3d on 200 random rotated boxes, each against itself included (1),
    nms3d against greedy_nms; the F1 association and IoU matrix both ways
    on 200 predictions x 50 GTs."""
    from parq_torch import native
    from parq_torch.evals import f1
    from parq_torch.evals.iou3d import iou3d, to_odam
    from parq_torch.evals.nms import greedy_nms
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    phase("native", f"{os.path.relpath(path, ROOT)} built with g++ "
          f"{' '.join(native.GXX_FLAGS)} in {build_s:.2f} s")
    rng = np.random.RandomState(0)
    boxes = np.stack([to_odam(rotated_box(rng, 0.4)) for _ in range(200)])
    got = native.iou3d_matrix(boxes, boxes)
    want = np.array([[iou3d(a, b)[0] for b in boxes] for a in boxes])
    err = float(np.abs(got - want).max())
    self_err = float(np.abs(np.diag(got) - 1.0).max())
    check(err <= 1e-9 and self_err <= 1e-9, f"native: iou3d_matrix off the "
          f"Python iou3d by {err}, self-IoU off 1 by {self_err} (1e-9)")
    kept = []
    for same, thresh, ties in ((False, 0.1, False), (True, 0.25, False),
                               (False, 0.1, True)):
        lo = rng.uniform(-1.0, 1.0, (300, 3))
        score = (rng.randint(0, 4, (300, 1)) / 4.0 if ties
                 else rng.permutation(300)[:, None] / 300.0)
        nms_rows = np.concatenate([lo, lo + rng.uniform(0.2, 1.0, (300, 3)),
                                   score, rng.randint(0, 9, (300, 1))],
                                  axis=1)
        keep = native.nms3d(nms_rows, thresh, same)
        want_keep = np.zeros(300, bool)
        want_keep[greedy_nms(nms_rows, thresh, same)] = True
        check(np.array_equal(keep, want_keep), f"native: nms3d (same class "
              f"{same}, tied scores {ties}) differs from greedy_nms")
        kept.append(int(keep.sum()))
    phase("native", f"iou3d_matrix vs the Python iou3d on 200 rotated boxes "
          f"(40,000 pairs, each box against itself included): max abs err "
          f"{err:.2e}, self-IoU within {self_err:.2e} of 1 (limit 1e-9); "
          f"nms3d equal to greedy_nms on 300 boxes, distinct scores and "
          f"scores on 4 levels (kept {kept})")

    def entry(rng):
        return [int(rng.randint(9)), rotated_box(rng, 1.5),
                float(rng.rand()), -1]
    preds = [entry(rng) for _ in range(200)]
    gts = [entry(rng) for _ in range(50)]

    def python_matrix(a, b):
        return np.array([[iou3d(x, y)[0] for y in b] for x in a])

    times = {}
    for way in ("library", "python"):
        saved = native.iou3d_matrix
        if way == "python":
            native.iou3d_matrix = python_matrix
        try:
            t0 = time.perf_counter()
            m = f1._pairwise_iou(preds, gts)
            t1 = time.perf_counter()
            matches, _ = f1._associate(preds, gts, 0.1)
            t2 = time.perf_counter()
        finally:
            native.iou3d_matrix = saved
        times[way] = (1e3 * (t1 - t0), 1e3 * (t2 - t1), m, matches)
    check(np.abs(times["library"][2] - times["python"][2]).max() <= 1e-6
          and times["library"][3] == times["python"][3],
          "native: F1's IoU matrix or association differs between ways")
    phase("native", f"F1 on the host, 200 predictions x 50 GTs: _pairwise_iou "
          f"{times['library'][0]:.2f} ms (library) vs "
          f"{times['python'][0]:.2f} ms (Python iou3d); _associate "
          f"{times['library'][1]:.2f} vs {times['python'][1]:.2f} ms; "
          f"the same matrix and matches")


def phase_times(cfg, engine, counts, requests, train_counts, errs, b1_row):
    """Times from CUDA events on this card, and the kernels' record (B1's
    row timed by `sampler_rows`)."""
    import torch.nn.functional as F
    from parq_torch.kernels import flash_bwd, flash_fwd_lse
    from parq_torch.kernels import flash_cross_attention_kv_fused as flash
    from parq_torch.kernels import sample_views_bwd_mem
    from parq_torch.kernels.cross_attention import (
        _flash_fwd, _flash_fwd_lse, _splits_for,
        cross_attention_kv_fused_bwd_plain, cross_attention_kv_fused_plain,
        cross_attention_kv_fused_train_plain, split_kv)
    from parq_torch.kernels.pixel_align import sample_views_bwd_mem_plain
    B = engine.batch_size
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: engine.model(engine.example), 10)
    phase("times", f"forward B={B} {cfg.compute_dtype}: {fwd_ms:.2f} ms "
          f"({1e3 * B / fwd_ms:.1f} samples/s)")
    with torch.inference_mode():
        device_profile(lambda: engine.model(engine.example), "forward")
    gen = torch.Generator(device="cuda").manual_seed(1)
    mem, uvs = release_sampler_inputs(cfg, B, torch.bfloat16, gen)
    Hh, D = cfg.dec_heads, cfg.dec_dim // cfg.dec_heads
    N = cfg.num_views * cfg.feat_size[0] * cfg.feat_size[1]
    L, rate = cfg.dec_layers, cfg.dropout_rate
    q, kv = attention_inputs(B, Hh, cfg.num_queries, N, D, torch.bfloat16,
                             gen)
    k, v = (t.contiguous() for t in split_kv(kv, Hh))
    b2_bound, b2_by = attention_bound(q, kv)
    rows = [
        dict(b1_row),
        dict(name="flash_cross_attention_fwd", route="cuda",
             source="parq_torch/csrc/flash_fwd_sm90.cu",
             replaces="parq_tpu/kernels/cross_attention_pallas.py:457",
             ms=device_ms(lambda: flash(q, kv), 10),
             plain_ms=device_ms(
                 lambda: cross_attention_kv_fused_plain(q, kv), 10),
             bound_ms=b2_bound, bound_by=b2_by,
             library_ms=device_ms(
                 lambda: F.scaled_dot_product_attention(q, k, v), 10)),
    ]
    for r in rows:
        r["launches"] = counts[r["name"]]

    # training kernels at the shapes the release step gives them
    s1 = seed_vector(1, gen)
    b2t_bound, b2t_by = attention_bound(q, kv, lse=True)
    rows.append(dict(
        name="flash_cross_attention_fwd_train", route="cuda",
        source="parq_torch/csrc/flash_fwd_sm90.cu",
        replaces="parq_tpu/kernels/cross_attention_pallas.py:457",
        ms=device_ms(lambda: flash_fwd_lse(q, kv, s1, rate), 10),
        plain_ms=device_ms(lambda: cross_attention_kv_fused_train_plain(
            q, kv, s1, rate), 3),
        bound_ms=b2t_bound, bound_by=b2t_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate), 10)))

    qf, _ = attention_inputs(B, Hh, L * cfg.num_queries, 1, D,
                             torch.bfloat16, gen)
    sL = seed_vector(L, gen)
    do = torch.randn(qf.shape, device="cuda", generator=gen).to(qf.dtype)
    o, lse = flash_fwd_lse(qf, kv, sL, rate)
    delta = (do.float() * o.float()).sum(-1)
    b3_bound, b3_by = attention_bwd_bound(qf, kv)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (qf, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    rows.append(dict(
        name="flash_cross_attention_bwd", route="cuda",
        source="parq_torch/csrc/flash_bwd_sm90.cu",
        replaces="parq_tpu/kernels/cross_attention_pallas.py:547",
        ms=device_ms(lambda: flash_bwd(qf, kv, do, lse, delta, sL, rate), 3),
        plain_ms=device_ms(lambda: cross_attention_kv_fused_bwd_plain(
            qf, kv, do, lse, delta, sL, rate), 3),
        bound_ms=b3_bound, bound_by=b3_by,
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), 5)))
    del ol, ql, kl, vl

    mem_shape, g, dists = sampler_bwd_inputs(cfg, B, gen)
    uvf = dists["release"]
    b4_bound, b4_by = sampler_bwd_bound(uvf, g, mem_shape, mem.dtype)
    g_path = g.to(mem.dtype)   # the training paths hand B4 B1's dtype
    rows.append(dict(
        name="pixel_align_bwd_mem", route="cuda",
        source="parq_torch/csrc/pixel_align_bwd.cu",
        replaces="parq_tpu/kernels/pixel_align_pallas.py:280",
        ms=device_ms(lambda: sample_views_bwd_mem(uvf, g_path, mem_shape,
                                                  mem.dtype), 20),
        plain_ms=device_ms(lambda: sample_views_bwd_mem_plain(
            uvf, g_path, mem_shape, mem.dtype), 3),
        bound_ms=b4_bound, bound_by=b4_by,
        library_ms=grid_sampler_bwd_ms(mem, uvf, g)))
    for r in rows[2:]:
        r["launches"] = train_counts[r["name"]]
    for r in rows[1:]:
        r["max_abs_err"] = errs[r["name"]]
        phase("times", f"{r['name']}: {r['ms']:.4f} ms/launch"
              f", {r['launches']} launches on its path, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    H, W = mem_shape[2:4]
    phase("times", "B4's rows with a tap inside the image: " + ", ".join(
        f"{name} {100 * rows_in_image(u, H, W):.1f}%"
        for name, u in dists.items()))
    for dtype in (torch.bfloat16, torch.float32):
        g_cast = g.to(dtype)    # then the wrapper's cast of g is no pass
        cells = []
        for name, u in dists.items():
            whole, kernel = (device_ms(lambda: sample_views_bwd_mem(
                u, x, mem_shape, dtype), 10) for x in (g, g_cast))
            cells.append(f"{name} {whole:.4f} [{kernel:.4f}]")
        phase("times", f"B4 {str(dtype)[6:]} ms/launch by distribution of "
              "the rows [without the wrapper's cast of g]: "
              + ", ".join(cells))
    phase("times", f"B2 splits its KV range in "
          f"{_splits_for(q, N, q.shape[2], None)} at q {tuple(q.shape)} (eval "
          f"and train); unsplit it takes "
          f"{device_ms(lambda: _flash_fwd(q, kv, 1), 10):.4f} ms (eval), "
          f"{device_ms(lambda: _flash_fwd_lse(q, kv, s1, rate, 1), 10):.4f}"
          " ms (train)")
    return rows


def eval_b1_row(cfg):
    """B2 at B=1 over the release N (the eval twin's shape, and /detect at
    batch 1) against its plain version (atol 2e-2) and timed: the record
    row without its launches, which the eval twin's run gives."""
    import torch.nn.functional as F
    from parq_torch.kernels import flash_cross_attention_kv_fused as flash
    from parq_torch.kernels.cross_attention import (
        _splits_for, cross_attention_kv_fused_plain, split_kv)
    gen = torch.Generator(device="cuda").manual_seed(5)
    Hh, D = cfg.dec_heads, cfg.dec_dim // cfg.dec_heads
    N = cfg.num_views * cfg.feat_size[0] * cfg.feat_size[1]
    q, kv = attention_inputs(1, Hh, cfg.num_queries, N, D, torch.bfloat16,
                             gen)
    k, v = (t.contiguous() for t in split_kv(kv, Hh))
    err = (flash(q, kv).float() - cross_attention_kv_fused_plain(q, kv)
           .float()).abs().max().item()
    check(err <= 2e-2, f"B2 eval B=1: max abs err {err} > 2e-2")
    bound, by = attention_bound(q, kv)
    row = dict(name="flash_cross_attention_fwd_eval_b1", route="cuda",
               source="parq_torch/csrc/flash_fwd_sm90.cu",
               replaces="parq_tpu/kernels/cross_attention_pallas.py:457",
               max_abs_err=err, ms=device_ms(lambda: flash(q, kv), 20),
               plain_ms=device_ms(
                   lambda: cross_attention_kv_fused_plain(q, kv), 5),
               bound_ms=bound, bound_by=by,
               library_ms=device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v), 20))
    phase("times", f"{row['name']}: q {tuple(q.shape)} N={N}, KV splits "
          f"{_splits_for(q, N, q.shape[2], None)}: {row['ms']:.4f} ms/launch"
          f", bound {bound:.4f} ms ({by}), plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms; max abs err {err:.3e} (atol "
          "2e-2)")
    return row


def heads_row(cfg):
    """The heads kernels (`kernels/heads.py`: the four detection heads and
    the box decode of one decoder iteration, three kernels a call) at the
    eval cell's shape (B=1, Q=256, D=1024) under bf16 autocast against
    their plain version (the per-head path's operations, atol 2e-2: the
    bf16 trunk) and timed by graph replay, beside the plain version's
    time: the record row without its launches, which the eval twin's run
    gives. Bound: one read of the f32 parameters and of the input, one
    write of the outputs, against 2·Q·D·(4·D + 9 + classes + 3) FLOP."""
    from parq_torch.kernels.heads import (detection_heads,
                                          detection_heads_plain, head_eps,
                                          head_tensors)
    from parq_torch.models.decoder import _MLPHeads
    gen = torch.Generator(device="cuda").manual_seed(6)
    D, Q, nc = cfg.dec_dim, cfg.num_queries, cfg.num_semcls + 1
    heads = _MLPHeads(D, cfg.num_semcls).cuda()
    with torch.no_grad():
        for name, p in heads.named_parameters():
            r = torch.randn(p.shape, device="cuda", generator=gen)
            norm_scale = name.endswith("weight") and (
                "layers.1." in name or "layers.5." in name)
            p.copy_(r / p.shape[1] ** 0.5 if p.dim() >= 2
                    else r * 0.1 + (1.0 if norm_scale else 0.0))
    out = torch.randn(1, Q, D, device="cuda", generator=gen)
    ref = torch.rand(1, Q, 3, device="cuda", generator=gen)
    mean_size = torch.rand(nc, 3, device="cuda", generator=gen) + 0.5
    params, eps = head_tensors(heads), head_eps(heads)
    with torch.inference_mode(), torch.autocast("cuda",
                                                dtype=torch.bfloat16):
        new_ref, got = detection_heads(out, ref, heads, mean_size, cfg.scale)
        want = detection_heads_plain(out, ref, params, mean_size, cfg.scale,
                                     eps)
        err = max(float((a - b).abs().max()) for a, b in
                  zip((new_ref, *got.values()), want))
        ms = device_ms(lambda: detection_heads(out, ref, heads, mean_size,
                                               cfg.scale), 50)
        plain_ms = device_ms(lambda: detection_heads_plain(
            out, ref, params, mean_size, cfg.scale, eps), 10)
    check(err <= 2e-2, f"detection_heads: max abs err {err} > 2e-2")
    flops = 2 * Q * D * (4 * D + 9 + nc + 3)
    nbytes = 4 * (sum(p.numel() for p in params) + out.numel()
                  + ref.numel() + Q * (3 + nc + 3 + 3 + 6 + nc))
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    bound, by = 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops
                                            else "operations")
    phase("kernels", f"detection_heads B=1 Q={Q} D={D}: {ms:.4f} ms a launch "
          f"(3 kernels), bound {bound:.4f} ms ({by}), plain "
          f"{plain_ms:.4f} ms; max abs err {err:.3e} (atol 2e-2)")
    return dict(name="detection_heads", route="cuda",
                source="parq_torch/csrc/heads.cu",
                replaces="parq_tpu/models/mlp.py:135 (fused_detection_heads:"
                " XLA, no pallas_call)", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def nms_rows(cfg, reps=50):
    """The NMS kernel (`kernels/nms.py`: parse_pred's greedy NMS and the
    pack of its detections, one launch) at the eval cell's shape (B=1,
    K=256, classes 9 + background) on the device half's arrays of random
    outputs: its pack equal to the plain version's and its pred_mask to
    the host library's keep mask and valid, bit for bit; its device ms by
    graph replay of `reps` launches, beside the plain version's ms (on the
    CPU), the host route it replaced (the seven copies and `run_nms`, and
    `run_nms` alone), its ms without the NMS (the pack alone) and
    `nms_mask_device` on the card. Bound: one read of
    the inputs and one write of the pack at the HBM rate (under 200 KB:
    latency, not bytes, sets its time)."""
    from parq_torch.config import ServeConfig
    from parq_torch.evals import nms_mask_device, parse_pred_device
    from parq_torch.evals.nms import run_nms
    from parq_torch.kernels.nms import nms_pack, nms_pack_plain
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, K, ncls = 1, cfg.num_queries, cfg.num_semcls
    logits = torch.randn(B, K, ncls + 1, device="cuda", generator=gen) * 2
    last = {"size_unnormalized": torch.rand(B, K, 3, device="cuda",
                                            generator=gen) + 0.3,
            "center_unnormalized": torch.randn(B, K, 3, device="cuda",
                                               generator=gen) * 0.8,
            "sem_cls_prob": logits.softmax(-1),
            "ortho6d": torch.randn(B, K, 6, device="cuda", generator=gen)}
    Twl = torch.zeros(B, 12, device="cuda")
    Twl[:, [0, 4, 8]] = 1.0
    dev = parse_pred_device(last, Twl, ServeConfig(model=cfg).track_scale,
                            False, ncls)
    args = [dev[k] for k in ("obb_data", "corners_local", "corners_world",
                             "scores", "sem_cls_prob", "labels", "valid")]
    host = [t.cpu() for t in args]
    got = nms_pack(*args, ncls, 0.1, False)
    want = nms_pack_plain(*host, ncls, 0.1, False, True)
    keep = run_nms(host[1].numpy(), host[5].numpy(), host[3].numpy(), ncls,
                   0.1)
    torch.cuda.synchronize()
    check(torch.equal(got.cpu(), want), "nms: the kernel's pack differs "
          "from the plain version's")
    check(np.array_equal(got[..., -1].cpu().numpy() != 0,
                         keep & host[6].numpy()),
          "nms: pred_mask differs from run_nms's keep and valid")
    ms = device_ms(lambda: nms_pack(*args, ncls, 0.1, False), reps)
    pack_ms = device_ms(lambda: nms_pack(*args, ncls, 0.1, False, False),
                        reps)
    t = time.perf_counter()
    for _ in range(3):
        nms_pack_plain(*host, ncls, 0.1, False, True)
    plain_ms = 1e3 * (time.perf_counter() - t) / 3

    def host_route():
        a = [x.cpu().numpy() for x in args]
        return run_nms(a[1], a[5], a[3], ncls, 0.1)
    host_route()
    t = time.perf_counter()
    for _ in range(reps):
        host_route()
    host_ms = 1e3 * (time.perf_counter() - t) / reps
    t = time.perf_counter()
    for _ in range(reps):
        run_nms(host[1].numpy(), host[5].numpy(), host[3].numpy(), ncls, 0.1)
    run_nms_ms = 1e3 * (time.perf_counter() - t) / reps
    mask_ms = cuda_ms(lambda: nms_mask_device(
        args[1][0], args[3][0], args[5][0], ncls, 0.1), 3)
    nbytes = sum(x.numel() * x.element_size() for x in args) \
        + got.numel() * 4
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    phase("kernels", f"nms B={B} K={K} ({int((host[5] != ncls).sum())} "
          f"foreground, {int(keep.sum())} kept): {ms:.4f} ms a launch "
          f"({reps} replayed; {pack_ms:.4f} without the NMS), bound "
          f"{bound:.5f} ms ({nbytes} bytes), plain "
          f"{plain_ms:.2f} ms (CPU); the host route it replaced: 7 copies + "
          f"run_nms {host_ms:.4f} ms, run_nms alone {run_nms_ms:.4f} ms; "
          f"nms_mask_device on the card {mask_ms:.3f} ms; pack and keep "
          "equal bit for bit")
    return dict(name="nms", route="cuda", source="parq_torch/csrc/nms.cu",
                replaces="parq_tpu/evals/nms.py (nms_mask_device: plain "
                "JAX, no pallas_call)", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None, pack_ms=pack_ms, host_route_ms=host_ms,
                run_nms_ms=run_nms_ms, nms_mask_device_ms=mask_ms)


PETR_DCN_SHAPES = {"stage3": (6, 256, 32, 88), "stage4": (6, 512, 16, 44)}
PETR_DCN_BLOCKS = {"stage3": 6, "stage4": 3}     # ResNet-50's blocks there


def dcn_inputs(shape, gen):
    """A bf16 channels-last map and offsets at a PETR DCN stage's shape:
    offsets of a few pixels, the first row pushed off the top and the last
    column off the right, one point far off the map, mask logits around
    0."""
    N, C, H, W = shape
    x = torch.randn(N, C, H, W, device="cuda", generator=gen)
    om = torch.randn(N, 27, H, W, device="cuda", generator=gen) * 2
    om[:, 0:18:2, 0] -= 4.0
    om[:, 1:18:2, :, -1] += 4.0
    om[0, 0, 1, 1], om[0, 1, 1, 1] = -1e4, 1e4
    cl = torch.channels_last
    return (x.to(torch.bfloat16).contiguous(memory_format=cl),
            om.to(torch.bfloat16).contiguous(memory_format=cl))


def deform_rows():
    """The DCNv2 sampling kernel (`kernels/deform_conv.py`) at PETR's two
    DCN stage shapes (six cameras) in bf16 against its plain version's f32
    sums: within one bf16 ulp of them (the kernel rounds its f32 sums
    once; 5e-5 for the rounding of grid_sample's normalised coordinates),
    two launches equal bit for bit, the far point 0. Timed by graph
    replay beside the plain version: the record rows without their
    launches, which `phase_petr` gives. Bound: bytes, the map and the 27
    offset and mask channels read once, the columns written once."""
    from parq_torch.kernels.deform_conv import (deform_columns,
                                                deform_columns_plain)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    for stage, shape in PETR_DCN_SHAPES.items():
        x, om = dcn_inputs(shape, gen)
        got = deform_columns(x, om)
        sums = deform_columns_plain(x.float(), om.float())
        excess = float(((got.float() - sums).abs()
                        - (sums.abs() * 2 ** -7 + 5e-5)).max())
        err = float((got.float() - sums).abs().max())
        check(excess <= 0, f"deform_conv {stage}: beyond one bf16 ulp of "
              f"the plain f32 sums by {excess:.3e} (max abs err {err:.3e})")
        check(torch.equal(got, deform_columns(x, om)),
              f"deform_conv {stage}: two launches differ")
        check(torch.count_nonzero(got[0, 1, 1, 0]) == 0,
              f"deform_conv {stage}: a point far off the map sampled")
        ms = device_ms(lambda: deform_columns(x, om), 50)
        plain_ms = device_ms(lambda: deform_columns_plain(x, om), 5)
        nbytes = (x.numel() + om.numel() + got.numel()) * x.element_size()
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        phase("kernels", f"deform_conv {stage} x {tuple(shape)} bf16: "
              f"{ms:.4f} ms a launch, bound {bound:.4f} ms (bytes), plain "
              f"{plain_ms:.4f} ms; max abs err {err:.3e} (within one bf16 "
              "ulp of the f32 sums)")
        rows[stage] = dict(
            name=f"deform_conv_{stage}", route="cuda",
            source="parq_torch/csrc/deform_conv.cu",
            replaces="none (the JAX package has no deformable convolution)",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes", library_ms=None)
    return rows


# the frozen-BN pass's record: (model, map, residual) at PETR's stem (6
# cameras, 704x256 after conv1), its layer-1 sites (352x128: the two
# identity blocks, the first block's downsample) and the release stem (3
# views, 160x120); each row's launches a forward are that site's in the
# model's `frozen_bn_tally`
FROZEN_BN_CASES = {
    "petr_stem": ("petr", (6, 64, 256, 704), None),
    "petr_layer1_identity": ("petr", (6, 256, 128, 352), "identity"),
    "petr_layer1_downsample": ("petr", (6, 256, 128, 352), "downsample"),
    "release_stem": ("release", (3, 64, 120, 160), None),
}


def frozen_bn_tally(run):
    """The frozen-BN pass's launches in one eager call of `run` under
    inference mode, by (map shape, form): the body's `frozen_bn_site`
    wrapped by a recorder that calls through and tallies each call in
    which the kernel's launch counter moved (form None, "identity" or
    "downsample")."""
    import importlib
    from parq_torch.kernels.frozen_bn import frozen_bn_site
    body = importlib.import_module("parq_torch.models.resnet_fpn")
    tally = {}

    def record(x, bn, residual=None, residual_bn=None):
        before = frozen_bn_site.launches
        y = frozen_bn_site(x, bn, residual, residual_bn)
        form = (None if residual is None
                else "identity" if residual_bn is None else "downsample")
        key = (tuple(x.shape), form)
        tally[key] = tally.get(key, 0) + frozen_bn_site.launches - before
        return y

    body.frozen_bn_site = record
    try:
        with torch.inference_mode():
            run()
        torch.cuda.synchronize()
    finally:
        body.frozen_bn_site = frozen_bn_site
    return {k: n for k, n in tally.items() if n}


def release_frozen_bn_tally(cfg, eval_counts, snippets=8):
    """`frozen_bn_tally` of one bf16 release forward at B=1 (the eval
    twin's batch); its launches must be those the eval twin measured a
    snippet (`eval_counts` over `snippets`)."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.models import BATCH_KEYS, build_model
    model = build_model(cfg, seed=0, device="cuda")
    batch = to_device(make_batch([0], image_size=cfg.image_size,
                                 num_views=cfg.num_views), BATCH_KEYS,
                      "cuda")
    tally = frozen_bn_tally(lambda: model(batch))
    want = eval_counts["frozen_bn"] / snippets
    check(sum(tally.values()) == want, f"release: the recorder tallied "
          f"{sum(tally.values())} frozen-BN launches in a forward, the eval "
          f"twin measured {want} a snippet")
    del model
    torch.cuda.empty_cache()
    return tally


def frozen_bn_rows(tallies):
    """The frozen-BN pass (`kernels/frozen_bn.py`) at `FROZEN_BN_CASES`,
    bf16 channels-last maps, random non-identity buffers (variances over
    eight decades): bit for bit the modules' ops (its plain version), two
    launches equal; timed by graph replay against its bound (bytes: each
    map read once, the output written once) and the modules' ops. The
    record rows, with the launches a forward that `tallies` (model name →
    `frozen_bn_tally`) measured at the row's map and form."""
    from parq_torch.kernels.frozen_bn import (frozen_bn_site,
                                              frozen_bn_site_plain)
    from parq_torch.models.resnet_fpn import FrozenBatchNorm2d
    gen = torch.Generator(device="cuda").manual_seed(10)

    def random_bn(C):
        m = FrozenBatchNorm2d(C).cuda()
        for b in (m.weight, m.bias, m.running_mean):
            b.copy_(torch.randn(C, device="cuda", generator=gen))
        m.running_var.copy_(10 ** (8 * torch.rand(C, device="cuda",
                                                  generator=gen) - 4))
        return m

    def bf16_map(shape):                     # channels-last memory
        N, C, H, W = shape
        return (torch.randn(N, H, W, C, device="cuda", generator=gen)
                * 3).to(torch.bfloat16).permute(0, 3, 1, 2)

    rows = []
    for name, (model, shape, res) in FROZEN_BN_CASES.items():
        sites = tallies[model].get((shape, res), 0)
        check(sites > 0, f"frozen_bn {name}: no launch at {shape} "
              f"({res or 'ReLU'}) in the {model} forward's tally")
        x, bn = bf16_map(shape), random_bn(shape[1])
        args = () if res is None else (bf16_map(shape),) + (
            (random_bn(shape[1]),) if res == "downsample" else ())
        with torch.inference_mode():
            got = frozen_bn_site(x, bn, *args)
            want = frozen_bn_site_plain(x, bn, *args)
            again = frozen_bn_site(x, bn, *args)
        bits = [t.view(torch.int16) for t in (got, want, again)]
        check(torch.equal(bits[0], bits[1]), f"frozen_bn {name}: the kernel "
              "differs from the modules' ops")
        check(torch.equal(bits[0], bits[2]),
              f"frozen_bn {name}: two launches differ")
        ms = device_ms(lambda: frozen_bn_site(x, bn, *args), 20)
        plain_ms = device_ms(lambda: frozen_bn_site_plain(x, bn, *args), 5)
        nbytes = x.numel() * x.element_size() * (3 if res else 2)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        phase("kernels", f"frozen_bn {name} x {tuple(shape)} bf16"
              f"{' + ' + res if res else ''} + ReLU: {ms:.4f} ms a launch, "
              f"bound {bound:.4f} ms (bytes; {ms / bound:.2f}x), the "
              f"modules' ops {plain_ms:.4f} ms; bit for bit the modules'; "
              f"{sites} a {model} forward")
        rows.append(dict(
            name=f"frozen_bn_{name}", route="cuda",
            source="parq_torch/csrc/frozen_bn.cu",
            replaces="none (XLA fuses the JAX body's frozen BN, ReLU and "
                     "adds)", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by="bytes", library_ms=None,
            launches=sites))
    return rows


def phase_petr(smi_line, replays=20):
    """PETR at its published widths in bf16 (`build_petr_model`, the DCN
    offset convs given offsets of a few pixels, not mmcv's zeros) through
    `Graphed`, as the benchmark's PETR cell runs it: two replays equal the
    eager forward bit for bit and launch the DCN kernel 9 times each (one
    a DCN block, the six cameras batched) and the frozen-BN pass 49 times
    (`BODY_SITES`), which an eager forward's `frozen_bn_tally` must sum
    to; the replay's time and the peak memory. Returns the DCN launches a
    forward and the tally."""
    from parq_torch.config import PETRConfig
    from parq_torch.graphs import Graphed
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import build_petr_model
    gen = torch.Generator(device="cuda").manual_seed(9)
    cfg = PETRConfig(compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    model = build_petr_model(cfg, seed=0, device="cuda")
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "conv_offset"):
                m.conv_offset.weight.normal_(0, 0.05, generator=gen)
    W, H = cfg.image_size
    xs = [{"img": torch.randint(0, 256, (1, cfg.num_cams, 3, H, W),
                                device="cuda", dtype=torch.uint8,
                                generator=gen),
           "lidar2img": torch.eye(4, device="cuda").repeat(
               1, cfg.num_cams, 1, 1) + 0.1 * torch.randn(
                   1, cfg.num_cams, 4, 4, device="cuda", generator=gen)}
          for _ in range(2)]
    fwd = Graphed(model)
    with torch.inference_mode():
        fwd(xs[0])                                    # warm-up + capture
        reset_launch_counts()
        got = [fwd(x) for x in xs]
        torch.cuda.synchronize()
        launches = launch_counts()["deform_conv"]
        check(launches == 2 * 9, f"petr: {launches} DCN launches in two "
              "replays, not 18")
        bn_launches = launch_counts()["frozen_bn"]
        check(bn_launches == 2 * BODY_SITES, f"petr: {bn_launches} "
              f"frozen-BN launches in two replays, not {2 * BODY_SITES}")
        for x, g in zip(xs, got):
            want = model(x)
            for k, v in want.items():
                check(bool(torch.isfinite(v).all()), f"petr: {k} not finite")
                check(torch.equal(g[k], v), f"petr: replayed {k} differs "
                      "from the eager forward")
        tally = frozen_bn_tally(lambda: model(xs[0]))
        check(sum(tally.values()) == bn_launches // 2, f"petr: the "
              f"recorder tallied {sum(tally.values())} frozen-BN launches "
              f"in an eager forward, a replay made {bn_launches // 2}")
        ms = cuda_ms(lambda: fwd(xs[1]), replays)
    peak = torch.cuda.max_memory_allocated()
    phase("petr", f"Graphed(PETRModel) bf16, {cfg.num_cams} cameras of "
          f"{W}x{H}, {cfg.num_query} queries: a replay equals the eager "
          "forward bit for bit, 9 DCN launches and "
          f"{bn_launches // 2} frozen-BN launches a replay; "
          f"{ms:.3f} ms a replay (copy-in and clones included), peak {peak}"
          f" B; {smi_line}")
    del fwd, model
    torch.cuda.empty_cache()
    return launches // 2, tally


def split_rows(cfg, errs, sp_counts):
    """The kernels' record for the forms on separate K and V and the v2
    hash: B2-train and B3 natural at an SP rank's shapes (half the release
    tokens: its own shard of K/V), the legacy layout and the v2 hash at the
    release shapes. Launches: rank 0's in the sp phase's steps; the legacy
    layout and the v2 hash are not on the main path (0)."""
    import torch.nn.functional as F
    from parq_torch.kernels import (flash_bwd, flash_bwd_kv, flash_fwd_lse,
                                    flash_fwd_lse_kv)
    from parq_torch.kernels.cross_attention import (
        attention_bwd_plain, attention_train_plain,
        cross_attention_kv_fused_bwd_plain,
        cross_attention_kv_fused_train_plain, heads_view)
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, Hh, D = 8, cfg.dec_heads, cfg.dec_dim // cfg.dec_heads
    Q0, L, rate = cfg.num_queries, cfg.dec_layers, cfg.dropout_rate
    N = cfg.num_views * cfg.feat_size[0] * cfg.feat_size[1]
    s1, sL = seed_vector(1, gen), seed_vector(L, gen)
    src = {"fwd": "parq_torch/csrc/flash_fwd_sm90.cu",
           "bwd": "parq_torch/csrc/flash_bwd_sm90.cu"}
    rep = {"fwd": "parq_tpu/kernels/cross_attention_pallas.py:457",
           "bwd": "parq_tpu/kernels/cross_attention_pallas.py:547"}
    rows = []

    def views(n, legacy):
        q, kv = attention_inputs(B, Hh, Q0, n, D, torch.bfloat16, gen)
        k, v = natural_kv(kv, Hh)
        if legacy:
            k, v = legacy_kv(k, v, Hh, -(-n // 1920) * 1920, gen)
        return q, kv, heads_view(k, Hh, n), heads_view(v, Hh, n)

    def sdpa_ms(q, kh, vh, dropout):
        k, v = kh.contiguous(), vh.contiguous()
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=dropout), 10)

    def sdpa_bwd_ms(qf, kh, vh, do):
        ql, kl, vl = (t.detach().contiguous().requires_grad_(True)
                      for t in (qf, kh, vh))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        return cuda_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), 5)

    for form, n, legacy in (("split", N // 2, False),
                            ("legacy", N, True)):
        q, kv, kh, vh = views(n, legacy)
        qf, _ = attention_inputs(B, Hh, L * Q0, 1, D, torch.bfloat16, gen)
        do = torch.randn(qf.shape, device="cuda", generator=gen).bfloat16()
        o, lse = flash_fwd_lse_kv(qf, kh, vh, sL, rate)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
        fb, fby = attention_bound(q, kv, lse=True)
        bb, bby = attention_bwd_bound(qf, kv)
        launches = sp_counts if form == "split" else {}
        rows.append(dict(
            name=f"flash_cross_attention_fwd_train_{form}", route="cuda",
            source=src["fwd"], replaces=rep["fwd"],
            launches=launches.get("flash_cross_attention_fwd_train_split", 0),
            ms=device_ms(lambda: flash_fwd_lse_kv(q, kh, vh, s1, rate), 10),
            plain_ms=device_ms(lambda: attention_train_plain(
                q, kh, vh, s1, rate), 3),
            bound_ms=fb, bound_by=fby,
            library_ms=sdpa_ms(q, kh, vh, rate)))
        rows.append(dict(
            name=f"flash_cross_attention_bwd_{form}", route="cuda",
            source=src["bwd"], replaces=rep["bwd"],
            launches=launches.get("flash_cross_attention_bwd_split", 0),
            ms=device_ms(lambda: flash_bwd_kv(qf, kh, vh, do, lse, delta, sL,
                                              rate, dk, dv), 3),
            plain_ms=device_ms(lambda: attention_bwd_plain(
                qf, kh, vh, do, lse, delta, sL, rate, dk, dv), 3),
            bound_ms=bb, bound_by=bby,
            library_ms=sdpa_bwd_ms(qf, kh, vh, do)))
        del q, kv, kh, vh, qf, do, o, lse, delta, dk, dv
    # the v2 hash on the fused buffer at the release shapes
    q, kv = attention_inputs(B, Hh, Q0, N, D, torch.bfloat16, gen)
    qf, _ = attention_inputs(B, Hh, L * Q0, 1, D, torch.bfloat16, gen)
    do = torch.randn(qf.shape, device="cuda", generator=gen).bfloat16()
    o, lse = flash_fwd_lse(qf, kv, sL, rate, v2=True)
    delta = (do.float() * o.float()).sum(-1)
    kh, vh = natural_kv(kv, Hh)
    kh, vh = heads_view(kh, Hh, N), heads_view(vh, Hh, N)
    fb, fby = attention_bound(q, kv, lse=True)
    bb, bby = attention_bwd_bound(qf, kv)
    rows.append(dict(
        name="flash_cross_attention_fwd_train_v2", route="cuda",
        source=src["fwd"], replaces=rep["fwd"], launches=0,
        ms=device_ms(lambda: flash_fwd_lse(q, kv, s1, rate, v2=True), 10),
        plain_ms=device_ms(lambda: cross_attention_kv_fused_train_plain(
            q, kv, s1, rate, v2=True), 3),
        bound_ms=fb, bound_by=fby, library_ms=sdpa_ms(q, kh, vh, rate)))
    rows.append(dict(
        name="flash_cross_attention_bwd_v2", route="cuda",
        source=src["bwd"], replaces=rep["bwd"], launches=0,
        ms=device_ms(lambda: flash_bwd(qf, kv, do, lse, delta, sL, rate,
                                       v2=True), 3),
        plain_ms=device_ms(lambda: cross_attention_kv_fused_bwd_plain(
            qf, kv, do, lse, delta, sL, rate, v2=True), 3),
        bound_ms=bb, bound_by=bby, library_ms=sdpa_bwd_ms(qf, kh, vh, do)))
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        phase("times", f"{r['name']}: {r['ms']:.4f} ms/launch, "
              f"{r['launches']} launches on its path, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms")
    return rows


def grid_sampler_bwd_ms(mem, uvs, g):
    """The library's d(input) of grid_sample (zeros padding, corners
    aligned) on the same data: the per-view scale folded into the
    cotangent, one (B·T) batch of maps. CUDA-event ms, or None where the
    build has no kernel for the dtype."""
    B, T, H, W, C = mem.shape
    Q = uvs.shape[2]
    inp = mem.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    grid = torch.stack([2 * uvs[..., 0] / (W - 1) - 1,
                        2 * uvs[..., 1] / (H - 1) - 1], -1)
    grid = grid.reshape(B * T, Q, 1, 2).to(mem.dtype)
    go = (g[:, None] * uvs[..., 2:3]).reshape(B * T, Q, C)
    go = go.permute(0, 2, 1)[..., None].to(mem.dtype)
    try:
        return cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            go, inp, grid, 0, 0, True, [True, False]), 10)
    except RuntimeError as e:
        phase("times", f"grid_sampler_2d_backward in {mem.dtype}: not "
              f"available ({str(e).splitlines()[0][:80]})")
        return None


CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")
TRAIN_STEPS = 5     # the release steps of [train]
NO_KERNELS = {"pixel_align_sample": 0, "flash_cross_attention_fwd": 0,
              "flash_cross_attention_fwd_train": 0,
              "flash_cross_attention_bwd": 0, "pixel_align_bwd_mem": 0,
              "flash_cross_attention_fwd_train_split": 0,
              "flash_cross_attention_bwd_split": 0, "lap_solve": 0,
              "dropout_keep_mask": 0, "detection_heads": 0,
              "deform_conv": 0, "frozen_bn": 0, "nms": 0}
# the frozen-BN pass a bf16 ResNet-50 forward without gradient launches:
# one a BN site of the body but the 4 downsamples' (the stem, 3 a block)
BODY_SITES = 49
# M1 once a train step and once a validation batch (the loss's matcher);
# the keep masks 5 an iteration of the fold's first phase, 5 in its second;
# no frozen-BN launch: the configs train the body (BACKBONE2D.FREEZE False)
TRAIN_KERNELS = dict(NO_KERNELS, pixel_align_sample=8,
                     flash_cross_attention_fwd_train=8,
                     flash_cross_attention_bwd=1, pixel_align_bwd_mem=1,
                     lap_solve=1, dropout_keep_mask=45)
# a validation batch: its forward, the loss's matcher and parse_pred's NMS
VAL_KERNELS = dict(NO_KERNELS, pixel_align_sample=8,
                   flash_cross_attention_fwd=8, lap_solve=1,
                   detection_heads=8, frozen_bn=BODY_SITES, nms=1)
# sequence-parallel: per rank, the split forms in training, the fused
# forward with LSE (the merge needs it) in validation
SP_TRAIN_KERNELS = dict(NO_KERNELS, pixel_align_sample=8,
                        flash_cross_attention_fwd_train_split=8,
                        flash_cross_attention_bwd_split=1,
                        pixel_align_bwd_mem=1, lap_solve=1,
                        dropout_keep_mask=45)
SP_VAL_KERNELS = dict(NO_KERNELS, pixel_align_sample=8,
                      flash_cross_attention_fwd_train=8, detection_heads=8,
                      frozen_bn=BODY_SITES)


def cli_opts(name, *opts):
    """Overrides shared by the CLI phases: bf16, synthetic snippets, the
    mean-size table by absolute path, files under build/."""
    return ["TRAINER.PRECISION", "16", "DATAMODULE.DATA_PATH", "synthetic",
            "MODEL.DECODER.MEAN_SIZE_PATH",
            os.path.join(ROOT, "data", "average_scan2cad.txt"),
            "LOG_IMAGES", "False", "LOG_PATH", CLI_DIR, "NAME", name, *opts]


@contextlib.contextmanager
def counted_path(model_dtypes):
    """Per train step and per validation of the Trainer: the launch counts
    (set to 0 just before, read just after; a replayed step's are those
    its graph's capture recorded), the step's CUDA-event ms and the
    validation's wall ms; the decoder's memory dtype on every forward of
    every model the Trainer builds (a replay runs no Python: the eager
    first step and the capture of each graph)."""
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.train import loop
    steps, vals = [], []
    make, validate, build = loop.make_graphed_train_step, \
        loop.Trainer.validate, loop.build_model

    def counted_make(*a, **k):
        step = make(*a, **k)

        def counted_step(*a, **k):
            reset_launch_counts()
            t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t[0].record()
            out = step(*a, **k)
            t[1].record()
            torch.cuda.synchronize()
            steps.append((launch_counts(), t[0].elapsed_time(t[1])))
            return out
        return counted_step

    def counted_validate(self, *a, **k):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = validate(self, *a, **k)
        torch.cuda.synchronize()
        vals.append((launch_counts(), 1e3 * (time.perf_counter() - t0)))
        return out

    def watched_build(*a, **k):
        model = build(*a, **k)
        model_dtypes.append(watch_memory_dtype(model)[0])
        return model

    loop.make_graphed_train_step, loop.Trainer.validate, loop.build_model = \
        counted_make, counted_validate, watched_build
    try:
        yield steps, vals
    finally:
        loop.make_graphed_train_step, loop.Trainer.validate, \
            loop.build_model = make, validate, build


def check_counts(seen, want, what):
    for i, (counts, _) in enumerate(seen):
        check(counts == want, f"{what} {i}: launches {counts}, want {want}")


def phase_fit(smi_line):
    """The train twin at release width; then a resume. Returns the best
    checkpoint's path after the resume, and the ms per step."""
    from parq_torch.cli import train as cli_train
    from parq_torch.config import get_cfg, update_config
    from parq_torch.train.loop import Trainer
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    cfg_path = os.path.join(ROOT, "configs", "train.yaml")
    def fit_opts(epochs):
        return cli_opts("fit", "DATAMODULE.BATCH_SIZE", "8",
                        "TRAINER.MAX_EPOCHS", str(epochs),
                        "TRAINER.VAL_CHECK_INTERVAL", "0.5",
                        "TRAINER.LOG_EVERY_N_STEPS", "1",
                        "CALLBACK.SAVE_TOP_K", "1")
    opts = fit_opts(2)
    dtypes = []
    t0 = time.perf_counter()
    with counted_path(dtypes) as (steps, vals):
        trainer, final = cli_train.main(["--cfg", cfg_path, *opts])
    fit_ms = 1e3 * (time.perf_counter() - t0)
    check(len(steps) == 8 and len(vals) == 5, f"fit: {len(steps)} steps and "
          f"{len(vals)} validations, want 8 and 4 + the final one")
    check_counts(steps, TRAIN_KERNELS, "fit step")
    check_counts(vals, VAL_KERNELS, "validation")
    # the hook sees the eager first call and the capture of each graph (a
    # replay runs no Python): the train step's, a validation's, and the
    # final validation's after the best checkpoint's restore
    check(all(d == torch.bfloat16 for seen in dtypes for d in seen)
          and sum(map(len, dtypes)) >= 2 + 2 + 2,
          f"fit: the decoder's memory came as {dtypes}, want bfloat16")
    with open(trainer.metrics_path) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["total_loss"] for r in rows if r["stage"] == "train"]
    check(len(losses) >= 1 and all(math.isfinite(v) for v in losses),
          f"fit: losses {losses}")
    for r in rows:
        if r["stage"] == "train":
            phase("fit", f"step {r['step']}: loss {r['total_loss']:.5f} "
                  f"grad_norm {r['grad_norm']:.4f} lr {r['lr']:.3e}")
    kept = trainer.ckpt_mgr.steps()
    best = trainer.ckpt_mgr.best_step()
    check(8 in kept and best is not None and all(
        os.path.exists(trainer.ckpt_mgr.path(s)) for s in kept),
        f"fit: checkpoints kept {kept}, best {best}")
    step_ms = [ms for _, ms in steps]
    val_ms = sum(ms for _, ms in vals[:4])
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
    phase("fit", f"{len(steps)} steps at B=8 bf16, per step launches "
          f"{steps[-1][0]}; per validation {vals[0][0]}; token memory "
          f"bfloat16; checkpoints {kept} (best {best}); final metrics "
          f"0.5_f1 {final.get('0.5_f1')}, total_loss "
          f"{final.get('total_loss')}")
    phase("fit", f"[{smi_line}] step {mean_ms:.2f} ms (CUDA events, mean "
          f"of steps 2-8; step 1 {step_ms[0]:.2f} ms); 4 validations "
          f"{val_ms:.1f} ms of the fit's {fit_ms:.1f} ms wall "
          f"({100 * val_ms / fit_ms:.1f}%; the final one "
          f"{vals[4][1]:.1f} ms)")

    for line in trainer.profile_summary().splitlines():
        phase("fit", f"  {line}")
    # where a validation's time goes: as configured (2 spawn workers start
    # per validation), then with the prefetch thread instead
    _, val_loader = cli_train.build_loaders(trainer.cfg)
    device_profile(lambda: trainer.validate(val_loader),
                   "validation (NUM_WORKERS 2)", label_phase="fit")
    val_loader.num_workers = 0
    device_profile(lambda: trainer.validate(val_loader),
                   "validation (prefetch thread)", label_phase="fit")

    # resume: MAX_EPOCHS 3 picks up at step 8 and takes epoch 3
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(cfg=cfg_path, opts=fit_opts(3)))
    saved = torch.load(trainer.ckpt_mgr.path(8), map_location="cuda",
                       weights_only=True)["model"]
    with counted_path([]) as (steps, vals):
        again = Trainer(cfg)
        train_loader, val_loader = cli_train.build_loaders(cfg)
        again.setup_state(len(train_loader))
        check(again.restore_if_available(train_loader)
              and again.global_step == 8, "resume: not at step 8")
        own = again.model.state_dict()
        check(sorted(own) == sorted(saved) and all(
            torch.equal(own[k], v) for k, v in saved.items()),
            "resume: restored weights differ from the saved ones")
        again.fit(train_loader, val_loader)
    check(again.global_step == 12 and train_loader.epoch == 3
          and len(steps) == 4, f"resume: at step {again.global_step}, epoch "
          f"{train_loader.epoch}, {len(steps)} steps")
    check_counts(steps, TRAIN_KERNELS, "resumed step")
    check_counts(vals, VAL_KERNELS, "resumed validation")
    phase("fit", f"resumed at step 8 with the saved weights bit for bit "
          f"({len(saved)} tensors); took epoch 3: steps 9-12, "
          f"{len(vals)} validations")
    return again.ckpt_mgr.path(again.ckpt_mgr.best_step()), mean_ms


def phase_eval(ckpt, smi_line):
    """The eval twin on the fit's best checkpoint: its printed metrics and
    the kernels' launches over its 8 snippets."""
    from parq_torch.cli import eval as cli_eval
    from parq_torch.kernels import launch_counts, reset_launch_counts
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        metrics = cli_eval.main([
            "--cfg", os.path.join(ROOT, "configs", "eval.yaml"),
            "--CHECKPOINT_PATH", ckpt, *cli_opts("eval")])
    counts = launch_counts()
    text = out.getvalue()
    sys.stdout.write(text)
    printed = {line.split()[0] for line in text.splitlines() if line.strip()}
    for key in ("0.25_f1", "0.5_f1", "0.7_f1", "mean_latency_s"):
        check(key in printed and key in metrics, f"eval: {key} not printed")
    want = {k: 8 * v for k, v in VAL_KERNELS.items()}
    check(counts == want, f"eval: launches {counts} for 8 snippets, want "
          f"{want}")
    latency_ms = 1e3 * metrics["mean_latency_s"]
    phase("eval", f"[{smi_line}] 8 snippets at B=1 bf16 from "
          f"{os.path.relpath(ckpt, ROOT)}: mean latency {latency_ms:.2f} ms "
          f"per snippet (the first excluded); launches {counts}; 0.5_f1 "
          f"{metrics['0.5_f1']}")
    return metrics, counts


# ------------------------------------------- the scaled-recurrence config --
SCALED_DIR = os.path.join(ROOT, "build", "chip_smoke_scaled")
EXPORT_DIR = os.path.join(ROOT, "build", "chip_smoke_export")
# per step of the scaled config (L=16), the sequential path: with REMAT the
# recompute launches B1, B2-train and the 5 keep masks of an iteration a
# second time in the backward
SCALED_REMAT_KERNELS = dict(NO_KERNELS, pixel_align_sample=32,
                           flash_cross_attention_fwd_train=32,
                           flash_cross_attention_bwd=16,
                           pixel_align_bwd_mem=16, lap_solve=1,
                           dropout_keep_mask=160)
SCALED_SEQ_KERNELS = dict(NO_KERNELS, pixel_align_sample=16,
                         flash_cross_attention_fwd_train=16,
                         flash_cross_attention_bwd=16,
                         pixel_align_bwd_mem=16, lap_solve=1,
                         dropout_keep_mask=80)
SCALED_FOLD_KERNELS = dict(NO_KERNELS, pixel_align_sample=16,
                          flash_cross_attention_fwd_train=16,
                          flash_cross_attention_bwd=1,
                          pixel_align_bwd_mem=1, lap_solve=1,
                          dropout_keep_mask=85)
# the bare eval forward; a validation batch adds M1 (the loss) and the NMS
SCALED_VAL_KERNELS = dict(NO_KERNELS, pixel_align_sample=16,
                         flash_cross_attention_fwd=16, detection_heads=16,
                         frozen_bn=BODY_SITES)


def config_tree(path, *opts):
    """A config tree from configs/`path` in bf16 on synthetic snippets, the
    mean-size table by absolute path, plus `opts`."""
    from parq_torch.config import get_cfg, update_config
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", path), opts=[
            "TRAINER.PRECISION", "16", "DATAMODULE.DATA_PATH", "synthetic",
            "MODEL.DECODER.MEAN_SIZE_PATH",
            os.path.join(ROOT, "data", "average_scan2cad.txt"), *opts]))
    return cfg


def scaled_model_cfg():
    """configs/scaled_recurrence.yaml's model: 6 views, L=16, REMAT, bf16."""
    from parq_torch.config import ModelConfig
    mcfg = ModelConfig.from_cfg(config_tree("scaled_recurrence.yaml"))
    check(mcfg.remat and mcfg.share_weights and mcfg.num_views == 6
          and mcfg.dec_layers == 16 and mcfg.compute_dtype == "bfloat16",
          f"scaled_recurrence.yaml read as {mcfg}")
    return mcfg


def scaled_inputs(mcfg, gen):
    """The kernels' inputs at the scaled shapes: B=1, T=6, Q=256,
    N = 6·80·60 = 28,800 tokens, 4 heads of 256."""
    Hh, D = mcfg.dec_heads, mcfg.dec_dim // mcfg.dec_heads
    N = mcfg.num_views * mcfg.feat_size[0] * mcfg.feat_size[1]
    mem, uvs = release_sampler_inputs(mcfg, 1, torch.bfloat16, gen)
    q, kv = attention_inputs(1, Hh, mcfg.num_queries, N, D, torch.bfloat16,
                             gen)
    g = torch.randn(1, mcfg.num_queries, mem.shape[-1], device="cuda",
                    generator=gen)
    return mem, uvs, g, q, kv


def scaled_kernels(mcfg):
    """Each kernel of the scaled path against its plain version at its
    shapes, with the release checks' tolerances: B1 (bf16 and f32,
    `check_sampler`), B2 and B2-train (bf16, atol 2e-2, lse 1e-4), B3 (2e-2 of the
    largest element), B4 (1e-2 of it, two launches equal bit for bit).
    Returns the bf16 max abs errors."""
    from parq_torch.kernels import (flash_cross_attention_kv_fused,
                                    flash_fwd_lse, sample_views_bwd_mem)
    from parq_torch.kernels.cross_attention import (
        cross_attention_kv_fused_plain, cross_attention_kv_fused_train_plain)
    from parq_torch.kernels.pixel_align import sample_views_bwd_mem_plain
    gen = torch.Generator(device="cuda").manual_seed(3)
    mem, uvs, g, q, kv = scaled_inputs(mcfg, gen)
    errs = {"pixel_align_sample": check_sampler("scaled", mem, uvs)}
    err = (flash_cross_attention_kv_fused(q, kv).float()
           - cross_attention_kv_fused_plain(q, kv).float()).abs().max().item()
    check(err <= 2e-2, f"scaled B2: max abs err {err} > 2e-2")
    errs["flash_cross_attention_fwd"] = err
    seeds = seed_vector(1, gen)
    rate = mcfg.dropout_rate
    o, lse = flash_fwd_lse(q, kv, seeds, rate)
    o_ref, lse_ref = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    err_t = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    check(err_t <= 2e-2 and err_l <= 1e-4, f"scaled B2-train: o {err_t} > "
          f"2e-2 or lse {err_l} > 1e-4")
    errs["flash_cross_attention_fwd_train"] = err_t
    phase("kernels", f"scaled B2 bfloat16 q {tuple(q.shape)} kv "
          f"{tuple(kv.shape)}: eval max abs err {err:.3e}, train (rate "
          f"{rate}) {err_t:.3e} (atol 2e-2), lse {err_l:.3e} (atol 1e-4)")
    errs["flash_cross_attention_bwd"] = check_backward(q, kv, seeds, rate,
                                                       2e-2, gen)
    check_kv_splits(q, kv, rate, 2e-2, gen, "scaled")
    _, ctas = check_dq_splits(q, kv, seeds, rate, 2e-2, gen, "scaled")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(sms < 132 or ctas >= 100, f"scaled B3: the dq pass launches "
          f"{ctas} CTAs on {sms} SMs (want at least 100)")
    got = sample_views_bwd_mem(uvs, g, mem.shape, mem.dtype)
    check(torch.equal(got, sample_views_bwd_mem(uvs, g, mem.shape,
                                                mem.dtype)),
          "scaled B4: two launches on the same inputs differ")
    err, rel = _rel_err(got, sample_views_bwd_mem_plain(uvs, g, mem.shape,
                                                        mem.dtype))
    check(rel <= 1e-2, f"scaled B4: max abs err {err} is {rel} of its max")
    errs["pixel_align_bwd_mem"] = err
    phase("kernels", f"scaled B4 bfloat16 dmem {tuple(mem.shape)} "
          f"Q={uvs.shape[2]}: max abs err {err:.3e} ({rel:.2e} of its max; "
          "limit 1e-2); two launches equal bit for bit")
    torch.cuda.synchronize()
    return errs


def scaled_rows(mcfg, errs, counts, b1_row):
    """The kernels' record at the scaled shapes: device ms (CUDA-graph
    replay; the library's dropout and backward by CUDA events), bound,
    plain and library ms; launches from the scaled phase's REMAT steps
    (training kernels) and its eval forward (B2's eval form). B1's row
    comes timed from `sampler_rows`."""
    import torch.nn.functional as F
    from parq_torch.kernels import (flash_bwd, flash_cross_attention_kv_fused,
                                    flash_fwd_lse, sample_views_bwd_mem)
    from parq_torch.kernels.cross_attention import (
        _splits_for, cross_attention_kv_fused_bwd_plain,
        cross_attention_kv_fused_plain, cross_attention_kv_fused_train_plain,
        split_kv)
    from parq_torch.kernels.pixel_align import sample_views_bwd_mem_plain
    gen = torch.Generator(device="cuda").manual_seed(4)
    mem, uvs, g, q, kv = scaled_inputs(mcfg, gen)
    k, v = (t.contiguous() for t in split_kv(kv, mcfg.dec_heads))
    rate = mcfg.dropout_rate
    s1 = seed_vector(1, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    o, lse = flash_fwd_lse(q, kv, s1, rate)
    delta = (do.float() * o.float()).sum(-1)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    src = "parq_torch/csrc/"
    rows = [
        dict(name="flash_cross_attention_fwd_scaled",
             kernel="flash_cross_attention_fwd",
             source=src + "flash_fwd_sm90.cu",
             replaces="parq_tpu/kernels/cross_attention_pallas.py:457",
             ms=device_ms(lambda: flash_cross_attention_kv_fused(q, kv), 20),
             plain_ms=device_ms(
                 lambda: cross_attention_kv_fused_plain(q, kv), 5),
             bound=attention_bound(q, kv),
             library_ms=device_ms(
                 lambda: F.scaled_dot_product_attention(q, k, v), 20)),
        dict(name="flash_cross_attention_fwd_train_scaled",
             kernel="flash_cross_attention_fwd_train",
             source=src + "flash_fwd_sm90.cu",
             replaces="parq_tpu/kernels/cross_attention_pallas.py:457",
             ms=device_ms(lambda: flash_fwd_lse(q, kv, s1, rate), 20),
             plain_ms=device_ms(lambda: cross_attention_kv_fused_train_plain(
                 q, kv, s1, rate), 3),
             bound=attention_bound(q, kv, lse=True),
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, dropout_p=rate), 20)),
        dict(name="flash_cross_attention_bwd_scaled",
             kernel="flash_cross_attention_bwd",
             source=src + "flash_bwd_sm90.cu",
             replaces="parq_tpu/kernels/cross_attention_pallas.py:547",
             ms=device_ms(lambda: flash_bwd(q, kv, do, lse, delta, s1, rate),
                          10),
             plain_ms=device_ms(lambda: cross_attention_kv_fused_bwd_plain(
                 q, kv, do, lse, delta, s1, rate), 3),
             bound=attention_bwd_bound(q, kv),
             library_ms=cuda_ms(lambda: torch.autograd.grad(
                 ol, (ql, kl, vl), do, retain_graph=True), 10)),
        dict(name="pixel_align_bwd_mem_scaled", kernel="pixel_align_bwd_mem",
             source=src + "pixel_align_bwd.cu",
             replaces="parq_tpu/kernels/pixel_align_pallas.py:280",
             ms=device_ms(lambda: sample_views_bwd_mem(
                 uvs, g.to(mem.dtype), mem.shape, mem.dtype), 20),
             plain_ms=device_ms(lambda: sample_views_bwd_mem_plain(
                 uvs, g.to(mem.dtype), mem.shape, mem.dtype), 3),
             bound=sampler_bwd_bound(uvs, g, mem.shape, mem.dtype),
             library_ms=grid_sampler_bwd_ms(mem, uvs, g)),
    ]
    phase("times", f"scaled: B2 splits its KV range in "
          f"{_splits_for(q, kv.shape[1], q.shape[2], None)} at q "
          f"{tuple(q.shape)}, N={kv.shape[1]}")
    out = [dict(b1_row, launches=counts["pixel_align_sample"])]
    for r in rows:
        kernel = r.pop("kernel")
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        r.update(route="cuda", launches=counts[kernel],
                 max_abs_err=errs[kernel])
        phase("times", f"{r['name']}: {r['ms']:.4f} ms/launch, "
              f"{r['launches']} launches in the scaled phase, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
        out.append(r)
    return out


def scaled_batches(mcfg, seeds, keys):
    from parq_torch.data.synthetic import make_batch, to_device
    return [to_device(make_batch([s], image_size=mcfg.image_size,
                                 num_views=mcfg.num_views), keys, "cuda")
            for s in seeds]


def phase_scaled(smi_line, steps=3):
    """configs/scaled_recurrence.yaml at full width: train steps with
    REMAT on, then off (the sequential path, and the fold the config
    would take without REMAT), launches per step, step ms and peak memory;
    an f32 gate of REMAT on against off; one eval forward; the train twin
    on the config. Returns the launch counts of the REMAT steps and the
    eval forward (B2's eval form)."""
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import BATCH_KEYS, build_model
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import (make_graphed_train_step,
                                             make_optimizer, train_step)
    mcfg = scaled_model_cfg()
    t0 = time.perf_counter()
    model = build_model(mcfg, seed=0, device="cuda").train()
    opt = make_optimizer(model, lr=1e-4, capturable=True)
    batches = scaled_batches(mcfg, range(steps), TRAIN_KEYS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dec = model.box3d_decoder
    train_step(model, opt, batches[0], gen)      # warm-up: AdamW's state
    torch.cuda.synchronize()
    graphed = {}
    phase("scaled", f"model ready in {time.perf_counter() - t0:.1f} s: "
          f"{mcfg.resnet_name} {mcfg.num_views}x{mcfg.image_size} "
          f"L={mcfg.dec_layers} Q={mcfg.num_queries} dim={mcfg.dec_dim} "
          f"B=1 bfloat16, dropout {mcfg.dropout_rate}; a warm-up step")
    mem_dtypes, hook = watch_memory_dtype(model)
    remat_counts = dict(NO_KERNELS)
    for label, remat, folded, want in (
            ("REMAT on", True, False, SCALED_REMAT_KERNELS),
            ("REMAT off, sequential", False, False, SCALED_SEQ_KERNELS),
            ("REMAT off, fold", False, True, SCALED_FOLD_KERNELS)):
        dec.remat, dec.batched_grad = remat, folded
        check(dec.folds(False) == folded, f"scaled {label}: fold gate")
        # a graph per decoder path: step 0 runs eagerly (its peak memory is
        # the path's) and captures, steps 1.. replay
        step_fn = graphed[label] = make_graphed_train_step(model, opt)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for step in range(steps):
            reset_launch_counts()
            t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t[0].record()
            m = step_fn(batches[step], gen)
            t[1].record()
            torch.cuda.synchronize()
            ms.append(t[0].elapsed_time(t[1]))
            counts = launch_counts()
            check(counts == want, f"scaled {label} step {step}: launches "
                  f"{counts}, want {want}")
            if remat:
                for k, n in counts.items():
                    remat_counts[k] += n
            loss = float(m["total_loss"])
            check(math.isfinite(loss) and math.isfinite(float(
                m["grad_norm"])), f"scaled {label} step {step}: loss {loss}")
        peak = torch.cuda.max_memory_allocated()
        phase("scaled", f"[{smi_line}] {label}: step "
              f"{sum(ms[1:]) / (steps - 1):.2f} ms (CUDA events, mean of the "
              f"{steps - 1} replays; the eager step and capture first: "
              + ", ".join(f"{x:.2f}" for x in ms)
              + f"); peak memory {peak / 2 ** 30:.3f} GiB "
              f"({(peak - base) / 2 ** 30:.3f} GiB over the "
              f"{base / 2 ** 30:.3f} GiB held between steps); per step "
              f"launches {want}; last loss {loss:.5f}")
    hook.remove()
    for label, key, remat, folded in (
            ("REMAT on", "REMAT on", True, False),
            ("the fold", "REMAT off, fold", False, True)):
        dec.remat, dec.batched_grad = remat, folded
        device_profile(lambda: graphed[key](batches[0], gen),
                       f"scaled step ({label}, replay)", label_phase="scaled")
    del graphed
    for label, remat in (("REMAT on", True), ("REMAT off, sequential", False)):
        dec.remat, dec.batched_grad = remat, False
        total, top = saved_for_backward(model, batches[0], gen)
        phase("scaled", f"{label}: autograd keeps {total / 2 ** 30:.3f} GiB "
              "for the backward of one step's forward (distinct storages; "
              "under REMAT the iterations' own are dropped); largest: "
              + "; ".join(f"{n} x {shape} {str(dt)[6:]} "
                          f"{nb / 2 ** 20:.1f} MiB"
                          for (shape, dt), (n, nb) in top))
    check(mem_dtypes == [torch.bfloat16] * (3 * 2),
          f"scaled: the decoder's memory came as {mem_dtypes}, want "
          "bfloat16 in each path's eager step and capture (B1 and B4 take "
          "the memory's dtype; a replay runs no Python)")
    dec.remat, dec.batched_grad = True, True

    # one eval forward
    batch = scaled_batches(mcfg, [7], BATCH_KEYS)[0]
    reset_launch_counts()
    with torch.inference_mode():
        out = model.eval()(batch)
    eval_counts = launch_counts()
    check(eval_counts == SCALED_VAL_KERNELS, f"scaled eval: launches "
          f"{eval_counts}, want {SCALED_VAL_KERNELS}")
    L, Q = mcfg.dec_layers, mcfg.num_queries
    check(out["pred_logits"].shape == (L, 1, Q, mcfg.num_semcls + 1)
          and all(bool(torch.isfinite(v).all()) for v in out.values()
                  if v.is_floating_point()), "scaled eval: outputs")
    phase("scaled", f"eval forward B=1: outputs finite, pred_logits "
          f"{tuple(out['pred_logits'].shape)}; launches {eval_counts}")
    del model, opt, out
    torch.cuda.empty_cache()
    scaled_remat_gate(mcfg)
    scaled_cli(smi_line)
    remat_counts["flash_cross_attention_fwd"] = eval_counts[
        "flash_cross_attention_fwd"]
    return remat_counts


def saved_for_backward(model, batch, gen, top=5):
    """(bytes, the `top` largest kinds) of the tensors autograd keeps for
    the backward of one training forward and loss, counted once per
    storage, the parameters' own not counted: a diagnostic of what REMAT
    drops."""
    from parq_torch.train.train_step import forward_and_loss
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            seen.setdefault(st.data_ptr(), ((tuple(t.shape), t.dtype),
                                            st.nbytes()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        losses, _ = forward_and_loss(model, batch, gen)
    del losses
    kinds = {}
    for kind, nb in seen.values():
        n, b = kinds.get(kind, (0, 0))
        kinds[kind] = (n + 1, b + nb)
    total = sum(b for _, b in kinds.values())
    return total, sorted(kinds.items(), key=lambda kv: -kv[1][1])[:top]


def scaled_remat_gate(mcfg):
    """REMAT on against off (the sequential path) on the card: f32, TF32
    off, dropout 0, the same weights, batch and matcher draws; each
    gradient to the train-parity tolerance."""
    from parq_torch.models import build_model
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import forward_and_loss
    f32 = dataclasses.replace(mcfg, compute_dtype="float32", dropout_rate=0.0,
                              batched_grad=False)
    batch = scaled_batches(f32, [5], TRAIN_KEYS)[0]
    u = torch.rand((f32.dec_layers, f32.num_queries,
                    batch["obbs_padded"].shape[1]),
                   generator=torch.Generator().manual_seed(0))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads, losses = {}, {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(f32, remat=remat), seed=1,
                            device="cuda").train()
        lo, _ = forward_and_loss(model, batch, None, uniforms=u)
        lo["total_loss"].backward()
        losses[remat] = float(lo["total_loss"].detach())
        grads[remat] = {n: p.grad.detach() for n, p in
                        model.named_parameters()}
        del model, lo
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    check(abs(losses[True] - losses[False]) <= 1e-3 * max(abs(losses[False]),
                                                          1.0),
          f"scaled remat gate: loss {losses[True]} vs {losses[False]}")
    total = math.sqrt(sum(float(g.norm()) ** 2 for g in grads[False].values()))
    worst, worst_name = 0.0, ""
    for n, g in grads[False].items():
        err = float((grads[True][n] - g).norm())
        check(err <= 5e-3 * float(g.norm()) + 1e-6 * total,
              f"scaled remat gate: {n} gradient off by {err} (norm "
              f"{float(g.norm())})")
        rel = err / max(float(g.norm()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    phase("scaled", f"f32 gate, REMAT on vs off on the card (TF32 off, "
          f"dropout 0, L={f32.dec_layers}, 6 views): loss {losses[True]:.6f}"
          f" vs {losses[False]:.6f}; {len(grads[False])} gradients, worst "
          f"‖Δ‖/‖g‖ {worst:.2e} ({worst_name}); limit 5e-3·‖g‖ + "
          f"1e-6·‖G‖, ‖G‖ = {total:.4g}")
    del grads
    torch.cuda.empty_cache()


def scaled_cli(smi_line):
    """`python -m parq_torch.cli.train` on configs/scaled_recurrence.yaml
    (in-process) with 2 synthetic snippets to train and 2 to validate (the
    YAML plus smoke.yaml's SYNTHETIC_*_SIZE keys): 2 steps, a validation,
    a checkpoint, the final validation."""
    from parq_torch.cli import train as cli_train
    shutil.rmtree(SCALED_DIR, ignore_errors=True)
    os.makedirs(SCALED_DIR)
    with open(os.path.join(ROOT, "configs", "scaled_recurrence.yaml")) as f:
        text = f.read()
    yaml = os.path.join(SCALED_DIR, "scaled_recurrence.yaml")
    with open(yaml, "w") as f:
        f.write(text.replace("DATAMODULE:\n", "DATAMODULE:\n"
                             "  SYNTHETIC_TRAIN_SIZE: 2\n"
                             "  SYNTHETIC_VAL_SIZE: 2\n"))
    opts = ["TRAINER.PRECISION", "16", "DATAMODULE.DATA_PATH", "synthetic",
            "MODEL.DECODER.MEAN_SIZE_PATH",
            os.path.join(ROOT, "data", "average_scan2cad.txt"),
            "LOG_PATH", SCALED_DIR, "TRAINER.MAX_EPOCHS", "1",
            "TRAINER.VAL_CHECK_INTERVAL", "1.0",
            "TRAINER.LOG_EVERY_N_STEPS", "1", "CALLBACK.SAVE_TOP_K", "1"]
    dtypes = []
    t0 = time.perf_counter()
    with counted_path(dtypes) as (steps, vals):
        trainer, final = cli_train.main(["--cfg", yaml, *opts])
    wall = time.perf_counter() - t0
    check(len(steps) == 2 and len(vals) == 2, f"scaled cli: {len(steps)} "
          f"steps and {len(vals)} validations, want 2 and 1 + the final one")
    check_counts(steps, SCALED_REMAT_KERNELS, "scaled cli step")
    check_counts(vals, dict({k: 2 * n for k, n in SCALED_VAL_KERNELS.items()},
                            lap_solve=2, nms=2),
                 "scaled cli validation (2 snippets)")
    check(all(d == torch.bfloat16 for seen in dtypes for d in seen),
          f"scaled cli: the decoder's memory came as {dtypes}")
    with open(trainer.metrics_path) as f:
        losses = [json.loads(line)["total_loss"] for line in f
                  if json.loads(line)["stage"] == "train"]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"scaled cli: losses {losses}")
    phase("scaled", f"[{smi_line}] train twin on scaled_recurrence.yaml: "
          f"2 steps ({', '.join(f'{ms:.1f}' for _, ms in steps)} ms, losses "
          + ", ".join(f"{v:.5f}" for v in losses)
          + f"), 2 validations, checkpoint {trainer.ckpt_mgr.steps()}, "
          f"final 0.5_f1 {final.get('0.5_f1')}; {wall:.1f} s wall; per "
          f"step launches {steps[0][0]}")
    shutil.rmtree(SCALED_DIR, ignore_errors=True)


# ------------------------------------------------- export and serving --
def program_sampler_dtypes(blob):
    """The memory's dtype at each ``parq::sample_views`` call of a saved
    exported program, from the program's own graph (a dispatch mode that
    watched the calls would change how the autocast region runs)."""
    ep = torch.export.load(io.BytesIO(blob))
    return [n.args[0].meta["val"].dtype
            for mod in ep.graph_module.modules()
            if isinstance(mod, torch.fx.GraphModule)
            for n in mod.graph.nodes
            if n.op == "call_function"
            and n.target is torch.ops.parq.sample_views.default]


def _max_gap(got, want):
    """max over the float outputs of |got − want| / max(1, max |want|)."""
    worst = 0.0
    for k, w in want.items():
        if not w.is_floating_point():
            check(torch.equal(got[k], w), f"{k} differs")
            continue
        gap = (got[k].float() - w.float()).abs().max().item()
        worst = max(worst, gap / max(1.0, w.float().abs().max().item()))
    return worst


def phase_export(smi_line, requests=3):
    """The release eval forward exported on the card through
    parq_torch.export.export_forward (configs/eval.yaml), saved and loaded:
    in f32 at B=1 (TF32 off) its outputs against the live model's to 1e-5
    (relative to max(1, |output|)); in bf16 at B=8 an Engine serving it
    answers 3 /detect requests, each raising B1 and B2 by exactly 8 and
    nothing else, its outputs against the live model's to 1e-2 (a bf16
    rounding), and the program's sampler calls take bf16 memory, as the
    live model's decoder does."""
    from parq_torch.config import ModelConfig
    from parq_torch.export import export_forward
    from parq_torch.models import build_model
    from parq_torch.serve import Engine
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    gaps = {}
    for dtype, B in (("float32", 1), ("bfloat16", 8)):
        tree = config_tree("eval.yaml", "TRAINER.PRECISION", "32",
                           "TPU.COMPUTE_DTYPE", dtype)
        mcfg = ModelConfig.from_cfg(tree)
        if dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        blob, _, batch = export_forward(tree, B, device="cuda")
        path = os.path.join(EXPORT_DIR, f"parq_fwd_{dtype}.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        engine = Engine.from_cfg(tree, artifact=path, batch_size=B,
                                 device="cuda")
        secs = time.perf_counter() - t0
        live = build_model(mcfg, seed=int(tree.SEED), device="cuda")
        mem_dtypes, hook = watch_memory_dtype(live)
        with torch.inference_mode():
            want = live(batch)
            got = engine.forward(batch)
        hook.remove()
        gaps[dtype] = _max_gap(got, want)
        seen = program_sampler_dtypes(blob)
        check(seen == [getattr(torch, dtype)] * mcfg.dec_layers
              and mem_dtypes == [getattr(torch, dtype)],
              f"export {dtype}: the program's sampler takes {seen}, the "
              f"live model's decoder {mem_dtypes}")
        limit = 1e-5 if dtype == "float32" else 1e-2
        check(gaps[dtype] <= limit, f"export {dtype}: artifact vs live "
              f"model {gaps[dtype]} > {limit}")
        phase("export", f"{dtype} B={B}: exported, saved ({len(blob)} "
              f"bytes), loaded and warmed up in {secs:.1f} s; artifact vs "
              f"live model {gaps[dtype]:.2e} of max(1, |output|) (limit "
              f"{limit}); the program's {len(seen)} sampler calls take "
              f"{seen[0]} memory, as the live model's decoder")
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        del live
    _, counts, n_dets = serve_requests(engine, requests, "export")
    check_serve_counts(counts, engine.cfg.model, requests, "export",
                       body_sites=0)
    phase("export", f"[{smi_line}] the bf16 artifact behind the server: "
          f"{requests} /detect requests answered, {n_dets} detections; "
          f"launches {counts} ({engine.cfg.model.dec_layers} of B1 and B2 "
          "per request)")
    del engine
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_serve_ckpt(ckpt):
    """An Engine from configs/eval.yaml with the fit's best checkpoint
    loaded strictly, then with the same weights as a reference-layout
    state_dict: on one snippet their detections equal those of the eval
    twin's model (a Trainer and `load_pretrained`, as cli/eval.py builds
    it), at the config's CONF_THRESH and at 0, and so do its outputs (to
    1e-4 of max(1, |output|): the detections may be none)."""
    from parq_torch.data.synthetic import make_batch
    from parq_torch.evals.parse_pred import parse_pred
    from parq_torch.models import BATCH_KEYS
    from parq_torch.serve import Engine
    from parq_torch.train.checkpoint import load_pretrained
    from parq_torch.train.loop import Trainer, to_device_batch
    tree = config_tree("eval.yaml", "LOG_PATH", CLI_DIR, "NAME", "serve")
    thresh = float(tree.MODEL.DECODER.CONF_THRESH)
    ref_path = os.path.join(CLI_DIR, "reference_layout.pt")
    torch.save(torch.load(ckpt, map_location="cpu", weights_only=True)
               ["model"], ref_path)
    raw = make_batch([100], image_size=tuple(tree.TPU.IMAGE_SIZE))
    request = {k: raw[k] for k in BATCH_KEYS}

    twin = Trainer(tree)
    twin.setup_state(steps_per_epoch=1)
    load_pretrained(twin.model, ckpt, strict=True)
    with torch.inference_mode():
        batch = to_device_batch(raw, "cuda")
        out = twin.model.eval()(batch)
    last = {k: v[-1] for k, v in out.items()}
    host = parse_pred(last, batch["T_world_local"],
                      tuple(tree.MODEL.DECODER.TRACK_SCALE),
                      int(tree.MODEL.DECODER.NUM_SEMCLS))
    center = last["center_unnormalized"].float().cpu().numpy()

    def twin_dets(t):
        keep = np.where(host["pred_mask"][0] & (host["scores"][0] >= t))[0]
        return [(int(host["labels"][0, k]), float(host["scores"][0, k]),
                 center[0, k]) for k in keep]
    del twin
    counts, gaps = {}, {}
    for label, path in (("checkpoint", ckpt), ("reference layout",
                                                ref_path)):
        engine = Engine.from_cfg(tree, checkpoint=path, batch_size=1)
        check(engine.cfg.conf_thresh == thresh, f"serve-ckpt: threshold "
              f"{engine.cfg.conf_thresh}, config {thresh}")
        gaps[label] = _max_gap(engine.forward(
            {k: batch[k] for k in BATCH_KEYS}), out)
        check(gaps[label] <= 1e-4, f"serve-ckpt {label}: outputs off the "
              f"eval twin's by {gaps[label]}")
        for t in (thresh, 0.0):
            engine.cfg = dataclasses.replace(engine.cfg, conf_thresh=t)
            got = engine.detect(request)[0]
            want = twin_dets(t)
            check([d["label"] for d in got] == [w[0] for w in want]
                  and all(abs(d["score"] - w[1]) <= 1e-4 and np.allclose(
                      d["center"], w[2], atol=1e-4, rtol=0)
                      for d, w in zip(got, want)),
                  f"serve-ckpt {label} at {t}: {len(got)} detections differ "
                  f"from the eval twin's {len(want)}")
            counts[(label, t)] = len(got)
        del engine
    phase("serve-ckpt", f"Engine from eval.yaml with "
          f"{os.path.relpath(ckpt, ROOT)} (strict), and as a "
          f"reference-layout state_dict: outputs off the eval twin's by "
          f"{gaps['checkpoint']:.2e} and {gaps['reference layout']:.2e} of "
          f"max(1, |output|) (limit 1e-4); detections equal at CONF_THRESH "
          f"{thresh} ({counts[('checkpoint', thresh)]}) and at 0 "
          f"({counts[('checkpoint', 0.0)]})")
    torch.cuda.empty_cache()


# ------------------------------------------------- parallel phases --
DIST_DIR = os.path.join(ROOT, "build", "chip_smoke_dist")
DIST_BACKEND = "gloo"   # NCCL refuses two ranks on one card
# [ddp]'s bf16 loss limit, ranks against one process over the global
# batch, from parq_torch/tools/ddp_loss_gap.py's readings (PERF.md §6): at
# most 2.63e-2 over 18 generator seeds (6 at the parent, 12 here), and the
# control (rank 0's rows twice) 4.10e-2 at this phase's seed 1
DDP_BF16_LOSS_RTOL = 3e-2


def run_ranks(fn, world, *args, timeout=600.0):
    """`world` processes on the one card, each joining one gloo group
    through a file:// rendezvous under build/, each running fn(rank,
    world, *args) and saving its result. Fails if any rank raises, exits
    non-zero or outlives `timeout`; leaves no process running."""
    import torch.multiprocessing as mp
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    torch.cuda.empty_cache()
    ctx = mp.start_processes(_rank_entry, args=(fn, world, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"{fn.__name__}: ranks did not finish in {timeout} s")
    except mp.ProcessRaisedException as e:
        raise SmokeFailure(f"{fn.__name__}: a rank failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise SmokeFailure(f"{fn.__name__}: a rank exited: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in ctx.processes]
    check(codes == [0] * world, f"{fn.__name__}: rank exit codes {codes}")
    out = [torch.load(os.path.join(DIST_DIR, f"rank{r}.pt"),
                      weights_only=False) for r in range(world)]
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return out


def _rank_entry(rank, fn, world, args):
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        DIST_BACKEND, init_method=f"file://{DIST_DIR}/rendezvous",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        torch.save(fn(rank, world, *args),
                   os.path.join(DIST_DIR, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _grads_cpu(model):
    return {n: p.grad.detach().float().cpu()
            for n, p in model.named_parameters() if p.grad is not None}


def _f32_gate_cfg(cfg, rate):
    """The gates' model: f32, L=2, dropout `rate`; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dataclasses.replace(cfg, compute_dtype="float32",
                               dropout_rate=rate, dec_layers=2)


def _f32_step_grads(cfg, mesh):
    """One f32 step's loss and gradients, TF32 off, dropout 0, L=2, B=1,
    fixed matcher draws; `mesh` None is one process."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.models import build_model
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import forward_and_loss
    f32 = _f32_gate_cfg(cfg, 0.0)
    raw = make_batch([5], image_size=f32.image_size)
    u = torch.rand((f32.dec_layers, f32.num_queries,
                    raw["obbs_padded"].shape[1]),
                   generator=torch.Generator().manual_seed(0))
    model = build_model(f32, seed=1, device="cuda").train()
    if mesh is not None:
        model.set_parallel(mesh, True)
    losses, _ = forward_and_loss(model, to_device(raw, TRAIN_KEYS, "cuda"),
                                 None, uniforms=u)
    losses["total_loss"].backward()
    return float(losses["total_loss"].detach()), _grads_cpu(model)


def _compare_grads(got, want, rtol, floor):
    """The worst ‖Δ‖ / (rtol·max(‖g‖, 1) + floor) over the parameters,
    and its name (≤ 1 passes)."""
    worst, name = 0.0, ""
    check(sorted(got) == sorted(want), "gradients of other parameters")
    for n, g in want.items():
        r = float((got[n] - g).norm()) / (rtol * max(float(g.norm()), 1.0)
                                          + floor)
        if r > worst:
            worst, name = r, n
    return worst, name


def _grad_gap(got, want):
    """‖ΔG‖ / ‖G‖ over all parameters."""
    total = math.sqrt(sum(float(g.norm()) ** 2 for g in want.values()))
    diff = math.sqrt(sum(float((got[n] - g).norm()) ** 2
                         for n, g in want.items()))
    return diff / total


def _sp_rank(rank, world, cfg, B, steps):
    """A rank of the sp phase: the f32 gate's gradients (rank 0 also takes
    the one-process step), `steps` bf16 training steps with their launch
    counts and CUDA-event ms, one SP validation forward."""
    import torch.distributed as dist
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import BATCH_KEYS, build_model
    from parq_torch.parallel.mesh import make_mesh, replicated
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import make_optimizer, train_step
    mesh = make_mesh(data=1, model=world)
    out = {}
    out["f32"] = _f32_step_grads(cfg, mesh)
    if rank == 0:
        out["f32_one"] = _f32_step_grads(cfg, None)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    model = replicated(build_model(cfg, seed=0, device="cuda").train())
    model.set_parallel(mesh, True)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    counts, ms, losses = [], [], []
    for step in range(steps):
        batch = to_device(make_batch(list(range(step * B, (step + 1) * B)),
                                     image_size=cfg.image_size),
                          TRAIN_KEYS, "cuda")
        dist.barrier()
        reset_launch_counts()
        t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t[0].record()
        m = train_step(model, opt, batch, gen, model_group=mesh.model_group)
        t[1].record()
        torch.cuda.synchronize()
        counts.append(launch_counts())
        ms.append(t[0].elapsed_time(t[1]))
        losses.append((float(m["total_loss"]), float(m["grad_norm"])))
    out["steps"] = (counts, ms, losses)
    out["params"] = {n: p.detach().float().cpu()
                     for n, p in model.named_parameters()}
    model.eval()
    batch = to_device(make_batch(list(range(B)), image_size=cfg.image_size),
                      BATCH_KEYS, "cuda")
    reset_launch_counts()
    with torch.inference_mode():
        o = model(batch)
    torch.cuda.synchronize()
    out["val"] = (launch_counts(),
                  all(bool(torch.isfinite(v.float()).all())
                      for v in o.values() if v.dtype != torch.bool))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def phase_sp(cfg, B=8, steps=3):
    """Sequence parallelism, two ranks on the one card (gloo): the f32 gate
    against one process; `steps` release bf16 steps (L=8, dropout 0.1);
    an SP validation forward. Returns rank 0's launch counts of the bf16
    steps, summed."""
    t0 = time.perf_counter()
    outs = run_ranks(_sp_rank, 2, cfg, B, steps)
    (loss, grads), (loss1, grads1) = outs[0]["f32"], outs[0]["f32_one"]
    worst, name = _compare_grads(grads, grads1, 2e-4, 1e-3)
    worst_r, name_r = _compare_grads(outs[1]["f32"][1], grads1, 2e-4, 1e-3)
    phase("sp", f"backend {DIST_BACKEND}, 2 ranks on one card, MESH_MODEL 2: "
          f"f32 gate (TF32 off, L=2, B=1, dropout 0) loss {loss:.7f} and "
          f"{outs[1]['f32'][0]:.7f} vs one process {loss1:.7f}; "
          f"{len(grads)} gradients, worst {worst:.3f} and {worst_r:.3f} of "
          f"the limit 2e-4·max(‖g‖, 1) + 1e-3 ({name}; {name_r}); "
          f"‖ΔG‖/‖G‖ {_grad_gap(grads, grads1):.2e} and "
          f"{_grad_gap(outs[1]['f32'][1], grads1):.2e}")
    for l_r in (loss, outs[1]["f32"][0]):
        check(abs(l_r - loss1) <= 1e-5 * abs(loss1), f"sp f32: loss {l_r} vs "
              f"one process {loss1} (rtol 1e-5)")
    check(max(worst, worst_r) <= 1.0, f"sp f32: {name} / {name_r} gradient "
          f"off by {max(worst, worst_r)} of its limit")
    for r, o in enumerate(outs):
        counts, ms, losses = o["steps"]
        for i, c in enumerate(counts):
            check(c == SP_TRAIN_KERNELS, f"sp rank {r} step {i}: launches "
                  f"{c}, want {SP_TRAIN_KERNELS}")
        check(all(math.isfinite(a) and math.isfinite(b) for a, b in losses),
              f"sp rank {r}: losses {losses}")
        vc, finite = o["val"]
        check(vc == SP_VAL_KERNELS and finite, f"sp rank {r} validation: "
              f"launches {vc}, want {SP_VAL_KERNELS}; finite {finite}")
    same = all(torch.equal(p, outs[1]["params"][n])
               for n, p in outs[0]["params"].items())
    check(same, "sp: the ranks' parameters parted after the bf16 steps")
    counts, ms, losses = outs[0]["steps"]
    phase("sp", f"{steps} bf16 steps at B={B}, L={cfg.dec_layers}, dropout "
          f"{cfg.dropout_rate}: losses/grad norms rank 0 {losses}, rank 1 "
          f"{outs[1]['steps'][2]}; parameters equal on both ranks bit for "
          f"bit after the steps; per rank per step launches {counts[-1]}; "
          f"step ms {[round(x, 2) for x in ms]} (CUDA events; two ranks "
          "share the card's SMs); peak memory per rank "
          f"{[round(o['peak_gb'], 2) for o in outs]} GB")
    phase("sp", f"validation forward at B={B}: launches per rank "
          f"{outs[0]['val'][0]}; outputs finite; wall of the phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _ddp_rank(rank, world, cfg, B):
    """A rank of the ddp phase: the f32 gate (one row a rank) and one bf16
    release step (B/2 rows a rank); rank 0 then takes each one-process
    step over the whole batch."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import build_model
    from parq_torch.parallel.mesh import make_mesh, replicated, shard_batch
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import make_optimizer, train_step
    mesh = make_mesh(data=world, model=1)

    def step(mcfg, rows, mesh):
        model = build_model(mcfg, seed=0, device="cuda").train()
        if mesh is not None:           # one process: no collective
            replicated(model).set_parallel(mesh, False)
        gen = torch.Generator(device="cuda").manual_seed(1)
        reset_launch_counts()
        m = train_step(model, make_optimizer(model), rows, gen,
                       data_group=None if mesh is None else mesh.data_group)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()}, _grads_cpu(model),
                launch_counts())

    def split_loss(mcfg, batch, parts):
        """The loss the ranks' step reports, computed in this one process:
        each rank's rows as that data index (its dropout rows and matcher
        draws), the losses weighted as train_step's data weighting does,
        Σ loss_r·max(valid_r, 1) / max(Σ valid_r, 1)."""
        from parq_torch.train.train_step import forward_and_loss
        total = valid = 0.0
        n = batch["rgb_img"].shape[0] // parts
        for r in range(parts):
            model = build_model(mcfg, seed=0, device="cuda").train()
            model.box3d_decoder.set_parallel(None, r, parts)
            gen = torch.Generator(device="cuda").manual_seed(1)
            losses, _ = forward_and_loss(
                model, {k: v[r * n:(r + 1) * n] for k, v in batch.items()},
                gen)
            v = float(losses["valid_bs"])
            total += float(losses["total_loss"]) * max(v, 1.0)
            valid += v
        return total / max(valid, 1.0)

    out = {}
    for name, mcfg, n in (("f32", _f32_gate_cfg(cfg, cfg.dropout_rate), 2),
                          ("bf16", cfg, B)):
        if name == "bf16":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        batch = to_device(make_batch(list(range(n)),
                                     image_size=cfg.image_size),
                          TRAIN_KEYS, "cuda")
        out[name] = step(mcfg, shard_batch(batch, mesh), mesh)
        torch.cuda.empty_cache()
        if rank == 0:
            out[name + "_one"] = step(mcfg, batch, None)
            if name == "bf16":
                out["bf16_split"] = split_loss(mcfg, batch, world)
                # the gate's control: rank 1 given rank 0's rows
                out["bf16_dup"] = step(mcfg, to_device(make_batch(
                    list(range(n // 2)) * 2, image_size=cfg.image_size),
                    TRAIN_KEYS, "cuda"), None)
            if name == "bf16":    # the yardstick: the same step in f32
                out["f32_one_b8"] = step(dataclasses.replace(
                    _f32_gate_cfg(cfg, cfg.dropout_rate),
                    dec_layers=cfg.dec_layers), batch, None)
        torch.cuda.empty_cache()
    return out


def phase_ddp(cfg, B=8):
    """Data parallelism, two ranks on the one card (gloo), dropout 0.1, the
    same seeds as one process over the whole batch, so the ranks draw its
    dropout masks and matcher draws: the f32 gate (TF32 off, L=2, one row a
    rank) to the sp gate's tolerance, and one release bf16 step (B/2 rows a
    rank). In bf16 the products over 4 rows instead of 8 round otherwise,
    and with random weights the matcher's near ties then break otherwise
    for some queries. So the bf16 step's loss is held to the one-process
    step over the whole batch within DDP_BF16_LOSS_RTOL, a limit set from
    the readings of `parq_torch/tools/ddp_loss_gap.py` over generator
    seeds, and a control must fail that gate: the one-process step over
    rank 0's rows twice (what the ranks would report if rank 1 took rank
    0's rows). Besides, the loss equals to 1e-5 the same split computed in
    one process (each rank's rows as its data index, the losses weighted
    as the ranks weigh them), and the clipped gradients are within twice
    the distance of the one-process B=8 bf16 step from the same step in
    f32 (‖ΔG‖/‖G‖), at least 5e-2."""
    outs = run_ranks(_ddp_rank, 2, cfg, B)
    o = outs[0]
    (m, grads, _), (m1, grads1, _) = o["f32"], o["f32_one"]
    worst, name = _compare_grads(grads, grads1, 2e-4, 1e-3)
    phase("ddp", f"backend {DIST_BACKEND}, 2 ranks on one card, MESH_DATA 2: "
          f"f32 gate (TF32 off, L=2, 1 row a rank, dropout "
          f"{cfg.dropout_rate}) loss {m['total_loss']:.7f} vs one process "
          f"at B=2 {m1['total_loss']:.7f}; clipped gradients worst "
          f"{worst:.3f} of the limit 2e-4·max(‖g‖, 1) + 1e-3 ({name}), "
          f"‖ΔG‖/‖G‖ {_grad_gap(grads, grads1):.2e}")
    check(abs(m["total_loss"] - m1["total_loss"]) <= 1e-5 *
          abs(m1["total_loss"]) and worst <= 1.0 and
          m["valid_bs"] == m1["valid_bs"], f"ddp f32: loss "
          f"{m['total_loss']} vs {m1['total_loss']}, worst gradient {worst}")
    (m, grads, counts), (m1, grads1, _) = o["bf16"], o["bf16_one"]
    want = dict(TRAIN_KERNELS, pixel_align_sample=cfg.dec_layers,
                flash_cross_attention_fwd_train=cfg.dec_layers)
    for r, ro in enumerate(outs):
        check(ro["bf16"][2] == want, f"ddp rank {r}: launches "
              f"{ro['bf16'][2]}")
    m32, grads32, _ = o["f32_one_b8"]
    lim = DDP_BF16_LOSS_RTOL
    rel = abs(m["total_loss"] - m1["total_loss"]) / abs(m1["total_loss"])
    dup = o["bf16_dup"][0]["total_loss"]
    rel_dup = abs(dup - m1["total_loss"]) / abs(m1["total_loss"])
    split = o["bf16_split"]
    rel_split = abs(m["total_loss"] - split) / abs(split)
    gap = _grad_gap(grads, grads1)
    rel32 = abs(m1["total_loss"] - m32["total_loss"]) / abs(m32["total_loss"])
    gap32 = _grad_gap(grads1, grads32)
    lim_g = max(2 * gap32, 5e-2)
    phase("ddp", f"bf16 step, 2 ranks x {B // 2} rows, dropout "
          f"{cfg.dropout_rate}: loss {m['total_loss']:.6f} vs one process at "
          f"B={B} {m1['total_loss']:.6f} (rel {rel:.2e}; limit {lim:.1e}); "
          f"the control, one process over rank 0's rows twice, "
          f"{dup:.6f} (rel {rel_dup:.2e}; must fail the limit); the same "
          f"split in one process {split:.6f} (rel {rel_split:.2e}; limit "
          f"1e-5); grad norm {m['grad_norm']:.5f} vs {m1['grad_norm']:.5f}; "
          f"clipped gradients ‖ΔG‖/‖G‖ {gap:.2e} (limit {lim_g:.2e}); the "
          f"one-process step in f32: loss {m32['total_loss']:.6f} (bf16 off "
          f"by {rel32:.2e}), grad norm {m32['grad_norm']:.5f}, ‖ΔG‖/‖G‖ "
          f"{gap32:.2e}; valid_bs {m['valid_bs']:.0f} vs "
          f"{m1['valid_bs']:.0f}; per rank launches {counts}")
    check(rel <= lim and rel_split <= 1e-5 and gap <= lim_g
          and m["valid_bs"] == m1["valid_bs"],
          f"ddp bf16: loss rel {rel} against one process (limit {lim}), "
          f"{rel_split} against the same split in one process (limit "
          f"1e-5), ‖ΔG‖/‖G‖ {gap} (limit {lim_g})")
    check(rel_dup > lim, f"ddp bf16: the control (rank 0's rows twice) is "
          f"within {rel_dup} of one process, inside the gate's {lim}")


def phase_fit_sp(smi_line):
    """`python -m parq_torch.cli.train` under torchrun, 2 ranks on the card
    (gloo), TPU.SEQ_PARALLEL True, MESH_MODEL 2: 2 steps, 1 validation, a
    checkpoint written once (by rank 0), then the final validation."""
    name = "fit-sp"
    work = os.path.join(CLI_DIR, name)
    shutil.rmtree(work, ignore_errors=True)
    opts = cli_opts(name, "DATAMODULE.BATCH_SIZE", "8",
                    "DATAMODULE.NUM_WORKERS", "0", "TRAINER.MAX_EPOCHS", "1",
                    "TRAINER.LIMIT_TRAIN_BATCHES", "2",
                    "TRAINER.VAL_CHECK_INTERVAL", "0.5",
                    "TRAINER.LIMIT_VAL_BATCHES", "1",
                    "TRAINER.LOG_EVERY_N_STEPS", "1",
                    "CALLBACK.SAVE_TOP_K", "1", "TPU.SEQ_PARALLEL", "True",
                    "TPU.MESH_MODEL", "2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "parq_torch.cli.train", "--cfg",
           os.path.join(ROOT, "configs", "train.yaml"), *opts]
    env = dict(os.environ, PARQ_DIST_BACKEND=DIST_BACKEND,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise SmokeFailure("fit-sp: torchrun did not finish in 400 s")
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"fit-sp: torchrun exited "
          f"{proc.returncode}:\n{text[-3000:]}")
    writes = [ln for ln in text.splitlines() if "checkpoint: wrote step" in ln]
    backends = [ln for ln in text.splitlines() if "torch.distributed: rank" in
                ln]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if r["stage"] == "train"]
    vals = [r for r in rows if r["stage"] == "val/metrics"]
    check(len(writes) == 1 and "step 2" in writes[0], f"fit-sp: checkpoint "
          f"writes {writes}, want one at step 2")
    check(len(backends) == 2 and all(f"backend {DIST_BACKEND}" in b
                                     for b in backends),
          f"fit-sp: process group lines {backends}")
    check([r["step"] for r in train] == [1, 2] and len(vals) == 1
          and all(math.isfinite(r["total_loss"]) for r in train),
          f"fit-sp: metrics rows {rows}")
    ckpts = sorted(f for f in os.listdir(os.path.join(work, "checkpoints"))
                   if f.endswith(".pt"))
    check(ckpts == ["step_2.pt"], f"fit-sp: checkpoints {ckpts}")
    phase("fit", f"[{smi_line}] torchrun, 2 ranks, backend {DIST_BACKEND}, "
          f"SEQ_PARALLEL, MESH_MODEL 2: steps {[r['step'] for r in train]} "
          f"losses {[round(r['total_loss'], 5) for r in train]}, 1 "
          f"validation, checkpoint {ckpts} written once (by rank 0), final "
          f"validation on it; {wall:.1f} s wall")
    shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------ tensor parallelism --
TP_DIR = os.path.join(ROOT, "build", "chip_smoke_tp")
TP_LR = 1e-4


def _tp_step(cfg, mesh, batch):
    """One train_step of the model from seed 0, the step's generator
    seeded 1 (mesh None: one process): the model, its optimizer, the
    metrics, and the clipped gradients and updated parameters in the
    reference layout."""
    from parq_torch.models import build_model
    from parq_torch.parallel.tensor_parallel import gathered, shard_model_
    from parq_torch.train.train_step import make_optimizer, train_step
    model = build_model(cfg, seed=0, device="cuda").train()
    if mesh is not None:
        shard_model_(model, mesh)
    opt = make_optimizer(model, lr=TP_LR)
    gen = torch.Generator(device="cuda").manual_seed(1)
    m = train_step(model, opt, batch, gen,
                   model_group=None if mesh is None else mesh.model_group)
    torch.cuda.synchronize()
    grads = gathered(model, {n: p.grad for n, p in model.named_parameters()})
    params = gathered(model, {n: p.detach() for n, p in
                              model.named_parameters()})
    return (model, opt, {k: float(v) for k, v in m.items()},
            {n: g.float().cpu() for n, g in grads.items()},
            {n: p.float().cpu() for n, p in params.items()})


def _tp_rank(rank, world, cfg, B, steps):
    """A rank of the tp phase: the f32 gate's TP step (rank 0 also takes
    the one-process step), its checkpoint and eval forward; then `steps`
    bf16 release steps with their launch counts, CUDA-event ms and peak
    memory."""
    import torch.distributed as dist
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import BATCH_KEYS, build_model
    from parq_torch.parallel.mesh import make_mesh
    from parq_torch.parallel.tensor_parallel import shard_model_
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.checkpoint import CheckpointManager
    from parq_torch.train.train_step import make_optimizer, train_step
    mesh = make_mesh(data=1, model=world)
    f32 = _f32_gate_cfg(cfg, cfg.dropout_rate)
    raw = make_batch([0, 1], image_size=cfg.image_size)
    batch = to_device(raw, TRAIN_KEYS, "cuda")
    model, opt, *out_f32 = _tp_step(f32, mesh, batch)
    out = {"f32": out_f32}
    CheckpointManager(TP_DIR, save_top_k=1).save(1, model, opt)
    with torch.no_grad():
        o = model.eval()(to_device(raw, BATCH_KEYS, "cuda"))
    out["fwd"] = {k: v.float().cpu() for k, v in o.items()}
    del model, opt
    if rank == 0:
        out["f32_one"] = _tp_step(f32, None, batch)[2:]
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    model = shard_model_(build_model(cfg, seed=0, device="cuda").train(),
                         mesh)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    counts, ms, losses = [], [], []
    for step in range(steps):
        batch = to_device(make_batch(list(range(step * B, (step + 1) * B)),
                                     image_size=cfg.image_size),
                          TRAIN_KEYS, "cuda")
        dist.barrier()
        reset_launch_counts()
        t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t[0].record()
        m = train_step(model, opt, batch, gen, model_group=mesh.model_group)
        t[1].record()
        torch.cuda.synchronize()
        counts.append(launch_counts())
        ms.append(t[0].elapsed_time(t[1]))
        losses.append((float(m["total_loss"]), float(m["grad_norm"])))
    layer = model.box3d_decoder.parq_module.decoder.layers[0]
    out["bf16"] = (counts, ms, losses,
                   torch.cuda.max_memory_allocated() / 2 ** 30,
                   (layer.self_attn.in_proj_weight.shape[0] // 3
                    // (cfg.dec_dim // cfg.dec_heads),
                    layer.linear1.weight.shape[0]))
    return out


def _adam_step_gap(params, params1, grads, grads1):
    """The updated parameters' largest gap where Adam's first step is well
    posed, less the f32 rounding of the parameter (1e-6·|p|); and the
    largest gap anywhere. The first step is lr·g/(|g| + eps), eps 1e-8: a
    gradient error Δg moves it by about lr·eps·|Δg|/|g|², at most
    1e-3·lr where |g| > max(10·|Δg|, 1e-6) ("well posed"); elsewhere it
    can take either sign, up to lr."""
    posed_gap, any_gap = 0.0, 0.0
    for n, p1 in params1.items():
        g1 = grads1[n]
        posed = g1.abs() > torch.clamp(10 * (grads[n] - g1).abs(), min=1e-6)
        diff = (params[n] - p1).abs()
        excess = torch.where(posed, diff - 1e-6 * p1.abs(), 0.0)
        posed_gap = max(posed_gap, float(excess.max()))
        any_gap = max(any_gap, float(diff.max()))
    return posed_gap, any_gap


def phase_tp(cfg, smi_line, B=8, steps=3):
    """Tensor parallelism, two ranks on the one card (gloo), model 2 at
    release width: the f32 gate, the bf16 steps, the TP checkpoint in one
    process, and the dryrun_multichip twin on 4 ranks."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.models import BATCH_KEYS, build_model
    from parq_torch.parallel import dryrun_multichip
    from parq_torch.train.checkpoint import load_pretrained
    t0 = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    outs = run_ranks(_tp_rank, 2, cfg, B, steps)
    m1, grads1, params1 = outs[0]["f32_one"]
    for r, o in enumerate(outs):
        m, grads, params = o["f32"]
        rel = abs(m["total_loss"] - m1["total_loss"]) / abs(m1["total_loss"])
        rel_n = abs(m["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
        worst, name = _compare_grads(grads, grads1, 2e-4, 1e-3)
        posed, anyg = _adam_step_gap(params, params1, grads, grads1)
        phase("tp", f"rank {r}: f32 gate (TF32 off, L=2, B=2, dropout "
              f"{cfg.dropout_rate}, lr {TP_LR}) TP step vs one process: loss "
              f"{m['total_loss']:.7f} vs {m1['total_loss']:.7f} (rel "
              f"{rel:.2e}, limit 1e-5), grad_norm {m['grad_norm']:.6f} vs "
              f"{m1['grad_norm']:.6f} (rel {rel_n:.2e}, limit 1e-5); "
              f"{len(grads)} clipped gradients in the reference layout, "
              f"worst {worst:.3f} of the limit 2e-4·max(‖g‖, 1) + 1e-3 "
              f"({name}); updated parameters where Adam's step is well posed "
              f"off by {posed:.2e} beyond 1e-6·|p| (limit 1e-3·lr = "
              f"{1e-3 * TP_LR:.0e}), anywhere {anyg:.2e} (limit 2·lr)")
        check(rel <= 1e-5 and rel_n <= 1e-5 and worst <= 1.0
              and posed <= 1e-3 * TP_LR and anyg <= 2 * TP_LR + 1e-6,
              f"tp f32 rank {r}: loss rel {rel}, grad_norm rel {rel_n}, "
              f"gradient {worst} of its limit, parameters {posed} / {anyg}")
    for r, o in enumerate(outs):
        counts, ms, losses, peak, local = o["bf16"]
        for i, c in enumerate(counts):
            check(c == TRAIN_KERNELS, f"tp rank {r} step {i}: launches {c}, "
                  f"want {TRAIN_KERNELS}")
        check(all(math.isfinite(a) and math.isfinite(b) for a, b in losses),
              f"tp rank {r}: losses {losses}")
        phase("tp", f"[{smi_line}] rank {r}: {steps} bf16 steps at B={B}, "
              f"L={cfg.dec_layers}, dim {cfg.dec_dim}, {local[0]} of "
              f"{cfg.dec_heads} self-attention heads and {local[1]} of "
              f"{cfg.dec_ffn_dim} FFN columns a rank: step ms "
              f"{[round(x, 2) for x in ms]} (CUDA events; the two ranks "
              f"share the one card's SMs, so this is no scaling figure); "
              f"launches per step {counts[-1]}; losses/grad norms {losses}; "
              f"peak memory {peak:.2f} GB")
    # the TP checkpoint, written in the reference layout, in one process
    raw = make_batch([0, 1], image_size=cfg.image_size)
    one = build_model(_f32_gate_cfg(cfg, cfg.dropout_rate), seed=3,
                      device="cuda")
    load_pretrained(one, os.path.join(TP_DIR, "step_1.pt"), strict=True)
    with torch.no_grad():
        want = one(to_device(raw, BATCH_KEYS, "cuda"))
    gap = _max_gap(outs[0]["fwd"], {k: v.float().cpu() for k, v in
                                    want.items()})
    phase("tp", f"TP checkpoint (gathered, written by rank 0) loaded "
          f"strictly into one process: its f32 forward vs the TP ranks' at "
          f"B=2, max |Δ| / max(1, max |want|) {gap:.2e} (limit 1e-4)")
    check(gap <= 1e-4, f"tp checkpoint: forward off by {gap}")
    del one
    torch.cuda.empty_cache()
    text = dryrun_multichip(4, "cuda")
    first = text.splitlines()[0]
    check(first.startswith("dryrun_multichip(4): mesh={'data': 2, 'model': "
                           "2} loss=") and first.endswith(
                               "OK (+SP attention exact)"),
          f"tp: dryrun line {first!r}")
    phase("tp", f"wall of the phase {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(TP_DIR, ignore_errors=True)


# ------------------------------------------------------------------ vis --
VIS_DIR = os.path.join(ROOT, "build", "chip_smoke_vis")


def phase_vis(smi_line):
    """The vis utilities on the card's host: Trainer.validate(for_vis) at
    release width, one log_images call, and the eval twin with FOR_VIS."""
    from parq_torch.cli import eval as cli_eval
    from parq_torch.data import SnippetLoader, SyntheticDataset
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.train.loop import Trainer, to_device_batch
    from parq_torch.utils import vis
    shutil.rmtree(VIS_DIR, ignore_errors=True)
    cfg = config_tree("eval.yaml", "MODEL.DECODER.FOR_VIS", "True",
                      "LOG_IMAGES", "True", "LOG_PATH", VIS_DIR, "NAME",
                      "vis")
    trainer = Trainer(cfg)
    trainer.setup_state(steps_per_epoch=1)
    ds = SyntheticDataset(num_snippets=2, image_size=tuple(cfg.TPU.IMAGE_SIZE),
                          seed=1000)
    loader = SnippetLoader(ds, 1, shuffle=False, drop_last=False)
    out_dir = os.path.join(VIS_DIR, "validate_vis")
    reset_launch_counts()
    trainer.validate(loader, for_vis=True, vis_dir=out_dir)
    counts = launch_counts()
    want = {k: 2 * v for k, v in VAL_KERNELS.items()}
    check(counts == want, f"vis: launches {counts}, want {want}")
    pngs = sorted(os.listdir(out_dir))
    W, H = cfg.TPU.IMAGE_SIZE
    shapes = {vis.read_png(os.path.join(out_dir, p)).shape for p in pngs}
    check(len(pngs) == 2 and shapes == {(3 * H, W, 3)},
          f"vis: FOR_VIS PNGs {pngs} of shapes {shapes}")
    phase("vis", f"Trainer.validate(for_vis=True) at release width, bf16, 2 "
          f"synthetic snippets: {pngs}, each {(3 * H, W, 3)}; launches "
          f"{counts}")

    batch = next(iter(loader))
    dev = to_device_batch(batch, trainer.device)
    with torch.no_grad():
        outputs, feat = trainer.model(dev, deterministic=True,
                                      return_feature_map=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    paths = trainer.log_images(batch, outputs, "val", feat)
    host_ms = 1e3 * (time.perf_counter() - t)
    gt = vis.read_png(paths[1])
    plain = vis.to_uint8(np.concatenate([vis.normalize_img(v) for v in
                                         batch["rgb_img"][0]], axis=0))
    drawn = int((gt != plain).any(-1).sum())
    check(drawn > 100, f"vis: the GT overlay has {drawn} box pixels")
    phase("vis", f"[{smi_line}] one log_images call (parse_pred with NMS, "
          f"the prediction and GT overlays, the feature map's PCA, 3 PNGs): "
          f"{host_ms:.1f} ms on the host; {[os.path.basename(p) for p in paths]}"
          f"; the GT overlay's box pixels {drawn}")

    out = io.StringIO()
    reset_launch_counts()
    with contextlib.chdir(VIS_DIR), contextlib.redirect_stdout(out):
        cli_eval.main(["--cfg", os.path.join(ROOT, "configs", "eval.yaml"),
                       *cli_opts("vis-eval", "MODEL.DECODER.FOR_VIS",
                                 "True", "DATAMODULE.BATCH_SIZE", "1",
                                 "CHECKPOINT_PATH", "None")])
    counts = launch_counts()
    pngs = sorted(os.listdir(os.path.join(VIS_DIR, "demo_vis")))
    check(len(pngs) == 8 and counts == {k: 8 * v for k, v in
                                        VAL_KERNELS.items()},
          f"vis: the eval twin wrote {pngs}, launches {counts}")
    phase("vis", f"python -m parq_torch.cli.eval on eval.yaml (random "
          f"weights from SEED), MODEL.DECODER.FOR_VIS True, DATA_PATH "
          f"synthetic: {len(pngs)} "
          f"PNGs in demo_vis/ (e.g. {pngs[0]}); launches {counts}")
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(VIS_DIR, ignore_errors=True)


# ------------------------------------------- the bench twin, the rehearsal --
BENCH_KEYS = {"metric", "value", "unit", "device", "host_cpu",
              "device_busy_ms", "wall_ms", "launches_per_iter"}
REHEARSAL_DIR = os.path.join(ROOT, "build", "chip_smoke_rehearsal")
REHEARSAL_KEYS = ("pred_logits", "center_unnormalized", "size_unnormalized",
                  "ortho6d", "coord_pos")


def run_bench(*flags, timeout=400):
    """`python -m parq_torch.bench [flags]` in a process of its own: its
    one JSON line and its seconds; a non-zero exit fails the run."""
    cmd = [sys.executable, "-m", "parq_torch.bench", *flags]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"bench {flags}: no line in {timeout} s")
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"bench {flags}: exit {res.returncode}:\n"
          f"{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    check(len(lines) == 1, f"bench {flags}: {len(lines)} lines, want one: "
          f"{res.stdout[-2000:]}")
    return json.loads(lines[0]), wall


def phase_bench(cfg, train_counts, train_steps, smi_line):
    """The bench twin at its default flags, eval and --train: its keys,
    a rate above 0 and below the plausibility guard, and its kernels'
    launches per iteration (B1 and B2 L each a forward, the frozen-BN pass
    49; a step's those of `phase_train`)."""
    from parq_torch.bench import guard_fps
    from parq_torch.kernels import SERVE_KERNELS
    torch.cuda.empty_cache()
    runs = {}
    for train in (False, True):
        out, wall = run_bench(*(["--train"] if train else []))
        metric = ("train_frames_per_sec_per_chip" if train
                  else "multi_view_frames_per_sec_per_chip")
        keys = BENCH_KEYS | ({"vs_baseline"} if not train else set())
        check(set(out) == keys and out["metric"] == metric
              and out["unit"] == "frames/sec/chip",
              f"bench: line {out}, want the keys {sorted(keys)}")
        guard = guard_fps(cfg, train)
        check(0 < out["value"] < guard, f"bench: {metric} {out['value']} "
              f"outside (0, {guard:.0f})")
        check(out["device_busy_ms"] is not None
              and 0 < out["device_busy_ms"] < 1e3 * out["wall_ms"],
              f"bench: device_busy_ms {out['device_busy_ms']}, wall_ms "
              f"{out['wall_ms']}")
        if train:
            want = {k: v / train_steps for k, v in train_counts.items() if v}
        else:
            want = dict({k: float(cfg.dec_layers) for k in SERVE_KERNELS},
                        frozen_bn=float(BODY_SITES))
        check(out["launches_per_iter"] == want, f"bench: {metric} "
              f"launches per iteration {out['launches_per_iter']}, want "
              f"{want}")
        runs[metric] = (out, wall)
        phase("bench", f"[{smi_line}] {json.dumps(out)}")
    phase("bench", ", ".join(f"{m} {w:.1f} s" for m, (_, w)
                             in runs.items())
          + f" (phase {sum(w for _, w in runs.values()):.1f} s); guard "
          f"{guard_fps(cfg):.0f} frames/s (eval), "
          f"{guard_fps(cfg, True):.0f} (train)")


def iteration_gaps(got, want, mean_tab, L, label):
    """The release rehearsal's envelope: per iteration l every output
    within 1.5e-3·2.8^l of `want`'s, sizes divided by their own mean row
    and an argmax flip allowed only where `want`'s logit gap is below
    twice that. Returns each iteration's worst error and its output."""
    worst = []
    for l in range(L):
        tol = 1.5e-3 * (2.8 ** l)
        errs = {}
        for key in REHEARSAL_KEYS:
            ours, theirs = got[key][l], want[key][l]
            if key == "size_unnormalized":
                lo, lt = got["pred_logits"][l], want["pred_logits"][l]
                ao, at = lo.argmax(-1), lt.argmax(-1)
                errs[key] = float(np.max(np.abs(ours / mean_tab[ao]
                                                - theirs / mean_tab[at])))
                flips = ao != at
                if flips.any():
                    gap = np.abs(np.take_along_axis(lt, ao[..., None], -1)
                                 - np.take_along_axis(lt, at[..., None], -1)
                                 )[..., 0][flips]
                    check(gap.max() < 2 * tol, f"{label} iteration {l}: an "
                          f"argmax flip with logit gap {gap.max()} >= "
                          f"{2 * tol} (not a near-tie)")
            else:
                errs[key] = float(np.max(np.abs(ours - theirs)))
            check(errs[key] < tol, f"{label} iteration {l} {key}: max abs "
                  f"err {errs[key]} >= {tol}")
        worst.append(max((e, k) for k, e in errs.items()))
    return worst


def phase_rehearsal(smi_line):
    """The release dress rehearsal on the card: a checkpoint in
    parq_release.ckpt's layout (`synthesize_release_checkpoint`) loaded
    strictly by the eval twin on configs/eval.yaml (CONF_THRESH 0.05, the
    real mean-size table, LIMIT_VAL_BATCHES 2, 2 synthetic snippets of one
    scene), f32 with TF32 off, on the card and on the CPU: every
    iteration's outputs within the rehearsal's envelope, the F1 dicts
    within 0.15, and per snippet B1 8, B2 8 and M1 1 launch, M1 on the
    loss's 100 targets."""
    from parq_torch import data as pdata
    from parq_torch.cli import eval as cli_eval
    from parq_torch.geometry.obb import MAX_BOXES
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models.box_processor import load_mean_size_table
    from parq_torch.ops import hungarian
    from parq_torch.tools.release_ckpt import synthesize_release_checkpoint
    from parq_torch.train import loop
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)
    os.makedirs(REHEARSAL_DIR)
    t0 = time.perf_counter()
    ckpt = synthesize_release_checkpoint(
        os.path.join(REHEARSAL_DIR, "fake_parq_release.ckpt"), seed=0)
    table = os.path.join(ROOT, "data", "average_scan2cad.txt")
    opts = ["DATAMODULE.DATA_PATH", "synthetic",
            "MODEL.DECODER.CONF_THRESH", "0.05",
            "MODEL.DECODER.MEAN_SIZE_PATH", table, "LOG_IMAGES", "False",
            "TRAINER.LIMIT_VAL_BATCHES", "2", "LOG_PATH", REHEARSAL_DIR,
            "NAME", "rehearsal"]
    dataset, make_eval, solve, finish = (
        pdata.SyntheticDataset, loop.make_graphed_eval_step,
        hungarian.solve_lap, loop.finish_parse_pred)
    captured, problems, kept = [], [], []

    def one_scene(**kw):
        return dataset(**dict(kw, num_snippets=2, scenes=1))

    def capturing_make(*a, **k):
        step = make_eval(*a, **k)

        def capture_step(*a, **k):           # the outputs of every call
            losses, outputs = step(*a, **k)
            captured.append({k: v.float().cpu().numpy()
                             for k, v in outputs.items()})
            return losses, outputs
        return capture_step

    # M1's problems as Python sees them: on the card snippet 0's eager step
    # and the capture (snippet 1 replays), on the CPU each snippet's step
    def watched_solve(cost, n_rows):
        problems.append(tuple(cost.shape))
        return solve(cost, n_rows)

    def counted_finish(*a, **k):
        # the predictions F1 scores: kept by NMS, not background, above
        # CONF_THRESH
        host = finish(*a, **k)
        prob = host["sem_cls_prob"]
        kept.append(int((host["pred_mask"]
                         & (prob.argmax(-1) != prob.shape[-1] - 1)
                         & (prob.max(-1) > 0.05)).sum()))
        return host

    runs, counts, seconds = {}, {}, {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    patched = (one_scene, capturing_make, watched_solve, counted_finish)
    (pdata.SyntheticDataset, loop.make_graphed_eval_step,
     hungarian.solve_lap, loop.finish_parse_pred) = patched
    try:
        for dev in ("cuda", "cpu"):
            captured.clear()
            problems.clear()
            kept.clear()
            text = io.StringIO()
            reset_launch_counts()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                metrics = cli_eval.main([
                    "--cfg", os.path.join(ROOT, "configs", "eval.yaml"),
                    "--CHECKPOINT_PATH", ckpt, *opts,
                    *(["TPU.PLATFORM", "cpu"] if dev == "cpu" else [])])
            seconds[dev] = time.perf_counter() - t1
            counts[dev] = (launch_counts(), list(problems), sum(kept))
            check(len(captured) == 2 and sum(kept) > 0, f"rehearsal {dev}: "
                  f"{len(captured)} snippets evaluated (want 2), {kept} "
                  "predictions through NMS (want some)")
            runs[dev] = (metrics, list(captured))
    finally:
        (pdata.SyntheticDataset, loop.make_graphed_eval_step,
         hungarian.solve_lap, loop.finish_parse_pred) = \
            dataset, make_eval, solve, finish
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    (card, card_outs), (cpu, cpu_outs) = runs["cuda"], runs["cpu"]
    launches, shapes, _ = counts["cuda"]
    # f32: the heads keep the per-head path, the body its modules
    want = dict({k: 2 * v for k, v in VAL_KERNELS.items()}, detection_heads=0,
                frozen_bn=0)
    check(launches == want, f"rehearsal: launches {launches} for 2 "
          f"snippets, want {want}")
    check(len(shapes) == 2 and all(MAX_BOXES in s[1:] for s in shapes),
          f"rehearsal: M1's problems {shapes}, want {MAX_BOXES} targets")
    L = card_outs[0]["pred_logits"].shape[0]
    mean_tab = load_mean_size_table(table, 9).astype(np.float32)
    worst = [iteration_gaps(g, w, mean_tab, L, f"rehearsal snippet {i}")
             for i, (g, w) in enumerate(zip(card_outs, cpu_outs))]
    f1_keys = [k for k in cpu if k not in ("total_loss", "mean_latency_s")]
    check(f1_keys and set(f1_keys) <= set(card), f"rehearsal: F1 keys "
          f"{sorted(cpu)} on the CPU, {sorted(card)} on the card")
    gaps = {k: abs(card[k] - cpu[k]) for k in f1_keys}
    for k, g in gaps.items():
        check(g <= 0.15, f"rehearsal: {k} {card[k]} on the card, {cpu[k]} "
              "on the CPU")
    phase("rehearsal", f"[{smi_line}] {os.path.relpath(ckpt, ROOT)} "
          f"(parq_release.ckpt's layout, strict) through the eval twin on "
          f"eval.yaml, f32, TF32 off: card {seconds['cuda']:.1f} s, CPU "
          f"{seconds['cpu']:.1f} s; launches {launches}; M1 problems "
          f"{shapes}; predictions through NMS {counts['cuda'][2]} (card), "
          f"{counts['cpu'][2]} (CPU)")
    phase("rehearsal", "card vs CPU, worst error per iteration (limit "
          "1.5e-3·2.8^l): " + "; ".join(
              f"snippet {i} " + ", ".join(f"{e:.2e} ({k})" for e, k in w)
              for i, w in enumerate(worst)))
    phase("rehearsal", f"F1 card vs CPU: 0.25_f1 {card.get('0.25_f1')} vs "
          f"{cpu.get('0.25_f1')}, 0.5_f1 {card.get('0.5_f1')} vs "
          f"{cpu.get('0.5_f1')}; largest gap over {len(gaps)} keys "
          f"{max(gaps.values()):.4f} (limit 0.15); phase "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)


PREPROCESS_DIR = os.path.join(ROOT, "build", "chip_smoke_preprocess")
# ScanNet's .sens intrinsics (fx, fy, cx, cy) at its 640x480 depth and
# 1296x968 color streams; a smaller scene scales them
SCANNET_DEPTH_K = (577.870605, 577.870605, 319.5, 239.5)
SCANNET_COLOR_K = (1170.187988, 1170.187988, 647.75, 483.75)
ROOM = np.array([6.0, 5.0, 2.8])     # the synthetic room, meters (z up)
CATIDS = ("03001627", "04379243", "02933112", "02747177", "02871439",
          "03211117", "04256520", "02808440", "99999999")
SYMS = ("__SYM_NONE", "__SYM_ROTATE_UP_2", "__SYM_ROTATE_UP_4",
        "__SYM_ROTATE_UP_INF")


def _intrinsic(k, hw, full_hw):
    sy, sx = hw[0] / full_hw[0], hw[1] / full_hw[1]
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (k[0] * sx, k[1] * sy,
                                          (k[2] + 0.5) * sx - 0.5,
                                          (k[3] + 0.5) * sy - 0.5)
    return K


def _qmul(a, b):
    """Hamilton product of (w, x, y, z) quaternions: the rotation a after b."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _qz(angle):
    """The quaternion of a turn by `angle` about z."""
    return np.array([np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)])


def _camera_path(rng, frames):
    """T_scan_camera of one loop 1.2 m around the room's middle at 1.4 m,
    looking across the room and 20 degrees down (camera x right, y down,
    z forward). A frame moves on along the loop with probability 0.6, else
    only jitters, so view selection drops some frames."""
    poses, arc = [], 0.0
    step = 2 * np.pi / (0.6 * frames)
    for i in range(frames):
        if i and rng.rand() < 0.6:
            arc += step
        yaw = arc + np.pi + 0.3 + rng.normal(0, 0.003)
        pitch = np.radians(20.0) + rng.normal(0, 0.003)
        fwd = np.array([np.cos(pitch) * np.cos(yaw),
                        np.cos(pitch) * np.sin(yaw), -np.sin(pitch)])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        T = np.eye(4)
        T[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
        T[:3, 3] = (ROOM / 2 + 1.2 * np.array([np.cos(arc), np.sin(arc), 0.0])
                    + rng.normal(0, 0.002, 3))
        T[2, 3] = 1.4 + rng.normal(0, 0.002)
        poses.append(T)
    return poses


def _render_depth(T, K, hw, rng):
    """uint16 depth (mm) of the room's walls, floor and ceiling seen from
    T_scan_camera: the ray's z at its first hit, 4 mm of noise, 3% of the
    pixels 0 (no reading)."""
    H, W = hw
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                     np.ones((H, W))], -1) @ T[:3, :3].T
    o = T[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(rays > 0, (ROOM - o) / rays,
                     np.where(rays < 0, -o / rays, np.inf)).min(-1)
    mm = np.rint(t * 1000 + rng.normal(0, 4, t.shape))
    mm[rng.rand(H, W) < 0.03] = 0
    return np.clip(mm, 0, 65535).astype(np.uint16)


def _box_models(rng, n, q_world_scan, t_world_scan):
    """n scan2cad model records: furniture on the floor (turned about z,
    the floor through its base), boxes through a wall (turned every way),
    one of degenerate scale (skipped by the parser), and the last three
    outside the room (behind two walls, above the ceiling): no depth point
    falls in them."""
    from parq_torch.tools.scannet_preprocessing.processing_utils import \
        quat_to_matrix
    outside = [(-2.0, 2.5, 1.0), (3.0, 7.5, 1.0), (3.0, 2.5, 6.0)]
    models = []
    for i in range(n):
        half = rng.uniform([0.15, 0.15, 0.2], [0.6, 0.5, 0.6])
        if i >= n - 3:
            center, q = np.array(outside[i - (n - 3)]), _qz(rng.rand() * 6)
        elif i % 3 == 2:
            wall = rng.randint(4)
            center = np.array([rng.uniform(0.5, ROOM[0] - 0.5),
                               rng.uniform(0.5, ROOM[1] - 0.5),
                               rng.uniform(0.5, 2.2)])
            center[wall % 2] = 0.0 if wall < 2 else ROOM[wall % 2]
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
        else:
            center = np.array([rng.uniform(0.5, ROOM[0] - 0.5),
                               rng.uniform(0.5, ROOM[1] - 0.5),
                               half[2] - 0.05])
            q = _qz(rng.uniform(0, 2 * np.pi))
        scale = rng.uniform(0.8, 1.25, 3)
        if i == 3:
            scale[0] = 1e-4
        offset = rng.normal(0, 0.05, 3)
        q_wo = _qmul(q_world_scan, q)
        # T_scan_object = T_scan_world @ T_world_object @ offset puts the
        # box's center at `center` of the scan with rotation q
        t_wo = (quat_to_matrix(q_world_scan) @ center + t_world_scan
                - quat_to_matrix(q_wo) @ offset)
        models.append({
            "trs": {"translation": t_wo.tolist(), "rotation": q_wo.tolist(),
                    "scale": scale.tolist()},
            "center": offset.tolist(), "bbox": (half / scale).tolist(),
            "catid_cad": CATIDS[i % len(CATIDS)], "id_cad": f"cad{i:03d}",
            "sym": SYMS[i % len(SYMS)]})
    return models


def _jpeg_header(h, w):
    """A baseline JPEG's markers up to its frame header (SOI, APP0, SOF0,
    EOI): enough for a reader of its size, no image data."""
    app0 = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    sof = struct.pack(">BHHB", 8, h, w, 3) + b"\x01\x22\x00\x02\x11\x01\x03\x11\x01"
    return (b"\xff\xd8\xff\xe0" + struct.pack(">H", len(app0) + 2) + app0
            + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xd9")


def write_synthetic_scannet(root, scenes=("scene0000_00",), seed=0,
                            frames=120, depth_hw=(480, 640),
                            color_hw=(968, 1296), boxes=24):
    """A ScanNet raw layout under root/scans (poses, intrinsics, 16-bit P5
    depth, header-only color JPEGs) and a scan2cad-shaped
    root/full_annotations.json, all from `seed`; ScanNet's sizes by
    default. Returns (scans dir, JSON path)."""
    rng = np.random.RandomState(seed)
    scans = os.path.join(root, "scans")
    annotations = []
    for scene in scenes:
        sd = os.path.join(scans, scene)
        for sub in ("pose", "intrinsic", "color", "depth"):
            os.makedirs(os.path.join(sd, sub), exist_ok=True)
        Kd = _intrinsic(SCANNET_DEPTH_K, depth_hw, (480, 640))
        Kc = _intrinsic(SCANNET_COLOR_K, color_hw, (968, 1296))
        np.savetxt(os.path.join(sd, "intrinsic", "intrinsic_depth.txt"), Kd)
        np.savetxt(os.path.join(sd, "intrinsic", "intrinsic_color.txt"), Kc)
        header = _jpeg_header(*color_hw)
        for fid, T in enumerate(_camera_path(rng, frames)):
            name = f"frame-{fid:06d}"
            np.savetxt(os.path.join(sd, "pose", f"{name}.pose.txt"), T)
            with open(os.path.join(sd, "color", f"{name}.color.jpg"),
                      "wb") as f:
                f.write(header)
            depth = _render_depth(T, Kd, depth_hw, rng)
            with open(os.path.join(sd, "depth", f"{name}.depth.pgm"),
                      "wb") as f:
                f.write(b"P5\n%d %d\n65535\n" % (depth_hw[1], depth_hw[0]))
                f.write(depth.astype(">u2").tobytes())
        q_world_scan = _qz(rng.uniform(0, 2 * np.pi))
        t_world_scan = rng.uniform(-2, 2, 3)
        annotations.append({
            "id_scan": scene, "n_aligned_models": boxes,
            "trs": {"translation": t_world_scan.tolist(),
                    "rotation": q_world_scan.tolist(),
                    "scale": [1.0, 1.0, 1.0]},
            "aligned_models": _box_models(rng, boxes, q_world_scan,
                                          t_world_scan)})
    path = os.path.join(root, "full_annotations.json")
    with open(path, "w") as f:
        json.dump(annotations, f)
    return scans, path


def _snippet_gaps(card, cpu, what):
    """Hold the CPU path's snippet records to the card's: frame lists,
    poses, intrinsics and counts equal, ratios to 1e-12; the largest ratio
    gap."""
    check(len(card) == len(cpu), f"{what}: {len(card)} snippets on the "
          f"card, {len(cpu)} on the CPU")
    worst = 0.0
    for a, b in zip(card, cpu):
        check(a["image_ids"] == b["image_ids"], f"{what}: snippet "
              f"{a['snippet_id']} frames {a['image_ids']} vs {b['image_ids']}")
        check(a["point_cloud_num_list"].dtype == np.int64
              and np.array_equal(a["point_cloud_num_list"],
                                 b["point_cloud_num_list"]),
              f"{what}: snippet {a['snippet_id']} counts "
              f"{a['point_cloud_num_list']} on the card, "
              f"{b['point_cloud_num_list']} on the CPU")
        gap = float(np.abs(a["truncation_ratio_list"]
                           - b["truncation_ratio_list"]).max())
        check(gap <= 1e-12, f"{what}: snippet {a['snippet_id']} ratios "
              f"differ by {gap:.3e} (limit 1e-12)")
        worst = max(worst, gap)
        for key in ("T_scan_camera", "intrinsic"):
            check(all(np.array_equal(x, y) and x.dtype == y.dtype
                      for x, y in zip(a[key], b[key])),
                  f"{what}: snippet {a['snippet_id']} {key} differ")
    return worst


def _roidb_of(scene_record, out):
    """Stage 2 over one image_anno record written to `out`: the roidb list
    and the scene's loaded scene_anno pickle."""
    from parq_torch.tools.scannet_preprocessing import \
        generate_scannet_anno_snippet as gen
    os.makedirs(out)
    with open(os.path.join(out, f"image_anno_{scene_record['scene_name']}"
                           ".pkl"), "wb") as f:
        pickle.dump(scene_record, f)
    with contextlib.redirect_stdout(io.StringIO()):
        items = gen.get_roidb(out, "check")
    with open(os.path.join(out, "scene_anno",
                           f"{scene_record['scene_name']}.pkl"), "rb") as f:
        return items, pickle.load(f)


def _same_tree(a, b):
    """Loaded pickles equal: dicts and lists item by item, arrays by value
    and dtype."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def preprocess_times(gen, ctx, fids, workers, cpu_frames=4):
    """ms a frame of the card's stage 1 on `fids`, by part: reading the
    depth into pinned memory with the threads (host clock), uploading it and
    the device passes (CUDA events); and the CPU path's device passes on
    the first `cpu_frames` of them (host clock)."""
    from concurrent.futures import ThreadPoolExecutor
    paths = [gen._depth_file(ctx["scene_dir"], f) for f in fids]
    corners = gen.camera_corners(ctx, fids)
    read_s = upload_ms = passes_ms = 0.0
    with ThreadPoolExecutor(workers) as pool:
        for s in range(0, len(fids), gen.CHUNK_FRAMES):
            sel = slice(s, s + gen.CHUNK_FRAMES)
            t0 = time.perf_counter()
            host = [gen.read_depth_chunk(paths[sel], pool, pin=True),
                    torch.from_numpy(corners[sel]).pin_memory()]
            read_s += time.perf_counter() - t0
            dev = []
            upload_ms += _elapsed_ms(lambda: dev.extend(
                a.to("cuda", non_blocking=True) for a in host))
            passes_ms += _elapsed_ms(
                lambda: gen.chunk_visibility(dev[0], dev[1], ctx))
        first = gen.read_depth_chunk(paths[:cpu_frames], pool)
    t0 = time.perf_counter()
    gen.chunk_visibility(first, torch.from_numpy(corners[:cpu_frames]), ctx)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / cpu_frames
    n = len(fids)
    return read_s * 1e3 / n, upload_ms / n, passes_ms / n, cpu_ms


def phase_preprocess(smi_line, snippets_checked=8):
    """The offline ScanNet preprocessing twin at ScanNet's sizes on one
    synthetic scene: parse_scan2cad, then stage 1 and 2 of both splits
    through the generator's CLI entry on the card; the card's snippet
    records held against the port's CPU path on the first
    `snippets_checked` snippets of each split, and the stage-2 pickles of
    those snippets equal; ms per frame by part; the syncs of one scene."""
    from parq_torch.tools.scannet_preprocessing import (
        generate_scannet_anno_snippet as gen, parse_scan2cad)
    from parq_torch.tools.syncs import count_syncs
    shutil.rmtree(PREPROCESS_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    scene = "scene0000_00"
    scans, json_path = write_synthetic_scannet(PREPROCESS_DIR, (scene,))
    anno = os.path.join(PREPROCESS_DIR, "anno")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        parse_scan2cad.main(["--scan2cad", json_path, "--out", anno])
    with open(os.path.join(anno, f"{scene}.pkl"), "rb") as f:
        n_boxes = len(pickle.load(f)["aligned_models"])
    check(n_boxes == 23, f"preprocess: parse_scan2cad kept {n_boxes} of 24 "
          "boxes (want 23: one of degenerate scale)")
    write_s = time.perf_counter() - t0
    workers = os.cpu_count() or 1
    lines, stage_s, frames, snippets, worst, hist = ({}, {}, {}, {},
                                                     {}, {})
    for split, variant in (("val", "nonoverlap"), ("train", "overlap")):
        out = os.path.join(PREPROCESS_DIR, split)
        text = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            gen.main(["--scans", scans, "--anno", anno, "--out", out,
                      "--split", split, "--device", "cuda"])
        stage_s[split] = time.perf_counter() - t1
        lines[split] = text.getvalue().splitlines()
        with open(os.path.join(out, f"image_anno_{scene}.pkl"), "rb") as f:
            card = pickle.load(f)
        with open(os.path.join(out, f"scannet_{split}_gt_roidb.pkl"),
                  "rb") as f:
            roidb = pickle.load(f)
        check(lines[split] == ["stage snippets: 1/1 scenes",
                               f"wrote {len(roidb)} snippets to "
                               f"{out}/scannet_{split}_gt_roidb.pkl"],
              f"preprocess {split}: stdout {lines[split]}")
        ctx = gen.load_scene(scans, anno, scene, variant, 3)
        check([s["image_ids"] for s in card["snippets"]] == ctx["snippets"],
              f"preprocess {split}: the pickle's snippets are not the "
              "view selection's")
        check(ctx["image_shape"] == (968, 1296), f"preprocess: image shape "
              f"{ctx['image_shape']} from the color JPEG")
        frames[split] = len({f for s in ctx["snippets"] for f in s})
        snippets[split] = (len(card["snippets"]), len(roidb))
        levels = [gen.get_level(c, r) for s in card["snippets"] for c, r in
                  zip(s["point_cloud_num_list"], s["truncation_ratio_list"])]
        hist[split] = np.bincount(levels, minlength=4).tolist()
        head = ctx["snippets"][:snippets_checked]
        t1 = time.perf_counter()
        cpu = gen.snippet_records(ctx, head, device="cpu", workers=workers)
        cpu_s = time.perf_counter() - t1
        worst[split] = (_snippet_gaps(card["snippets"][:len(head)], cpu,
                                      f"preprocess {split}"), cpu_s,
                        len({f for s in head for f in s}))
        got = _roidb_of(dict(card, snippets=card["snippets"][:len(head)]),
                        os.path.join(PREPROCESS_DIR, f"{split}_card"))
        want = _roidb_of(dict(card, snippets=cpu),
                         os.path.join(PREPROCESS_DIR, f"{split}_cpu"))
        check(_same_tree(got, want), f"preprocess {split}: stage-2 pickles "
              "of the card's and the CPU's records differ")
    ctx = gen.load_scene(scans, anno, scene, "overlap", 3)
    fids = sorted({f for s in ctx["snippets"] for f in s})
    n_chunks = -(-len(fids) // gen.CHUNK_FRAMES)
    syncs, sites = count_syncs(lambda: gen.process_scene(
        scans, anno, os.path.join(PREPROCESS_DIR, "train"), scene,
        "overlap", 3, device="cuda", workers=workers))
    check(syncs <= n_chunks, f"preprocess: {syncs} syncs in one scene of "
          f"{n_chunks} chunks (at most one a chunk): {dict(sites)}")
    read_ms, upload_ms, dev_ms, cpu_ms = preprocess_times(gen, ctx, fids,
                                                          workers)
    phase("preprocess", f"[{smi_line}] one synthetic scene at ScanNet's "
          f"sizes (640x480 16-bit P5 depth, {len(fids)} frames, 24 boxes, "
          f"{n_boxes} kept by parse_scan2cad; written in {write_s:.1f} s): "
          + "; ".join(f"{split}: {frames[split]} frames read, "
                      f"{snippets[split][0]} snippets written, "
                      f"{snippets[split][1]} in the roidb, box levels 0-3 "
                      f"{hist[split]}, the CLI "
                      f"{stage_s[split]:.2f} s "
                      f"({stage_s[split] * 1e3 / frames[split]:.2f} ms a "
                      "frame)" for split in stage_s))
    phase("preprocess", "card vs the CPU path on the first "
          f"{snippets_checked} snippets a split: counts equal, stage-2 "
          "pickles equal, ratios within " + ", ".join(
              f"{w[0]:.1e} ({split}, {w[2]} frames, CPU path "
              f"{w[1] * 1e3 / w[2]:.1f} ms a frame with its reads)"
              for split, w in worst.items()) + " (limit 1e-12)")
    phase("preprocess", f"card ms a frame over {len(fids)} frames in "
          f"chunks of {gen.CHUNK_FRAMES} ({workers} reading threads): read "
          f"{read_ms:.3f} (host), upload {upload_ms:.3f}, device passes "
          f"{dev_ms:.3f} (CUDA events); the CPU path's passes on 4 of "
          f"them {cpu_ms:.1f} ms a frame; syncs of one scene {syncs} for "
          f"{n_chunks} chunks ({dict(sites)}); phase "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(PREPROCESS_DIR, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import parq_torch
    except ImportError as e:
        print(f"chip_smoke: parq_torch is not beside this script ({e})",
              file=sys.stderr)
        return 1
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(parq_torch.__file__)))
    if pkg_root != ROOT:
        print(f"chip_smoke: parq_torch comes from {pkg_root}, not {ROOT}",
              file=sys.stderr)
        return 1
    from parq_torch.config import ModelConfig, ServeConfig

    t0 = time.perf_counter()
    try:
        smi_line = phase_device()
        phase_build()
        cfg = ModelConfig(compute_dtype="bfloat16")
        scaled_cfg = scaled_model_cfg()
        errs, b1_rows = phase_kernels(cfg, scaled_cfg)
        scaled_errs = scaled_kernels(scaled_cfg)
        m1_rows = phase_matcher(cfg, scaled_cfg, smi_line)
        phase_native(smi_line)
        engine, counts, requests = phase_serve(ServeConfig(model=cfg), 8)
        phase_parity(cfg)
        train_counts, _ = phase_train(cfg, TRAIN_STEPS)
        phase_graphs(cfg, smi_line)
        phase_train_parity(cfg)
        phase_train_parity(dataclasses.replace(cfg, share_weights=False),
                           "unshared")
        rows = phase_times(cfg, engine, counts, requests, train_counts,
                           errs, b1_rows["pixel_align_sample"])
        m1_rows[0]["launches"] = train_counts["lap_solve"]
        b2_eval_row = eval_b1_row(cfg)
        heads_eval_row = heads_row(cfg)
        nms_eval_row = nms_rows(cfg)
        dcn_rows = deform_rows()
        dcn_launches, petr_tally = phase_petr(smi_line)
        check(dcn_launches == sum(PETR_DCN_BLOCKS.values()),
              "petr: DCN launches a forward are not one a DCN block")
        rows += [dict(dcn_rows[s], launches=n)      # launches a forward
                 for s, n in PETR_DCN_BLOCKS.items()]
        del engine
        torch.cuda.empty_cache()
        sp_counts = phase_sp(cfg)
        phase_ddp(cfg)
        phase_tp(cfg, smi_line)
        rows += split_rows(cfg, errs, sp_counts)
        torch.cuda.empty_cache()
        ckpt, _ = phase_fit(smi_line)
        _, eval_counts = phase_eval(ckpt, smi_line)
        rows += frozen_bn_rows({
            "petr": petr_tally,
            "release": release_frozen_bn_tally(cfg, eval_counts)})
        rows.append(dict(b1_rows["pixel_align_sample_eval"],
                         launches=eval_counts["pixel_align_sample"]))
        rows.append(dict(b2_eval_row,
                         launches=eval_counts["flash_cross_attention_fwd"]))
        rows.append(dict(heads_eval_row,
                         launches=eval_counts["detection_heads"]))
        rows.append(dict(nms_eval_row, launches=eval_counts["nms"]))
        phase_vis(smi_line)
        phase_serve_ckpt(ckpt)
        shutil.rmtree(CLI_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
        scaled_counts = phase_scaled(smi_line)
        rows += scaled_rows(scaled_cfg, scaled_errs, scaled_counts,
                            b1_rows["pixel_align_sample_scaled"])
        m1_rows[1]["launches"] = scaled_counts["lap_solve"]
        rows += m1_rows
        rows.append(keep_mask_row(cfg, train_counts))
        phase_export(smi_line)
        phase_fit_sp(smi_line)
        phase_bench(cfg, train_counts, TRAIN_STEPS, smi_line)
        phase_rehearsal(smi_line)
        phase_preprocess(smi_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    phase("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA source in parq_torch/csrc, one nvcc each, timed;
  3. kernels — the Hopper building blocks (wgmma descriptors, TMA) on one
               tile against a plain product; then each kernel against its
               plain PyTorch version at the release shapes: B1 (sampler) in
               bf16 and f32, atol 1e-4; B2 (flash cross-attention) in bf16
               (atol 2e-2: bf16 output rounding) and f32 (atol 1e-4), at
               every KV split the wrapper can choose, plus B2 at a ragged
               N; B2's train form (LSE to 1e-4, dropout 0.1) at Q=256, and
               folded (Q=2048 in 8 seed groups) against 8 separate calls,
               equal bit for bit; B3 (flash backward) at Q=2048, G=8, with
               dropout 0.1 and 0, and at a ragged N; B2, B2-train and B3 at
               a Q that does not divide the 128-row tile (200) and an N
               below one KV tile (40); B4 (sampler d(memory)) at Q=2048;
  4. serve   — an Engine at the release config (ResNet50, 3 x 320x240,
               L=8, Q=256, dim 1024, B=8, bf16) answers 3 /detect requests
               over HTTP; every output is finite, each serving kernel's
               launch count rose by exactly 8 per request and no training
               kernel launched;
  5. parity  — the same seeded weights and batch, B=1 f32, TF32 off: the
               card's forward (kernels) against the port's CPU forward
               (plain versions), atol 2e-3, every output of the last
               iteration;
  6. train   — the release model at B=8 in bf16, dropout 0.1, AdamW at lr
               1e-4 with a global-norm clip of 1.0, 5 steps through
               parq_torch.train's train_step on synthetic batches: finite
               losses and gradient norms, the parameters moved, and per
               step B1 8, B2-train 8, B3 1 and B4 1 launches; step ms from
               CUDA events after a warm-up step, and a profile of one step;
  7. train-parity — B=1, f32, TF32 off, dropout 0, release widths at L=2:
               the card's gradients (kernels) against the CPU's (plain
               versions), parameter by parameter, by norm;
  8. times   — forward ms at B=8 bf16 (CUDA events over 10 forwards, the
               host's work included) and a profile of one forward; per
               kernel device ms (CUDA-graph replay; the library's dropout
               and backward calls by CUDA events), launches on its path,
               bound ms, plain ms and the library call's ms; B3's two
               passes from one profiled launch.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a GPU, or without the parq_torch
package beside this file, it exits non-zero and prints no result.
"""
import dataclasses
import io
import json
import math
import os
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
    batch = make_batch(list(range(B)), image_size=cfg.image_size)
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


def attention_inputs(B, H, Q, N, D, dtype, gen):
    """Logits of std 2 (q ~ 2·N(0,1), k ~ N(0,1), scaled by 1/sqrt(D)): a
    softmax far from uniform, so outputs are O(0.1–1) and an error in the
    kernel's weighting shows."""
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    return q, kv


def sampler_bound_ms(mem, uvs):
    """Bytes the sampler must move for THIS data: every distinct in-image
    tap row read once, the (u, v, scale) rows read, the f32 output
    written once."""
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
    nbytes = (n_rows * C * mem.element_size() + uvs.numel() * 4
              + B * Q * C * 4)
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


def phase_kernels(cfg):
    """Each kernel vs its plain version at the release shapes."""
    from parq_torch.kernels import flash_cross_attention_kv_fused as flash
    from parq_torch.kernels import sample_views
    from parq_torch.kernels.cross_attention import (
        MAX_SPLITS, _flash_fwd, _splits_for, cross_attention_kv_fused_plain,
        split_bounds)
    from parq_torch.kernels.pixel_align import sample_views_plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        mem, uvs = release_sampler_inputs(cfg, 8, dtype, gen)
        err = (sample_views(mem, uvs)
               - sample_views_plain(mem, uvs)).abs().max().item()
        check(err <= 1e-4, f"B1 {dtype} max abs err {err} > 1e-4")
        errs[("B1", dtype)] = err
        phase("kernels", f"B1 sampler {str(dtype)[6:]} {tuple(mem.shape)} "
              f"Q={uvs.shape[2]}: max abs err {err:.3e} (atol 1e-4)")
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
            want = cross_attention_kv_fused_plain(q, kv).float()
            worst = {}
            for splits in range(1, MAX_SPLITS + 1):
                if len(split_bounds(n, splits)) != splits:
                    continue       # a split would be left without a block
                worst[splits] = (_flash_fwd(q, kv, splits).float()
                                 - want).abs().max().item()
                check(worst[splits] <= atol, f"B2 bf16 N={n} splits "
                      f"{splits}: max abs err {worst[splits]} > {atol}")
            phase("kernels", f"B2 flash bfloat16 N={n} at every KV split: "
                  "max abs err " + ", ".join(f"{k}: {v:.3e}" for k, v in
                                             worst.items())
                  + f" (atol {atol}; the wrapper's rule picks "
                  f"{_splits_for(q, n, q.shape[2], None)})")
    errs.update(train_kernels(cfg, gen, N))
    torch.cuda.synchronize()
    return {"pixel_align_sample": errs[("B1", torch.bfloat16)],
            "flash_cross_attention_fwd": errs[("B2", torch.bfloat16, N)],
            "flash_cross_attention_fwd_train": errs["B2-train"],
            "flash_cross_attention_bwd": errs["B3"],
            "pixel_align_bwd_mem": errs["B4"]}


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

    # B4 at the fold: the rows of all 8 iterations scatter into one map
    mem, uvs = release_sampler_inputs(cfg, 8, torch.bfloat16, gen)
    uvs = uvs.repeat(1, 1, L, 1).contiguous()
    uvs[..., :2] += torch.randn(uvs[..., :2].shape, device="cuda",
                                generator=gen)
    g = torch.randn(8, uvs.shape[2], mem.shape[-1], device="cuda",
                    generator=gen)
    for dtype, atol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        got = sample_views_bwd_mem(uvs, g, mem.shape, dtype)
        want = sample_views_bwd_mem_plain(uvs, g, mem.shape, dtype)
        err, rel = _rel_err(got, want)
        check(rel <= atol, f"B4 {dtype}: max abs err {err} is {rel} of its "
              f"max > {atol}")
        if dtype == torch.bfloat16:
            errs["B4"] = err
        phase("kernels", f"B4 {str(dtype)[6:]} dmem {tuple(mem.shape)} "
              f"Q={uvs.shape[2]}: max abs err {err:.3e} ({rel:.2e} of its "
              f"max; limit {atol})")
    return errs


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"/detect answered {r.status}")
        return json.loads(r.read())


def phase_serve(serve_cfg, batch_size, requests=3):
    from parq_torch.data.synthetic import make_batch
    from parq_torch.kernels import (SERVE_KERNELS, launch_counts,
                                    reset_launch_counts)
    from parq_torch.models import BATCH_KEYS
    from parq_torch.serve import Engine, build_server
    cfg = serve_cfg.model
    t0 = time.perf_counter()
    engine = Engine(serve_cfg, batch_size=batch_size, device="cuda", seed=0)
    phase("serve", f"engine ready in {time.perf_counter() - t0:.1f} s: "
          f"{cfg.resnet_name} {cfg.num_views}x{cfg.image_size} "
          f"L={cfg.dec_layers} Q={cfg.num_queries} dim={cfg.dec_dim} "
          f"B={batch_size} {cfg.compute_dtype}")
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
            image_size=cfg.image_size).items() if k in BATCH_KEYS}
            for i in range(requests)]
        reset_launch_counts()
        answers = [_post(url + "/detect", b) for b in bodies]
        counts = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    for name, n in counts.items():
        want = cfg.dec_layers * requests if name in SERVE_KERNELS else 0
        check(n == want, f"{name}: {n} launches in {requests} requests, "
              f"want {want}")
    n_dets = 0
    for ans in answers:
        check(len(ans["detections"]) == batch_size, "response batch size")
        for dets in ans["detections"]:
            for d in dets:
                n_dets += 1
                vals = [d["score"], *d["center"], *d["size"],
                        *np.ravel(d["corners_world"])]
                check(all(math.isfinite(v) for v in vals),
                      "non-finite detection")
    out = engine.forward(engine.example)
    L, B, Q = cfg.dec_layers, batch_size, cfg.num_queries
    check(out["pred_logits"].shape == (L, B, Q, cfg.num_semcls + 1),
          f"pred_logits shape {tuple(out['pred_logits'].shape)}")
    for k, v in out.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"non-finite output {k}")
    phase("serve", f"{requests} /detect requests answered, {n_dets} "
          f"detections, outputs finite; launches {counts} "
          f"({cfg.dec_layers} per request)")
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


def device_profile(run, label, top=8):
    """One call of `run` under torch.profiler: device time by kernel name,
    and the device's busy share of the profiled call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernel after it starts: give it one
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if not kernels:
        phase("times", f"profiler saw no device time in the {label}: "
              "breakdown not measured")
        return
    phase("times", f"profiled {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels)} kernel names")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:top]:
        phase("times", f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{n} "
              f"{name[:90]}")


def phase_train(cfg, steps=5):
    """The release training step, B=8 bf16, through the entry point's
    train_step: finite metrics, moving parameters, the training kernels'
    launches per step, step time, and one profiled step."""
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.train.__main__ import build, synthetic_batches
    from parq_torch.train.train_step import train_step
    B = 8
    t0 = time.perf_counter()
    net, opt = build("release", "bfloat16", seed=0, device="cuda")
    batches = synthetic_batches(net.cfg, B, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    before = [p.detach().clone() for p in net.parameters()]
    phase("train", f"model and batches ready in {time.perf_counter() - t0:.1f}"
          f" s: {cfg.resnet_name} L={cfg.dec_layers} Q={cfg.num_queries} "
          f"dim={cfg.dec_dim} B={B} bfloat16, dropout "
          f"{net.cfg.dropout_rate}, AdamW lr 1e-4, clip 1.0")
    reset_launch_counts()
    ms = []
    for step in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = train_step(net, opt, batches[step % len(batches)], gen)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        loss, norm = float(m["total_loss"]), float(m["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(norm),
              f"train step {step}: loss {loss}, grad norm {norm}")
        phase("train", f"step {step}: loss {loss:.5f} grad_norm {norm:.4f} "
              f"valid_bs {float(m['valid_bs']):.0f} ({ms[-1]:.1f} ms)")
    counts = launch_counts()
    want = {"pixel_align_sample": cfg.dec_layers,
            "flash_cross_attention_fwd": 0,
            "flash_cross_attention_fwd_train": cfg.dec_layers,
            "flash_cross_attention_bwd": 1, "pixel_align_bwd_mem": 1}
    for name, n in counts.items():
        check(n == want[name] * steps, f"train: {name} launched {n} times "
              f"in {steps} steps, want {want[name]} per step")
    moved = sum(float((p.detach() - b).abs().sum())
                for p, b in zip(net.parameters(), before))
    check(moved > 0 and math.isfinite(moved), f"parameters moved {moved}")
    step_ms = sum(ms[1:]) / len(ms[1:])
    phase("train", f"{steps} steps, launches {counts} (per step: {want}); "
          f"sum |Δparams| {moved:.4g}; step {step_ms:.2f} ms from CUDA "
          f"events over steps 1-{steps - 1} after a warm-up step "
          f"({1e3 * B / step_ms:.2f} samples/s)")
    device_profile(lambda: train_step(net, opt, batches[0], gen),
                   "train step")
    return counts, step_ms


def phase_train_parity(cfg):
    """Gradients on the card (kernels) against the CPU (plain versions):
    B=1, f32, TF32 off, dropout 0, release widths at L=2 (depth cut so the
    CPU side fits the time limit); the same weights, batch and matcher
    draws."""
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
              f"train-parity: {k} {losses['cuda'][k]} vs {v}")
    total = math.sqrt(sum(float(g.norm()) ** 2
                          for g in grads["cpu"].values()))
    worst, worst_name = 0.0, ""
    for n, g in grads["cpu"].items():
        err = float((grads["cuda"][n] - g).norm())
        check(err <= 5e-3 * float(g.norm()) + 1e-6 * total,
              f"train-parity: {n} gradient off by {err} (norm "
              f"{float(g.norm())})")
        rel = err / max(float(g.norm()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    phase("train-parity", f"card (kernels) vs CPU (plain), B=1 f32, TF32 "
          f"off, dropout 0, L=2: loss {losses['cuda']['total_loss']:.6f} vs "
          f"{losses['cpu']['total_loss']:.6f}; {len(grads['cpu'])} "
          f"gradients, worst ‖Δ‖/‖g‖ {worst:.2e} ({worst_name}); limit "
          f"5e-3·‖g‖ + 1e-6·‖G‖, ‖G‖ = {total:.4g}")


def phase_times(cfg, engine, counts, requests, train_counts, errs):
    """Times from CUDA events on this card, and the kernels' record."""
    import torch.nn.functional as F
    from parq_torch.kernels import flash_bwd, flash_fwd_lse
    from parq_torch.kernels import flash_cross_attention_kv_fused as flash
    from parq_torch.kernels import sample_views, sample_views_bwd_mem
    from parq_torch.kernels.cross_attention import (
        _flash_fwd, _flash_fwd_lse, _splits_for,
        cross_attention_kv_fused_bwd_plain, cross_attention_kv_fused_plain,
        cross_attention_kv_fused_train_plain, split_kv)
    from parq_torch.kernels.pixel_align import (sample_views_bwd_mem_plain,
                                                sample_views_plain)
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
        dict(name="pixel_align_sample", route="cuda",
             source="parq_torch/csrc/pixel_align.cu",
             replaces="parq_tpu/kernels/pixel_align_pallas.py:168",
             ms=device_ms(lambda: sample_views(mem, uvs), 50),
             plain_ms=device_ms(lambda: sample_views_plain(mem, uvs), 10),
             bound_ms=sampler_bound_ms(mem, uvs), bound_by="bytes",
             library_ms=None),
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

    uvf = uvs.repeat(1, 1, L, 1).contiguous()
    uvf[..., :2] += torch.randn(uvf[..., :2].shape, device="cuda",
                                generator=gen)
    g = torch.randn(B, uvf.shape[2], mem.shape[-1], device="cuda",
                    generator=gen)
    b4_bound, b4_by = sampler_bwd_bound(uvf, g, mem.shape, mem.dtype)
    rows.append(dict(
        name="pixel_align_bwd_mem", route="cuda",
        source="parq_torch/csrc/pixel_align_bwd.cu",
        replaces="parq_tpu/kernels/pixel_align_pallas.py:280",
        ms=device_ms(lambda: sample_views_bwd_mem(uvf, g, mem.shape,
                                                  mem.dtype), 10),
        plain_ms=device_ms(lambda: sample_views_bwd_mem_plain(
            uvf, g, mem.shape, mem.dtype), 3),
        bound_ms=b4_bound, bound_by=b4_by,
        library_ms=grid_sampler_bwd_ms(mem, uvf, g)))
    for r in rows[2:]:
        r["launches"] = train_counts[r["name"]]
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        phase("times", f"{r['name']}: {r['ms']:.4f} ms/launch"
              f", {r['launches']} launches on its path, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    phase("times", f"B2 splits its KV range in "
          f"{_splits_for(q, N, q.shape[2], None)} at q {tuple(q.shape)} (eval "
          f"and train); unsplit it takes "
          f"{device_ms(lambda: _flash_fwd(q, kv, 1), 10):.4f} ms (eval), "
          f"{device_ms(lambda: _flash_fwd_lse(q, kv, s1, rate, 1), 10):.4f}"
          " ms (train)")
    device_profile(lambda: flash_bwd(qf, kv, do, lse, delta, sL, rate),
                   "B3 launch (its two passes)", top=2)
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
        phase_device()
        phase_build()
        cfg = ModelConfig(compute_dtype="bfloat16")
        errs = phase_kernels(cfg)
        engine, counts, requests = phase_serve(ServeConfig(model=cfg), 8)
        phase_parity(cfg)
        train_counts, _ = phase_train(cfg)
        phase_train_parity(cfg)
        rows = phase_times(cfg, engine, counts, requests, train_counts,
                           errs)
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

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — both CUDA kernels from parq_torch/csrc, timed;
  3. kernels — each kernel against its plain PyTorch version at the
               release shapes: B1 (sampler) in bf16 and f32, atol 1e-4;
               B2 (flash cross-attention) in bf16 (atol 2e-2: bf16 output
               rounding) and f32 (atol 1e-4), plus B2 at a ragged N;
  4. serve   — an Engine at the release config (ResNet50, 3 x 320x240,
               L=8, Q=256, dim 1024, B=8, bf16) answers 3 /detect requests
               over HTTP; every output is finite and each kernel's launch
               count rose by exactly 8 per request;
  5. parity  — the same seeded weights and batch, B=1 f32, TF32 off: the
               card's forward (kernels) against the port's CPU forward
               (plain versions), atol 2e-3, every output of the last
               iteration;
  6. times   — forward ms at B=8 bf16 (CUDA events over 10 forwards, the
               host's work included) and a profile of one forward; per
               kernel device ms (CUDA-graph replay), launches per forward,
               bound ms, plain ms and the library call's ms.
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


def attention_bound(q, kv):
    """(ms, "bytes" | "operations"): q and kv read once, o written once,
    against 4·B·H·Q·N·D bf16 tensor-core operations."""
    B, H, Q, D = q.shape
    N = kv.shape[1]
    nbytes = (2 * q.numel() + kv.numel()) * q.element_size()
    flops = 4 * B * H * Q * N * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
        cross_attention_kv_fused_plain)
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
    torch.cuda.synchronize()
    return {"pixel_align_sample": errs[("B1", torch.bfloat16)],
            "flash_cross_attention_fwd": errs[("B2", torch.bfloat16, N)]}


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"/detect answered {r.status}")
        return json.loads(r.read())


def phase_serve(serve_cfg, batch_size, requests=3):
    from parq_torch.data.synthetic import make_batch
    from parq_torch.kernels import launch_counts, reset_launch_counts
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
    want = cfg.dec_layers * requests
    for name, n in counts.items():
        check(n == want, f"{name}: {n} launches in {requests} requests, "
              f"want {want} ({cfg.dec_layers} per request)")
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


def forward_profile(engine, top=8):
    """One forward under torch.profiler: device time by kernel name, and
    the device's busy share of the profiled forward's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.model(engine.example)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if not kernels:
        phase("times", "profiler saw no device time: breakdown not measured")
        return
    phase("times", f"profiled forward: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(kernels)} kernel names")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:top]:
        phase("times", f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{n} "
              f"{name[:90]}")


def phase_times(cfg, engine, counts, requests, errs):
    """Times from CUDA events on this card, and the kernels' record."""
    import torch.nn.functional as F
    from parq_torch.kernels import flash_cross_attention_kv_fused as flash
    from parq_torch.kernels import sample_views
    from parq_torch.kernels.cross_attention import (
        cross_attention_kv_fused_plain, split_kv)
    from parq_torch.kernels.pixel_align import sample_views_plain
    B = engine.batch_size
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: engine.model(engine.example), 10)
    phase("times", f"forward B={B} {cfg.compute_dtype}: {fwd_ms:.2f} ms "
          f"({1e3 * B / fwd_ms:.1f} samples/s)")
    forward_profile(engine)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mem, uvs = release_sampler_inputs(cfg, B, torch.bfloat16, gen)
    Hh, D = cfg.dec_heads, cfg.dec_dim // cfg.dec_heads
    N = cfg.num_views * cfg.feat_size[0] * cfg.feat_size[1]
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
             source="parq_torch/csrc/cross_attention.cu",
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
        r["max_abs_err"] = errs[r["name"]]
        phase("times", f"{r['name']}: {r['ms']:.4f} ms/launch, "
              f"{r['launches'] // requests} launches per forward, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    return rows


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
        rows = phase_times(cfg, engine, counts, requests, errs)
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

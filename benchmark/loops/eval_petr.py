"""Loop kind `eval_petr`: a closed loop of PETR inference over six-camera
samples, as an offline nuScenes evaluation (mmdet3d tests at
samples_per_gpu=1) or a driving stack detecting from each frame in turn
runs it.

Set-up makes `pool_batches` distinct batches of `batch` samples from the
seed in page-locked host memory (`data_petr`: uint8 BGR images and
lidar2img), loads the seed's weights (`weights_petr`) into the port's
`PETRModel` in eval mode and wraps it in `parq_torch.graphs.Graphed`
(captured on the first call, replayed after). Per batch, one after
another: copy it to the card (non-blocking), replay the forward under
inference mode, then `parq_torch.evals.petr_decode` on the last layer's
outputs (the top `max_num`, NMS-free), which brings the detections to the
host in one copy.

eval_frames_per_s: B · cameras of every batch forwarded and decoded in
the window over the window's wall time (camera images a second, as the
PARQ cells count views).

Correctness: `check_batches` of the window's batches, a uniform sample
of all of them drawn from the seed as the window runs (reservoir
sampling), keep their outputs and detections; once the window has closed
the reference (`reference.petr`, f32, TF32 off) runs the forward on the
same inputs and decodes the program's own last-layer outputs.
output_gap: the largest ‖program − reference‖ / ‖reference‖ of the last
layer's class logits, box centres and other box fields; decode_mismatch:
the detections in which the reference's decode of the program's outputs
and the program's own decode differ (`reference.petr.decode_mismatch`).

Traced (--trace 1), the loop runs as it does untraced. A stretch of it
runs under the profiler, with its phases in host ranges (`bench.h2d`,
`bench.forward`, `bench.decode`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, data_petr, program, program_petr
from benchmark.harness import Run
from benchmark.reference import petr as ref
from benchmark.trace import Stretch, span
from benchmark.weights_petr import make_weights

WARM_CALLS = 3


def run(ctx) -> Run:
    from parq_torch.evals.petr_decode import petr_decode
    from parq_torch.graphs import Graphed
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, P, N = tr["batch"], tr["pool_batches"], cfg["num_cams"]
    pool = program.pinned(data_petr.make_pool(B * P, cfg, tr["boxes"],
                                              ctx.seed, dev), dev)
    weights = make_weights(cfg, ctx.seed, dev)
    model = program_petr.build_model(cfg, weights, dev)
    del weights
    graphed = Graphed(model)
    rng = np.random.default_rng([ctx.seed % 2 ** 63, 31])
    kept = []                           # (batch, outputs, detections)

    def keep(n, out, dets):
        if n < tr["check_batches"]:
            kept.append((n, out, dets))
        else:
            j = rng.integers(0, n + 1)
            if j < len(kept):
                kept[j] = (n, out, dets)

    def host(i):
        j = i % P
        return {k: pool[k][j * B:(j + 1) * B] for k in program_petr.KEYS}

    def one(i, tracing):
        with span("bench.h2d", tracing):
            x = program_petr.to_device(host(i), dev)
        with span("bench.forward", tracing), torch.inference_mode():
            out = graphed(x)
        with span("bench.decode", tracing):
            dets = petr_decode(out["all_cls_scores"][-1],
                               out["all_bbox_preds"][-1],
                               cfg["post_center_range"], cfg["max_num"])
        return out, dets

    for i in range(WARM_CALLS):
        one(i, False)
    program.sync(dev)
    setup_s = time.time() - ctx.t_start

    trace_at = ctx.seconds * tr["trace_from"]
    stretch, traced, tracing = None, 0, False
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and stretch is None and \
                time.perf_counter() - t0 >= trace_at:
            stretch, tracing = Stretch(dev).__enter__(), True
        out, dets = one(n, tracing)
        keep(n, {k: v[-1:] for k, v in out.items()}, dets)
        if tracing:
            traced += 1
            if traced == tr["trace_batches"]:
                stretch.__exit__(None, None, None)
                tracing = False
        n += 1
    program.sync(dev)
    window = time.perf_counter() - t0
    if tracing:
        stretch.__exit__(None, None, None)
    peak = program.memory_peak(dev)

    del model, graphed
    program.release(dev)
    checks.no_tf32()
    w = make_weights(cfg, ctx.seed, dev)
    inf = float("inf")
    worst = dict.fromkeys(("output_gap", "decode_mismatch"),
                          0.0 if kept else inf)
    for i, out, dets in kept:
        x = {k: v.to(dev) for k, v in host(i).items()}
        with torch.no_grad():
            r = ref.forward(w, cfg, x)
        got = {"output_gap": max(ref.output_gaps(out, r).values())}
        mine = ref.decode(out["all_cls_scores"][-1].float().cpu().numpy(),
                          out["all_bbox_preds"][-1].float().cpu().numpy(),
                          cfg["post_center_range"], cfg["max_num"])
        got["decode_mismatch"] = ref.decode_mismatch(dets, mine)
        worst = {k: max(v, float(got[k])) for k, v in worst.items()}
    lim = ctx.limits
    return Run(
        attempted=n, failed=0,
        metrics={"eval_frames_per_s": n * B * N / window,
                 "setup_s": setup_s},
        checks={k: (v, float(lim[k])) for k, v in worst.items()},
        memory_peak_bytes=peak, trace=stretch,
        counts={"batches": float(traced), "batch": float(B)})

"""Loop kind `eval`: a closed loop of batched inference, as an offline
evaluation over a dataset runs it.

Set-up makes `pool_batches` distinct batches of `batch` snippets from
the seed in page-locked host memory, loads the seed's weights into the
port's model in eval mode and wraps it in `parq_torch.graphs.Graphed`
(captured on the first call, replayed after). Per batch, one after
another: copy it to the card (non-blocking), replay the forward under
inference mode, then `parq_torch.evals.parse_pred.parse_pred` on the last
iteration's outputs with the configuration's track box and NMS, which
brings the detections to the host.

eval_frames_per_s: B·T of every batch forwarded and parsed in the window
over the window's wall time.

Correctness: `check_batches` of the window's batches, a uniform sample
of all of them drawn from the seed as the window runs (reservoir
sampling), keep their outputs and detections; once the window has
closed the reference runs the forward on the same inputs
(`checks.forward_readings`) and its own post-processing of the
program's outputs (`checks.parse_mismatch`).

Traced (--trace 1), the loop runs as it does untraced. A stretch of it
runs under the profiler, with its phases in host ranges (`bench.h2d`,
`bench.forward`, `bench.parse_pred`); the other batches record CUDA
events on the stream before and after each forward's replay (the
forward's device time, whatever the host does meanwhile, and without the
gaps the profiler's tracing opens between a graph's kernels).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, data, program
from benchmark.harness import Run
from benchmark.reference import parse as ref_parse
from benchmark.trace import Stretch, span
from benchmark.weights import make_weights

WARM_CALLS = 3


def run(ctx) -> Run:
    from parq_torch.evals.parse_pred import parse_pred
    from parq_torch.graphs import Graphed
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, P, T = tr["batch"], tr["pool_batches"], cfg["num_views"]
    pool = program.pinned(data.make_pool(B * P, T, cfg["image_size"],
                                         tr["boxes"], ctx.seed, dev), dev)
    weights = make_weights(cfg, ctx.seed, dev)
    model = program.build_model(cfg, ctx.cell.root, weights, dev)
    del weights
    graphed = Graphed(model)
    rng = np.random.default_rng([ctx.seed % 2 ** 63, 29])
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
        return data.take(pool, slice(j * B, (j + 1) * B), program.EVAL_KEYS)

    def one(i, tracing, timed):
        events = program.events(dev) if timed else None
        with span("bench.h2d", tracing):
            x = program.to_device(host(i), program.EVAL_KEYS, dev)
        with span("bench.forward", tracing), torch.inference_mode():
            if events:
                events[0].record()
            out = graphed(x)
            if events:
                events[1].record()
        with span("bench.parse_pred", tracing):
            dets = parse_pred({k: v[-1] for k, v in out.items()},
                              x["T_world_local"], cfg["track_scale"],
                              cfg["num_semcls"], enable_nms=cfg["enable_nms"])
        return out, dets, events

    for i in range(WARM_CALLS):
        one(i, False, False)
    program.sync(dev)
    setup_s = time.time() - ctx.t_start

    forwards = []                       # timed forwards' event pairs
    trace_at = ctx.seconds * tr["trace_from"]
    stretch, traced, tracing = None, 0, False
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and stretch is None and \
                time.perf_counter() - t0 >= trace_at:
            stretch, tracing = Stretch(dev).__enter__(), True
        out, dets, events = one(n, tracing, ctx.trace and not tracing)
        keep(n, out, dets)
        if events:
            forwards.append(events)
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
    w = make_weights(cfg, ctx.seed, dev)
    inf = float("inf")
    worst = dict.fromkeys(("output_gap", "parse_mismatch"),
                          0.0 if kept else inf)
    for i, out, dets in kept:
        x = host(i)
        got, _ = checks.forward_readings(cfg, ctx.cell.root, w, x, out, dev)
        mine = ref_parse.parse(checks.host_outputs(out),
                               x["T_world_local"].numpy(),
                               cfg["track_scale"], cfg["num_semcls"],
                               nms_corners=dets["corners_local"])
        got["parse_mismatch"] = checks.parse_mismatch(dets, mine)
        worst = {k: max(v, float(got[k])) for k, v in worst.items()}
    lim = ctx.limits
    return Run(
        attempted=n, failed=0,
        metrics={"eval_frames_per_s": n * B * T / window,
                 "setup_s": setup_s},
        checks={k: (v, float(lim[k])) for k, v in worst.items()},
        memory_peak_bytes=peak, trace=stretch,
        spans={"forward_device": [a.elapsed_time(b) / 1e3
                                  for a, b in forwards]},
        counts={"batches": float(traced), "batch": float(B)})

"""Loop kind `eval_bevformer`: a closed loop of BEVFormer inference in
video test mode over the samples of a scene, in scene order, as an
offline nuScenes val evaluation (BEVFormer tests at samples_per_gpu=1,
video_test_mode) or a driving stack that detects from each six-camera
frame in turn and carries its BEV forward runs it.

Set-up makes one scene of `pool_batches` samples from the seed in
page-locked host memory (`data_bevformer`: uint8 BGR images at 1600 x
900, lidar2img, the CAN-bus rows of a seeded drive), loads the seed's
weights (`weights_bevformer`) into the port's `BEVFormerModel` and puts
its `BEVStream` around `parq_torch.graphs.Graphed(model)`. Sample i is
pool sample i mod pool_batches of scene i // pool_batches: at each wrap
of the pool the scene id changes and the stream drops the previous BEV,
so it runs the first-frame form once in pool_batches samples and the
carried form the rest (both captured during the warm-up). Per sample,
one after another: copy it to the card (non-blocking), the stream's
forward (a replay, under inference mode), then
`parq_torch.evals.petr_decode` on the last layer's outputs (the top
`max_num`, NMS-free), which brings the detections to the host in one
copy.

eval_frames_per_s: B · cameras of every sample forwarded and decoded in
the window over the window's wall time (camera images a second, as the
PETR cell counts them).

Correctness: `check_batches` of the window's samples, a uniform sample
of all of them drawn from the seed as the window runs (reservoir
sampling), and always the window's first scene start, keep their inputs
(the pool index, and the previous BEV the program itself fed in), the
new BEV, the last layer's outputs and the detections; the tensors go to
page-locked host memory on a side stream, so neither the window's
stream nor the card's memory holds them. Once the window has closed the
reference (`reference.bevformer`, f32, TF32 off) runs the forward on the
same inputs, the program's previous BEV included, its decoder along the
program's trajectory (on the program's new BEV, each layer from the
program's refined reference points of the layer before, as the PARQ
cell's reference runs along the program's centres: without it the box
refinement feeds each layer's round-off into the next one's sampling
points, and sound bf16 runs read up to 0.158 against the control's
0.199–0.233), and decodes the program's own last-layer outputs.
output_gap: the largest ‖program − reference‖ / ‖reference‖ of the last
layer's class logits, box centres and other box fields; bev_gap: the
same of the new BEV embedding, which the next sample consumes; decode_mismatch: the detections in which the
reference's decode of the program's outputs and the program's own decode
differ (`reference.petr.decode_mismatch`).

Traced (--trace 1), the loop runs as it does untraced. A stretch of it
runs under the profiler, with its phases in host ranges (`bench.h2d`,
`bench.forward`, `bench.decode`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, data_bevformer, program, program_bevformer
from benchmark.harness import Run
from benchmark.reference import bevformer as ref
from benchmark.trace import Stretch, span
from benchmark.weights_bevformer import make_weights

WARM_CALLS = 3                  # a scene start, then two carried samples


class Keeper:
    """Kept samples' tensors, copied to page-locked host memory on a side
    stream of the card (plain references off a card). `reserve` makes the
    page-locked blocks before the window and frees them to the caching
    host allocator, so that the window's copies page-lock nothing."""

    def __init__(self, device):
        cuda = torch.device(device).type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.device = device

    def reserve(self, shape, dtype, n: int) -> None:
        if self.stream is not None:
            blocks = [torch.empty(shape, dtype=dtype, pin_memory=True)
                      for _ in range(n)]
            del blocks

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(t, non_blocking=True)
        t.record_stream(self.stream)
        return host


def run(ctx) -> Run:
    # a checkout without BEVFormer fails here, before the set-up
    from parq_torch.models import BEVStream  # noqa: F401
    from parq_torch.evals.petr_decode import petr_decode
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, P, N = tr["batch"], tr["pool_batches"], cfg["num_cams"]
    pool = program.pinned(data_bevformer.make_scene(
        B * P, cfg, tr["boxes"], ctx.seed, dev), dev)
    weights = make_weights(cfg, ctx.seed, dev)
    model, stream = program_bevformer.build_stream(cfg, weights, dev)
    del weights
    rng = np.random.default_rng([ctx.seed % 2 ** 63, 37])
    keeper = Keeper(dev)
    kept = []                           # (sample, prev BEV, outputs, dets)
    # the window's first scene start, and whether it was the window's: the
    # warm-up's (sample 0) stands in until the window reaches one
    start = [None, False]

    def keep(n, i, prev, out, dets):
        """The window's n-th sample, sample i of the loop."""
        if i % P == 0 and not start[1]:
            start[:] = [item(i, prev, out, dets), True]
        if n < tr["check_batches"]:
            kept.append(item(i, prev, out, dets))
        else:
            j = rng.integers(0, n + 1)
            if j < len(kept):
                kept[j] = item(i, prev, out, dets)

    def item(i, prev, out, dets):
        return (i, None if prev is None else keeper(prev),
                {k: keeper(out[k][-1:] if k == "all_cls_scores" else out[k])
                 for k in out}, dets)

    def host(i):
        j = i % P
        return {k: pool[k][j * B:(j + 1) * B] for k in
                program_bevformer.KEYS}

    def one(i, tracing):
        with span("bench.h2d", tracing):
            x = program_bevformer.to_device(host(i), dev)
        with span("bench.forward", tracing):
            prev = stream.prev_bev if i // P == stream.scene else None
            out = stream(x, i // P)
        with span("bench.decode", tracing):
            dets = petr_decode(out["all_cls_scores"][-1],
                               out["all_bbox_preds"][-1],
                               cfg["post_center_range"], cfg["max_num"])
        return prev, out, dets

    for i in range(WARM_CALLS):
        prev, out, dets = one(i, False)
        if i == 0:
            start[0] = item(i, prev, out, dets)
    # a kept sample holds two BEVs; the reservoir, the scene start and the
    # items being replaced
    keeper.reserve(out["bev_embed"].shape, out["bev_embed"].dtype,
                   2 * (tr["check_batches"] + 3))
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
        prev, out, dets = one(WARM_CALLS + n, tracing)
        keep(n, WARM_CALLS + n, prev, out, dets)
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

    del model, stream
    program.release(dev)
    checks.no_tf32()
    w = make_weights(cfg, ctx.seed, dev)
    inf = float("inf")
    worst = dict.fromkeys(("output_gap", "bev_gap", "decode_mismatch"),
                          0.0 if kept else inf)
    for i, prev, out, dets in kept + start[:1]:
        x = {k: v.to(dev) for k, v in host(i).items()}
        prev_can = None if prev is None else host(i - 1)["can_bus"].to(dev)
        with torch.no_grad():
            r = ref.forward(w, cfg, x, None if prev is None else prev.to(dev),
                            prev_can, along={k: v.to(dev)
                                             for k, v in out.items()})
        got = {"output_gap": max(ref.output_gaps(out, r).values()),
               "bev_gap": ref.bev_gap(out["bev_embed"], r["bev_embed"])}
        mine = ref.decode(out["all_cls_scores"][-1].float().cpu().numpy(),
                          out["all_bbox_preds"][-1].float().cpu().numpy(),
                          cfg["post_center_range"], cfg["max_num"])
        got["decode_mismatch"] = ref.decode_mismatch(dets, mine)
        worst = {k: max(v, float(got[k])) for k, v in worst.items()}
        del r
    lim = ctx.limits
    return Run(
        attempted=n, failed=0,
        metrics={"eval_frames_per_s": n * B * N / window,
                 "setup_s": setup_s},
        checks={k: (v, float(lim[k])) for k, v in worst.items()},
        memory_peak_bytes=peak, trace=stretch,
        counts={"batches": float(traced), "batch": float(B)})

"""Readings for setting the BEVFormer cell's limits: the program's gaps
over many seeds and the control's (the reference in the program's place,
computed in fp8, one step below the configuration's bf16), in one
process; and the drift of the program's carried chain from the
reference's own.

    python3 -m benchmark.calibrate_bevformer --workload <cell> \
        --seeds 1,2,... [--control-seeds 1,2]

Per seed the seed's scene in order through the program's stream
(`BEVStream(Graphed(model))`, as the loop runs it: a first sample, then
carried ones), which holds every sample a run can check, each against
the reference on the same inputs (the program's own carried BEV), its
decoder along the program's trajectory, as the loop checks:
`reference.bevformer.output_gaps` and `bev_gap`. On the control seeds
also the control on the same inputs (checked the same way, along its own
trajectory), and the reference's own f32 chain, free-running (each
sample on the reference's previous BEV, its decoder on its own BEV and
points), against which the program's chain drifts: its gaps are printed
as kind "drift". Prints one
JSON line per reading; run on the card. The command line is
`calibrate`'s.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from . import calibrate, checks, data_bevformer, program, program_bevformer
from .reference import bevformer as ref
from .reference.model import Precision
from .weights_bevformer import make_weights


def forward_cell(cell, seeds, control, dev):
    cfg, tr = cell.config, cell.traffic
    B, P = tr["batch"], tr["pool_batches"]
    model = stream = None
    for seed in seeds:
        t0 = time.time()
        w = make_weights(cfg, seed, dev)
        if model is None:
            model, stream = program_bevformer.build_stream(cfg, w, dev)
        else:
            program.load_weights(model, w)
        pool = data_bevformer.make_scene(B * P, cfg, tr["boxes"], seed, dev)
        prev = prev_can = chain = None
        for i in range(P):
            x = program_bevformer.to_device(
                {k: v[i * B:(i + 1) * B] for k, v in pool.items()}, dev)
            out = stream(x, seed)
            checks.no_tf32()
            with torch.no_grad():
                runs = {"program": (out, ref.forward(w, cfg, x, prev,
                                                     prev_can, along=out))}
                if seed in control:
                    c = ref.forward(w, cfg, x, prev, prev_can,
                                    Precision("fp8"))
                    runs["control"] = (c, ref.forward(w, cfg, x, prev,
                                                      prev_can, along=c))
                    r = ref.forward(w, cfg, x, chain, prev_can)
                    runs["drift"] = (out, r)
                    chain = r["bev_embed"]
            for kind, (o, r) in runs.items():
                g = ref.output_gaps(o, r)
                print(json.dumps({
                    "cell": cell.name, "seed": seed, "batch": i,
                    "kind": kind, "output_gap": max(g.values()),
                    "bev_gap": ref.bev_gap(o["bev_embed"], r["bev_embed"]),
                    "by_output": {k: round(v, 6) for k, v in g.items()},
                    "s": round(time.time() - t0, 1)}), flush=True)
            prev, prev_can = out["bev_embed"], x["can_bus"]


def main(argv=None) -> int:
    """`calibrate`'s command line and checks, with this forward."""
    calibrate.forward_cell = forward_cell
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())

"""Readings for setting a PETR cell's limits: the program's output gaps
over many seeds and the control's (the reference in the program's place,
computed in fp8, one step below the configuration's bf16), in one
process.

    python3 -m benchmark.calibrate_petr --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3]

Per seed the program's forward (`Graphed(model)`, as the loop replays it)
of every batch of the seed's pool, which holds every batch a run can
check, against the reference (`reference.petr.output_gaps`), and on the
control seeds the control's. Prints one JSON line per reading; run on the
card. The command line is `calibrate`'s.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from . import calibrate, checks, data_petr, program, program_petr
from .reference import petr as ref
from .reference.model import Precision
from .weights_petr import make_weights


def forward_cell(cell, seeds, control, dev):
    from parq_torch.graphs import Graphed
    cfg, tr = cell.config, cell.traffic
    B, P = tr["batch"], tr["pool_batches"]
    graphed = model = None
    for seed in seeds:
        t0 = time.time()
        w = make_weights(cfg, seed, dev)
        if model is None:
            model = program_petr.build_model(cfg, w, dev)
            graphed = Graphed(model)
        else:
            program.load_weights(model, w)
        pool = data_petr.make_pool(B * P, cfg, tr["boxes"], seed, dev)
        for i in range(P):
            x = program_petr.to_device(
                {k: v[i * B:(i + 1) * B] for k, v in pool.items()}, dev)
            with torch.inference_mode():
                out = graphed(x)
            checks.no_tf32()
            with torch.no_grad():
                r = ref.forward(w, cfg, x)
                runs = {"program": out}
                if seed in control:
                    runs["control"] = ref.forward(w, cfg, x,
                                                  Precision("fp8"))
            for kind, o in runs.items():
                g = ref.output_gaps(o, r)
                print(json.dumps({
                    "cell": cell.name, "seed": seed, "batch": i,
                    "kind": kind, "output_gap": max(g.values()),
                    "by_output": {k: round(v, 6) for k, v in g.items()},
                    "s": round(time.time() - t0, 1)}), flush=True)


def main(argv=None) -> int:
    """`calibrate`'s command line and checks, with this forward."""
    calibrate.forward_cell = forward_cell
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())

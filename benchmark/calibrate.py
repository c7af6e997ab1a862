"""Readings for setting a cell's limits: the program's numbers over many
seeds and the control's (the reference in the program's place, computed
in fp8, one step below the configuration's bf16), in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3]

Per seed the program's forward (`Graphed(model)`, as the eval loop
replays it) of every batch of the seed's pool, which holds every batch a
run can check, against the reference (`checks.output_gaps` per output
and iteration), and on the control seeds the control's. Prints one JSON
line per reading; run on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import checks, data, program
from .harness import find_cell
from .weights import make_weights


def forward_cell(cell, seeds, control, dev):
    from parq_torch.graphs import Graphed
    cfg, tr = cell.config, cell.traffic
    B, P = tr["batch"], tr["pool_batches"]
    graphed = model = None
    for seed in seeds:
        t0 = time.time()
        w = make_weights(cfg, seed, dev)
        if model is None:
            model = program.build_model(cfg, cell.root, w, dev)
            graphed = Graphed(model)
        else:
            program.load_weights(model, w)
        pool = data.make_pool(B * P, cfg["num_views"], cfg["image_size"],
                              tr["boxes"], seed, dev)
        for i in range(P):
            x = data.take(pool, slice(i * B, (i + 1) * B), program.EVAL_KEYS)
            with torch.inference_mode():
                out = graphed(program.to_device(x, program.EVAL_KEYS, dev))
            runs = {"program": out}
            if seed in control:
                runs["control"] = checks.reference_forward(
                    cfg, cell.root, w, x, dev, "fp8")
            for kind, o in runs.items():
                rd, ref = checks.forward_readings(cfg, cell.root, w, x, o,
                                                  dev)
                g = checks.output_gaps(o, ref)
                print(json.dumps({
                    "cell": cell.name, "seed": seed, "batch": i, "kind": kind,
                    **rd, "by_output": {k: [round(x, 6) for x in v]
                                        for k, v in g.items()},
                    "s": round(time.time() - t0, 1)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(Path.cwd(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds += [s for s in sorted(control) if s not in seeds]
    forward_cell(cell, seeds, control, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())

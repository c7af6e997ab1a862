"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Reads BENCHMARK.json, finds the cell's
configuration, traffic mix, loop kind and limits by name, makes the
inputs and weights from --seed, sets up and warms the program
(`parq_torch`), measures for --seconds, checks what the timed path
produced against the plain reference (`benchmark/reference`), and prints
one JSON line last on standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics; with --trace 1 its per-layer
metrics, read from a profiled stretch of the window), device and, traced,
breakdown; the compared numbers with their limits come last, under
`checks`, and again as the last lines on standard error.

Exits 3 and prints no result without a CUDA device (or with fewer than
the cell asks for), and 4 if a module of JAX or of the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .harness import (BenchError, check_lines, find_cell, forbidden_modules,
                      process_start, result_line)

# the port's builds stay in the checkout (build/parq_torch/); keep any
# library that would look for JAX from loading it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What a loop is given: the cell, the run's arguments, the device
    and the process's start time."""

    def __init__(self, cell, seed, seconds, trace, device, t_start):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = bool(trace), device, t_start
        self.config, self.traffic = cell.config, cell.traffic
        self.limits = cell.limits


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """One run of `workload` on `device` (no look for a card): the result
    line's object."""
    cell = find_cell(root, workload)
    ctx = Context(cell, seed, seconds, trace, device, t_start)
    run = cell.loop().run(ctx)
    return result_line(cell, run, trace, device), run


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    root = Path.cwd()
    try:
        cell = find_cell(root, args.workload)
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    out, run = run_cell(root, args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 4
    for line in check_lines(run):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

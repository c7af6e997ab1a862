"""The release train step on the card (B=8 bf16, dropout 0.1, synthetic
snippets) for one or several checkouts of the repository in turn: step ms,
the device's busy and idle share of a profiled step, and the synchronizing
operations of a step with their sites; eager with the plain AdamW, eager
with the capturable AdamW and replayed as a CUDA graph, where the checkout
has `make_graphed_train_step`.

    python parq_torch/tools/step_times.py [--tree DIR ...] [--steps N]
        [--top N]

Each DIR (default: the checkout this file lies in) runs in a process of
its own whose `parq_torch` is DIR's, so two commits can be compared on one
card in one call: give the parent's tree and this one in turns (parent,
change, change, parent). The timers and the sync count are this
checkout's (`tools/syncs.py`, loaded from beside this file, so a tree
that lacks it is counted the same way), and so is the profile
(`tools/profiling.py`). Per tree and form it prints the
steps' ms from CUDA events (after 2 warm-up steps, the graph's capture
among them) as median and quartiles, one profiled step's wall ms and
device busy ms (torch.profiler), and the synchronizing operations of one
step (sync debug mode "warn"); with `--top N` the N kernels of the
profiled step with the most device time, by name; for an eager form the
device time of its AdamW step alone, profiled after the step. Since the
port's graph layer the eager step makes none (16 before it) and so does a
replay.
"""
import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _this_checkout(name):
    """tools/<name>.py of this checkout, whatever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_of_this_checkout", Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_tree(steps, top):
    sys.path.insert(0, os.getcwd())
    import inspect
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_times: no CUDA device is visible")
    import parq_torch
    from parq_torch.train.__main__ import build, synthetic_batches
    ts = importlib.import_module("parq_torch.train.train_step")
    count_syncs = _this_checkout("syncs").count_syncs
    device_profile = _this_checkout("profiling").device_profile
    net, _ = build("release", "bfloat16", seed=0, device="cuda")
    batches = synthetic_batches(net.cfg, 8, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    opts = {"eager": ts.make_optimizer(net)}
    if "capturable" in inspect.signature(ts.make_optimizer).parameters:
        opts["eager, capturable AdamW"] = ts.make_optimizer(
            net, capturable=True)
    forms = [(form, opt, lambda b, opt=opt: ts.train_step(net, opt, b, gen))
             for form, opt in opts.items()]
    if hasattr(ts, "make_graphed_train_step"):
        opt = list(opts.values())[-1]
        graphed = ts.make_graphed_train_step(net, opt)
        forms.append(("graph", opt, lambda b: graphed(b, gen)))
    for form, opt, step in forms:
        for i in range(2):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
        ms = []
        for i in range(steps):
            t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t[0].record()
            step(batches[i % len(batches)])
            t[1].record()
            torch.cuda.synchronize()
            ms.append(t[0].elapsed_time(t[1]))
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"{form}: {steps} steps: median {med:.2f} ms, quartiles "
              f"{q1:.2f}-{q3:.2f} ms (CUDA events); all: "
              + ", ".join(f"{x:.1f}" for x in ms), flush=True)
        prof = device_profile(lambda: step(batches[0]))
        wall, busy = prof["wall_ms"], prof["busy_ms"]
        print(f"{form}: profiled step: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f}%)",
              flush=True)
        for name, kms, n in prof["kernels"][:top]:
            print(f"{form}:   {kms:8.3f} ms {n:5d}x {name[:100]}",
                  flush=True)
        if form != "graph":
            prof = device_profile(opt.step)
            print(f"{form}: its AdamW step alone: device busy "
                  f"{prof['busy_ms']:.3f} ms in "
                  f"{sum(n for _, _, n in prof['kernels'])} launches",
                  flush=True)
        n, sites = count_syncs(lambda: step(batches[0]),
                               port=os.path.dirname(parq_torch.__file__))
        print(f"{form}: synchronizing operations in a step: {n} at "
              f"{dict(sites)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time; may be given several times")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=0,
                    help="print the N kernels of a profiled step with the "
                         "most device time")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_tree(args.steps, args.top)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in args.tree or [str(HERE)]:
        print(f"--- {tree}", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", "--steps", str(args.steps),
                        "--top", str(args.top)], cwd=tree,
                       check=True)


if __name__ == "__main__":
    main()

"""The release train step on the card (B=8 bf16, dropout 0.1, synthetic
snippets) for one or several checkouts of the repository in turn: step ms,
the device's busy and idle share of a profiled step, and the synchronizing
operations of a step with their sites.

    python parq_torch/tools/step_times.py [--tree DIR ...] [--steps N]

Each DIR (default: the checkout this file lies in) runs in a process of
its own whose `parq_torch` is DIR's, so two commits can be compared on one
card in one call: give the parent's tree and this one in turns (parent,
change, change, parent). The timers and the sync count are this
checkout's (`tools/syncs.py`, loaded from beside this file, so a tree
that lacks it is counted the same way). Per tree it prints the steps'
ms from CUDA events (after 2 warm-up steps) as median and quartiles, one
profiled step's wall ms and device busy ms (torch.profiler), and the
synchronizing operations of one step (sync debug mode "warn").
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _count_syncs():
    spec = importlib.util.spec_from_file_location(
        "syncs_of_this_checkout", Path(__file__).with_name("syncs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count_syncs


def one_tree(steps):
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("step_times: no CUDA device is visible")
    import parq_torch
    from parq_torch.train.__main__ import build, synthetic_batches
    from parq_torch.train.train_step import train_step
    count_syncs = _count_syncs()
    net, opt = build("release", "bfloat16", seed=0, device="cuda")
    batches = synthetic_batches(net.cfg, 8, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for i in range(2):
        train_step(net, opt, batches[i % len(batches)], gen)
    torch.cuda.synchronize()
    ms = []
    for i in range(steps):
        t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t[0].record()
        train_step(net, opt, batches[i % len(batches)], gen)
        t[1].record()
        torch.cuda.synchronize()
        ms.append(t[0].elapsed_time(t[1]))
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"{steps} steps: median {med:.2f} ms, quartiles {q1:.2f}-{q3:.2f} "
          f"ms (CUDA events); all: " + ", ".join(f"{x:.1f}" for x in ms),
          flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(net, opt, batches[0], gen)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    print(f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle {100 * (1 - busy / wall):.1f}%)", flush=True)
    n, sites = count_syncs(lambda: train_step(net, opt, batches[0], gen),
                           port=os.path.dirname(parq_torch.__file__))
    print(f"synchronizing operations in a step: {n} at {dict(sites)}",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time; may be given several times")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_tree(args.steps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in args.tree or [str(HERE)]:
        print(f"--- {tree}", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", "--steps", str(args.steps)], cwd=tree,
                       check=True)


if __name__ == "__main__":
    main()

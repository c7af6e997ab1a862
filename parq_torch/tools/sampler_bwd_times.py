"""Kernel B4 (the sampler's d(memory)) on the card: its times on three
distributions of the rows, and its share of one release train step, for one
or several checkouts of the repository in turn.

    python parq_torch/tools/sampler_bwd_times.py [--tree DIR ...] [--step]

Each DIR (default: the checkout this file lies in) is timed in a process of
its own whose `parq_torch` is DIR's, so two commits can be compared on one
card in one call: give the parent's tree and this one, in the order wanted.
The inputs and the timers are always those of this checkout's
chip_smoke.py (`sampler_bwd_inputs`, `device_ms`: CUDA-graph replay). Per
tree it prints, for bf16 and f32, the wrapper's ms per launch on each
distribution (and, in brackets, with g already in the memory's dtype),
whether two launches are equal bit for bit, and the error against the plain
version. With --step it also runs 4 release train steps (B=8 bf16) and
prints, for the last, the kernel's device time from torch.profiler, the
memory's dtype and how many of the step's rows have a tap inside the image.
"""
import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(cs, torch):
    from parq_torch.config import ModelConfig
    from parq_torch.kernels.pixel_align import (sample_views_bwd_mem,
                                                sample_views_bwd_mem_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape, g, dists = cs.sampler_bwd_inputs(
        ModelConfig(compute_dtype="bfloat16"), 8, gen)
    for dtype in (torch.bfloat16, torch.float32):
        g_cast = g.to(dtype)
        for name, u in dists.items():
            got = sample_views_bwd_mem(u, g, shape, dtype)
            same = torch.equal(got, sample_views_bwd_mem(u, g, shape, dtype))
            err, rel = cs._rel_err(
                got, sample_views_bwd_mem_plain(u, g, shape, dtype))
            del got
            whole, kernel = (cs.device_ms(lambda: sample_views_bwd_mem(
                u, x, shape, dtype), 10) for x in (g, g_cast))
            print(f"B4 {str(dtype)[6:]} {name}: {whole:.4f} ms/launch "
                  f"[{kernel:.4f} with g already cast]; two launches equal "
                  f"bit for bit: {same}; max abs err {err:.3e} ({rel:.2e} of "
                  "the plain result's max)", flush=True)


def step_share(cs, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parq_torch.kernels import pixel_align as pa
    from parq_torch.train.__main__ import build, synthetic_batches
    from parq_torch.train.train_step import train_step
    net, opt = build("release", "bfloat16", seed=0, device="cuda")
    batches = synthetic_batches(net.cfg, 8, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    wrapper, seen = pa.sample_views_bwd_mem, []

    def watched(uvs, g, mem_shape, dtype):
        seen.append((dtype, cs.rows_in_image(uvs, *mem_shape[2:4])))
        return wrapper(uvs, g, mem_shape, dtype)
    watched.launches = 0     # the wrapper counts on the module's name
    pa.sample_views_bwd_mem = watched
    for i in range(3):
        train_step(net, opt, batches[i % len(batches)], gen)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        train_step(net, opt, batches[3 % len(batches)], gen)
        torch.cuda.synchronize()
    pa.sample_views_bwd_mem = wrapper
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA   # kernels only
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    dtype, share = seen[-1]
    print(f"train step 3: device busy {sum(k[1] for k in kernels):.2f} ms; "
          f"d(memory) in {str(dtype)[6:]}; {100 * share:.1f}% of its rows "
          "have a tap inside the image", flush=True)
    for key, ms, n in kernels:
        if "sample_bwd_mem" in key:
            print(f"  {ms:.4f} ms x{n} {key[:110]}", flush=True)


def one_tree(step):
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        sys.exit("sampler_bwd_times: no CUDA device is visible")
    cs = _smoke()
    kernel_times(cs, torch)
    if step:
        step_share(cs, torch)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time; may be given several times")
    ap.add_argument("--step", action="store_true",
                    help="also profile B4 inside a release train step")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_tree(args.step)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in args.tree or [str(HERE)]:
        print(f"--- {tree}", flush=True)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one"]
        subprocess.run(cmd + (["--step"] if args.step else []), cwd=tree,
                       check=True)


if __name__ == "__main__":
    main()

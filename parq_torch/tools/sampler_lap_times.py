"""Kernels B1 (the sampler's forward) and M1 (the matcher's LAP) on the card,
for one or several checkouts of the repository in turn, on the same inputs.

    python parq_torch/tools/sampler_lap_times.py [--tree DIR ...] [--step]

Each DIR (default: the checkout this file lies in) runs in a process of its
own whose `parq_torch` is DIR's, so two commits can be compared on one card
in one call: give the parent's tree and this one in turns (parent, change,
change, parent). The first process makes the inputs with this checkout's
chip_smoke.py (`release_sampler_inputs`, `matcher_inputs`) and saves
them; every process loads the same ones, times with this
checkout's `device_ms` (CUDA-graph replay) and saves its outputs. Per tree
it prints ms per launch of B1 at three shapes (release B=8 T=3, eval B=1
T=3, scaled B=1 T=6; bf16 memory) and of M1 on the release problem (64
pairs, 100 x 256) at the batch's 3 targets a pair and at 100, and the
scaled P=16. Then, against the first tree: whether B1's f32 sums are equal
bit for bit (a tree whose B1 writes bf16 gives its sums through
`sample_views_sums`), whether each tree's output equals the other's cast
to bf16, and whether M1's col4row is equal. With --step, each tree also
runs release train steps (B=8 bf16): the ms of B4's wrapper on the
arguments one step gave it (the dtype of its cotangent says whether the
wrapper cast it), and the device busy ms of a profiled step and of a
profiled eval forward (torch.profiler).
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SHAPES = ("release B=8 T=3", "eval B=1 T=3", "scaled B=1 T=6")
LAPS = ("release 3 targets", "release 100 targets", "scaled 3 targets",
        "scaled 100 targets")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(cs, torch):
    """The B1 and M1 inputs, on the card, made from fixed seeds."""
    from parq_torch.config import ModelConfig
    from parq_torch.ops.hungarian import lap_problem, match_cost
    from parq_torch.train.__main__ import TRAIN_KEYS, synthetic_batches
    cfg = ModelConfig(compute_dtype="bfloat16")
    scfg = cs.scaled_model_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b1 = {}
    for name, B in zip(SHAPES[:2], (8, 1)):
        b1[name] = cs.release_sampler_inputs(cfg, B, torch.bfloat16, gen)
    b1[SHAPES[2]] = cs.release_sampler_inputs(scfg, 1, torch.bfloat16, gen)
    m1 = {}
    batches = {"release": synthetic_batches(cfg, 8, "cuda")[0],
               "scaled": cs.scaled_batches(scfg, [0], TRAIN_KEYS)[0]}
    for name in LAPS:
        which = name.split()[0]
        mcfg = cfg if which == "release" else scfg
        inp = cs.matcher_inputs(mcfg, batches[which], mcfg.dec_layers, gen,
                                n_valid=100 if "100" in name else None)
        cost, _ = match_cost(*inp[:4])
        m1[name] = lap_problem(cost, inp[4])
    return {"b1": b1, "m1": m1}


def time_kernels(cs, torch, inputs):
    from parq_torch.kernels import pixel_align as pa
    from parq_torch.kernels.lap import solve_lap
    out = {"b1": {}, "m1": {}}
    sums_fn = getattr(pa, "sample_views_sums", None)
    for name in SHAPES:
        mem, uvs = inputs["b1"][name]
        got = pa.sample_views(mem, uvs)
        sums = got if sums_fn is None else sums_fn(mem, uvs)
        ms = cs.device_ms(lambda: pa.sample_views(mem, uvs), 50)
        bound = cs.sampler_bound_ms(mem, uvs, got.element_size())
        out["b1"][name] = dict(out=got.cpu(), sums=sums.cpu(), ms=ms)
        print(f"B1 {name}: {ms:.4f} ms/launch, output {str(got.dtype)[6:]}, "
              f"bound {bound:.4f} ms", flush=True)
    for name in LAPS:
        rows, n_rows = inputs["m1"][name]
        got = solve_lap(rows, n_rows)
        ms = cs.device_ms(lambda: solve_lap(rows, n_rows), 50)
        out["m1"][name] = dict(col4row=got.cpu(), ms=ms)
        print(f"M1 {name}: P={rows.shape[0]} {rows.shape[1]}x"
              f"{rows.shape[2]}: {ms:.4f} ms/launch", flush=True)
    return out


def step_numbers(cs, torch):
    """B4's wrapper on a release step's own arguments, and the device busy
    ms of a profiled step and of a profiled eval forward."""
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
        seen.append((uvs, g, mem_shape, dtype))
        return wrapper(uvs, g, mem_shape, dtype)
    watched.launches = 0
    pa.sample_views_bwd_mem = watched
    for i in range(3):
        train_step(net, opt, batches[i % len(batches)], gen)
    pa.sample_views_bwd_mem = wrapper
    uvs, g, shape, dtype = seen[-1]
    ms = cs.device_ms(lambda: wrapper(uvs, g, shape, dtype), 20)
    print(f"B4 wrapper in a release step: {ms:.4f} ms/launch, cotangent "
          f"{str(g.dtype)[6:]}, d(memory) {str(dtype)[6:]}", flush=True)

    def busy(run):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA   # kernels only
                   and not getattr(e, "is_user_annotation", False)) / 1e3
    steps = [busy(lambda: train_step(net, opt, batches[i % 2], gen))
             for i in range(3)]
    net.eval()
    with torch.inference_mode():
        for _ in range(2):
            net(batches[0])
        fwd = [busy(lambda: net(batches[0])) for _ in range(3)]
    print("device busy ms: release step " + ", ".join(
        f"{x:.3f}" for x in steps) + "; release eval forward B=8 "
        + ", ".join(f"{x:.3f}" for x in fwd), flush=True)


def one_tree(inputs_path, out_path, step):
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        sys.exit("sampler_lap_times: no CUDA device is visible")
    cs = _smoke()
    if os.path.exists(inputs_path):
        inputs = torch.load(inputs_path, map_location="cuda")
    else:
        inputs = make_inputs(cs, torch)
        torch.save(inputs, inputs_path)
    torch.save(time_kernels(cs, torch, inputs), out_path)
    if step:
        step_numbers(cs, torch)


def compare(torch, results, trees):
    """Each tree against the first: B1's sums bit for bit, its outputs
    equal once the f32 one is cast to the other's dtype, M1's col4row."""
    ref = results[0]
    for tree, res in zip(trees[1:], results[1:]):
        lines = []
        for name in SHAPES:
            a, b = ref["b1"][name], res["b1"][name]
            same_sums = torch.equal(a["sums"], b["sums"])
            dtype = min(a["out"].dtype, b["out"].dtype,
                        key=lambda d: torch.finfo(d).bits)
            same_out = torch.equal(a["out"].to(dtype), b["out"].to(dtype))
            lines.append(f"B1 {name}: f32 sums equal bit for bit: "
                         f"{same_sums}; outputs equal in "
                         f"{str(dtype)[6:]}: {same_out}")
        for name in LAPS:
            same = torch.equal(ref["m1"][name]["col4row"],
                               res["m1"][name]["col4row"])
            lines.append(f"M1 {name}: col4row equal: {same}")
        print(f"--- {tree} against {trees[0]}", flush=True)
        for line in lines:
            print("  " + line, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time; may be given several times")
    ap.add_argument("--step", action="store_true",
                    help="also time B4's wrapper in a release step and the "
                    "device busy time of a step and of a forward")
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_tree(*args.one, args.step)
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    trees = args.tree or [str(HERE)]
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        results = []
        for k, tree in enumerate(trees):
            print(f"--- {tree}", flush=True)
            out = os.path.join(tmp, f"{k}.pt")
            cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
                   inputs, out]
            subprocess.run(cmd + (["--step"] if args.step else []),
                           cwd=tree, check=True)
            results.append(torch.load(out))
        compare(torch, results, trees)


if __name__ == "__main__":
    main()

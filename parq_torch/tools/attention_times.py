"""Kernels B2 and B3 (flash cross-attention, forward and backward) on the
card, for one or several checkouts of the repository in turn, on the same
inputs.

    python parq_torch/tools/attention_times.py [--tree DIR ...]

Each DIR (default: the checkout this file lies in) runs in a process of its
own whose `parq_torch` is DIR's, so two commits can be compared on one card
in one call: give the parent's tree and this one in turns (parent, change,
change, parent). The first process makes the inputs from fixed seeds with
this checkout's chip_smoke.py (`attention_inputs`, `natural_kv`) and saves
them; every process loads the same ones, calls only the wrappers every
tree has (`flash_cross_attention_kv_fused`, `flash_fwd_lse`, `flash_bwd`,
`flash_fwd_lse_kv`, `flash_bwd_kv`), times each case with this
checkout's `device_ms` (CUDA-graph replay) seven times, keeping the median,
and profiles one launch of each B3 case
(`tools/profiling.py`: device ms per kernel name, so the dkv pass, the dq
pass and, where the dq pass splits, its combine). Cases, bf16, 4 heads of
256, dropout 0.1 in the training forms:

- release: B=8, Q=256, N=14,400: B2, B2-train, B2-train with the v2 hash;
  B3 at the fold (Q=2048 in 8 seed groups), also with the v2 hash;
- split: an SP rank's 7,200 tokens as natural (B, N, H·D) K and V, and as
  legacy (B, H, N, D) buffers padded to 9,600 rows: B2-train at Q=256,
  B3 at the fold;
- scaled (configs/scaled_recurrence.yaml): B=1, Q=256, N=28,800: B2,
  B2-train, B3 (one iteration, as the REMAT path calls it);
- eval B=1: B=1, Q=256, N=14,400 (the eval twin, /detect at batch 1): B2.

Then, against the first tree, whether each output is equal bit for bit and
its largest difference.
"""
import argparse
import hashlib
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
RATE = 0.1
H, D, Q0, L = 4, 256, 256, 8
N_RELEASE, N_SCALED = 14400, 28800
N_SP, N_PAD = N_RELEASE // 2, 9600
CASES = ("B2 release", "B2-train release", "B2-train v2", "B3 release fold",
         "B3 v2", "B2-train split", "B3 split", "B2-train legacy",
         "B3 legacy", "B2 scaled", "B2-train scaled", "B3 scaled",
         "B2 eval B=1")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _views(inp, torch):
    """The split cases' K/V views: natural (B, H, N, D) views of the
    release buffer's first N_SP tokens, and the same values in legacy
    (B, H, N_PAD, D) buffers, zero past N_SP."""
    from parq_torch.kernels.cross_attention import heads_view
    k, v = inp["k_sp"], inp["v_sp"]
    legacy = []
    for t in (k, v):
        buf = torch.zeros(8, H, N_PAD, D, dtype=t.dtype, device=t.device)
        buf[:, :, :N_SP] = t.view(8, N_SP, H, D).transpose(1, 2)
        legacy.append(buf)
    return ((heads_view(k, H, N_SP), heads_view(v, H, N_SP)),
            tuple(heads_view(t, H, N_SP) for t in legacy), (k, v, *legacy))


def make_inputs(cs, torch):
    """q, kv, the cotangents and seeds from fixed seeds, and each B3 case's
    lse and delta from the first tree's forward."""
    from parq_torch.kernels import flash_fwd_lse, flash_fwd_lse_kv
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    q8, kv8 = cs.attention_inputs(8, H, Q0, N_RELEASE, D, bf, gen)
    qf, _ = cs.attention_inputs(8, H, L * Q0, 1, D, bf, gen)
    q1, kv_s = cs.attention_inputs(1, H, Q0, N_SCALED, D, bf, gen)
    do_f = torch.randn(qf.shape, device="cuda", generator=gen).to(bf)
    do_1 = torch.randn(q1.shape, device="cuda", generator=gen).to(bf)
    k_sp, v_sp = cs.natural_kv(kv8[:, :N_SP], H)
    inp = dict(q8=q8, kv8=kv8, qf=qf, q1=q1, kv_s=kv_s, do_f=do_f,
               do_1=do_1, k_sp=k_sp, v_sp=v_sp,
               s1=cs.seed_vector(1, gen), sL=cs.seed_vector(L, gen))
    (kh, vh), _, _ = _views(inp, torch)
    for name, (o, lse), do in (
            ("fold", flash_fwd_lse(qf, kv8, inp["sL"], RATE), do_f),
            ("v2", flash_fwd_lse(qf, kv8, inp["sL"], RATE, v2=True), do_f),
            ("split", flash_fwd_lse_kv(qf, kh, vh, inp["sL"], RATE), do_f),
            ("scaled", flash_fwd_lse(q1, kv_s, inp["s1"], RATE), do_1)):
        inp[f"lse_{name}"] = lse
        inp[f"delta_{name}"] = (do.float() * o.float()).sum(-1)
    return inp


def cases(inp, torch):
    """name → (call, timing reps); each call returns its outputs."""
    from parq_torch.kernels import (flash_bwd, flash_bwd_kv,
                                    flash_cross_attention_kv_fused,
                                    flash_fwd_lse, flash_fwd_lse_kv)
    (kh, vh), (kl, vl), bufs = _views(inp, torch)
    q8, kv8, qf, q1, kv_s = (inp[k] for k in ("q8", "kv8", "qf", "q1",
                                               "kv_s"))
    s1, sL, do_f, do_1 = inp["s1"], inp["sL"], inp["do_f"], inp["do_1"]
    kv1 = kv8[:1].contiguous()
    grads = [torch.zeros_like(t) for t in bufs[:2]]
    grads_l = [torch.zeros_like(t) for t in bufs[2:]]

    def split_bwd(k, v, dk_buf, dv_buf):
        from parq_torch.kernels.cross_attention import heads_view
        dk, dv = (heads_view(t, H, N_SP) for t in (dk_buf, dv_buf))
        dq = flash_bwd_kv(qf, k, v, do_f, inp["lse_split"],
                          inp["delta_split"], sL, RATE, dk, dv)
        return dq, dk_buf, dv_buf

    def bwd(q, kv, do, name, seeds, **kw):
        return lambda: flash_bwd(q, kv, do, inp[f"lse_{name}"],
                                 inp[f"delta_{name}"], seeds, RATE, **kw)
    return {
        "B2 release": (lambda: (flash_cross_attention_kv_fused(q8, kv8),),
                       20),
        "B2-train release": (lambda: flash_fwd_lse(q8, kv8, s1, RATE), 20),
        "B2-train v2": (lambda: flash_fwd_lse(q8, kv8, s1, RATE, v2=True),
                        20),
        "B3 release fold": (bwd(qf, kv8, do_f, "fold", sL), 10),
        "B3 v2": (bwd(qf, kv8, do_f, "v2", sL, v2=True), 10),
        "B2-train split": (lambda: flash_fwd_lse_kv(q8, kh, vh, s1, RATE),
                           20),
        "B3 split": (lambda: split_bwd(kh, vh, *grads), 10),
        "B2-train legacy": (lambda: flash_fwd_lse_kv(q8, kl, vl, s1, RATE),
                            20),
        "B3 legacy": (lambda: split_bwd(kl, vl, *grads_l), 10),
        "B2 scaled": (lambda: (flash_cross_attention_kv_fused(q1, kv_s),),
                      50),
        "B2-train scaled": (lambda: flash_fwd_lse(q1, kv_s, s1, RATE), 50),
        "B3 scaled": (bwd(q1, kv_s, do_1, "scaled", s1), 20),
        "B2 eval B=1": (lambda: (flash_cross_attention_kv_fused(q8[:1],
                                                                 kv1),), 50),
    }


def _digest(t, torch):
    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha1(raw.tobytes()).hexdigest()


def time_cases(cs, torch, inp):
    from parq_torch.tools.profiling import device_profile
    out = {}
    for name, (call, reps) in cases(inp, torch).items():
        res = call()
        runs = [cs.device_ms(call, reps) for _ in range(7)]
        ms = statistics.median(runs)
        passes = []
        if name.startswith("B3"):
            prof = device_profile(call)
            passes = [] if prof is None else [
                (m.group(0), t, n) for k, t, n in prof["kernels"]
                for m in [re.search(r"flash_\w+", k)] if m]
        out[name] = dict(ms=ms, runs=runs, passes=passes,
                         digests=[_digest(t, torch) for t in res],
                         small=[t.cpu() if t.numel() < 2 ** 24 else None
                                for t in res])
        print(f"{name}: {ms:.4f} ms/launch (median of "
              + ", ".join(f"{x:.4f}" for x in runs) + ")" + "".join(
            f"; {k} {t:.4f} ms x{n}" for k, t, n in passes), flush=True)
    return out


def one_tree(inputs_path, out_path):
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        sys.exit("attention_times: no CUDA device is visible")
    cs = _smoke()
    if os.path.exists(inputs_path):
        inp = torch.load(inputs_path, map_location="cuda")
    else:
        inp = make_inputs(cs, torch)
        torch.save(inp, inputs_path)
    torch.save(time_cases(cs, torch, inp), out_path)


def compare(results, trees):
    """The ms of every case per tree, then each tree's outputs against the
    first tree's: equal bit for bit, or their largest difference."""
    print("--- ms per launch, trees in the order given: "
          + ", ".join(trees), flush=True)
    for name in CASES:
        print(f"  {name}: " + ", ".join(f"{r[name]['ms']:.4f}"
                                        for r in results), flush=True)
    ref = results[0]
    for tree, res in zip(trees[1:], results[1:]):
        print(f"--- {tree} against {trees[0]}", flush=True)
        for name in CASES:
            a, b = ref[name], res[name]
            same = a["digests"] == b["digests"]
            gaps = [f"{(x.float() - y.float()).abs().max().item():.3e}"
                    for x, y in zip(a["small"], b["small"])
                    if x is not None and y is not None]
            print(f"  {name}: equal bit for bit: {same}"
                  + ("" if same else f"; largest differences {gaps}"),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time; may be given several times")
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one_tree(*args.one)
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
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--one", inputs, out], cwd=tree, check=True)
            results.append(torch.load(out))
        compare(results, trees)


if __name__ == "__main__":
    main()

"""The data-parallel release step's bf16 loss against one process over the
global batch, over several generator seeds, for one or several checkouts
of the repository in turn: the readings behind chip_smoke.py's `[ddp]`
loss gate and its control.

    python parq_torch/tools/ddp_loss_gap.py [--tree DIR ...]
        [--seeds 1,2,3,4,5,6] [--dropout R] [--philox-masks]

Per tree (a process of its own whose `parq_torch` is DIR's, as in
tools/step_times.py) and generator seed, one release train step (B=8,
bf16, TF32 on, random weights from seed 0, synthetic snippets 0..7):
- `ranks`: two ranks on the one card (gloo over tcp://localhost), 4 rows
  each, the loss they report (the global batch's);
- `one`: one process over the 8 rows;
- `f32`: the same one-process step in f32, TF32 off;
- `dup`: the control, one process over rows 0..3 twice (what the ranks
  would report if rank 1 took rank 0's rows).
It prints rel = |ranks − one| / |one|, the control's |dup − one| / |one|
and rel32 = |one − f32| / |f32|, and their extremes over the seeds.
`--philox-masks` (one process only: the ranks are skipped) draws the
decoder's residual, self-attention and FFN keep masks as the port did
before its masks became a counter hash: a torch generator seeded by each
(iteration, salt) seed, `torch.rand < 1 − rate`, so the two mask families
can be compared on one tree.
"""
import argparse
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
B = 8


def _philox_keep(self, groups, salt, per_shape):
    import torch
    seeds = self.seeds.tolist()
    masks = []
    for l in groups:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds[l][salt])
        masks.append(torch.rand(tuple(per_shape), generator=gen,
                                device=self.device) < 1.0 - self.rate)
    return torch.cat(masks, dim=1) if len(masks) > 1 else masks[0]


def _step(cfg, rows, seed, mesh=None):
    """One train step's reported loss."""
    import torch
    from parq_torch.models import build_model
    from parq_torch.parallel.mesh import replicated
    from parq_torch.train.train_step import make_optimizer, train_step
    tf32 = cfg.compute_dtype != "float32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    model = build_model(cfg, seed=0, device="cuda").train()
    if mesh is not None:
        replicated(model).set_parallel(mesh, False)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = train_step(model, make_optimizer(model), rows, gen,
                   data_group=None if mesh is None else mesh.data_group)
    loss = float(m["total_loss"])
    del model
    torch.cuda.empty_cache()
    return loss


def _batch(rows):
    from parq_torch.config import ModelConfig
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.train.__main__ import TRAIN_KEYS
    return to_device(make_batch(rows, image_size=ModelConfig().image_size),
                     TRAIN_KEYS, "cuda")


def _rank(rank, world, port, cfg, seeds, queue):
    import datetime
    import torch
    import torch.distributed as dist
    from parq_torch.parallel.mesh import make_mesh, shard_batch
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(data=world, model=1)
        rows = shard_batch(_batch(list(range(B))), mesh)
        out = [_step(cfg, rows, s, mesh) for s in seeds]
        if rank == 0:
            queue.put(out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def one_tree(seeds, dropout, philox):
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        sys.exit("ddp_loss_gap: no CUDA device is visible")
    from parq_torch.config import ModelConfig
    from parq_torch.models import decoder
    cfg = ModelConfig(compute_dtype="bfloat16")
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout_rate=dropout)
    ranks = [None] * len(seeds)
    if philox:
        decoder.DropoutDraws.keep = _philox_keep
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        queue = ctx.SimpleQueue()
        procs = mp.start_processes(_rank, args=(2, port, cfg, seeds, queue),
                                   nprocs=2, join=False,
                                   start_method="spawn")
        try:
            while not procs.join(timeout=5):
                pass
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        ranks = queue.get()
    whole, dup = _batch(list(range(B))), _batch(list(range(B // 2)) * 2)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    rels, ctrl, rel32s = [], [], []
    for s, r in zip(seeds, ranks):
        one, l32 = _step(cfg, whole, s), _step(f32, whole, s)
        d = _step(cfg, dup, s)
        rel32s.append(abs(one - l32) / abs(l32))
        ctrl.append(abs(d - one) / abs(one))
        line = (f"seed {s}: one {one:.6f} f32 {l32:.6f} dup {d:.6f}: "
                f"rel32 {rel32s[-1]:.3e}, control {ctrl[-1]:.3e}")
        if r is not None:
            rels.append(abs(r - one) / abs(one))
            line += f"; ranks {r:.6f}: rel {rels[-1]:.3e}"
        print(line, flush=True)
    print(f"{os.getcwd()}: dropout {cfg.dropout_rate}, "
          f"{'philox' if philox else 'the tree'}'s masks, {len(seeds)} "
          f"seeds: rel max {max(rels) if rels else float('nan'):.3e}; "
          f"control min {min(ctrl):.3e}, max {max(ctrl):.3e}; rel32 min "
          f"{min(rel32s):.3e}, median {sorted(rel32s)[len(seeds) // 2]:.3e},"
          f" max {max(rel32s):.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to run; may be given several times")
    ap.add_argument("--seeds", default="1,2,3,4,5,6")
    ap.add_argument("--dropout", type=float, default=None,
                    help="the decoder's dropout rate (default: release's)")
    ap.add_argument("--philox-masks", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.one:
        return one_tree(seeds, args.dropout, args.philox_masks)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    extra = ["--seeds", args.seeds]
    if args.dropout is not None:
        extra += ["--dropout", str(args.dropout)]
    if args.philox_masks:
        extra.append("--philox-masks")
    for tree in args.tree or [str(HERE)]:
        print(f"--- {tree}", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one"] + extra, cwd=tree, check=True)


if __name__ == "__main__":
    main()

"""The port's twin of __graft_entry__.py:dryrun_multichip, with the
checkpoint half of its `_multihost_worker` (:166-249).

    python -c "from parq_torch.parallel import dryrun_multichip as d; d(4)"
    (on the CPU: d(4, "cpu"))

`dryrun_multichip(n, device)` starts n ranks (processes over gloo, or NCCL
when every rank has a card of its own) on a (data, model) grid laid out as
the JAX dry run lays out its mesh (:116-118): (n/2, 2) when n ≥ 4 and n is
even, else (n, 1). Each rank builds the tiny model of
`_flagship_model(tiny=True)` from one seed, shards its decoder over the
model group (`shard_model_`: tensor parallelism, as the JAX dry run applies
`param_sharding_rules`), takes its rows of the synthetic batch of n/model
rows (`shard_batch`) and one training step with dropout 0.1; the loss must
be finite. With model > 1 it also holds sequence-parallel cross-attention
(`sp_flash_cross_attention`, the memory tokens sharded over the model
group) against plain attention, as the JAX dry run's second half does.
Then the multihost dry run's checkpoint: a second step, a collective save
(the shards gathered into the reference layout, rank 0 writes), a restore
into a freshly sharded model and AdamW, every parameter and moment equal
bit for bit. The JAX multihost dry run's other half, jax.distributed over
hosts, is parallel/multihost.py.

On a CUDA device the tiny model's decoder is widened from dim 32 to 256
(head dim 8 to 64; FPN 8 to 64 channels, as the model ties them): the
flash kernels are built for head dims 64, 128 and 256
(kernels/cross_attention.py:HEAD_DIMS). The printed line names the widths.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device

TIMEOUT_S = 600.0
# the tiny decoder widened to the smallest head dim the kernels are built for
CARD_WIDTHS = dict(fpn_channels=64, tokenizer_out_channels=256, dec_dim=256)


def dryrun_model_config(device):
    """The dry run's model: `ModelConfig.tiny()` (dropout 0.1), widened on
    a CUDA device (`CARD_WIDTHS`)."""
    from ..config import ModelConfig
    cfg = ModelConfig.tiny()
    if torch.device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, **CARD_WIDTHS)
    return cfg


def grid(n: int):
    """(data, model) of n ranks, as __graft_entry__.py:116-118."""
    model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // model, model


def _sp_attention_gap(mesh, device) -> float:
    """max |SP attention − plain attention| over the model group, f32
    (the JAX dry run's shapes: B 2, H 2, Q 16, D 128, N 64 per rank)."""
    from .seq_parallel import sp_flash_cross_attention
    g = torch.Generator().manual_seed(0)
    B, H, Q, D, N = 2, 2, 16, 128, 64 * mesh.model
    q = torch.randn(B, H, Q, D, generator=g) * 0.5
    k = torch.randn(B, N, H * D, generator=g) * 0.3
    v = torch.randn(B, N, H * D, generator=g)
    idx = dist.get_rank(mesh.model_group)
    rows = slice(idx * N // mesh.model, (idx + 1) * N // mesh.model)
    o = sp_flash_cross_attention(q.to(device), k[:, rows].to(device),
                                 v[:, rows].to(device),
                                 group=mesh.model_group)
    kh = k.view(B, N, H, D).transpose(1, 2)
    vh = v.view(B, N, H, D).transpose(1, 2)
    s = (q @ kh.transpose(-1, -2)) / math.sqrt(D)
    ref = torch.softmax(s, dim=-1) @ vh
    return float((o.cpu() - ref).abs().max())


def _rank(rank: int, world: int, device_type: str, out_dir: str) -> dict:
    from ..data.synthetic import make_batch, to_device
    from ..models import build_model
    from ..train.__main__ import TRAIN_KEYS
    from ..train.checkpoint import CheckpointManager, restore_state
    from ..train.train_step import make_optimizer, train_step
    from .mesh import make_mesh, shard_batch
    from .tensor_parallel import shard_model_
    device = torch.device(device_type)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    data, model_axis = grid(world)
    mesh = make_mesh(data, model_axis)
    cfg = dryrun_model_config(device)

    def sharded_model():
        model = build_model(cfg, seed=0, device=device).train()
        model.set_parallel(mesh, False)
        return shard_model_(model, mesh)

    model = sharded_model()
    opt = make_optimizer(model, lr=1e-4)
    batch = shard_batch(to_device(make_batch(list(range(data)),
                                             image_size=cfg.image_size),
                                  TRAIN_KEYS, device), mesh)
    gen = torch.Generator(device=device).manual_seed(1)
    losses = []
    for _ in range(2):
        m = train_step(model, opt, batch, gen, max_norm=1.0,
                       data_group=mesh.data_group,
                       model_group=mesh.model_group)
        losses.append(float(m["total_loss"]))
        if not math.isfinite(losses[-1]):
            raise FloatingPointError(f"rank {rank}: loss {losses}")
    sp_gap = (_sp_attention_gap(mesh, device) if model_axis > 1 else None)
    if sp_gap is not None and sp_gap > 2e-5:
        raise AssertionError(f"rank {rank}: SP attention off by {sp_gap}")

    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), save_top_k=1)
    mgr.save(2, model, opt, metrics={"0.5_f1": 0.0})
    fresh = sharded_model()
    fresh_opt = make_optimizer(fresh, lr=1e-4)
    restore_state(mgr, fresh, fresh_opt, step=2)
    same = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 fresh.parameters()))
    for p, q in zip(opt.param_groups[0]["params"],
                    fresh_opt.param_groups[0]["params"]):
        s, t = opt.state[p], fresh_opt.state[q]
        # AdamW keeps its step count where the checkpoint was loaded to
        same = same and all(torch.equal(s[k].cpu(), t[k].cpu()) for k in s)
    if not same:
        raise AssertionError(f"rank {rank}: the restored state differs")
    local = sum(p.numel() for p in model.parameters())
    return {"losses": losses, "sp_gap": sp_gap, "local_params": local,
            "dec_dim": cfg.dec_dim, "heads": cfg.dec_heads}


def _rank_entry(rank, world, device_type, out_dir, backend):
    if device_type == "cpu":        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend,
                            init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        torch.save(_rank(rank, world, device_type, out_dir),
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device=None) -> str:
    """Run the dry run on n ranks of `device` (CUDA unless the caller asks
    for the CPU). Prints and returns its two lines: the JAX dry run's
    ``dryrun_multichip(n): mesh={'data': d, 'model': m} loss=… OK
    (+SP attention exact)``, and the checkpoint's. Raises if a rank fails
    or the ranks outlive TIMEOUT_S; leaves no process running."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n else "gloo")
    data, model_axis = grid(n)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_entry,
                                 args=(n, dev.type, out_dir, backend),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"dryrun_multichip({n}): the ranks "
                                       f"did not finish in {TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        outs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                for r in range(n)]
    loss = outs[0]["losses"][0]
    lines = [f"dryrun_multichip({n}): mesh={{'data': {data}, 'model': "
             f"{model_axis}}} loss={loss:.4f} OK"
             + (" (+SP attention exact)" if model_axis > 1 else ""),
             f"dryrun_multichip({n}): {dev.type}, backend {backend}, tiny "
             f"model at dim {outs[0]['dec_dim']} ({outs[0]['heads']} heads), "
             f"{outs[0]['local_params']} parameters a rank; losses of the 2 "
             f"steps {[round(x, 6) for x in outs[0]['losses']]}; SP "
             f"attention max abs err {outs[0]['sp_gap']}; collective "
             f"checkpoint saved and restored bit for bit on every rank; "
             f"{time.perf_counter() - t0:.1f} s"]
    text = "\n".join(lines)
    print(text, flush=True)
    return text


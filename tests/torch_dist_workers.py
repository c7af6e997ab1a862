"""Ranks of the port's multi-process tests, spawned with
torch.multiprocessing over gloo. No JAX here: the ranks import torch and
the port only.

`run_ranks(fn, world, tmp_path, *args)` starts `world` processes that join
one gloo process group through a ``file://`` rendezvous in `tmp_path` (no
TCP port, so parallel test workers cannot collide), runs
`fn(rank, world, *args)` in each, and returns each rank's result (saved
with torch.save). It fails if a rank raises, exits non-zero, or the ranks
do not finish within `timeout` seconds.
"""
from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, init_file, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 300.0):
    out_dir = str(tmp_path)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = mp.start_processes(_entry, args=(fn, world, init_file, out_dir,
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"{world} ranks did not finish in "
                                     f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in ctx.processes]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------- workers --
def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def sp_entries(rank, world, inp):
    """The four SP entries on this rank's token shard of inp's natural
    (B, N, H·D) k and v: (o, lse) of the forward with LSE; o and the
    gradients (dq summed over the group, the shard's dk and dv) of
    `sp_flash_cross_attention` and of the precomputed form; o of the fused
    eval form."""
    from parq_torch.parallel import seq_parallel as sp
    group = dist.group.WORLD
    N = inp["k"].shape[1]
    rows = slice(rank * N // world, (rank + 1) * N // world)
    kw = dict(group=group, dropout_rate=inp["rate"],
              dropout_seed=inp["seeds"])
    out = {}
    o, lse = sp.sp_flash_cross_attention_fwd_lse(
        _t(inp["q"]), _t(inp["k"][:, rows]), _t(inp["v"][:, rows]), **kw)
    out["fwd_lse"] = (o.numpy(), lse.numpy())
    for name in ("train", "precomputed"):
        q, k, v = (_t(inp["q"], True), _t(inp["k"][:, rows], True),
                   _t(inp["v"][:, rows], True))
        if name == "train":
            y = sp.sp_flash_cross_attention(q, k, v, **kw)
        else:
            y = sp.sp_flash_cross_attention_precomputed(q, k, v, o, lse,
                                                        **kw)
        y.backward(_t(inp["g"]))
        out[name] = (y.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
                     v.grad.numpy())
    out["kv_fused"] = sp.sp_flash_cross_attention_kv_fused(
        _t(inp["q"]), _t(inp["kv"][:, rows]), group=group).numpy()
    return out


def _decoder(cfg):
    from parq_torch.models.decoder import PARQDecoder
    return PARQDecoder(**cfg)


def _scene(scene):
    from parq_torch.geometry import Camera, Pose
    return (_t(scene["mem"]), Camera(_t(scene["camera"])),
            Pose(_t(scene["Tcp"])), Pose(_t(scene["Twp"])),
            Pose(_t(scene["Twl"])))


def sp_decoder_eval(rank, world, cfg, state, scene):
    """The port's decoder, memory tokens sharded over the group, eval."""
    dec = _decoder(cfg)
    dec.load_state_dict(state)
    dec.set_parallel(dist.group.WORLD)
    with torch.no_grad():
        out = dec(*_scene(scene), deterministic=True)
    return {k: v.float().numpy() for k, v in out.items()}


def model_grads(model, batch, uniforms):
    """(losses, {name: grad}) of one training forward and backward of the
    port's model, no optimizer step."""
    from parq_torch.train.train_step import forward_and_loss
    model.train()
    losses, _ = forward_and_loss(model, batch, None, uniforms=uniforms)
    losses["total_loss"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


def sp_model_grads(rank, world, mcfg, batch, uniforms):
    """The tiny model's training gradients with sequence parallelism over
    the group (dropout 0)."""
    from parq_torch.models import build_model
    from parq_torch.parallel.mesh import make_mesh
    model = build_model(mcfg, seed=1, device="cpu")
    model.set_parallel(make_mesh(data=1, model=world), True)
    batch = {k: _t(v) for k, v in batch.items()}
    return model_grads(model, batch, _t(uniforms))


def ddp_step(rank, world, mcfg, batch):
    """One train_step of the tiny model on this rank's rows of `batch`,
    gradients averaged over the data group: (metrics, {name: clipped
    grad}, {name: updated param})."""
    from parq_torch.models import build_model
    from parq_torch.parallel.mesh import make_mesh, shard_batch
    from parq_torch.train.train_step import make_optimizer, train_step
    mesh = make_mesh(data=world, model=1)
    model = build_model(mcfg, seed=1, device="cpu")
    model.set_parallel(mesh, False)
    opt = make_optimizer(model, lr=1e-3)
    rows = shard_batch({k: _t(v) for k, v in batch.items()}, mesh)
    gen = torch.Generator().manual_seed(7)
    m = train_step(model.train(), opt, rows, gen, data_group=mesh.data_group)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def checkpoint_barrier(rank, world, directory):
    """Every rank saves through one CheckpointManager: rank 0 writes."""
    from parq_torch.train.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory, save_top_k=1)
    model = torch.nn.Linear(2, 2)
    torch.manual_seed(0)
    torch.nn.init.normal_(model.weight)
    mgr.save(3, model, metrics={"0.5_f1": 0.5})
    mgr.save(5, model, metrics={"0.5_f1": 0.25})
    files = sorted(f for f in os.listdir(directory) if f.endswith(".pt"))
    restored = mgr.restore()["model"]["weight"]
    return {"files": files, "steps": mgr.steps(), "best": mgr.best_step(),
            "restored": torch.equal(restored, model.weight.detach())}


def trainer_fit(rank, world, cfg_path, log_path, opts):
    """The train twin on the CPU as one rank: (its parameters, the metrics
    rows and checkpoint files rank 0 wrote)."""
    import json
    from parq_torch.cli import train as cli_train
    trainer, _ = cli_train.main(["--cfg", cfg_path, "TPU.PLATFORM", "cpu",
                                 "LOG_PATH", log_path, "NAME", "fit", *opts])
    dist.barrier()
    with open(trainer.metrics_path) as f:
        rows = [json.loads(line) for line in f]
    ckpts = sorted(os.listdir(trainer.ckpt_mgr.directory))
    return ({n: p.detach().clone() for n, p in
             trainer.model.named_parameters()}, rows, ckpts,
            (trainer.mesh.data, trainer.mesh.model))


def tp_runs(rank, world, mcfg, batch, ckpt_one, ckpt_tp, jax_case):
    """Tensor parallelism over a model group of `world` ranks (data 1):
    - "b": one train_step of the tiny model (seed 1) at mcfg's dropout,
      the step's generator seeded 7: metrics, the clipped gradients and
      the updated parameters gathered into the reference layout, and this
      rank's dropout masks of the self-attention weights and of the FFN;
    - "d": the TP checkpoint of that step written to `ckpt_tp` (rank 0
      writes); the one-process checkpoint in `ckpt_one` restored into a
      fresh TP model and AdamW (this rank's shards and moments);
    - "c": one step at dropout 0 from `jax_case`'s weights (the JAX
      package's init through from_jax) and matcher draws, lr 1e-4."""
    from parq_torch.models import build_model
    from parq_torch.models.decoder import DropoutDraws
    from parq_torch.parallel.mesh import make_mesh
    from parq_torch.parallel.tensor_parallel import (full_state_dict,
                                                     gathered, shard_model_)
    from parq_torch.train.checkpoint import CheckpointManager, restore_state
    from parq_torch.train.train_step import make_optimizer, train_step
    mesh = make_mesh(data=1, model=world)
    rows = {k: _t(v) for k, v in batch.items()}
    out = {}

    def sharded(cfg, seed, state=None):
        model = build_model(cfg, seed=seed, device="cpu").train()
        if state is not None:
            model.load_state_dict(state)
        return shard_model_(model, mesh)

    model = sharded(mcfg, 1)
    try:
        model.set_parallel(mesh, True)
        out["sp_refused"] = ""
    except ValueError as e:
        out["sp_refused"] = str(e)
    opt = make_optimizer(model, lr=1e-3)
    m = train_step(model, opt, rows, torch.Generator().manual_seed(7),
                   model_group=mesh.model_group)
    B, L, Q = batch["rgb_img"].shape[0], mcfg.dec_layers, mcfg.num_queries
    drops = DropoutDraws(mcfg.dropout_rate, L, "cpu",
                         torch.Generator().manual_seed(7))
    layer = model.box3d_decoder.parq_module.decoder.layers[0]
    out["b"] = ({k: float(v) for k, v in m.items()},
                gathered(model, {n: p.grad.clone() for n, p in
                                 model.named_parameters()}),
                full_state_dict(model),
                (layer.sa_keep(drops, range(L), B, Q),
                 layer.ffn_keep(drops, range(L), B, Q)))

    CheckpointManager(ckpt_tp, save_top_k=1).save(1, model, opt)
    fresh = sharded(mcfg, 5)
    fresh_opt = make_optimizer(fresh, lr=1e-3)
    restore_state(CheckpointManager(ckpt_one), fresh, fresh_opt)
    out["d"] = ({n: p.detach().clone() for n, p in fresh.named_parameters()},
                {n: {k: v.clone() for k, v in fresh_opt.state[p].items()}
                 for n, p in fresh.named_parameters()})

    jcfg, state, u, lr = jax_case
    model = sharded(jcfg, 0, {k: _t(v) for k, v in state.items()})
    m = train_step(model, make_optimizer(model, lr=lr), rows, None,
                   uniforms=_t(u), model_group=mesh.model_group)
    out["c"] = ({k: float(v) for k, v in m.items()},
                gathered(model, {n: p.grad.clone() for n, p in
                                 model.named_parameters()}),
                full_state_dict(model))
    return out

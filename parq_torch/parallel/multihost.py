"""Multi-process scaffolding over torch.distributed (port of
parq_tpu/parallel/multihost.py).

The reference trains DDP over GPUS × NUM_NODES processes
(ref: train.py:103-110) with a DistributedSampler per rank and rank-0
gating of checkpoint and log writes. Here:

- `initialize_distributed` joins the process group that `torchrun` (or
  any launcher setting RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)
  describes. The backend is chosen explicitly: NCCL on the card, gloo on
  the CPU, or what PARQ_DIST_BACKEND names (gloo for ranks that share one
  card: NCCL refuses two ranks on one GPU). It is logged, and nothing
  switches it on an error.
- `is_main_process` gates log and checkpoint writes.
- `host_shard_indices` is the per-rank strided shard of an epoch order
  (copy of the JAX package's), which `SnippetLoader` applies.
"""
from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def launcher_env() -> Optional[dict]:
    """(rank, world_size, local_rank) from the launcher's environment, or
    None for a single process (no WORLD_SIZE, or WORLD_SIZE 1)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    return {"rank": int(os.environ["RANK"]), "world_size": world,
            "local_rank": int(os.environ.get("LOCAL_RANK", "0"))}


def initialize_distributed(num_nodes: int = 1,
                           device_type: str = "cuda") -> bool:
    """Join the process group the launcher describes (env://). Returns True
    if this process is (now) one rank of several. Idempotent. `num_nodes`
    is TRAINER.NUM_NODES: more than one node needs a launcher."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = launcher_env()
    if env is None:
        if num_nodes > 1:
            raise RuntimeError(
                f"TRAINER.NUM_NODES={num_nodes} needs a launcher: run under "
                "torchrun (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        return False
    backend = os.environ.get("PARQ_DIST_BACKEND") or (
        "nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://",
                            rank=env["rank"], world_size=env["world_size"],
                            timeout=timedelta(seconds=600))
    logger.info("torch.distributed: rank %d of %d, backend %s", env["rank"],
                env["world_size"], backend)
    return True


def rank_device(device: torch.device) -> torch.device:
    """This rank's card: cuda:LOCAL_RANK, modulo the cards visible (ranks
    that share one card run on it together)."""
    if device.type != "cuda":
        return device
    env = launcher_env()
    if env is None:
        return device
    return torch.device("cuda",
                        env["local_rank"] % torch.cuda.device_count())


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """All ranks meet (a no-op for one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def host_shard_indices(order: np.ndarray, process_index: int,
                       process_count: int) -> np.ndarray:
    """Per-host slice of a (shared, identically-seeded) epoch order.

    DistributedSampler semantics: pad by wraparound to a multiple of
    process_count so every host gets the same count, then stride — host i
    takes padded[i::process_count]."""
    if process_count <= 1:
        return order
    n = len(order)
    per = -(-n // process_count)
    total = per * process_count
    pad = total - n
    padded = np.concatenate([order, order[:pad]]) if pad else order
    return padded[process_index::process_count]

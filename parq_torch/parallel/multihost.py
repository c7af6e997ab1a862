"""Per-host shard of an epoch order (copy of
parq_tpu/parallel/multihost.py:host_shard_indices). The port's
multi-process wiring (DDP over NCCL) is still to come (ROADMAP §A8); the
loaders already take (process_index, process_count)."""
from __future__ import annotations

import numpy as np


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

"""The PARQ modified matcher (port of parq_tpu/ops/hungarian.py:
match_single / match_batch).

Exact linear assignment on ``cost = 0.25·L1(ref, center) − 2·prob``, then
every query whose reference point lies within `ratio` (L1) of a target is
also assigned to it, capped at `max_padding` per target by a uniform random
subset; capped-out queries are left out of the classification loss
(`punish_mask`).

The JAX package solves the assignment on the device (a Jonker–Volgenant
loop in `lax`) only to keep the TPU step free of host syncs. Here it runs
on the host with `scipy.optimize.linear_sum_assignment`, on the valid
targets only: one transfer of the (LB, Q, K) costs per step. Both branches
of the JAX matcher are kept: K ≤ Q (targets are the rows) and the
transposed K > Q (queries are the rows; the JAX package gives invalid
target columns a flat cost, which solving over the valid columns alone
matches). The proximity draws are an input: (LB, Q, K) uniforms, or drawn
from a `torch.Generator`, so the tests can feed the JAX draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


class MatchResult(NamedTuple):
    """assign (LB, Q) int64 target per query, −1 if none; is_hungarian
    (LB, Q) bool; punish_mask (LB, Q) bool — queries in the CE loss."""
    assign: torch.Tensor
    is_hungarian: torch.Tensor
    punish_mask: torch.Tensor


def _lap_assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(Q,) target per query from the exact assignment of one pair:
    cost (Q, K), valid (K,) with valid targets first; −1 if unmatched."""
    Q, K = cost.shape
    hung = np.full(Q, -1, np.int64)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return hung
    if K <= Q:   # rows = valid targets, cols = queries
        rows, cols = linear_sum_assignment(cost[:, idx].T)
        hung[cols] = idx[rows]
    else:        # the transposed problem: rows = queries
        rows, cols = linear_sum_assignment(cost[:, idx])
        hung[rows] = idx[cols]
    return hung


@torch.no_grad()
def match_batch(pred_logits: torch.Tensor, coord_pos: torch.Tensor,
                tgt_labels: torch.Tensor, tgt_center: torch.Tensor,
                tgt_valid: torch.Tensor, uniforms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                cost_class: float = 2.0, cost_bbox: float = 0.25,
                ratio: float = 0.2, max_padding: int = 10) -> MatchResult:
    """Match every pair of the (LB,) batch: pred_logits (LB, Q, C+1),
    coord_pos (LB, Q, 3) input reference points, tgt_labels (LB, K) (−1
    pad), tgt_center (LB, K, 3), tgt_valid (LB, K) bool. `uniforms`
    (LB, Q, K) in [0, 1) rank the proximity matches; without them they are
    drawn from `generator`."""
    LB, Q, _ = pred_logits.shape
    K = tgt_labels.shape[1]
    dev = pred_logits.device
    prob = torch.softmax(pred_logits.float(), dim=-1)
    labels = tgt_labels.long().clamp(0, prob.shape[-1] - 1)
    c_class = -torch.gather(prob, 2, labels[:, None, :].expand(LB, Q, K))
    c_bbox = (coord_pos.float()[:, :, None, :]
              - tgt_center.float()[:, None, :, :]).abs().sum(-1)  # (LB,Q,K)
    cost = cost_bbox * c_bbox + cost_class * c_class

    cost_np = cost.cpu().numpy()
    valid_np = tgt_valid.cpu().numpy()
    hung = torch.from_numpy(np.stack([
        _lap_assign(cost_np[i], valid_np[i]) for i in range(LB)])).to(dev)
    is_hungarian = hung >= 0

    inside = (c_bbox < ratio) & tgt_valid[:, None, :]
    if uniforms is None:
        gdev = generator.device if generator is not None else "cpu"
        uniforms = torch.rand((LB, Q, K), generator=generator, device=gdev)
    rnd = torch.where(inside, uniforms.to(dev, torch.float32),
                      torch.full((), float("inf"), device=dev))
    # the cap's k-th smallest draw per target; with fewer than max_padding
    # queries every inside query is selected (the JAX index clamps too)
    kth = torch.sort(rnd, dim=1).values[:, min(max_padding, Q) - 1, :]
    n_inside = inside.sum(dim=1)
    selected = inside & ((n_inside[:, None, :] <= max_padding)
                         | (rnd <= kth[:, None, :]))
    any_sel = selected.any(dim=2)
    prox = torch.where(any_sel, selected.int().argmax(dim=2),
                       torch.full((), -1, device=dev))
    assign = torch.where(is_hungarian, hung, prox)
    punish = ~(inside.any(dim=2) & ~any_sel & ~is_hungarian)

    has_tgt = tgt_valid.any(dim=1, keepdim=True)
    assign = torch.where(has_tgt, assign, torch.full((), -1, device=dev))
    return MatchResult(assign, is_hungarian & has_tgt, punish | ~has_tgt)

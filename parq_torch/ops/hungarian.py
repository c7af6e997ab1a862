"""The PARQ modified matcher (port of parq_tpu/ops/hungarian.py:
match_single / match_batch).

Exact linear assignment on ``cost = 0.25·L1(ref, center) − 2·prob``, then
every query whose reference point lies within `ratio` (L1) of a target is
also assigned to it, capped at `max_padding` per target by a uniform random
subset; capped-out queries are left out of the classification loss
(`punish_mask`).

The assignment runs on the tensors' device, as the JAX package's does:
kernel M1 (`kernels.lap.solve_lap`) on the card, its plain version on the
CPU, both in JAX's f32 arithmetic, so no value of the step goes to the
host. Both branches of the JAX matcher are kept: K ≤ Q (targets are the
rows, invalid target rows get a flat cost and are not searched) and the
transposed K > Q (queries are the rows, invalid target columns get a flat
cost, matches to them are dropped). The proximity draws are an input:
(LB, Q, K) uniforms, or drawn from a `torch.Generator`, so the tests can
feed the JAX draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.lap import solve_lap

FLAT_COST = 1e4     # the cost of an invalid target (hungarian.py:182, :205)


class MatchResult(NamedTuple):
    """assign (LB, Q) int64 target per query, −1 if none; is_hungarian
    (LB, Q) bool; punish_mask (LB, Q) bool — queries in the CE loss."""
    assign: torch.Tensor
    is_hungarian: torch.Tensor
    punish_mask: torch.Tensor


def match_cost(pred_logits: torch.Tensor, coord_pos: torch.Tensor,
               tgt_labels: torch.Tensor, tgt_center: torch.Tensor,
               cost_class: float = 2.0, cost_bbox: float = 0.25):
    """(cost, c_bbox), each (LB, Q, K) f32: ``cost_bbox·L1(ref, center) −
    cost_class·prob[label]`` and the L1 term alone (hungarian.py:171-176)."""
    LB, Q, _ = pred_logits.shape
    K = tgt_labels.shape[1]
    prob = torch.softmax(pred_logits.float(), dim=-1)
    labels = tgt_labels.long().clamp(0, prob.shape[-1] - 1)
    c_class = -torch.gather(prob, 2, labels[:, None, :].expand(LB, Q, K))
    c_bbox = (coord_pos.float()[:, :, None, :]
              - tgt_center.float()[:, None, :, :]).abs().sum(-1)
    return cost_bbox * c_bbox + cost_class * c_class, c_bbox


def lap_problem(cost: torch.Tensor, valid: torch.Tensor):
    """The assignment problems of costs (LB, Q, K) and valid (LB, K), as
    `solve_lap` takes them: (rows (LB, R, C) contiguous f32, n_rows (LB,)
    int32). K ≤ Q: rows = targets, invalid ones flat and not searched;
    K > Q: rows = queries, all searched, invalid target columns flat."""
    LB, Q, K = cost.shape
    if K <= Q:
        rows = torch.where(valid[:, :, None], cost.transpose(1, 2), FLAT_COST)
        n_rows = valid.sum(dim=1, dtype=torch.int32)
    else:
        rows = torch.where(valid[:, None, :], cost, FLAT_COST)
        n_rows = torch.full((LB,), Q, dtype=torch.int32, device=cost.device)
    return rows.contiguous(), n_rows


def _hungarian_assign(cost: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """(LB, Q) target per query from the exact assignment of each pair:
    cost (LB, Q, K), valid (LB, K) with valid targets first; −1 if
    unmatched (hungarian.py:178-212)."""
    LB, Q, K = cost.shape
    dev = cost.device
    col4row = solve_lap(*lap_problem(cost, valid)).long()
    if K <= Q:
        # target rows to query slots; unassigned rows (−1) go to the extra
        # slot Q, which is cut off
        slot = torch.where(col4row >= 0, col4row, Q)
        tgt = torch.where(valid, torch.arange(K, device=dev), -1)
        hung = torch.full((LB, Q + 1), -1, dtype=torch.long, device=dev)
        return hung.scatter_(1, slot, tgt)[:, :Q]
    # query rows to targets; a match to an invalid (flat) target is none
    hit = torch.gather(valid, 1, col4row.clamp(0, K - 1))
    return torch.where((col4row >= 0) & hit, col4row, -1)


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
    cost, c_bbox = match_cost(pred_logits, coord_pos, tgt_labels, tgt_center,
                              cost_class, cost_bbox)
    hung = _hungarian_assign(cost, tgt_valid.bool())
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

"""PARQ set prediction loss (port of parq_tpu/losses/set_loss.py).

Targets arrive padded (B, K, 19) with validity masks; matching runs per
(iteration, sample) pair through `ops.hungarian.match_batch`; the
symmetry-resolved rotation loss is a min over a static (4, 36) table of
rotations about y, computed with the trace identity as one (N, 9) x (9, 144)
product. Per-pair component losses are summed and divided by the number of
pairs that had any match (`valid_bs`), as the reference does. Everything
runs in f32, outside autocast.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import Obb3D, Pose, rotation_matrix_from_ortho6d, roty
from ..ops.hungarian import match_batch

# (4, 36) symmetry angle table: row s = the angles tried for sym class s
# (0 none, 1 two-fold, 2 four-fold, 3 "infinite" ≈ 36)
_SYM_COUNT = (1, 2, 4, 36)
_ANGLES = np.zeros((4, 36), np.float32)
_VALID = np.zeros((4, 36), bool)
for _s, _m in enumerate(_SYM_COUNT):
    for _k in range(_m):
        _ANGLES[_s, _k] = _k * 2.0 * math.pi / _m
        _VALID[_s, _k] = True


class Targets(NamedTuple):
    labels: torch.Tensor         # (B, K) int64, −1 pad
    center: torch.Tensor         # (B, K, 3) in the local frame
    size: torch.Tensor           # (B, K, 3)
    rot: torch.Tensor            # (B, K, 3, 3) local-frame rotation
    valid: torch.Tensor          # (B, K) bool
    sym: torch.Tensor            # (B, K) int64, 0 where unknown
    corners_world: torch.Tensor  # (B, K, 8, 3)


def parse_targets(obbs_padded: Obb3D, T_world_local: Pose,
                  sym: Optional[torch.Tensor] = None) -> Targets:
    """obbs_padded: Obb3D (B, K); T_world_local: Pose (B, 1) or (B,);
    sym: (B, S) padded symmetry ids in box order."""
    if T_world_local.data.dim() == 3:
        T_world_local = Pose(T_world_local.data[:, 0, :])
    valid = obbs_padded.valid_mask()                    # (B, K)
    B, K = valid.shape
    Two = obbs_padded.T_world_object
    T_local_object = Pose(T_world_local.inverse().data[:, None, :]) @ Two
    center = T_local_object.transform(
        obbs_padded.bb3_center_object[..., None, :])[..., 0, :]
    corners_world = Two.transform(obbs_padded.corners_object)
    labels = torch.where(valid, obbs_padded.sem_id[..., 0].long(),
                         torch.full((), -1, device=valid.device))
    sym_k = torch.zeros(B, K, dtype=torch.int64, device=valid.device)
    if sym is not None:
        S = min(sym.shape[1], K)
        sym_k[:, :S] = sym[:, :S].long().clamp(0, 3)
    return Targets(labels=labels, center=center, size=obbs_padded.bb3_size,
                   rot=T_local_object.R, valid=valid, sym=sym_k,
                   corners_world=corners_world)


def rotation_loss_sym(R_pred: torch.Tensor, R_tgt: torch.Tensor,
                      sym: torch.Tensor) -> torch.Tensor:
    """Per-pair symmetry-resolved rotation MSE, (N, 3, 3) x2, (N,) → (N,):
    min over the sym class's angles k of mean((R_pred − R_tgt·R_y(k))²),
    by the trace identity (‖R_tgt·R_k‖ = ‖R_tgt‖)."""
    dev = R_pred.device
    Rk = roty(torch.as_tensor(_ANGLES, device=dev)).reshape(4 * 36, 9)
    N = R_pred.shape[0]
    sq = R_pred.square().sum((-2, -1)) + R_tgt.square().sum((-2, -1))
    M = torch.einsum("nji,njk->nik", R_tgt, R_pred).reshape(N, 9)
    per = (sq[:, None] - 2.0 * (M @ Rk.T)).clamp(min=0.0) / 9.0
    valid = torch.as_tensor(_VALID, device=dev).reshape(-1)
    per = torch.where(valid[None], per, torch.full((), float("inf"),
                                                   device=dev))
    per_sym = per.reshape(N, 4, 36).min(dim=-1).values    # (N, 4)
    return torch.gather(per_sym, 1, sym.long()[:, None])[:, 0]


def set_loss(outputs: Dict[str, torch.Tensor], targets: Targets,
             uniforms: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             loss_weight: Tuple[float, float, float, float] = (5.0, 5.0,
                                                              5.0, 1.0),
             num_semcls: int = 9, bg_cls_weight: float = 0.1
             ) -> Dict[str, torch.Tensor]:
    """outputs: per-iteration stacks (L, B, Q, ...) from the decoder.
    `uniforms` (L·B, Q, K): the matcher's proximity draws (else drawn
    from `generator`). Returns total_loss, its components and valid_bs."""
    with torch.autocast(outputs["pred_logits"].device.type, enabled=False):
        return _set_loss(outputs, targets, uniforms, generator, loss_weight,
                         num_semcls, bg_cls_weight)


def _set_loss(outputs, targets, uniforms, generator, loss_weight,
              num_semcls, bg_cls_weight):
    L, B, Q = outputs["pred_logits"].shape[:3]
    K = targets.labels.shape[1]
    LB = L * B
    flat = {k: outputs[k].float().reshape((LB,) + outputs[k].shape[2:])
            for k in ("pred_logits", "coord_pos", "center_unnormalized",
                      "size_unnormalized", "ortho6d")}
    t = Targets(*(f.repeat((L,) + (1,) * (f.dim() - 1)) for f in targets))
    res = match_batch(flat["pred_logits"], flat["coord_pos"], t.labels,
                      t.center, t.valid, uniforms=uniforms,
                      generator=generator)
    matched = res.assign >= 0
    a = res.assign.clamp(0, K - 1)
    mf = matched.float()
    mcount = mf.sum(dim=1)
    denom = mcount.clamp(min=1.0)

    def pick(x):                                    # (LB, K, ...) → (LB, Q, ...)
        idx = a.view(LB, Q, *([1] * (x.dim() - 2)))
        return torch.gather(x, 1, idx.expand(LB, Q, *x.shape[2:]))

    c_err = (flat["center_unnormalized"] - pick(t.center)).abs().mean(-1)
    s_err = (flat["size_unnormalized"] - pick(t.size)).abs().mean(-1)
    center_loss = (c_err * mf).sum(1) / denom
    size_loss = (s_err * mf).sum(1) / denom

    R_pred = rotation_matrix_from_ortho6d(flat["ortho6d"].reshape(LB * Q, 6))
    r_err = rotation_loss_sym(R_pred, pick(t.rot).reshape(LB * Q, 3, 3),
                              pick(t.sym).reshape(LB * Q)).reshape(LB, Q)
    rot_loss = torch.where(matched, r_err, 0.0).sum(1) / denom

    tgt_cls = torch.where(matched, pick(t.labels),
                          torch.full((), num_semcls, device=a.device))
    class_weight = torch.ones(num_semcls + 1, device=a.device)
    class_weight[num_semcls] = bg_cls_weight
    logp = torch.log_softmax(flat["pred_logits"], dim=-1)
    ce = -torch.gather(logp, 2, tgt_cls[..., None])[..., 0] \
        * class_weight[tgt_cls]
    punish = res.punish_mask.float()
    cat_loss = (ce * punish).sum(1) / punish.sum(1).clamp(min=1.0)

    has_match = mcount > 0
    w = loss_weight
    comp = {"center_loss": center_loss * w[0], "size_loss": size_loss * w[1],
            "rot_loss": rot_loss * w[2], "cat_loss": cat_loss * w[3]}
    valid_bs = has_match.float().sum()
    norm = valid_bs.clamp(min=1.0)
    losses = {k: torch.where(has_match, v, 0.0).sum() / norm
              for k, v in comp.items()}
    losses["total_loss"] = sum(losses.values())
    losses["valid_bs"] = valid_bs
    return losses

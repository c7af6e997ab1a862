"""The comparisons that decide `correct`, and the reference runs they
compare with. Each reading is a number that sound runs keep small; a
cell's limits file (`limits/<cell>.json`) gives each its limit.

Forward outputs (`forward_readings`): output_gap, over the iterations
and the outputs pred_logits, center_unnormalized, size_unnormalized
(on the queries whose most likely class both sides agree on: the size
is the class's mean size scaled), ortho6d and coord_pos (the input
points), the largest ‖program − reference‖ / ‖reference‖, the reference
run along the program's own trajectory: iteration l > 0 starts from the
program's centers of iteration l − 1, so coord_pos checks the program's
step from centers to input points. (Along its own trajectory a float32
run of the program drifts from the float32 reference by 10⁻³ at
iteration 0 and by 10⁻¹ at iteration 3: the recurrence amplifies
round-off from iteration to iteration.)
Detections (`parse_mismatch`): the queries whose kept flag, track-box
flag, label, score or corners in the program's post-processing differ
from the reference's post-processing of the same outputs (its
suppression run on the program's decoded local corners, see
`reference.parse`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import model as ref

OUTPUT_KEYS = ("pred_logits", "center_unnormalized", "size_unnormalized",
               "ortho6d", "coord_pos")


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mean_size(cfg: dict, root) -> torch.Tensor:
    return ref.load_mean_size(str(root / cfg["mean_size_path"]),
                              cfg["num_semcls"], cfg["class_names"])


@torch.no_grad()
def reference_forward(cfg: dict, root, w, batch: dict, device,
                      precision: str = "f32", centers=None
                      ) -> Dict[str, torch.Tensor]:
    """The reference's eval forward of `batch`, one sample at a time;
    with `centers` (L, B, Q, 3), iteration l > 0 starts from those
    centers of iteration l − 1 (another run's)."""
    no_tf32()
    P = ref.Precision(precision)
    ms = mean_size(cfg, root).to(device)
    outs = []
    for b in range(batch["rgb_img"].shape[0]):
        one = {k: v[b:b + 1].to(device).float() for k, v in batch.items()}
        c = None if centers is None else \
            centers[:, b:b + 1].to(device).float()
        outs.append(ref.forward(w, cfg, one, ms, P, centers=c))
    return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}


def forward_readings(cfg: dict, root, w, batch: dict, out, device):
    """output_gap of one batch's forward outputs `out`, against the
    reference run along the same trajectory: iteration l > 0 starts from
    `out`'s centers of iteration l − 1, so the reference's input points
    (`coord_pos`) check the program's recurrence step too."""
    r = reference_forward(cfg, root, w, batch, device,
                          centers=out["center_unnormalized"])
    return {"output_gap": output_gap(out, r)}, r


def output_gaps(prog: Dict[str, torch.Tensor],
                refr: Dict[str, torch.Tensor]) -> Dict[str, List[float]]:
    """‖program − reference‖ / ‖reference‖ per output and iteration."""
    out = {}
    same = (prog["sem_cls_prob"].to(refr["sem_cls_prob"].device).argmax(-1)
            == refr["sem_cls_prob"].argmax(-1))[..., None]
    for k in OUTPUT_KEYS:
        p, r = prog[k].float().to(refr[k].device), refr[k].float()
        if k == "size_unnormalized":   # scaled by the argmax class's size
            p, r = p * same, r * same
        out[k] = [float((p[l] - r[l]).norm() / r[l].norm())
                  for l in range(r.shape[0])]
    return out


def output_gap(prog: Dict[str, torch.Tensor],
               refr: Dict[str, torch.Tensor]) -> float:
    return max(max(v) for v in output_gaps(prog, refr).values())


def parse_mismatch(prog_host: Dict[str, np.ndarray],
                   mine: Dict[str, np.ndarray]) -> int:
    """Queries whose detection differs between the program's
    post-processing (`prog_host`) and the reference's (`mine`), over all
    queries: kept flag, track-box flag, label, score (1e-5) or corners
    (1e-4 m)."""
    bad = prog_host["pred_mask"] != mine["pred_mask"]
    bad |= prog_host["valid"] != mine["valid"]
    bad |= prog_host["labels"] != mine["labels"]
    bad |= np.abs(prog_host["scores"] - mine["scores"]) > 1e-5
    bad |= np.abs(prog_host["corners_world"] - mine["corners_world"]).max(
        axis=(-1, -2)) > 1e-4
    return int(bad.sum())


def host_outputs(out: Dict[str, torch.Tensor], it: int = -1
                 ) -> Dict[str, np.ndarray]:
    """One iteration's outputs as float numpy arrays."""
    return {k: out[k][it].float().cpu().numpy() for k in
            ("sem_cls_prob", "center_unnormalized", "size_unnormalized",
             "ortho6d")}

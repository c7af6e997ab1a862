"""Parse scan2cad full_annotations.json into per-scene oriented-box pickles
(the port's twin of scripts/scannet_preprocessing/parse_scan2cad.py: the
same functions, flags, stdout lines and pickles, byte for byte).

Offline step 1, faithful to the reference's output format
(ref: scripts/scannet_preprocessing/parse_scan2cad.py:12-97): every scene
pickle holds ``{id_scan, n_aligned_models, aligned_models: [...]}`` where
each model record carries the CAD category id, the box extents centered at
the origin (CAD bbox half-extents x scale x 2), the scan-frame pose
``T_so = T_scan_world @ T_world_object @ offset(center)`` (object pose
without scale; the CAD center offset folded in unscaled, as the reference
does), the scan-frame corners, and the symmetry tag. Models with any scale
axis < 1e-3 are skipped. Also writes the combined
``scan2cad_bbox_3d_anno.pkl`` list.

Host numpy only (no device): it reads one JSON file.

Usage:
    python -m parq_torch.tools.scannet_preprocessing.parse_scan2cad \
        --scan2cad full_annotations.json --out anno_dir
"""
import argparse
import json
import os
import pickle

import numpy as np

from .processing_utils import make_corners, tqs_to_matrix


def parse_scene(scene_anno):
    trs = scene_anno["trs"]
    # scene alignment keeps its scale; object poses drop theirs (ref: :35-60)
    T_world_scan = tqs_to_matrix(trs["translation"], trs["rotation"],
                                 trs["scale"])
    T_scan_world = np.linalg.inv(T_world_scan)

    models = []
    for i, model in enumerate(scene_anno["aligned_models"]):
        mtrs = model["trs"]
        s = np.asarray(mtrs["scale"], np.float64)
        if s.min() < 1e-3:
            continue  # degenerate scale (ref: :56-57)
        scales = np.asarray(model["bbox"], np.float64) * s * 2
        T_wo = tqs_to_matrix(mtrs["translation"], mtrs["rotation"],
                             np.ones_like(s))
        offset = np.eye(4)
        offset[:3, 3] = model["center"]
        T_so = T_scan_world @ T_wo @ offset
        bboxes = np.stack([-scales[0] / 2, scales[0] / 2,
                           -scales[1] / 2, scales[1] / 2,
                           -scales[2] / 2, scales[2] / 2])
        corners = make_corners(bboxes)
        corners_scan = corners @ T_so[:3, :3].T + T_so[:3, 3]
        models.append({
            "id_obj": i,
            "catid_cad": model["catid_cad"],
            "id_cad": model.get("id_cad"),
            "bboxes": bboxes,
            "bbox_corners": corners_scan,
            "T_so": T_so,
            "sym": model.get("sym", "__SYM_NONE"),
        })
    return {
        "id_scan": scene_anno["id_scan"],
        "n_aligned_models": scene_anno.get("n_aligned_models", len(models)),
        "aligned_models": models,
    }


def generate_anno(scan2cad_path: str, out_dir: str):
    with open(scan2cad_path) as f:
        annotations = json.load(f)
    os.makedirs(out_dir, exist_ok=True)

    full_list = []
    for scene_anno in annotations:
        anno_dict = parse_scene(scene_anno)
        with open(os.path.join(out_dir, f"{anno_dict['id_scan']}.pkl"),
                  "wb") as f:
            pickle.dump(anno_dict, f)
        full_list.append(anno_dict)
        print(f"{anno_dict['id_scan']}: "
              f"{len(anno_dict['aligned_models'])} boxes")

    with open(os.path.join(out_dir, "scan2cad_bbox_3d_anno.pkl"),
              "wb") as f:
        pickle.dump(full_list, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan2cad", required=True,
                    help="path to full_annotations.json")
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args(argv)
    generate_anno(args.scan2cad, args.out)


if __name__ == "__main__":
    main()

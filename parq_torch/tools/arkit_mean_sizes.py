"""Compute a per-class mean-size table from ARKitScenes 3DOD annotations
(the port's twin of scripts/arkit_mean_sizes.py; the same flags, output,
warnings and exit message).

The ScanNet pipeline ships data/average_scan2cad.txt; ARKitScenes has no
equivalent, so this derives one from the training annotations:

    python -m parq_torch.tools.arkit_mean_sizes \
        --data ./data/arkitscenes/3dod/Training \
        --out ./data/arkit_mean_sizes.txt

then set MODEL.DECODER.MEAN_SIZE_PATH to the output in
configs/arkitscenes.yaml. Rows are `name: [x y z]`, the format the table
parser reads, one per name of `parq_torch.data.arkitscenes.ARKIT_CLASSES`
in order; a class with no annotation gets a unit row and a warning. Box
dims are the annotation's `axesLengths`, averaged per class.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..data.arkitscenes import ARKIT_CLASS_TO_ID, ARKIT_CLASSES


def collect_sizes(data_path: str):
    """(sums (K, 3), counts (K,), annotation files read) over every
    ``{vid}/{vid}_3dod_annotation.json`` under `data_path`."""
    sums = np.zeros((len(ARKIT_CLASSES), 3), np.float64)
    counts = np.zeros(len(ARKIT_CLASSES), np.int64)
    n_files = 0
    for vid in sorted(os.listdir(data_path)):
        anno_path = os.path.join(data_path, vid, f"{vid}_3dod_annotation.json")
        if not os.path.isfile(anno_path):
            continue
        n_files += 1
        with open(anno_path) as f:
            anno = json.load(f)
        for item in anno.get("data", []):
            cid = ARKIT_CLASS_TO_ID.get(item.get("label", ""))
            if cid is None:
                continue
            sums[cid] += np.asarray(
                item["segments"]["obbAligned"]["axesLengths"], np.float64)
            counts[cid] += 1
    return sums, counts, n_files


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="ARKitScenes 3DOD split root (e.g. .../Training)")
    ap.add_argument("--out", default="./data/arkit_mean_sizes.txt")
    args = ap.parse_args(argv)

    sums, counts, n_files = collect_sizes(args.data)
    if n_files == 0:
        raise SystemExit(f"no *_3dod_annotation.json found under {args.data}")

    lines = []
    for cid, name in enumerate(ARKIT_CLASSES):
        if counts[cid] == 0:
            print(f"WARNING: class '{name}' has no annotations; "
                  "emitting unit size", file=sys.stderr)
            mean = np.ones(3)
        else:
            mean = sums[cid] / counts[cid]
        lines.append(f"{name}: [{mean[0]:.8f} {mean[1]:.8f} {mean[2]:.8f}] \n")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.writelines(lines)
    print(f"wrote {len(lines)} class rows ({int(counts.sum())} boxes from "
          f"{n_files} scenes) to {args.out}")


if __name__ == "__main__":
    main()

"""Generate ScanNet snippet annotations (offline step 2; the port's twin of
scripts/scannet_preprocessing/generate_scannet_anno_snippet.py: the same
stages, functions, flags, stdout lines and artifacts, plus `--device`).

  stage 1 (``--stage snippets``, ref save_snippet_pkl:139-263): per scene,
  read every ``frame-{:06d}.pose.txt``, run view selection (train:
  overlap-shifted windows ×10 over raw frame ids; val: coupled
  non-overlapping windows; plus w1 / allframes), compute per-snippet
  per-object visibility — max over frames of depth-point-in-box counts and
  of FOV truncation ratios — and write ``image_anno_{scene}.pkl``.

  stage 2 (``--stage roidb``, ref get_roidb:266-366): read the image_anno
  pickles, map catids → RayTran class ids, drop objects with difficulty
  ≥ 3, drop snippets with no valid object, and write
  ``scene_anno/{scene}.pkl`` + ``scannet_{split}_gt_roidb.pkl``.

The pickles hold the JAX side's values and dtypes (int64 counts, float64
ratios and poses, float32 intrinsics), so either package's loader reads
either toolchain's output.

Where the JAX side computes each snippet's frames one by one with PIL and
numpy, stage 1 here takes a scene's distinct frames once: a pool of
``--workers`` threads reads their depth maps (P5 or PNG, without PIL) in
chunks of `CHUNK_FRAMES`; each chunk is uploaded once, its depth
backprojection, point-in-box counts and FOV ratios run on ``--device`` in
float64, and its results come back once (one sync a chunk). A snippet's
lists are then the max over its frames, the numbers the per-snippet
recomputation gives.

Device: CUDA unless ``--device cpu``; without a GPU the default raises.
On the card, scenes run one after another in this process: the JAX side's
multiprocessing pool over scenes cannot fork once CUDA has started. With
``--device cpu`` and ``--workers`` > 1 scenes go to a pool of spawned
processes, as on the JAX side.

Usage:
    python -m parq_torch.tools.scannet_preprocessing.generate_scannet_anno_snippet \\
        --scans scans --anno anno_dir --out out_dir --split train [--device cpu]

Expected raw layout per scene (ScanNet .sens exports):
  {scans}/{scene}/pose/frame-{:06d}.pose.txt    4x4 world_from_camera
  {scans}/{scene}/intrinsic/intrinsic_color.txt + intrinsic_depth.txt (4x4)
  {scans}/{scene}/color/frame-{:06d}.color.jpg
  {scans}/{scene}/depth/frame-{:06d}.depth.pgm  uint16 mm
  {anno}/{scene}.pkl                            from parse_scan2cad
"""
import argparse
import glob
import multiprocessing as mp
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import resolve_device
from .image_io import depth_meters, jpeg_size, read_depth_samples
from .processing_utils import (catids_to_labels, depth_to_points,
                               fov_truncation_ratio, get_level,
                               points_inside_corners, view_selection)

CHUNK_FRAMES = 16         # depth maps read, uploaded and counted together
NO_DEPTH_COUNT = 10 ** 6  # a frame without depth: every box counts visible


def read_scene_poses(scene_dir):
    """All finite frame poses, id-ordered (ref: worker_thread:106-126 —
    the reference indexes poses by color-frame count; non-finite poses are
    skipped)."""
    pose_dir = os.path.join(scene_dir, "pose")
    poses = {}
    for f in sorted(os.listdir(pose_dir)):
        if not f.endswith(".txt"):
            continue
        fid = int(f.replace("frame-", "").split(".")[0])
        T = np.loadtxt(os.path.join(pose_dir, f)).reshape(4, 4)
        if np.all(np.isfinite(T)):
            poses[fid] = T
    return dict(sorted(poses.items()))


def _frame_file(scene_dir, sub, fid, suffix):
    return os.path.join(scene_dir, sub, f"frame-{fid:06d}.{suffix}")


def _depth_file(scene_dir, fid):
    """The frame's depth export (`.depth.pgm`, else `{fid}.png`), or None."""
    dpath = _frame_file(scene_dir, "depth", fid, "depth.pgm")
    if not os.path.exists(dpath):
        dpath = os.path.join(scene_dir, "depth", f"{fid}.png")
    return dpath if os.path.exists(dpath) else None


def load_scene(scans_dir, anno_dir, scene, variant, window,
               image_shape=None):
    """Stage 1's inputs for one scene: a dict of its directory, aligned
    models, poses, snippets, intrinsics, image shape and scan-frame box
    corners; None where the JAX side skips the scene."""
    scene_dir = os.path.join(scans_dir, scene)
    anno_path = os.path.join(anno_dir, f"{scene}.pkl")
    if not os.path.exists(anno_path):
        return None  # no oriented boxes for this scene (ref: :160-166)
    with open(anno_path, "rb") as f:
        scene_anno = pickle.load(f)
    aligned = scene_anno["aligned_models"]
    if not aligned:
        return None

    poses = read_scene_poses(scene_dir)
    if not poses:
        return None
    snippets = view_selection(poses, window=window, variant=variant)

    def intr(name):
        p = os.path.join(scene_dir, "intrinsic", name)
        return np.loadtxt(p).astype(np.float32) if os.path.exists(p) \
            else np.eye(4, dtype=np.float32)

    if image_shape is None:
        # reference reads the first color jpg of the first snippet for the
        # image shape (ref: :190-199); fall back to ScanNet's 968x1296
        shape = (968, 1296)
        for frames in snippets[:1]:
            cpath = _frame_file(scene_dir, "color", frames[0], "color.jpg")
            if os.path.exists(cpath):
                shape = jpeg_size(cpath)
        image_shape = shape

    return {
        "scene": scene, "scene_dir": scene_dir, "aligned": aligned,
        "poses": poses, "snippets": snippets,
        "intr_depth": intr("intrinsic_depth.txt"),
        "intr_color": intr("intrinsic_color.txt"),
        "image_shape": image_shape,
        "corners_scan": np.stack([m["bbox_corners"] for m in aligned]),
    }


def camera_corners(ctx, fids):
    """(F, K, 8, 3) float64 box corners in each frame's camera, on the host
    as the JAX side computes them per frame."""
    corners_scan = ctx["corners_scan"]
    K = corners_scan.shape[0]
    hom_corners = np.concatenate([corners_scan, np.ones((K, 8, 1))], -1)
    return np.stack([(hom_corners @ np.linalg.inv(ctx["poses"][fid]).T)
                     [..., :3] for fid in fids])


def chunk_visibility(depth, corners, ctx):
    """One chunk on the device: depth (F, H, W) float32 meters or None,
    corners (F, K, 8, 3) float64 → (counts (F, K) int64 or None, ratios
    (F, K) float64)."""
    ratios = fov_truncation_ratio(corners, ctx["image_shape"],
                                  ctx["intr_color"])
    if depth is None:
        return None, ratios
    points, valid = depth_to_points(depth, ctx["intr_depth"])
    return points_inside_corners(corners, points, valid), ratios


def read_depth_chunk(paths, pool, pin=False):
    """The depth maps of `paths` (None: no file) in meters, (F, H, W)
    float32 with zeros for a missing frame, in host memory (pinned when
    `pin`); None when no frame has one. The threads of `pool` read the
    files, then write their meters straight into the tensor."""
    samples = list(pool.map(
        lambda p: None if p is None else read_depth_samples(p), paths))
    shapes = {s.shape for s in samples if s is not None}
    if not shapes:
        return None
    if len(shapes) > 1:
        raise ValueError(f"depth maps of one scene differ in shape: "
                         f"{sorted(shapes)}")
    out = torch.empty((len(samples), *shapes.pop()), dtype=torch.float32,
                      pin_memory=pin)
    view = out.numpy()

    def meters(i):
        if samples[i] is None:
            view[i] = 0.0
        else:
            depth_meters(samples[i], out=view[i])

    list(pool.map(meters, range(len(samples))))
    return out


def frame_visibility(ctx, fids, device, workers=1, use_depth=True):
    """Counts (F, K) int64 and ratios (F, K) float64 of the frames `fids`,
    and which of them had a depth map. Chunks of `CHUNK_FRAMES`: the
    threads read chunk c + 1 while the device works on chunk c; every
    upload and readback is asynchronous (pinned host memory on CUDA) and
    the host waits once a chunk, for its results."""
    device = torch.device(device)
    F, K = len(fids), len(ctx["aligned"])
    counts = np.full((F, K), NO_DEPTH_COUNT, np.int64)
    ratios = np.empty((F, K), np.float64)
    paths = [_depth_file(ctx["scene_dir"], f) if use_depth else None
             for f in fids]
    found = np.array([p is not None for p in paths], bool)
    corners = camera_corners(ctx, fids) if F else None
    pin = device.type == "cuda"
    chunk = CHUNK_FRAMES
    starts = list(range(0, F, chunk))

    def host(c):
        sel = slice(starts[c], starts[c] + chunk)
        corner = torch.from_numpy(corners[sel])
        return (read_depth_chunk(paths[sel], pool, pin),
                corner.pin_memory() if pin else corner)

    with ThreadPoolExecutor(max(1, workers)) as pool:
        staged = host(0) if starts else None
        for c, s in enumerate(starts):
            depth, corner = (None if a is None else
                             a.to(device, non_blocking=True) for a in staged)
            cnt, rat = chunk_visibility(depth, corner, ctx)
            out = [t.to("cpu", non_blocking=True) for t in (rat, cnt)
                   if t is not None]
            if c + 1 < len(starts):
                staged = host(c + 1)     # host reads overlap the device
            if pin:
                torch.cuda.current_stream(device).synchronize()
            n = out[0].shape[0]
            ratios[s:s + n] = out[0].numpy()
            if cnt is not None:
                counts[s:s + n] = np.where(found[s:s + n, None],
                                           out[1].numpy(), NO_DEPTH_COUNT)
    return counts, ratios, found


def snippet_records(ctx, snippets, use_depth=True, device="cpu", workers=1):
    """The image_anno records of `snippets` (lists of frame ids of the
    scene `ctx`): each distinct frame computed once, each snippet's lists
    the max over its frames; a WARNING line for each frame without depth,
    in the order the JAX side prints them."""
    fids = sorted({fid for frames in snippets for fid in frames})
    counts, ratios, found = frame_visibility(ctx, fids, device, workers,
                                             use_depth)
    row = {fid: i for i, fid in enumerate(fids)}
    records = []
    for sid, frames in enumerate(snippets):
        for fid in frames:
            if use_depth and not found[row[fid]]:
                # pose exists but depth export is missing for this frame
                # (train-split overlap windows only require the pose):
                # assume visible rather than aborting the whole run
                print(f"WARNING {ctx['scene']}: no depth for frame {fid}; "
                      "assuming objects visible")
        rows = [row[fid] for fid in frames]
        # per-object visibility = BEST frame in the snippet (ref: :243-248)
        records.append({
            "snippet_id": sid,
            "image_ids": list(frames),
            "intrinsic": [np.copy(ctx["intr_color"]) for _ in frames],
            "T_scan_camera": [ctx["poses"][fid] for fid in frames],
            "point_cloud_num_list": np.max(counts[rows], axis=0),
            "truncation_ratio_list": np.max(ratios[rows], axis=0),
        })
    return records


def process_scene(scans_dir, anno_dir, out_dir, scene, variant, window,
                  use_depth=True, image_shape=None, device=None, workers=1):
    """Stage 1 for one scene → image_anno_{scene}.pkl
    (ref: save_snippet_pkl, generate_scannet_anno_snippet.py:139-263)."""
    device = resolve_device(device)
    ctx = load_scene(scans_dir, anno_dir, scene, variant, window,
                     image_shape)
    if ctx is None:
        return None
    aligned = ctx["aligned"]
    roidb_scene = {
        "scene_name": scene,
        "bboxes": [m["bboxes"] for m in aligned],
        "sym": [m["sym"] for m in aligned],
        "T_scan_object": [m["T_so"] for m in aligned],
        "labels": [m["catid_cad"] for m in aligned],
        "snippets": snippet_records(ctx, ctx["snippets"], use_depth, device,
                                    workers),
    }
    with open(os.path.join(out_dir, f"image_anno_{scene}.pkl"), "wb") as f:
        pickle.dump(roidb_scene, f)
    return scene


def get_roidb(out_dir, split, scene_filter=None):
    """Stage 2: difficulty-filtered roidb + per-scene annotation pickles
    (ref: get_roidb, generate_scannet_anno_snippet.py:266-366)."""
    scene_anno_path = os.path.join(out_dir, "scene_anno")
    os.makedirs(scene_anno_path, exist_ok=True)
    item_list = []
    for path in sorted(glob.glob(os.path.join(out_dir, "image_anno*"))):
        with open(path, "rb") as f:
            roidb_scene = pickle.load(f)
        scene_name = roidb_scene["scene_name"]
        if scene_filter is not None and scene_name not in scene_filter:
            continue
        ids = catids_to_labels(roidb_scene["labels"])
        bboxes = roidb_scene["bboxes"]
        T_scan_object = roidb_scene["T_scan_object"]
        sym = roidb_scene["sym"]

        item_one_scene = {}
        for snip in roidb_scene["snippets"]:
            pc_nums = snip["point_cloud_num_list"]
            ratios = snip["truncation_ratio_list"]
            valid = [i for i in range(len(bboxes))
                     if pc_nums is None
                     or get_level(pc_nums[i], ratios[i]) < 3]
            if not valid:
                continue  # snippet with no visible object dropped (ref:
                # :332-334)
            item_list.append({"scene_name": scene_name,
                              "snippet_id": snip["snippet_id"]})
            item_one_scene[snip["snippet_id"]] = {
                "image_ids": snip["image_ids"],
                "T_scan_camera": snip["T_scan_camera"],
                "intrinsic": snip["intrinsic"],
                "annotations": {
                    "label": [ids[i] for i in valid],
                    "bboxes": [bboxes[i] for i in valid],
                    "sym": [sym[i] for i in valid],
                    "T_scan_object": [T_scan_object[i] for i in valid],
                },
            }
        with open(os.path.join(scene_anno_path, f"{scene_name}.pkl"),
                  "wb") as f:
            pickle.dump(item_one_scene, f)

    roidb_file = os.path.join(out_dir, f"scannet_{split}_gt_roidb.pkl")
    with open(roidb_file, "wb") as f:
        pickle.dump(item_list, f)
    print(f"wrote {len(item_list)} snippets to {roidb_file}")
    return item_list


def _cpu_worker_init(workers):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


def _cpu_worker(args):
    return process_scene(*args, device="cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", required=True, help="ScanNet scans directory")
    ap.add_argument("--anno", required=True,
                    help="parse_scan2cad output directory")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--stage", default="all",
                    choices=["all", "snippets", "roidb"])
    ap.add_argument("--variant", default=None,
                    choices=[None, "overlap", "nonoverlap", "w1",
                             "allframes"])
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--workers", type=int, default=os.cpu_count(),
                    help="depth-reading threads; with --device cpu, "
                    "processes over scenes")
    ap.add_argument("--no-depth", action="store_true",
                    help="skip depth-based difficulty (all boxes kept)")
    ap.add_argument("--scene-list", default=None,
                    help="file with one scene id per line (default: all)")
    ap.add_argument("--device", default=None,
                    help="device of the per-frame geometry (default cuda)")
    args = ap.parse_args(argv)

    variant = args.variant or ("overlap" if args.split == "train"
                               else "nonoverlap")
    if args.scene_list:
        with open(args.scene_list) as f:
            scenes = [ln.strip() for ln in f if ln.strip()]
    else:
        scenes = sorted(os.listdir(args.scans))

    os.makedirs(args.out, exist_ok=True)
    if args.stage in ("all", "snippets"):
        device = resolve_device(args.device)
        work = [(args.scans, args.anno, args.out, s, variant, args.window,
                 not args.no_depth) for s in scenes]
        if device.type == "cpu" and args.workers > 1:
            with mp.get_context("spawn").Pool(
                    args.workers, _cpu_worker_init, (args.workers,)) as pool:
                done = pool.map(_cpu_worker, work)
        else:
            done = [process_scene(*w, device=device, workers=args.workers)
                    for w in work]
        print(f"stage snippets: {sum(d is not None for d in done)}/"
              f"{len(scenes)} scenes")
    if args.stage in ("all", "roidb"):
        get_roidb(args.out, args.split,
                  scene_filter=set(scenes) if args.scene_list else None)


if __name__ == "__main__":
    main()

"""Evaluate PARQ on the card: the port's twin of eval.py.

    python -m parq_torch.cli.eval --cfg configs/eval.yaml \
        [--CHECKPOINT_PATH ckpt] [KEY VALUE ...]

Prints each snippet's latency, then every metric as `key value`: per-class
and mean F1, accuracy and recall at IoU 0.25/0.5/0.7, total_loss and
mean_latency_s. CHECKPOINT_PATH loads strictly: the port's checkpoints and
state_dicts in the reference layout (parq_release.ckpt's; with SHARE_WEIGHTS
False such a file fills iteration 0 only, so a strict load of it fails, as
in eval.py); without it the weights are random from SEED.
`DATAMODULE.DATA_PATH synthetic` evaluates 8 synthetic snippets of
NUM_FRAMES_PER_SNIPPET views (eval.py's always have 3). It runs on CUDA and raises without a GPU unless
TPU.PLATFORM (or env PARQ_PLATFORM) is "cpu". Under torchrun (RANK,
WORLD_SIZE, LOCAL_RANK) every rank evaluates the whole set on its
cuda:LOCAL_RANK, the model group sharding the memory tokens under
TPU.SEQ_PARALLEL, and rank 0 prints the metrics.

`--DEMO` evaluates the ARKit demo fragments (DemoDataset: DATA_PATH and
VAL_ANNOTATION_PATH name the images and fragments.pkl; PIL opens the
JPEGs). With MODEL.DECODER.FOR_VIS True (configs/demo.yaml sets it) every
snippet's wireframe overlay is written to
``demo_vis/{scene}_{snippet}_rgb_imgwithbox.png``, as eval.py does; on
synthetic snippets too.
"""
from __future__ import annotations

import argparse
import faulthandler
import logging

from ..config import get_cfg, update_config


def main(argv=None):
    """Returns the metrics it prints."""
    faulthandler.enable(all_threads=True)
    parser = argparse.ArgumentParser(description="PARQ eval on the card")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--CHECKPOINT_PATH", type=str, default=None)
    parser.add_argument("--DEMO", nargs="?", const=True, default=False,
                        type=lambda s: str(s).lower() in
                        ("1", "true", "yes", "y"))
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = get_cfg()
    update_config(cfg, args)
    cfg.defrost()
    if args.CHECKPOINT_PATH:
        cfg.CHECKPOINT_PATH = args.CHECKPOINT_PATH
    if args.DEMO:
        cfg.DEMO = True
    cfg.freeze()
    logging.basicConfig(level=logging.INFO, force=True)

    from ..config import platform_device
    from ..data import (DemoDataset, ScanNetDataset, SnippetLoader,
                        SyntheticDataset)
    from ..parallel.multihost import initialize_distributed, is_main_process
    from ..train.checkpoint import load_pretrained
    from ..train.loop import Trainer
    initialize_distributed(int(cfg.TRAINER.NUM_NODES),
                           platform_device(cfg))
    trainer = Trainer(cfg)
    dm = cfg.DATAMODULE
    size = tuple(cfg.TPU.IMAGE_SIZE)
    if cfg.DEMO:
        ds = DemoDataset(dm.DATA_PATH, dm.VAL_ANNOTATION_PATH,
                         num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
                         image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED)
    elif dm.DATA_PATH == "synthetic":
        ds = SyntheticDataset(num_snippets=8, image_size=size, seed=1000,
                              num_views=int(dm.NUM_FRAMES_PER_SNIPPET))
    else:
        ds = ScanNetDataset(dm.DATA_PATH, dm.VAL_ANNOTATION_PATH,
                            num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
                            image_size=size,
                            gravity_aligned=dm.GRAVITY_ALIGNED)
    loader = SnippetLoader(ds, dm.BATCH_SIZE, shuffle=False, drop_last=False)
    trainer.setup_state(steps_per_epoch=max(len(loader), 1))
    if cfg.CHECKPOINT_PATH:
        # the model's layout follows SHARE_WEIGHTS (eval.py:70 passes it to
        # the converter): an unshared model wants every iteration's keys
        load_pretrained(trainer.model, cfg.CHECKPOINT_PATH, strict=True)
        logging.info("loaded checkpoint %s", cfg.CHECKPOINT_PATH)
    for_vis = bool(cfg.MODEL.DECODER.FOR_VIS)
    metrics = trainer.validate(loader,
                               limit_batches=cfg.TRAINER.LIMIT_VAL_BATCHES,
                               verbose=True, timing=True, for_vis=for_vis,
                               vis_dir="demo_vis" if for_vis else None)
    if is_main_process():
        for key, value in metrics.items():
            print(key, value, flush=True)
    return metrics


if __name__ == "__main__":
    main()

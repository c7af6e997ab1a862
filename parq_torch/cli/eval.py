"""Evaluate PARQ on the card: the port's twin of eval.py.

    python -m parq_torch.cli.eval --cfg configs/eval.yaml \
        [--CHECKPOINT_PATH ckpt] [KEY VALUE ...]

Prints each snippet's latency, then every metric as `key value`: per-class
and mean F1, accuracy and recall at IoU 0.25/0.5/0.7, total_loss and
mean_latency_s. CHECKPOINT_PATH loads strictly: the port's checkpoints and
state_dicts in the reference layout (parq_release.ckpt's); without it the
weights are random from SEED. `DATAMODULE.DATA_PATH synthetic` evaluates 8
synthetic snippets. It runs on CUDA and raises without a GPU unless
TPU.PLATFORM (or env PARQ_PLATFORM) is "cpu".
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

    from ..data import ScanNetDataset, SnippetLoader, SyntheticDataset
    from ..train.checkpoint import load_pretrained
    from ..train.loop import Trainer
    trainer = Trainer(cfg)              # rejects DEMO until vis is ported
    dm = cfg.DATAMODULE
    size = tuple(cfg.TPU.IMAGE_SIZE)
    if dm.DATA_PATH == "synthetic":
        ds = SyntheticDataset(num_snippets=8, image_size=size, seed=1000)
    else:
        ds = ScanNetDataset(dm.DATA_PATH, dm.VAL_ANNOTATION_PATH,
                            num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
                            image_size=size,
                            gravity_aligned=dm.GRAVITY_ALIGNED)
    loader = SnippetLoader(ds, dm.BATCH_SIZE, shuffle=False, drop_last=False)
    trainer.setup_state(steps_per_epoch=max(len(loader), 1))
    if cfg.CHECKPOINT_PATH:
        load_pretrained(trainer.model, cfg.CHECKPOINT_PATH, strict=True)
        logging.info("loaded checkpoint %s", cfg.CHECKPOINT_PATH)
    metrics = trainer.validate(loader,
                               limit_batches=cfg.TRAINER.LIMIT_VAL_BATCHES,
                               verbose=True, timing=True)
    for key, value in metrics.items():
        print(key, value, flush=True)
    return metrics


if __name__ == "__main__":
    main()

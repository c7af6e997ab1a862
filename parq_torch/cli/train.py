"""Train PARQ on the card: the port's twin of train.py.

    python -m parq_torch.cli.train --cfg configs/train.yaml [KEY VALUE ...]
    python -m parq_torch.cli.train --cfg configs/smoke.yaml TPU.PLATFORM cpu

Epochs over the dataset DATAMODULE names (`DATA_PATH synthetic` for the
built-in synthetic snippets), validation every VAL_CHECK_INTERVAL of an
epoch with F1 model selection, top-k checkpoints and resume under
LOG_PATH/NAME, then a final validation on the best checkpoint. It runs on
CUDA and raises without a GPU unless TPU.PLATFORM (or env PARQ_PLATFORM)
is "cpu".
"""
from __future__ import annotations

import argparse
import logging

from ..config import get_cfg, update_config


def build_loaders(cfg):
    """(train, val) SnippetLoaders for DATAMODULE, as train.py builds them:
    NUM_WORKERS ≤ 1 decodes in a prefetch thread, more in that many worker
    processes; one process, so no sharding."""
    from ..data import ScanNetDataset, SnippetLoader
    dm = cfg.DATAMODULE
    size = tuple(cfg.TPU.IMAGE_SIZE)
    workers = int(dm.get("NUM_WORKERS", 1))
    host = dict(num_workers=0 if workers <= 1 else workers)
    if dm.DATASET == "arkitscenes":
        from ..data.arkitscenes import ARKitScenesDataset
        train_ds = ARKitScenesDataset(
            dm.DATA_PATH, num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
            image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED)
        val_ds = ARKitScenesDataset(
            dm.VAL_ANNOTATION_PATH or dm.DATA_PATH,
            num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
            image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED)
        return (SnippetLoader(train_ds, dm.BATCH_SIZE, shuffle=dm.SHUFFLE,
                              seed=cfg.SEED, **host),
                SnippetLoader(val_ds, dm.BATCH_SIZE, shuffle=False,
                              drop_last=False, seed=cfg.SEED, **host))
    if dm.DATA_PATH == "synthetic" or dm.DATASET == "synthetic":
        from ..data import SyntheticDataset
        train_ds = SyntheticDataset(
            num_snippets=dm.get("SYNTHETIC_TRAIN_SIZE", 32),
            image_size=size, seed=0)
        val_ds = SyntheticDataset(
            num_snippets=dm.get("SYNTHETIC_VAL_SIZE", 8),
            image_size=size, seed=1000)
    else:
        train_ds, val_ds = (ScanNetDataset(
            dm.DATA_PATH, path,
            num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
            image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED,
            seed=cfg.SEED) for path in (dm.TRAIN_ANNOTATION_PATH,
                                        dm.VAL_ANNOTATION_PATH))
    return (SnippetLoader(train_ds, dm.BATCH_SIZE, shuffle=dm.SHUFFLE,
                          drop_last=True, seed=cfg.SEED, **host),
            SnippetLoader(val_ds, dm.BATCH_SIZE, shuffle=False,
                          drop_last=False, seed=cfg.SEED, **host))


def main(argv=None):
    """Returns (trainer, final validation metrics)."""
    parser = argparse.ArgumentParser(description="PARQ training on the card")
    parser.add_argument("--cfg", required=True,
                        help="experiment configure file name")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE config overrides")
    args = parser.parse_args(argv)
    cfg = get_cfg()
    update_config(cfg, args)
    logging.basicConfig(level=logging.INFO, force=True)
    logging.info("config:\n%s", cfg)

    from ..train.loop import Trainer
    trainer = Trainer(cfg)
    train_loader, val_loader = build_loaders(cfg)
    trainer.fit(train_loader, val_loader)
    if trainer.restore_best():
        logging.info("final eval uses the best checkpoint")
    metrics = trainer.validate(val_loader, verbose=True)
    logging.info("final metrics: %s", metrics)
    return trainer, metrics


if __name__ == "__main__":
    main()

"""Train PARQ on the card: the port's twin of train.py.

    python -m parq_torch.cli.train --cfg configs/train.yaml [KEY VALUE ...]
    python -m parq_torch.cli.train --cfg configs/smoke.yaml TPU.PLATFORM cpu

Epochs over the dataset DATAMODULE names (`DATA_PATH synthetic` for the
built-in synthetic snippets), validation every VAL_CHECK_INTERVAL of an
epoch with F1 model selection, top-k checkpoints and resume under
LOG_PATH/NAME, then a final validation on the best checkpoint. It runs on
CUDA and raises without a GPU unless TPU.PLATFORM (or env PARQ_PLATFORM)
is "cpu".

Under torchrun it is one rank of a data- and sequence-parallel run
(RANK, WORLD_SIZE, LOCAL_RANK; device cuda:LOCAL_RANK):

    torchrun --nproc_per_node 8 -m parq_torch.cli.train \
        --cfg configs/train.yaml TPU.MESH_MODEL 2 TPU.SEQ_PARALLEL True

The process group's backend is NCCL on the card and gloo on the CPU, or
what env PARQ_DIST_BACKEND names (gloo for ranks that share one card).
One process without those variables runs as before.
"""
from __future__ import annotations

import argparse
import logging

from ..config import get_cfg, update_config


def build_loaders(cfg, mesh=None):
    """(train, val) SnippetLoaders for DATAMODULE, as train.py builds them:
    NUM_WORKERS ≤ 1 decodes in a prefetch thread, more in that many worker
    processes. With a `mesh` of several data ranks the training loader
    takes this rank's strided shard of the epoch order in batches of
    BATCH_SIZE / data (BATCH_SIZE is the global batch); the validation
    loader is the whole set on every rank."""
    from ..data import ScanNetDataset, SnippetLoader
    dm = cfg.DATAMODULE
    size = tuple(cfg.TPU.IMAGE_SIZE)
    workers = int(dm.get("NUM_WORKERS", 1))
    host = dict(num_workers=0 if workers <= 1 else workers)
    data = mesh.data if mesh is not None else 1
    shard = dict(host, process_index=mesh.data_index if data > 1 else 0,
                 process_count=data)
    train_bs = int(dm.BATCH_SIZE) // data
    if dm.DATASET == "arkitscenes":
        from ..data.arkitscenes import ARKitScenesDataset
        train_ds = ARKitScenesDataset(
            dm.DATA_PATH, num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
            image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED)
        val_ds = ARKitScenesDataset(
            dm.VAL_ANNOTATION_PATH or dm.DATA_PATH,
            num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
            image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED)
        return (SnippetLoader(train_ds, train_bs, shuffle=dm.SHUFFLE,
                              seed=cfg.SEED, **shard),
                SnippetLoader(val_ds, dm.BATCH_SIZE, shuffle=False,
                              drop_last=False, seed=cfg.SEED, **host))
    if dm.DATA_PATH == "synthetic" or dm.DATASET == "synthetic":
        # NUM_FRAMES_PER_SNIPPET views (train.py's synthetic loaders always
        # make 3), so a config's view count reaches the card
        from ..data import SyntheticDataset
        views = int(dm.NUM_FRAMES_PER_SNIPPET)
        train_ds = SyntheticDataset(
            num_snippets=dm.get("SYNTHETIC_TRAIN_SIZE", 32),
            image_size=size, num_views=views, seed=0)
        val_ds = SyntheticDataset(
            num_snippets=dm.get("SYNTHETIC_VAL_SIZE", 8),
            image_size=size, num_views=views, seed=1000)
    else:
        train_ds, val_ds = (ScanNetDataset(
            dm.DATA_PATH, path,
            num_frames_per_snippet=dm.NUM_FRAMES_PER_SNIPPET,
            image_size=size, gravity_aligned=dm.GRAVITY_ALIGNED,
            seed=cfg.SEED) for path in (dm.TRAIN_ANNOTATION_PATH,
                                        dm.VAL_ANNOTATION_PATH))
    return (SnippetLoader(train_ds, train_bs, shuffle=dm.SHUFFLE,
                          drop_last=True, seed=cfg.SEED, **shard),
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

    from ..config import platform_device
    from ..parallel.multihost import initialize_distributed
    initialize_distributed(int(cfg.TRAINER.NUM_NODES),
                           platform_device(cfg))
    from ..train.loop import Trainer
    trainer = Trainer(cfg)
    train_loader, val_loader = build_loaders(cfg, trainer.mesh)
    trainer.fit(train_loader, val_loader)
    if trainer.restore_best():
        logging.info("final eval uses the best checkpoint")
    metrics = trainer.validate(val_loader, verbose=True)
    logging.info("final metrics: %s", metrics)
    return trainer, metrics


if __name__ == "__main__":
    main()

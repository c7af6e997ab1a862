"""Train on synthetic batches: the port's twin of bench.py:build_train.

    python -m parq_torch.train --steps 5 --batch 8 --dtype bfloat16 --seed 0
    python -m parq_torch.train --steps 3 --batch 2 --device cpu

The model is the release configuration (ResNet50-FPN concat-1024, 3 views
of 320x240, dim 1024, L=8, Q=256, dropout 0.1) on CUDA, and the tiny one
on the CPU; random weights from --seed, AdamW at a constant lr of 1e-4
with a global-norm clip of 1.0. One line per step with the loss and the
gradient's norm. On the card the step is captured once as a CUDA graph
(the first step runs eagerly and captures it) and replayed after that.
Without a GPU it raises unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import resolve_device
from ..config import ModelConfig
from ..data.synthetic import make_batch, to_device
from ..models import BATCH_KEYS, build_model
from .train_step import make_graphed_train_step, make_optimizer

TRAIN_KEYS = BATCH_KEYS + ("obbs_padded", "sym")


def synthetic_batches(cfg: ModelConfig, batch_size: int, device,
                      n_batches: int = 2):
    """Device batches of synthetic snippets (boxes and symmetries
    included), made once; the steps cycle through them."""
    return [to_device(make_batch(list(range(i * batch_size,
                                            (i + 1) * batch_size)),
                                 image_size=cfg.image_size),
                      TRAIN_KEYS, device) for i in range(n_batches)]


def build(model: str = "release", dtype: str = "bfloat16", seed: int = 0,
          device=None):
    """(model in training mode, AdamW at lr 1e-4) at the named
    configuration; the AdamW is capturable, as `main` captures its step."""
    base = ModelConfig() if model == "release" else ModelConfig.tiny()
    cfg = dataclasses.replace(base, compute_dtype=dtype)
    net = build_model(cfg, seed=seed, device=device).train()
    return net, make_optimizer(net, capturable=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; release model) or cpu (tiny)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model_name = "tiny" if dev.type == "cpu" else "release"
    net, opt = build(model_name, args.dtype, args.seed, dev)
    batches = synthetic_batches(net.cfg, args.batch, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    train_step = make_graphed_train_step(net, opt)
    print(f"train: {model_name} B={args.batch} {args.dtype} on {dev}",
          flush=True)
    for step in range(args.steps):
        t0 = time.perf_counter()
        m = train_step(batches[step % len(batches)], gen)
        loss, norm = float(m["total_loss"]), float(m["grad_norm"])
        print(f"step {step}: loss {loss:.6f} grad_norm {norm:.6f} "
              f"valid_bs {float(m['valid_bs']):.0f} "
              f"({1e3 * (time.perf_counter() - t0):.1f} ms)", flush=True)


if __name__ == "__main__":
    main()

"""Export the port's eval forward with `torch.export` (twin of
scripts/export_model.py).

    python -m parq_torch.export --cfg configs/eval.yaml --out parq_fwd.pt2 \
        [--batch 1] [KEY VALUE ...]

The artifact is an `ExportedProgram` saved with `torch.export.save`: the
eval forward of the model the config describes, traced at a fixed batch of
the five input arrays (`BATCH_KEYS`), on the device it will serve on
(CUDA unless TPU.PLATFORM or env PARQ_PLATFORM is "cpu"): like the JAX
artifact, it is specific to its platform. Kernels B1 and B2 stay in the
program as the custom ops ``parq::sample_views`` and
``parq::flash_kv_fused``, so the artifact launches the same hand-written
kernels as the live model; loading it needs `parq_torch.kernels` imported
to resolve them (`load_artifact` does that).

The program carries the weights it was traced with (random from SEED);
there is deliberately no --CHECKPOINT_PATH flag, as in the JAX CLI: pair
the artifact with a checkpoint at serving time
(`python -m parq_torch.serve --artifact ... --CHECKPOINT_PATH ...`), which
loads the checkpoint's weights into the loaded program.
"""
from __future__ import annotations

import argparse
import io
import logging
from typing import Dict, Optional, Tuple

import torch

from . import kernels  # noqa: F401  (registers the custom ops)
from .data.synthetic import make_batch, to_device
from .models import BATCH_KEYS, PARQModel, build_model


def example_batch(model_cfg, batch_size: int, device) -> Dict:
    """The synthetic batch an artifact is traced and warmed up on: the
    five input arrays only (scripts/export_model.py:40-43)."""
    raw = make_batch(list(range(batch_size)), image_size=model_cfg.image_size,
                     num_views=model_cfg.num_views)
    return to_device(raw, BATCH_KEYS, device)


def load_model(model_cfg, seed: int, checkpoint: Optional[str] = None,
               device=None) -> PARQModel:
    """The eval model of `model_cfg` on `device`: random weights from
    `seed`, then `checkpoint` loaded strictly (a port checkpoint or a
    reference-layout state_dict) when one is given."""
    from .train.checkpoint import load_pretrained
    model = build_model(model_cfg, seed=seed, device=device)
    if checkpoint:
        load_pretrained(model, checkpoint, strict=True)
    return model


def export_forward(cfg, batch_size: int = 1, checkpoint: Optional[str] = None,
                   device=None) -> Tuple[bytes, Dict[str, torch.Tensor], Dict]:
    """(serialized program, its state_dict, example batch) for the config
    tree `cfg`, as scripts/export_model.py:export_forward returns
    (serialized bytes, params, example batch). Traced with no gradient, so
    the decoder takes its eval forms (B1 and B2 through their custom
    ops)."""
    from . import resolve_device
    from .config import ModelConfig, platform_device
    dev = resolve_device(device or platform_device(cfg))
    model = load_model(ModelConfig.from_cfg(cfg), int(cfg.SEED), checkpoint,
                       dev)
    batch = example_batch(model.cfg, batch_size, dev)
    with torch.no_grad():
        ep = torch.export.export(model, (batch,))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), ep.state_dict, batch


def load_artifact(path_or_bytes) -> torch.nn.Module:
    """The callable module of a saved artifact (a path or its bytes):
    call it with a dict of the five input tensors."""
    f = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
         else path_or_bytes)
    return torch.export.load(f).module()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export the parq_torch forward")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    from .config import get_cfg, update_config
    cfg = get_cfg()
    update_config(cfg, args)
    logging.basicConfig(level=logging.INFO)
    blob, _, _ = export_forward(cfg, args.batch)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob)} bytes -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

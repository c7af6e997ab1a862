"""The system under test, as the loops build it: the port (`parq_torch`)
at a configuration's sizes, loaded with the benchmark's weights.

Only the port's public entry points are used: `ModelConfig`,
`PARQModel`, `Graphed` and `parse_pred`."""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

EVAL_KEYS = ("rgb_img", "camera", "T_camera_pseudoCam", "T_world_pseudoCam",
             "T_world_local")


def model_config(cfg: dict, root: Path):
    """The port's ModelConfig of a configuration file's sizes."""
    from parq_torch.config import ModelConfig
    return ModelConfig(
        resnet_name=cfg["resnet_name"], backbone_layer=0,
        image_size=tuple(cfg["image_size"]), num_views=cfg["num_views"],
        fpn_channels=cfg["fpn_channels"],
        tokenizer_out_channels=cfg["tokenizer_out_channels"],
        ray_points_scale=tuple(cfg["ray_points_scale"]),
        num_samples=cfg["num_samples"], min_depth=cfg["min_depth"],
        max_depth=cfg["max_depth"], dec_dim=cfg["dec_dim"],
        dec_heads=cfg["dec_heads"], dec_ffn_dim=cfg["dec_ffn_dim"],
        dec_layers=cfg["dec_layers"], num_queries=cfg["num_queries"],
        num_semcls=cfg["num_semcls"], scale=tuple(cfg["scale"]),
        mean_size_path=str(root / cfg["mean_size_path"]),
        compute_dtype=cfg["compute_dtype"],
        dropout_rate=cfg["dropout_rate"], batched_grad=True,
        share_weights=True, remat=cfg["remat"])


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy the benchmark's weights into `model` (every key, strictly)."""
    with torch.no_grad():
        model.load_state_dict(weights, strict=True)


def build_model(cfg: dict, root: Path, weights, device):
    """The port's PARQModel with `weights`, on `device`, in eval mode."""
    from parq_torch.models import PARQModel
    with torch.device(device):
        model = PARQModel(model_config(cfg, root))
    model = model.to(device)
    load_weights(model, weights)
    return model.eval()


def to_device(host: Dict[str, torch.Tensor], keys, device):
    """A batch's `keys` copied to `device` (non-blocking from pinned
    memory), float32 as the port takes them."""
    return {k: host[k].to(device, non_blocking=True).float() for k in keys}


def pinned(pool: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """The pool in page-locked memory when the device is a card."""
    if torch.device(device).type != "cuda":
        return pool
    return {k: v.pin_memory() for k, v in pool.items()}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def events(device):
    """Two timing events on the card's stream, or None off a card."""
    if torch.device(device).type != "cuda":
        return None
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def release(device):
    """Give back the card's cached memory once the program is dropped."""
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

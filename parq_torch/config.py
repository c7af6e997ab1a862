"""Settings of the port's model and server, as small dataclasses.

The defaults are the release configuration: the values of
configs/eval.yaml and of the flagship model the JAX package builds
(`__graft_entry__._flagship_model`). `ModelConfig.tiny()` is that module's
tiny variant, for CPU tests.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parents[1]
MEAN_SIZE_PATH = str(REPO_ROOT / "data" / "average_scan2cad.txt")
RELEASE_SCALE = (-3.0, 3.0, -2.0, 0.5, 0.25, 5.25)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    resnet_name: str = "resnet50"
    image_size: Tuple[int, int] = (320, 240)      # (W, H)
    num_views: int = 3
    fpn_channels: int = 256
    tokenizer_out_channels: int = 1024
    ray_points_scale: Tuple[float, ...] = RELEASE_SCALE
    num_samples: int = 64
    min_depth: float = 0.25
    max_depth: float = 5.25
    dec_dim: int = 1024
    dec_heads: int = 4
    dec_ffn_dim: int = 768
    dec_layers: int = 8
    num_queries: int = 256
    num_semcls: int = 9
    scale: Tuple[float, ...] = RELEASE_SCALE
    mean_size_path: Optional[str] = MEAN_SIZE_PATH
    compute_dtype: str = "float32"                # or "bfloat16"
    dropout_rate: float = 0.1                     # decoder, training only
    batched_grad: bool = True                     # the two-phase fold

    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        """`_flagship_model(tiny=True)`: resnet18, 64x48, 2 iterations of
        8 queries at width 32, dropout 0.1."""
        kw = dict(resnet_name="resnet18", image_size=(64, 48),
                  num_samples=8, fpn_channels=8, tokenizer_out_channels=32,
                  dec_dim=32, dec_heads=4, dec_ffn_dim=16, dec_layers=2,
                  num_queries=8)
        kw.update(overrides)
        return cls(**kw)

    @property
    def feat_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // 4, self.image_size[1] // 4)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig = ModelConfig()
    track_scale: Tuple[float, ...] = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)
    conf_thresh: float = 0.8

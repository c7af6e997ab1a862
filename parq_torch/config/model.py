"""Settings of the port's model and server, as small dataclasses.

The defaults are the release configuration: the values of
configs/eval.yaml and of the flagship model the JAX package builds
(`__graft_entry__._flagship_model`). `ModelConfig.tiny()` is that module's
tiny variant, for CPU tests; `ModelConfig.from_cfg` reads a config tree
(`parq_torch.config.get_cfg`) as the JAX package's
`PARQModel.from_config` does.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parents[2]
MEAN_SIZE_PATH = str(REPO_ROOT / "data" / "average_scan2cad.txt")
RELEASE_SCALE = (-3.0, 3.0, -2.0, 0.5, 0.25, 5.25)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    resnet_name: str = "resnet50"
    backbone_layer: int = 0                       # the concat's pyramid level
    backbone_freeze: bool = False                 # no gradient to the backbone
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
    # class names by id for the mean-size table; None: ScanNet's 9 classes
    class_names: Optional[Tuple[str, ...]] = None
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

    @classmethod
    def from_cfg(cls, cfg) -> "ModelConfig":
        """The model a config tree describes (parq_tpu/models/parq.py:53-90):
        widths from MODEL, the input size, FPN width and compute dtype from
        the TPU section, the ARKit class names for the mean-size table when
        DATAMODULE.DATASET is arkitscenes."""
        m, t = cfg.MODEL, cfg.MODEL.DECODER.TRANSFORMER
        class_names = None
        if str(cfg.DATAMODULE.DATASET).lower() == "arkitscenes":
            from ..data.arkitscenes import ARKIT_CLASSES
            class_names = tuple(ARKIT_CLASSES)
        path = m.DECODER.MEAN_SIZE_PATH
        return cls(
            resnet_name=str(m.BACKBONE2D.RESNET_NAME),
            backbone_layer=int(m.BACKBONE2D.LAYER),
            backbone_freeze=bool(m.BACKBONE2D.FREEZE),
            image_size=tuple(int(v) for v in cfg.TPU.IMAGE_SIZE),
            num_views=int(cfg.DATAMODULE.NUM_FRAMES_PER_SNIPPET),
            fpn_channels=int(cfg.TPU.FPN_CHANNELS),
            tokenizer_out_channels=int(m.TOKENIZER.OUT_CHANNELS),
            ray_points_scale=tuple(float(v)
                                   for v in m.TOKENIZER.RAY_POINTS_SCALE),
            num_samples=int(m.TOKENIZER.NUM_SAMPLES),
            min_depth=float(m.TOKENIZER.MIN_DEPTH),
            max_depth=float(m.TOKENIZER.MAX_DEPTH),
            dec_dim=int(t.DEC_DIM), dec_heads=int(t.DEC_HEADS),
            dec_ffn_dim=int(t.DEC_FFN_DIM), dec_layers=int(t.DEC_LAYERS),
            num_queries=int(m.DECODER.NUM_QUERIES),
            num_semcls=int(m.DECODER.NUM_SEMCLS),
            scale=tuple(float(v) for v in t.SCALE),
            mean_size_path=None if path is None else str(path),
            class_names=class_names,
            compute_dtype=str(cfg.TPU.COMPUTE_DTYPE),
            dropout_rate=float(t.DROPOUT_RATE),
            batched_grad=bool(cfg.TPU.BATCHED_GRAD))

    @property
    def feat_size(self) -> Tuple[int, int]:
        s = 2 ** (self.backbone_layer + 2)
        return (self.image_size[0] // s, self.image_size[1] // s)

    @property
    def camera_scale(self) -> float:
        """Image → feature-map scale of the intrinsics (resnet_fpn.py:88)."""
        return 1.0 / 2 ** (self.backbone_layer + 2)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig = ModelConfig()
    track_scale: Tuple[float, ...] = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)
    conf_thresh: float = 0.8

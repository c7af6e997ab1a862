"""Settings of the port's model and server, as small dataclasses.

The defaults are the release configuration: the values of
configs/eval.yaml and of the flagship model the JAX package builds
(`__graft_entry__._flagship_model`). `ModelConfig.tiny()` is that module's
tiny variant, for CPU tests; `ModelConfig.from_cfg` reads a config tree
(`parq_torch.config.get_cfg`) as the JAX package's
`PARQModel.from_config` does. `PETRConfig` is the second architecture's:
its defaults are PETR's published R50-DCN P4 setting.
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
    share_weights: bool = True                    # one decoder iteration, L times
    remat: bool = False                           # recompute each iteration

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
        widths and SHARE_WEIGHTS from MODEL, the input size, FPN width,
        compute dtype, BATCHED_GRAD and REMAT from the TPU section, the ARKit class names for the mean-size table when
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
            batched_grad=bool(cfg.TPU.BATCHED_GRAD),
            share_weights=bool(t.SHARE_WEIGHTS),
            remat=bool(cfg.TPU.REMAT))

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
    """The served model and the host half's settings: the track-scale box
    of `parse_pred`, its NMS switch and the score threshold of a kept
    detection. The defaults are configs/eval.yaml's."""
    model: ModelConfig = ModelConfig()
    track_scale: Tuple[float, ...] = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)
    conf_thresh: float = 0.8
    enable_nms: bool = True

    @classmethod
    def from_cfg(cls, cfg) -> "ServeConfig":
        """From a config tree: the model of `ModelConfig.from_cfg`, and
        TRACK_SCALE, ENABLE_NMS and CONF_THRESH from MODEL.DECODER, as
        scripts/serve.py reads them (:135-142)."""
        dec = cfg.MODEL.DECODER
        return cls(model=ModelConfig.from_cfg(cfg),
                   track_scale=tuple(float(v) for v in dec.TRACK_SCALE),
                   conf_thresh=float(dec.CONF_THRESH),
                   enable_nms=bool(dec.ENABLE_NMS))


PETR_POSITION_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


@dataclasses.dataclass(frozen=True)
class PETRConfig:
    """PETR (Liu et al., ECCV 2022), the published R50-DCN P4 model:
    megvii-research/PETR projects/configs/petr/petr_r50dcn_gridmask_p4.py.
    Six cameras resized to 1408 x 512 at test time; a caffe-style
    ResNet-50 with DCNv2 in stages 3 and 4; CPFPN over C4, C5 (1024, 2048
    → 256) whose P4 (stride 16) the head reads; the 3D position encoder
    over 64 LID depth bins from 1 m; 900 queries; 6 post-norm decoder
    layers of width 256, 8 heads, FFN 2048; the NMS-free decode of the top
    300. Ranges are (x_min, y_min, z_min, x_max, y_max, z_max) in metres,
    in the lidar frame. The input normalisation is caffe's: BGR pixels in
    0..255, less the mean, over the std."""
    image_size: Tuple[int, int] = (1408, 512)     # (W, H), after the resize
    num_cams: int = 6
    resnet_name: str = "resnet50"
    style: str = "caffe"
    stage_with_dcn: Tuple[bool, ...] = (False, False, True, True)
    neck_in_channels: Tuple[int, ...] = (1024, 2048)    # C4, C5
    stride: int = 16                              # P4
    embed_dims: int = 256
    num_heads: int = 8
    ffn_dim: int = 2048
    num_layers: int = 6
    num_query: int = 900
    num_classes: int = 10
    code_size: int = 10             # cx, cy, w, l, cz, h, sin, cos, vx, vy
    num_reg_fcs: int = 2
    depth_num: int = 64
    depth_start: float = 1.0
    position_range: Tuple[float, ...] = PETR_POSITION_RANGE
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    post_center_range: Tuple[float, ...] = PETR_POSITION_RANGE
    max_num: int = 300
    img_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)   # BGR
    img_std: Tuple[float, ...] = (57.375, 57.120, 58.395)
    compute_dtype: str = "float32"                # or "bfloat16"

    @classmethod
    def tiny(cls, **overrides) -> "PETRConfig":
        """A CPU-test size: the same backbone and neck, 2 cameras of
        128 x 64, 8 depth bins, 2 layers of width 32 with 4 heads, 24
        queries, the top 20 decoded."""
        kw = dict(image_size=(128, 64), num_cams=2, embed_dims=32,
                  num_heads=4, ffn_dim=64, num_layers=2, num_query=24,
                  depth_num=8, max_num=20)
        kw.update(overrides)
        return cls(**kw)

    @property
    def feat_size(self) -> Tuple[int, int]:
        """(w, h) of P4."""
        return (self.image_size[0] // self.stride,
                self.image_size[1] // self.stride)

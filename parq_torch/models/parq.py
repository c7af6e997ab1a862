"""Full PARQ model: backbone → rayPE add → recurrent decoder (port of
parq_tpu/models/parq.py), returning the per-iteration stacked outputs.

State-dict keys follow the reference checkpoint: ``backbone2d.*``,
``add_ray_pe.*``, ``box3d_decoder.*``. `from_config` builds it from a
config tree and carries a (data, model) `Mesh` to the decoder, as the JAX
package's `PARQModel.from_config` carries `sp_mesh` (parq.py:48-91, 142):
the memory tokens shard over the mesh's model group under TPU.SEQ_PARALLEL.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from .. import resolve_device
from ..config import ModelConfig
from ..geometry import Camera, Pose
from .box_processor import load_mean_size_table
from .decoder import PARQDecoder
from .ray_pe import AddRayPE
from .resnet_fpn import ResNetFPN

BATCH_KEYS = ("rgb_img", "camera", "T_camera_pseudoCam",
              "T_world_pseudoCam", "T_world_local")


class PARQModel(nn.Module):
    @classmethod
    def from_config(cls, cfg, mesh=None) -> "PARQModel":
        """From a config tree; `mesh` (parallel.mesh.Mesh) sets the
        decoder's data-parallel place and, under TPU.SEQ_PARALLEL, its
        sequence-parallel group."""
        model = cls(ModelConfig.from_cfg(cfg))
        if mesh is not None:
            model.set_parallel(mesh, bool(cfg.TPU.SEQ_PARALLEL))
        return model

    def set_parallel(self, mesh, seq_parallel: bool) -> None:
        """The decoder's place in `mesh`: its data index (dropout draws for
        the global batch) and, with `seq_parallel`, the model group."""
        self.box3d_decoder.set_parallel(
            mesh.model_group if seq_parallel else None, mesh.data_index,
            mesh.data)

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        if cfg.dec_dim != cfg.tokenizer_out_channels \
                or cfg.tokenizer_out_channels != 4 * cfg.fpn_channels:
            raise ValueError("need dec_dim == tokenizer_out_channels == "
                             "4 * fpn_channels")
        self.backbone2d = ResNetFPN(cfg.resnet_name, cfg.fpn_channels,
                                    cfg.backbone_layer, cfg.backbone_freeze)
        self.add_ray_pe = AddRayPE(cfg.tokenizer_out_channels,
                                   cfg.ray_points_scale, cfg.num_samples,
                                   cfg.min_depth, cfg.max_depth,
                                   cfg.feat_size)
        class2type = (None if cfg.class_names is None
                      else dict(enumerate(cfg.class_names)))
        mean = load_mean_size_table(cfg.mean_size_path, cfg.num_semcls,
                                    class2type)
        self.box3d_decoder = PARQDecoder(
            cfg.dec_dim, cfg.dec_heads, cfg.dec_ffn_dim, cfg.dec_layers,
            cfg.num_queries, cfg.num_semcls, cfg.scale, cfg.feat_size,
            mean_size=torch.from_numpy(mean), dropout_rate=cfg.dropout_rate,
            batched_grad=cfg.batched_grad, share_weights=cfg.share_weights,
            remat=cfg.remat)

    def forward(self, batch: Dict[str, torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_feature_map: bool = False):
        """batch: rgb_img (B, T, H, W, 3) in [0, 1], camera (B, T, 6),
        T_camera_pseudoCam / T_world_pseudoCam (B, T, 12),
        T_world_local (B, 1, 12). bf16 runs under autocast; geometry,
        norms' statistics, the sampler's sums (rounded once to bf16 at its
        output) and the heads' outputs stay f32. `deterministic=False` is the training forward, with the
        decoder's dropout drawn from `generator`. Returns the decoder's
        outputs; with `return_feature_map`, (outputs, the token memory
        (B, T, h, w, C): backbone features plus the ray encoding, what the
        JAX package sows as "feature_map" for image logging)."""
        dev = batch["rgb_img"].device
        bf16 = self.cfg.compute_dtype == "bfloat16"
        ctx = (torch.autocast(dev.type, dtype=torch.bfloat16) if bf16
               else contextlib.nullcontext())
        with ctx:
            camera = Camera(batch["camera"]).scale(self.cfg.camera_scale)
            Tcp = Pose(batch["T_camera_pseudoCam"])
            Twp = Pose(batch["T_world_pseudoCam"])
            Twl = Pose(batch["T_world_local"])
            encoding = self.add_ray_pe(camera, Tcp, Twp, Twl)
            memory = self.backbone2d(batch["rgb_img"]) + encoding
            out = self.box3d_decoder(memory, camera, Tcp, Twp, Twl,
                                     deterministic=deterministic,
                                     generator=generator)
        return (out, memory) if return_feature_map else out


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from `generator`, in parameter order: weights of rank
    ≥ 2 ~ N(0, 1/fan_in) (lecun normal, as the JAX package's default),
    biases 0, norm scales 1, the reference points ~ N(0, 1). Frozen
    BatchNorm statistics stay at identity."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("refpoint.weight"):
                p.copy_(torch.randn(p.shape, generator=generator))
            elif p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def build_model(cfg: ModelConfig = ModelConfig(), seed: int = 0,
                device=None) -> PARQModel:
    """A PARQModel with random weights from `seed`, in eval mode, on
    `device` (CUDA unless the caller names another). Weights are drawn on
    the CPU, so one seed gives the same weights on every device."""
    dev = resolve_device(device)
    model = PARQModel(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

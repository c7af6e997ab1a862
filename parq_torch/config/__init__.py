"""Configuration: the model's and the server's dataclasses, and the config
tree the CLIs read from configs/*.yaml (port of parq_tpu/config)."""
from .defaults import (check_card_support, check_config, get_cfg,
                       platform_device, update_config)
from .model import (MEAN_SIZE_PATH, REPO_ROOT, BEVFormerConfig, ModelConfig,
                    PETRConfig, ServeConfig)
from .node import CfgNode, load_yaml

__all__ = ["BEVFormerConfig", "CfgNode", "MEAN_SIZE_PATH", "ModelConfig",
           "PETRConfig", "REPO_ROOT",
           "ServeConfig", "check_card_support", "check_config", "get_cfg",
           "load_yaml", "platform_device", "update_config"]

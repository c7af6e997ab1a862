from .bevformer import (BEVFormerModel, BEVStream, build_bevformer_model,
                        init_bevformer_weights)
from .parq import BATCH_KEYS, PARQModel, build_model, init_weights
from .petr import PETRModel, build_petr_model, init_petr_weights

__all__ = ["BATCH_KEYS", "BEVFormerModel", "BEVStream", "PARQModel",
           "PETRModel", "build_bevformer_model", "build_model",
           "build_petr_model", "init_bevformer_weights", "init_petr_weights",
           "init_weights"]

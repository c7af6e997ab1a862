from .parq import BATCH_KEYS, PARQModel, build_model, init_weights
from .petr import PETRModel, build_petr_model, init_petr_weights

__all__ = ["BATCH_KEYS", "PARQModel", "PETRModel", "build_model",
           "build_petr_model", "init_petr_weights", "init_weights"]

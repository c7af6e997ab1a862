from .parq import BATCH_KEYS, PARQModel, build_model, init_weights

__all__ = ["BATCH_KEYS", "PARQModel", "build_model", "init_weights"]

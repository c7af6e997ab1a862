from .nms import run_nms
from .parse_pred import parse_pred, parse_pred_device

__all__ = ["parse_pred", "parse_pred_device", "run_nms"]

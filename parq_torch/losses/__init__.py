from .set_loss import Targets, parse_targets, rotation_loss_sym, set_loss

__all__ = ["Targets", "parse_targets", "rotation_loss_sym", "set_loss"]

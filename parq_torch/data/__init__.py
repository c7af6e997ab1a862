from .synthetic import make_batch, make_snippet, to_device

__all__ = ["make_batch", "make_snippet", "to_device"]

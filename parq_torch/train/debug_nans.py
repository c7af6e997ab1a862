"""TPU.DEBUG_NANS: stop at the first NaN, the twin of the JAX package's
``jax_debug_nans`` (train.py:95-97), which raises FloatingPointError at
the first operation whose output holds a NaN.

- Forward: a hook on every module of the model checks the module's
  floating outputs and raises FloatingPointError naming the first module
  (innermost first, in execution order) whose output holds a NaN.
- Backward: autograd's anomaly mode with ``check_nan`` names the backward
  function that returned a NaN; `nan_errors` turns its RuntimeError into a
  FloatingPointError.

Off by default, and then nothing is installed: the hooks and the anomaly
mode cost a device sync for every module, so they are for debugging only.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def enable(model: torch.nn.Module) -> List:
    """Forward hooks on every module of `model` that raise
    FloatingPointError at the first NaN output, and autograd's anomaly mode
    with NaN checks (global, as the JAX flag is). Returns the hooks'
    handles."""
    def hook_for(name):
        def hook(module, inputs, output):
            for t in _tensors(output):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"DEBUG_NANS: NaN in the output of "
                        f"{name or 'the model'} ({type(module).__name__})")
        return hook
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    return [m.register_forward_hook(hook_for(name))
            for name, m in model.named_modules()]


@contextlib.contextmanager
def nan_errors():
    """Re-raise anomaly mode's NaN report from a backward as
    FloatingPointError."""
    try:
        yield
    except RuntimeError as e:
        if "nan values" in str(e):
            raise FloatingPointError(f"DEBUG_NANS: {e}") from e
        raise

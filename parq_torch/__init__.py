"""parq_torch — PyTorch/CUDA port of parq_tpu for one NVIDIA H100.

Mirrors parq_tpu's layout (geometry/, ops/, kernels/, models/, losses/,
evals/, data/, train/, config/, parallel/, io/) so each module has an
obvious counterpart; cli/ holds the twins of the root train.py and
eval.py. The JAX package is the reference this port is held against;
nothing here imports it.

Entry points run on CUDA unless the caller passes ``device="cpu"``. On a
CUDA tensor every kernel wrapper launches its hand-written kernel (built
from ``parq_torch/csrc``) or raises; the plain PyTorch version of each
kernel runs only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` names
    another. Raises when CUDA is requested (explicitly or by default) and
    no GPU is visible — there is no quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "parq_torch: no CUDA device is visible; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev

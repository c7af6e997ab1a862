"""DCNv2 as a module: mmcv's ModulatedDeformConv2dPack as mmdet's ResNet
builds it with ``dcn=dict(type='DCNv2', deform_groups=1,
fallback_on_stride=False)``: a 3x3 convolution, stride 1, padding 1, no
bias, whose sampling points move by offsets and are weighted by masks that
its own `conv_offset` (3x3, 27 outputs, with a bias) predicts from the
input. The sampling and the product run in `kernels.deform_conv`."""
from __future__ import annotations

import torch
import torch.nn as nn

from ..kernels.deform_conv import OFFSET_CHANNELS, modulated_deform_conv


class ModulatedDeformConv2d(nn.Module):
    """(N, cin, H, W) → (N, cout, H, W). State: `weight` (cout, cin, 3, 3)
    and `conv_offset` (its `weight` (27, cin, 3, 3) and `bias` (27)), the
    keys of an mmdet3d checkpoint's DCN conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.conv_offset = nn.Conv2d(cin, OFFSET_CHANNELS, 3, padding=1,
                                     bias=True)
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        nn.init.zeros_(self.conv_offset.weight)     # mmcv's init: a plain
        nn.init.zeros_(self.conv_offset.bias)       # conv until trained

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return modulated_deform_conv(x, self.conv_offset(x), self.weight)

"""Shared model building blocks (port of ``repro.models.layers``; the conv
block only so far)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.approx_ops import ApproxConfig, conv2d


def conv2d_block(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, stride=(1, 1),
                 padding="SAME", dilation=(1, 1), groups: int = 1,
                 acfg: Optional[ApproxConfig] = None,
                 activation=None) -> torch.Tensor:
    """Conv2d + optional bias + optional activation, the shared conv call
    site of every vision model. The route is resolved per layer by
    :func:`repro_torch.core.acu.conv_plan`; ``acfg=None`` is the exact
    float conv."""
    y = conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation,
               groups=groups, cfg=acfg)
    return y if activation is None else activation(y)

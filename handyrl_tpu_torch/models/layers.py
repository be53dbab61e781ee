"""Building blocks of the game nets.

Counterpart of the part of ``handyrl_tpu/models/layers.py`` that
``SimpleConvNet`` uses.  The JAX package computes in NHWC; torch's
convolutions take NCHW, so the port keeps NCHW between layers and moves the
channels last only where the order is visible: a head flattens its
features in NHWC order (``chw_to_nhwc``), as the JAX package's heads do.

Module names follow the Flax parameter tree (``Conv_0``, ``GroupNorm_0``,
``Dense_0``), so ``models/convert.py`` maps one onto the other by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # Flax's GroupNorm default (torch's is 1e-5)


def chw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C)."""
    return x.movedim(-3, -1)


def _norm(num_channels: int) -> nn.GroupNorm:
    """GroupNorm with 8 groups where the channels divide by 8, else one."""
    groups = 8 if num_channels % 8 == 0 else 1
    return nn.GroupNorm(groups, num_channels, eps=GN_EPS)


class ConvBlock(nn.Module):
    """3x3 'same' conv + (optional) GroupNorm; callers apply the ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 3, use_norm: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, padding=kernel // 2,
                                bias=not use_norm)
        self.GroupNorm_0 = _norm(features) if use_norm else None

    def forward(self, x):
        h = self.Conv_0(x)
        return h if self.GroupNorm_0 is None else self.GroupNorm_0(h)


class DenseHead(nn.Module):
    """1x1-conv feature mixer, leaky ReLU, NHWC flatten, bias-free linear."""

    def __init__(self, in_features: int, mix_features: int, cells: int, outputs: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, mix_features, 1)
        self.Dense_0 = nn.Linear(cells * mix_features, outputs, bias=False)

    def forward(self, x):
        h = F.leaky_relu(self.Conv_0(x), 0.1)
        return self.Dense_0(chw_to_nhwc(h).flatten(-3))

"""Building blocks of the game nets.

Counterpart of ``handyrl_tpu/models/layers.py``.  The JAX package computes
in NHWC; torch's convolutions take NCHW, so the port keeps NCHW between
layers and moves the channels last only where the order is visible:
``DenseHead`` and ``ScalarHead`` flatten their features in NHWC order
(``chw_to_nhwc``), as the JAX package's do, and ``SpatialHead`` flattens in
CHW order, which is where the JAX one moves its channels before the
reshape.  The DRC's recurrent state is NCHW too (see ``DRC``).

The blocks that take the fp32 recurrent state (the spatial and scalar
heads, ``ConvLSTMCell``) cast their input to their weights' dtype, so a
bf16 copy of the weights runs on it (``compute_dtype: bfloat16``).

Module names follow the Flax parameter tree (``Conv_0``, ``GroupNorm_0``,
``Dense_0``), so ``models/convert.py`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
    """3x3 'same' conv + (optional) GroupNorm; callers apply the ReLU.
    ``circular`` pads by wrapping around (a torus board)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3, use_norm: bool = True,
                 circular: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, padding=kernel // 2,
                                bias=not use_norm,
                                padding_mode="circular" if circular else "zeros")
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


class SpatialHead(nn.Module):
    """3x3 conv + GroupNorm + ReLU, bias-free 1x1 conv, CHW flatten: one
    logit per (output feature, cell), index ``f * H * W + y * W + x``."""

    def __init__(self, in_features: int, mix_features: int, output_features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, mix_features, 3, padding=1, bias=False)
        self.GroupNorm_0 = _norm(mix_features)
        self.Conv_1 = nn.Conv2d(mix_features, output_features, 1, bias=False)

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x.to(self.Conv_0.weight.dtype))))
        return self.Conv_1(h).flatten(-3)


class ScalarHead(nn.Module):
    """Bias-free 1x1 conv + GroupNorm + ReLU, NHWC flatten, bias-free linear."""

    def __init__(self, in_features: int, mix_features: int, cells: int, outputs: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, mix_features, 1, bias=False)
        self.GroupNorm_0 = _norm(mix_features)
        self.Dense_0 = nn.Linear(cells * mix_features, outputs, bias=False)

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x.to(self.Conv_0.weight.dtype))))
        return self.Dense_0(chw_to_nhwc(h).flatten(-3))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell on NCHW maps: one 'same' conv over
    ``cat([x, h_prev])`` gives the four gates, in the order i, f, o, g.

    The state ``(h, c)`` keeps its own dtype (fp32): the conv runs in its
    weights' dtype and the gate arithmetic promotes back to the state's."""

    def __init__(self, in_features: int, features: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features + features, 4 * features, kernel,
                                padding=kernel // 2)

    def forward(self, x, state: Tuple[torch.Tensor, torch.Tensor]):
        h_prev, c_prev = state
        w = self.Conv_0.weight
        gates = self.Conv_0(torch.cat([x.to(w.dtype), h_prev.to(w.dtype)], dim=-3))
        i, f, o, g = gates.chunk(4, dim=-3)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class DRC(nn.Module):
    """Deep Repeated ConvLSTM (arXiv:1901.03559): ``num_layers`` stacked
    cells applied ``num_repeats`` times per time step; layer 0 reads the
    input, layer i > 0 the fresh h of layer i - 1.

    The state is a pair ``(h, c)`` of fp32 tensors shaped
    ``(*batch, num_layers, C, H, W)``: per layer NCHW, the layout of the
    port's convolutions.  The JAX package's is ``(*batch, num_layers, H, W,
    C)``; the batch dims lead in both, so engines and batches stack it alike."""

    def __init__(self, in_features: int, num_layers: int, features: int, num_repeats: int = 3):
        super().__init__()
        self.num_layers, self.features, self.num_repeats = num_layers, features, num_repeats
        for i in range(num_layers):
            self.add_module(f"cell{i}", ConvLSTMCell(in_features if i == 0 else features, features))

    def forward(self, x, hidden):
        hs, cs = list(hidden[0].unbind(-4)), list(hidden[1].unbind(-4))
        cells = [getattr(self, f"cell{i}") for i in range(self.num_layers)]
        for _ in range(self.num_repeats):
            for i, cell in enumerate(cells):
                _, (hs[i], cs[i]) = cell(x if i == 0 else hs[i - 1], (hs[i], cs[i]))
        return hs[-1], (torch.stack(hs, dim=-4), torch.stack(cs, dim=-4))

    def initial_state(self, batch_dims: Sequence[int], spatial: Tuple[int, int], device=None):
        shape = (*batch_dims, self.num_layers, self.features, *spatial)
        return (torch.zeros(shape, device=device), torch.zeros(shape, device=device))

"""Game-specific policy/value nets.

Counterpart of ``handyrl_tpu/models/nets.py`` (``SimpleConvNet`` so far).
The calling convention is the transformer's: ``module(obs, hidden)`` with a
leading batch dim on every observation leaf (CHW planes, as the envs emit
them) returns a dict with 'policy' and 'value'; ``initial_state`` is None
for a feed-forward net.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBlock, DenseHead


class SimpleConvNet(nn.Module):
    """TicTacToe net: conv stem + ``blocks`` GroupNorm conv blocks + a
    policy and a value head (JAX ``SimpleConvNet``)."""

    def __init__(self, filters: int = 32, blocks: int = 3, num_actions: int = 9,
                 in_channels: int = 3, board: int = 9):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, filters, 3, padding=1)
        for i in range(blocks):
            self.add_module(f"ConvBlock_{i}", ConvBlock(filters, filters))
        self.blocks = blocks
        self.DenseHead_0 = DenseHead(filters, 2, board, num_actions)
        self.DenseHead_1 = DenseHead(filters, 1, board, 1)

    def forward(self, obs, hidden=None):
        h = F.relu(self.Conv_0(obs.to(self.Conv_0.weight.dtype)))
        for i in range(self.blocks):
            h = F.relu(getattr(self, f"ConvBlock_{i}")(h))
        return {"policy": self.DenseHead_0(h), "value": torch.tanh(self.DenseHead_1(h))}

    def initial_state(self, batch_dims: Sequence[int] = (), device=None):
        return None

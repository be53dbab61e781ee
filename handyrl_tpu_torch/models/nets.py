"""Game-specific policy/value nets.

Counterpart of ``handyrl_tpu/models/nets.py``: ``SimpleConvNet``
(TicTacToe), ``GeeseNet`` (HungryGeese) and the recurrent ``GeisterNet``.
The calling convention is the transformer's: ``module(obs, hidden)`` with
one leading batch dim on every observation leaf (CHW planes, as the envs
emit them) returns a dict with 'policy' and 'value', and 'return' and the
next 'hidden' where the net has them; ``initial_state`` is None for a
feed-forward net.  Submodules carry the names of the Flax scopes
(``ConvBlock_0``, ``drc.cell0.Conv_0``, ``Dense_0``, ...), so
``models/convert.py`` maps the JAX package's parameters by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DRC, ConvBlock, DenseHead, ScalarHead, SpatialHead


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


class GeeseNet(nn.Module):
    """HungryGeese net: a residual tower of circular-padded conv blocks; the
    policy reads the features at the goose's own head cell (observation
    plane 0), the value those and the board's mean (JAX ``GeeseNet``).

    The bias-free output layers start at zero (``zero_init``, which
    ``init_variables`` honours): the tower's scale grows with its depth, so
    a variance-preserving init gives a near-deterministic policy at step 0,
    where self-play needs the uniform one and a zero value."""

    def __init__(self, filters: int = 32, blocks: int = 12, num_actions: int = 4,
                 in_channels: int = 17):
        super().__init__()
        self.blocks = blocks
        self.ConvBlock_0 = ConvBlock(in_channels, filters, circular=True)
        for i in range(1, blocks + 1):
            self.add_module(f"ConvBlock_{i}", ConvBlock(filters, filters, circular=True))
        self.Dense_0 = nn.Linear(filters, num_actions, bias=False)
        self.Dense_1 = nn.Linear(2 * filters, 1, bias=False)
        for head in (self.Dense_0, self.Dense_1):
            nn.init.zeros_(head.weight)
            head.zero_init = True

    def forward(self, obs, hidden=None):
        h = F.relu(self.ConvBlock_0(obs))
        for i in range(1, self.blocks + 1):
            h = F.relu(h + getattr(self, f"ConvBlock_{i}")(h))
        h_head = (h * obs[:, :1]).sum(dim=(-2, -1))
        h_avg = h.mean(dim=(-2, -1))
        policy = self.Dense_0(h_head)
        value = torch.tanh(self.Dense_1(torch.cat([h_head, h_avg], dim=-1)))
        return {"policy": policy, "value": value}

    def initial_state(self, batch_dims: Sequence[int] = (), device=None):
        return None


class GeisterNet(nn.Module):
    """Geister net: conv stem, DRC ConvLSTM core, and the move / set policy,
    value and return heads (JAX ``GeisterNet``).

    The 18 scalar features are broadcast to board planes and put before the
    7 board planes; the 70 layout ('set') logits are a linear map of the
    turn-colour bit; the policy is 144 move logits then the 70."""

    def __init__(self, filters: int = 32, drc_layers: int = 3, drc_repeats: int = 3,
                 board_size: int = 6, scalar_features: int = 18, board_planes: int = 7):
        super().__init__()
        self.board_size = board_size
        cells = board_size * board_size
        self.ConvBlock_0 = ConvBlock(scalar_features + board_planes, filters)
        self.drc = DRC(filters, drc_layers, filters, drc_repeats)
        self.SpatialHead_0 = SpatialHead(filters, 8, 4)
        self.Dense_0 = nn.Linear(1, 70)
        self.ScalarHead_0 = ScalarHead(filters, 2, cells, 1)
        self.return_head = ScalarHead(filters, 2, cells, 1)

    def forward(self, obs, hidden=None):
        board, scalar = obs["board"], obs["scalar"]
        s_planes = scalar[..., None, None].expand(*scalar.shape, self.board_size, self.board_size)
        h = F.relu(self.ConvBlock_0(torch.cat([s_planes, board], dim=-3)))
        if hidden is None:
            hidden = self.initial_state(board.shape[:-3], board.device)
        h, new_hidden = self.drc(h, hidden)
        p_move = self.SpatialHead_0(h)
        p_set = self.Dense_0(scalar[..., 0:1])
        return {
            "policy": torch.cat([p_move, p_set], dim=-1),
            "value": torch.tanh(self.ScalarHead_0(h)),
            "return": self.return_head(h),
            "hidden": new_hidden,
        }

    def initial_state(self, batch_dims: Sequence[int] = (), device=None):
        """Zeros ``(h, c)``, each fp32 ``(*batch_dims, drc_layers, filters,
        board_size, board_size)`` (see ``DRC``)."""
        return self.drc.initial_state(tuple(batch_dims), (self.board_size, self.board_size), device)

"""Host-facing inference wrappers: numpy observations in, numpy outputs out.

Counterpart of ``handyrl_tpu/models/inference.py``.  ``InferenceModel``
runs the module on its device (the card unless the caller asks for the
CPU); the recurrent hidden state (the transformer's KV cache) stays there
between calls as device tensors, and policy / value come back as numpy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..utils import resolve_device, tree_map


@torch.no_grad()
def init_variables(module: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise ``module``'s parameters in place, as Flax initialises its
    own: Linear and Conv weights lecun-normal (normal truncated at two
    standard deviations, scaled by the fan-in: in features times the
    kernel's cells), biases zero, LayerNorm and GroupNorm scale one.  The
    numbers come from a ``torch.Generator`` seeded with ``seed``; they are
    not the JAX package's numbers for the same seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            # flax's variance_scaling(1, fan_in, truncated_normal) corrects
            # the std for the truncation
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return module


class InferenceModel:
    """A module on a device, exposing single-sample numpy inference.

    ``inference(obs, hidden)`` takes one unbatched observation and hidden
    state; the returned ``hidden`` is the next state, still on the device."""

    def __init__(self, module: nn.Module, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()

    def init_hidden(self, batch_dims=()):
        return self.module.initial_state(tuple(batch_dims), self.device)

    @torch.no_grad()
    def inference_batch(self, obs, hidden=None) -> Dict[str, Any]:
        obs_t = tree_map(lambda x: torch.as_tensor(np.asarray(x), device=self.device), obs)
        return self.module(obs_t, hidden)

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        hidden_b = tree_map(lambda h: h[None], hidden) if hidden is not None else None
        out = self.inference_batch(tree_map(lambda x: np.asarray(x)[None], obs), hidden_b)
        return split_outputs(out, 1)[0]


def split_outputs(out: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """A batch of ``n`` outputs -> one dict per row: policy, value ... as
    fp32 numpy (one copy to the host per key), the next hidden state (if
    the net has one) as views of the device tensors."""
    host = {k: v.float().cpu().numpy() for k, v in out.items() if k != "hidden"}
    hidden = out.get("hidden")
    rows = []
    for i in range(n):
        row = {k: v[i] for k, v in host.items()}
        if hidden is not None:
            row["hidden"] = tree_map(lambda h: h[i], hidden)
        rows.append(row)
    return rows


class RandomModel:
    """Zero-logit stand-in (uniform policy over legal actions, zero value)."""

    def __init__(self, output_spec: Dict[str, Any]):
        self._outputs = {
            k: np.zeros(shape, dtype) for k, (shape, dtype) in output_spec.items() if k != "hidden"
        }

    @classmethod
    def from_model(cls, model: InferenceModel, obs) -> "RandomModel":
        out = model.inference(obs, model.init_hidden())
        return cls({k: (v.shape, v.dtype) for k, v in out.items() if k != "hidden"})

    def init_hidden(self, batch_dims=()):
        return None

    def inference(self, obs, hidden=None, **kwargs):
        return {k: v.copy() for k, v in self._outputs.items()}

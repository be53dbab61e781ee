"""Host-facing inference wrappers: numpy observations in, numpy outputs out.

Counterpart of ``handyrl_tpu/models/inference.py``.  ``InferenceModel``
runs the module on its device (the card unless the caller asks for the
CPU); the recurrent hidden state (the transformer's KV cache) stays there
between calls as device tensors, and policy / value come back as numpy.

The serving plane splits a batch in two: ``inference_batch_async``
enqueues the forward and returns its outputs as tensors on the device
(under the per-device dispatch lock), and ``fetch_outputs`` copies them to
the host outside it.  ``build_inference_model`` makes each serving engine
a module of its own on its device, straight from a state dict.
"""

from __future__ import annotations

import copy
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
    kernel's cells), biases zero, LayerNorm and GroupNorm scale one.  A
    layer marked ``zero_init`` (a Flax ``zeros_init`` kernel) gets zero
    weights.  The numbers come from a ``torch.Generator`` seeded with
    ``seed``; they are not the JAX package's numbers for the same seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for mod in module.modules():
        if getattr(mod, "zero_init", False):
            mod.weight.zero_()
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
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

    def inference_batch_async(self, obs, hidden=None) -> Dict[str, Any]:
        """Enqueue one batched forward: a host-stacked observation batch is
        copied to the device once, ``hidden`` is a tree already there.
        Returns the outputs as device tensors, without waiting for them;
        ``fetch_outputs`` brings them to the host."""
        return self.inference_batch(obs, hidden)

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        hidden_b = tree_map(lambda h: h[None], hidden) if hidden is not None else None
        out = self.inference_batch(tree_map(lambda x: np.asarray(x)[None], obs), hidden_b)
        return split_outputs(out, 1)[0]


def as_device_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor on ``device``: a tensor
    already there is returned as it is, anything else is copied.  A
    read-only array (one decoded from a frame) is copied on the host
    first, since torch would otherwise alias a buffer it may not write."""
    if torch.is_tensor(x):
        return x.to(device)
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, device=device)


def as_host_array(x) -> np.ndarray:
    """``x`` (a tensor or an array) as numpy on the host: what the codec
    carries and the spill tier holds."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def fetch_outputs(outputs) -> Dict[str, Any]:
    """The fetch half of the serving plane's dispatch/fetch split: every
    leaf of ``outputs``, the hidden state included, copied to the host as
    numpy.  Called outside the dispatch lock, so another engine on the
    device enqueues meanwhile."""
    return tree_map(lambda x: None if x is None else as_host_array(x), outputs)


def module_skeleton(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s structure whose parameters and buffers live on
    the meta device: no storage is read or copied, wherever ``module``
    lives."""
    memo = {}
    for p in module.parameters():
        memo[id(p)] = nn.Parameter(torch.empty_like(p, device="meta"), p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def build_inference_model(module: nn.Module, state_dict: Dict[str, Any],
                          weight_dtype: str = "float32", device=None) -> InferenceModel:
    """A new module of ``module``'s structure, allocated on ``device`` (the
    card unless the caller asks for another) and filled from
    ``state_dict`` (tensors or numpy arrays by name), wrapped as an
    ``InferenceModel``; ``weight_dtype: int8`` builds the int8-resident
    ``QuantizedInferenceModel`` (an fp32 or an already quantized tree).  Each serving engine gets one: nothing is shared
    with ``module`` or with another engine, and a live engine's module is
    never copied."""
    if weight_dtype == "int8":
        # the codes and scales go straight onto the device; each layer
        # dequantizes its own kernel inside its forward (models/quantize.py)
        from .quantize import QuantizedInferenceModel

        return QuantizedInferenceModel(module, state_dict, device=device)
    if weight_dtype not in (None, "float32"):
        raise ValueError(f"weight_dtype must be 'float32' or 'int8', got {weight_dtype!r}")
    device = resolve_device(device)
    fresh = module_skeleton(module).to_empty(device=device)
    # host tensors go in as they are: load_state_dict copies each once into
    # the device's parameters, with no second device copy alive meanwhile
    fresh.load_state_dict({k: v if torch.is_tensor(v) else as_device_tensor(v, "cpu")
                           for k, v in state_dict.items()})
    return InferenceModel(fresh, device=device)


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

"""int8 weights for the serving engines and int8 observations for training.

Counterpart of ``handyrl_tpu/models/quantize.py``, in two halves.

* **The host half (numpy)**, as the JAX package has it: per-channel
  symmetric int8 weights (fp32 scales, codes -127..127, no zero-point) and
  static per-leaf (scale, zero-point) observations.  The port's layout puts
  a kernel's output channel on dim 0 (Linear ``(out, in)``, Conv2d OIHW),
  where Flax puts it last, so the per-channel scale runs over every axis but
  the first.  The codes are ``np.rint(w / scale)`` in fp32 on the host:
  bit for bit the JAX package's codes after ``convert.py``'s transpose.
  A quantized params tree is flat, ``name -> ndarray``: a quantized kernel
  ``name.weight`` travels as ``name.weight.int8_q`` (int8) and
  ``name.weight.int8_scale`` (fp32, one per output channel); biases and
  norm parameters stay fp32.

* **The device half (torch)**: ``quantize_module`` swaps every Linear and
  Conv2d of a module copy for a ``QuantLinear`` / ``QuantConv2d`` that
  holds the int8 codes and fp32 scales on the device and dequantizes ITS
  kernel when its forward reads ``.weight``: one layer's fp32 kernel at a
  time, computed in fp32 by ``F.linear`` / ``F.conv2d``, never the whole
  fp32 tree.  ``QuantizedInferenceModel`` is the engine over such a module;
  ``dequantize_obs_tree`` widens int8 observation planes on the device at
  the consumption seams (the train step's entry, the staged rings' sample).

Observations quantize once, at episode finalize (runtime/generation.py), so
the wire blocks, shm slots and device rings carry int8.  The default spec
(1.0, 0) is exact for the 0/1 planes of every env in the repo.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import resolve_device, to_numpy, tree_leaves, tree_map, tree_unflatten
from .inference import InferenceModel, as_device_tensor, fetch_outputs, module_skeleton

# the keys of one quantized kernel, as in the JAX package's wrapper dicts
QUANT_KEYS = frozenset({"int8_q", "int8_scale"})
_Q, _S = ".int8_q", ".int8_scale"

# symmetric int8: the -128 code is unused, so dequantize needs no zero-point
_QMAX = 127.0


def is_quantized_leaf(node: Any) -> bool:
    return isinstance(node, dict) and frozenset(node.keys()) == QUANT_KEYS


def _quantizable(leaf) -> bool:
    """Kernels only: >= 2 dims and floating."""
    leaf = np.asarray(leaf)
    return leaf.ndim >= 2 and np.issubdtype(leaf.dtype, np.floating)


def quantize_leaf(w) -> Dict[str, np.ndarray]:
    """Per-OUT-channel symmetric int8, the output channel on dim 0: the
    scale runs over every other axis."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))
    # an all-zero channel gets scale 1.0 and quantizes to zeros exactly
    scale = np.where(absmax > 0, absmax / _QMAX, 1.0).astype(np.float32)
    b = scale.reshape((-1,) + (1,) * (w.ndim - 1))
    q = np.clip(np.rint(w / b), -_QMAX, _QMAX).astype(np.int8)
    return {"int8_q": q, "int8_scale": scale}


def dequantize_leaf(node: Dict[str, Any]) -> np.ndarray:
    """The inverse of ``quantize_leaf`` (numpy)."""
    q = np.asarray(node["int8_q"])
    return q.astype(np.float32) * np.asarray(node["int8_scale"], np.float32).reshape(
        (-1,) + (1,) * (q.ndim - 1))


def quantized_names(params: Dict[str, Any]) -> List[str]:
    """The kernel names of a flat quantized tree (``name.weight``)."""
    return sorted(k[: -len(_Q)] for k in params if k.endswith(_Q))


def quantize_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A flat state dict (tensors or arrays) -> a flat numpy tree with every
    quantizable kernel as its ``.int8_q`` / ``.int8_scale`` pair.  Entries
    already quantized pass through: quantizing twice is the identity."""
    out: Dict[str, np.ndarray] = {}
    for name, value in params.items():
        value = to_numpy(value)
        if name.endswith(_Q) or name.endswith(_S) or not _quantizable(value):
            out[name] = value
        else:
            node = quantize_leaf(value)
            out[name + _Q], out[name + _S] = node["int8_q"], node["int8_scale"]
    return out


def dequantize_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A quantized (or mixed) flat tree -> an all-fp32 state dict."""
    out: Dict[str, np.ndarray] = {}
    for name, value in params.items():
        if name.endswith(_S):
            continue
        if name.endswith(_Q):
            base = name[: -len(_Q)]
            out[base] = dequantize_leaf({"int8_q": to_numpy(value),
                                         "int8_scale": to_numpy(params[base + _S])})
        else:
            out[name] = to_numpy(value)
    return out


def has_quantized_leaves(params: Dict[str, Any]) -> bool:
    return any(k.endswith(_Q) for k in params)


def param_bytes(params) -> int:
    """Resident bytes of a params tree (a flat dict, or a module's state),
    int8 codes and scales counted as they are stored."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return int(sum(v.numel() * v.element_size() if torch.is_tensor(v) else np.asarray(v).nbytes
                   for v in params.values()))


# -- the device half: quantized layers, module and engine -------------------


class _QuantKernel(nn.Module):
    """A layer whose kernel is held as int8 codes and fp32 per-output-channel
    scales on the device.  Reading ``.weight`` dequantizes this one kernel;
    its state dict names the pair ``weight.int8_q`` / ``weight.int8_scale``,
    the keys of ``quantize_params``."""

    def _init_quant(self, shape, bias: bool, device) -> None:
        self.register_buffer("int8_q", torch.zeros(shape, dtype=torch.int8, device=device))
        self.register_buffer("int8_scale", torch.ones(shape[0], dtype=torch.float32,
                                                      device=device))
        self.bias = (nn.Parameter(torch.zeros(shape[0], device=device), requires_grad=False)
                     if bias else None)

    @property
    def weight(self) -> torch.Tensor:
        return self.int8_q.float() * self.int8_scale.reshape(
            (-1,) + (1,) * (self.int8_q.dim() - 1))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "weight" + _Q] = self.int8_q if keep_vars else self.int8_q.detach()
        destination[prefix + "weight" + _S] = (self.int8_scale if keep_vars
                                                else self.int8_scale.detach())
        if self.bias is not None:
            destination[prefix + "bias"] = self.bias if keep_vars else self.bias.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        own = {"weight" + _Q: self.int8_q, "weight" + _S: self.int8_scale}
        if self.bias is not None:
            own["bias"] = self.bias
        for key, dest in own.items():
            src = state_dict.get(prefix + key)
            if src is None:
                missing_keys.append(prefix + key)
                continue
            src = torch.as_tensor(src)
            if src.shape != dest.shape or src.dtype != dest.dtype:
                error_msgs.append(f"{prefix + key}: {tuple(src.shape)} {src.dtype} where the "
                                  f"module holds {tuple(dest.shape)} {dest.dtype}")
                continue
            with torch.no_grad():
                dest.copy_(src)
        if strict:
            for key in state_dict:
                if key.startswith(prefix) and key[len(prefix):] not in own:
                    unexpected_keys.append(key)


class QuantLinear(_QuantKernel):
    def __init__(self, linear: nn.Linear, device=None):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self._init_quant((linear.out_features, linear.in_features), linear.bias is not None,
                         device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class QuantConv2d(_QuantKernel):
    def __init__(self, conv: nn.Conv2d, device=None):
        super().__init__()
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        # non-zero padding (GeeseNet's torus is 'circular') goes in F.pad first,
        # as nn.Conv2d does it
        self.padding_mode = conv.padding_mode
        self._pad = conv._reversed_padding_repeated_twice
        self._init_quant(tuple(conv.weight.shape), conv.bias is not None, device)

    def forward(self, x):
        if self.padding_mode != "zeros":
            return F.conv2d(F.pad(x, self._pad, mode=self.padding_mode), self.weight, self.bias,
                            self.stride, 0, self.dilation, self.groups)
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups)


def quantize_module(module: nn.Module, device="meta") -> nn.Module:
    """A copy of ``module``'s structure with every Linear and Conv2d
    replaced by its quantized layer (allocated on ``device``), the rest of
    its parameters and buffers on the meta device, storage unread.  Fill it
    with ``to_empty`` and ``load_state_dict(quantize_params(...))``."""
    fresh = module_skeleton(module)

    def swap(parent: nn.Module) -> None:
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear):
                setattr(parent, name, QuantLinear(child, device))
            elif isinstance(child, nn.Conv2d):
                setattr(parent, name, QuantConv2d(child, device))
            else:
                swap(child)

    swap(fresh)
    return fresh


class QuantizedInferenceModel(InferenceModel):
    """The engine over a quantized module: the int8 codes and fp32 scales
    stay resident on the device, and each layer dequantizes its own kernel
    inside its forward.  The surface of ``InferenceModel`` (``module``,
    ``init_hidden``, ``inference_batch_async``, ``inference_batch``), which
    ``ContinuousBatcher`` and ``SessionCache`` use, plus ``swap_params``.
    The quantized module is made from a meta skeleton straight onto the
    device: only codes, scales, biases and norms are copied there."""

    def __init__(self, module: nn.Module, params: Dict[str, Any], device=None):
        self.device = resolve_device(device)
        self.module = quantize_module(module).to_empty(device=self.device).eval()
        self.swap_params(params)

    @torch.no_grad()
    def swap_params(self, params: Dict[str, Any]) -> None:
        """Load an fp32 or an already quantized tree into the resident
        buffers (quantized on the host when it is fp32): a hot swap."""
        tree = quantize_params(params)
        self.module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                     for k, v in tree.items()})

    @torch.no_grad()
    def inference_batch(self, obs, hidden=None) -> Dict[str, Any]:
        obs_t = tree_map(lambda x: as_device_tensor(x, self.device), obs)
        return self.module(obs_t, hidden)


def calibration_report(module: nn.Module, params: Dict[str, Any], obs_batches: Sequence[Any],
                       hidden=None, device=None) -> Dict[str, float]:
    """The measured fp32-vs-int8 output deviation over replay observations:
    ``obs_batches`` (batched observation trees) through an fp32 engine and
    an int8 engine of the same params (an fp32 or quantized tree).  Max and
    mean absolute deviation over every output but the hidden state."""
    from .inference import build_inference_model

    fp32 = build_inference_model(module, dequantize_params(params), device=device)
    q = QuantizedInferenceModel(module, params, device=device)
    max_dev, dev_sum, n = 0.0, 0.0, 0
    for obs in obs_batches:
        bdims = (np.asarray(tree_leaves(obs)[0]).shape[0],)
        h = hidden if hidden is not None else fp32.init_hidden(bdims)
        out_f = fetch_outputs(fp32.inference_batch(obs, h))
        out_q = fetch_outputs(q.inference_batch(obs, h))
        for key, vf in out_f.items():
            if key == "hidden" or vf is None:
                continue
            d = np.abs(np.asarray(vf, np.float32) - np.asarray(out_q[key], np.float32))
            max_dev = max(max_dev, float(d.max()))
            dev_sum += float(d.sum())
            n += d.size
    return {
        "calib_batches": float(len(obs_batches)),
        "calib_max_dev": round(max_dev, 6),
        "calib_mean_dev": round(dev_sum / max(n, 1), 8),
    }


def calibration_batches_from_store(store, n: int) -> List[Any]:
    """Up to ``n`` recent episodes' observations from an ``EpisodeStore`` as
    batched observation trees (host numpy); int8 observations are
    dequantized under the spec their episode carries."""
    from ..runtime.replay import decompress_block

    if n <= 0:
        return []
    batches: List[Any] = []
    for ep in store.snapshot()[-int(n):]:
        obs = decompress_block(ep["blocks"][0])["obs"]   # (t, P, ...) leaves
        if obs_tree_is_int8(obs):
            obs = dequantize_obs_tree(obs, episode_obs_spec(ep))
        batches.append(tree_map(lambda x: np.asarray(x).reshape((-1,) + np.asarray(x).shape[2:]),
                                obs))
    return batches


# -- the observation int8 plane ---------------------------------------------


def obs_quant_spec(env, obs=None) -> List[Tuple[float, float]]:
    """Per-leaf (scale, zero_point) of an env's observation tree, in
    ``tree_leaves`` order: the env's ``obs_int8_spec()`` where it has one,
    else (1.0, 0) per leaf, exact for 0/1 planes."""
    hook = getattr(env, "obs_int8_spec", None)
    if hook is not None:
        spec = [(float(s), float(z)) for s, z in hook()]
    else:
        if obs is None:
            env.reset()
            obs = env.observation(env.players()[0])
        spec = [(1.0, 0.0) for _ in tree_leaves(obs)]
    for scale, zp in spec:
        if scale <= 0:
            raise ValueError(f"obs_int8 scale must be > 0, got {scale}")
    return spec


def episode_obs_spec(episode: Dict[str, Any]) -> Optional[List[Tuple[float, float]]]:
    """The spec an int8 episode was quantized under (its ``obs_scale`` and
    ``obs_zero``), or None."""
    if episode.get("obs_scale") is None:
        return None
    return list(zip(np.asarray(episode["obs_scale"], np.float32).tolist(),
                    np.asarray(episode["obs_zero"], np.float32).tolist()))


def quantize_obs_tree(tree: Any, spec: Optional[Sequence[Tuple[float, float]]] = None):
    """The host-side (numpy) observation quantize at episode finalize."""
    leaves = tree_leaves(tree)
    if spec is None:
        spec = [(1.0, 0.0)] * len(leaves)
    out = []
    for leaf, (scale, zp) in zip(leaves, spec):
        x = np.asarray(leaf)
        if np.issubdtype(x.dtype, np.floating):
            out.append(np.clip(np.rint(x / scale) + zp, -128, 127).astype(np.int8))
        else:
            out.append(x)
    return tree_unflatten(tree, out)


def dequantize_obs_tree(tree: Any, spec: Optional[Sequence[Tuple[float, float]]] = None):
    """Widen int8 leaves to fp32 (tensors on their device, or numpy on the
    host); other leaves pass through, so an fp32 tree is returned as it is."""
    leaves = tree_leaves(tree)
    if spec is None:
        spec = [(1.0, 0.0)] * len(leaves)
    out = []
    for leaf, (scale, zp) in zip(leaves, spec):
        if torch.is_tensor(leaf) and leaf.dtype == torch.int8:
            x = leaf.float()
            if zp:
                x = x - float(np.float32(zp))
            if scale != 1.0:
                x = x * float(np.float32(scale))
            out.append(x)
        elif not torch.is_tensor(leaf) and np.asarray(leaf).dtype == np.int8:
            x = np.asarray(leaf).astype(np.float32)
            if zp:
                x = x - np.float32(zp)
            if scale != 1.0:
                x = x * np.float32(scale)
            out.append(x)
        else:
            out.append(leaf)
    return tree_unflatten(tree, out)


def obs_tree_is_int8(tree: Any) -> bool:
    return any((leaf.dtype == torch.int8) if torch.is_tensor(leaf)
               else np.asarray(leaf).dtype == np.int8 for leaf in tree_leaves(tree))


__all__ = [
    "QUANT_KEYS", "QuantConv2d", "QuantLinear", "QuantizedInferenceModel",
    "calibration_batches_from_store", "calibration_report",
    "dequantize_leaf", "dequantize_obs_tree", "dequantize_params", "episode_obs_spec",
    "has_quantized_leaves", "is_quantized_leaf", "obs_quant_spec", "obs_tree_is_int8",
    "param_bytes", "quantize_leaf", "quantize_module", "quantize_obs_tree", "quantize_params",
    "quantized_names",
]

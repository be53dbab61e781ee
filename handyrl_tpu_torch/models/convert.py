"""Weight bridge: the JAX package's Flax params -> the port's ``state_dict``.

Flax names each submodule as the port names its ``nn.Module``s
(``attn0/q/kernel`` -> ``attn0.q.weight``, ``drc/cell0/Conv_0/kernel`` ->
``drc.cell0.Conv_0.weight``).  A Dense kernel is stored
(in, out) and a torch Linear weight (out, in), so kernels are transposed;
a Conv kernel is stored HWIO and a torch Conv2d weight OIHW;
LayerNorm and GroupNorm ``scale``/``bias`` become ``weight``/``bias``.
A quantized kernel (the JAX package's ``{'int8_q', 'int8_scale'}`` dict)
becomes ``<name>.weight.int8_q`` (the codes, transposed as the kernel is)
and ``<name>.weight.int8_scale``: the state dict of the port's quantized
module (models/quantize.py).
The q/k/v output features keep their (H * Dh, head-major) order, which
both packages reshape the same way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .quantize import is_quantized_leaf

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the Flax ``params`` tree as nested dicts of numpy arrays."""
    out: Dict[str, torch.Tensor] = {}

    def kernel(arr):
        return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T

    def walk(tree, prefix):
        for name, value in tree.items():
            if is_quantized_leaf(value):
                # a quantized kernel: its codes transpose as the kernel does,
                # its per-output-channel scales stay as they are
                base = prefix + _LEAF_NAMES[name]
                out[base + ".int8_q"] = torch.tensor(kernel(np.asarray(value["int8_q"], np.int8)))
                out[base + ".int8_scale"] = torch.tensor(
                    np.asarray(value["int8_scale"], np.float32))
                continue
            if isinstance(value, dict):
                walk(value, prefix + name + ".")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = kernel(arr)
            out[prefix + _LEAF_NAMES[name]] = torch.tensor(arr)  # a copy, C-contiguous

    walk(params, "")
    return out

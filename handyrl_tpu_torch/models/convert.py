"""Weight bridge: the JAX package's Flax params -> the port's ``state_dict``.

Flax names each submodule as the port names its ``nn.Module``s
(``attn0/q/kernel`` -> ``attn0.q.weight``, ``drc/cell0/Conv_0/kernel`` ->
``drc.cell0.Conv_0.weight``).  A Dense kernel is stored
(in, out) and a torch Linear weight (out, in), so kernels are transposed;
a Conv kernel is stored HWIO and a torch Conv2d weight OIHW;
LayerNorm and GroupNorm ``scale``/``bias`` become ``weight``/``bias``.
The q/k/v output features keep their (H * Dh, head-major) order, which
both packages reshape the same way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the Flax ``params`` tree as nested dicts of numpy arrays."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + name + ".")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[prefix + _LEAF_NAMES[name]] = torch.tensor(arr)  # a copy, C-contiguous

    walk(params, "")
    return out

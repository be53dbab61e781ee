"""Attention references shared by the ops layer.

Counterpart of ``handyrl_tpu/ops/ring_attention.py``.  It holds, for now,
the ``NEG_INF`` fill value and ``full_attention_reference``, the plain
version of the flash kernel (``ops/flash_attention.py``).  The ring
functions of the JAX module (``ring_self_attention``,
``masked_ring_self_attention`` and their shards) come with the multi-GPU
work, over a sequence-parallel ``torch.distributed`` group.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def full_attention_reference(q, k, v, causal: bool = True):
    """Naive O(T^2) attention over (B, T, H, D): fp32 scores and softmax,
    the causal mask a ``tril`` filled with ``NEG_INF``, the product with v in
    fp32, cast to q's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)

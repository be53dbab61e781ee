"""Transformer policy/value net with a KV-cache ring buffer as hidden state.

Counterpart of ``handyrl_tpu/models/transformer.py``.  Episode memory is a
per-layer key/value cache of the last ``memory_len`` observed steps:

* step mode (acting) — one decode step over the ring: a one-hot cache
  write at ``slot = pos mod memory_len``, and attention over the ``count``
  newest entries with an ALiBi age bias;
* seq mode (training) — a whole (rows, T) window at once, reproducing the
  ring exactly with masks: keys must be observed steps, ages count observed
  steps, keys older than ``memory_len`` observed steps are invisible, and
  self is always visible.  The attention is the masked flash kernel
  (``use_flash``) or its plain version.

Module names follow the Flax parameter tree (``enc1``, ``attn{i}.q`` ...),
so ``models/convert.py`` maps one onto the other by name.  LayerNorm keeps
Flax's ``eps=1e-6``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import masked_attention_reference, masked_flash_attention
from ..utils import tree_leaves

NEG_INF = -1e30
LN_EPS = 1e-6


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """Geometric head slopes as in ALiBi: 2^(-8(i+1)/n)."""
    return torch.tensor(
        [2.0 ** (-8.0 * (i + 1) / n_heads) for i in range(n_heads)],
        dtype=torch.float32, device=device,
    )


def flatten_obs(obs, lead_dims: int, dtype) -> torch.Tensor:
    """Encoder input: every obs leaf flattened past the first ``lead_dims``
    axes, concatenated in sorted-key order."""
    return torch.cat(
        [l.reshape(l.shape[:lead_dims] + (-1,)).to(dtype) for l in tree_leaves(obs)], dim=-1
    )


class CachedSelfAttention(nn.Module):
    """Causal self-attention; step mode over a KV ring, seq mode over a window."""

    def __init__(self, d_model: int, n_heads: int, memory_len: int):
        super().__init__()
        self.n_heads, self.memory_len = n_heads, memory_len
        self.head_dim = d_model // n_heads
        width = n_heads * self.head_dim
        self.q = nn.Linear(d_model, width)
        self.k = nn.Linear(d_model, width)
        self.v = nn.Linear(d_model, width)
        self.o = nn.Linear(width, d_model)

    def step(self, x, cache, slot, count):
        B, H, S, Dh = x.shape[0], self.n_heads, self.memory_len, self.head_dim
        q = self.q(x).reshape(B, H, Dh)
        k_new = self.k(x).reshape(B, H, Dh)
        v_new = self.v(x).reshape(B, H, Dh)

        oh = F.one_hot(slot, S).to(x.dtype)[..., None, None]          # (B, S, 1, 1)
        k_cache = cache["k"] * (1 - oh) + oh * k_new[:, None]
        v_cache = cache["v"] * (1 - oh) + oh * v_new[:, None]

        scores = torch.einsum("bhd,bshd->bhs", q, k_cache) / Dh ** 0.5
        idx = torch.arange(S, device=x.device)
        age = torch.remainder(slot[:, None] - idx[None, :], S)          # 0 = newest
        valid = age < count[:, None]
        bias = -alibi_slopes(H, x.device)[None, :, None] * age[:, None, :]
        scores = torch.where(valid[:, None, :], scores + bias, torch.full_like(scores, NEG_INF))
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhs,bshd->bhd", attn, v_cache).reshape(B, H * Dh)
        return self.o(out), {"k": k_cache, "v": v_cache}

    def seq(self, x, key_mask, burn_in: int = 0, use_flash: bool = False, blk_q: int = 128):
        B, T, _ = x.shape
        H, Dh = self.n_heads, self.head_dim
        q = self.q(x).reshape(B, T, H, Dh)
        k = self.k(x).reshape(B, T, H, Dh)
        v = self.v(x).reshape(B, T, H, Dh)
        if burn_in > 0:  # no gradients through warm-up keys
            bmask = (torch.arange(T, device=x.device) < burn_in).to(x.dtype)[None, :, None, None]
            k = k.detach() * bmask + k * (1 - bmask)
            v = v.detach() * bmask + v * (1 - bmask)
        slopes = alibi_slopes(H, x.device)
        if use_flash:
            out = masked_flash_attention(q, k, v, key_mask, slopes, self.memory_len, blk_q)
        else:
            out = masked_attention_reference(q, k, v, key_mask, slopes, self.memory_len)
        return self.o(out.reshape(B, T, H * Dh))


class TransformerNet(nn.Module):
    """Memory-transformer policy/value net.

    ``input_size`` is the flattened observation size (Flax infers it at
    init; a torch Linear needs it up front).  ``with_return`` adds the
    reward-sum head (Geister)."""

    supports_seq = True  # the train path may call with seq=True

    def __init__(self, num_actions: int, input_size: int, d_model: int = 64, n_heads: int = 4,
                 n_layers: int = 2, memory_len: int = 32, mlp_ratio: int = 4,
                 with_return: bool = False):
        super().__init__()
        self.num_actions, self.d_model, self.n_heads = num_actions, d_model, n_heads
        self.n_layers, self.memory_len, self.with_return = n_layers, memory_len, with_return
        self.enc1 = nn.Linear(input_size, d_model)
        self.enc2 = nn.Linear(d_model, d_model)
        for i in range(n_layers):
            self.add_module(f"ln_a{i}", nn.LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"attn{i}", CachedSelfAttention(d_model, n_heads, memory_len))
            self.add_module(f"ln_m{i}", nn.LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"mlp_up{i}", nn.Linear(d_model, mlp_ratio * d_model))
            self.add_module(f"mlp_dn{i}", nn.Linear(mlp_ratio * d_model, d_model))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.policy = nn.Linear(d_model, num_actions)
        self.value = nn.Linear(d_model, 1)
        if with_return:
            self.return_head = nn.Linear(d_model, 1)

    def _layer(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}{i}")

    def forward(self, obs, hidden=None, *, seq: bool = False, key_mask=None, burn_in: int = 0,
                use_flash: bool = False, blk_q: int = 128) -> Dict[str, Any]:
        dtype = self.enc1.weight.dtype
        if seq:
            x = F.relu(self.enc1(flatten_obs(obs, 2, dtype)))
            if key_mask is None:
                key_mask = torch.ones(x.shape[:2], device=x.device)
        else:
            if hidden is None:
                hidden = self.initial_state((tree_leaves(obs)[0].shape[0],), self.enc1.weight.device)
            x = F.relu(self.enc1(flatten_obs(obs, 1, dtype)))
            pos = hidden["pos"]                 # float32 (B,)
            count = torch.clamp(pos + 1, max=self.memory_len).to(torch.int64)
            slot = torch.remainder(pos, float(self.memory_len)).to(torch.int64)
        x = self.enc2(x)

        new_layers = []
        for i in range(self.n_layers):
            h = self._layer("ln_a", i)(x)
            attn = self._layer("attn", i)
            if seq:
                a = attn.seq(h, key_mask, burn_in, use_flash, blk_q)
            else:
                a, cache = attn.step(h, hidden["layers"][i], slot, count)
                new_layers.append(cache)
            x = x + a
            m = self._layer("mlp_up", i)(self._layer("ln_m", i)(x))
            x = x + self._layer("mlp_dn", i)(F.relu(m))

        h = self.ln_f(x)
        out: Dict[str, Any] = {"policy": self.policy(h), "value": torch.tanh(self.value(h))}
        if not seq:
            out["hidden"] = {"layers": tuple(new_layers), "pos": hidden["pos"] + 1.0}
        if self.with_return:
            out["return"] = self.return_head(h)
        return out

    def initial_state(self, batch_dims: Sequence[int] = (), device=None):
        bd = tuple(batch_dims)
        Dh = self.d_model // self.n_heads
        shape = (*bd, self.memory_len, self.n_heads, Dh)
        layers = tuple(
            {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}
            for _ in range(self.n_layers)
        )
        # pos is float32, as in the JAX package (its scan carry is masked
        # arithmetically and must keep one dtype)
        return {"layers": layers, "pos": torch.zeros(bd, device=device)}

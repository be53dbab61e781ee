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
  (``use_flash``), its plain version, or, given ``ring`` (an ``sp``
  AxisGroup), the masked ring over the group: then the module runs on this
  rank's T/sp shard of the window, at its global positions; ``remat`` picks
  the block's rung of the activation-checkpoint ladder (``_seq_block``),
  'none' under the ring.

Module names follow the Flax parameter tree (``enc1``, ``attn{i}.q`` ...),
so ``models/convert.py`` maps one onto the other by name.  LayerNorm keeps
Flax's ``eps=1e-6``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import masked_attention_reference, masked_flash_attention
from ..ops.ring_attention import global_counts, masked_ring_attention_shard
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

    def seq_parts(self, burn_in: int = 0, use_flash: bool = False, blk_q: int = 128,
                  ring=None):
        """Seq mode as two functions over the weights as they are now (under
        ``functional_call``, the substituted ones): ``project(h) -> (q, k, v)``
        and ``attend(q, k, v, key_mask) -> out``.  The remat ladder
        checkpoints ``attend`` with q, k and v as its inputs, so they stay
        stored (the kernel's backward reads them), and its replay in the
        backward pass computes with the same weights as the forward did.

        ``ring``: (the sp AxisGroup, the shard's first global position, the
        shard's global observed counts) when ``h`` is one rank's shard of the
        window; the burn-in mask then reads global positions."""
        H, Dh, S = self.n_heads, self.head_dim, self.memory_len
        wq, bq, wk, bk = self.q.weight, self.q.bias, self.k.weight, self.k.bias
        wv, bv, wo, bo = self.v.weight, self.v.bias, self.o.weight, self.o.bias

        def project(h):
            B, T, _ = h.shape
            q = F.linear(h, wq, bq).reshape(B, T, H, Dh)
            k = F.linear(h, wk, bk).reshape(B, T, H, Dh)
            v = F.linear(h, wv, bv).reshape(B, T, H, Dh)
            if burn_in > 0:  # no gradients through warm-up keys
                pos = torch.arange(T, device=h.device) + (ring[1] if ring is not None else 0)
                bmask = (pos < burn_in).to(h.dtype)[None, :, None, None]
                k = k.detach() * bmask + k * (1 - bmask)
                v = v.detach() * bmask + v * (1 - bmask)
            return q, k, v

        def attend(q, k, v, key_mask):
            B, T = q.shape[:2]
            slopes = alibi_slopes(H, q.device)
            if ring is not None:
                group, _offset, counts = ring
                out = masked_ring_attention_shard(q, k, v, key_mask, counts, slopes, group, S)
            elif use_flash:
                out = masked_flash_attention(q, k, v, key_mask, slopes, S, blk_q)
            else:
                out = masked_attention_reference(q, k, v, key_mask, slopes, S)
            return F.linear(out.reshape(B, T, H * Dh), wo, bo)

        return project, attend


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

    def _seq_block(self, i: int, x, key_mask, burn_in: int, use_flash: bool, blk_q: int,
                   remat: str, ring=None):
        """One attention+FFN block in seq mode, at rung ``remat`` of the
        ladder (JAX ``TransformerNet`` seq mode):

        * none  — every activation stored;
        * attn  — the attention sublayer (kernel forward and output
          projection) checkpointed and replayed in the backward pass;
        * block — the whole block checkpointed: only its input and q, k, v
          stay stored per layer.

        Both rungs keep q, k and v, as the JAX package's
        ``save_only_these_names('attn_qkv')`` does, by making them inputs
        of the checkpointed region.  One definition of each half serves
        every rung, so the rungs compute the same numbers."""
        ln_a, ln_m = self._layer("ln_a", i), self._layer("ln_m", i)
        up, dn = self._layer("mlp_up", i), self._layer("mlp_dn", i)
        project, attend = self._layer("attn", i).seq_parts(burn_in, use_flash, blk_q, ring)
        wa, ba, wm, bm = ln_a.weight, ln_a.bias, ln_m.weight, ln_m.bias
        wu, bu, wd, bd = up.weight, up.bias, dn.weight, dn.bias
        shape = (x.shape[-1],)

        def qkv(x):
            return project(F.layer_norm(x, shape, wa, ba, LN_EPS))

        def mlp(x):
            m = F.linear(F.layer_norm(x, shape, wm, bm, LN_EPS), wu, bu)
            return x + F.linear(F.relu(m), wd, bd)

        def rest(x, q, k, v):
            return mlp(x + attend(q, k, v, key_mask))

        if remat == "none":
            return rest(x, *qkv(x))
        if remat == "attn":
            q, k, v = qkv(x)
            return mlp(x + checkpoint(attend, q, k, v, key_mask,
                                      use_reentrant=False, preserve_rng_state=False))
        if remat == "block":
            q, k, v = checkpoint(qkv, x, use_reentrant=False, preserve_rng_state=False)
            return checkpoint(rest, x, q, k, v, use_reentrant=False, preserve_rng_state=False)
        raise ValueError(f"remat={remat!r} not one of ('none', 'attn', 'block')")

    def forward(self, obs, hidden=None, *, seq: bool = False, key_mask=None, burn_in: int = 0,
                use_flash: bool = False, blk_q: int = 128, remat: str = "none",
                ring=None) -> Dict[str, Any]:
        """``ring`` (seq mode): the ``sp`` AxisGroup when ``obs`` and
        ``key_mask`` are this rank's T/sp shard of the window (rank index i
        holds steps [i * T_loc, (i + 1) * T_loc)); attention then runs over
        the group's ring, and the remat ladder is off."""
        dtype = self.enc1.weight.dtype
        if seq:
            x = F.relu(self.enc1(flatten_obs(obs, 2, dtype)))
            if key_mask is None:
                key_mask = torch.ones(x.shape[:2], device=x.device)
            if ring is not None:
                if remat != "none":
                    raise ValueError("the remat ladder is off under the ring (remat='none')")
                ring = (ring, ring.index * x.shape[1], global_counts(key_mask, ring))
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
            if seq:
                x = self._seq_block(i, x, key_mask, burn_in, use_flash, blk_q, remat, ring)
                continue
            h = self._layer("ln_a", i)(x)
            a, cache = self._layer("attn", i).step(h, hidden["layers"][i], slot, count)
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
